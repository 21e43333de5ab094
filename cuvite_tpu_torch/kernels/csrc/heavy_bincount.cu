// Heavy bincount: dedup + modularity-gain argmax for the hub vertices whose
// degree exceeds the widest bucket (8192).
//
// Replaces: heavy_argmax_pallas (cuvite_tpu/kernels/heavy_bincount.py:200,
// body _kernel :138).  The TPU kernel bincounts each hub's neighbour
// weights over the WHOLE community range in C=512 tiles with a one-hot
// matmul -- H*D*nv compares a sweep, about 1.8e13 at R-MAT scale 20, for
// 2.65 M heavy edges.  That form is not carried over.
//
// Same function as the row kernel, per hub: counter0 = weight into the
// current community, then for every distinct neighbour community c != curr
// the gain 2*(wagg - eix) - ((2*vdeg)*(ay - ax))*const, argmax with ties to
// the smaller id, sentinel / -inf when no community is a candidate.  A
// community is a candidate because an edge reaches it (presence), whatever
// that edge's weight.
//
// Layout (kernels/heavy_bincount.py, build_heavy_layout): each hub's edges
// are its CSR range of the heavy edge arrays, cut into chunks of at most
// kChunk edges that never straddle two hubs: chunk b is edges
// [coff[b], coff[b+1]) of hub chunk_hub[b], hub h owns chunks
// [hub_chunks[h], hub_chunks[h+1]) and table slots [toff[h], toff[h+1]).
//
// What bounds it on an H100.  Its bytes bound is 8 B of dst and w an edge
// plus the comm and comm_deg tables once (about 9 us for R-MAT 20's 2.65 M
// heavy edges, chip_smoke.py phase 6).  A block per hub cannot come
// near it: the largest hub sets the time while most SMs idle, and a
// per-hub table of next_pow2(2*degree) slots that every launch clears and
// scans costs 2-4x the edges again.  What remains once the hubs are spread
// over the card is the merge of the chunks: one random read-modify-write of
// a hub-table entry per distinct (hub, community) pair -- every heavy edge
// at the identity assignment -- into tables of 8 B x next_pow2(2*degree)
// slots, 42-85 MB at R-MAT 20, more than L2 holds.  Design, three launches:
//   pass 1, one block per chunk (the whole card busy however the degrees
//     fall): the chunk's loads and comm gathers go out, 8 a thread, before
//     its shared table of next_pow2(2*len) <= 8,192 slots is cleared; the
//     chunk is aggregated there with warp-aggregated inserts; its counter0
//     partial goes to its own slot; each distinct community is then flushed
//     into the hub's table, whose 8-byte entries hold key and sum together:
//     one 64-bit atomicCAS that carries the sum claims an empty slot (one
//     atomic and one sector for a new community, an atomicAdd on the sum
//     for a known one), four first CASes in flight a thread; a claimed slot
//     is appended to the chunk's own share of the list (its edge range),
//     counted in shared memory, so no global counter is contended;
//   pass 2, one block per chunk again, over the slots its chunk claimed:
//     counter0 as the sum of the hub's chunk partials in chunk order
//     (deterministic, one warp), the gain of each listed community, a block
//     argmax and one 64-bit atomicMax per block on the hub's packed key;
//     each visited entry is reset to empty;
//   finalize, one warp per hub: counter0 again, decode the packed key,
//     reset it to 0.
// The scratch (hub tables, lists, claim counts, partials, packed keys)
// belongs to the layout: the tables and keys are cleared once when the
// layout is uploaded and left clean by every launch, so no launch clears or
// scans a whole table -- only the entries it claimed.  One launch at a time
// per layout (stream order).
//
// The packed key is (orderable(gain) << 32) | ~id: a larger key is a larger
// gain, then a smaller id -- the order of cv::better.  orderable() maps a
// float's bits to an unsigned that sorts like the float, which would put
// -0.0 below +0.0 where cv::better calls them equal and breaks the tie by
// id, so the gain is canonicalised (-0.0 -> +0.0) before packing.  (The
// gain formula itself never yields -0.0: a difference of equal floats is
// +0.0 in round-to-nearest, and wagg is summed from +0.0.)  The key 0 lies
// below every packed candidate and means "no candidate".
//
// Weights are summed in another order than the reference's: see the
// exactness domain in common.cuh.
#include "common.cuh"

namespace {

constexpr int kChunk = 4096;    // HEAVY_CHUNK of kernels/heavy_bincount.py
constexpr int kThreads = 512;
constexpr int kU = kChunk / kThreads;   // edges in flight per thread
constexpr int kF = 4;                   // first CASes in flight per thread

// A hub-table entry: the key in the low word, the float sum in the high
// word; kEmptyEntry is key -1 with sum +0.0.
constexpr unsigned long long kEmptyEntry = 0xffffffffull;

__device__ __forceinline__ unsigned long long make_entry(int key, float v) {
  return ((unsigned long long)__float_as_uint(v) << 32) | (unsigned)key;
}

__device__ __forceinline__ int entry_key(unsigned long long e) {
  return (int)(unsigned)e;
}

__device__ __forceinline__ float* entry_sum(unsigned long long* e) {
  return reinterpret_cast<float*>(e) + 1;
}

// Add v to key's entry of a hub table, probing from slot h: an empty slot
// is claimed with one 64-bit CAS that carries v.  Returns true when this
// call claimed the slot (stored in `slot`).
__device__ __forceinline__ bool hub_add(unsigned long long* tab,
                                        unsigned mask, int key, float v,
                                        unsigned h, unsigned& slot) {
  while (true) {
    const unsigned long long prev =
        atomicCAS(tab + h, kEmptyEntry, make_entry(key, v));
    slot = h;
    if (prev == kEmptyEntry) return true;
    if (entry_key(prev) == key) {
      atomicAdd(entry_sum(tab + h), v);
      return false;
    }
    h = (h + 1) & mask;
  }
}

__device__ __forceinline__ unsigned orderable(float g) {
  const unsigned u = __float_as_uint(__fadd_rn(g, 0.0f));   // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unorderable(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ unsigned long long pack(float g, int c) {
  return ((unsigned long long)orderable(g) << 32) | (unsigned)~c;
}

// counter0 of hub h: its chunk partials summed in chunk order.  A whole
// warp calls it: the lanes load 32 partials at a time and every lane adds
// them in the same order, so every lane holds the same sum.
__device__ __forceinline__ float hub_counter0(const float* partial,
                                              const int* hub_chunks, int h) {
  const int lane = threadIdx.x & 31;
  const int k0 = hub_chunks[h], k1 = hub_chunks[h + 1];
  float c0 = 0.0f;
  for (int base = k0; base < k1; base += 32) {
    const float p = base + lane < k1 ? partial[base + lane] : 0.0f;
    const int n = min(32, k1 - base);
    for (int i = 0; i < n; ++i)
      c0 = __fadd_rn(c0, __shfl_sync(cv::kFull, p, i));
  }
  return c0;
}

__global__ void __launch_bounds__(kThreads) heavy_pass1(
    const int* __restrict__ chunk_hub, const long long* __restrict__ coff,
    const int* __restrict__ hverts, const int* __restrict__ dst,
    const float* __restrict__ w, const long long* __restrict__ toff,
    unsigned long long* __restrict__ table, int* __restrict__ tlist,
    int* __restrict__ nlist, float* __restrict__ partial,
    const int* __restrict__ comm, int nv) {
  extern __shared__ int smem[];
  __shared__ int s_n;
  const int b = blockIdx.x, h = chunk_hub[b];
  const long long e0 = coff[b];
  const int len = (int)(coff[b + 1] - e0);
  const unsigned mask = cv::table_slots(len) - 1u;
  int* skeys = smem;
  float* svals = reinterpret_cast<float*>(smem + mask + 1);
  const int curr = comm[min(hverts[h], nv - 1)];
  // The edges' loads and gathers go out before the table is cleared.
  float c0 = 0.0f;
  int key[kU];
  float x[kU];
  auto gather = [&](int base) {
    int d[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int j = base + k * kThreads + threadIdx.x;
      d[k] = j < len ? __ldcs(dst + e0 + j) : -1;
      x[k] = j < len ? __ldcs(w + e0 + j) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kU; ++k)
      key[k] = d[k] >= 0 ? __ldg(comm + d[k]) : cv::kEmpty;
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      if (d[k] >= 0 && key[k] == curr) {
        c0 = __fadd_rn(c0, x[k]);
        key[k] = cv::kEmpty;
      }
    }
  };
  gather(0);
  for (unsigned s = threadIdx.x; s <= mask; s += kThreads) {
    skeys[s] = cv::kEmpty;
    svals[s] = 0.0f;
  }
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  for (int base = 0;;) {
#pragma unroll
    for (int k = 0; k < kU; ++k)
      cv::warp_insert(skeys, svals, nullptr, mask, key[k], x[k], 0.0f);
    base += kU * kThreads;
    if (base >= len) break;
    gather(base);
  }
  c0 = cv::block_sum(c0);  // also orders the table writes before the flush
  if (threadIdx.x == 0) partial[b] = c0;

  // Flush each distinct community of the chunk into the hub's table, kF
  // slots a thread at a time with their first CASes in flight together.
  // A claimed slot goes to this chunk's share of the list (positions
  // coff[b] ... of tlist, at most len of them).
  unsigned long long* gtab = table + toff[h];
  const unsigned gmask = (unsigned)(toff[h + 1] - toff[h]) - 1u;
  int* list = tlist + e0;
  const int lane = threadIdx.x & 31;
  for (unsigned s0 = 0; s0 <= mask; s0 += kF * kThreads) {   // uniform
    int k[kF];
    float v[kF];
    unsigned slot[kF];
    unsigned long long prev[kF];
    bool claimed[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const unsigned s = s0 + f * kThreads + threadIdx.x;
      k[f] = s <= mask ? skeys[s] : cv::kEmpty;
      v[f] = s <= mask ? svals[s] : 0.0f;
      slot[f] = cv::mix(k[f]) & gmask;
    }
#pragma unroll
    for (int f = 0; f < kF; ++f)
      prev[f] = k[f] != cv::kEmpty
          ? atomicCAS(gtab + slot[f], kEmptyEntry, make_entry(k[f], v[f]))
          : kEmptyEntry;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      claimed[f] = k[f] != cv::kEmpty && prev[f] == kEmptyEntry;
      if (k[f] != cv::kEmpty && !claimed[f]) {
        if (entry_key(prev[f]) == k[f])
          atomicAdd(entry_sum(gtab + slot[f]), v[f]);
        else
          claimed[f] = hub_add(gtab, gmask, k[f], v[f],
                               (slot[f] + 1) & gmask, slot[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const unsigned cl = __ballot_sync(cv::kFull, claimed[f]);
      if (cl) {
        const int first = __ffs(cl) - 1;
        int at = 0;
        if (lane == first) at = atomicAdd(&s_n, __popc(cl));
        at = __shfl_sync(cv::kFull, at, first);
        if (claimed[f])
          list[at + __popc(cl & ((1u << lane) - 1u))] = (int)slot[f];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) nlist[b] = s_n;
}

__global__ void __launch_bounds__(kThreads) heavy_pass2(
    const int* __restrict__ chunk_hub, const long long* __restrict__ coff,
    const int* __restrict__ hub_chunks, const int* __restrict__ hverts,
    const long long* __restrict__ toff,
    unsigned long long* __restrict__ table, const int* __restrict__ tlist,
    const int* __restrict__ nlist, const float* __restrict__ partial,
    const int* __restrict__ comm, const float* __restrict__ comm_deg,
    const float* __restrict__ vdeg, const float* __restrict__ self_loop,
    int nv, float cst, int sentinel, unsigned long long* __restrict__ best) {
  const int b = blockIdx.x, h = chunk_hub[b];
  const int n = nlist[b];
  if (n == 0) return;   // the whole block
  __shared__ float s_c0;
  if (threadIdx.x < 32) {
    const float c0 = hub_counter0(partial, hub_chunks, h);
    if (threadIdx.x == 0) s_c0 = c0;
  }
  const int v = min(hverts[h], nv - 1);
  const float vd = vdeg[v];
  const float ax = __fsub_rn(comm_deg[comm[v]], vd);
  const float sl = self_loop[v];
  __syncthreads();
  const float eix = __fsub_rn(s_c0, sl);
  unsigned long long* gtab = table + toff[h];
  const int* list = tlist + coff[b];
  float g = -CUDART_INF_F;
  int bc = sentinel;
  for (int base = 0; base < n; base += kU * kThreads) {
    int slot[kU], key[kU];
    float val[kU], ay[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int p = base + k * kThreads + threadIdx.x;
      slot[k] = p < n ? list[p] : -1;
    }
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const unsigned long long e = slot[k] >= 0 ? __ldcg(gtab + slot[k])
                                                : kEmptyEntry;
      key[k] = entry_key(e);
      val[k] = __uint_as_float((unsigned)(e >> 32));
    }
#pragma unroll
    for (int k = 0; k < kU; ++k)
      ay[k] = slot[k] >= 0 ? __ldg(comm_deg + key[k]) : 0.0f;
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      if (slot[k] < 0) continue;
      const float gk = cv::gain(val[k], eix, vd, ay[k], ax, cst);
      if (cv::better(gk, key[k], g, bc)) {
        g = gk;
        bc = key[k];
      }
      gtab[slot[k]] = kEmptyEntry;   // leave the table clean
    }
  }
  cv::block_argmax(g, bc, sentinel);
  if (threadIdx.x == 0 && bc != sentinel) atomicMax(&best[h], pack(g, bc));
}

// One warp per hub.
__global__ void heavy_finalize(int n_hubs, const int* __restrict__ hub_chunks,
                               const float* __restrict__ partial,
                               unsigned long long* __restrict__ best,
                               int sentinel, int* __restrict__ best_c,
                               float* __restrict__ best_gain,
                               float* __restrict__ counter0) {
  const int h = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (h >= n_hubs) return;   // the whole warp
  const float c0 = hub_counter0(partial, hub_chunks, h);
  if ((threadIdx.x & 31) == 0) {
    const unsigned long long p = best[h];
    best_c[h] = p ? (int)~(unsigned)(p & 0xffffffffu) : sentinel;
    best_gain[h] = p ? unorderable((unsigned)(p >> 32)) : -CUDART_INF_F;
    counter0[h] = c0;
    best[h] = 0;
  }
}

// Raise pass 1's dynamic shared-memory limit once per device (up to 64).
cudaError_t allow_shared_memory() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(heavy_pass1,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(cv::table_slots(kChunk) * 8));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

// Scratch (all per layout, on the device): table [T] hub-table entries,
// all kEmptyEntry between launches; tlist [E] (each chunk's claimed slots,
// at its edge offset); nlist [C] and partial [C] (claims and counter0 per
// chunk); best [H], 0 between launches.  max_chunk: the layout's longest
// chunk, at most kChunk.
extern "C" int cv_heavy_argmax(
    const int* hverts, const int* dst, const float* w, int n_hubs,
    const int* chunk_hub, const long long* coff, const int* hub_chunks,
    int n_chunks, int max_chunk, const long long* toff,
    unsigned long long* table, int* tlist, int* nlist, float* partial,
    unsigned long long* best, const int* comm, const float* comm_deg,
    const float* vdeg, const float* self_loop, int nv, float cst,
    int sentinel, int* best_c, float* best_gain, float* counter0,
    void* stream) {
  if (n_hubs <= 0) return 0;
  if (nv < 1 || n_chunks < n_hubs || max_chunk < 1 || max_chunk > kChunk)
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  heavy_pass1<<<n_chunks, kThreads, cv::table_slots(max_chunk) * 8, st>>>(
      chunk_hub, coff, hverts, dst, w, toff, table, tlist, nlist, partial,
      comm, nv);
  cudaError_t launch = cudaGetLastError();
  if (launch != cudaSuccess) return (int)launch;
  heavy_pass2<<<n_chunks, kThreads, 0, st>>>(
      chunk_hub, coff, hub_chunks, hverts, toff, table, tlist, nlist,
      partial, comm, comm_deg, vdeg, self_loop, nv, cst, sentinel, best);
  launch = cudaGetLastError();
  if (launch != cudaSuccess) return (int)launch;
  heavy_finalize<<<(n_hubs + 7) / 8, 256, 0, st>>>(
      n_hubs, hub_chunks, partial, best, sentinel, best_c, best_gain,
      counter0);
  return (int)cudaGetLastError();
}
