// Row argmax: neighbour-community dedup + modularity-gain argmax for the
// rows of one degree bucket of the Louvain sweep.
//
// Replaces: row_argmax_pallas (cuvite_tpu/kernels/row_argmax.py:166, body
// _kernel :60) and, for the widths the reference leaves to XLA (above
// PALLAS_MAX_WIDTH = 2048), _row_argmax_sorted
// (cuvite_tpu/louvain/bucketed.py:627).  It serves every width of
// DEFAULT_BUCKETS, 8 ... 8192.
//
// Per row (one vertex v, D neighbour slots, row-major [N, D]):
//   curr = comm[v]; c_j = comm[dst_j]; ay_j = comm_deg[c_j]
//   counter0 = sum_{c_j == curr} w_j      (self-loops included)
//   eix = counter0 - self_loop[v];  ax = comm_deg[curr] - vdeg[v]
//   for each distinct c != curr:  wagg_c = sum_{c_j == c} w_j
//       gain_c = 2*(wagg_c - eix) - ((2*vdeg)*(ay_c - ax))*const
//   best = argmax gain, ties to the smaller id; sentinel / -inf if none.
// The comm[dst] and comm_deg[c] gathers happen inside the kernel, so no
// [N, D] community or degree matrix is ever written to device memory.
// With the optional per-row degree (row_len) a row stops at its degree and
// never reads its padded slots; without it the whole width is read.
// Padding slots carry dst = v and w = 0: their community is curr, so they
// add 0 to counter0 and are never candidates.  Padding rows carry
// verts = nv and are computed against vertex nv-1 (the caller drops them;
// the port's device plan holds none).
//
// What bounds it on an H100.  The bytes bound is 8 B of dst and w a slot,
// but a slot also needs its neighbour's community and that community's
// degree, random 4-byte reads of the per-vertex tables that come from L2
// as whole 32-byte sectors.  Those random gathers, not the stream of dst
// and w, set the time at R-MAT 20 (PERF.md, chip_smoke.py phase 6).
// Design:
//   * every vertex is read through one 16-byte record of the sweep's
//     vertex_table {comm, comm_deg[comm], vdeg, self_loop}: a slot costs
//     one 8-byte gather (its community and that community's degree), a
//     row one 16-byte gather -- half the random sectors of two tables;
//   * D in {8, 16, 32}: D lanes per row (32/D rows per warp); the all-pairs
//     dedup runs in registers through shuffles, the first occurrence leads;
//   * D <= 256 (64 ... 256): one warp per row, four rows per block, each
//     warp on its own shared-memory slice of next_pow2(2*degree) slots
//     (at most 512 slots, 6 KB) -- no block barrier, __syncwarp only, the
//     argmax by shuffles;
//   * D > 256 (384 ... 8192): one block per row (128 ... 1,024 threads, about
//     8 slots a thread), one shared table of next_pow2(2*degree) slots
//     (192 KB at 8192), the cudaFuncSetAttribute for it made once per
//     device, not per launch;
//   * in both table forms every thread issues the loads of 4 slots, then
//     their 4 record gathers, before any insert, and the first slots' loads
//     go out before the table is cleared; the community degree travels with
//     the key into the table, so the scan reads shared memory only;
//   * inserts are warp-aggregated (common.cuh warp_insert): a converged row,
//     or a row inside one or two communities, costs one shared atomic per
//     community and warp.
// dst and w stream once, contiguous: each load of a warp reads 128
// contiguous bytes, with the evict-first hint.  No 16-byte loads (4 slots
// a lane): a 64-slot row would then keep only 16 of 32 lanes busy.  No TMA:
// the bound is the gathers, not the stream.  Weights are summed in
// another order than the reference's (with float atomics in the table
// forms): see the exactness domain in common.cuh.
//
// The size form (template flag kSized; cv_row_argmax_sized) serves the
// sparse ghost exchange of a vertex mesh (louvain/bucketed.py), where no
// shard holds a community-indexed table: a slot's dst is an extended-local
// index (owned vertex or ghost) into a second record table
// sinfo[d] = {comm_ext[d], cdeg_ext[d], csize_ext[d], 0} -- the community,
// that community's degree and its size, attached to the vertex -- and the
// kernel also returns best_size, the size carried by the winning slot
// (sentinel where there is no candidate), which the singleton guard needs
// (reference: row_argmax_pallas(szT=...), cuvite_tpu/kernels/
// row_argmax.py:28-35, :63-70, :166-214).  The row's record stays vinfo,
// whose second word is then the env's cdeg_v.  Every slot of a community
// carries the same attached degree and size, so which slot supplies them
// does not matter.  In the narrow form each lane gathers its slot's whole
// 16-byte record; the table forms keep their 12-byte slots (key, weight
// sum, and the claiming slot's dst in place of the degree), gather the
// 4-byte community per slot, and read the record of each distinct
// community once more at the scan -- a second gather per candidate, not
// per slot, and tables of the non-size form's size (16-byte slots would
// not fit the 8192 class in shared memory).  The non-size instantiations
// are the code above unchanged.
//
// Batches (louvain/batched.py): B tenants folded into one id space, vertex
// or community v of tenant b stored as b * nv_pad + v with nv_pad a power
// of two, so one launch per width class covers the rows of every tenant.
// Each row takes its tenant's constant float32(1/(2 m_b)) from
// csts[v >> tshift] (tshift = log2 nv_pad).  One graph is a batch of one:
// csts[0], with tshift = ceil(log2 nv) so that every id maps to it.
#include "common.cuh"

namespace {

constexpr int kMaxWidth = 8192;
constexpr int kWarpMaxWidth = 256;   // widest row of the warp-per-row form
constexpr int kRowWarps = 4;         // rows (warps) per block in that form
constexpr int kU = 4;                // slots in flight per thread
constexpr int kSlotBytes = 12;  // key, weight sum, degree (size form: dst)

struct Row {
  int curr;
  float vd, sl, ax, cst;
};

// vinfo[v] = {comm[v], comm_deg[comm[v]], vdeg[v], self_loop[v]} (float
// bits): the row's vertex is one 16-byte gather, a slot's community and
// community degree one 8-byte gather.
// The row's constant is its tenant's.
__device__ __forceinline__ Row row_scalars(const int* verts, long long row,
                                           const int4* vinfo, int nv,
                                           const float* csts,
                                           int tshift) {
  const int v = min(verts[row], nv - 1);
  const int4 e = __ldg(vinfo + v);
  Row r;
  r.curr = e.x;
  r.vd = __int_as_float(e.z);
  r.sl = __int_as_float(e.w);
  r.ax = __fsub_rn(__int_as_float(e.y), r.vd);
  r.cst = __ldg(csts + (v >> tshift));
  return r;
}

__device__ __forceinline__ int row_length(const int* row_len, long long row,
                                          int width) {
  return row_len ? min(max(row_len[row], 0), width) : width;
}

// The kU slots this thread owns in one pass over [base, base + kU*team),
// `team` apart (a warp reads 128 contiguous bytes per load).  A slot past
// `len` reads nothing.  Slots of the current community go to c0; the
// others come back as (key, x, ay), key kEmpty where there is nothing to
// insert.  In the size form (kSized) `vinfo` is sinfo, and `ay` carries
// the slot's dst (its bits) for the scan to read the record again.
template <bool kSized>
__device__ __forceinline__ void gather_slots(
    const int* __restrict__ drow, const float* __restrict__ wrow, int base,
    int t, int team, int len, const int4* __restrict__ vinfo, int curr,
    int (&key)[kU], float (&x)[kU], float (&ay)[kU], float& c0) {
  int d[kU];
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    const int j = base + k * team + t;
    d[k] = j < len ? __ldcs(drow + j) : -1;
    x[k] = j < len ? __ldcs(wrow + j) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    if constexpr (kSized) {
      key[k] = d[k] >= 0 ? __ldg(reinterpret_cast<const int*>(vinfo + d[k]))
                         : cv::kEmpty;
      ay[k] = __int_as_float(d[k]);
    } else {
      const int2 e = d[k] >= 0
          ? __ldg(reinterpret_cast<const int2*>(vinfo + d[k]))
          : make_int2(cv::kEmpty, 0);
      key[k] = e.x;
      ay[k] = __int_as_float(e.y);
    }
  }
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    if (d[k] >= 0 && key[k] == curr) {
      c0 = __fadd_rn(c0, x[k]);
      key[k] = cv::kEmpty;
    }
  }
}

// Best (gain, id) over the occupied slots of this thread's share of a
// table; slots `stride` apart from `first`.
__device__ __forceinline__ void scan_table(const int* keys, const float* vals,
                                           const float* ays, unsigned mask,
                                           unsigned first, unsigned stride,
                                           const Row& r, float eix,
                                           float& g, int& b) {
  for (unsigned s = first; s <= mask; s += stride) {
    const int k = keys[s];
    if (k != cv::kEmpty) {
      const float gk = cv::gain(vals[s], eix, r.vd, ays[s], r.ax, r.cst);
      if (cv::better(gk, k, g, b)) {
        g = gk;
        b = k;
      }
    }
  }
}

// scan_table of the size form: the table's third word is a slot's dst,
// whose sinfo record gives the community's degree and size; `sz` follows
// the winner.
__device__ __forceinline__ void scan_table_sized(
    const int* keys, const float* vals, const float* dsts, unsigned mask,
    unsigned first, unsigned stride, const Row& r, float eix,
    const int4* __restrict__ sinfo, float& g, int& b, int& sz) {
  for (unsigned s = first; s <= mask; s += stride) {
    const int k = keys[s];
    if (k != cv::kEmpty) {
      const int4 e = __ldg(sinfo + __float_as_int(dsts[s]));
      const float gk = cv::gain(vals[s], eix, r.vd, __int_as_float(e.y),
                                r.ax, r.cst);
      if (cv::better(gk, k, g, b)) {
        g = gk;
        b = k;
        sz = e.z;
      }
    }
  }
}

// group_argmax carrying the winner's size.
template <int W>
__device__ __forceinline__ void group_argmax_sized(float& g, int& c,
                                                   int& sz) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const float og = __shfl_xor_sync(cv::kFull, g, off, W);
    const int oc = __shfl_xor_sync(cv::kFull, c, off, W);
    const int os = __shfl_xor_sync(cv::kFull, sz, off, W);
    if (cv::better(og, oc, g, c)) {
      g = og;
      c = oc;
      sz = os;
    }
  }
}

// block_argmax carrying the winner's size; valid in thread 0.
__device__ __forceinline__ void block_argmax_sized(float& g, int& c, int& sz,
                                                   int sentinel) {
  __shared__ float pg[32];
  __shared__ int pc[32], ps[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  group_argmax_sized<32>(g, c, sz);
  if (lane == 0) {
    pg[wid] = g;
    pc[wid] = c;
    ps[wid] = sz;
  }
  __syncthreads();
  if (wid == 0) {
    const bool have = lane < (int)(blockDim.x >> 5);
    g = have ? pg[lane] : -CUDART_INF_F;
    c = have ? pc[lane] : sentinel;
    sz = have ? ps[lane] : sentinel;
    group_argmax_sized<32>(g, c, sz);
  }
}

template <int D, bool kSized>
__global__ void row_argmax_narrow(const int* __restrict__ dst,
                                  const float* __restrict__ w,
                                  const int* __restrict__ verts,
                                  const int* __restrict__ row_len,
                                  long long n_rows,
                                  const int4* __restrict__ vinfo, int nv,
                                  const float* __restrict__ csts,
                                  int tshift, int sentinel,
                                  const int4* __restrict__ sinfo,
                                  int* __restrict__ best_c,
                                  float* __restrict__ best_gain,
                                  float* __restrict__ counter0,
                                  int* __restrict__ best_size) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / D;
  const int lane = (int)(t % D);
  const bool live = row < n_rows;  // dead lanes still join the shuffles
  int curr = 0, c = cv::kEmpty, sz = sentinel;
  float vd = 0.0f, sl = 0.0f, ax = 0.0f, wj = 0.0f, ay = 0.0f, rc = 0.0f;
  if (live) {
    const Row r = row_scalars(verts, row, vinfo, nv, csts, tshift);
    curr = r.curr;
    vd = r.vd;
    sl = r.sl;
    ax = r.ax;
    rc = r.cst;
    // A slot past the row's degree is a padding slot: curr, weight 0.
    c = curr;
    if (lane < row_length(row_len, row, D)) {
      const long long j = row * D + lane;
      if constexpr (kSized) {
        const int4 e = __ldg(sinfo + dst[j]);
        c = e.x;
        ay = __int_as_float(e.y);
        sz = e.z;
      } else {
        const int2 e = __ldg(reinterpret_cast<const int2*>(vinfo + dst[j]));
        c = e.x;
        ay = __int_as_float(e.y);
      }
      wj = w[j];
    }
  }
  const float c0 = cv::group_sum<D>(c == curr ? wj : 0.0f);
  const float eix = __fsub_rn(c0, sl);
  float wagg = 0.0f;
  bool dup = false;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const int ck = __shfl_sync(cv::kFull, c, k, D);
    const float wk = __shfl_sync(cv::kFull, wj, k, D);
    if (ck == c) {
      wagg = __fadd_rn(wagg, wk);
      dup |= k < lane;
    }
  }
  const bool valid = live && !dup && c != curr;
  float g = valid ? cv::gain(wagg, eix, vd, ay, ax, rc) : -CUDART_INF_F;
  int b = valid ? c : sentinel;
  if constexpr (kSized) {
    sz = valid ? sz : sentinel;
    group_argmax_sized<D>(g, b, sz);
  } else {
    cv::group_argmax<D>(g, b);
  }
  if (live && lane == 0) {
    best_c[row] = b;
    best_gain[row] = g;
    counter0[row] = c0;
    if constexpr (kSized) best_size[row] = sz;
  }
}

// One warp per row; `slots` is the table slice of one warp (the class
// width's), the row uses the next_pow2(2 * degree) slots it needs.
template <bool kSized>
__global__ void __launch_bounds__(kRowWarps * 32)
row_argmax_warp(const int* __restrict__ dst, const float* __restrict__ w,
                const int* __restrict__ verts,
                const int* __restrict__ row_len, long long n_rows, int width,
                const int4* __restrict__ vinfo, int nv,
                const float* __restrict__ csts, int tshift, int sentinel,
                unsigned slots, const int4* __restrict__ sinfo,
                int* __restrict__ best_c,
                float* __restrict__ best_gain,
                float* __restrict__ counter0,
                int* __restrict__ best_size) {
  extern __shared__ int smem[];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowWarps + wid;
  if (row >= n_rows) return;   // the whole warp
  int* keys = smem + (size_t)wid * slots * 3;
  float* vals = reinterpret_cast<float*>(keys + slots);
  float* ays = vals + slots;
  const int len = row_length(row_len, row, width);
  const unsigned mask = cv::table_slots(len) - 1u;
  // The first slots' loads and the row's own chain go out before the
  // table is cleared, so their latency overlaps the clearing.
  const Row r = row_scalars(verts, row, vinfo, nv, csts, tshift);
  const int* drow = dst + row * width;
  const float* wrow = w + row * width;
  const int4* slot_info = kSized ? sinfo : vinfo;
  float c0 = 0.0f;
  int key[kU];
  float x[kU], ay[kU];
  gather_slots<kSized>(drow, wrow, 0, lane, 32, len, slot_info, r.curr,
                       key, x, ay, c0);
  for (unsigned s = lane; s <= mask; s += 32) {
    keys[s] = cv::kEmpty;
    vals[s] = 0.0f;
  }
  __syncwarp();
  for (int base = 0;;) {
#pragma unroll
    for (int k = 0; k < kU; ++k)
      cv::warp_insert(keys, vals, ays, mask, key[k], x[k], ay[k]);
    base += kU * 32;
    if (base >= len) break;
    gather_slots<kSized>(drow, wrow, base, lane, 32, len, slot_info,
                         r.curr, key, x, ay, c0);
  }
  __syncwarp();
  c0 = cv::group_sum<32>(c0);
  const float eix = __fsub_rn(c0, r.sl);
  float g = -CUDART_INF_F;
  int b = sentinel;
  int sz = sentinel;
  if constexpr (kSized) {
    scan_table_sized(keys, vals, ays, mask, lane, 32, r, eix, sinfo, g, b,
                     sz);
    group_argmax_sized<32>(g, b, sz);
  } else {
    scan_table(keys, vals, ays, mask, lane, 32, r, eix, g, b);
    cv::group_argmax<32>(g, b);
  }
  if (lane == 0) {
    best_c[row] = b;
    best_gain[row] = g;
    counter0[row] = c0;
    if constexpr (kSized) best_size[row] = sz;
  }
}

template <bool kSized>
__global__ void __launch_bounds__(1024)
row_argmax_block(const int* __restrict__ dst, const float* __restrict__ w,
                 const int* __restrict__ verts,
                 const int* __restrict__ row_len, int width,
                 const int4* __restrict__ vinfo, int nv,
                 const float* __restrict__ csts, int tshift, int sentinel,
                 const int4* __restrict__ sinfo,
                 int* __restrict__ best_c,
                 float* __restrict__ best_gain,
                 float* __restrict__ counter0,
                 int* __restrict__ best_size) {
  extern __shared__ int smem[];
  const long long row = blockIdx.x;
  const int len = row_length(row_len, row, width);
  const unsigned mask = cv::table_slots(len) - 1u;
  int* keys = smem;
  float* vals = reinterpret_cast<float*>(keys + mask + 1);
  float* ays = vals + mask + 1;
  const Row r = row_scalars(verts, row, vinfo, nv, csts, tshift);
  const int* drow = dst + row * width;
  const float* wrow = w + row * width;
  const int4* slot_info = kSized ? sinfo : vinfo;
  float c0 = 0.0f;
  int key[kU];
  float x[kU], ay[kU];
  gather_slots<kSized>(drow, wrow, 0, threadIdx.x, blockDim.x, len,
                       slot_info, r.curr, key, x, ay, c0);
  for (unsigned s = threadIdx.x; s <= mask; s += blockDim.x) {
    keys[s] = cv::kEmpty;
    vals[s] = 0.0f;
  }
  __syncthreads();
  for (int base = 0;;) {
#pragma unroll
    for (int k = 0; k < kU; ++k)
      cv::warp_insert(keys, vals, ays, mask, key[k], x[k], ay[k]);
    base += kU * (int)blockDim.x;
    if (base >= len) break;
    gather_slots<kSized>(drow, wrow, base, threadIdx.x, blockDim.x, len,
                         slot_info, r.curr, key, x, ay, c0);
  }
  c0 = cv::block_sum(c0);  // also orders the table writes before the scan
  const float eix = __fsub_rn(c0, r.sl);
  float g = -CUDART_INF_F;
  int b = sentinel;
  int sz = sentinel;
  if constexpr (kSized) {
    scan_table_sized(keys, vals, ays, mask, threadIdx.x, blockDim.x, r, eix,
                     sinfo, g, b, sz);
    block_argmax_sized(g, b, sz, sentinel);
  } else {
    scan_table(keys, vals, ays, mask, threadIdx.x, blockDim.x, r, eix, g,
               b);
    cv::block_argmax(g, b, sentinel);
  }
  if (threadIdx.x == 0) {
    best_c[row] = b;
    best_gain[row] = g;
    counter0[row] = c0;
    if constexpr (kSized) best_size[row] = sz;
  }
}

// Threads of the block form: about 8 slots a thread (two passes of kU),
// 128 ... 1,024.
int block_threads(int width) {
  const int t = ((width / 8 + 31) / 32) * 32;
  return t < 128 ? 128 : (t > 1024 ? 1024 : t);
}

// Raise the dynamic shared-memory limit of both table forms, both
// instantiations, once per device (up to 64 devices), not per launch.
template <bool kSized>
cudaError_t allow_shared_memory_of() {
  const int most = (int)(cv::table_slots(kMaxWidth) * kSlotBytes);
  cudaError_t err = cudaFuncSetAttribute(
      row_argmax_block<kSized>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      row_argmax_warp<kSized>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kRowWarps * cv::table_slots(kWarpMaxWidth) * kSlotBytes));
}

cudaError_t allow_shared_memory() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = allow_shared_memory_of<false>();
  if (err != cudaSuccess) return err;
  err = allow_shared_memory_of<true>();
  if (err != cudaSuccess) return err;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

// One launch of either form; sinfo/best_size are null in the non-size
// form.
template <bool kSized>
int launch(const int* dst, const float* w, const int* verts,
           const int* row_len, long long n_rows, int width,
           const int4* vinfo, int nv, const float* csts, int tshift,
           int sentinel, const int4* sinfo, int* best_c, float* best_gain,
           float* counter0, int* best_size, cudaStream_t st) {
  if (n_rows <= 0) return 0;
  if (width < 1 || width > kMaxWidth || nv < 1 || csts == nullptr
      || tshift < 0 || tshift > 31)
    return cudaErrorInvalidValue;
  if (width == 8 || width == 16 || width == 32) {
    const int threads = 256;
    const long long blocks = (n_rows * width + threads - 1) / threads;
    if (width == 8)
      row_argmax_narrow<8, kSized><<<(unsigned)blocks, threads, 0, st>>>(
          dst, w, verts, row_len, n_rows, vinfo, nv, csts, tshift,
          sentinel, sinfo, best_c, best_gain, counter0, best_size);
    else if (width == 16)
      row_argmax_narrow<16, kSized><<<(unsigned)blocks, threads, 0, st>>>(
          dst, w, verts, row_len, n_rows, vinfo, nv, csts, tshift,
          sentinel, sinfo, best_c, best_gain, counter0, best_size);
    else
      row_argmax_narrow<32, kSized><<<(unsigned)blocks, threads, 0, st>>>(
          dst, w, verts, row_len, n_rows, vinfo, nv, csts, tshift,
          sentinel, sinfo, best_c, best_gain, counter0, best_size);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return (int)err;
  const unsigned slots = cv::table_slots(width);
  if (width <= kWarpMaxWidth) {
    const long long blocks = (n_rows + kRowWarps - 1) / kRowWarps;
    row_argmax_warp<kSized><<<(unsigned)blocks, kRowWarps * 32,
                              (size_t)kRowWarps * slots * kSlotBytes, st>>>(
        dst, w, verts, row_len, n_rows, width, vinfo, nv, csts, tshift,
        sentinel, slots, sinfo, best_c, best_gain, counter0, best_size);
  } else {
    row_argmax_block<kSized><<<(unsigned)n_rows, block_threads(width),
                               (size_t)slots * kSlotBytes, st>>>(
        dst, w, verts, row_len, width, vinfo, nv, csts, tshift,
        sentinel, sinfo, best_c, best_gain, counter0, best_size);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// row_len: optional [n_rows] per-row degrees (nullptr: every row is
// `width` slots long).
// vinfo: [nv] records {comm, comm_deg[comm], vdeg, self_loop} (float bits).
// csts: the per-tenant constants, csts[v >> tshift] the row vertex v's
// (one entry for one graph).
extern "C" int cv_row_argmax(const int* dst, const float* w, const int* verts,
                             const int* row_len, long long n_rows, int width,
                             const int4* vinfo, int nv, const float* csts,
                             int tshift, int sentinel, int* best_c,
                             float* best_gain, float* counter0,
                             void* stream) {
  return launch<false>(dst, w, verts, row_len, n_rows, width, vinfo, nv,
                       csts, tshift, sentinel, nullptr, best_c, best_gain,
                       counter0, nullptr, static_cast<cudaStream_t>(stream));
}

// The size form: vinfo's second word is the env's cdeg_v, dst indexes
// sinfo [n_ext] records {comm_ext, cdeg_ext, csize_ext, 0}, and best_size
// gets the winner's size (sentinel with no candidate).
extern "C" int cv_row_argmax_sized(const int* dst, const float* w,
                                   const int* verts, const int* row_len,
                                   long long n_rows, int width,
                                   const int4* vinfo, int nv,
                                   const float* csts, int tshift,
                                   int sentinel, const int4* sinfo,
                                   int* best_c, float* best_gain,
                                   float* counter0, int* best_size,
                                   void* stream) {
  if (sinfo == nullptr || best_size == nullptr) return cudaErrorInvalidValue;
  return launch<true>(dst, w, verts, row_len, n_rows, width, vinfo, nv,
                      csts, tshift, sentinel, sinfo, best_c, best_gain,
                      counter0, best_size, static_cast<cudaStream_t>(stream));
}
