// Segmented coalesce of relabelled edge slabs: one row per distinct
// (src, dst) of each tenant, in ascending order, compacted into the
// tenant's slab prefix, duplicate weights summed.  The device half of the
// inter-phase coarsening (ops/segment.coalesced_runs_batched, 'dense').
//
// Replaces: seg_coalesce_pallas (cuvite_tpu/kernels/seg_coalesce.py:202,
// body _kernel :175) and its emission emit_coalesced (:272).  The TPU
// kernel accumulates a dense [nv_pad, nv_pad] weight and count grid, dst
// tile by dst tile so a tile fits VMEM, and the emission compacts the
// present slots with a cumsum outside the kernel.  On this card the grid
// is the cost: nv_pad^2 x 12 B to clear and scan (192 MiB at 4096) for
// slabs of 10^3..10^6 rows.  So the grid is gone: the work here is
// proportional to the slab's rows plus B * grid bucket counters.
//
// Function: B tenants' slabs of ne_row rows each, back to back.  Row e
// belongs to tenant b = e / ne_row and is real when src < grid and
// dst < grid (padding rows carry src == the class's nv_pad >= grid).
// Outputs, [B, ne_row] each: tenant b's distinct real (src, dst) in
// ascending order in [0, n[b]), weights summed in f64 and rounded once to
// f32, presence decided by count (a zero-weight real row is a row); then
// padding src == nv_pad, dst == 0, w == 0.  One slab is B = 1.
//
// Pipeline, all on the caller's stream, no host sync:
//  1. count: a block a chunk of one tenant's rows counts them per bucket
//     (b, src) in a shared-memory histogram, adds the histogram to
//     cnt[B * grid] with one global atomic a nonzero bin, and gives each
//     row its rank in its bucket;
//  2. scan (one block): bucket starts, and the ids of the buckets the
//     warps do not take, in order (the dense list);
//  3. scatter: a block a count chunk orders the chunk's real rows by
//     bucket in shared memory, then stores each row's (dst, w), 8 B, at
//     start[bucket] + rank in `rows` -- runs of consecutive addresses;
//  4. dedup, by bucket length c, each writing its runs in ascending dst
//     at the front of its own bucket in `rows`:
//     - c <= 32: one warp sorts the rows by dst with a bitonic network
//       over shuffles and sums each run of equal dst in f64 (a segmented
//       scan);
//     - 32 < c <= WCAP with grid <= WTABLE_MAX: one warp counts and sums
//       the rows per dst in its private dense row of `grid` slots in
//       shared memory and emits the present slots in order, clearing
//       them;
//     - the rest (the dense list): one block counts and sums the rows per
//       dst in a dense row of shared memory and emits the present slots
//       by a block scan.  Past TILE_MAX dst slots it tiles the dst range
//       and re-reads the bucket once a tile -- the TPU kernel's dst
//       tiling, moved from VMEM to shared memory.  One bucket may hold the
//       whole slab (a late phase where one community absorbs most
//       vertices);
//     Shared-memory f64 atomics are compare-and-swap loops that serialize
//     on a hot slot, and a late phase's bucket sends most rows to one dst
//     (its self-loop): both dense rows count first (int atomics) and sum
//     the busiest slot in registers;
//  5. scan (one block) of the distinct counts: each bucket's offset in
//     its tenant's prefix, and n[b];
//  6. emit: each bucket's runs to b * ne_row + offset, padding after n[b].
// The scans are single-block kernels written here: the bucket arrays are
// B * grid <= 2^16 counters on the serving paths, and a device-wide scan
// would add launches.
//
// Scratch (cv_seg_coalesce_scratch_bytes): the bucket counters and
// `rows`, B * ne_row (dst, w) pairs; the outputs double as staging before
// the emission writes them (the ranks live in src_c, a dense bucket's runs
// in dst_c and w_c).
//
// Numbers: warp sums and run sums add in an order that changes from run
// to run, but in f64 a run sum of f32 addends within ~29 bits of each
// other is exact and therefore independent of the order: it equals the
// host oracle's f64 sum and, on unit and dyadic weights, the reference's
// f32 accumulator.  So the rows are bit-equal to the plain twin on the
// exactness domain and on the float slabs whose run sums are exact.
//
// What bounds it on an H100: bytes -- 12 B per real row read, 12 B per
// output slot written -- and, on the small one-graph slabs, the eight
// launches' fixed cost.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_THREADS = 256;         // emit
constexpr int ROW_BLOCKS_MAX = 132 * 16;
constexpr int CHUNK = 4096;              // rows a count or scatter block takes
constexpr int CHUNK_THREADS = 512;
constexpr int SCAN_THREADS = 1024;       // the single-block scans
constexpr int SCAN_ITEMS = 16;           // consecutive counters a thread
constexpr int WARP_THREADS = 256;        // dedup_warp: 8 warps a block
constexpr int WARP_BLOCKS_MAX = 132 * 8;
constexpr int WCAP = 2048;               // longest bucket a warp's table takes
constexpr int WTABLE_MAX = 1024;         // widest grid of a warp's table
constexpr int DENSE_THREADS = 512;
constexpr int DENSE_BLOCKS_MAX = 132 * 2;
constexpr int TILE_MAX = 8192;           // dst slots of a dense tile
constexpr int ROW_LOADS = 4;             // rows a thread loads at once
static_assert(SCAN_THREADS == 32 * 32, "scan_kernel scans 32 warp totals");
static_assert(SCAN_ITEMS % 4 == 0, "scan_kernel loads int4s");

struct Row {
  int d;
  float w;
};

__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}

// Inclusive sum of v over lanes [0, lane].
__device__ __forceinline__ int warp_incl(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Exclusive sum of v over the threads of the block below this one, and
// the block's sum in `total`.  `sh` holds 33 ints; every thread calls this.
__device__ int block_excl(int v, int* sh, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_incl(v, lane);
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0;
    const int wi = warp_incl(t, lane);
    sh[lane] = wi - t;
    if (lane == 31) sh[32] = wi;
  }
  __syncthreads();
  const int out = sh[warp] + incl - v;
  total = sh[32];
  __syncthreads();  // sh is reused by the next call
  return out;
}

// op over the values of every thread of the block, in a fixed order;
// `sh` holds 32 values; every thread calls this and gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* sh, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = sh[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) v = op(v, sh[i]);
  __syncthreads();  // sh is reused by the next call
  return v;
}

// 1. Rows per (tenant, src) bucket, and each real row's rank in its bucket
// (-1 for a padding row).  Block = (tenant, chunk of CHUNK rows); dynamic
// shared memory: grid ints.
__global__ void count_kernel(const int* __restrict__ src,
                             const int* __restrict__ dst, int ne_row,
                             int chunks, unsigned grid, int* __restrict__ cnt,
                             int* __restrict__ rank) {
  extern __shared__ int hist[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / chunks;
  const int lo = b * ne_row + (blockIdx.x - b * chunks) * CHUNK;
  const int hi = min(lo + CHUNK, (b + 1) * ne_row);
  for (int i = tid; i < (int)grid; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int e = lo + tid; e < hi; e += blockDim.x) {
    const unsigned s = (unsigned)src[e], d = (unsigned)dst[e];
    rank[e] = s < grid && d < grid ? atomicAdd(&hist[s], 1) : -1;
  }
  __syncthreads();
  for (int i = tid; i < (int)grid; i += blockDim.x) {
    const int c = hist[i];
    if (c) hist[i] = atomicAdd(&cnt[b * (int)grid + i], c);
  }
  __syncthreads();
  for (int e = lo + tid; e < hi; e += blockDim.x) {
    const int r = rank[e];
    if (r >= 0) rank[e] = r + hist[src[e]];
  }
}

// 2 and 5. Exclusive scan of cnt[0, nb) into excl[0, nb], excl[nb] the
// total, in one block.  With `list`: the ids of the counters above `cap`,
// ascending, and their number in *n_list.  With `n_out`: n_out[b] =
// excl[(b + 1) * grid] - excl[b * grid].  Each counter carries its list
// flag in the high word of one 64-bit sum.  cnt and excl are 16-B aligned.
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_kernel(const int* __restrict__ cnt, int nb, int cap,
                int* __restrict__ excl, int* __restrict__ list,
                int* __restrict__ n_list, int grid, int n_tenants,
                long long* __restrict__ n_out) {
  __shared__ unsigned long long warp_excl[32];
  __shared__ unsigned long long block_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long carry = 0;
  for (int base = 0; base < nb; base += SCAN_THREADS * SCAN_ITEMS) {
    const int i0 = base + tid * SCAN_ITEMS;
    const bool whole = i0 + SCAN_ITEMS <= nb;
    int c[SCAN_ITEMS];
    if (whole) {
#pragma unroll
      for (int q = 0; q < SCAN_ITEMS / 4; ++q) {
        const int4 v = reinterpret_cast<const int4*>(cnt + i0)[q];
        c[4 * q] = v.x;
        c[4 * q + 1] = v.y;
        c[4 * q + 2] = v.z;
        c[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k)
        c[k] = i0 + k < nb ? cnt[i0 + k] : 0;
    }
    unsigned long long sum = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k)
      sum += (unsigned long long)(unsigned)c[k] |
             ((unsigned long long)(c[k] > cap) << 32);
    unsigned long long incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_excl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const unsigned long long t = warp_excl[lane];
      unsigned long long wi = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long u = __shfl_up_sync(FULL, wi, o);
        if (lane >= o) wi += u;
      }
      warp_excl[lane] = wi - t;
      if (lane == 31) block_total = wi;
    }
    __syncthreads();
    unsigned long long run = carry + warp_excl[warp] + incl - sum;
    int out[SCAN_ITEMS];
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      out[k] = (int)(unsigned)run;
      if (list != nullptr && c[k] > cap && i0 + k < nb)
        list[run >> 32] = i0 + k;
      run += (unsigned long long)(unsigned)c[k] |
             ((unsigned long long)(c[k] > cap) << 32);
    }
    if (whole) {
#pragma unroll
      for (int q = 0; q < SCAN_ITEMS / 4; ++q)
        reinterpret_cast<int4*>(excl + i0)[q] =
            make_int4(out[4 * q], out[4 * q + 1], out[4 * q + 2],
                      out[4 * q + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k)
        if (i0 + k < nb) excl[i0 + k] = out[k];
    }
    carry += block_total;
    __syncthreads();
  }
  if (tid == 0) {
    excl[nb] = (int)(unsigned)carry;
    if (n_list != nullptr) *n_list = (int)(carry >> 32);
  }
  if (n_out != nullptr) {
    __syncthreads();
    for (int b = tid; b < n_tenants; b += blockDim.x)
      n_out[b] = excl[(b + 1) * grid] - excl[b * grid];
  }
}

// 3. Each real row's (dst, w) to its place in its bucket, a block a
// count chunk.  The chunk's rows are first ordered by bucket in shared
// memory: its rows of one bucket have consecutive ranks, so the stores go
// out as runs of consecutive addresses (one store a row in slab order hits
// a random sector each).  Dynamic shared memory: CHUNK rows and their
// places, then grid ints.
__global__ void __launch_bounds__(CHUNK_THREADS)
    scatter_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                   const float* __restrict__ w, int ne_row, int chunks,
                   unsigned grid, const int* __restrict__ rank,
                   const int* __restrict__ start, Row* __restrict__ rows) {
  extern __shared__ Row stage[];  // [CHUNK]
  int* place = reinterpret_cast<int*>(stage + CHUNK);  // [CHUNK]
  int* hist = place + CHUNK;                           // [grid]
  __shared__ int sh[33];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / chunks;
  const int lo = b * ne_row + (blockIdx.x - b * chunks) * CHUNK;
  const int hi = min(lo + CHUNK, (b + 1) * ne_row);
  for (int i = tid; i < (int)grid; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int e = lo + tid; e < hi; e += blockDim.x)
    if (rank[e] >= 0) atomicAdd(&hist[src[e]], 1);
  __syncthreads();
  int carry = 0;
  for (int b0 = 0; b0 < (int)grid; b0 += blockDim.x) {
    const int i = b0 + tid;
    const int v = i < (int)grid ? hist[i] : 0;
    int round;
    const int ex = block_excl(v, sh, round);
    if (i < (int)grid) hist[i] = carry + ex;
    carry += round;
  }
  __syncthreads();
  for (int e = lo + tid; e < hi; e += blockDim.x) {
    const int r = rank[e];
    if (r < 0) continue;
    const int s = src[e];
    const int slot = atomicAdd(&hist[s], 1);
    stage[slot] = Row{dst[e], w[e]};
    place[slot] = start[b * (int)grid + s] + r;
  }
  __syncthreads();
  for (int i = tid; i < carry; i += blockDim.x) rows[place[i]] = stage[i];
}

// 4, c <= 32: the bucket's rows, a lane each, sorted by dst, each run of
// equal dst summed in f64 and its end written, in order, to rows[0, k).
// Returns k.  Every lane of the warp calls it with the same c.
__device__ int warp_sort_dedup(Row* rows, int c, int lane) {
  int key = INT_MAX;
  float val = 0.0f;
  if (lane < c) {
    const Row r = rows[lane];
    key = r.d;
    val = r.w;
  }
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int pk = __shfl_xor_sync(FULL, key, j);
      const float pv = __shfl_xor_sync(FULL, val, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      if (keep_min ? pk < key : pk > key) {
        key = pk;
        val = pv;
      }
    }
  }
  // Runs of equal keys are contiguous; padding lanes (INT_MAX) sort last.
  const int prev = __shfl_up_sync(FULL, key, 1);
  const int next = __shfl_down_sync(FULL, key, 1);
  const bool valid = key != INT_MAX;
  const bool end = valid && (lane == 31 || next != key);
  int head = valid && (lane == 0 || prev != key) ? lane : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) head = max(head, __shfl_up_sync(FULL, head, o));
  double v = val;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(FULL, v, o);
    if (lane - o >= head) v += t;
  }
  const unsigned ends = __ballot_sync(FULL, end);
  if (end) rows[__popc(ends & lanemask_lt(lane))] = Row{key, (float)v};
  return __popc(ends);
}

// The slot with the most rows, the lowest on a tie, as (count << 32 |
// (n - 1 - slot)); the reduction's identity is 0.
__device__ __forceinline__ long long slot_key(int count, int slot, int n) {
  return ((long long)count << 32) | (unsigned)(n - 1 - slot);
}

// 4, 32 < c <= WCAP: the bucket's rows counted and summed per dst in the
// warp's dense row of grid slots (clean on entry and on return; an int
// count and an f64 sum a slot), the slot with the most rows summed in
// registers -- shared-memory f64 atomics are compare-and-swap loops that
// serialize on a hot slot -- and the present slots written, in order, to
// rows[0, k).  Returns k.
__device__ int warp_table_dedup(Row* rows, int c, int lane, int grid,
                                double* tacc, int* tnum) {
  for (int i0 = lane; i0 < c; i0 += ROW_LOADS * 32) {
    int d[ROW_LOADS];
#pragma unroll
    for (int u = 0; u < ROW_LOADS; ++u) {
      const int i = i0 + u * 32;
      d[u] = i < c ? rows[i].d : -1;
    }
#pragma unroll
    for (int u = 0; u < ROW_LOADS; ++u)
      if (d[u] >= 0) atomicAdd(&tnum[d[u]], 1);
  }
  __syncwarp();
  long long best = 0;
  for (int sl = lane; sl < grid; sl += 32)
    best = max(best, slot_key(tnum[sl], sl, grid));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, o));
  const int hot = grid - 1 - (int)(best & 0xffffffff);
  double hot_sum = 0.0;
  for (int i0 = lane; i0 < c; i0 += ROW_LOADS * 32) {
    Row r[ROW_LOADS];
#pragma unroll
    for (int u = 0; u < ROW_LOADS; ++u) {
      const int i = i0 + u * 32;
      r[u] = i < c ? rows[i] : Row{-1, 0.0f};
    }
#pragma unroll
    for (int u = 0; u < ROW_LOADS; ++u) {
      if (r[u].d == hot)
        hot_sum += (double)r[u].w;
      else if (r[u].d >= 0)
        atomicAdd(&tacc[r[u].d], (double)r[u].w);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hot_sum += __shfl_xor_sync(FULL, hot_sum, o);
  __syncwarp();
  if (lane == 0) tacc[hot] += hot_sum;
  __syncwarp();
  int k = 0;
  for (int b0 = 0; b0 < grid; b0 += 32) {
    const int sl = b0 + lane;
    const bool p = sl < grid && tnum[sl] > 0;
    const unsigned bal = __ballot_sync(FULL, p);
    if (p) {
      rows[k + __popc(bal & lanemask_lt(lane))] = Row{sl, (float)tacc[sl]};
      tacc[sl] = 0.0;
      tnum[sl] = 0;
    }
    k += __popc(bal);
  }
  __syncwarp();
  return k;
}

// 4, the buckets of at most `cap` rows, a warp a bucket.  Dynamic shared
// memory, when grid <= WTABLE_MAX: each warp's table, grid f64 sums and
// grid int counts.
__global__ void __launch_bounds__(WARP_THREADS)
    dedup_warp_kernel(const int* __restrict__ cnt,
                      const int* __restrict__ start, int nb, int cap,
                      int grid, Row* __restrict__ dd,
                      int* __restrict__ distinct) {
  extern __shared__ double tab[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int per_block = blockDim.x >> 5;
  double* tacc = tab + wib * grid;
  int* tnum = reinterpret_cast<int*>(tab + per_block * grid) + wib * grid;
  if (cap > 32) {
    for (int i = lane; i < grid; i += 32) {
      tacc[i] = 0.0;
      tnum[i] = 0;
    }
    __syncwarp();
  }
  const int n_warps = gridDim.x * per_block;
  for (int key = blockIdx.x * per_block + wib; key < nb; key += n_warps) {
    const int c = cnt[key];
    if (c > cap) continue;  // the dense list's
    Row* rows = dd + start[key];
    int k = 0;
    if (c > 32)
      k = warp_table_dedup(rows, c, lane, grid, tacc, tnum);
    else if (c > 0)
      k = warp_sort_dedup(rows, c, lane);
    if (lane == 0) distinct[key] = k;
  }
}

// 4, the dense list: a block a bucket.  Tile by tile over [0, grid): the
// rows of the tile's dst range are counted and summed per dst slot in
// shared memory (an f64 sum and an int count a slot).  Shared-memory f64
// atomics are compare-and-swap loops that serialize on a hot slot, and a
// late phase's bucket sends most of its rows to one dst (its self-loop):
// so the slot with the most rows is summed in registers and reduced over
// the block, the others by atomics.  The present slots go, in order, to
// (run_d, run_w), the bucket's own place in (dst_c, w_c): a tile's rows
// are re-read, so the runs reach the front of the bucket's rows only after
// the last tile.  Each thread keeps ROW_LOADS row loads in flight.
// Dynamic shared memory: 12 B a slot.
__global__ void __launch_bounds__(DENSE_THREADS)
    dedup_dense_kernel(const int* __restrict__ cnt,
                       const int* __restrict__ start,
                       const int* __restrict__ list,
                       const int* __restrict__ n_list, unsigned grid,
                       int tile, Row* __restrict__ dd,
                       int* __restrict__ stage_d, float* __restrict__ stage_w,
                       int* __restrict__ distinct) {
  extern __shared__ double acc[];  // [tile] sums, then [tile] row counts
  int* num = reinterpret_cast<int*>(acc + tile);
  __shared__ int sh[33];
  __shared__ long long red_ll[32];
  __shared__ double red_d[32];
  const int tid = threadIdx.x;
  const int per = (tile + blockDim.x - 1) / blockDim.x;  // emission slots
  const int n = *n_list;
  for (int li = blockIdx.x; li < n; li += gridDim.x) {
    const int key = list[li];
    const int c = cnt[key];
    const int s0 = start[key];
    const Row* rows = dd + s0;
    int* run_d = stage_d + s0;
    float* run_w = stage_w + s0;
    int k = 0;  // runs emitted
    for (unsigned lo = 0; lo < grid; lo += tile) {
      for (int i = tid; i < tile; i += blockDim.x) {
        acc[i] = 0.0;
        num[i] = 0;
      }
      __syncthreads();
      for (int i0 = tid; i0 < c; i0 += ROW_LOADS * blockDim.x) {
        int d[ROW_LOADS];
#pragma unroll
        for (int u = 0; u < ROW_LOADS; ++u) {
          const int i = i0 + u * blockDim.x;
          d[u] = i < c ? rows[i].d : -1;
        }
#pragma unroll
        for (int u = 0; u < ROW_LOADS; ++u) {
          const unsigned off = (unsigned)d[u] - lo;
          if (off < (unsigned)tile) atomicAdd(&num[off], 1);
        }
      }
      __syncthreads();
      // The slot with the most rows, the lowest on a tie.
      long long best = 0;
      for (int sl = tid; sl < tile; sl += blockDim.x)
        best = max(best, slot_key(num[sl], sl, tile));
      best = block_reduce(best, red_ll,
                          [](long long a, long long b) { return max(a, b); });
      const int hot = (best >> 32) > 0 ? tile - 1 - (int)(best & 0xffffffff)
                                       : -1;
      double hot_sum = 0.0;
      for (int i0 = tid; i0 < c; i0 += ROW_LOADS * blockDim.x) {
        Row r[ROW_LOADS];
#pragma unroll
        for (int u = 0; u < ROW_LOADS; ++u) {
          const int i = i0 + u * blockDim.x;
          r[u] = i < c ? rows[i] : Row{-1, 0.0f};
        }
#pragma unroll
        for (int u = 0; u < ROW_LOADS; ++u) {
          const unsigned off = (unsigned)r[u].d - lo;
          if (off == (unsigned)hot)
            hot_sum += (double)r[u].w;
          else if (off < (unsigned)tile)
            atomicAdd(&acc[off], (double)r[u].w);
        }
      }
      hot_sum = block_reduce(hot_sum, red_d,
                             [](double a, double b) { return a + b; });
      if (tid == 0 && hot >= 0) acc[hot] += hot_sum;
      __syncthreads();
      // The present slots in ascending order: `per` consecutive slots a
      // thread, one block scan.
      const int s_lo = min(tid * per, tile), s_hi = min(s_lo + per, tile);
      int mine = 0;
      for (int sl = s_lo; sl < s_hi; ++sl) mine += num[sl] > 0;
      int found;
      int at = k + block_excl(mine, sh, found);
      for (int sl = s_lo; sl < s_hi; ++sl) {
        if (num[sl] > 0) {
          run_d[at] = (int)lo + sl;
          run_w[at] = (float)acc[sl];
          ++at;
        }
      }
      k += found;
      __syncthreads();
    }
    for (int i = tid; i < k; i += blockDim.x)
      dd[s0 + i] = Row{run_d[i], run_w[i]};
    if (tid == 0) distinct[key] = k;
  }
}

// 6. Each bucket's runs to its tenant's prefix (a warp a bucket), then the
// padding after each tenant's n[b] rows.
__global__ void emit_kernel(const int* __restrict__ distinct,
                            const int* __restrict__ start,
                            const int* __restrict__ off, int nb, int kbits,
                            int ne_row, int n_rows, int nv_pad,
                            const Row* __restrict__ dd,
                            int* __restrict__ src_c, int* __restrict__ dst_c,
                            float* __restrict__ w_c) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int mask = (1 << kbits) - 1;
  for (int key = tid >> 5; key < nb; key += stride >> 5) {
    const int k = distinct[key];
    if (k == 0) continue;
    const int b = key >> kbits;
    const int o = b * ne_row + off[key] - off[b << kbits];
    const Row* from = dd + start[key];
    for (int j = lane; j < k; j += 32) {
      const Row r = from[j];
      src_c[o + j] = key & mask;
      dst_c[o + j] = r.d;
      w_c[o + j] = r.w;
    }
  }
  for (int i = tid; i < n_rows; i += stride) {
    const int b = i / ne_row;
    if (i - b * ne_row >= off[(b + 1) << kbits] - off[b << kbits]) {
      src_c[i] = nv_pad;
      dst_c[i] = 0;
      w_c[i] = 0.0f;
    }
  }
}

int blocks_for(long long work, long long per_block, int most) {
  const long long b = (work + per_block - 1) / per_block;
  return (int)(b < 1 ? 1 : (b > most ? most : b));
}

// Raise a kernel's dynamic shared memory limit when `bytes` may not fit
// the default 48 KB, which the kernel's static shared memory shares.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 32 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The shape of one launch, and where its scratch arrays lie.
struct Plan {
  int nb, ne, stride, cap, tile;
  long long ints_bytes, rows_bytes;

  Plan(int n_tenants, int ne_row, int grid)
      : nb(n_tenants * grid), ne(n_tenants * ne_row),
        stride((nb + 4) & ~3),
        cap(grid <= WTABLE_MAX ? WCAP : 32),
        tile(grid < TILE_MAX ? grid : TILE_MAX),
        ints_bytes(((5LL * stride + 4) * sizeof(int) + 255) & ~255LL),
        rows_bytes((long long)ne * sizeof(Row)) {}

  long long bytes() const { return ints_bytes + rows_bytes; }
};

}  // namespace

#define CV_CHECK(call)                             \
  do {                                             \
    const cudaError_t e_ = (call);                 \
    if (e_ != cudaSuccess) return (int)e_;         \
  } while (0)

// Bytes of `scratch` for one launch: five arrays of B * grid + 1
// counters (each padded to 16 B) and the dense list's length, then
// B * ne_row (dst, w) pairs.
extern "C" long long cv_seg_coalesce_scratch_bytes(int n_tenants, int ne_row,
                                                   int grid) {
  return Plan(n_tenants, ne_row, grid).bytes();
}

// src/dst/w: [n_tenants, ne_row] row-major.  Outputs src_c/dst_c/w_c
// [n_tenants, ne_row] and n_out [n_tenants]; scratch: 256-B aligned,
// cv_seg_coalesce_scratch_bytes(...) bytes.  The caller keeps
// n_tenants * ne_row and n_tenants * grid at most 2^30.
extern "C" int cv_seg_coalesce(const int* src, const int* dst,
                               const float* w, int n_tenants, int ne_row,
                               int grid, int nv_pad, int* src_c, int* dst_c,
                               float* w_c, long long* n_out, void* scratch,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid < 1 || (grid & (grid - 1)) != 0 || grid > (1 << 15) ||
      ne_row < 0 || n_tenants < 1)
    return cudaErrorInvalidValue;
  int kbits = 0;
  while ((1 << kbits) < grid) ++kbits;
  const Plan plan(n_tenants, ne_row, grid);
  const int nb = plan.nb, ne = plan.ne, cap = plan.cap;
  if (ne == 0)
    return (int)cudaMemsetAsync(n_out, 0, n_tenants * sizeof(long long), st);
  char* base = static_cast<char*>(scratch);
  int* cnt = reinterpret_cast<int*>(base);
  int* start = cnt + plan.stride;
  int* distinct = start + plan.stride;
  int* off = distinct + plan.stride;
  int* list = off + plan.stride;
  int* n_list = list + plan.stride;
  Row* rows = reinterpret_cast<Row*>(base + plan.ints_bytes);

  CV_CHECK(cudaMemsetAsync(cnt, 0, nb * sizeof(int), st));
  const int chunks = (ne_row + CHUNK - 1) / CHUNK;
  const size_t hist = (size_t)grid * sizeof(int);
  CV_CHECK(allow_smem(count_kernel, hist));
  count_kernel<<<n_tenants * chunks, CHUNK_THREADS, hist, st>>>(
      src, dst, ne_row, chunks, (unsigned)grid, cnt, src_c);
  CV_CHECK(cudaGetLastError());
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(cnt, nb, cap, start, list, n_list,
                                          grid, n_tenants, nullptr);
  CV_CHECK(cudaGetLastError());
  const size_t staged = (size_t)CHUNK * (sizeof(Row) + sizeof(int)) + hist;
  CV_CHECK(allow_smem(scatter_kernel, staged));
  scatter_kernel<<<n_tenants * chunks, CHUNK_THREADS, staged, st>>>(
      src, dst, w, ne_row, chunks, (unsigned)grid, src_c, start, rows);
  CV_CHECK(cudaGetLastError());
  const size_t table =
      cap > 32
          ? (size_t)(WARP_THREADS / 32) * grid * (sizeof(double) + sizeof(int))
          : 0;
  CV_CHECK(allow_smem(dedup_warp_kernel, table));
  dedup_warp_kernel<<<blocks_for(nb, WARP_THREADS / 32, WARP_BLOCKS_MAX),
                      WARP_THREADS, table, st>>>(cnt, start, nb, cap, grid,
                                                 rows, distinct);
  CV_CHECK(cudaGetLastError());
  if (ne > cap) {
    const size_t smem = (size_t)plan.tile * (sizeof(double) + sizeof(int));
    CV_CHECK(allow_smem(dedup_dense_kernel, smem));
    dedup_dense_kernel<<<blocks_for(ne, cap + 1, DENSE_BLOCKS_MAX),
                         DENSE_THREADS, smem, st>>>(
        cnt, start, list, n_list, (unsigned)grid, plan.tile, rows, dst_c, w_c,
        distinct);
    CV_CHECK(cudaGetLastError());
  }
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(distinct, nb, INT_MAX, off,
                                          nullptr, nullptr, grid, n_tenants,
                                          n_out);
  CV_CHECK(cudaGetLastError());
  emit_kernel<<<blocks_for(ne, ROW_THREADS, ROW_BLOCKS_MAX), ROW_THREADS, 0,
                st>>>(
      distinct, start, off, nb, kbits, ne_row, ne, nv_pad, rows, src_c, dst_c,
      w_c);
  CV_CHECK(cudaGetLastError());
  return 0;
}
