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
// Padding slots carry dst = v and w = 0: their community is curr, so they
// add 0 to counter0 and are never candidates.  Padding rows carry
// verts = nv and are computed against vertex nv-1 (the caller drops them).
//
// What bounds it on an H100: memory.  Each slot costs 8 bytes of dst and w
// plus a 4-byte gather of comm, against a handful of flops, so the floor is
// the slab bytes over 3.35 TB/s.  Design:
//   D in {8, 16, 32}: D lanes per row (32/D rows per warp); the all-pairs
//     dedup runs in registers through shuffles, the first occurrence leads.
//   other D (64 ... 8192): one block per row; the row's distinct
//     communities are aggregated in a shared-memory open-addressing table
//     of next_pow2(2D) (key, sum) slots -- 128 KB at D = 8192, which needs
//     the raised dynamic shared-memory limit -- then one pass over the
//     table and a block reduction pick the argmax.
// Weights are summed in another order than the reference's (and with
// float atomics in the wide form): see the exactness domain in common.cuh.
#include "common.cuh"

namespace {

template <int D>
__global__ void row_argmax_narrow(const int* __restrict__ dst,
                                  const float* __restrict__ w,
                                  const int* __restrict__ verts,
                                  long long n_rows,
                                  const int* __restrict__ comm,
                                  const float* __restrict__ comm_deg,
                                  const float* __restrict__ vdeg,
                                  const float* __restrict__ self_loop, int nv,
                                  float cst, int sentinel,
                                  int* __restrict__ best_c,
                                  float* __restrict__ best_gain,
                                  float* __restrict__ counter0) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / D;
  const int lane = (int)(t % D);
  const bool live = row < n_rows;  // dead lanes still join the shuffles
  int curr = 0, c = cv::kEmpty;
  float vd = 0.0f, sl = 0.0f, ax = 0.0f, wj = 0.0f;
  if (live) {
    const int v = min(verts[row], nv - 1);
    curr = comm[v];
    vd = vdeg[v];
    sl = self_loop[v];
    ax = __fsub_rn(comm_deg[curr], vd);
    const long long e = row * D + lane;
    c = comm[dst[e]];
    wj = w[e];
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
  float g = valid ? cv::gain(wagg, eix, vd, comm_deg[c], ax, cst)
                  : -CUDART_INF_F;
  int b = valid ? c : sentinel;
  cv::group_argmax<D>(g, b);
  if (live && lane == 0) {
    best_c[row] = b;
    best_gain[row] = g;
    counter0[row] = c0;
  }
}

__global__ void row_argmax_wide(const int* __restrict__ dst,
                                const float* __restrict__ w,
                                const int* __restrict__ verts, int width,
                                const int* __restrict__ comm,
                                const float* __restrict__ comm_deg,
                                const float* __restrict__ vdeg,
                                const float* __restrict__ self_loop, int nv,
                                float cst, int sentinel, unsigned mask,
                                int* __restrict__ best_c,
                                float* __restrict__ best_gain,
                                float* __restrict__ counter0) {
  extern __shared__ int table[];
  int* keys = table;
  float* vals = reinterpret_cast<float*>(table + mask + 1);
  const long long row = blockIdx.x;
  for (unsigned s = threadIdx.x; s <= mask; s += blockDim.x) {
    keys[s] = cv::kEmpty;
    vals[s] = 0.0f;
  }
  const int v = min(verts[row], nv - 1);
  const int curr = comm[v];
  const float vd = vdeg[v];
  const float sl = self_loop[v];
  const float ax = __fsub_rn(comm_deg[curr], vd);
  __syncthreads();
  const int* drow = dst + row * width;
  const float* wrow = w + row * width;
  float c0 = 0.0f;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    const int c = comm[drow[j]];
    const float x = wrow[j];
    if (c == curr)
      c0 = __fadd_rn(c0, x);
    else
      cv::table_add(keys, vals, mask, c, x);
  }
  c0 = cv::block_sum(c0);  // also orders the table writes before the scan
  const float eix = __fsub_rn(c0, sl);
  float g = -CUDART_INF_F;
  int b = sentinel;
  for (unsigned s = threadIdx.x; s <= mask; s += blockDim.x) {
    const int k = keys[s];
    if (k != cv::kEmpty) {
      const float gk = cv::gain(vals[s], eix, vd, comm_deg[k], ax, cst);
      if (cv::better(gk, k, g, b)) {
        g = gk;
        b = k;
      }
    }
  }
  cv::block_argmax(g, b, sentinel);
  if (threadIdx.x == 0) {
    best_c[row] = b;
    best_gain[row] = g;
    counter0[row] = c0;
  }
}

}  // namespace

// Largest width the wide form takes: next_pow2(2 * 8192) slots of 8 bytes
// fill 128 KB of the 227 KB a block may have.
constexpr int kMaxWidth = 8192;

extern "C" int cv_row_argmax(const int* dst, const float* w, const int* verts,
                             long long n_rows, int width, const int* comm,
                             const float* comm_deg, const float* vdeg,
                             const float* self_loop, int nv, float cst,
                             int sentinel, int* best_c, float* best_gain,
                             float* counter0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0) return 0;
  if (width < 1 || width > kMaxWidth || nv < 1) return cudaErrorInvalidValue;
  if (width == 8 || width == 16 || width == 32) {
    const int threads = 256;
    const long long blocks = (n_rows * width + threads - 1) / threads;
    if (width == 8)
      row_argmax_narrow<8><<<(unsigned)blocks, threads, 0, st>>>(
          dst, w, verts, n_rows, comm, comm_deg, vdeg, self_loop, nv, cst,
          sentinel, best_c, best_gain, counter0);
    else if (width == 16)
      row_argmax_narrow<16><<<(unsigned)blocks, threads, 0, st>>>(
          dst, w, verts, n_rows, comm, comm_deg, vdeg, self_loop, nv, cst,
          sentinel, best_c, best_gain, counter0);
    else
      row_argmax_narrow<32><<<(unsigned)blocks, threads, 0, st>>>(
          dst, w, verts, n_rows, comm, comm_deg, vdeg, self_loop, nv, cst,
          sentinel, best_c, best_gain, counter0);
    return (int)cudaGetLastError();
  }
  unsigned slots = 1;
  while (slots < 2u * (unsigned)width) slots <<= 1;
  const size_t smem = (size_t)slots * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        row_argmax_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = width >= 256 ? 256 : ((width + 31) / 32) * 32;
  row_argmax_wide<<<(unsigned)n_rows, threads, smem, st>>>(
      dst, w, verts, width, comm, comm_deg, vdeg, self_loop, nv, cst,
      sentinel, slots - 1, best_c, best_gain, counter0);
  return (int)cudaGetLastError();
}
