// Segmented coalesce: the dense per-(src, dst) weight sum and presence
// count of a relabeled edge slab, the accumulate half of the inter-phase
// coarsening of the sort engine.
//
// Replaces: seg_coalesce_pallas (cuvite_tpu/kernels/seg_coalesce.py:202,
// body _kernel :175).  The TPU kernel tiles the dst range so a
// [nv_pad, C] accumulator pair fits VMEM and scans the whole slab once per
// tile.  That tiling serves a VMEM budget the card does not have and is
// not carried over: the card holds the whole [nv_pad, nv_pad] pair in
// device memory (192 MiB at nv_pad = 4096) and scans the slab once.
//
// Function: for every slab row with src < nv_pad and dst < nv_pad, add w
// to acc[src * nv_pad + dst] and 1 to cnt[src * nv_pad + dst]; padding
// rows (src == nv_pad) drop.  The outputs are zeroed first.  The caller
// (emit_coalesced) compacts the present slots, in ascending flat order,
// which is the (src, dst)-sorted run order.
//
// Numbers: acc is float64 and the emission rounds it to float32 once.
// Atomics add in an order that changes from run to run, but in f64 a run
// sum of f32 addends within ~29 bits of each other is exact and therefore
// independent of the order: it equals the host oracle's f64 sum and, on
// unit and dyadic weights, the reference's f32 accumulator.
//
// What bounds it on an H100: bytes -- zeroing and later reading the
// nv_pad^2 x 12 B outputs, against 12 B per slab row.  The late-phase
// slabs that reach this kernel hold 10^3..10^5 rows, so the memset of the
// accumulator sets the time; the atomics are scattered 8 B and 4 B
// updates, one pair per row.  Design: one thread per row, grid-stride,
// native f64 atomicAdd (sm_60+).
#include <cuda_runtime.h>

namespace {

__global__ void seg_coalesce_kernel(const int* __restrict__ src,
                                    const int* __restrict__ dst,
                                    const float* __restrict__ w,
                                    long long ne, int kbits,
                                    unsigned nv_pad, double* __restrict__ acc,
                                    int* __restrict__ cnt) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < ne; e += stride) {
    const unsigned s = (unsigned)src[e];
    const unsigned d = (unsigned)dst[e];
    if (s >= nv_pad || d >= nv_pad) continue;  // padding rows drop
    const long long slot = ((long long)s << kbits) | (long long)d;
    atomicAdd(&acc[slot], (double)w[e]);
    atomicAdd(&cnt[slot], 1);
  }
}

}  // namespace

extern "C" int cv_seg_coalesce(const int* src, const int* dst,
                               const float* w, long long ne, int nv_pad,
                               double* acc, int* cnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nv_pad < 1 || (nv_pad & (nv_pad - 1)) != 0 || ne < 0)
    return cudaErrorInvalidValue;
  int kbits = 0;
  while ((1 << kbits) < nv_pad) ++kbits;
  const size_t n = (size_t)nv_pad * (size_t)nv_pad;
  cudaError_t err = cudaMemsetAsync(acc, 0, n * sizeof(double), st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(cnt, 0, n * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (ne == 0) return 0;
  const int threads = 256;
  long long blocks = (ne + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  seg_coalesce_kernel<<<(unsigned)blocks, threads, 0, st>>>(
      src, dst, w, ne, kbits, (unsigned)nv_pad, acc, cnt);
  return (int)cudaGetLastError();
}
