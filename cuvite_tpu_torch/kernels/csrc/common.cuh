// Shared device helpers of the port's Louvain kernels: the modularity gain
// in the reference's operand order, the (gain desc, community asc) argmax
// order, warp/block reductions and an open-addressing hash table that
// aggregates edge weights by community.
//
// Exactness domain: the kernels sum edge weights with float atomics and in
// tree order, so their sums equal the reference's only where every partial
// sum is exact in float32 -- integer weights below 2^24 (R-MAT and every
// coarse phase of it) and dyadic weights.  Outside it the sums are still
// correct to f32 rounding, but ties may break differently from run to run.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace cv {

constexpr int kEmpty = -1;        // community ids are >= 0
constexpr unsigned kFull = 0xffffffffu;

// 2*(wagg - eix) - ((2*vdeg)*(ay - ax))*c  (reference louvain.cpp:2228,
// cuvite_tpu/kernels/row_argmax.py:105).  Every product and difference is
// rounded on its own: c = 1/(2m) is not dyadic, so a fused multiply-add
// would change the last bit of a gain and could flip a tie.  The build
// passes -fmad=false as well; the _rn intrinsics keep the order if it is
// ever dropped.
__device__ __forceinline__ float gain(float wagg, float eix, float vdeg,
                                      float ay, float ax, float c) {
  const float lhs = __fmul_rn(2.0f, __fsub_rn(wagg, eix));
  const float rhs =
      __fmul_rn(__fmul_rn(__fmul_rn(2.0f, vdeg), __fsub_rn(ay, ax)), c);
  return __fsub_rn(lhs, rhs);
}

// Max gain first; among equal gains the smaller community id.
__device__ __forceinline__ bool better(float g, int c, float bg, int bc) {
  return g > bg || (g == bg && c < bc);
}

// Reductions over aligned groups of W lanes (W a power of two <= 32); every
// lane of the warp must take part.  The result is in every lane of the
// group.
template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, off, W));
  return x;
}

template <int W>
__device__ __forceinline__ void group_argmax(float& g, int& c) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const float og = __shfl_xor_sync(kFull, g, off, W);
    const int oc = __shfl_xor_sync(kFull, c, off, W);
    if (better(og, oc, g, c)) {
      g = og;
      c = oc;
    }
  }
}

// Block-wide sum, returned to every thread.  blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float part[32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  x = group_sum<32>(x);
  if (lane == 0) part[wid] = x;
  __syncthreads();
  if (wid == 0) {
    x = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.0f;
    x = group_sum<32>(x);
    if (lane == 0) total = x;
  }
  __syncthreads();
  return total;
}

// Block-wide argmax; the result is valid in thread 0.
__device__ __forceinline__ void block_argmax(float& g, int& c, int sentinel) {
  __shared__ float pg[32];
  __shared__ int pc[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  group_argmax<32>(g, c);
  if (lane == 0) {
    pg[wid] = g;
    pc[wid] = c;
  }
  __syncthreads();
  if (wid == 0) {
    const bool have = lane < (int)(blockDim.x >> 5);
    g = have ? pg[lane] : -CUDART_INF_F;
    c = have ? pc[lane] : sentinel;
    group_argmax<32>(g, c);
  }
}

__device__ __forceinline__ unsigned mix(int key) {  // murmur3 fmix32
  unsigned h = (unsigned)key;
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// Add w to the entry of `key`, inserting it if absent.  The table (shared
// or global memory) has mask+1 slots, a power of two larger than the
// number of distinct keys, so the linear probe always ends.  An entry
// exists because an edge reached its community, whatever the weight: a
// zero-weight edge still makes a candidate.
__device__ __forceinline__ void table_add(int* keys, float* vals,
                                          unsigned mask, int key, float w) {
  unsigned h = mix(key) & mask;
  while (true) {
    const int prev = atomicCAS(&keys[h], kEmpty, key);
    if (prev == kEmpty || prev == key) {
      atomicAdd(&vals[h], w);
      return;
    }
    h = (h + 1) & mask;
  }
}

}  // namespace cv
