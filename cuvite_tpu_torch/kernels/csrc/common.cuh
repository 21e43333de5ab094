// Shared device helpers of the port's Louvain kernels: the modularity gain
// in the reference's operand order, the (gain desc, community asc) argmax
// order, warp/block reductions and an open-addressing hash table that
// aggregates edge weights by community, with warp-aggregated inserts.
//
// Exactness domain: the kernels sum edge weights with float atomics, in
// shuffle trees and in tree order, so their sums equal the reference's only
// where every partial sum is exact in float32 -- integer weights below 2^24
// (R-MAT and every coarse phase of it) and dyadic weights.  Outside it the
// sums are still correct to f32 rounding, but ties may break differently
// from run to run.
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

// Hash-table slots for `n` distinct keys: the power of two >= 2n, so the
// load factor stays at most 1/2.
__host__ __device__ __forceinline__ unsigned table_slots(int n) {
  unsigned s = 1;
  while (s < 2u * (unsigned)n) s <<= 1;
  return s;
}

// The slot of `key` in an open-addressing table (shared or global memory)
// of mask+1 slots, a power of two larger than the number of distinct keys,
// so the linear probe always ends.  A slot goes from kEmpty to its key once
// and never changes again, so a plain read that sees the key is final and
// only an empty slot needs the atomicCAS.  `claimed` is set when this call
// inserted the key.
__device__ __forceinline__ unsigned table_find(int* keys, unsigned mask,
                                               int key, bool& claimed) {
  unsigned h = mix(key) & mask;
  while (true) {
    int k = *reinterpret_cast<volatile int*>(&keys[h]);
    if (k == kEmpty) {
      k = atomicCAS(&keys[h], kEmpty, key);
      if (k == kEmpty) {
        claimed = true;
        return h;
      }
    }
    if (k == key) return h;
    h = (h + 1) & mask;
  }
}

// Add w to the entry of `key`, inserting it if absent; the inserting call
// also stores `ay` (the community's degree) beside it when `ays` is given.
// An entry exists because an edge reached its community, whatever the
// weight: a zero-weight edge still makes a candidate.
__device__ __forceinline__ void table_add(int* keys, float* vals,
                                          float* ays, unsigned mask, int key,
                                          float w, float ay) {
  bool claimed = false;
  const unsigned h = table_find(keys, mask, key, claimed);
  if (claimed && ays != nullptr) ays[h] = ay;
  atomicAdd(&vals[h], w);
}

// Warp-aggregated insert: every lane of the warp calls it (key kEmpty for
// a lane with nothing to insert).  A cheap test looks for repeated keys
// (a lane holding the first active lane's key, or its neighbour's); when
// it finds none every lane inserts on its own.  Otherwise lanes holding the
// same key are grouped with __match_any_sync, their weights summed by
// pointer jumping along the list of peer lanes (ceil(log2(largest group))
// shuffle rounds) and the lowest lane of each group makes the one
// table_add.  A row whose slots fall in a few communities (a converged
// sweep, a hub inside one community) then costs one atomic per community
// and warp, not one per slot on a hot address; a row of distinct
// communities does not pay for __match_any_sync.
__device__ __forceinline__ void warp_insert(int* keys, float* vals,
                                            float* ays, unsigned mask,
                                            int key, float x, float ay) {
  const bool have = key != kEmpty;
  const unsigned act = __ballot_sync(kFull, have);
  if (act == 0) return;
  const int lane = threadIdx.x & 31;
  const int first = __ffs(act) - 1;
  const int k0 = __shfl_sync(kFull, key, first);
  const int kn = __shfl_xor_sync(kFull, key, 1);
  const bool dup = have && ((key == k0 && lane != first) || key == kn);
  if (__ballot_sync(kFull, dup) == 0) {
    if (have) table_add(keys, vals, ays, mask, key, x, ay);
    return;
  }
  const unsigned peers = __match_any_sync(kFull, key);
  const unsigned group = __reduce_max_sync(kFull, have ? __popc(peers) : 1u);
  float s = x;
  const unsigned above = peers & ~(0xffffffffu >> (31 - lane));
  int nxt = above ? __ffs(above) - 1 : 32;   // next peer lane, 32: none
  for (unsigned span = 1; span < group; span <<= 1) {
    const float sn = __shfl_sync(kFull, s, nxt & 31);
    const int nn = __shfl_sync(kFull, nxt, nxt & 31);
    if (nxt < 32) {
      s = __fadd_rn(s, sn);
      nxt = nn;
    }
  }
  if (have && (peers & ((1u << lane) - 1u)) == 0)
    table_add(keys, vals, ays, mask, key, s, ay);
}

}  // namespace cv
