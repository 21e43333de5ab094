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
// Layout: each hub's edges are its CSR range [eoff[h], eoff[h+1]) of the
// heavy edge arrays; hubs are listed once, with no padding slots.
//
// What bounds it on an H100: memory -- 8 bytes of dst and w plus a comm
// gather per edge, and the table traffic, which stays in L2 for a hub.
// Design: one block per hub.  The hub's distinct communities are
// aggregated in an open-addressing (key, sum) table in a global scratch
// region the wrapper allocates, next_pow2(2 * degree) slots per hub, so the
// scratch is O(heavy edges) bytes.  Each block clears its own region, adds
// its edges with atomics, then scans the table and reduces the argmax.
// Weights are summed in another order than the reference's: see the
// exactness domain in common.cuh.
#include "common.cuh"

namespace {

__global__ void heavy_argmax_kernel(
    const int* __restrict__ hverts, const long long* __restrict__ eoff,
    const int* __restrict__ dst, const float* __restrict__ w,
    const long long* __restrict__ toff, int* __restrict__ tkeys,
    float* __restrict__ tvals, const int* __restrict__ comm,
    const float* __restrict__ comm_deg, const float* __restrict__ vdeg,
    const float* __restrict__ self_loop, int nv, float cst, int sentinel,
    int* __restrict__ best_c, float* __restrict__ best_gain,
    float* __restrict__ counter0) {
  const int h = blockIdx.x;
  int* keys = tkeys + toff[h];
  float* vals = tvals + toff[h];
  const unsigned mask = (unsigned)(toff[h + 1] - toff[h]) - 1u;
  for (unsigned s = threadIdx.x; s <= mask; s += blockDim.x) {
    keys[s] = cv::kEmpty;
    vals[s] = 0.0f;
  }
  const int v = min(hverts[h], nv - 1);
  const int curr = comm[v];
  const float vd = vdeg[v];
  const float sl = self_loop[v];
  const float ax = __fsub_rn(comm_deg[curr], vd);
  __syncthreads();
  float c0 = 0.0f;
  for (long long e = eoff[h] + threadIdx.x; e < eoff[h + 1]; e += blockDim.x) {
    const int c = comm[dst[e]];
    const float x = w[e];
    if (c == curr)
      c0 = __fadd_rn(c0, x);
    else
      cv::table_add(keys, vals, mask, c, x);
  }
  c0 = cv::block_sum(c0);  // also orders the table atomics before the scan
  const float eix = __fsub_rn(c0, sl);
  float g = -CUDART_INF_F;
  int b = sentinel;
  for (unsigned s = threadIdx.x; s <= mask; s += blockDim.x) {
    const int k = __ldcg(&keys[s]);  // written by atomics at L2
    if (k != cv::kEmpty) {
      const float gk =
          cv::gain(__ldcg(&vals[s]), eix, vd, comm_deg[k], ax, cst);
      if (cv::better(gk, k, g, b)) {
        g = gk;
        b = k;
      }
    }
  }
  cv::block_argmax(g, b, sentinel);
  if (threadIdx.x == 0) {
    best_c[h] = b;
    best_gain[h] = g;
    counter0[h] = c0;
  }
}

}  // namespace

extern "C" int cv_heavy_argmax(const int* hverts, const long long* eoff,
                               const int* dst, const float* w, int n_hubs,
                               const long long* toff, int* tkeys,
                               float* tvals, const int* comm,
                               const float* comm_deg, const float* vdeg,
                               const float* self_loop, int nv, float cst,
                               int sentinel, int* best_c, float* best_gain,
                               float* counter0, void* stream) {
  if (n_hubs <= 0) return 0;
  if (nv < 1) return cudaErrorInvalidValue;
  heavy_argmax_kernel<<<n_hubs, 512, 0, static_cast<cudaStream_t>(stream)>>>(
      hverts, eoff, dst, w, toff, tkeys, tvals, comm, comm_deg, vdeg,
      self_loop, nv, cst, sentinel, best_c, best_gain, counter0);
  return (int)cudaGetLastError();
}
