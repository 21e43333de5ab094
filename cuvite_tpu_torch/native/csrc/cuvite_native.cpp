// cuvite_tpu_torch native host runtime: graph ingest, CSR construction,
// inter-phase coarsening, bucket-plan construction and synthetic-graph
// generation.
//
// The port's own copy of native/cuvite_native.cpp, routine for routine
// (cuvite_tpu_torch never loads the JAX package's library).  The device
// compute path is PyTorch and the CUDA kernels under kernels/csrc;
// everything here runs on the host CPU, feeding the struct-of-arrays
// buffers the device path uploads.  Built at first use by
// cuvite_tpu_torch/native/__init__.py (g++, -ffp-contract=off).
//
// Design constraints:
//  * bit-deterministic: every routine produces output identical to the
//    plain numpy path in cuvite_tpu_torch (tests/test_torch_native.py),
//    so a run is reproducible with or without the native library.
//  * OpenMP where it pays (per-row sorts, deinterleaving); serial where
//    determinism of float accumulation order matters.
//  * C ABI only — bound from Python via ctypes, no pybind11.

#ifndef _FILE_OFFSET_BITS
#define _FILE_OFFSET_BITS 64  // 64-bit off_t for fseeko on 32-bit-long ABIs
#endif

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <type_traits>
#include <sys/types.h>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

// ---------------------------------------------------------------------------
// CSR construction from an edge list (one template, two entry points).
//
// Matches cuvite_tpu_torch.core.graph.Graph.from_edges exactly:
//   - symmetrize: append (dst,src,w) for every non-self edge, after the
//     originals (same virtual concatenation order as the numpy path);
//   - sort by (src, dst) with duplicates kept in input order (stable);
//   - coalesce duplicates by summing weights in double, in input order
//     (numpy's np.add.at order after a stable argsort).
//
// UNIT=true is the R-MAT / unweighted-input specialization: every edge
// weighs exactly 1, so coalescing is duplicate COUNTING and ids ride
// int32 end to end — no 8-byte array exists at any point, which halves
// the ingest's peak host memory.  weights_out[k] = (float)count is
// bit-identical to the generic path's f64 sum-of-ones cast to f32 (both
// round the exact integer once); callers therefore gate the unit path on
// a float32 weight policy.
//
// Sort scheme: small-nv dense-accumulator fast path (counting-sort by
// src + generation-stamped per-row scratch, ~4x for coarsened community
// graphs), else byte-wise LSD radix on the composite key src*nv + dst.
// 8-bit digits: 16-bit digits make 64 K per-bucket write streams that
// thrash L1 and the TLB, where 256 stay cache-resident; a u32 dst-radix
// plus counting-by-src variant pays a cache miss per element in the
// nv-bucket scatter.  Allocation order keeps the radix peak at ~32 B/slot
// (~16 B/slot for UNIT): the expanded edge list is freed/moved before
// the ping-pong buffers are allocated.

struct NoPayload {};

// Byte-wise LSD radix on uint64 keys with an optional ping-pong payload
// (P = NoPayload sorts keys alone).  Stable, so duplicates keep input
// order.  8-bit digits (see build_csr_impl's note).
// The histogram/scatter loops run over BLOCK ids, not thread ids, so
// correctness holds for any actual OpenMP team size (OMP_DYNAMIC,
// thread limits, nested regions) — every block is processed exactly
// once, whoever runs it.  The exclusive scan is digit-major then
// block-minor: block t's digit-b slots start after every block's
// smaller digits and after earlier blocks' digit-b entries — preserving
// LSD stability.  Shared by the three O(E) sorts (both CSR builders'
// radix branches and the large-nc coarsen); transient = one key + one
// payload ping-pong buffer, allocated here.
template <typename P>
static void radix_sort_pairs(std::vector<uint64_t>& key, std::vector<P>& pay,
                             int key_bits) {
  constexpr bool HAS_P = !std::is_same<P, NoPayload>::value;
  const int64_t m = (int64_t)key.size();
  std::vector<uint64_t> key2(m);
  std::vector<P> pay2;
  if constexpr (HAS_P) pay2.resize(m);
#if defined(_OPENMP)
  const int nt = omp_get_max_threads();
#else
  const int nt = 1;
#endif
  constexpr int DIGIT_BITS = 8;
  constexpr int NB = 1 << DIGIT_BITS;
  constexpr uint64_t DMASK = NB - 1;
  std::vector<int64_t> hist((size_t)nt * NB);
  const int64_t blk = (m + nt - 1) / (nt > 0 ? nt : 1);
  for (int shift = 0; shift < key_bits; shift += DIGIT_BITS) {
    std::fill(hist.begin(), hist.end(), 0);
#pragma omp parallel for schedule(static)
    for (int t = 0; t < nt; ++t) {
      int64_t* h = hist.data() + (size_t)t * NB;
      const int64_t lo = t * blk, hi = std::min<int64_t>(m, lo + blk);
      for (int64_t j = lo; j < hi; ++j) h[(key[j] >> shift) & DMASK]++;
    }
    int64_t run = 0;
    for (int b = 0; b < NB; ++b) {
      for (int t = 0; t < nt; ++t) {
        int64_t c = hist[(size_t)t * NB + b];
        hist[(size_t)t * NB + b] = run;
        run += c;
      }
    }
#pragma omp parallel for schedule(static)
    for (int t = 0; t < nt; ++t) {
      int64_t* h = hist.data() + (size_t)t * NB;
      const int64_t lo = t * blk, hi = std::min<int64_t>(m, lo + blk);
      for (int64_t j = lo; j < hi; ++j) {
        int64_t slot = h[(key[j] >> shift) & DMASK]++;
        key2[slot] = key[j];
        if constexpr (HAS_P) pay2[slot] = pay[j];
      }
    }
    key.swap(key2);
    if constexpr (HAS_P) pay.swap(pay2);
  }
}

// Key width for a composite key a*nv + b, a,b < nv: max key is
// nv*nv - 1 < 2^(2*ceil(log2 nv)); computing from bits(nv-1) avoids
// evaluating nv*nv, which wraps at nv == 2^32.
static int composite_key_bits(uint64_t nv) {
  int vb = 0;
  for (uint64_t x = nv > 0 ? nv - 1 : 0; x; x >>= 1) ++vb;
  return 2 * vb;
}

template <typename IdT, bool UNIT>
static int64_t build_csr_impl(
    int64_t nv, int64_t ne, const IdT* src, const IdT* dst, const double* w,
    int symmetrize, int64_t* offsets_out, IdT* tails_out,
    typename std::conditional<UNIT, float, double>::type* weights_out) {
  using UId = typename std::make_unsigned<IdT>::type;
  using WOut = typename std::conditional<UNIT, float, double>::type;
  // The composite radix key src*nv+dst must fit uint64; UNIT ids int32.
  const int64_t nv_cap =
      UNIT ? ((int64_t)1 << 31) : ((int64_t)1 << 32);
  if (nv < 0 || nv > nv_cap) return -1;
  for (int64_t j = 0; j < ne; ++j) {
    if (src[j] < 0 || src[j] >= nv || dst[j] < 0 || dst[j] >= nv) return -1;
  }
  // Expanded (virtually concatenated) edge list.
  int64_t m = ne;
  std::vector<UId> xs, xd;
  std::vector<double> xw;
  if (symmetrize) {
    int64_t nself = 0;
    for (int64_t j = 0; j < ne; ++j) nself += (src[j] == dst[j]);
    m = 2 * ne - nself;
    xs.resize(m);
    xd.resize(m);
    if (!UNIT) xw.resize(m);
    for (int64_t j = 0; j < ne; ++j) {
      xs[j] = (UId)src[j];
      xd[j] = (UId)dst[j];
      if (!UNIT) xw[j] = w[j];
    }
    int64_t k = ne;
    for (int64_t j = 0; j < ne; ++j) {
      if (src[j] != dst[j]) {
        xs[k] = (UId)dst[j];
        xd[k] = (UId)src[j];
        if (!UNIT) xw[k] = w[j];
        ++k;
      }
    }
  } else {
    xs.resize(m);
    xd.resize(m);
    if (!UNIT) xw.resize(m);
    for (int64_t j = 0; j < ne; ++j) {
      xs[j] = (UId)src[j];
      xd[j] = (UId)dst[j];
      if (!UNIT) xw[j] = w[j];
    }
  }

  // Small-nv fast path: counting-sort by src (stable), then per-row dense
  // accumulation with a generation-stamped scratch.  Bit-identical to the
  // sort path: within a row, duplicate (src, dst) pairs accumulate in
  // input order (exactly the grouping a stable sort produces), and each
  // row's unique tails are emitted sorted ascending.
  if ((uint64_t)nv <= (1ull << 22)) {
    std::vector<int64_t> row_start(nv + 1, 0);
    for (int64_t j = 0; j < m; ++j) row_start[(int64_t)xs[j] + 1]++;
    for (int64_t v = 0; v < nv; ++v) row_start[v + 1] += row_start[v];
    std::vector<UId> rd(m);
    std::vector<double> rw;
    if (!UNIT) rw.resize(m);
    {
      std::vector<int64_t> pos(row_start.begin(), row_start.end() - 1);
      for (int64_t j = 0; j < m; ++j) {
        const int64_t p = pos[xs[j]]++;
        rd[p] = xd[j];
        if (!UNIT) rw[p] = xw[j];
      }
    }
    using Acc = typename std::conditional<UNIT, int64_t, double>::type;
    std::vector<Acc> acc(nv, (Acc)0);
    std::vector<int64_t> seen(nv, -1);
    std::vector<int64_t> uniq;
    std::memset(offsets_out, 0, (nv + 1) * sizeof(int64_t));
    int64_t n_out = 0;
    for (int64_t r = 0; r < nv; ++r) {
      uniq.clear();
      for (int64_t k = row_start[r]; k < row_start[r + 1]; ++k) {
        const int64_t d = (int64_t)rd[k];
        if (seen[d] != r) {
          seen[d] = r;
          if constexpr (UNIT) acc[d] = 1; else acc[d] = rw[k];
          uniq.push_back(d);
        } else {
          if constexpr (UNIT) acc[d] += 1; else acc[d] += rw[k];
        }
      }
      std::sort(uniq.begin(), uniq.end());
      offsets_out[r + 1] = (int64_t)uniq.size();
      for (int64_t d : uniq) {
        tails_out[n_out] = (IdT)d;
        weights_out[n_out] = (WOut)acc[d];
        ++n_out;
      }
    }
    for (int64_t v = 0; v < nv; ++v) offsets_out[v + 1] += offsets_out[v];
    return n_out;
  }

  // Byte-wise LSD radix on the composite key (radix_sort_pairs).
  const uint64_t unv = (uint64_t)nv;
  std::vector<uint64_t> key(m);
  for (int64_t j = 0; j < m; ++j)
    key[j] = (uint64_t)xs[j] * unv + (uint64_t)xd[j];
  xs.clear(); xs.shrink_to_fit();
  xd.clear(); xd.shrink_to_fit();
  std::vector<double> pw(std::move(xw));
  if constexpr (UNIT) {
    std::vector<NoPayload> none;
    radix_sort_pairs(key, none, composite_key_bits(unv));
  } else {
    radix_sort_pairs(key, pw, composite_key_bits(unv));
  }

  // Linear coalesce of the sorted stream into the CSR.
  std::memset(offsets_out, 0, (nv + 1) * sizeof(int64_t));
  int64_t n_out = 0;
  uint64_t prev_key = ~0ull;
  if constexpr (UNIT) {
    int64_t run_count = 0;
    for (int64_t j = 0; j < m; ++j) {
      if (key[j] == prev_key) {
        ++run_count;
      } else {
        if (n_out) weights_out[n_out - 1] = (float)run_count;
        prev_key = key[j];
        run_count = 1;
        tails_out[n_out] = (IdT)(key[j] % unv);
        offsets_out[key[j] / unv + 1]++;
        ++n_out;
      }
    }
    if (n_out) weights_out[n_out - 1] = (float)run_count;
  } else {
    for (int64_t j = 0; j < m; ++j) {
      if (key[j] == prev_key) {
        weights_out[n_out - 1] += pw[j];
      } else {
        prev_key = key[j];
        tails_out[n_out] = (IdT)(key[j] % unv);
        weights_out[n_out] = pw[j];
        offsets_out[key[j] / unv + 1]++;
        ++n_out;
      }
    }
  }
  for (int64_t v = 0; v < nv; ++v) offsets_out[v + 1] += offsets_out[v];
  return n_out;
}

// Weighted low-footprint CSR builder (int32 ids, f32 output weights).
//
// The generic cv_build_csr carries an f64 payload through every radix
// pass (key+payload ping-pong = 32 B/slot) and emits int64/f64 outputs —
// ~65 B/slot end to end.  This variant sorts an int32 ORIGINAL-
// EDGE-INDEX payload instead (key 8x2 + idx 4x2 = 24 B/slot transient)
// and gathers w[idx] only at the linear coalesce, accumulating in double
// and casting to f32 once per unique edge — the exact value the generic
// path produces after its policy cast, because a stable sort of indices
// visits duplicates in the same input order the f64-payload sort does.
// Requires nv <= 2^31 and expanded edge count < 2^31 (int32 index).
template <typename IdT>
static int64_t build_csr_w32_impl(int64_t nv, int64_t ne, const IdT* src,
                                  const IdT* dst, const double* w,
                                  int symmetrize, int64_t* offsets_out,
                                  int32_t* tails_out, float* weights_out) {
  if (nv < 0 || nv > ((int64_t)1 << 31)) return -1;
  for (int64_t j = 0; j < ne; ++j) {
    if (src[j] < 0 || src[j] >= nv || dst[j] < 0 || dst[j] >= nv) return -1;
  }
  int64_t m = ne;
  int64_t nself = 0;
  if (symmetrize) {
    for (int64_t j = 0; j < ne; ++j) nself += (src[j] == dst[j]);
    m = 2 * ne - nself;
  }
  if (m >= ((int64_t)1 << 31)) return -1;  // int32 index payload bound
  const uint64_t unv = (uint64_t)nv;

  // Expanded key + original-edge-index payload.  Mirrored entries point
  // at the ORIGINAL edge's weight; expansion order (originals first,
  // mirrors after) matches the numpy concatenation, so stable sorting
  // reproduces the generic accumulation order exactly.
  std::vector<uint64_t> key(m);
  std::vector<int32_t> idx(m);
  for (int64_t j = 0; j < ne; ++j) {
    key[j] = (uint64_t)src[j] * unv + (uint64_t)dst[j];
    idx[j] = (int32_t)j;
  }
  if (symmetrize) {
    int64_t k = ne;
    for (int64_t j = 0; j < ne; ++j) {
      if (src[j] != dst[j]) {
        key[k] = (uint64_t)dst[j] * unv + (uint64_t)src[j];
        idx[k] = (int32_t)j;
        ++k;
      }
    }
  }

  // Byte-wise LSD radix (radix_sort_pairs), payload = int32 index.
  radix_sort_pairs(key, idx, composite_key_bits(unv));

  // Linear coalesce: gather w[idx] in sorted order, accumulate in double
  // per run, cast once at emission.
  std::memset(offsets_out, 0, (nv + 1) * sizeof(int64_t));
  int64_t n_out = 0;
  uint64_t prev_key = ~0ull;
  double acc = 0.0;
  for (int64_t j = 0; j < m; ++j) {
    if (key[j] == prev_key) {
      acc += w[idx[j]];
    } else {
      if (n_out) weights_out[n_out - 1] = (float)acc;
      prev_key = key[j];
      acc = w[idx[j]];
      tails_out[n_out] = (int32_t)(key[j] % unv);
      offsets_out[key[j] / unv + 1]++;
      ++n_out;
    }
  }
  if (n_out) weights_out[n_out - 1] = (float)acc;
  for (int64_t v = 0; v < nv; ++v) offsets_out[v + 1] += offsets_out[v];
  return n_out;
}

extern "C" {

// offsets_out must hold nv+1 entries; tails_out/weights_out must hold
// (symmetrize ? 2*ne : ne) entries.  Returns the number of unique CSR
// entries written, or -1 on bad input (src/dst out of range).
int64_t cv_build_csr(int64_t nv, int64_t ne, const int64_t* src,
                     const int64_t* dst, const double* w, int symmetrize,
                     int64_t* offsets_out, int64_t* tails_out,
                     double* weights_out) {
  return build_csr_impl<int64_t, false>(nv, ne, src, dst, w, symmetrize,
                                        offsets_out, tails_out, weights_out);
}

// Unit-weight int32 variant (see the template header).  Requires
// nv <= 2^31; weights_out holds f32 duplicate counts.
int64_t cv_build_csr_unit(int64_t nv, int64_t ne, const int32_t* src,
                          const int32_t* dst, int symmetrize,
                          int64_t* offsets_out, int32_t* tails_out,
                          float* weights_out) {
  return build_csr_impl<int32_t, true>(nv, ne, src, dst, nullptr, symmetrize,
                                       offsets_out, tails_out, weights_out);
}

// Weighted low-footprint builder (see build_csr_w32_impl); src/dst may be
// int32 or int64 (id64 flag) — no width conversion is ever materialized.
int64_t cv_build_csr_w32(int64_t nv, int64_t ne, const void* src,
                         const void* dst, const double* w, int id64,
                         int symmetrize, int64_t* offsets_out,
                         int32_t* tails_out, float* weights_out) {
  if (id64)
    return build_csr_w32_impl(nv, ne, (const int64_t*)src,
                              (const int64_t*)dst, w, symmetrize,
                              offsets_out, tails_out, weights_out);
  return build_csr_w32_impl(nv, ne, (const int32_t*)src,
                            (const int32_t*)dst, w, symmetrize,
                            offsets_out, tails_out, weights_out);
}

// ---------------------------------------------------------------------------
// Fused inter-phase coarsening: relabel + coalesce straight from the CSR.
//
// Equivalent computation to cuvite_tpu_torch.coarsen.rebuild.coarsen_graph's
// relabel + Graph.from_edges(symmetrize=False), but with
// no expanded numpy edge list: the (labels[src], labels[dst]) composite
// key is generated row-by-row from the CSR, so the only O(E) transients
// are the radix key/payload ping-pong buffers (~32 B/slot; the numpy
// route peaks at ~3x that in int64/f64 temporaries).
//
// Bit-identity with the fallback path: the key sequence equals the numpy
// path's (stable LSD radix = stable argsort; duplicate (s,d) pairs keep
// CSR order), weights accumulate in double in that order, and the result
// is cast to f32 once — exactly Graph.from_edges' contract.

}  // extern "C" — the coarsen template needs C++ linkage

template <typename IdT, typename WT>
static int64_t coarsen_impl(int64_t nv, int64_t nc, const int64_t* offsets,
                            const IdT* tails, const WT* w,
                            const int32_t* labels, int64_t* offsets_out,
                            int32_t* tails_out, float* weights_out,
                            int force_dense) {
  if (nc < 0 || nc > ((int64_t)1 << 31)) return -1;
  const int64_t m = offsets[nv];
  for (int64_t v = 0; v < nv; ++v)
    if (labels[v] < 0 || labels[v] >= nc) return -1;

  // Counting-sort path: rows by coarse src, then dense per-row
  // accumulation (generation-stamped scratch).  Same output as the sort
  // path: duplicates accumulate in CSR order, unique tails emitted
  // ascending.  Default for small nc (the O(nc) scratch is hot); also
  // selected by the caller via ``force_dense`` for benchmark-scale
  // graphs where the radix path's 32 B/slot ping-pong transient exceeds
  // host RAM — this path peaks at 12 B/slot + O(nc).
  if (force_dense || nc <= ((int64_t)1 << 22)) {
    std::vector<int64_t> row_start(nc + 1, 0);
    for (int64_t v = 0; v < nv; ++v)
      row_start[(int64_t)labels[v] + 1] += offsets[v + 1] - offsets[v];
    for (int64_t r = 0; r < nc; ++r) row_start[r + 1] += row_start[r];
    std::vector<int32_t> rd(m);
    std::vector<double> rw(m);
    {
      std::vector<int64_t> pos(row_start.begin(), row_start.end() - 1);
      for (int64_t v = 0; v < nv; ++v) {
        const int32_t s = labels[v];
        int64_t p = pos[s];
        for (int64_t k = offsets[v]; k < offsets[v + 1]; ++k) {
          rd[p] = labels[(int64_t)tails[k]];
          rw[p] = (double)w[k];
          ++p;
        }
        pos[s] = p;
      }
    }
    std::vector<double> acc(nc, 0.0);
    std::vector<int64_t> seen(nc, -1);
    std::vector<int64_t> uniq;
    std::memset(offsets_out, 0, (nc + 1) * sizeof(int64_t));
    int64_t n_out = 0;
    for (int64_t r = 0; r < nc; ++r) {
      uniq.clear();
      for (int64_t k = row_start[r]; k < row_start[r + 1]; ++k) {
        const int64_t d = (int64_t)rd[k];
        if (seen[d] != r) {
          seen[d] = r;
          acc[d] = rw[k];
          uniq.push_back(d);
        } else {
          acc[d] += rw[k];
        }
      }
      std::sort(uniq.begin(), uniq.end());
      offsets_out[r + 1] = (int64_t)uniq.size();
      for (int64_t d : uniq) {
        tails_out[n_out] = (int32_t)d;
        weights_out[n_out] = (float)acc[d];
        ++n_out;
      }
    }
    for (int64_t r = 0; r < nc; ++r) offsets_out[r + 1] += offsets_out[r];
    return n_out;
  }

  // Large-nc: byte-wise LSD radix on labels[s]*nc + labels[d]
  // (radix_sort_pairs — same stability argument as build_csr_impl).
  const uint64_t unc = (uint64_t)nc;
  std::vector<uint64_t> key(m);
  std::vector<double> pw(m);
  for (int64_t v = 0; v < nv; ++v) {
    const uint64_t s = (uint64_t)labels[v] * unc;
    for (int64_t k = offsets[v]; k < offsets[v + 1]; ++k) {
      key[k] = s + (uint64_t)labels[(int64_t)tails[k]];
      pw[k] = (double)w[k];
    }
  }
  radix_sort_pairs(key, pw, composite_key_bits(unc));
  std::memset(offsets_out, 0, (nc + 1) * sizeof(int64_t));
  int64_t n_out = 0;
  uint64_t prev_key = ~0ull;
  std::vector<double> wacc;
  wacc.reserve(1 << 20);
  // Accumulate runs in double, cast once at emission (stream the cast to
  // avoid holding a full f64 copy of the output).
  for (int64_t j = 0; j < m; ++j) {
    if (key[j] == prev_key) {
      wacc[n_out - 1] += pw[j];
    } else {
      prev_key = key[j];
      tails_out[n_out] = (int32_t)(key[j] % unc);
      offsets_out[key[j] / unc + 1]++;
      wacc.push_back(pw[j]);
      ++n_out;
    }
  }
  for (int64_t j = 0; j < n_out; ++j) weights_out[j] = (float)wacc[j];
  for (int64_t r = 0; r < nc; ++r) offsets_out[r + 1] += offsets_out[r];
  return n_out;
}

extern "C" int64_t cv_coarsen(int64_t nv, int64_t nc, const int64_t* offsets,
                              const void* tails, const void* w, int id64,
                              int w64, const int32_t* labels,
                              int64_t* offsets_out, int32_t* tails_out,
                              float* weights_out, int force_dense) {
  if (id64) {
    if (w64)
      return coarsen_impl(nv, nc, offsets, (const int64_t*)tails,
                          (const double*)w, labels, offsets_out, tails_out,
                          weights_out, force_dense);
    return coarsen_impl(nv, nc, offsets, (const int64_t*)tails,
                        (const float*)w, labels, offsets_out, tails_out,
                        weights_out, force_dense);
  }
  if (w64)
    return coarsen_impl(nv, nc, offsets, (const int32_t*)tails,
                        (const double*)w, labels, offsets_out, tails_out,
                        weights_out, force_dense);
  return coarsen_impl(nv, nc, offsets, (const int32_t*)tails,
                      (const float*)w, labels, offsets_out, tails_out,
                      weights_out, force_dense);
}

// Per-vertex weighted degree straight off the CSR: one sequential f64
// accumulation in slab order — bit-identical to
// np.bincount(sources, weights=w.astype(f64)) without the O(E) expanded
// source array (Graph.weighted_degrees' numpy route).
extern "C" void cv_weighted_degrees(int64_t nv, const int64_t* offsets,
                                    const void* w, int w64, double* out) {
  for (int64_t v = 0; v < nv; ++v) {
    double a = 0.0;
    if (w64) {
      const double* ww = (const double*)w;
      for (int64_t k = offsets[v]; k < offsets[v + 1]; ++k) a += ww[k];
    } else {
      const float* ww = (const float*)w;
      for (int64_t k = offsets[v]; k < offsets[v + 1]; ++k) a += (double)ww[k];
    }
    out[v] = a;
  }
}

extern "C" {

// ---------------------------------------------------------------------------
// Counter-based RNG (SplitMix64): stateless, trivially parallel, and
// reproduced verbatim by the numpy path (cuvite_tpu_torch/utils/rng.py).
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return x;
}

static inline double u01(uint64_t x) {
  return (double)(x >> 11) * (1.0 / 9007199254740992.0); /* 2^-53 */
}

// Deterministic bijective scramble of [0, 2^bits): rounds of
// (multiply by odd constant mod 2^bits, xor with own high half).  Replaces
// the numpy path's rng.permutation for breaking the R-MAT id/degree
// correlation; identical formula in cuvite_tpu_torch/utils/rng.py:
// scramble_ids.
static inline uint64_t scramble(uint64_t x, int bits, uint64_t seed) {
  const uint64_t mask = (bits >= 64) ? ~0ull : ((1ull << bits) - 1);
  const uint64_t odd1 = (splitmix64(seed ^ 0xA5A5A5A5ull) | 1ull);
  const uint64_t odd2 = (splitmix64(seed ^ 0x5A5A5A5Aull) | 1ull);
  int h = bits / 2 > 0 ? bits / 2 : 1;
  x = (x * odd1) & mask;
  x ^= x >> h;
  x = (x * odd2) & mask;
  x ^= x >> h;
  return x & mask;
}

// Graph500-style R-MAT edge generator: ne edges over 2^scale vertices with
// recursive quadrant probabilities (a, b, c, 1-a-b-c).  The RGG variant
// lives in Python (KD-tree based) — this native path serves the large
// benchmark graphs.
void cv_rmat(int scale, int64_t ne, uint64_t seed, double a, double b,
             double c, int64_t* src_out, int64_t* dst_out) {
  const double ab = a + b;
  const double a_norm = a / ab;
  const double c_norm = c / (1.0 - ab);
#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < ne; ++e) {
    uint64_t s = 0, d = 0;
    const uint64_t base = seed + (uint64_t)e * (uint64_t)(2 * scale);
    for (int l = 0; l < scale; ++l) {
      double r1 = u01(splitmix64(base + (uint64_t)(2 * l)));
      double r2 = u01(splitmix64(base + (uint64_t)(2 * l + 1)));
      uint64_t sbit = r1 > ab;
      uint64_t dbit = sbit ? (r2 > c_norm) : (r2 > a_norm);
      s = (s << 1) | sbit;
      d = (d << 1) | dbit;
    }
    src_out[e] = (int64_t)scramble(s, scale, seed);
    dst_out[e] = (int64_t)scramble(d, scale, seed);
  }
}

// ---------------------------------------------------------------------------
// Vite binary graph format (layout: cuvite_tpu_torch/io/vite.py):
//   [nv][ne] [offsets (nv+1)] [edges ne x {tail, weight}]
// with 64-bit (i8/f8) or 32-bit (i4/f4) element widths.

int cv_vite_header(const char* path, int bits64, int64_t* nv_out,
                   int64_t* ne_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int rc = 0;
  if (bits64) {
    int64_t h[2];
    rc = std::fread(h, sizeof(int64_t), 2, f) == 2 ? 0 : -2;
    if (rc == 0) { *nv_out = h[0]; *ne_out = h[1]; }
  } else {
    int32_t h[2];
    rc = std::fread(h, sizeof(int32_t), 2, f) == 2 ? 0 : -2;
    if (rc == 0) { *nv_out = h[0]; *ne_out = h[1]; }
  }
  std::fclose(f);
  return rc;
}

// Reads edge records [e0, e1) and deinterleaves them to struct-of-arrays
// (the caller reads + validates the offsets itself, via memmap in
// cuvite_tpu_torch/io/vite.py).  Returns 0 on success.
int cv_vite_edges(const char* path, int bits64, int64_t nv, int64_t e0,
                  int64_t e1, int64_t* tails_out, double* weights_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const int64_t esz = bits64 ? 8 : 4;
  const int64_t rec = bits64 ? 16 : 8;
  const int64_t base = 2 * esz + (nv + 1) * esz + e0 * rec;
  // fseeko takes off_t (64-bit with _FILE_OFFSET_BITS=64), so offsets past
  // 2 GiB work even where long is 32-bit; the read streams in bounded
  // chunks so a billion-edge shard never needs a matching heap buffer.
  if (fseeko(f, (off_t)base, SEEK_SET) != 0) { std::fclose(f); return -3; }
  const int64_t n = e1 - e0;
  const int64_t chunk = 4 << 20;  // records per read (<= 64 MiB buffer)
  std::vector<char> buf((size_t)(n < chunk ? (n > 0 ? n : 1) : chunk) * rec);
  for (int64_t done = 0; done < n; ) {
    const int64_t c = n - done < chunk ? n - done : chunk;
    if ((int64_t)std::fread(buf.data(), rec, c, f) != c) {
      std::fclose(f);
      return -2;
    }
    if (bits64) {
      struct E { int64_t t; double w; };
      const E* e = (const E*)buf.data();
#pragma omp parallel for schedule(static)
      for (int64_t i = 0; i < c; ++i) {
        tails_out[done + i] = e[i].t;
        weights_out[done + i] = e[i].w;
      }
    } else {
      struct E { int32_t t; float w; };
      const E* e = (const E*)buf.data();
#pragma omp parallel for schedule(static)
      for (int64_t i = 0; i < c; ++i) {
        tails_out[done + i] = e[i].t;
        weights_out[done + i] = e[i].w;
      }
    }
    done += c;
  }
  std::fclose(f);
  return 0;
}

int cv_vite_write(const char* path, int bits64, int64_t nv, int64_t ne,
                  const int64_t* offsets, const int64_t* tails,
                  const double* weights) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int rc = 0;
  if (bits64) {
    int64_t h[2] = {nv, ne};
    if (std::fwrite(h, 8, 2, f) != 2) rc = -2;
    if (!rc && (int64_t)std::fwrite(offsets, 8, nv + 1, f) != nv + 1) rc = -2;
    if (!rc) {
      struct E { int64_t t; double w; };
      std::vector<E> buf(ne);
#pragma omp parallel for schedule(static)
      for (int64_t i = 0; i < ne; ++i) buf[i] = {tails[i], weights[i]};
      if ((int64_t)std::fwrite(buf.data(), 16, ne, f) != ne) rc = -2;
    }
  } else {
    int32_t h[2] = {(int32_t)nv, (int32_t)ne};
    if (std::fwrite(h, 4, 2, f) != 2) rc = -2;
    if (!rc) {
      std::vector<int32_t> o32(nv + 1);
      for (int64_t i = 0; i <= nv; ++i) o32[i] = (int32_t)offsets[i];
      if ((int64_t)std::fwrite(o32.data(), 4, nv + 1, f) != nv + 1) rc = -2;
    }
    if (!rc) {
      struct E { int32_t t; float w; };
      std::vector<E> buf(ne);
#pragma omp parallel for schedule(static)
      for (int64_t i = 0; i < ne; ++i)
        buf[i] = {(int32_t)tails[i], (float)weights[i]};
      if ((int64_t)std::fwrite(buf.data(), 8, ne, f) != ne) rc = -2;
    }
  }
  std::fclose(f);
  return rc;
}

// ---------------------------------------------------------------------------
// Edge-balanced partition: greedy scan of the offset array assigning
// contiguous vertex ranges of ~ne/nparts edges each (the -b flag's
// edge-balanced shards).
void cv_balanced_parts(int64_t nv, const int64_t* offsets, int64_t nparts,
                       int64_t* parts_out) {
  const int64_t ne = offsets[nv];
  parts_out[0] = 0;
  // Cuts start at 1 (shard 0 is never empty), matching the Python
  // balanced_parts searchsorted-over-offsets[1:] semantics even when a
  // target is 0 (ne < nparts).
  int64_t v = 1;
  for (int64_t p = 1; p < nparts; ++p) {
    const int64_t target = (ne * p) / nparts;
    while (v < nv && offsets[v] < target) ++v;
    parts_out[p] = v;
  }
  parts_out[nparts] = nv;
}

// ---------------------------------------------------------------------------
// Bucket-plan construction (the host side of the degree-bucketed engine,
// cuvite_tpu_torch/louvain/bucketed.py BucketPlan.build).
//
// The numpy builder materializes O(E) int64/float64 transients per phase
// (real-mask copies, per-class [nb, width] index/gather matrices) — tens of
// GB at benchmark scales.  These two entry points stream the slab once each
// and write ONLY the output matrices, with no transient larger than O(nv):
//
//   cv_plan_scan  — one fused pass: per-vertex self-loop accumulation (f64,
//                   slab order, bit-identical to np.add.at), the unit-weight
//                   predicate, the src-sortedness check, and the
//                   padding-only-at-tail check that gates cv_bucket_fill.
//   cv_bucket_fill — one pass over CSR rows writing each vertex's padded
//                   bucket row (dst matrix + weight-or-mask matrix) and the
//                   heavy-vertex edge triples, exactly as the numpy path
//                   lays them out (pad columns carry the vertex's own
//                   global id with weight 0).
//
// The cheap O(nv) planning arithmetic (degree bincount, width-class
// assignment, row counters, pow2 padding) stays in numpy — it never touches
// O(E) memory.

}  // extern "C" — template helpers need C++ linkage

template <typename I, typename W>
static int plan_scan_impl(int64_t ne, int64_t nv, int64_t base, const I* src,
                          const I* dst, const W* w, double* self_loop,
                          int* flags_out) {
  int sorted = 1, unit = 1, tail_ok = 1;
  int64_t prev = -1;
  int seen_pad = 0;
  for (int64_t j = 0; j < ne; ++j) {
    const int64_t s = (int64_t)src[j];
    if (s >= nv) {
      seen_pad = 1;
      continue;
    }
    if (s < 0) {  // malformed slab: force the caller's numpy fallback
      *flags_out = 0;
      return 0;
    }
    if (seen_pad) tail_ok = 0;
    if (s < prev) sorted = 0;
    if (!sorted || !tail_ok) {
      // The caller is guaranteed to decline the plan; don't stream the
      // rest of an O(E) slab computing discarded self-loops (color-class
      // masked plans hit this every phase).
      *flags_out = 0;
      return 0;
    }
    prev = s;
    const double wj = (double)w[j];
    if (wj != 1.0) unit = 0;
    if ((int64_t)dst[j] == s + base) self_loop[s] += wj;
  }
  *flags_out = sorted | (unit << 1) | (tail_ok << 2);
  return 0;
}

extern "C" int cv_plan_scan(int64_t ne, int64_t nv, int64_t base,
                            const void* src, const void* dst, const void* w,
                            int id64, int w64, double* self_loop,
                            int* flags_out) {
  if (id64) {
    if (w64)
      return plan_scan_impl(ne, nv, base, (const int64_t*)src,
                            (const int64_t*)dst, (const double*)w, self_loop,
                            flags_out);
    return plan_scan_impl(ne, nv, base, (const int64_t*)src,
                          (const int64_t*)dst, (const float*)w, self_loop,
                          flags_out);
  }
  if (w64)
    return plan_scan_impl(ne, nv, base, (const int32_t*)src,
                          (const int32_t*)dst, (const double*)w, self_loop,
                          flags_out);
  return plan_scan_impl(ne, nv, base, (const int32_t*)src,
                        (const int32_t*)dst, (const float*)w, self_loop,
                        flags_out);
}

// cls codes: kept-class index, 254 = heavy, 255 = no bucket (degree 0).
// Caller pre-fills verts with nv (padding), zero-fills dmat/wmat, and
// pre-pads the heavy arrays; this routine writes only real entries.
// Requires the slab CSR-sorted with padding at the tail (cv_plan_scan
// flags); returns -1 on a counter overrun (corrupt cls/deg inputs).
template <typename I, typename W, typename WM>
static int bucket_fill_impl(int64_t nv, int64_t base, const I* dst,
                            const W* w, const int64_t* row_start,
                            const int64_t* deg, const uint8_t* cls,
                            int nclasses, const int64_t* widths,
                            const int64_t* nb_pad, int64_t** verts_ptrs,
                            I** dmat_ptrs, WM** wmat_ptrs, int unit,
                            int64_t heavy_pad, I* hsrc, I* hdst, W* hw) {
  std::vector<int64_t> counter(nclasses, 0);
  int64_t hk = 0;
  for (int64_t v = 0; v < nv; ++v) {
    const uint8_t c = cls[v];
    if (c == 255) continue;
    const int64_t rs = row_start[v];
    const int64_t d = deg[v];
    if (c == 254) {
      if (hk + d > heavy_pad) return -1;
      for (int64_t k = 0; k < d; ++k) {
        hsrc[hk] = (I)v;
        hdst[hk] = dst[rs + k];
        hw[hk] = w[rs + k];
        ++hk;
      }
      continue;
    }
    if (c >= nclasses) return -1;
    const int64_t width = widths[c];
    const int64_t row = counter[c]++;
    if (row >= nb_pad[c]) return -1;
    verts_ptrs[c][row] = v;
    I* drow = dmat_ptrs[c] + row * width;
    WM* wrow = wmat_ptrs[c] + row * width;
    for (int64_t k = 0; k < d; ++k) {
      drow[k] = dst[rs + k];
      wrow[k] = unit ? (WM)1 : (WM)w[rs + k];
    }
    const I self_id = (I)(v + base);
    for (int64_t k = d; k < width; ++k) drow[k] = self_id;
  }
  return 0;
}

extern "C" int cv_bucket_fill(
    int64_t nv, int64_t base, const void* dst, const void* w, int id64,
    int w64, const int64_t* row_start, const int64_t* deg,
    const uint8_t* cls, int nclasses, const int64_t* widths,
    const int64_t* nb_pad, void** verts_ptrs, void** dmat_ptrs,
    void** wmat_ptrs, int unit, int64_t heavy_pad, void* hsrc, void* hdst,
    void* hw) {
  // unit=1 writes uint8 {0,1} masks; otherwise wmat shares w's dtype.
#define CV_FILL(I_, W_, WM_)                                                  \
  bucket_fill_impl<I_, W_, WM_>(                                              \
      nv, base, (const I_*)dst, (const W_*)w, row_start, deg, cls, nclasses, \
      widths, nb_pad, (int64_t**)verts_ptrs, (I_**)dmat_ptrs,                \
      (WM_**)wmat_ptrs, unit, heavy_pad, (I_*)hsrc, (I_*)hdst, (W_*)hw)
  if (id64) {
    if (w64) return unit ? CV_FILL(int64_t, double, uint8_t)
                         : CV_FILL(int64_t, double, double);
    return unit ? CV_FILL(int64_t, float, uint8_t)
                : CV_FILL(int64_t, float, float);
  }
  if (w64) return unit ? CV_FILL(int32_t, double, uint8_t)
                       : CV_FILL(int32_t, double, double);
  return unit ? CV_FILL(int32_t, float, uint8_t)
              : CV_FILL(int32_t, float, float);
#undef CV_FILL
}

extern "C" int cv_openmp_threads(void) {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}
