"""Graph generators (port of ``cuvite_tpu/io/generate.py``).

- ``generate_rgg`` (port of ``:36-90``): the random geometric graph of the
  reference application's ``-n NV`` (Vite's own generator): NV points in
  the unit square from the Park-Miller stream, shard s's points in the
  strip [s/p, (s+1)/p) of Y, an edge between every pair closer than
  rn = (rc + rt)/2, weighted by the distance.  The points, edges and
  weights are bit-identical to the reference package's for every
  (nv, nshards, seed).  Neighbours are found with scipy's ``cKDTree``, as
  in the reference.  ``random_edge_percent`` adds the ``-e`` extra
  long-range edges (port of ``_rgg_extra_edges``, ``:93-177``), also
  bit-identical.
- ``generate_rmat`` (port of ``:180-234``): Graph500-style R-MAT (a=0.57,
  b=0.19, c=0.19) with a counter-based SplitMix64 RNG, bit-identical to
  the reference package's for every (scale, edge_factor, seed).  The edge
  list comes from the native host runtime (``native.rmat_edges``) unless
  ``CUVITE_NO_NATIVE`` is set; ``rmat_edges_numpy`` is its plain version.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from cuvite_tpu_torch import native
from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import Policy, default_policy
from cuvite_tpu_torch.utils.rng import lcg_stream, \
    minstd0_uniform_real, scramble_ids, splitmix64, u01


def rgg_radius(nv: int) -> float:
    """rn = (rc + rt)/2: the connectivity radius rc and the threshold
    radius rt of the reference application's generator."""
    rc = np.sqrt(np.log(nv) / (np.pi * nv))
    rt = np.sqrt(2.0736 / nv)
    return float((rc + rt) / 2.0)


def rgg_points(nv: int, nshards: int,
               seed: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """X uniform in [0, 1); Y of shard s in its strip [s/p, (s+1)/p).
    Shard s draws 2n numbers from its own slice [2ns, 2n(s+1)) of the one
    global stream: X from the first n, Y from the second."""
    n = nv // nshards
    xs, ys = [], []
    for s in range(nshards):
        r = lcg_stream(seed, nshards * 2 * n, lo=s * 2 * n,
                       hi=(s + 1) * 2 * n)
        xs.append(r[:n])
        ys.append(s / nshards + r[n:] * (1.0 / nshards))
    return np.concatenate(xs), np.concatenate(ys)


def generate_rgg(nv: int, nshards: int = 1, seed: int = 1,
                 policy: Policy | None = None, *,
                 random_edge_percent: int = 0) -> Graph:
    """Random geometric graph of ``-n nv``, with ``-e
    random_edge_percent`` extra long-range edges.  The point count is nv
    rounded down to a multiple of ``nshards``, as in the reference."""
    policy = policy or default_policy()
    n = nv // nshards
    nv_eff = n * nshards
    rn = rgg_radius(nv_eff)
    if nshards > 1 and 1.0 / nshards <= rn:
        raise ValueError(f"strip width 1/{nshards} must exceed rn={rn:.4f}")
    x, y = rgg_points(nv_eff, nshards, seed)
    pts = np.stack([x, y], axis=1)
    pairs = cKDTree(pts).query_pairs(r=rn, output_type="ndarray")
    d = np.sqrt(((pts[pairs[:, 0]] - pts[pairs[:, 1]]) ** 2).sum(axis=1))
    src, dst, w = pairs[:, 0], pairs[:, 1], d
    if random_edge_percent > 0:
        es, ed, wx = _rgg_extra_edges(pts, nshards, n, nv_eff,
                                      random_edge_percent, pairs, seed)
        src = np.concatenate([src, es])
        dst = np.concatenate([dst, ed])
        w = np.concatenate([w, wx])
    return Graph.from_edges(nv_eff, src, dst, weights=w, policy=policy)


def _rgg_extra_edges(pts, nshards: int, n: int, nv: int, pct: int,
                     existing: np.ndarray, seed: int) -> tuple:
    """The ``-e`` edges: about ``pct`` percent of the undirected RGG edge
    count more, between random endpoint pairs (the reference
    application's ``distgraph.cpp:652-842``, as the reference package
    makes it reproducible).

    - Count: nrande = pct * |existing| // 100, split evenly over the
      shards with the remainder on the last; below one a shard, all on the
      last shard.
    - Draws: shard r draws (local i in [0, n), global j in [0, nv)) pairs
      from its slice [2 offs[r], 2 offs[r+1]) of the Park-Miller stream of
      ``seed + 1``.
    - A self pair or a duplicate of an RGG edge or of an earlier extra
      (undirected) forfeits its draw.
    - Weight: the distance when the shards of the endpoints are equal or
      neighbours, else ``minstd0_uniform_real(i * nv + j)`` in [0.01, 1).
    """
    nrande = (pct * len(existing)) // 100
    if nrande <= 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0, dtype=np.float64)
    counts = np.zeros(nshards, dtype=np.int64)
    if nrande < nshards:
        counts[-1] = nrande
    else:
        counts[:] = nrande // nshards
        counts[-1] += nrande % nshards
    offs = np.concatenate([[0], np.cumsum(counts)])
    total = int(offs[-1])
    gi_parts, gj_parts = [], []
    for r in range(nshards):
        if counts[r] == 0:
            continue
        vals = lcg_stream(seed + 1, 2 * total,
                          lo=2 * int(offs[r]), hi=2 * int(offs[r + 1]))
        i_loc = np.minimum((vals[0::2] * n).astype(np.int64), n - 1)
        gi_parts.append(r * n + i_loc)
        gj_parts.append(np.minimum((vals[1::2] * nv).astype(np.int64),
                                   nv - 1))
    g_i = np.concatenate(gi_parts)
    g_j = np.concatenate(gj_parts)
    keep = g_i != g_j
    key = np.minimum(g_i, g_j) * nv + np.maximum(g_i, g_j)
    ex_key = (np.minimum(existing[:, 0], existing[:, 1]) * nv
              + np.maximum(existing[:, 0], existing[:, 1]))
    keep &= ~np.isin(key, ex_key)
    _, first = np.unique(key, return_index=True)
    is_first = np.zeros(len(key), dtype=bool)
    is_first[first] = True
    keep &= is_first
    g_i, g_j = g_i[keep], g_j[keep]
    near = np.abs(g_i // n - g_j // n) <= 1
    dist = np.sqrt(((pts[g_i] - pts[g_j]) ** 2).sum(axis=1))
    wfar = minstd0_uniform_real(
        g_i.astype(np.uint64) * np.uint64(nv) + g_j.astype(np.uint64),
        0.01, 1.0)
    return g_i, g_j, np.where(near, dist, wfar)


def rmat_edges_numpy(scale: int, ne: int, seed: int, a: float, b: float,
                     c: float) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT edge list.  Per edge e and recursion level l, the quadrant
    draws are splitmix64(seed + e*2*scale + 2l [+1])."""
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    base = (np.arange(ne, dtype=np.uint64) * np.uint64(2 * scale)
            + np.uint64(seed))
    src = np.zeros(ne, dtype=np.uint64)
    dst = np.zeros(ne, dtype=np.uint64)
    one = np.uint64(1)
    for level in range(scale):
        r1 = u01(splitmix64(base + np.uint64(2 * level)))
        r2 = u01(splitmix64(base + np.uint64(2 * level + 1)))
        sbit = r1 > ab
        dbit = np.where(sbit, r2 > c_norm, r2 > a_norm)
        src = (src << one) | sbit.astype(np.uint64)
        dst = (dst << one) | dbit.astype(np.uint64)
    src = scramble_ids(src, scale, seed).astype(np.int64)
    dst = scramble_ids(dst, scale, seed).astype(np.int64)
    return src, dst


def generate_rmat(
    scale: int,
    edge_factor: int = 16,
    seed: int = 1,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    policy: Policy | None = None,
) -> Graph:
    """Graph500 R-MAT: 2^scale vertices, edge_factor * 2^scale edges
    (before dedup/symmetrization), unit weights summed over duplicates."""
    policy = policy or default_policy()
    nv = 1 << scale
    ne = edge_factor << scale
    if native.available():
        src, dst = native.rmat_edges(scale, ne, seed, a, b, c)
    else:
        src, dst = rmat_edges_numpy(scale, ne, seed, a, b, c)
    keep = src != dst
    if scale < 31:
        # int32 ids for the unit-weight CSR builder; the int64 generator
        # output is freed before the ingest.
        s32 = src[keep].astype(np.int32)
        del src
        d32 = dst[keep].astype(np.int32)
        del dst, keep
        return Graph.from_edges(nv, s32, d32, policy=policy)
    return Graph.from_edges(nv, src[keep], dst[keep], policy=policy)
