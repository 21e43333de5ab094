"""Graph generators (port of ``cuvite_tpu/io/generate.py``).

- ``generate_rgg`` (port of ``:36-90``): the random geometric graph of the
  reference application's ``-n NV`` (Vite's own generator): NV points in
  the unit square from the Park-Miller stream, shard s's points in the
  strip [s/p, (s+1)/p) of Y, an edge between every pair closer than
  rn = (rc + rt)/2, weighted by the distance.  The points, edges and
  weights are bit-identical to the reference package's for every
  (nv, nshards, seed).  Neighbours are found with scipy's ``cKDTree``, as
  in the reference.  The ``-e`` extra long-range edges are not ported yet.
- ``generate_rmat`` (port of ``:180-234``): Graph500-style R-MAT (a=0.57,
  b=0.19, c=0.19) with a counter-based SplitMix64 RNG, bit-identical to
  the reference package's for every (scale, edge_factor, seed).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import Policy, default_policy
from cuvite_tpu_torch.utils.rng import lcg_stream, scramble_ids, \
    splitmix64, u01


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
                 policy: Policy | None = None) -> Graph:
    """Random geometric graph of ``-n nv`` (no ``-e`` extra edges).  The
    point count is nv rounded down to a multiple of ``nshards``, as in the
    reference."""
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
    return Graph.from_edges(nv_eff, pairs[:, 0], pairs[:, 1], weights=d,
                            policy=policy)


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
    src, dst = rmat_edges_numpy(scale, ne, seed, a, b, c)
    keep = src != dst
    return Graph.from_edges(nv, src[keep], dst[keep], policy=policy)
