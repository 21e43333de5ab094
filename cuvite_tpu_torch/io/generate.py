"""R-MAT generator (port of ``cuvite_tpu/io/generate.py:180-234``).

Graph500-style R-MAT (a=0.57, b=0.19, c=0.19) with a counter-based
SplitMix64 RNG: the edge list is bit-identical to the reference package's,
for every (scale, edge_factor, seed).  The random geometric generator is
not ported yet.
"""

from __future__ import annotations

import numpy as np

from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import Policy, default_policy
from cuvite_tpu_torch.utils.rng import scramble_ids, splitmix64, u01


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
