"""Single-shard padded graph layout (port of ``cuvite_tpu/core/distgraph.py``).

The port runs on one GPU, so only the single-shard case of the reference
``DistGraph.build`` is kept: the padded vertex space is ``[0, nv_pad)``
with ``nv_pad`` a power of two, original ids map to themselves, and
padding vertices sit at the tail.  The reference's ``min_nv_pad`` floor
(few compiled shapes across coarse phases) has no use in eager torch and
is not kept; padding vertices are isolated and never move, so labels do
not depend on it.  The bucketed engine never uploads the edge slab, so the slab is
the CSR itself (the reference's ``pad_edges=False`` layout): ``src`` is the
expanded row, ``dst``/``w`` alias ``tails``/``weights``.  No multi-GPU
sharding yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import next_pow2


@dataclasses.dataclass
class DistGraph:
    """One shard: the graph, its padded vertex count and its edge slab."""

    graph: Graph
    nv_pad: int
    src: np.ndarray          # [ne] local source index (CSR row expanded)
    dst: np.ndarray          # [ne] tail vertex id
    w: np.ndarray            # [ne] weight
    old_to_pad: np.ndarray   # [nv] original id -> padded id (identity)
    pad_to_old: np.ndarray   # [nv_pad] padded id -> original id, or -1

    @staticmethod
    def build(graph: Graph) -> "DistGraph":
        nv = graph.num_vertices
        nv_pad = next_pow2(max(nv, 1))
        vdt = graph.policy.vertex_dtype
        old_to_pad = np.arange(nv, dtype=np.int64)
        pad_to_old = np.full(nv_pad, -1, dtype=np.int64)
        pad_to_old[:nv] = old_to_pad
        return DistGraph(
            graph=graph,
            nv_pad=nv_pad,
            src=np.repeat(np.arange(nv, dtype=vdt), graph.degrees()),
            dst=graph.tails,
            w=graph.weights,
            old_to_pad=old_to_pad,
            pad_to_old=pad_to_old,
        )

    def padded_weighted_degrees(self) -> np.ndarray:
        """Weighted degree in the padded id space (padding vertices get 0)."""
        out = np.zeros(self.nv_pad, dtype=np.float64)
        out[self.old_to_pad] = self.graph.weighted_degrees().astype(np.float64)
        return out.astype(self.graph.policy.weight_dtype)

    def vertex_mask(self) -> np.ndarray:
        """Boolean mask over the padded id space marking real vertices."""
        return self.pad_to_old >= 0
