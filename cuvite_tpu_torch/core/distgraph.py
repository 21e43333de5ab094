"""Single-shard padded graph layout (port of ``cuvite_tpu/core/distgraph.py``).

The port runs on one GPU, so only the single-shard case of the reference
``DistGraph.build`` is kept: the padded vertex space is ``[0, nv_pad)``
with ``nv_pad`` a power of two, original ids map to themselves, and
padding vertices sit at the tail.  The reference's ``min_nv_pad`` and
``min_ne_pad`` floors (few compiled shapes across coarse phases) have no
use in eager torch and are not kept; padding vertices are isolated and
never move, so labels do not depend on them.

The host slab is the CSR itself (the reference's ``pad_edges=False``
layout): ``src`` is the expanded row, ``dst``/``w`` alias
``tails``/``weights``, with no padding rows.  The bucketed engine builds
its plan from it and never uploads it; the sort engine uploads it once
(:meth:`DistGraph.device_slab`).  After a device coarsening
(``coarsen/device.py``) the graph exists only as a slab on the card:
:meth:`DistGraph.from_device_slab` wraps it with a :class:`SlabMeta` and
no host CSR.  Either slab keeps the reference's contract -- src
ascending, padding rows (if any) ``src == nv_pad``, ``dst == 0``,
``w == 0`` -- and its length is the real edge count.  No multi-GPU
sharding yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import Policy, next_pow2


@dataclasses.dataclass
class SlabMeta:
    """Stands in for ``DistGraph.graph`` when the graph exists only as a
    slab on the device (reference ``SlabMeta``, ``distgraph.py:73-88``):
    the scalar facts the driver reads and nothing of O(E) size.  2m is
    carried through coarsening unchanged -- community aggregation keeps it
    exactly -- never re-summed from the slab."""

    num_vertices: int
    num_edges: int
    policy: Policy
    tw2: float

    def total_edge_weight_twice(self) -> float:
        return self.tw2


@dataclasses.dataclass
class DistGraph:
    """One shard: the graph, its padded vertex count and its edge slab."""

    graph: Graph | SlabMeta  # host CSR, or SlabMeta for a device slab
    nv_pad: int
    src: np.ndarray | torch.Tensor   # [ne] source index (CSR row expanded)
    dst: np.ndarray | torch.Tensor   # [ne] tail vertex id
    w: np.ndarray | torch.Tensor     # [ne] weight
    old_to_pad: np.ndarray   # [nv] original id -> padded id (identity)
    pad_to_old: np.ndarray   # [nv_pad] padded id -> original id, or -1
    device_resident: bool = False    # src/dst/w are tensors on the card

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

    @staticmethod
    def from_device_slab(src: torch.Tensor, dst: torch.Tensor,
                         w: torch.Tensor, *, num_vertices: int,
                         num_edges: int, nv_pad: int, policy: Policy,
                         total_weight_twice: float) -> "DistGraph":
        """Wrap a slab already on the device -- the output of
        ``coarsen/device.py`` -- without a host rebuild (reference
        ``DistGraph.from_device_slab``, ``distgraph.py:258-294``).  A
        coarse graph's vertex ids are its dense community ids, so the id
        tables are the identity; ``total_weight_twice`` is the original
        graph's 2m."""
        meta = SlabMeta(num_vertices=num_vertices, num_edges=num_edges,
                        policy=policy, tw2=float(total_weight_twice))
        old_to_pad = np.arange(num_vertices, dtype=np.int64)
        pad_to_old = np.full(nv_pad, -1, dtype=np.int64)
        pad_to_old[:num_vertices] = old_to_pad
        return DistGraph(graph=meta, nv_pad=nv_pad, src=src, dst=dst, w=w,
                         old_to_pad=old_to_pad, pad_to_old=pad_to_old,
                         device_resident=True)

    def device_slab(self, device) -> tuple:
        """(src, dst, w) as int32/int32/float32 tensors on ``device``: the
        resident slab as it is, or the host slab uploaded once."""
        if self.device_resident:
            return self.src, self.dst, self.w
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
                     for a, dt in ((self.src, torch.int32),
                                   (self.dst, torch.int32),
                                   (self.w, torch.float32)))

    def padded_weighted_degrees(self) -> np.ndarray | torch.Tensor:
        """Weighted degree in the padded id space (padding vertices get 0).
        A device-resident slab sums its own weights on the device and
        returns a float32 tensor there."""
        if self.device_resident:
            from cuvite_tpu_torch.coarsen.device import (
                device_weighted_degrees,
            )

            return device_weighted_degrees(self.src, self.w,
                                           nv_pad=self.nv_pad)
        out = np.zeros(self.nv_pad, dtype=np.float64)
        out[self.old_to_pad] = self.graph.weighted_degrees().astype(np.float64)
        return out.astype(self.graph.policy.weight_dtype)

    def vertex_mask(self) -> np.ndarray:
        """Boolean mask over the padded id space marking real vertices."""
        return self.pad_to_old >= 0
