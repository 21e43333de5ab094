"""Padded graph layout, one shard or many (port of
``cuvite_tpu/core/distgraph.py:26-72,141-257,298-327``).

One shard: the padded vertex space is ``[0, nv_pad)`` with ``nv_pad`` a
power of two, original ids map to themselves, and padding vertices sit
at the tail.  The reference's ``min_nv_pad`` and ``min_ne_pad`` floors
(few compiled shapes across coarse phases) have no use in eager torch and
are not applied to one shard; padding vertices are isolated and never
move, so labels do not depend on them.

The host slab is the CSR itself (the reference's ``pad_edges=False``
layout): ``src`` is the expanded row, ``dst``/``w`` alias
``tails``/``weights``, with no padding rows.  The bucketed engine builds
its plan from it and never uploads it; the sort engine uploads it once
(:meth:`DistGraph.device_slab`).  After a device coarsening
(``coarsen/device.py``) the graph exists only as a slab on the card:
:meth:`DistGraph.from_device_slab` wraps it with a :class:`SlabMeta` and
no host CSR.  Either slab keeps the reference's contract -- src
ascending, padding rows (if any) ``src == nv_pad``, ``dst == 0``,
``w == 0`` -- and its length is the real edge count.

Several shards (``nshards > 1``, the vertex mesh of ``comm/mesh.py``):
the reference's layout array for array -- contiguous vertex ranges
(:func:`uniform_parts`, or edge-balanced :func:`balanced_parts`, the
``-b`` flag), each shard owning ``[s * nv_pad, (s + 1) * nv_pad)`` of the
padded id space with its padding at the tail, and one edge slab per
shard (:class:`Shard`: local src, padded-global dst, w) padded to a
common ``ne_pad``, padding rows ``src == nv_pad``.  ``min_nv_pad`` and
``min_ne_pad`` are kept there for parity with the reference's builds.
A multi-shard graph lives on the host; the sharded engines upload its
slabs or plans shard by shard.  A rank of a process group builds the
slabs of its own shards only (``shard_ids``); the others keep their
range and edge count with ``src=None``, as a per-rank ingest's do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import Policy, next_pow2


def uniform_parts(num_vertices: int, nshards: int) -> np.ndarray:
    """Contiguous near-equal vertex ranges: ``parts[nshards + 1]``."""
    chunk = num_vertices // nshards
    rem = num_vertices % nshards
    sizes = np.full(nshards, chunk, dtype=np.int64)
    sizes[:rem] += 1
    parts = np.zeros(nshards + 1, dtype=np.int64)
    np.cumsum(sizes, out=parts[1:])
    return parts


def balanced_parts_from_offsets(offsets, nv: int, ne: int,
                                nshards: int) -> np.ndarray:
    """Edge-balanced contiguous ranges from a CSR offset array: each
    shard owns about ne / nshards edges."""
    targets = (np.arange(1, nshards, dtype=np.int64) * ne) // nshards
    cuts = np.searchsorted(offsets[1:], targets, side="left") + 1
    parts = np.concatenate([[0], np.clip(cuts, 0, nv), [nv]]).astype(np.int64)
    # Monotone even where a shard would be empty.
    np.maximum.accumulate(parts, out=parts)
    return parts


def balanced_parts(graph: Graph, nshards: int) -> np.ndarray:
    """Edge-balanced contiguous ranges of ``graph`` (the reference
    application's ``-b``)."""
    return balanced_parts_from_offsets(
        graph.offsets, graph.num_vertices, graph.num_edges, nshards)


@dataclasses.dataclass
class Shard:
    """One shard's padded edge slab and its owned original-id range."""

    base: int         # first owned original vertex id
    bound: int        # one past the last owned original vertex id
    src: np.ndarray   # [ne_pad] LOCAL source index; padding = nv_pad
    dst: np.ndarray   # [ne_pad] padded-global tail id; padding = 0
    w: np.ndarray     # [ne_pad] weight; padding = 0
    n_real_edges: int


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
    """The graph, its padded vertex count per shard and its edge slabs.
    One shard keeps its slab in ``src``/``dst``/``w``; several keep one
    :class:`Shard` each in ``shards`` (``src``/``dst``/``w`` None)."""

    graph: Graph | SlabMeta  # host CSR, or SlabMeta for a device slab
    nv_pad: int              # owned padded vertices per shard
    src: np.ndarray | torch.Tensor | None  # [ne] source index (one shard)
    dst: np.ndarray | torch.Tensor | None  # [ne] tail vertex id
    w: np.ndarray | torch.Tensor | None    # [ne] weight
    old_to_pad: np.ndarray   # [nv] original id -> padded id
    pad_to_old: np.ndarray   # [nshards * nv_pad] padded id -> original, -1
    device_resident: bool = False    # src/dst/w are tensors on the card
    nshards: int = 1
    parts: np.ndarray | None = None  # [nshards + 1] original-id ranges
    ne_pad: int = 0                  # edge slots per shard (several)
    shards: list = dataclasses.field(default_factory=list)

    @property
    def total_padded_vertices(self) -> int:
        return self.nshards * self.nv_pad

    def owner_of_padded(self, v: int) -> int:
        return v // self.nv_pad

    @staticmethod
    def build(graph: Graph, nshards: int = 1, balanced: bool = False,
              pad_pow2: bool = True, min_nv_pad: int = 1,
              min_ne_pad: int = 1, shard_ids=None) -> "DistGraph":
        """One shard: the CSR layout of the module note (the other
        arguments do not apply).  Several: the reference's padded slabs
        (``min_nv_pad``/``min_ne_pad`` floor the padded sizes,
        ``pad_pow2`` rounds them up to powers of two); with ``shard_ids``
        (a rank's shards of a process group) only those shards get their
        slabs, the others ``src=None``."""
        if nshards > 1:
            return _build_sharded(graph, nshards, balanced, pad_pow2,
                                  min_nv_pad, min_ne_pad, shard_ids)
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
            parts=np.asarray([0, nv], dtype=np.int64),
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
                         device_resident=True,
                         parts=np.asarray([0, num_vertices], dtype=np.int64))

    def device_slab(self, device) -> tuple:
        """(src, dst, w) as int32/int32/float32 tensors on ``device``: the
        resident slab as it is, or the host slab uploaded once
        (``utils/upload.to_device``: in flight on the card's current
        stream; on the CPU aliasing the host arrays where the dtypes
        match, which then are frozen -- the sweeps and coarsenings only
        read the slab)."""
        if self.device_resident:
            return self.src, self.dst, self.w
        from cuvite_tpu_torch.utils.upload import to_device

        return tuple(to_device(a, dt, device)
                     for a, dt in ((self.src, torch.int32),
                                   (self.dst, torch.int32),
                                   (self.w, torch.float32)))

    def stacked_edges(self) -> tuple:
        """(src, dst, w) of every shard concatenated shard-major,
        [nshards * ne_pad] each (one shard: its slab as it is)."""
        if self.nshards == 1:
            return self.src, self.dst, self.w
        return tuple(np.concatenate([getattr(sh, f) for sh in self.shards])
                     for f in ("src", "dst", "w"))

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
        out = np.zeros(self.total_padded_vertices, dtype=np.float64)
        out[self.old_to_pad] = self.graph.weighted_degrees().astype(np.float64)
        return out.astype(self.graph.policy.weight_dtype)

    def vertex_mask(self) -> np.ndarray:
        """Boolean mask over the padded id space marking real vertices."""
        return self.pad_to_old >= 0


def _build_sharded(graph: Graph, nshards: int, balanced: bool,
                   pad_pow2: bool, min_nv_pad: int, min_ne_pad: int,
                   shard_ids=None) -> DistGraph:
    """The reference's multi-shard ``DistGraph.build``, array for array
    (the slabs of ``shard_ids`` only, when given)."""
    nv = graph.num_vertices
    parts = (balanced_parts(graph, nshards) if balanced
             else uniform_parts(nv, nshards))
    owned = np.diff(parts)
    nv_pad = max(int(owned.max()) if len(owned) else 1, min_nv_pad)
    if pad_pow2:
        nv_pad = next_pow2(max(nv_pad, 1))
    old_to_pad = np.empty(nv, dtype=np.int64)
    pad_to_old = np.full(nshards * nv_pad, -1, dtype=np.int64)
    for s in range(nshards):
        lo, hi = int(parts[s]), int(parts[s + 1])
        old_to_pad[lo:hi] = s * nv_pad + np.arange(hi - lo)
        pad_to_old[s * nv_pad: s * nv_pad + (hi - lo)] = np.arange(lo, hi)
    counts = [int(graph.offsets[parts[s + 1]] - graph.offsets[parts[s]])
              for s in range(nshards)]
    ne_pad = max(max(counts) if counts else 1, 1, min_ne_pad)
    if pad_pow2:
        ne_pad = next_pow2(ne_pad)
    vdt = graph.policy.vertex_dtype
    wdt = graph.policy.weight_dtype
    held = range(nshards) if shard_ids is None else shard_ids
    shards = []
    for s in range(nshards):
        lo, hi = int(parts[s]), int(parts[s + 1])
        e0, e1 = int(graph.offsets[lo]), int(graph.offsets[hi])
        n = e1 - e0
        if s not in held:
            shards.append(Shard(base=lo, bound=hi, src=None, dst=None,
                                w=None, n_real_edges=n))
            continue
        src_l = np.full(ne_pad, nv_pad, dtype=vdt)
        dst_g = np.zeros(ne_pad, dtype=vdt)
        w = np.zeros(ne_pad, dtype=wdt)
        # A source's local index is its offset in the shard's range.
        src_l[:n] = np.repeat(np.arange(hi - lo, dtype=vdt),
                              np.diff(graph.offsets[lo: hi + 1]))
        dst_g[:n] = old_to_pad[graph.tails[e0:e1].astype(np.int64)].astype(
            vdt)
        w[:n] = graph.weights[e0:e1]
        shards.append(Shard(base=lo, bound=hi, src=src_l, dst=dst_g, w=w,
                            n_real_edges=n))
    return DistGraph(graph=graph, nv_pad=nv_pad, src=None, dst=None, w=None,
                     old_to_pad=old_to_pad, pad_to_old=pad_to_old,
                     nshards=nshards, parts=parts, ne_pad=ne_pad,
                     shards=shards)
