"""Per-rank sharded ingest: each rank reads ONLY its shards' edge ranges
(port of ``cuvite_tpu/io/dist_ingest.py``).

The counterpart of the reference application's collective MPI-IO load
(loadDistGraphMPIIO[Balanced], distgraph.cpp:69-337): every rank of a
multi-process run (``comm/multihost.py``) issues
``read_vite(vertex_range=...)`` range reads for the shards it owns, so
no rank ever holds the whole O(ne) edge list: host memory is O(local
edges + nv).

What stays replicated (O(nv) or smaller, computed alike on every rank):
the partition, the padded-id maps, the whole weighted-degree vector
(assembled by an all-gather of the ranks' blocks, the counterpart of the
reference application's degree Allreduce) and the coarse graphs of
phases >= 1 (assembled by all-gathering each rank's aggregated coarse
edges, the counterpart of send_newEdges).

A checkpoint of a run on a DistVite carries its
:meth:`DistVite.content_fingerprint`, a hash of the partitioned layout
combined across the ranks, equal to the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
import zlib

import numpy as np

from cuvite_tpu_torch.comm.multihost import (
    allgather_varlen,
    allreduce_sum_host,
    local_shard_range,
)
from cuvite_tpu_torch.core.distgraph import (
    Shard,
    balanced_parts_from_offsets,
    uniform_parts,
)
from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import (
    Policy,
    default_policy,
    next_pow2,
    wide_policy,
)
from cuvite_tpu_torch.io.vite import _edge_dtype, _elem_dtype, read_vite


@dataclasses.dataclass
class GraphMeta:
    """Stands in for ``Graph`` where only its scalar facts are needed
    (per-rank ingest never holds the whole edge list)."""

    num_vertices: int
    num_edges: int
    policy: Policy
    tw2: float

    def total_edge_weight_twice(self) -> float:
        return self.tw2


@dataclasses.dataclass
class DistVite:
    """A ``DistGraph``-shaped partition whose edge slabs exist only for
    the shards of THIS rank (remote shards carry ``src=None``).

    It has the ``DistGraph`` surface the sparse bucketed mesh path reads;
    ``graph`` is a :class:`GraphMeta`, so the whole-graph host steps use
    :meth:`modularity` and :meth:`coarse_edges` instead, which reduce over
    the local slabs and combine across the ranks."""

    graph: GraphMeta
    parts: np.ndarray
    nshards: int
    nv_pad: int
    ne_pad: int
    shards: list
    local_lo: int          # first shard index this rank owns
    local_hi: int          # one past its last
    vdeg_full: np.ndarray  # [nshards * nv_pad] padded weighted degrees
    bytes_read: int = 0    # file bytes this rank read

    local_only = True      # marks the per-rank layout for the driver

    @property
    def num_vertices(self) -> int:
        return self.graph.num_vertices

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    @property
    def total_padded_vertices(self) -> int:
        return self.nshards * self.nv_pad

    @functools.cached_property
    def old_to_pad(self) -> np.ndarray:
        out = np.empty(self.graph.num_vertices, dtype=np.int64)
        for s in range(self.nshards):
            lo, hi = int(self.parts[s]), int(self.parts[s + 1])
            out[lo:hi] = s * self.nv_pad + np.arange(hi - lo)
        return out

    @functools.cached_property
    def pad_to_old(self) -> np.ndarray:
        out = np.full(self.total_padded_vertices, -1, dtype=np.int64)
        for s in range(self.nshards):
            lo, hi = int(self.parts[s]), int(self.parts[s + 1])
            out[s * self.nv_pad: s * self.nv_pad + (hi - lo)] = np.arange(
                lo, hi)
        return out

    def padded_weighted_degrees(self) -> np.ndarray:
        return self.vdeg_full

    def vertex_mask(self) -> np.ndarray:
        return self.pad_to_old >= 0

    def _to_pad(self, v: np.ndarray) -> np.ndarray:
        """Original ids -> padded ids without the O(nv) map."""
        owner = np.searchsorted(self.parts, v, side="right") - 1
        return owner * self.nv_pad + (v - self.parts[owner])

    @staticmethod
    def load(path: str, nshards: int, bits64: bool = True,
             balanced: bool = False, policy: Policy | None = None,
             min_nv_pad: int = 1, min_ne_pad: int = 1) -> "DistVite":
        """Partition the Vite file ``path`` into ``nshards`` shards (uniform
        or, with ``balanced``, edge-balanced ranges) and read this rank's
        shards (``multihost.local_shard_range``; every shard outside a
        process group).  Collective: every rank of the group calls it."""
        policy = policy or (wide_policy() if bits64 else default_policy())
        elem = _elem_dtype(bits64)
        header = np.fromfile(path, dtype=elem, count=2)
        if len(header) != 2:
            raise ValueError(f"{path}: truncated Vite header")
        nv, ne = int(header[0]), int(header[1])
        offsets = np.asarray(np.memmap(path, dtype=elem, mode="r",
                                       offset=2 * elem.itemsize,
                                       shape=(nv + 1,)), dtype=np.int64)
        if balanced:
            parts = balanced_parts_from_offsets(offsets, nv, ne, nshards)
        else:
            parts = uniform_parts(nv, nshards)
        owned = np.diff(parts)
        nv_pad = next_pow2(max(int(owned.max()) if len(owned) else 1,
                               min_nv_pad, 1))
        counts = offsets[parts[1:]] - offsets[parts[:-1]]
        ne_pad = next_pow2(max(int(counts.max()) if len(counts) else 1,
                               min_ne_pad, 1))

        lo, hi = local_shard_range(nshards)
        vdt, wdt = policy.vertex_dtype, policy.weight_dtype
        shards = []
        local_wsum = 0.0
        vdeg_blocks = np.zeros((hi - lo) * nv_pad, dtype=np.float64)
        dv = DistVite(
            graph=GraphMeta(nv, ne, policy, 0.0), parts=parts,
            nshards=nshards, nv_pad=nv_pad, ne_pad=ne_pad, shards=shards,
            local_lo=lo, local_hi=hi, vdeg_full=None,
            bytes_read=(3 + nv) * elem.itemsize)
        for s in range(nshards):
            p0, p1 = int(parts[s]), int(parts[s + 1])
            n = int(counts[s])
            if not lo <= s < hi:
                shards.append(Shard(base=p0, bound=p1, src=None, dst=None,
                                    w=None, n_real_edges=n))
                continue
            gs = read_vite(path, bits64=bits64, policy=policy,
                           vertex_range=(p0, p1))
            dv.bytes_read += (p1 - p0 + 1) * elem.itemsize \
                + n * _edge_dtype(bits64).itemsize
            src_l = np.full(ne_pad, nv_pad, dtype=vdt)
            dst_g = np.zeros(ne_pad, dtype=vdt)
            w = np.zeros(ne_pad, dtype=wdt)
            src_l[:n] = gs.sources()
            dst_g[:n] = dv._to_pad(gs.tails.astype(np.int64)).astype(vdt)
            w[:n] = gs.weights
            shards.append(Shard(base=p0, bound=p1, src=src_l, dst=dst_g,
                                w=w, n_real_edges=n))
            blk = (s - lo) * nv_pad
            vdeg_blocks[blk: blk + (p1 - p0)] = np.bincount(
                gs.sources(), weights=gs.weights.astype(np.float64),
                minlength=p1 - p0)
            local_wsum += float(gs.weights.sum(dtype=np.float64))
        # The degree Allreduce's counterpart: the ranks' padded blocks,
        # contiguous in shard order, make the whole vector.
        dv.vdeg_full = np.concatenate(allgather_varlen(vdeg_blocks)).astype(
            wdt)
        if len(dv.vdeg_full) != nshards * nv_pad:
            raise RuntimeError(
                f"gathered {len(dv.vdeg_full)} degrees for "
                f"{nshards * nv_pad} padded vertices")
        dv.graph.tw2 = float(allreduce_sum_host(local_wsum))
        return dv

    # ---- whole-graph stand-ins (reductions across the ranks) ------------

    def content_fingerprint(self) -> int:
        """The checkpoint fingerprint of the input (reference
        ``io/dist_ingest.py:193-227``, bit for bit): a CRC of each local
        shard's (base, bound, edge count, src, dst, w), the ranks'
        per-shard digests all-gathered and chained in shard order, with
        the vertex count.  It covers the partitioned layout, so a resume
        with another nshards or balanced setting is refused as another
        graph.  Collective: every rank calls it."""
        digests = []
        for s in range(self.local_lo, self.local_hi):
            sh = self.shards[s]
            n = int(sh.n_real_edges)
            h = zlib.crc32(np.asarray([sh.base, sh.bound, n],
                                      dtype=np.int64).tobytes())
            for a in (sh.src, sh.dst, sh.w):
                h = zlib.crc32(np.ascontiguousarray(a[:n]).view(np.uint8), h)
            digests.append(h)
        h = 0
        for v in np.concatenate(allgather_varlen(
                np.asarray(digests, dtype=np.int64))):
            h = zlib.crc32(np.int64(v).tobytes(), h)
        return (h << 16) ^ (self.num_vertices & 0xFFFF)

    def _local_edges(self):
        """(padded src, padded dst, w) of each local shard's real edges."""
        for s in range(self.local_lo, self.local_hi):
            sh = self.shards[s]
            real = sh.src < self.nv_pad
            yield (s * self.nv_pad + sh.src[real].astype(np.int64),
                   sh.dst[real].astype(np.int64), sh.w[real])

    def modularity(self, comm_pad: np.ndarray) -> float:
        """f64 modularity of padded-space labels: the e-term over the local
        slabs, summed across the ranks, and the a-term from the whole
        degree vector (distComputeModularity's Allreduce)."""
        comm_pad = np.asarray(comm_pad).astype(np.int64)
        e_local = 0.0
        for sg, dg_, w in self._local_edges():
            same = comm_pad[sg] == comm_pad[dg_]
            e_local += float(w[same].astype(np.float64).sum())
        e_xx = float(allreduce_sum_host(e_local))
        a = np.bincount(comm_pad, weights=self.vdeg_full.astype(np.float64))
        c = 1.0 / self.graph.tw2
        return e_xx * c - float((a * a).sum()) * c * c

    def coarse_edges(self, dense_comm_pad: np.ndarray, nc: int) -> tuple:
        """Community -> community edges of the next phase: the local slabs
        aggregated, then every rank's (much smaller) coarse triples
        all-gathered (fill_newEdgesMap + send_newEdges).  Returns (src,
        dst, w) of the WHOLE coarse graph on every rank."""
        dense = np.asarray(dense_comm_pad).astype(np.int64)
        edges = list(self._local_edges())
        if edges:
            src = np.concatenate([dense[e[0]] for e in edges])
            dst = np.concatenate([dense[e[1]] for e in edges])
            w = np.concatenate([e[2].astype(np.float64) for e in edges])
            # Local pre-aggregation bounds the all-gather.
            glocal = Graph.from_edges(nc, src, dst, weights=w,
                                      symmetrize=False)
            src = glocal.sources().astype(np.int64)
            dst = glocal.tails.astype(np.int64)
            w = glocal.weights.astype(np.float64)
        else:
            src = dst = np.zeros(0, dtype=np.int64)
            w = np.zeros(0, dtype=np.float64)
        return tuple(np.concatenate(allgather_varlen(a))
                     for a in (src, dst, w))
