"""A tenant's resident streaming session: delta application and
warm-start re-clustering on the slab on the card (port of
``cuvite_tpu/stream/session.py``).

A :class:`StreamSession` owns one tenant's canonical edge slab on the
device for its lifetime:

  * ``apply_delta`` edits the slab in place on the device through
    ``stream/delta.apply_delta_slab``, keeps 2m on the host in f64, folds
    the batch digest into the session's content **fingerprint lineage**,
    and accumulates the delta **frontier** (touched endpoints and their
    slab neighbours) for the next warm start.  It reads the device once:
    the new row count, the retired weight, the delete hits and the
    frontier size, in one fetch.
  * ``recluster`` runs the clustering again under a warm-start arm:
    ``labels`` seeds phase 0 with the previous run's labels and
    activates only the accumulated frontier (``louvain/driver.
    warm_start_phase``, ET mode 1); ``plp`` seeds it with a label-
    propagation prepass; ``cold`` starts from the identity.  Phase 0
    sweeps the whole slab; the slab is then coarsened on the device and
    the fused engine runs every later phase, so the re-cluster stays on
    the card.

A stale warm start is refused: warm labels carry the fingerprint of the
slab content they were computed on, and ``recluster`` accepts them only
when it equals the lineage point the pending frontier measures its edits
from.  Labels from another session, another edit history or a skipped
delta raise instead of seeding wrong communities, as a checkpoint resume
refuses the wrong graph (``utils/checkpoint.py``).

The slab class is the reference's: ``DistGraph.build(graph, 1,
min_nv_pad=4096, min_ne_pad=16384)`` (:func:`canonical_slab`), the CSR
rows with padding rows src == nv_pad, dst == 0, w == 0 up to ne_pad =
max(next_pow2(ne), 16384), so spills, ``hbm_bytes`` and the serving
pool's evictions fall where the reference's do.  An insert batch that
overflows the headroom first grows the slab to the next pow2 class
(``coarsen/device.grow_slab``).  Coarse phases use the port's exact
classes (``maybe_shrink_to_class``), as its fused driver does.
"""

from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from cuvite_tpu_torch.coarsen.device import (
    device_coarsen_slab,
    device_compose_labels,
    device_renumber,
    device_weighted_degrees,
    grow_slab,
    maybe_shrink_to_class,
)
from cuvite_tpu_torch.core.batch import slab_class_of
from cuvite_tpu_torch.core.device import resolve_device
from cuvite_tpu_torch.core.distgraph import DistGraph
from cuvite_tpu_torch.core.types import TERMINATION_PHASE_COUNT, next_pow2
from cuvite_tpu_torch.stream.delta import (
    DeltaBatch,
    apply_delta_slab,
    delta_frontier,
    plp_prepass,
)
from cuvite_tpu_torch.utils.checkpoint import graph_fingerprint
from cuvite_tpu_torch.utils.trace import NullTracer
from cuvite_tpu_torch.utils.upload import to_device

WARM_MODES = ("labels", "plp", "cold")


def _fold_fingerprint(fp: int, digest: int) -> int:
    """Advance a content-fingerprint lineage by one canonical delta
    batch: deterministic in (fp, digest), so two sessions that applied
    the same edits to the same base agree, and any divergence -- a
    missed batch, a different base -- never collides back."""
    return zlib.crc32(np.int64(digest).tobytes(), fp & 0xFFFFFFFF) \
        ^ ((fp >> 16) << 8)


def canonical_slab(graph) -> tuple:
    """The single-shard padded slab of the reference session's
    ``DistGraph.build(graph, 1, min_nv_pad=4096, min_ne_pad=16384)`` as
    host arrays: (nv_pad, ne_pad, src int32, dst int32, w f32), the CSR
    rows first and padding rows (nv_pad, 0, 0) after; the class is the
    serving queue's (``core/batch.slab_class_of``)."""
    nv, ne = graph.num_vertices, graph.num_edges
    nv_pad, ne_pad = slab_class_of(graph)
    src = np.full(ne_pad, nv_pad, dtype=np.int32)
    src[:ne] = np.repeat(np.arange(nv, dtype=np.int32), graph.degrees())
    dst = np.zeros(ne_pad, dtype=np.int32)
    dst[:ne] = graph.tails
    w = np.zeros(ne_pad, dtype=np.float32)
    w[:ne] = graph.weights
    return nv_pad, ne_pad, src, dst, w


def _upload(arrays, dev: torch.device) -> list:
    """Equal-length int32 / f32 host arrays as tensors on ``dev``, in one
    copy (``utils/upload.to_device``: from pinned memory, making the host
    wait for nothing; on the CPU aliasing the packed copy, which is this
    function's own).  The f32 arrays travel as their bits."""
    packed = np.stack([a.view(np.int32) for a in arrays])
    t = to_device(packed, device=dev)
    return [t[i].view(torch.float32) if a.dtype == np.float32 else t[i]
            for i, a in enumerate(arrays)]


class StreamSession:
    """One tenant's resident slab and warm-start state (module note).

    Public state: ``src``/``dst``/``w`` (the canonical slab on
    ``device``), ``ne`` (real rows), ``nv``/``nv_pad``/``ne_pad``,
    ``tw2`` (2m, host f64), ``fingerprint`` (content lineage),
    ``frontier_frac`` (of the pending accumulated frontier).  The labels
    of the last ``recluster`` stay on the host (O(V)) for warm seeding
    and serving replies.
    """

    def __init__(self, *, nv, nv_pad, ne_pad, ne, src, dst, w, tw2,
                 policy, fingerprint, tracer=None):
        self.nv = int(nv)
        self.nv_pad = int(nv_pad)
        self.ne_pad = int(ne_pad)
        self.ne = int(ne)
        self.src = src
        self.dst = dst
        self.w = w
        self.device = src.device
        self.tw2 = float(tw2)
        self.policy = policy
        self.fingerprint = int(fingerprint)
        self.tracer = NullTracer() if tracer is None else tracer
        self._labels: np.ndarray | None = None
        self._labels_fp: int | None = None
        # The lineage point the pending frontier accumulates from: warm
        # labels are valid iff their fingerprint equals this.
        self.frontier_base_fp = int(fingerprint)
        self._frontier: torch.Tensor | None = None   # [nv_pad] bool
        self.frontier_frac = 0.0
        self.deltas_applied = 0

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_graph(graph, *, tracer=None, device=None) -> "StreamSession":
        """Upload a host graph as a resident session: the tenant's one
        full-slab upload; every later visit pays only its delta.
        ``device``: None is the card (raises without one)."""
        dev = resolve_device(device)
        nv_pad, ne_pad, src, dst, w = canonical_slab(graph)
        src_t, dst_t, w_t = _upload((src, dst, w), dev)
        return StreamSession(
            nv=graph.num_vertices, nv_pad=nv_pad, ne_pad=ne_pad,
            ne=graph.num_edges, src=src_t, dst=dst_t, w=w_t,
            tw2=graph.total_edge_weight_twice(), policy=graph.policy,
            fingerprint=graph_fingerprint(graph), tracer=tracer)

    # -- facts --------------------------------------------------------------

    @property
    def real_mask(self) -> torch.Tensor:
        return torch.arange(self.nv_pad, device=self.device) < self.nv

    def hbm_bytes(self) -> int:
        """Resident device footprint of the session, the serving pool's
        ledger unit: the three slab arrays plus the O(nv_pad) frontier
        and mask state.  Host-side labels are not device memory."""
        return 12 * self.ne_pad + 2 * self.nv_pad

    def labels(self) -> np.ndarray | None:
        return None if self._labels is None else self._labels.copy()

    # -- delta ingestion ----------------------------------------------------

    def apply_delta(self, batch: DeltaBatch) -> dict:
        """Apply one canonical batch; returns ``{n_ins, n_del, n_del_hit,
        ne, frontier_frac, wall_s}``.  Inserts that overflow the padding
        headroom first lift the slab to the next pow2 class
        (``grow_slab``), the only class transition."""
        if batch.num_vertices != self.nv:
            raise ValueError(
                f"delta batch is for {batch.num_vertices} vertices; the "
                f"resident session has {self.nv}")
        t0 = time.perf_counter()
        if self.ne + batch.n_ins > self.ne_pad:
            new_ne_pad = next_pow2(self.ne + batch.n_ins)
            self.src, self.dst, self.w = grow_slab(
                self.src, self.dst, self.w, nv_pad=self.nv_pad,
                new_nv_pad=self.nv_pad, new_ne_pad=new_ne_pad)
            self.tracer.event("delta_spill", ne_pad=self.ne_pad,
                              new_ne_pad=new_ne_pad)
            self.ne_pad = new_ne_pad
        ins_s, ins_d, ins_w, del_s, del_d, _ = batch.padded()
        ins_s, ins_d, ins_w, del_s, del_d = _upload(
            (ins_s, ins_d, ins_w, del_s, del_d), self.device)
        ins_mass = float(np.sum(batch.ins_w, dtype=np.float64))
        src2, dst2, w2, ne2_d, del_w_d, nhit_d = apply_delta_slab(
            self.src, self.dst, self.w, ins_s, ins_d, ins_w, del_s, del_d,
            self.ne, nv_pad=self.nv_pad)
        fr_d, nfr_d = delta_frontier(src2, dst2, ins_s, ins_d, del_s,
                                     del_d, nv_pad=self.nv_pad)
        if self._frontier is not None:
            fr_d = fr_d | self._frontier
            nfr_d = fr_d.sum()
        # The one host read of a delta.
        ne2, del_w, n_hit, n_fr = torch.stack(
            [ne2_d.double(), del_w_d.double(), nhit_d.double(),
             nfr_d.double()]).tolist()
        self.src, self.dst, self.w = src2, dst2, w2
        self.ne = int(ne2)
        # 2m fixup on the host, f64: inserts add a mass known exactly from
        # the canonical batch; deletes subtract the retired rows' slab
        # weight as the device measured it.
        self.tw2 = self.tw2 + ins_mass - del_w
        if self.tw2 <= 0:
            raise ValueError("delta removed the last edge weight; an "
                             "empty graph cannot be re-clustered")
        self.fingerprint = _fold_fingerprint(self.fingerprint,
                                             batch.digest())
        self._frontier = fr_d
        self.frontier_frac = float(int(n_fr)) / float(self.nv)
        self.deltas_applied += 1
        wall = time.perf_counter() - t0
        info = {"n_ins": batch.n_ins, "n_del": batch.n_del,
                "n_del_hit": int(n_hit), "ne": self.ne,
                "frontier_frac": round(self.frontier_frac, 6),
                "wall_s": wall}
        self.tracer.event("delta", **info)
        return info

    # -- re-clustering ------------------------------------------------------

    def recluster(self, warm: str = "labels", threshold: float = 1.0e-6,
                  max_phases: int = TERMINATION_PHASE_COUNT,
                  warm_labels=None, warm_fingerprint: int | None = None,
                  plp_iters: int = 3):
        """Re-cluster the resident slab; returns a ``louvain.driver.
        LouvainResult``, so golden envelopes and serving replies apply as
        they are.

        ``warm='labels'`` seeds phase 0 with the previous run's labels
        (or the caller's ``warm_labels``, tagged with
        ``warm_fingerprint``) and activates only the accumulated delta
        frontier; a fingerprint mismatch raises.  ``warm='plp'`` seeds it
        with a ``plp_iters``-sweep label-propagation prepass,
        ``warm='cold'`` with the identity; both activate every real
        vertex.
        """
        from cuvite_tpu_torch.louvain.driver import (
            LouvainResult,
            PhaseStats,
            warm_start_phase,
        )
        from cuvite_tpu_torch.louvain.fused import fused_louvain, fused_sweep
        from cuvite_tpu_torch.louvain.precise import phase_modularity

        if warm not in WARM_MODES:
            raise ValueError(f"unknown warm-start arm {warm!r}; "
                             f"use one of {WARM_MODES}")
        t0 = time.perf_counter()
        nv, nv_pad, dev = self.nv, self.nv_pad, self.device
        real_mask = self.real_mask
        vdeg = device_weighted_degrees(self.src, self.w, nv_pad=nv_pad)
        constant = 1.0 / self.tw2

        if warm == "labels":
            labels = warm_labels if warm_labels is not None \
                else self._labels
            fp = warm_fingerprint if warm_labels is not None \
                else self._labels_fp
            if labels is None:
                raise ValueError(
                    "warm-start 'labels' needs resident labels: run a "
                    "cold (or plp) recluster first, or pass warm_labels")
            if fp != self.frontier_base_fp:
                raise ValueError(
                    f"stale warm-start refused: labels carry content "
                    f"fingerprint {fp:#x} but the session's pre-delta "
                    f"lineage is {self.frontier_base_fp:#x} — these "
                    "labels were not computed against the slab the "
                    "pending deltas edited (wrong session, wrong base, "
                    "or a skipped batch); re-cluster cold instead")
            comm0_np = np.arange(nv_pad, dtype=np.int32)
            comm0_np[:nv] = np.asarray(labels, dtype=np.int32)[:nv]
            comm0 = torch.from_numpy(comm0_np).to(dev)
            active0 = (self._frontier & real_mask
                       if self._frontier is not None
                       else torch.zeros(nv_pad, dtype=torch.bool,
                                        device=dev))
        elif warm == "plp":
            comm0 = plp_prepass(self.src, self.dst, self.w, vdeg,
                                nv_pad=nv_pad, iters=plp_iters)
            active0 = real_mask
        else:
            comm0 = torch.arange(nv_pad, dtype=torch.int32, device=dev)
            active0 = real_mask

        sid = self.tracer.begin_span("recluster", warm=warm)
        labels_d, mod0, iters0, _conv = warm_start_phase(
            fused_sweep(self.src, self.dst, self.w, vdeg, constant), comm0,
            threshold, active0, real_mask=real_mask)

        # Coarsen on the device and compose the labels, then the fused
        # engine runs every later phase on the coarse slab.
        csrc, cdst, cw, dmap, nc_d, ne2 = device_coarsen_slab(
            self.src, self.dst, self.w, labels_d, real_mask, nv_pad=nv_pad,
            coalesce="sort")
        comm_all_d = device_compose_labels(
            dmap, labels_d, torch.arange(nv, dtype=labels_d.dtype,
                                         device=dev))
        nc = int(nc_d)
        csrc, cdst, cw, cnv_pad = maybe_shrink_to_class(
            csrc, cdst, cw, nc=nc, ne2=ne2, nv_pad=nv_pad)

        phases = [PhaseStats(phase=0, modularity=float(mod0),
                             iterations=iters0, num_vertices=nv,
                             num_edges=self.ne, seconds=0.0)]
        mask2 = torch.arange(cnv_pad, device=dev) < nc
        max_p2 = max(int(max_phases) - 1, 1)
        out = fused_louvain(csrc, cdst, cw, [threshold] * max_p2, constant,
                            mask2, nv_pad=cnv_pad, prev_mod0=mod0)
        tot_iters = iters0 + out.iterations
        nv_p = nc
        for fp_ in out.phases:
            phases.append(PhaseStats(
                phase=len(phases), modularity=fp_.modularity,
                iterations=fp_.iterations, num_vertices=nv_p,
                num_edges=ne2, seconds=0.0))
            nv_p = fp_.num_communities
        dmap2, _ = device_renumber(out.labels, mask2, nv_pad=cnv_pad)
        comm_all_d = device_compose_labels(dmap2, out.labels, comm_all_d)
        comm_all = comm_all_d.cpu().numpy().astype(np.int64)

        dgq = DistGraph.from_device_slab(
            csrc, cdst, cw, num_vertices=nc, num_edges=ne2,
            nv_pad=cnv_pad, policy=self.policy, total_weight_twice=self.tw2)
        final_q = phase_modularity(dgq, out.labels.cpu().numpy(),
                                   (csrc, cdst, cw))

        wall = time.perf_counter() - t0
        for st in phases:
            st.seconds = wall / len(phases)
        # The labels now describe the CURRENT content; the frontier
        # resets.
        self._labels = comm_all
        self._labels_fp = self.fingerprint
        self.frontier_base_fp = self.fingerprint
        self._frontier = None
        frontier_frac = self.frontier_frac
        self.frontier_frac = 0.0
        self.tracer.end_span(sid, wall_s=wall, warm=warm, q=float(final_q),
                             frontier_frac=round(frontier_frac, 6),
                             iterations=tot_iters)
        return LouvainResult(
            communities=comm_all, modularity=float(final_q),
            phases=phases, total_iterations=tot_iters, total_seconds=wall)
