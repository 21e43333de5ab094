"""Multi-phase Louvain driver, on one device or a vertex mesh (port of
``cuvite_tpu/louvain/driver.py``: its engines and schedules, and its
single-process mesh path).

Replicates the reference application loop (main.cpp:218-495,
louvain.cpp:425-588): per-phase sweeps until the modularity gain drops
below the threshold, keeping the last assignment whose gain passed;
threshold cycling 1e-3 -> 1e-6 over a 13-phase cycle with the final 1e-6
safety pass; coarsening and cross-phase label composition; at most 200
phases and 10,000 iterations.

Engines (``engine=``): ``'bucketed'`` (and ``'auto'``, as in the
reference, ``driver.py:1866``) sweeps the degree-bucketed plan on the
row-argmax and heavy-bincount kernels, builds each phase's plan on the
host and coarsens on the host.  ``'pallas'`` is the reference's name for
its bucketed engine with the classes up to ``PALLAS_MAX_WIDTH`` (2048)
routed through its row kernel; the port's row kernel already serves every
width, so ``'pallas'`` runs the bucketed engine, routes nothing by width
and has no ``CUVITE_PALLAS_MAX``.  ``'sort'`` keeps the edge slab on the
card, sweeps it with ``louvain_step_local`` and coarsens it on the card
(``coarsen/device.py``, the ``seg_coalesce`` kernel for classes with
nv_pad <= 4096): phases after the first get their graph from that device
transition, as a resident slab plus ``SlabMeta``, with one host read of
the coarse edge count per phase (``driver.py:2310-2368``).  Labels are
composed on the host in both.  ``'fused'`` (``louvain/fused.py``) uploads
the slab once and runs relabel-only phases on it, coarsening on the card
between calls while the slab is big (``FUSED_SHRINK_EDGES``) and
composing labels there.

Schedules of the bucketed and sort engines: early termination
(``et_mode`` 1-4, louvain.cpp:7-423) freezes vertices inside a phase;
``coloring=N`` / ``vertex_ordering=N`` color phase 0 and sweep it one
color class at a time, each class on its own bucket plan (coloring
refreshes the community tables per class, vertex ordering freezes them at
the iteration start).  The fused engine covers the plain schedule only
and hands the others to the bucketed engine with a warning, as does the
reference; the sort engine hands colored runs to the bucketed engine (the
port has no full-sweep color schedule, so there is no
``CUVITE_KEEP_SORT_COLORING``).  ``checkpoint_dir``/``resume`` save and
reload the state after each gaining phase (``utils/checkpoint.py``); a
checkpointed sort run coarsens on the host, which the files need.

Differences from the reference, by design rather than fault:

- Torch has no device while-loop, so the phase loop reads the stop test's
  values on the host once per sweep: Q, the moved count (the convergence
  rows) and, under ET modes 3/4, the active count, in one fetch.  The
  reference runs the whole phase in one ``lax.while_loop`` and syncs once
  per phase.  Its ET decisions are kept exactly: in f32 where its device
  loop makes them, in Python floats where its host loop (the class
  schedules) does.
- The in-loop Q is float64 on the device.  The reference's is float32 (or
  double-single pairs), so a gain within f32 rounding of the threshold can
  end a phase one sweep apart from the reference.
- The reported per-phase Q is the host f64 oracle for the bucketed engine
  and an f64 pass over the resident slab for the sort and fused engines,
  as in the reference (which uses ds32 pairs there).
- No accumulator tag feeds the coalesce engine choice: every float sum
  is f64 on the port, so there is no ds32 mode to route to the sort.
- The class schedules' convergence rows carry real moved counts (the
  reference leaves them untracked: it would cost it a sync).
- Kernel coverage (``LouvainResult.pallas_coverage`` and
  ``pallas_width_hits``, the reference's accounting, ``driver.py:
  1117-1138,2200-2240``): every bucketed or pallas run carries it, since
  every one sweeps its classes on the hand kernels (on the CPU their
  twins).  A class counts as kernelized by the route its sweep takes
  (``DevicePlan.coverage``): every bucket width, the wide ones above
  2048 included, and the hubs when the heavy kernel takes them (not on
  the sparse exchange, whose hubs ride the sorted path).  The reference
  flags only widths up to 2048 and, on a mesh, never the hubs, and
  counts class-scheduled phases as unkernelized; the port's class steps
  launch the row kernel, so they count.  Per width the traversed edges
  are the reference's; only the flags differ.

Device re-binning (reference ``driver.py:810-858``): in the bucketed
engine every phase after the first whose class the reference would
re-bin (``coarsen/rebin.rebin_eligible`` on the reference's floored class,
nv_pad >= 4096 and ne_pad >= 16384) and that runs no class schedule
builds its plan on the card (``coarsen/rebin.device_plan``), timed under
``stages["rebin"]``; ``LouvainResult.rebinned_phases`` lists those
phases.  Other phases, and every phase under ``CUVITE_DEVICE_REBIN=0``,
keep the host ``BucketPlan.build``.

``louvain_many`` clusters a batch of same-class graphs at once
(``louvain/batched.py``).

``tracer=`` (``utils/trace.Tracer``, with a flight recorder or without)
receives the reference's hooks: the stages ``plan`` (containing
``upload`` and ``rebin``), ``color``, ``iterate``, ``evaluate`` and
``coarsen`` (containing ``coalesce``), timed by the same clock as
``PhaseStats.stages``; the counters ``traversed_edges`` (edges x sweeps
of each phase attempt), ``coalesce_edges``/``coalesce_dense_edges`` and
``rebin_phases``/``rebin_device_phases``; a ``phase`` span with
``convergence`` and ``coarsen`` events; the phase tag; and the memory
ledger (slab, tables and plans of each phase, a snapshot a phase).  The
hooks read host values the loop already holds and tensor metadata only:
a tracer adds no host sync and leaves the labels bit for bit.

A vertex mesh (``nshards=S`` or ``mesh=``, ``comm/mesh.py``; reference
``driver.py:488-800,1036-1067,1734-2450``): every phase is built as S
vertex shards (``DistGraph.build(g, S, balanced=)``) and swept by
:class:`MeshPhaseRunner` -- the bucketed engine under the replicated or
the sparse ghost exchange (``exchange``: 'auto' picks sparse per phase
from ``exchange_cutover()`` padded vertices, the reference's
``CUVITE_EXCHANGE_CUTOVER``), or the sort engine under the replicated
one.  A sparse phase whose per-peer budget overflows is re-run with a
larger budget (sticky across phases).  Coarsening between phases runs on
the host and the next phase re-shards, as in the reference; no device
coarsening or re-binning runs on a mesh.  ``engine='fused'`` warns and
runs the bucketed engine.  ET, coloring, vertex ordering and checkpoints
run on a mesh under both exchanges (reference ``driver.py:739-795,
1203-1279``): ET on the shards' lists of ``loop.phase_loop``, the color
schedules on one mesh plan per class (``MeshPhaseRunner(classes=)``).
``mesh_shape=(dcn, ici)`` (or ``"DxI"``, or a ``mesh`` from
``comm.mesh.make_hybrid_mesh``) runs the two-level exchange on a hybrid
mesh of dcn groups of ici shards (reference ``driver.py:1815-1863``):
community tables replicated only inside a group, the groups' ghosts on
the sparse protocol, every phase under ``exchange='twolevel'`` on the
bucketed engine, ET and checkpoints included; ``dcn == 1`` is the flat
mesh.  As in the reference the two-level exchange refuses coloring,
vertex ordering, per-rank ingest and the other engines.
``LouvainResult.exchange_stats`` digests the first mesh phase's plan,
``dist_stats=True`` prints the partition's edge distribution once, and
``diag_prefix`` writes one line per shard and phase to
``<prefix>.<shard>`` (``utils/trace.ShardDiag``, the reference
application's ``dat.out.<rank>``; rank 0 alone under a process group).
The batch-axis mesh of ``louvain_many`` is ``louvain/batched.py``'s.

Several processes, one rank per card (``comm/multihost.initialize``
first; reference ``driver.py:420-433,1788-1810``): the mesh is this
rank's view (``make_mesh(S)``), each rank sweeps its own shards, the
collectives go over the process group, and at each phase end the labels
come back to every rank (``multihost.gather_global``).  Planning,
coarsening and the f64 Q stay on the host and are replicated: every rank
computes the same ones, so every rank returns the same result.  A
``io/dist_ingest.DistVite`` graph (per-rank ingest) forces the sparse
exchange and the bucketed engine; its phase 0 runs on the ranks' own
slabs, its Q is reduced over them, its coloring is
``multi_hash_coloring_dist``, and the coarse graph is all-gathered onto
every rank for the phases after it.  Checkpoints of a process group:
rank 0 alone writes (``save_phase`` removes higher-numbered files, so
writers sharing a directory would race; the reference lets every
process of a full-ingest run write), and on resume every rank loads and
an all-gather of [phase, fingerprint] refuses, on every rank, a
directory the ranks do not see alike.  A DistVite's fingerprint is its
``content_fingerprint``, and its resume runs from the checkpoint's
coarse graph on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from cuvite_tpu_torch.coarsen.device import (
    device_coarsen_enabled,
    device_coarsen_slab,
    device_compose_labels,
    device_renumber,
    maybe_shrink_to_class,
)
from cuvite_tpu_torch.coarsen.rebin import (
    device_plan,
    device_rebin_enabled,
    rebin_eligible,
)
from cuvite_tpu_torch.coarsen.rebuild import coarsen_graph, \
    renumber_communities
from cuvite_tpu_torch.comm import multihost
from cuvite_tpu_torch.comm.collectives import psum
from cuvite_tpu_torch.comm.exchange import ExchangePlan
from cuvite_tpu_torch.comm.mesh import (
    hybrid_shape,
    make_hybrid_mesh,
    make_mesh,
    shard_1d,
)
from cuvite_tpu_torch.core.device import resolve_device
from cuvite_tpu_torch.core.distgraph import DistGraph
from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import (
    MAX_TOTAL_ITERATIONS,
    TERMINATION_PHASE_COUNT,
    next_pow2,
)
from cuvite_tpu_torch.louvain.bucketed import (
    BucketPlan,
    DevicePlan,
    MeshPlan,
    bucketed_modularity,
    bucketed_step,
    build_class_plans,
    build_mesh_class_plans,
    build_stacked_plans,
    merge_coverage,
    plans_coverage,
    sharded_bucketed_modularity,
    sharded_bucketed_step,
)
from cuvite_tpu_torch.kernels.seg_coalesce import coalesce_engine
from cuvite_tpu_torch.louvain.coloring import (
    multi_hash_coloring,
    multi_hash_coloring_dist,
)
from cuvite_tpu_torch.louvain.loop import BudgetOverflow, phase_loop
from cuvite_tpu_torch.louvain.precise import phase_modularity
from cuvite_tpu_torch.louvain.step import louvain_step_local, sharded_step
from cuvite_tpu_torch.ops.segment import TenantConstants
from cuvite_tpu_torch.utils.trace import (
    NullTracer,
    ShardDiag,
    dist_stats_report,
)
from cuvite_tpu_torch.utils.upload import finish_uploads, to_device

ENGINES = ("bucketed", "sort", "fused", "pallas")

# Edge count from which the fused engine runs one phase per call and
# coarsens the slab on the device before the next: phase p then costs
# O(E_p), not O(E_original).  Below it, relabel-only phases on the resident
# slab run to the end in one call (reference ``driver.py:1363``).
FUSED_SHRINK_EDGES = 1 << 20

# exchange='auto' picks the sparse exchange for a phase of at least this
# many padded vertices (reference ``driver.py:1364-1392``): a memory bound
# -- the replicated exchange holds O(nv_total) tables on every shard --
# not a measured speed crossover.
AUTO_SPARSE_MIN_VERTICES = 1 << 26


def exchange_cutover() -> int:
    """The exchange='auto' cutover: AUTO_SPARSE_MIN_VERTICES, or the
    positive integer in CUVITE_EXCHANGE_CUTOVER (0x/0b prefixes accepted;
    a malformed value warns and keeps the default).  Read per phase."""
    raw = os.environ.get("CUVITE_EXCHANGE_CUTOVER")
    if not raw:
        return AUTO_SPARSE_MIN_VERTICES
    try:
        v = int(raw, 0)
    except ValueError:
        v = -1
    if v <= 0:
        warnings.warn(
            f"malformed CUVITE_EXCHANGE_CUTOVER={raw!r} (want a positive "
            f"integer); using the default {AUTO_SPARSE_MIN_VERTICES}",
            stacklevel=2)
        return AUTO_SPARSE_MIN_VERTICES
    return v


def threshold_for_phase(short_phase: int) -> float:
    """Threshold-cycling schedule (main.cpp:225-237)."""
    sp = short_phase % 13
    if sp <= 2:
        return 1.0e-3
    if sp <= 6:
        return 1.0e-4
    if sp <= 9:
        return 1.0e-5
    return 1.0e-6


@dataclasses.dataclass
class PhaseStats:
    phase: int
    modularity: float
    iterations: int
    num_vertices: int
    num_edges: int
    seconds: float
    # Host seconds by stage: color (phase 0 of a color schedule), plan
    # (host bucket plan or slab, upload), iterate (the sweeps, each ending
    # in the host read of Q), evaluate (the reported Q), coarsen
    # (coarsening after the phase; not part of ``seconds``).
    stages: dict = dataclasses.field(default_factory=dict)
    # Coalesce engine of the device coarsening after this phase ('dense',
    # 'sort', 'msd' or 'hash'); None when the phase was not coarsened on
    # the device.
    coalesce: str | None = None


@dataclasses.dataclass
class LouvainResult:
    communities: np.ndarray   # [nv original] dense community label per vertex
    modularity: float
    phases: list
    total_iterations: int
    total_seconds: float
    # obs.convergence.PhaseConvergence per phase attempt in run order: the
    # bucketed and sort engines record non-gaining attempts too
    # (gained=False), the fused engine its gaining phases only.
    convergence: list = dataclasses.field(default_factory=list)
    # Phases (attempts included) whose bucket plan was built on the device.
    rebinned_phases: list = dataclasses.field(default_factory=list)
    # A mesh run's first phase: its exchange plan's stats(), or
    # {"mode": "replicated"}; None on one shard.
    exchange_stats: dict | None = None
    # Kernel coverage (module note): the share of the traversed edges
    # (edges x sweeps, summed over phases) whose class a hand kernel
    # swept, and the traversed edges of each kernelized class ({width:
    # edges}, width 0 the hubs); None on the sort and fused engines.
    pallas_coverage: float | None = None
    pallas_width_hits: dict | None = None

    @property
    def num_communities(self) -> int:
        return int(self.communities.max()) + 1 if len(self.communities) else 0


class PhaseRunner:
    """Runs the sweeps of one phase on one device.  ``engine='bucketed'``
    builds the phase's bucket plan on the host, uploads it and iterates
    ``bucketed_step``; ``engine='sort'`` keeps the edge slab on the
    device (``src``/``dst``/``w``) and iterates ``louvain_step_local``.

    ``classes`` = (class of each padded vertex, number of classes) puts
    the bucketed engine on the color schedule: one de-padded plan per
    class, each with its own hub layout and scratch, and no whole-phase
    plan.  ``ordering``: vertex ordering's frozen community tables.
    ``rebin``: build the bucketed plan on the device from the slab
    (``coarsen/rebin.device_plan``) instead of on the host, synchronized.
    ``tracer``/``stages``: the ``upload`` and ``rebin`` stages are timed
    into both, and the placed buffers go to the memory ledger."""

    def __init__(self, dg: DistGraph, device, engine: str = "bucketed",
                 classes=None, ordering: bool = False, rebin: bool = False,
                 tracer=None, stages: dict | None = None):
        tracer = tracer if tracer is not None else NullTracer()
        self.tracer = tracer
        self.dg = dg
        self.device = torch.device(device)
        nv = dg.nv_pad
        self.nv_total = nv
        self.src = self.dst = self.w = self.plan = self.class_plans = None
        self.ordering = ordering
        slab = None   # the re-binner's input slab, placed for the build
        if engine == "sort":
            with tracer.stage("upload", into=stages):
                self.src, self.dst, self.w = dg.device_slab(self.device)
        elif classes is not None:
            plans = build_class_plans(dg.src, dg.dst, dg.w, *classes,
                                      nv_local=nv)
            with tracer.stage("upload", into=stages):
                self.class_plans = [DevicePlan.upload(p, self.device)
                                    for p in plans]
        elif rebin:
            with tracer.stage("upload", into=stages):
                slab = dg.device_slab(self.device)
                with tracer.stage("host_read"):
                    finish_uploads(self.device)
            with tracer.stage("rebin", into=stages):
                self.plan = device_plan(*slab, nv_local=nv, tracer=tracer)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        else:
            plan = BucketPlan.build(dg.src, dg.dst, dg.w, nv_local=nv)
            with tracer.stage("upload", into=stages):
                self.plan = DevicePlan.upload(plan, self.device,
                                              tracer=tracer)
        with tracer.stage("upload", into=stages):
            with tracer.stage("host_read"):
                self.vdeg = torch.as_tensor(
                    dg.padded_weighted_degrees()).to(self.device,
                                                     torch.float32)
            self.comm0 = torch.arange(nv, dtype=torch.int32,
                                      device=self.device)
            with tracer.stage("host_read"):
                self.real_mask = torch.from_numpy(dg.vertex_mask()).to(
                    self.device)
            self.constant = TenantConstants.of(
                1.0 / dg.graph.total_edge_weight_twice(), self.device)
            # The stage ends with every copy above done.
            with tracer.stage("host_read"):
                finish_uploads(self.device)
        self.labels_dev = None    # device labels of the last run()
        self.convergence = None   # PhaseConvergence of the last run()
        tracer.ledger_phase_begin()
        tracer.track("slab", self.src, self.dst, self.w, slab)
        tracer.track("tables", self.vdeg, self.comm0, self.real_mask,
                     self.constant)
        tracer.track("plans", self.plan, self.class_plans)

    def coverage(self) -> list | None:
        """(width, edges, kernelized) of the classes a sweep of this phase
        traverses (``DevicePlan.coverage``); None on the sort engine,
        whose sweep runs no hand kernel."""
        plans = self.class_plans or ([self.plan] if self.plan is not None
                                     else [])
        return plans_coverage(plans) if plans else None

    def step(self, comm: torch.Tensor):
        if self.plan is None:
            return louvain_step_local(self.src, self.dst, self.w, comm,
                                      self.vdeg, self.constant)
        return bucketed_step(self.plan, comm, self.vdeg, self.constant,
                             nv_total=self.nv_total)

    def class_sweep(self, comm: torch.Tensor, active=None) -> tuple:
        """One iteration of the color schedule: the classes in order, each
        committing its moves before the next decides (louvain.cpp:862-901).
        Coloring takes the community tables from the committed state,
        vertex ordering from the iteration's start (louvain.cpp:1535-1562).
        Q is the start's, over the class plans together.  Returns (target,
        Q)."""
        mod = bucketed_modularity(self.class_plans, comm, self.vdeg,
                                  self.constant, nv_total=self.nv_total)[0]
        info = comm if self.ordering else None
        work = comm
        for plan in self.class_plans:
            tgt = bucketed_step(plan, work, self.vdeg, self.constant,
                                nv_total=self.nv_total, info_comm=info).target
            work = tgt if active is None else torch.where(active, tgt, work)
        return work, mod

    def run(self, threshold: float, et_mode: int = 0,
            et_delta: float = 0.25):
        """One phase from the identity assignment (``loop.phase_loop``).
        Returns (labels in padded space as numpy, last in-loop Q,
        iterations); the phase's rows are left in ``convergence``."""
        if self.class_plans is not None:
            sweep = self.class_sweep
        else:
            def sweep(comm, _active):
                res = self.step(comm)
                return res.target, res.modularity[0]
        past, prev_mod, iters, self.convergence = phase_loop(
            sweep, self.comm0, threshold, et_mode=et_mode,
            et_delta=et_delta, real_mask=self.real_mask,
            host_et=self.class_plans is not None, tracer=self.tracer)
        self.labels_dev = past
        with self.tracer.stage("host_read"):
            labels = past.cpu().numpy()  # graftlint: disable=R010 — THE per-phase label sync chokepoint
        return labels, prev_mod, iters


class MeshPhaseRunner:
    """Runs the sweeps of one phase on the shards of a mesh (the
    reference ``PhaseRunner``'s mesh branches, ``driver.py:488-800,
    1036-1067``).  ``engine='bucketed'`` builds the per-shard plans on the
    host (``build_stacked_plans``; under ``exchange='sparse'`` over the
    phase's ``ExchangePlan``) and places each shard's on its device;
    ``engine='sort'`` places each shard's slab (replicated exchange).
    ``exchange='twolevel'`` (a hybrid mesh, bucketed engine, plain
    schedule) plans over ``ExchangePlan.build_grouped``.  ``budget``: the
    sparse exchange's per-peer budget, default max(128, nv // 4), at most
    nv, nv the plan's window: a shard's nv_pad, or a group's under the
    two-level exchange.

    ``classes`` = (class of each padded vertex [total padded vertices],
    number of classes) puts the bucketed engine on the color schedule:
    one mesh plan per class (``build_mesh_class_plans``), all over the
    phase's one routing under the sparse exchange, and no whole-phase
    plan (the reference's distributed -c/-d, ``driver.py:739-795``).
    ``ordering``: vertex ordering's frozen community tables."""

    def __init__(self, dg: DistGraph, mesh, engine: str = "bucketed",
                 exchange: str = "replicated", budget: int | None = None,
                 classes=None, ordering: bool = False,
                 tracer=None, stages: dict | None = None,
                 verbose: bool = False):
        tracer = tracer if tracer is not None else NullTracer()
        if exchange == "twolevel":
            if hybrid_shape(mesh)[0] < 2:
                raise ValueError(
                    "exchange='twolevel' needs a 2-D hybrid mesh "
                    "(comm.mesh.make_hybrid_mesh)")
            if engine not in ("bucketed", "pallas"):
                raise ValueError(
                    "exchange='twolevel' runs on the bucketed/pallas "
                    "engines only")
            if classes is not None:
                raise ValueError(
                    "exchange='twolevel' does not support the coloring/"
                    "ordering schedules yet (use exchange='sparse')")
        self.dg, self.mesh = dg, mesh
        self.exchange = exchange
        self.verbose = verbose
        self.ordering = ordering
        nv = dg.nv_pad
        self.budget = None
        self.xplan_stats = None
        self.ghost_counts = None
        self.slabs = self.plan = self.class_plans = None
        with tracer.stage("upload", into=stages):
            self.vdeg = shard_1d(
                mesh, dg.padded_weighted_degrees().astype(np.float32))
            self.comm0 = shard_1d(mesh, np.arange(mesh.size * nv,
                                                  dtype=np.int32))
            self.real_mask = shard_1d(mesh, dg.vertex_mask())
        self.constant = 1.0 / dg.graph.total_edge_weight_twice()
        if engine == "sort":
            with tracer.stage("upload", into=stages):
                self.slabs = [tuple(to_device(a, dt, d)
                                    for a, dt in ((sh.src, torch.int32),
                                                  (sh.dst, torch.int32),
                                                  (sh.w, torch.float32)))
                              for sh, d in zip(
                                  (dg.shards[s] for s in mesh.shard_ids),
                                  mesh.devices)]
        else:
            xplan = None
            if exchange in ("sparse", "twolevel"):
                # A rank finds its own shards' ghosts and gathers the rest.
                held = () if mesh.group is None else (mesh.shard_ids,)
                xplan = (ExchangePlan.build(dg, *held) if exchange == "sparse"
                         else ExchangePlan.build_grouped(
                             dg, hybrid_shape(mesh)[0], *held))
                self.xplan_stats = xplan.stats()
                self.ghost_counts = self.xplan_stats["ghosts_per_shard"]
                self.budget_cap = xplan.nv_pad
                self.budget = min(int(max(128, xplan.nv_pad // 4)
                                      if budget is None else budget),
                                  xplan.nv_pad)
            if classes is None:
                plans = build_stacked_plans(dg, exchange_plan=xplan,
                                            shard_ids=mesh.shard_ids)
                with tracer.stage("upload", into=stages):
                    self.plan = MeshPlan.upload(
                        plans, mesh, nv, self.vdeg, exchange=exchange,
                        xplan=xplan, budget=self.budget or 0)
            else:
                by_class = build_mesh_class_plans(
                    dg, *classes, exchange_plan=xplan,
                    shard_ids=mesh.shard_ids)
                with tracer.stage("upload", into=stages):
                    self.class_plans = []
                    for plans in by_class:
                        self.class_plans.append(MeshPlan.upload(
                            plans, mesh, nv, self.vdeg, exchange=exchange,
                            xplan=xplan, budget=self.budget or 0,
                            shared=(self.class_plans[0] if self.class_plans
                                    else None)))
        with tracer.stage("upload", into=stages):
            for d in set(mesh.devices):
                finish_uploads(d)
        self.labels_dev = None    # per-shard labels of the last run()
        self.convergence = None
        tracer.ledger_phase_begin()
        tracer.track("slab", self.slabs)
        tracer.track("tables", self.vdeg, self.comm0, self.real_mask)
        tracer.track("plans", self.plan, self.class_plans)

    def coverage(self) -> list | None:
        """(width, edges, kernelized) of the classes a sweep traverses on
        every shard of the mesh, this rank's and the others' (one host
        all-gather under a process group); None on the sort engine."""
        if self.slabs is not None:
            return None
        cov = plans_coverage([p for mp in self.class_plans or [self.plan]
                              for p in mp.plans])
        if not multihost.is_distributed():
            return cov
        flat = np.asarray(cov, dtype=np.int64).reshape(-1)
        return merge_coverage(
            e for part in multihost.allgather_varlen(flat)
            for e in part.reshape(-1, 3).tolist())

    def step(self, comms: list):
        if self.plan is None:
            return sharded_step(self.mesh, *zip(*self.slabs), comms,
                                self.vdeg, self.constant)
        return sharded_bucketed_step(self.plan, comms, self.vdeg,
                                     self.constant)

    def class_sweep(self, comms: list, actives=None) -> tuple:
        """One iteration of the color schedule on the mesh (reference
        ``driver.py:1256-1279``): Q of the start over the class plans,
        then the classes in order, each committing its moves before the
        next decides, against the committed state (coloring) or the
        start's community tables (vertex ordering).  A shard with no row
        in a class still takes part in the class step's collectives.
        Returns (targets, Q, moves over every shard, the budget overflow
        of any step), one host read's worth of 0-dim tensors."""
        mod, overflow = sharded_bucketed_modularity(
            self.class_plans, comms, self.vdeg, self.constant)
        info = comms if self.ordering else None
        work = comms
        for mp in self.class_plans:
            res = sharded_bucketed_step(mp, work, self.vdeg, self.constant,
                                        info_comms=info)
            tgt = res.targets
            if actives is not None:
                tgt = [torch.where(a, t, w)
                       for a, t, w in zip(actives, tgt, work)]
            work = tgt
            overflow = overflow | res.overflow
        moved = psum([(w != c).sum() for w, c in zip(work, comms)],
                     self.mesh)[0]
        return work, mod, moved, overflow

    def run(self, threshold: float, et_mode: int = 0,
            et_delta: float = 0.25) -> tuple:
        """One phase from the identity assignment (``loop.phase_loop`` on
        the shards' lists, early termination included); a sparse sweep
        that overflows its budget re-runs the phase with the budget grown
        to min(nv, max(4 * budget, 512)), nv the plan's window (a group's
        under the two-level exchange), where the owner route cannot
        overflow.  Returns (padded-space labels of every shard as numpy,
        on every rank of a process group: the reference's ``_phase_sync``;
        Q; sweeps)."""
        if self.class_plans is not None:
            sweep = self.class_sweep
        else:
            def sweep(comms, _active):
                res = self.step(comms)
                return res.targets, res.modularity, res.n_moved, res.overflow

        while True:
            try:
                past, q, iters, self.convergence = phase_loop(
                    sweep, self.comm0, threshold, et_mode=et_mode,
                    et_delta=et_delta, real_mask=self.real_mask,
                    host_et=self.class_plans is not None, mesh=self.mesh)
            except BudgetOverflow:
                self.budget = min(self.budget_cap,
                                  max(4 * self.budget, 512))
                for mp in self.class_plans or [self.plan]:
                    mp.budget = self.budget
                if self.verbose:
                    print("sparse-exchange budget overflow; retrying the "
                          f"phase with budget {self.budget}")
                continue
            break
        self.labels_dev = past
        return multihost.gather_global(past), q, iters


def warm_start_phase(sweep, comm0: torch.Tensor, threshold: float,
                     active0: torch.Tensor, *,
                     real_mask: torch.Tensor) -> tuple:
    """One ET mode-1 phase from the caller's labels ``comm0`` and active
    set ``active0`` instead of the identity and every real vertex: the
    streaming warm start (reference ``driver.py:400``, the semantics of
    its ``_run_phase_loop_et``).  ``sweep`` as ``loop.phase_loop`` takes
    it (``louvain/fused.fused_sweep``).  Targets are masked by the active
    set from the first sweep, and vertices freeze from the third; a warm
    assignment whose first sweep gains less than ``threshold`` comes back
    unchanged, so a re-cluster after a no-op delta keeps its labels bit
    for bit.  Returns (labels, Q, sweeps, PhaseConvergence)."""
    return phase_loop(sweep, comm0, threshold, et_mode=1,
                      real_mask=real_mask, active0=active0)


def _runner_slab(runner):
    """The resident (src, dst, w) of a single-device sort-engine runner,
    else None: the bucketed engine keeps no slab on the device, none is
    uploaded just for the phase-end Q (reference ``driver.py:187-194``),
    and a mesh's phase-end Q is the host oracle's, as in the reference."""
    if getattr(runner, "src", None) is None:
        return None
    return runner.src, runner.dst, runner.w


def _phase_q(dg, comm_pad: np.ndarray, runner) -> float:
    """The phase's reported f64 Q: a per-rank partition's own reduction
    over its slabs (``DistVite.modularity``), else ``phase_modularity``."""
    if getattr(dg, "local_only", False):
        return dg.modularity(comm_pad)
    return phase_modularity(dg, comm_pad, _runner_slab(runner))


def _coarse_from_partition(dg, dense: np.ndarray, nc: int) -> Graph:
    """The next phase's graph from a per-rank partition: each rank's
    coarse edges, all-gathered and rebuilt alike on every rank (the
    reference's send_newEdges counterpart, ``driver.py:2325-2335``).
    ``dense``: the dense community of each original vertex."""
    dense_pad = np.zeros(dg.total_padded_vertices, dtype=np.int64)
    dense_pad[dg.old_to_pad] = dense
    cs, cd, cw = dg.coarse_edges(dense_pad, nc)
    return Graph.from_edges(nc, cs, cd, weights=cw, symmetrize=False,
                            policy=dg.graph.policy)


def _device_transition(runner: PhaseRunner, nc: int, tracer,
                       stages: dict):
    """Coarsen the runner's resident slab on the device into the next
    phase's ``DistGraph`` (reference ``driver.py:2310-2368``), the
    relabel and coalesce timed as stage ``coalesce``.  Returns (next dg,
    coalesce engine)."""
    dg = runner.dg
    eng = coalesce_engine(dg.nv_pad)
    with tracer.stage("coalesce", into=stages):
        src2, dst2, w2, _dmap, _nc, ne2 = device_coarsen_slab(
            runner.src, runner.dst, runner.w, runner.labels_dev,
            runner.real_mask, nv_pad=dg.nv_pad, coalesce=eng)
    tracer.count("coalesce_edges", dg.graph.num_edges)
    if eng != "sort":
        tracer.count("coalesce_dense_edges", dg.graph.num_edges)
    src2, dst2, w2, nv_pad2 = maybe_shrink_to_class(
        src2, dst2, w2, nc=nc, ne2=ne2, nv_pad=dg.nv_pad)
    nxt = DistGraph.from_device_slab(
        src2, dst2, w2, num_vertices=nc, num_edges=ne2, nv_pad=nv_pad2,
        policy=dg.graph.policy,
        total_weight_twice=dg.graph.total_edge_weight_twice())
    return nxt, eng


def _color_classes(g: Graph, dg: DistGraph, n: int, device,
                   verbose: bool) -> tuple:
    """Phase 0's color classes (reference ``driver.py:2107-2146``): colors
    from max(n // 2, 1) hash functions, compressed to dense class ids in
    color order; uncolored vertices, and padding, form the last class (the
    reference application passes numColors + 1 classes, main.cpp:259).  A
    per-rank partition (``io/dist_ingest.DistVite``) is colored by
    ``multi_hash_coloring_dist``, with the same colors.  Returns (class of
    each padded vertex [total padded vertices] int32, class count)."""
    if getattr(g, "local_only", False):
        colors, n_colors = multi_hash_coloring_dist(
            g, n_hash=max(n // 2, 1), device=device)
    else:
        colors, n_colors = multi_hash_coloring(
            g.sources().astype(np.int32), g.tails.astype(np.int32),
            g.num_vertices, n_hash=max(n // 2, 1), device=device)
    if verbose:
        print(f"Number of colors (2*nHash rounds): {n_colors}, "
              f"colored {int((colors >= 0).sum())}/{g.num_vertices}")
    used = np.unique(colors[colors >= 0])
    remap = np.zeros(int(used.max()) + 1 if len(used) else 1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    dense = np.where(colors >= 0, remap[np.maximum(colors, 0)], len(used))
    n_classes = len(used) + 1
    cls = np.full(dg.total_padded_vertices, n_classes - 1, dtype=np.int32)
    cls[dg.old_to_pad] = dense
    return cls, n_classes


def _source_fingerprint(graph) -> int:
    """The checkpoint fingerprint of the original input (reference
    ``driver.py:175-184``): a per-rank partition's
    ``DistVite.content_fingerprint`` (collective), else
    ``utils.checkpoint.graph_fingerprint``."""
    if getattr(graph, "local_only", False):
        return graph.content_fingerprint()
    from cuvite_tpu_torch.utils.checkpoint import graph_fingerprint

    return graph_fingerprint(graph)


def _agree_on_checkpoint(ck, checkpoint_dir: str) -> None:
    """Under a process group every rank loads the checkpoint itself; one
    all-gather of each rank's [phase, fingerprint] refuses, on every rank
    alike, a directory the ranks do not all see the same (reference
    ``driver.py:1967-1988``), instead of leaving ranks in different
    phases to wait on each other's collectives."""
    if not multihost.is_distributed():
        return
    mine = np.asarray([ck.phase, ck.fingerprint] if ck is not None
                      else [-1, -1], dtype=np.int64)
    seen = np.stack(multihost.allgather_varlen(mine))
    if len(np.unique(seen, axis=0)) > 1:
        raise ValueError(
            f"ranks loaded different checkpoint states {seen.tolist()} "
            f"from {checkpoint_dir!r}: the checkpoint directory must be "
            "shared storage visible to every rank")


def louvain_many(
    graphs,
    threshold: float = 1.0e-6,
    max_phases: int = TERMINATION_PHASE_COUNT,
    b_pad: int | None = None,
    slab_class: tuple | None = None,
    mesh="auto",
    verbose: bool = False,
    engine: str = "fused",
    bucket_shape=None,
    device=None,
    tracer=None,
):
    """Cluster B same-slab-class graphs as one batch (reference
    ``louvain_many``, ``cuvite_tpu/louvain/driver.py:1689``): the
    multi-tenant analog of :func:`louvain_phases`.

    Returns a ``louvain.batched.BatchResult`` whose ``results`` hold one
    :class:`LouvainResult` per input graph, in order, each equal to this
    entry's run of that graph alone (B=1, same engine).  ``engine``:
    ``'fused'`` (sort sweeps every phase) or ``'bucketed'`` (bucket plans
    built on the device where eligible; else phase 0's on the host and
    the coarse phases fused); ``bucket_shape`` pins the phase-0 plan
    geometry (``core.batch.bucket_shape_for``) and refuses a batch that
    does not fit it.  ``device=None`` runs on the card and raises when
    there is none.  Mixed slab classes raise: binning is the serving
    layer's job.  ``tracer``: the batched engine's stages, counters and
    memory ledger.
    """
    from cuvite_tpu_torch.louvain.batched import cluster_many

    return cluster_many(graphs, threshold=threshold, max_phases=max_phases,
                        b_pad=b_pad, slab_class=slab_class, mesh=mesh,
                        verbose=verbose, engine=engine,
                        bucket_shape=bucket_shape, device=device,
                        tracer=tracer)


def louvain_phases(
    graph: Graph,
    threshold: float = 1.0e-6,
    threshold_cycling: bool = False,
    one_phase: bool = False,
    max_phases: int = TERMINATION_PHASE_COUNT,
    verbose: bool = False,
    device=None,
    engine: str = "auto",
    et_mode: int = 0,
    et_delta: float = 0.25,
    coloring: int = 0,
    vertex_ordering: int = 0,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    tracer=None,
    nshards: int = 1,
    mesh=None,
    balanced: bool = False,
    exchange: str = "auto",
    exchange_budget: int | None = None,
    dist_stats: bool = False,
    mesh_shape=None,
    diag_prefix: str | None = None,
) -> LouvainResult:
    """Full multi-phase Louvain (the main.cpp:218-495 loop) on one device
    or a vertex mesh.

    ``device=None`` runs on the card and raises when there is none;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.
    ``nshards=S`` / ``mesh=`` (``comm.mesh.make_mesh``): S vertex shards.
    Without ``mesh`` the shards are the first S visible cards
    (``make_mesh(S)``, which raises with fewer), or all on ``device`` when
    one is given, one process driving all of them; under an initialized
    process group (``comm.multihost.initialize``) this rank's S / world
    shards on its own card.  ``graph`` may be a per-rank
    ``io.dist_ingest.DistVite`` (module note).  ``balanced``: edge-balanced
    vertex ranges (``-b``).  ``exchange``: 'auto', 'replicated' or
    'sparse' (module note); ``exchange_budget``: the sparse exchange's
    first per-peer budget ('auto' then means sparse).  ``mesh_shape``:
    ``(dcn, ici)`` or ``"DxI"``, a hybrid mesh under the two-level
    exchange (module note; ``exchange`` 'auto' and 'sparse' then mean
    'twolevel', 'replicated' raises).  ``dist_stats``: print the first
    phase's edge distribution.  ``diag_prefix``: per-shard diagnostic
    files ``<prefix>.<shard>``.
    ``engine``: ``'auto'`` (= ``'bucketed'``), ``'bucketed'``, ``'sort'``
    or ``'fused'``.  ``et_mode`` 1-4 and ``et_delta``: early termination
    (reference ``-t``, ``-a``).  ``coloring=N`` / ``vertex_ordering=N``
    (``-c N`` / ``-d N``): phase 0 on the color schedule.
    ``checkpoint_dir``: save the state after every gaining phase;
    ``resume``: continue from the latest checkpoint there, refusing one
    written for another graph.  ``tracer``: the stages, counters, events
    and memory ledger of the module note."""
    if mesh is not None:
        if nshards not in (1, mesh.size):
            raise ValueError(f"nshards={nshards} conflicts with a mesh of "
                             f"{mesh.size} shards")
        nshards = mesh.size
    if exchange not in ("auto", "replicated", "sparse", "twolevel"):
        raise ValueError(f"unknown exchange {exchange!r}: use 'auto', "
                         "'replicated', 'sparse' or 'twolevel'")
    dist_ingest = getattr(graph, "local_only", False)
    if dist_ingest:
        # Per-rank ingest (io/dist_ingest.DistVite): phase 0 runs on the
        # partition's own slabs, later phases on the all-gathered coarse
        # graph (reference driver.py:1788-1810).
        if nshards == 1:
            nshards = graph.nshards
        if nshards != graph.nshards or nshards < 2:
            raise ValueError(
                f"nshards={nshards} does not match the DistVite partition "
                f"({graph.nshards} shards; per-rank ingest needs >= 2)")
        if engine not in ("auto", "bucketed", "pallas"):
            raise ValueError(
                "per-rank ingest supports only the bucketed engine")
        if exchange == "auto":
            exchange = "sparse"     # host memory is the constraint here
        if exchange != "sparse":
            raise ValueError("per-rank ingest requires exchange='sparse': "
                             "the replicated exchange needs every shard's "
                             "host arrays")
    if exchange == "auto" and exchange_budget is not None:
        exchange = "sparse"
    # The hybrid mesh of the two-level exchange (reference
    # driver.py:1815-1863).
    n_dcn = 1
    if mesh_shape is not None:
        if isinstance(mesh_shape, str):
            d_s, _, i_s = mesh_shape.lower().replace(
                "\u00d7", "x").partition("x")
            mesh_shape = (int(d_s), int(i_s))
        n_dcn, n_ici = int(mesh_shape[0]), int(mesh_shape[1])
        if n_dcn < 1 or n_ici < 1:
            raise ValueError(f"mesh_shape factors must be >= 1, "
                             f"got {n_dcn}x{n_ici}")
        if nshards not in (1, n_dcn * n_ici):
            raise ValueError(
                f"nshards={nshards} conflicts with mesh_shape "
                f"{n_dcn}x{n_ici} ({n_dcn * n_ici} devices)")
        nshards = n_dcn * n_ici
        if n_dcn > 1:
            if dist_ingest:
                raise ValueError("the two-level exchange does not support "
                                 "per-host ingest yet")
            if coloring or vertex_ordering:
                raise ValueError(
                    "the two-level exchange does not support coloring/"
                    "vertex-ordering yet (use a flat mesh)")
            if engine not in ("auto", "bucketed", "pallas"):
                raise ValueError("the two-level exchange runs on the "
                                 "bucketed/pallas engines only")
    elif mesh is not None:
        n_dcn = hybrid_shape(mesh)[0]
    if exchange == "twolevel" and n_dcn <= 1:
        raise ValueError("exchange='twolevel' requires a hybrid mesh with "
                         "|dcn| > 1 (pass mesh_shape=(dcn, ici)): the "
                         "two-level exchange has no flat form")
    if n_dcn > 1:
        if exchange == "replicated":
            raise ValueError("a hybrid mesh runs the two-level exchange; "
                             "exchange='replicated' needs a flat mesh")
        # 'auto' and 'sparse' on a hybrid mesh: the grouped plan is the
        # sparse protocol at group scale.
        exchange = "twolevel"
    if nshards > 1:
        if engine == "fused":
            warnings.warn(
                "engine='fused' covers only the plain single-shard "
                "schedule; running the 'bucketed' engine on the mesh "
                "instead", stacklevel=2)
            engine = "bucketed"
        if engine == "sort" and exchange == "sparse":
            warnings.warn(
                "exchange='sparse' is implemented on the bucketed engine "
                "only; the sort engine runs the replicated exchange "
                "(O(nv_total) per-shard state)", stacklevel=2)
    if engine == "auto":
        engine = "bucketed"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: use 'auto', "
                         "'bucketed', 'pallas', 'sort' or 'fused'")
    # The reference's kernel engine is the bucketed one here (module note).
    pallas = engine == "pallas"
    if pallas:
        engine = "bucketed"
    if et_mode not in (0, 1, 2, 3, 4):
        raise ValueError(f"et_mode must be 0-4, got {et_mode!r}")
    if engine == "fused" and (et_mode or coloring or vertex_ordering
                              or checkpoint_dir is not None):
        # The reference's fused program covers the plain schedule only
        # (driver.py:1868-1880); say so, or a timing of the fused engine
        # on these configurations would be misattributed.
        warnings.warn(
            "engine='fused' covers only the plain single-shard schedule; "
            "running the 'bucketed' engine for this configuration instead",
            stacklevel=2)
        engine = "bucketed"
    if engine == "sort" and (coloring or vertex_ordering):
        warnings.warn(
            "engine='sort' has no class-restricted plans for coloring/"
            "vertex-ordering; auto-switching to the class-capable "
            "'bucketed' engine", stacklevel=2)
        engine = "bucketed"
    if multihost.is_distributed() and mesh is None:
        # One rank per card: this rank's shards of the mesh, on its device.
        here = multihost.local_device()
        if device is not None and torch.device(device).type != here.type:
            raise ValueError(f"device={device!r} conflicts with this rank's "
                             f"device {here} (multihost.initialize)")
        if nshards == 1 and multihost.world_size() > 1:
            raise ValueError(
                f"a world of {multihost.world_size()} ranks needs nshards "
                "a multiple of the world size, not 1")
        if nshards == 1:
            device = here
    if nshards > 1 and mesh is None:
        devs = (None if multihost.is_distributed() or device is None
                else [torch.device(device)] * nshards)
        mesh = (make_hybrid_mesh(n_dcn, nshards // n_dcn, devices=devs)
                if n_dcn > 1 else make_mesh(nshards, devices=devs))
    if dist_ingest and (mesh.shard_ids.start, mesh.shard_ids.stop) != (
            graph.local_lo, graph.local_hi):
        raise ValueError(
            f"the mesh holds shards {list(mesh.shard_ids)} but this "
            f"DistVite read [{graph.local_lo}, {graph.local_hi})")
    dev = mesh.devices[0] if nshards > 1 else resolve_device(device)
    tracer = tracer if tracer is not None else NullTracer()
    nv0 = graph.num_vertices
    comm_all = np.arange(nv0, dtype=np.int64)
    if graph.num_edges == 0:
        return LouvainResult(communities=comm_all, modularity=0.0,
                             phases=[], total_iterations=0,
                             total_seconds=0.0)
    if engine == "fused":
        return _run_fused(graph, threshold=threshold,
                          threshold_cycling=threshold_cycling,
                          one_phase=one_phase, max_phases=max_phases,
                          verbose=verbose, device=dev, tracer=tracer)
    if checkpoint_dir and one_phase:
        raise ValueError(
            "checkpoint_dir is incompatible with one_phase: the run ends "
            "after its single phase, so there is no state to resume (use "
            "max_phases=1 to bound a checkpointed run instead)")
    # Read once per run: a sort-engine run that coarsened on the device
    # has no host graph to coarsen later, nor to checkpoint.
    dev_coarsen = (engine == "sort" and not checkpoint_dir
                   and nshards == 1 and device_coarsen_enabled())
    budget = exchange_budget     # sticky across phases, grown on overflow
    exchange_stats = None
    phases: list[PhaseStats] = []
    convergence: list = []
    rebinned: list = []
    # Kernel coverage over the traversed edges (reference
    # driver.py:1935-1945,2207-2240).
    cov_num = cov_den = cov_pending = 0
    width_hits: dict = {}
    prev_mod = -1.0
    tot_iters = 0
    t_start = time.perf_counter()
    phase = 0
    g = graph
    pending = None   # next phase's device-resident DistGraph
    cycling = threshold_cycling and not one_phase
    ck_fp = None     # the original graph's fingerprint, computed once
    # One writer under a process group, as for checkpoints.
    diag = (ShardDiag(diag_prefix, nshards)
            if diag_prefix and multihost.rank() == 0 else None)
    if resume and checkpoint_dir:
        from cuvite_tpu_torch.utils.checkpoint import load_latest

        ck = load_latest(checkpoint_dir)
        _agree_on_checkpoint(ck, checkpoint_dir)
        if ck is not None and ck.fingerprint != -1:
            ck_fp = _source_fingerprint(graph)
            if ck.fingerprint != ck_fp:
                raise ValueError(
                    f"checkpoint in {checkpoint_dir!r} was written for a "
                    "different graph (content fingerprint mismatch; for a "
                    "per-rank partition it also covers nshards and "
                    "balanced); use a fresh checkpoint_dir or drop resume")
        if ck is not None and len(ck.comm_all) == nv0 \
                and ck.orig_ne == graph.num_edges:
            g = ck.graph
            comm_all = ck.comm_all
            prev_mod = ck.prev_mod
            phase = ck.phase
            tot_iters = ck.tot_iters
            phases = [
                PhaseStats(phase=p, modularity=float(ck.mod_hist[p]),
                           iterations=int(ck.iter_hist[p]),
                           num_vertices=int(ck.nv_hist[p]),
                           num_edges=int(ck.ne_hist[p]), seconds=0.0)
                for p in range(ck.phase)]
            if verbose:
                print(f"Resumed from {checkpoint_dir} at phase {phase} "
                      f"(Q={prev_mod:.6f})")
    while phase < max_phases and tot_iters <= MAX_TOTAL_ITERATIONS:
        th = threshold_for_phase(phase) if cycling else threshold
        t1 = time.perf_counter()
        g_nv, g_ne = g.num_vertices, g.num_edges
        tracer.set_phase(phase)
        phase_sid = tracer.begin_span("phase", index=phase, nv=g_nv,
                                      ne=g_ne, threshold=float(th))
        stages = {}
        with tracer.stage("plan", into=stages):
            if pending is not None:
                dg = pending
            elif getattr(g, "local_only", False):
                dg = g              # the per-rank partition itself
            elif nshards > 1:
                # A rank of a process group builds its own shards' slabs.
                dg = DistGraph.build(
                    g, nshards, balanced=balanced,
                    shard_ids=None if mesh.group is None
                    else mesh.shard_ids)
            else:
                dg = DistGraph.build(g)
        pending = None
        classes = None
        if (coloring or vertex_ordering) and phase == 0:
            with tracer.stage("color", into=stages):
                classes = _color_classes(g, dg, coloring or vertex_ordering,
                                         dev, verbose)
        # The reference re-bins on its floored class (nv_pad >= 4096,
        # ne_pad >= 16384, driver.py:2062-2066 and :812-823).
        rebin = (engine == "bucketed" and phase >= 1 and classes is None
                 and nshards == 1 and device_rebin_enabled()
                 and rebin_eligible(max(dg.nv_pad, 4096),
                                    max(next_pow2(g_ne), 16384)))
        if engine == "bucketed" and phase >= 1 and classes is None \
                and nshards == 1:
            tracer.count("rebin_phases", 1)
            if rebin:
                tracer.count("rebin_device_phases", 1)
        with tracer.stage("plan", into=stages):
            if nshards > 1:
                phase_exchange = exchange
                if exchange == "auto":
                    phase_exchange = (
                        "sparse" if dg.total_padded_vertices
                        >= exchange_cutover() else "replicated")
                if engine == "sort" and exchange != "twolevel":
                    phase_exchange = "replicated"
                runner = MeshPhaseRunner(
                    dg, mesh, engine, phase_exchange, budget=budget,
                    classes=classes,
                    ordering=bool(vertex_ordering and not coloring),
                    tracer=tracer, stages=stages, verbose=verbose)
            else:
                runner = PhaseRunner(
                    dg, dev, engine, classes=classes,
                    ordering=bool(vertex_ordering and not coloring),
                    rebin=rebin, tracer=tracer, stages=stages)
        if rebin:
            rebinned.append(phase)
        with tracer.stage("iterate", into=stages):
            comm_pad, _, iters = runner.run(th, et_mode=et_mode,
                                            et_delta=et_delta)
        if nshards > 1:
            budget = runner.budget or budget
            tracer.event("exchange", mode=runner.exchange,
                         nshards=dg.nshards, budget=runner.budget,
                         plan=runner.xplan_stats)
            if exchange_stats is None:
                exchange_stats = dict(runner.xplan_stats
                                      or {"mode": runner.exchange})
        with tracer.stage("evaluate", into=stages):
            curr_mod = _phase_q(dg, comm_pad, runner)
        if diag is not None:
            _diag_phase(diag, dg, runner, phase, iters, curr_mod,
                        time.perf_counter() - t1)
        tot_iters += iters
        tracer.count("traversed_edges", g_ne * iters)
        cov = runner.coverage()
        if cov is not None:
            if not pallas and cov_den == 0:
                # Phases before the first that swept a kernel count as
                # unkernelized mass (reference driver.py:2208-2215).
                cov_den += cov_pending
            for w, n, k in cov:
                cov_den += n * iters
                if k:
                    cov_num += n * iters
                    width_hits[w] = width_hits.get(w, 0) + n * iters
            _report_coverage(cov, pallas, verbose)
        elif pallas or cov_den:
            cov_den += g_ne * iters
        else:
            cov_pending += g_ne * iters
        tracer.ledger_snapshot(phase)
        if dist_stats:
            print(dist_stats_report(dg, runner.ghost_counts
                                    if nshards > 1 else None))
            dist_stats = False   # the first phase only
        gained = (curr_mod - prev_mod) > th
        conv = runner.convergence
        conv.phase, conv.gained = phase, gained
        convergence.append(conv)
        if tracer.emitter is not None:   # to_dict builds a dict a row
            tracer.event("convergence", **conv.to_dict())
        if gained:
            with tracer.stage("renumber"):
                comm_old = comm_pad[dg.old_to_pad]
                dense, nc = renumber_communities(comm_old)
                comm_all = dense[comm_all]
            t2 = time.perf_counter()
            phases.append(PhaseStats(
                phase=phase, modularity=curr_mod, iterations=iters,
                num_vertices=g_nv, num_edges=g_ne,
                seconds=t2 - t1, stages=stages))
            if verbose:
                print(f"Level {phase}, Modularity: {curr_mod:.6f}, "
                      f"Iterations: {iters}, nv: {g_nv}, "
                      f"time: {t2 - t1:.3f}s")
            prev_mod = curr_mod
            if one_phase:
                tracer.end_span(phase_sid, gained=True)
                break
            with tracer.stage("coarsen", into=stages):
                if dev_coarsen:
                    pending, phases[-1].coalesce = _device_transition(
                        runner, nc, tracer, stages)
                    g = pending.graph   # SlabMeta: scalar facts only
                    runner = None
                elif getattr(dg, "local_only", False):
                    runner = None
                    g = _coarse_from_partition(dg, dense, nc)
                else:
                    runner = None   # free the phase's device plan first
                    g = coarsen_graph(g, dense, nc)
            tracer.event("coarsen", nv_from=g_nv, ne_from=g_ne, nv_to=nc,
                         device=dev_coarsen)
            phase += 1
            if checkpoint_dir:
                from cuvite_tpu_torch.utils.checkpoint import (
                    PhaseCheckpoint,
                    save_phase,
                )

                if ck_fp is None:
                    ck_fp = _source_fingerprint(graph)
            # One writer: save_phase removes higher-numbered files, so
            # ranks writing one shared directory would race.
            if checkpoint_dir and multihost.rank() == 0:
                save_phase(checkpoint_dir, PhaseCheckpoint(
                    phase=phase, comm_all=comm_all, graph=g,
                    prev_mod=prev_mod, tot_iters=tot_iters,
                    mod_hist=np.array([p.modularity for p in phases]),
                    iter_hist=np.array([p.iterations for p in phases]),
                    nv_hist=np.array([p.num_vertices for p in phases]),
                    ne_hist=np.array([p.num_edges for p in phases]),
                    orig_ne=graph.num_edges, fingerprint=ck_fp))
            if checkpoint_dir:
                # No rank goes on (and may resume) before the file exists.
                multihost.barrier()
            tracer.end_span(phase_sid, gained=True)
            continue
        # No gain.  Safety net: when cycling exits early, run one final
        # 1e-6 pass from the identity assignment, on the same schedule
        # without ET (main.cpp:432-442).  As in the reference, its sweeps
        # are not counted in traversed_edges.
        if cycling and phase < 10 and th > 1.0e-6:
            with tracer.stage("iterate", into=stages):
                comm_pad, _, iters = runner.run(1.0e-6)
            with tracer.stage("evaluate", into=stages):
                curr_mod = _phase_q(dg, comm_pad, runner)
            tot_iters += iters
            final_gained = (curr_mod - prev_mod) > 1.0e-6
            conv = runner.convergence
            conv.phase, conv.gained = phase, final_gained
            convergence.append(conv)
            if tracer.emitter is not None:
                tracer.event("convergence", **conv.to_dict())
            if final_gained:
                with tracer.stage("renumber"):
                    dense, _ = renumber_communities(comm_pad[dg.old_to_pad])
                    comm_all = dense[comm_all]
                prev_mod = curr_mod
                phases.append(PhaseStats(
                    phase=phase, modularity=curr_mod, iterations=iters,
                    num_vertices=g_nv, num_edges=g_ne,
                    seconds=time.perf_counter() - t1))
        tracer.end_span(phase_sid, gained=False)
        break
    if diag is not None:
        diag.close()
    tracer.set_phase(None)
    with tracer.stage("finish"):
        # Final contiguous renumber of the composed labels
        # (main.cpp:374-394).
        dense_all, _ = renumber_communities(comm_all)
    return LouvainResult(
        communities=dense_all,
        modularity=prev_mod,
        phases=phases,
        total_iterations=tot_iters,
        total_seconds=time.perf_counter() - t_start,
        convergence=convergence,
        rebinned_phases=rebinned,
        exchange_stats=exchange_stats,
        pallas_coverage=(cov_num / cov_den) if cov_den else None,
        pallas_width_hits=width_hits or None,
    )


def _report_coverage(cov: list, pallas: bool, verbose: bool) -> None:
    """The reference's per-phase coverage print (``verbose``) and its
    warning when a pallas phase sweeps under half of its edges on a
    kernel (``driver.py:1132-1138``)."""
    total = max(sum(n for _, n, _ in cov), 1)
    share = sum(n for _, n, k in cov if k) / total
    if verbose:
        det = " ".join(f"{'heavy' if w == 0 else w}:{n}{'*' if k else ''}"
                       for w, n, k in cov)
        print(f"pallas kernel coverage: {100 * share:.1f}% of edges "
              f"(per-width, * = kernel: {det})")
    if pallas and share < 0.5:
        warnings.warn(
            f"engine='pallas': only {100 * share:.0f}% of edges are in "
            "kernel-covered classes; the hubs of the sparse exchange run "
            "the sorted path", stacklevel=3)


def _diag_phase(diag, dg, runner, phase: int, iters: int, q: float,
                seconds: float) -> None:
    """One phase's line in every shard's diagnostic file (reference
    ``driver.py:2266-2273``): the shard's owned vertices and real edges,
    its ghosts under a ghost routing (its group's under the two-level
    exchange, whose plan lists them by group), the phase's sweeps, Q and
    seconds so far.  One shard: the phase's whole graph."""
    gc = getattr(runner, "ghost_counts", None)
    shards = ([(sh.bound - sh.base, sh.n_real_edges) for sh in dg.shards]
              or [(dg.graph.num_vertices, dg.graph.num_edges)])
    per = len(shards) // len(gc) if gc else 1
    for s, (owned, edges) in enumerate(shards):
        diag.write(s, f"phase {phase}: owned={owned} edges={edges}"
                   f"{f' ghosts={gc[s // per]}' if gc else ''}"
                   f" iters={iters} Q={q:.6f} t={seconds:.3f}s")


def _run_fused(graph: Graph, *, threshold: float, threshold_cycling: bool,
               one_phase: bool, max_phases: int, verbose: bool,
               device, tracer) -> LouvainResult:
    """The fused engine (reference ``driver.py:1419-1686``).  The slab is
    uploaded once.  While it holds >= ``FUSED_SHRINK_EDGES`` rows, each
    call runs one phase and the slab is coarsened on the device before the
    next; then one call runs every remaining phase relabel-only, with the
    in-call cycling safety net.  Labels compose on the device and reach
    the host once, at the end.  The engine always coarsens on the device
    (``CUVITE_DEVICE_COARSEN`` steers the sort engine only).  Phase
    seconds are the calls' seconds, rescaled so they sum to the wall
    time, as in the reference: its TEPS is the whole run's."""
    from cuvite_tpu_torch.louvain.fused import fused_louvain

    t_start = time.perf_counter()
    max_p = 1 if one_phase else int(max_phases)
    cycling = bool(threshold_cycling and not one_phase)

    def ths(phase0: int) -> list:
        return [threshold_for_phase(phase0 + k) if cycling else threshold
                for k in range(max_p)]

    with tracer.stage("start"):
        constant = 1.0 / graph.total_edge_weight_twice()
    with tracer.stage("plan"):
        dg = DistGraph.build(graph)
    nv_pad = dg.nv_pad
    with tracer.stage("upload"):
        slab = dg.device_slab(device)
        with tracer.stage("host_read"):
            real_mask = torch.from_numpy(dg.vertex_mask()).to(device)
        with tracer.stage("host_read"):
            finish_uploads(device)
    tracer.ledger_phase_begin()
    tracer.track("slab", slab)
    tracer.track("tables", real_mask)
    # Original vertex -> current dense id; single-shard padded ids are the
    # original ids.
    comm_all = torch.arange(graph.num_vertices, dtype=torch.int32,
                            device=device)
    phases: list[PhaseStats] = []
    convergence: list = []
    tot_iters = 0
    prev_mod = -1.0
    labels = nc = None
    real_nv, real_ne = graph.num_vertices, graph.num_edges

    def run_call(thresholds, budget, cyc):
        """One fused call on the resident slab; folds its phases into the
        run's records and returns how many it ran."""
        nonlocal tot_iters, prev_mod, comm_all, labels, nc
        timed = {}
        with tracer.stage("iterate", into=timed):
            out = fused_louvain(
                *slab, thresholds, constant, real_mask, nv_pad=nv_pad,
                cycling=cyc, prev_mod0=prev_mod, phase_budget=budget,
                phase0=len(phases),
                iter_budget=MAX_TOTAL_ITERATIONS - tot_iters, tracer=tracer)
        call_s = timed["iterate"]
        tot_iters += out.iterations
        tracer.count("traversed_edges", real_ne * out.iterations)
        n = len(out.phases)
        nv_p = real_nv
        for fp in out.phases:
            st = PhaseStats(phase=len(phases), modularity=fp.modularity,
                            iterations=fp.iterations, num_vertices=nv_p,
                            num_edges=real_ne, seconds=call_s / n,
                            stages={"iterate": call_s / n})
            phases.append(st)
            fp.convergence.phase, fp.convergence.gained = st.phase, True
            convergence.append(fp.convergence)
            if tracer.emitter is not None:
                tracer.event("convergence", **fp.convergence.to_dict())
            nv_p = fp.num_communities
            if verbose:
                print(f"Level {st.phase}, Modularity: {st.modularity:.6f}, "
                      f"Iterations: {st.iterations}, nv: {st.num_vertices}")
        # The call's labels over its slab: the identity when no phase
        # gained, which the final Q reads.
        labels = out.labels
        if n:
            nc = nv_p
            with tracer.stage("renumber"):
                dmap, _ = device_renumber(labels, real_mask, nv_pad=nv_pad,
                                          tracer=tracer)
                comm_all = device_compose_labels(dmap, labels, comm_all)
            prev_mod = out.modularity
        tracer.ledger_snapshot(phases[-1].phase if phases else None)
        return n

    while True:
        remaining = max_p - len(phases)
        one_phase_level = real_ne >= FUSED_SHRINK_EDGES and remaining > 1
        budget = 1 if one_phase_level else remaining
        n = run_call(ths(len(phases)), budget,
                     cycling and not one_phase_level)
        if n < budget:
            # No gain.  An intermediate call ran without the safety net;
            # when it is still due (main.cpp:432-442), run just the 1e-6
            # phase.
            if (one_phase_level and cycling and len(phases) < 10
                    and ths(len(phases))[0] > 1e-6
                    and tot_iters <= MAX_TOTAL_ITERATIONS):
                run_call([1e-6] * max_p, 1, False)
            break
        if (len(phases) >= max_p or not one_phase_level
                or tot_iters > MAX_TOTAL_ITERATIONS):
            break
        stages = phases[-1].stages
        with tracer.stage("coarsen", into=stages):
            eng = coalesce_engine(nv_pad)
            ne_in = real_ne
            with tracer.stage("coalesce", into=stages):
                src2, dst2, w2, _dm, _nc, real_ne = device_coarsen_slab(
                    *slab, labels, real_mask, nv_pad=nv_pad, coalesce=eng,
                    tracer=tracer)
            tracer.count("coalesce_edges", ne_in)
            if eng != "sort":
                tracer.count("coalesce_dense_edges", ne_in)
            real_nv = nc
            src2, dst2, w2, nv_pad = maybe_shrink_to_class(
                src2, dst2, w2, nc=real_nv, ne2=real_ne, nv_pad=nv_pad)
            slab = (src2, dst2, w2)
            real_mask = torch.arange(nv_pad, device=device) < real_nv
            tracer.ledger_phase_begin()
            tracer.track("slab", slab)
            tracer.track("tables", real_mask, labels)
        phases[-1].coalesce = eng

    total_s = time.perf_counter() - t_start
    call_sum = sum(st.seconds for st in phases)
    if call_sum > 0:
        for st in phases:
            st.seconds *= total_s / call_sum
    with tracer.stage("finish"):
        final_q = -1.0
        if phases:
            # Q of the final labels on the last working slab; multigraph
            # invariance makes it Q on the original graph.
            dgq = DistGraph.from_device_slab(
                *slab, num_vertices=real_nv, num_edges=real_ne,
                nv_pad=nv_pad, policy=graph.policy,
                total_weight_twice=graph.total_edge_weight_twice())
            with tracer.stage("host_read"):
                final = labels.cpu().numpy()  # graftlint: disable=R010 — final labels, O(V), for the host f64 Q
            final_q = phase_modularity(dgq, final, slab, tracer=tracer)
        # The one O(V) device-to-host transfer of the labels.
        with tracer.stage("host_read"):
            communities = comm_all.cpu().numpy().astype(np.int64)  # graftlint: disable=R010 — the allowlisted final label gather
    return LouvainResult(
        communities=communities,
        modularity=final_q,
        phases=phases,
        total_iterations=tot_iters,
        total_seconds=total_s,
        convergence=convergence,
    )
