"""Batched multi-tenant Louvain on one device (port of
``cuvite_tpu/louvain/batched.py``).

Serving many small graphs: B graphs of one slab class (``core/batch.py``)
run as one batch.  Every tenant is folded into one id space -- tenant b's
vertex v is b * nv_pad + v, nv_pad the class's power of two -- so each
sweep is one pass over the whole batch: one launch of the row kernel per
width class and one of the heavy kernel for every tenant's rows and hubs
(each row with its tenant's constant), or one sort of the whole slab; and
each coarsening is one batched coalesce (one ``seg_coalesce`` launch, or
one sort).  Nothing in a sweep or a coarsening mixes tenants, so every
tenant's labels and Q equal its own B=1 run's.

Engines (``engine=``): ``'fused'`` -- every phase sweeps the folded slab
with the sort formulation (``_phase_body``, the reference's vmapped fused
phase).  ``'bucketed'`` -- phase 0 sweeps plans built on the host at pack
time and folded (``_bucketed_phase_body``); after it the batch drops one
notch to the serving-coarse class when every tenant still clustering fits
(``_coarse_class``); coarse phases rebuild their plans on the device from
the coarse slab (``_rebinned_phase_body``, ``coarsen/rebin.py``) where
``rebin_eligible`` holds and ``CUVITE_DEVICE_REBIN`` is on, else run
fused.  ``BatchResult.phase_engines`` records each phase's engine.

The loop.  Torch has no device while-loop, so each sweep makes one host
read of the tenants' [B] Q and moved counts (``_phase_loop``).  Each
tenant stops, and rolls back its no-gain sweep, on its own; a tenant that
stopped keeps its state bit for bit while the others sweep on -- its rows
are still swept with the batch and the results discarded (skipping them
would split the launches).  After each phase (``_phase_tail``) a tenant
that gained nothing is retired: its slab becomes padding and its labels
stay; the batch never splits.  Tenants retired in an earlier phase are
not swept at all (their slabs hold no rows).

Numbers: as in the per-graph engines, label-feeding sums are taken in f64
and rounded once, and the in-loop Q is f64; the reference's batched loop
keeps f32 (or double-single) Q, so a gain within f32 rounding of the
threshold could end a phase one sweep apart.  Each tenant's Q is summed
over its own vertices; on the exactness domain (integer or dyadic
weights) its sums are exact, and so equal a B=1 run's bit for bit.

What does not carry over, by design:

- The reference's compile-key machinery (``_PHASE_CACHE``,
  ``_get_batched_phase``, the one-compile-per-(class, B, engine)
  contract, ``bucket_shape`` padding for compile stability): eager PyTorch
  has no trace to reuse.  ``bucket_shape`` is still accepted, and a batch
  that does not fit it is refused.
- Sharding the batch axis over several devices (``make_batch_mesh``,
  ``BATCH_AXIS``): multi-GPU work, ``ROADMAP.md`` A7.4.  ``mesh=None``
  and ``mesh="auto"`` resolve to the one device; any other value raises.
- The accumulator binning of ``accum_class_of``: the port sums in f64 for
  every graph, so every graph is one class (``"float64"``).  The serving
  queue still bins by the reference's tag (``serve/queue.py::
  accum_tag``), which now decides binning only.
- The ``msd``/``hash`` coalesce engines.

Merged batches (``pack_subrow_many``, ``prepare_packed``,
``cluster_packed``, reference ``:239-470, 772-822, 1038-1170,
1264-1305``).  A packed row holds ``n_sub`` small graphs of the sub class
(``core/batch.py::pack_subrows``); vertex v of sub-row s of row r has the
id ``r * (n_sub * nv_sub) + s * nv_sub + v``, which is this engine's fold
``t * nv_pad + v`` with tenant ``t = r * n_sub + s`` and
``nv_pad = nv_sub``.  So a merged batch runs as a batch of
``b_pad * n_sub`` tenants at the sub class, through the same phases,
kernels and per-tenant stops as a plain batch (the reference's
``_subrow_phase_body``, ``_subrow_phase_tail`` and
``_shrink_subrow_batch`` are ``_phase_body``, ``_phase_tail`` and
``_shrink_batch`` of that fold), and each sub-row freezes on its own
criterion.  ``BatchResult`` reports the packed geometry: ``b_pad`` rows of
the row class, ``n_sub``, and the coarse class scaled to the row.  The
engine is the caller's (``engine=``; the reference's packed engine is the
sort formulation, ``'fused'`` here); the reference refuses ds32-scale
tenants from packed rows, which the port's f64 sums do not need.

Uploads.  :func:`prepare_batch` uploads on the caller's stream.  With
``side_stream=True`` (the pipelined serving dispatcher's packer,
``serve/pipeline.py``) it uploads on the card from pinned host memory on
a side stream of its own and records an event, which
:func:`execute_prepared` makes its stream wait on: a batch packed on the
packer thread then overlaps the previous batch's execution (the default
stream is shared by every thread, and an upload from pageable memory is
synchronous).  The batch's device buffers are allocated on the side
stream and stay referenced by the ``PreparedBatch`` until its execution
has read the labels back, so the caching allocator cannot hand them to
the next pack while they are read.  Execution writes nothing into the
prepared buffers: a retry re-runs the same uploaded batch bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from cuvite_tpu_torch.coarsen.device import (
    batched_coarsen_slab,
    batched_compose_labels,
    batched_renumber,
    device_weighted_degrees,
)
from cuvite_tpu_torch.coarsen.rebin import (
    device_plan,
    device_rebin_enabled,
    rebin_eligible,
)
from cuvite_tpu_torch.core.batch import (
    BATCH_ENGINES,
    BatchedSlab,
    PackedSubRows,
    SubRowLayout,
    batch_bucket_plans,
    batch_slabs,
    fold_slab,
    pack_subrows,
)
from cuvite_tpu_torch.core.device import resolve_device
from cuvite_tpu_torch.core.types import (
    CONV_ROWS_CAP,
    MAX_TOTAL_ITERATIONS,
    TERMINATION_PHASE_COUNT,
    next_pow2,
)
from cuvite_tpu_torch.kernels.seg_coalesce import batched_coalesce_engine
from cuvite_tpu_torch.louvain.bucketed import DevicePlan, bucketed_step
from cuvite_tpu_torch.louvain.step import louvain_step_local
from cuvite_tpu_torch.obs.convergence import decode_phase_conv
from cuvite_tpu_torch.ops.segment import TenantConstants
from cuvite_tpu_torch.utils.trace import NullTracer

# Serving-coarse slab-class floors of the bucketed engine's one-notch
# shrink after phase 0 (reference ``:395-396``).
BATCH_COARSE_MIN_NV = 1024
BATCH_COARSE_MIN_NE = 4096


def _coarse_class(nv_pad: int, ne_pad: int) -> tuple:
    """The one-notch serving-coarse class of a phase-0 slab class: both
    dimensions divided by 4, floored at the serving-coarse minima."""
    return (max(nv_pad // 4, BATCH_COARSE_MIN_NV),
            max(ne_pad // 4, BATCH_COARSE_MIN_NE))


def _resolve_mesh(mesh) -> None:
    """``None`` and ``"auto"`` mean the one device; a batch-axis mesh over
    several devices is not ported."""
    if mesh is None or (isinstance(mesh, str) and mesh == "auto"):
        return
    raise ValueError(
        f"mesh={mesh!r}: sharding the batch axis over several devices is "
        "not ported (ROADMAP.md A7.4, multi-GPU); pass "
        "mesh=None or mesh='auto' for the one device")


@dataclasses.dataclass
class _Slab:
    """The batch's device state between phases: the [B, ne_pad] slab of
    the current class, the real-vertex mask, and every tenant's composed
    labels over its original vertices."""

    src: torch.Tensor        # [B, ne_pad] int32, padding src == nv_pad
    dst: torch.Tensor        # [B, ne_pad] int32
    w: torch.Tensor          # [B, ne_pad] f32
    real_mask: torch.Tensor  # [B, nv_pad] bool
    comm_all: torch.Tensor   # [B, nv_pad0] int32 dense community ids

    @property
    def nv_pad(self) -> int:
        return int(self.real_mask.shape[1])

    @property
    def ne_pad(self) -> int:
        return int(self.src.shape[1])

    @property
    def nv_total(self) -> int:
        return int(self.src.shape[0]) * self.nv_pad

    def folded(self) -> tuple:
        """(src, dst, w) as one slab over ``nv_total`` folded vertices
        (``core/batch.fold_slab``)."""
        return fold_slab(self.src, self.dst, self.w, nv_pad=self.nv_pad)


def _phase_loop(sweep, b: int, nv_pad: int, running: np.ndarray,
                threshold: float, device) -> tuple:
    """Every running tenant's phase from the identity assignment: the
    batched ``loop.phase_loop`` (reference ``_run_phase_loop`` under
    ``jax.vmap``).  ``sweep(comm)`` returns (target [B * nv_pad] int32,
    Q [B] f64, moved [B]).  One host read per sweep.

    The sweeps see folded ids (tenant b's community c is b * nv_pad + c).
    Returns (past [B, nv_pad] int32 in each tenant's own ids, Q of past
    [B] f64 numpy, sweeps [B] numpy, per-tenant (qs, moved) convergence
    rows)."""
    comm = torch.arange(b * nv_pad, dtype=torch.int32,
                        device=device).view(b, nv_pad)
    base = comm[:, :1].clone()
    past = comm.clone()
    prev = np.full(b, -1.0)
    iters = np.zeros(b, dtype=np.int64)
    rows = [([], []) for _ in range(b)]
    run = running.copy()
    while run.any():
        target, mod, moved = sweep(comm.reshape(-1))
        read = torch.stack([mod, moved.double()]).tolist()
        advance = np.zeros(b, dtype=bool)
        for i in np.flatnonzero(run):
            q = read[0][i]
            iters[i] += 1
            stop = (q - prev[i]) < threshold
            qs, mv = rows[i]
            if len(qs) < CONV_ROWS_CAP:
                qs.append(q)
                mv.append(0 if stop else int(read[1][i]))
            if stop:
                run[i] = False
                continue
            prev[i] = max(q, -1.0)
            advance[i] = True
            if iters[i] >= MAX_TOTAL_ITERATIONS:
                run[i] = False
        adv = torch.from_numpy(advance).to(device)[:, None]
        past = torch.where(adv, comm, past)
        comm = torch.where(adv, target.view(b, nv_pad), comm)
    return past - base, prev, iters, rows


def _constants(tw2: np.ndarray, device) -> TenantConstants:
    """Each tenant's 1/(2m) as the gains (f32) and Q (f64) take it; 0 on
    padding rows."""
    c64 = np.zeros(len(tw2))
    real = tw2 > 0
    c64[real] = 1.0 / tw2[real]
    return TenantConstants(
        c32=torch.from_numpy(c64.astype(np.float32)).to(device),
        c64=torch.from_numpy(c64).to(device))


def _phase_body(slab: _Slab, consts: TenantConstants) -> callable:
    """The fused phase (reference ``_phase_body``): the sort sweep over
    the folded slab."""
    src, dst, w = slab.folded()
    vdeg = device_weighted_degrees(src, w, nv_pad=slab.nv_total)

    def sweep(comm):
        out = louvain_step_local(src, dst, w, comm, vdeg, consts)
        return out.target, out.modularity, out.n_moved

    return sweep


def _bucketed_phase_body(plan: DevicePlan, slab: _Slab,
                         consts: TenantConstants) -> callable:
    """Phase 0 of the bucketed engine (reference ``_bucketed_phase_body``):
    the weighted degrees from the slab, then ``bucketed_step`` of every
    tenant over the folded plan, on the row and heavy kernels."""
    src, _, w = slab.folded()
    vdeg = device_weighted_degrees(src, w, nv_pad=slab.nv_total)

    def sweep(comm):
        res = bucketed_step(plan, comm, vdeg, consts,
                            nv_total=slab.nv_total)
        return res.target, res.modularity, res.n_moved

    return sweep


def _rebinned_phase_body(slab: _Slab, consts: TenantConstants) -> callable:
    """A coarse phase of the bucketed engine (reference
    ``_rebinned_phase_body``): the plan built on the device from the
    folded coarse slab (``coarsen/rebin.device_plan``), then the bucketed
    sweep.  The caller checks ``rebin_eligible``."""
    plan = device_plan(*slab.folded(), nv_local=slab.nv_total)
    return _bucketed_phase_body(plan, slab, consts)


def _phase_tail(slab: _Slab, past: torch.Tensor, mod: np.ndarray,
                prev_mod: np.ndarray, active: np.ndarray,
                threshold: float) -> tuple:
    """The phase epilogue shared by every engine (reference
    ``_phase_tail``): the gain test, the coarsening of the tenants that
    gained, and the masked exit of those that did not (slab retired to
    padding, labels kept).  Returns (next _Slab, gained [B], nc [B],
    ne2 [B], coalesce engine or None)."""
    dev = slab.src.device
    b, nv = slab.src.shape[0], slab.nv_pad
    gained = active & ((mod - prev_mod) > threshold)
    if not gained.any():
        return slab, gained, np.zeros(b, np.int64), np.zeros(b, np.int64), \
            None
    g = torch.from_numpy(gained).to(dev)[:, None]
    src = torch.where(g, slab.src, nv)
    dst = torch.where(g, slab.dst, 0)
    w = torch.where(g, slab.w, 0.0)
    real_mask = slab.real_mask & g
    dmap, nc_d = batched_renumber(past, real_mask, nv_pad=nv)
    nc = np.asarray(nc_d.tolist(), dtype=np.int64)
    grid = next_pow2(int(nc.max()))
    engine = batched_coalesce_engine(nv, b, grid)
    src2, dst2, w2, ne2_d = batched_coarsen_slab(
        src, dst, w, past, dmap, nv_pad=nv, coalesce=engine, grid=grid)
    ne2 = np.asarray(ne2_d.tolist(), dtype=np.int64)
    rm2 = torch.arange(nv, device=dev)[None, :] < nc_d[:, None]
    comm_all = torch.where(g, batched_compose_labels(dmap, past,
                                                     slab.comm_all),
                           slab.comm_all)
    return _Slab(src=src2, dst=dst2, w=w2, real_mask=rm2,
                 comm_all=comm_all), gained, nc, ne2, engine


def _shrink_batch(slab: _Slab, cnv: int, cne: int) -> _Slab:
    """The batch's slab in class (cnv, cne): each row's prefix, padding
    sentinels rewritten (coarse ids are dense and < nc <= cnv)."""
    s = slab.src[:, :cne]
    s = torch.where(s >= cnv, cnv, s).to(torch.int32)
    return _Slab(src=s.contiguous(), dst=slab.dst[:, :cne].contiguous(),
                 w=slab.w[:, :cne].contiguous(),
                 real_mask=slab.real_mask[:, :cnv].contiguous(),
                 comm_all=slab.comm_all)


@dataclasses.dataclass
class BatchResult:
    """Per-tenant results plus the batch-level serving telemetry."""

    results: list          # list[LouvainResult], one per job, in order
    wall_s: float          # whole-batch wall time (pack to final gather)
    n_phases: int          # batch phase count (max over rows)
    b_pad: int
    n_jobs: int
    slab_class: tuple      # (nv_pad, ne_pad)
    # The engine each batch phase ran: 'bucketed' (phase 0, host plans),
    # 'rebinned' (device plans) or 'fused' (sort sweeps).
    phase_engines: list = dataclasses.field(default_factory=list)
    # The serving-coarse class phases >= 1 ran at, else None.
    coarse_class: tuple | None = None
    pack_s: float = 0.0    # host pack, plan build and upload
    device_s: float = 0.0  # the phases and the final label gather
    # Coalesce engine of each batch coarsening ('dense' or 'sort').
    coalesce: list = dataclasses.field(default_factory=list)
    # Sweeps of each batch phase (its slowest tenant's).
    sweeps: list = dataclasses.field(default_factory=list)
    # Sub-rows per row: 1 for a plain batch, the layout's for a merged one.
    n_sub: int = 1

    @property
    def pack_util(self) -> float:
        return min(self.n_jobs, self.b_pad) / max(self.b_pad, 1)

    @property
    def jobs_per_s(self) -> float:
        return self.n_jobs / max(self.wall_s, 1e-9)


def accum_class_of(graph, nv_pad: int | None = None) -> str:
    """The accumulator half of the serving bin key.  The port sums every
    label-feeding quantity in f64 for every graph, so every graph is of
    one class; the reference tells f32 from double-single graphs here."""
    return "float64"


@dataclasses.dataclass
class PreparedBatch:
    """A packed batch with its device buffers uploaded: what
    :func:`execute_prepared` runs.  Execution reads and never writes
    these buffers, so a batch can be executed again."""

    b_pad: int
    nv_pad: int
    ne_pad: int
    n_jobs: int
    slab_class: tuple
    nv_real: np.ndarray
    ne_real: np.ndarray
    row_valid: np.ndarray
    tw2: np.ndarray
    engine: str
    device: torch.device
    slab: _Slab
    plan: DevicePlan | None = None   # phase-0 folded plan, bucketed only
    pack_s: float = 0.0
    # The upload's event on the side stream (card only, module note).
    ready: object = None
    # A merged batch: its sub-row layout and packed row count (the
    # fields above describe the fold of its sub-rows).
    layout: SubRowLayout | None = None
    rows: int = 0


# One upload stream per card (module note), made on first use.
_UPLOAD_STREAMS: dict = {}
_UPLOAD_LOCK = threading.Lock()


def _upload_stream(dev: torch.device):
    with _UPLOAD_LOCK:
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        stream = _UPLOAD_STREAMS.get(idx)
        if stream is None:
            stream = _UPLOAD_STREAMS[idx] = torch.cuda.Stream(idx)
    return stream


def prepare_batch(batch: BatchedSlab, *, mesh="auto", engine: str = "fused",
                  bucket_shape=None, device=None, tracer=None,
                  side_stream: bool = False) -> PreparedBatch:
    """The pack half of :func:`run_batched`: the phase-0 plans
    (``engine='bucketed'``, built on the host and folded) and the upload
    of the slab and the plans (``side_stream`` on the card: pinned
    memory, a side stream and an event, module note)."""
    if engine not in BATCH_ENGINES:
        raise ValueError(f"unknown batched engine {engine!r}; "
                         f"use one of {BATCH_ENGINES}")
    _resolve_mesh(mesh)
    dev = resolve_device(device)
    tracer = tracer if tracer is not None else NullTracer()
    t0 = time.perf_counter()
    nv_pad = batch.nv_pad
    host_plan = None
    if engine == "bucketed":
        with tracer.stage("plan"):
            host_plan = batch_bucket_plans(batch, shape=bucket_shape).fold()
    side = side_stream and dev.type == "cuda"
    stream = _upload_stream(dev) if side else None

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if side:
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    b = batch.b_pad
    ready = None
    with tracer.stage("upload"), (torch.cuda.stream(stream) if side
                                  else contextlib.nullcontext()):
        plan = (None if host_plan is None
                else DevicePlan.upload(host_plan, dev))
        slab = _Slab(
            src=put(batch.src), dst=put(batch.dst), w=put(batch.w),
            real_mask=put(batch.real_mask),
            comm_all=torch.arange(nv_pad, dtype=torch.int32,
                                  device=dev).repeat(b).view(b, nv_pad))
        if side:
            ready = torch.cuda.Event()
            ready.record(stream)
    if side:
        # The pack window ends with the upload done (the pinned buffers
        # are free to go); the executor still orders itself after it.
        ready.synchronize()
    return PreparedBatch(
        b_pad=b, nv_pad=nv_pad, ne_pad=batch.ne_pad, n_jobs=batch.n_jobs,
        slab_class=batch.slab_class, nv_real=batch.nv_real.copy(),
        ne_real=batch.ne_real.copy(), row_valid=batch.row_valid.copy(),
        tw2=batch.tw2.copy(), engine=engine, device=dev, slab=slab,
        plan=plan, pack_s=time.perf_counter() - t0, ready=ready)


def _coarse_engine(engine: str, nv: int, ne: int) -> str:
    """The engine of a coarse phase at class (nv, ne)."""
    if (engine == "bucketed" and device_rebin_enabled()
            and rebin_eligible(nv, ne)):
        return "rebinned"
    return "fused"


def execute_prepared(prep: PreparedBatch, *, threshold: float = 1.0e-6,
                     max_phases: int = TERMINATION_PHASE_COUNT,
                     tracer=None, verbose: bool = False) -> BatchResult:
    """The execute half of :func:`run_batched`: the phases, one batch
    coarsening after each, and one final label gather.  Re-runnable: the
    prepared buffers are only read, so a retry gives the same bits.  A
    merged batch (``prep.layout``) runs as the fold of its sub-rows and
    reports the packed geometry."""
    tracer = tracer if tracer is not None else NullTracer()
    if prep.ready is not None:
        torch.cuda.current_stream(prep.device).wait_event(prep.ready)
    with tracer.stage("iterate"):
        br = _execute_fold(prep, threshold=threshold,
                           max_phases=max_phases, verbose=verbose,
                           tracer=tracer)
    if prep.layout is not None:
        n_sub = prep.layout.n_sub
        br.b_pad = prep.rows
        br.slab_class = prep.layout.row_class
        br.n_sub = n_sub
        if br.coarse_class is not None:
            br.coarse_class = (n_sub * br.coarse_class[0],
                               n_sub * br.coarse_class[1])
    return br


def _execute_fold(prep: PreparedBatch, *, threshold: float,
                  max_phases: int, verbose: bool, tracer) -> BatchResult:
    """The phases of a prepared batch over its folded tenants.  Each
    phase books its live buffers to the tracer's memory ledger and counts
    ``traversed_edges`` (each active tenant's edges x sweeps, from the
    host values the phase already read), as the reference does
    (``batched.py:934-990``)."""
    from cuvite_tpu_torch.louvain.driver import LouvainResult, PhaseStats

    t0 = time.perf_counter()
    b = prep.b_pad
    dev = prep.device
    consts = _constants(prep.tw2, dev)
    slab = prep.slab
    coarse_class = None
    active = prep.row_valid.copy()
    prev_mod = np.full(b, -1.0)
    nv_cur = prep.nv_real.copy()
    ne_cur = prep.ne_real.copy()
    tot_iters = np.zeros(b, dtype=np.int64)
    row_phases: list = [[] for _ in range(b)]
    row_conv: list = [[] for _ in range(b)]
    phase_engines: list = []
    coalesce: list = []
    sweeps: list = []
    phase = 0
    while active.any() and phase < max_phases:
        t1 = time.perf_counter()
        tracer.ledger_phase_begin()
        tracer.track("slab", slab.src, slab.dst, slab.w)
        tracer.track("tables", slab.real_mask, consts)
        if phase == 0 and prep.engine == "bucketed":
            tracer.track("plans", prep.plan)
            eng = "bucketed"
            sweep = _bucketed_phase_body(prep.plan, slab, consts)
        else:
            eng = _coarse_engine(prep.engine, slab.nv_pad, slab.ne_pad)
            sweep = (_rebinned_phase_body(slab, consts) if eng == "rebinned"
                     else _phase_body(slab, consts))
        phase_engines.append(eng)
        past, mod, iters, rows = _phase_loop(sweep, b, slab.nv_pad, active,
                                             threshold, dev)
        del sweep
        sweeps.append(int(iters.max()))
        slab, gained, nc, ne2, ceng = _phase_tail(slab, past, mod, prev_mod,
                                                  active, threshold)
        if ceng is not None:
            coalesce.append(ceng)
        phase_wall = time.perf_counter() - t1
        share = phase_wall / max(int(active.sum()), 1)
        traversed = 0
        for i in np.flatnonzero(active):
            it = int(iters[i])
            tot_iters[i] += it
            traversed += int(ne_cur[i]) * it
            pc = decode_phase_conv(phase, it, *rows[i])
            pc.gained = bool(gained[i])
            row_conv[i].append(pc)
            if gained[i]:
                row_phases[i].append(PhaseStats(
                    phase=len(row_phases[i]), modularity=float(mod[i]),
                    iterations=it, num_vertices=int(nv_cur[i]),
                    num_edges=int(ne_cur[i]), seconds=share))
                nv_cur[i] = int(nc[i])
                ne_cur[i] = int(ne2[i])
                prev_mod[i] = max(float(mod[i]), -1.0)
        tracer.count("traversed_edges", traversed)
        tracer.ledger_snapshot(phase)
        active = active & gained & (tot_iters <= MAX_TOTAL_ITERATIONS)
        if verbose:
            print(f"batched phase {phase} ({eng}): active "
                  f"{int(active.sum())}/{prep.n_jobs}, iterations "
                  f"{iters[:prep.n_jobs].tolist()}")
        if phase == 0 and prep.engine == "bucketed":
            # One-notch serving-coarse shrink (reference :996-1010): iff
            # every tenant still clustering fits.
            cnv, cne = _coarse_class(slab.nv_pad, slab.ne_pad)
            if (active.any() and (cnv, cne) != (slab.nv_pad, slab.ne_pad)
                    and int(nc[active].max()) <= cnv
                    and int(ne2[active].max()) <= cne):
                slab = _shrink_batch(slab, cnv, cne)
                coarse_class = (cnv, cne)
        phase += 1

    # The one final label gather.
    comm_all = slab.comm_all.cpu().numpy()
    device_s = time.perf_counter() - t0
    results = []
    for i in range(prep.n_jobs):
        nv = int(prep.nv_real[i])
        results.append(LouvainResult(
            communities=comm_all[i, :nv].astype(np.int64),
            modularity=float(prev_mod[i]),
            phases=row_phases[i],
            total_iterations=int(tot_iters[i]),
            total_seconds=sum(p.seconds for p in row_phases[i]),
            convergence=row_conv[i],
        ))
    return BatchResult(
        results=results, wall_s=prep.pack_s + device_s, n_phases=phase,
        b_pad=b, n_jobs=prep.n_jobs, slab_class=prep.slab_class,
        phase_engines=phase_engines, coarse_class=coarse_class,
        pack_s=prep.pack_s, device_s=device_s, coalesce=coalesce,
        sweeps=sweeps)


def prepare_packed(packed: PackedSubRows, *, mesh="auto",
                   engine: str = "fused", device=None, tracer=None,
                   side_stream: bool = False) -> PreparedBatch:
    """The pack half of a merged batch: the packed rows as the fold of
    their sub-rows -- ``b_pad * n_sub`` tenants of the sub class, each
    sub-row's ids and padding back at its own offset 0 -- prepared as a
    plain batch of ``engine``, with the layout recorded."""
    lay = packed.layout
    n_sub, (nv_sub, ne_sub) = lay.n_sub, lay.sub_class
    bt = packed.b_pad * n_sub
    src = packed.src.reshape(bt, ne_sub)
    pad = src >= packed.nv_pad
    base = (np.arange(bt, dtype=np.int32) % n_sub * nv_sub)[:, None]
    batch = BatchedSlab(
        src=np.where(pad, nv_sub, src - base).astype(np.int32),
        dst=np.where(pad, 0, packed.dst.reshape(bt, ne_sub)
                     - base).astype(np.int32),
        w=packed.w.reshape(bt, ne_sub),
        real_mask=packed.real_mask.reshape(bt, nv_sub),
        constant=packed.constants.reshape(bt),
        row_valid=packed.sub_valid.reshape(bt),
        nv_real=packed.nv_real.reshape(bt),
        ne_real=packed.ne_real.reshape(bt),
        tw2=packed.tw2.reshape(bt),
        nv_pad=nv_sub, ne_pad=ne_sub, n_jobs=packed.n_jobs)
    prep = prepare_batch(batch, mesh=mesh, engine=engine, device=device,
                         tracer=tracer, side_stream=side_stream)
    prep.layout = lay
    prep.rows = packed.b_pad
    return prep


def run_batched(batch: BatchedSlab, *, threshold: float = 1.0e-6,
                max_phases: int = TERMINATION_PHASE_COUNT, mesh="auto",
                verbose: bool = False, engine: str = "fused",
                bucket_shape=None, device=None) -> BatchResult:
    """Cluster every row of a packed batch:
    ``execute_prepared(prepare_batch(batch))``.  Per tenant, the plain
    schedule at a fixed ``threshold``; a tenant's Q is its last gaining
    phase's in-loop Q; ``PhaseStats.seconds`` is the batch phase's wall
    time split over the tenants active in it."""
    prep = prepare_batch(batch, mesh=mesh, engine=engine,
                         bucket_shape=bucket_shape, device=device)
    return execute_prepared(prep, threshold=threshold,
                            max_phases=max_phases, verbose=verbose)


@dataclasses.dataclass
class PreparedMany:
    """A :func:`cluster_many` job set after packing: the edgeless jobs,
    answered inline, and the prepared batch of the rest (None when every
    job is edgeless)."""

    graphs_nv: list          # num_vertices per input, in order
    edgeless: set            # input indices answered inline
    prep: PreparedBatch | None

    @property
    def pack_s(self) -> float:
        return self.prep.pack_s if self.prep is not None else 0.0


def pack_many(graphs, *, b_pad: int | None = None,
              slab_class: tuple | None = None, mesh="auto",
              engine: str = "fused", bucket_shape=None,
              device=None, tracer=None,
              side_stream: bool = False) -> PreparedMany:
    """The pack stage of :func:`cluster_many`: edgeless split, slab
    stacking, plans and upload (``side_stream``: :func:`prepare_batch`)."""
    tracer = tracer if tracer is not None else NullTracer()
    edgeless = {i for i, g in enumerate(graphs) if g.num_edges == 0}
    packed = [g for i, g in enumerate(graphs) if i not in edgeless]
    prep = None
    if packed:
        with tracer.stage("plan"):
            batch = batch_slabs(packed, b_pad=b_pad, slab_class=slab_class)
        prep = prepare_batch(batch, mesh=mesh, engine=engine,
                             bucket_shape=bucket_shape, device=device,
                             tracer=tracer, side_stream=side_stream)
    else:
        if engine not in BATCH_ENGINES:
            raise ValueError(f"unknown batched engine {engine!r}; "
                             f"use one of {BATCH_ENGINES}")
        _resolve_mesh(mesh)
        resolve_device(device)
    return PreparedMany(graphs_nv=[g.num_vertices for g in graphs],
                        edgeless=edgeless, prep=prep)


def pack_subrow_many(graphs, layout: SubRowLayout, *,
                     b_pad: int | None = None, mesh="auto",
                     engine: str = "fused", device=None,
                     tracer=None, side_stream: bool = False) -> PreparedMany:
    """The pack stage of a merged batch: edgeless split, sub-row packing
    (``core/batch.py::pack_subrows``) and :func:`prepare_packed`.  The
    result is the :class:`PreparedMany` of :func:`pack_many`, which
    :func:`execute_many` runs the same way."""
    tracer = tracer if tracer is not None else NullTracer()
    if engine not in BATCH_ENGINES:
        raise ValueError(f"unknown batched engine {engine!r}; "
                         f"use one of {BATCH_ENGINES}")
    edgeless = {i for i, g in enumerate(graphs) if g.num_edges == 0}
    packed_graphs = [g for i, g in enumerate(graphs) if i not in edgeless]
    prep = None
    if packed_graphs:
        with tracer.stage("plan"):
            packed = pack_subrows(packed_graphs, layout, b_pad=b_pad)
        prep = prepare_packed(packed, mesh=mesh, engine=engine,
                              device=device, tracer=tracer,
                              side_stream=side_stream)
    else:
        _resolve_mesh(mesh)
        resolve_device(device)
    return PreparedMany(graphs_nv=[g.num_vertices for g in graphs],
                        edgeless=edgeless, prep=prep)


def cluster_packed(graphs, layout: SubRowLayout, *,
                   threshold: float = 1.0e-6,
                   max_phases: int = TERMINATION_PHASE_COUNT,
                   b_pad: int | None = None, mesh="auto", tracer=None,
                   verbose: bool = False, engine: str = "fused",
                   device=None) -> BatchResult:
    """Pack small-class graphs as sub-rows of ``layout.row_class`` rows and
    run them as one merged batch: the packed analog of
    :func:`cluster_many` (in-order results, edgeless graphs answered
    inline).  Each graph's labels and Q equal its own B=1 run's."""
    pm = pack_subrow_many(graphs, layout, b_pad=b_pad, mesh=mesh,
                          engine=engine, device=device, tracer=tracer)
    return execute_many(pm, threshold=threshold, max_phases=max_phases,
                        tracer=tracer, verbose=verbose)


def execute_many(pm: PreparedMany, *, threshold: float = 1.0e-6,
                 max_phases: int = TERMINATION_PHASE_COUNT,
                 tracer=None, verbose: bool = False) -> BatchResult:
    """The execute stage of :func:`cluster_many` (and of a merged batch):
    the prepared batch, and the in-order results with the edgeless jobs
    answered inline (every vertex its own community, Q = 0)."""
    from cuvite_tpu_torch.louvain.driver import LouvainResult

    if pm.prep is not None:
        br = execute_prepared(pm.prep, threshold=threshold,
                              max_phases=max_phases, tracer=tracer,
                              verbose=verbose)
    else:
        br = BatchResult(results=[], wall_s=0.0, n_phases=0, b_pad=0,
                         n_jobs=0, slab_class=(0, 0))
    out = []
    packed_iter = iter(br.results)
    for i, nv in enumerate(pm.graphs_nv):
        if i in pm.edgeless:
            out.append(LouvainResult(
                communities=np.arange(nv, dtype=np.int64),
                modularity=0.0, phases=[], total_iterations=0,
                total_seconds=0.0))
        else:
            out.append(next(packed_iter))
    br.results = out
    return br


def cluster_many(graphs, *, threshold: float = 1.0e-6,
                 max_phases: int = TERMINATION_PHASE_COUNT,
                 b_pad: int | None = None, slab_class: tuple | None = None,
                 mesh="auto", verbose: bool = False, engine: str = "fused",
                 bucket_shape=None, device=None, tracer=None) -> BatchResult:
    """Pack same-class graphs and run them as one batch; edgeless graphs
    are answered inline and take no batch row.  ``results`` covers every
    input in order; ``n_jobs``, ``pack_util`` and ``jobs_per_s`` describe
    the packed batch only."""
    pm = pack_many(graphs, b_pad=b_pad, slab_class=slab_class, mesh=mesh,
                   engine=engine, bucket_shape=bucket_shape, device=device,
                   tracer=tracer)
    return execute_many(pm, threshold=threshold, max_phases=max_phases,
                        tracer=tracer, verbose=verbose)
