"""Batched multi-tenant Louvain on one device or a batch-axis mesh (port
of ``cuvite_tpu/louvain/batched.py``).

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
phase).  ``'bucketed'`` -- phase 0 sweeps one plan of the folded batch
(``_bucketed_phase_body``), built at pack time (``_phase0_plan``) on the
device from the uploaded slab where the coarse phases' rule below holds,
else on the host and folded, the same tensors either way; after it the
batch drops one notch to the serving-coarse class when every tenant
still clustering fits (``_coarse_class``); coarse phases rebuild their
plans on the device from the coarse slab (``_rebinned_phase_body``,
``coarsen/rebin.py``) where ``rebin_eligible`` holds and
``CUVITE_DEVICE_REBIN`` is on, else run fused.
``BatchResult.phase_engines`` records each phase's engine.

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
- The accumulator binning of ``accum_class_of``: the port sums in f64 for
  every graph, so every graph is one class (``"float64"``).  The serving
  queue still bins by the reference's tag (``serve/queue.py::
  accum_tag``), which now decides binning only.

A batch coalesces with ``kernels/seg_coalesce.batched_coalesce_engine``:
``CUVITE_SEG_COALESCE=msd`` and ``=hash`` both run the msd engine on the
whole batch, as the reference sends ``hash`` to ``msd`` under ``vmap``.

The batch axis over several devices (reference ``:531-550, 713-730,
809-817``).  :func:`make_batch_mesh` spans the largest power-of-two
device count that divides the batch's rows and fits the visible cards
(None with one card or one row).  ``mesh="auto"``, the default of every
entry point, resolves through it for a batch on the card (on the CPU it
is the one device), ``mesh=None`` pins ``device``, and a mesh from
:func:`make_batch_mesh` may list a device more than once (two blocks on
``cuda:0``, or on the CPU).  :func:`prepare_batch` splits the batch into
equal contiguous row blocks, one a device, each prepared as a batch of
its own (its slab, its phase-0 plan, its upload stream and event);
:func:`execute_prepared` runs the blocks in lock step, phase by phase,
as the reference's shard_map does: each sweep is enqueued on every block
that still has running rows before any block's flags are read, so that
the cards overlap, and each block stops on its own rows.  The coarse
class and each phase's engine are decided over the whole batch; the
coarsenings run per block.  Launch counts are then the blocks' sum, and
``BatchResult.coalesce`` lists each block's coarsenings.

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
a side stream of its own, builds phase 0's plan on that stream, and
records an event, which
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
import functools
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
    HubSlabError,
    device_plan,
    device_rebin_enabled,
    rebin_eligible,
)
from cuvite_tpu_torch.comm.mesh import Mesh
from cuvite_tpu_torch.core.batch import (
    BATCH_ENGINES,
    BatchedSlab,
    PackedSubRows,
    SubRowLayout,
    batch_bucket_plans,
    batch_bucket_shape,
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
from cuvite_tpu_torch.utils.upload import finish_uploads, to_device

# Serving-coarse slab-class floors of the bucketed engine's one-notch
# shrink after phase 0 (reference ``:395-396``).
BATCH_COARSE_MIN_NV = 1024
BATCH_COARSE_MIN_NE = 4096


def _coarse_class(nv_pad: int, ne_pad: int) -> tuple:
    """The one-notch serving-coarse class of a phase-0 slab class: both
    dimensions divided by 4, floored at the serving-coarse minima."""
    return (max(nv_pad // 4, BATCH_COARSE_MIN_NV),
            max(ne_pad // 4, BATCH_COARSE_MIN_NE))


# The batch-axis mesh dimension (tenant-parallel; orthogonal to the vertex
# mesh of comm/mesh.py).
BATCH_AXIS = "batch"


def make_batch_mesh(b_pad: int, devices=None):
    """A batch-axis mesh over the largest power-of-two device count that
    divides ``b_pad`` and is at most the device count (reference
    ``make_batch_mesh``): ``devices`` lists them, repeats allowed, and
    defaults to the visible CUDA cards.  None when one device or one row
    makes sharding pointless."""
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if devices is None else [torch.device(d) for d in devices])
    if b_pad <= 1 or len(devs) <= 1:
        return None
    cap = 1 << (len(devs).bit_length() - 1)     # largest pow2 <= ndev
    nd = min(b_pad & -b_pad, cap)               # largest pow2 | b_pad
    if nd <= 1:
        return None
    return Mesh(devices=tuple(devs[:nd]), axis_name=BATCH_AXIS)


def _check_mesh(mesh) -> None:
    if mesh is None or (isinstance(mesh, str) and mesh == "auto"):
        return
    if not (isinstance(mesh, Mesh) and mesh.axis_name == BATCH_AXIS):
        raise ValueError(
            f"mesh={mesh!r}: pass None (one device), 'auto' or a batch "
            "mesh from make_batch_mesh")


def _resolve_mesh(mesh, b_pad: int, device):
    """The batch mesh a batch of ``b_pad`` rows runs on, or None for the
    one device ``device`` (module note)."""
    _check_mesh(mesh)
    if isinstance(mesh, str):
        if resolve_device(device).type != "cuda":
            return None
        mesh = make_batch_mesh(b_pad)
    if mesh is not None and b_pad % mesh.size:
        raise ValueError(f"a batch of {b_pad} rows does not split into "
                         f"{mesh.size} equal blocks")
    return mesh


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


def _phase_loop(sweeps: list, sizes: list, nv_pad: int,
                running: np.ndarray, threshold: float, devices: list,
                tracer) -> tuple:
    """Every running tenant's phase from the identity assignment: the
    batched ``loop.phase_loop`` (reference ``_run_phase_loop`` under
    ``jax.vmap``), over the batch's blocks, block k holding the next
    ``sizes[k]`` tenants on ``devices[k]``.  ``sweeps[k](comm)`` returns
    (target [b_k * nv_pad] int32, Q [b_k] f64, moved [b_k]).  Each sweep
    is enqueued on every block that still has running rows before any
    block's values are read (one host read a block and sweep).  Each
    round over the blocks is a ``sweep`` stage of ``tracer``, and a
    block's read, stop test and advance-mask upload one ``host_read``
    stage.

    The sweeps see folded ids (tenant b's community c is b * nv_pad + c
    within its block).  Returns (past [b_k, nv_pad] int32 of each block
    in each tenant's own ids, Q of past [B] f64 numpy, sweeps [B] numpy,
    per-tenant (qs, moved) convergence rows)."""
    b = int(sum(sizes))
    los = np.cumsum([0] + list(sizes))
    comms, bases, pasts = [], [], []
    for bk, dev in zip(sizes, devices):
        comm = torch.arange(bk * nv_pad, dtype=torch.int32,
                            device=dev).view(bk, nv_pad)
        comms.append(comm)
        bases.append(comm[:, :1].clone())
        pasts.append(comm.clone())
    prev = np.full(b, -1.0)
    iters = np.zeros(b, dtype=np.int64)
    rows = [([], []) for _ in range(b)]
    run = running.copy()
    while run.any():
        with tracer.stage("sweep"):
            pending = []
            for k, sweep in enumerate(sweeps):
                if run[los[k]:los[k + 1]].any():
                    target, mod, moved = sweep(comms[k].reshape(-1))
                    pending.append((k, target, torch.stack([mod,
                                                            moved.double()])))
            for k, target, flags in pending:
                # The read, the stop test and the advance-mask upload:
                # one host_read a block and round.
                with tracer.stage("host_read"):
                    read = flags.tolist()  # graftlint: disable=R010 — the one host read a block and sweep, O(B)
                    lo, bk = los[k], sizes[k]
                    advance = np.zeros(bk, dtype=bool)
                    for j in np.flatnonzero(run[lo:lo + bk]):
                        i = lo + j
                        q = read[0][j]
                        iters[i] += 1
                        stop = (q - prev[i]) < threshold
                        qs, mv = rows[i]
                        if len(qs) < CONV_ROWS_CAP:
                            qs.append(q)
                            mv.append(0 if stop else int(read[1][j]))
                        if stop:
                            run[i] = False
                            continue
                        prev[i] = max(q, -1.0)
                        advance[j] = True
                        if iters[i] >= MAX_TOTAL_ITERATIONS:
                            run[i] = False
                    adv = torch.from_numpy(advance).to(devices[k])[:, None]
                pasts[k] = torch.where(adv, comms[k], pasts[k])
                comms[k] = torch.where(adv, target.view(bk, nv_pad), comms[k])
    return [p - base for p, base in zip(pasts, bases)], prev, iters, rows


def _constants(tw2: np.ndarray, device, tracer=None) -> TenantConstants:
    """Each tenant's 1/(2m) as the gains (f32) and Q (f64) take it; 0 on
    padding rows.  The upload blocks: a ``host_read`` stage of
    ``tracer``."""
    tracer = tracer if tracer is not None else NullTracer()
    c64 = np.zeros(len(tw2))
    real = tw2 > 0
    c64[real] = 1.0 / tw2[real]
    with tracer.stage("host_read"):
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


def _rebinned_phase_body(slab: _Slab, consts: TenantConstants,
                         tracer=None) -> callable:
    """A coarse phase of the bucketed engine (reference
    ``_rebinned_phase_body``): the plan built on the device from the
    folded coarse slab (``coarsen/rebin.device_plan``), then the bucketed
    sweep.  The caller checks ``rebin_eligible``."""
    plan = device_plan(*slab.folded(), nv_local=slab.nv_total,
                       tracer=tracer)
    return _bucketed_phase_body(plan, slab, consts)


def _phase_tail(slab: _Slab, past: torch.Tensor, mod: np.ndarray,
                prev_mod: np.ndarray, active: np.ndarray,
                threshold: float, tracer) -> tuple:
    """The phase epilogue shared by every engine (reference
    ``_phase_tail``): the gain test, the coarsening of the tenants that
    gained, and the masked exit of those that did not (slab retired to
    padding, labels kept).  Its gain-mask upload and its two reads are
    ``host_read`` stages of ``tracer``.  Returns (next _Slab, gained [B], nc [B], ne2 [B],
    coalesce engine or None)."""
    dev = slab.src.device
    b, nv = slab.src.shape[0], slab.nv_pad
    gained = active & ((mod - prev_mod) > threshold)
    if not gained.any():
        return slab, gained, np.zeros(b, np.int64), np.zeros(b, np.int64), \
            None
    with tracer.stage("host_read"):
        g = torch.from_numpy(gained).to(dev)[:, None]
    src = torch.where(g, slab.src, nv)
    dst = torch.where(g, slab.dst, 0)
    w = torch.where(g, slab.w, 0.0)
    real_mask = slab.real_mask & g
    dmap, nc_d = batched_renumber(past, real_mask, nv_pad=nv)
    with tracer.stage("host_read"):
        nc = np.asarray(nc_d.tolist(), dtype=np.int64)  # graftlint: disable=R010 — phase-scalar sync, O(B)
    grid = next_pow2(int(nc.max()))
    engine = batched_coalesce_engine(nv, b, grid)
    src2, dst2, w2, ne2_d = batched_coarsen_slab(
        src, dst, w, past, dmap, nv_pad=nv, coalesce=engine, grid=grid)
    with tracer.stage("host_read"):
        ne2 = np.asarray(ne2_d.tolist(), dtype=np.int64)  # graftlint: disable=R010 — phase-scalar sync, O(B)
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
    # The engine each batch phase ran: 'bucketed' (phase 0, its plan
    # built at pack time), 'rebinned' (coarse phases, device plans) or
    # 'fused' (sort sweeps).
    phase_engines: list = dataclasses.field(default_factory=list)
    # The serving-coarse class phases >= 1 ran at, else None.
    coarse_class: tuple | None = None
    pack_s: float = 0.0    # host pack, plan build and upload
    device_s: float = 0.0  # the phases and the final label gather
    # Coalesce engine of each batch coarsening ('dense', 'sort' or
    # 'msd').
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
    slab: _Slab | None
    plan: DevicePlan | None = None   # phase-0 folded plan, bucketed only
    pack_s: float = 0.0
    # The upload's event on the side stream (card only, module note).
    ready: object = None
    # A merged batch: its sub-row layout and packed row count (the
    # fields above describe the fold of its sub-rows).
    layout: SubRowLayout | None = None
    rows: int = 0
    # A batch on a batch mesh: one prepared batch a block, in row order
    # (this one then holds no slab, plan or event of its own).
    parts: list | None = None

    @property
    def blocks(self) -> list:
        return self.parts or [self]


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
    """The pack half of :func:`run_batched`: the slab's upload and phase
    0's plan (``engine='bucketed'``, :func:`_phase0_plan`); with
    ``side_stream`` on the card, pinned memory, a side stream and an
    event (module note).  On a batch mesh
    (``mesh``, module note) every row block is prepared so on its own
    device."""
    if engine not in BATCH_ENGINES:
        raise ValueError(f"unknown batched engine {engine!r}; "
                         f"use one of {BATCH_ENGINES}")
    bm = _resolve_mesh(mesh, batch.b_pad, device)
    if bm is None:
        return _prepare_block(batch, engine, bucket_shape,
                              resolve_device(device), tracer, side_stream)
    t0 = time.perf_counter()
    per = batch.b_pad // bm.size
    parts = [_prepare_block(_rows(batch, k * per, (k + 1) * per), engine,
                            bucket_shape, dev, tracer, side_stream)
             for k, dev in enumerate(bm.devices)]
    return PreparedBatch(
        b_pad=batch.b_pad, nv_pad=batch.nv_pad, ne_pad=batch.ne_pad,
        n_jobs=batch.n_jobs, slab_class=batch.slab_class,
        nv_real=batch.nv_real.copy(), ne_real=batch.ne_real.copy(),
        row_valid=batch.row_valid.copy(), tw2=batch.tw2.copy(),
        engine=engine, device=parts[0].device, slab=None,
        pack_s=time.perf_counter() - t0, parts=parts)


def _rows(batch: BatchedSlab, lo: int, hi: int) -> BatchedSlab:
    """Rows [lo, hi) of a batch as a batch of their own."""
    return BatchedSlab(
        src=batch.src[lo:hi], dst=batch.dst[lo:hi], w=batch.w[lo:hi],
        real_mask=batch.real_mask[lo:hi], constant=batch.constant[lo:hi],
        row_valid=batch.row_valid[lo:hi], nv_real=batch.nv_real[lo:hi],
        ne_real=batch.ne_real[lo:hi], tw2=batch.tw2[lo:hi],
        nv_pad=batch.nv_pad, ne_pad=batch.ne_pad,
        n_jobs=min(max(batch.n_jobs - lo, 0), hi - lo))


def _phase0_plan(batch: BatchedSlab, slab: _Slab, bucket_shape, dev,
                 tracer) -> DevicePlan:
    """Phase 0's folded plan of the bucketed engine: built on the device
    from the uploaded slab (``coarsen/rebin.device_plan``) where the
    class is ``rebin_eligible`` and ``CUVITE_DEVICE_REBIN`` is on, the
    rule of the coarse phases; else, or when a tenant has a hub (a
    vertex above the widest bucket, possible only in a CSR with repeated
    edges), the host plans folded and uploaded.  A pinned
    ``bucket_shape`` refuses a batch that does not fit it on both paths.
    Counts ``batch_plans`` and, for a plan built on the device,
    ``batch_device_plans``."""
    tracer.count("batch_plans", 1)
    if device_rebin_enabled() and rebin_eligible(batch.nv_pad,
                                                 batch.ne_pad):
        if bucket_shape is not None:
            batch_bucket_shape(batch, bucket_shape)
        try:
            plan = device_plan(*slab.folded(), nv_local=slab.nv_total,
                               tracer=tracer)
        except HubSlabError:
            pass
        else:
            tracer.count("batch_device_plans", 1)
            return plan
    host_plan = batch_bucket_plans(batch, shape=bucket_shape).fold()
    return DevicePlan.upload(host_plan, dev, tracer=tracer)


def _prepare_block(batch: BatchedSlab, engine: str, bucket_shape, dev,
                   tracer, side_stream: bool) -> PreparedBatch:
    """One device's prepared batch (:func:`prepare_batch`): the slab's
    upload, then phase 0's plan (``engine='bucketed'``,
    :func:`_phase0_plan`) on the same stream."""
    tracer = tracer if tracer is not None else NullTracer()
    t0 = time.perf_counter()
    nv_pad = batch.nv_pad
    side = side_stream and dev.type == "cuda"
    stream = _upload_stream(dev) if side else None

    def put(a):
        # Pinned and in flight on the current stream (the side stream
        # under the pipelined dispatcher); on the CPU the tensors alias
        # the batch's arrays, which the phases only read.
        return to_device(a, device=dev)

    b = batch.b_pad
    ready = plan = None
    with (torch.cuda.stream(stream) if side else contextlib.nullcontext()):
        with tracer.stage("upload"):
            slab = _Slab(
                src=put(batch.src), dst=put(batch.dst), w=put(batch.w),
                real_mask=put(batch.real_mask),
                comm_all=torch.arange(nv_pad, dtype=torch.int32,
                                      device=dev).repeat(b).view(b, nv_pad))
        if engine == "bucketed":
            with tracer.stage("plan"):
                plan = _phase0_plan(batch, slab, bucket_shape, dev, tracer)
        if side:
            ready = torch.cuda.Event()
            ready.record(stream)
        else:
            with tracer.stage("host_read"):
                finish_uploads(dev)
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
    for blk in prep.blocks:
        if blk.ready is not None:
            torch.cuda.current_stream(blk.device).wait_event(blk.ready)
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
    """The phases of a prepared batch over its folded tenants, its blocks
    in lock step (module note).  Each phase books its live buffers to the
    tracer's memory ledger and counts ``traversed_edges`` (each active
    tenant's edges x sweeps, from the host values the phase already
    read), as the reference does (``batched.py:934-990``)."""
    from cuvite_tpu_torch.louvain.driver import LouvainResult, PhaseStats

    t0 = time.perf_counter()
    b = prep.b_pad
    blocks = prep.blocks
    devs = [blk.device for blk in blocks]
    sizes = [blk.b_pad for blk in blocks]
    los = np.cumsum([0] + sizes)
    consts = [_constants(blk.tw2, blk.device, tracer) for blk in blocks]
    slabs = [blk.slab for blk in blocks]
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
        for slab, c in zip(slabs, consts):
            tracer.track("slab", slab.src, slab.dst, slab.w)
            tracer.track("tables", slab.real_mask, c)
        if phase == 0 and prep.engine == "bucketed":
            tracer.track("plans", *[blk.plan for blk in blocks])
            eng = "bucketed"
            body = None
        else:
            eng = _coarse_engine(prep.engine, slabs[0].nv_pad,
                                 slabs[0].ne_pad)
            body = (functools.partial(_rebinned_phase_body, tracer=tracer)
                    if eng == "rebinned" else _phase_body)
        # A block none of whose tenants still clusters gets no phase.
        bodies = [None if not active[los[k]:los[k + 1]].any()
                  else _bucketed_phase_body(blk.plan, slabs[k], consts[k])
                  if body is None else body(slabs[k], consts[k])
                  for k, blk in enumerate(blocks)]
        phase_engines.append(eng)
        pasts, mod, iters, rows = _phase_loop(
            bodies, sizes, slabs[0].nv_pad, active, threshold, devs, tracer)
        del bodies
        sweeps.append(int(iters.max()))
        gained, nc, ne2 = (np.zeros(b, dtype=bool), np.zeros(b, np.int64),
                           np.zeros(b, np.int64))
        with tracer.stage("coarsen"):
            for k, past in enumerate(pasts):
                lo, hi = los[k], los[k + 1]
                slabs[k], gained[lo:hi], nc[lo:hi], ne2[lo:hi], ceng = \
                    _phase_tail(slabs[k], past, mod[lo:hi], prev_mod[lo:hi],
                                active[lo:hi], threshold, tracer)
                if ceng is not None:
                    coalesce.append(ceng)
        del pasts
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
            # every tenant still clustering, in every block, fits.
            cur = (slabs[0].nv_pad, slabs[0].ne_pad)
            cnv, cne = _coarse_class(*cur)
            if (active.any() and (cnv, cne) != cur
                    and int(nc[active].max()) <= cnv
                    and int(ne2[active].max()) <= cne):
                with tracer.stage("coarsen"):
                    slabs = [_shrink_batch(slab, cnv, cne)
                             for slab in slabs]
                coarse_class = (cnv, cne)
        phase += 1

    # The one final label gather (one a block).
    with tracer.stage("host_read"):
        comm_all = np.concatenate([slab.comm_all.cpu().numpy()  # graftlint: disable=R010 — the allowlisted final label gather (batched)
                                   for slab in slabs])
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
    plain batch of ``engine``, with the layout recorded.  A batch mesh
    splits the packed rows (``mesh="auto"`` resolves on their count), so
    that a block holds whole rows."""
    bm = _resolve_mesh(mesh, packed.b_pad, device)
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
    prep = prepare_batch(batch, mesh=bm, engine=engine, device=device,
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
        _check_mesh(mesh)
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
        _check_mesh(mesh)
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
