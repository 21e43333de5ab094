"""Segmented coalesce of a relabeled edge slab: the CUDA kernel wrapper,
its plain PyTorch twin, the compaction and the engine policy.

Replaces ``seg_coalesce_pallas`` (``cuvite_tpu/kernels/seg_coalesce.py:202``)
and follows that module's ``seg_coalesce_xla`` (``:246``),
``emit_coalesced`` (``:272``), ``coalesce_slab`` (``:299``) and
``coalesce_engine`` (``:106``).  The device coarsening must turn the
relabeled slab (dense ids < nv_pad, padding src == nv_pad) into one row per
distinct (src, dst), in ascending order, compacted into the slab prefix,
duplicate weights summed.  The dense engine accumulates a weight sum and a
presence count per slot of the key grid (the kernel,
``csrc/seg_coalesce.cu``), then compacts the present slots in flat order,
which is the sorted (src, dst) order (``emit_coalesced``).

Every function here takes a batch: B tenants' relabeled slabs
``[B, ne_pad]``, keyed by (tenant, src, dst) into a ``[B, grid, grid]``
accumulator pair, each tenant compacted into its own slab prefix.  One
slab is a batch of one with ``grid = nv_pad`` (``ops/segment.
coalesced_runs``).  The batched engine (``louvain/batched.py``) runs the
kernel on a whole batch in one launch; the reference never runs its
kernel on a batch (a Pallas grid does not lift over ``vmap``), and its
batched coarsening takes the XLA twin, which gives the same rows.

Differences from the reference, by design:

- The weight accumulator is float64 and is rounded to float32 once, at
  the emission; the reference accumulates in the weight dtype.  So the
  dense engine equals the sort engine (``ops/segment.coalesced_runs``,
  which also sums each run in f64) wherever the f64 run sums are exact,
  and the reference's f32 accumulator on unit and dyadic weights.
- The dense engine is the default for every class with
  ``nv_pad <= DEFAULT_MAX_NV``; the reference defaults to its sort
  engine, because on its CPU backend the sort was faster and its dense
  engines waited for a TPU measurement.  Both engines sum in f64 here,
  so the port needs no ds32 rule (the reference sends ds32 accumulators
  to the sort), and the kernel is on by default on CUDA as the heavy
  kernel is.  ``PERF.md`` holds the card's times of both engines on the
  same slab; ``CUVITE_SEG_COALESCE=sort`` pins the sort for comparisons.
- The compaction takes the present slots with ``nonzero`` (a device scan)
  instead of the reference's cumsum and drop-scatter.

``seg_coalesce`` launches the kernel for CUDA tensors and runs
``seg_coalesce_plain`` only for CPU tensors.  Not ported: the reference's
``hash`` engine (``:335-427``).

Memory bound of a batch: ``grid`` is the phase's largest community
count rounded up to a power of two, which the host holds after the
renumber, not the class's nv_pad -- a [64, 4096, 4096] pair would be
12.9 GB -- and :func:`batched_coalesce_engine` sends a coarsening whose
``B * grid^2`` exceeds ``DENSE_BATCH_MAX_SLOTS`` to the sort engine.
"""

from __future__ import annotations

import ctypes
import os

import torch

from cuvite_tpu_torch.kernels import _build

# Widest slab class the dense engine takes by default: a [4096, 4096]
# f64 + i32 accumulator pair is 192 MiB.
DEFAULT_MAX_NV = 4096
# Ceiling of the dense key grid (reference ``:94``): nv_pad^2 <= 2^30
# slots, an 8 GiB f64 accumulator.  ``CUVITE_SEG_COALESCE_MAX_NV`` may not
# exceed it.
FLAT_NV_MAX = 1 << 15

# Most slots of the batched form's key grid, B * grid^2: 2^27 slots are
# 1.5 GiB of f64 + i32 accumulators.  Past it the coarsening sorts.
DENSE_BATCH_MAX_SLOTS = 1 << 27

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = {
    "cv_seg_coalesce": ([_P, _P, _P, _I, _L, _I, _P, _P, _P], _I),
}


def _max_nv() -> int:
    """``CUVITE_SEG_COALESCE_MAX_NV`` (default ``DEFAULT_MAX_NV``): the
    widest nv_pad the dense engine takes.  Read per call."""
    raw = os.environ.get("CUVITE_SEG_COALESCE_MAX_NV", "")
    if not raw:
        return DEFAULT_MAX_NV
    try:
        v = int(raw, 0)
    except ValueError:
        v = 0
    if not 1 <= v <= FLAT_NV_MAX:
        raise ValueError(f"CUVITE_SEG_COALESCE_MAX_NV={raw!r}: want an "
                         f"integer in 1..{FLAT_NV_MAX}")
    return v


def coalesce_engine(nv_pad: int) -> str:
    """The coalesce engine of one slab class: ``'dense'`` when nv_pad is
    at most ``CUVITE_SEG_COALESCE_MAX_NV``, else ``'sort'``.
    ``CUVITE_SEG_COALESCE``: unset, empty or ``dense`` for that policy;
    ``sort`` pins the sort for every class.  Read per call, so a toggle
    takes effect at the next phase."""
    mode = os.environ.get("CUVITE_SEG_COALESCE", "").strip().lower()
    if mode == "sort":
        return "sort"
    if mode not in ("", "dense"):
        raise ValueError(f"CUVITE_SEG_COALESCE={mode!r}: the port has "
                         "'dense' (default) and 'sort'; the reference's "
                         "'msd' and 'hash' engines are not ported "
                         "(ROADMAP.md)")
    return "dense" if nv_pad <= _max_nv() else "sort"


def batched_coalesce_engine(nv_pad: int, n_tenants: int, grid: int) -> str:
    """The engine of one batched coarsening: ``coalesce_engine(nv_pad)``
    of the slab class, and ``'sort'`` when the dense form's
    ``n_tenants * grid^2`` key grid exceeds ``DENSE_BATCH_MAX_SLOTS``."""
    if coalesce_engine(nv_pad) != "dense":
        return "sort"
    return "dense" if n_tenants * grid * grid <= DENSE_BATCH_MAX_SLOTS \
        else "sort"


def _kbits(grid: int) -> int:
    if grid < 1 or grid & (grid - 1):
        raise ValueError(f"seg_coalesce: grid = {grid} is not a power of "
                         "two")
    if grid > FLAT_NV_MAX:
        raise ValueError(f"seg_coalesce: grid = {grid} over FLAT_NV_MAX = "
                         f"{FLAT_NV_MAX}: the dense key grid would exceed "
                         "2^30 slots a tenant; coalesce_engine sends this "
                         "class to 'sort'")
    return (grid - 1).bit_length()


def _validate(src, dst, w, grid: int) -> int:
    kbits = _kbits(grid)
    for name, t, dt in (("src", src, torch.int32), ("dst", dst, torch.int32),
                        ("w", w, torch.float32)):
        if t.device != src.device:
            raise ValueError(f"seg_coalesce: {name} is on {t.device}, src "
                             f"on {src.device}")
        if t.dtype != dt or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"seg_coalesce: {name} must be a contiguous "
                             f"[B, ne] {dt} tensor, got {t.dim()}-d "
                             f"{t.dtype}")
    if not src.shape == dst.shape == w.shape or src.shape[0] < 1:
        raise ValueError(f"seg_coalesce: shapes src {tuple(src.shape)}, dst "
                         f"{tuple(dst.shape)}, w {tuple(w.shape)}")
    return kbits


def seg_coalesce(src, dst, w, *, grid: int):
    """Dense accumulators of B relabeled slabs in one launch.

    src, dst [B, ne] int32 (rows with src or dst outside [0, grid) drop;
    padding rows carry src == the class's nv_pad >= grid); w [B, ne] f32.
    Returns (acc [B, grid, grid] f64 weight sums, cnt [B, grid, grid]
    int32 row counts); feed :func:`emit_coalesced`."""
    _validate(src, dst, w, grid)
    if src.device.type == "cpu":
        return seg_coalesce_plain(src, dst, w, grid=grid)
    if src.device.type != "cuda":
        raise ValueError(f"seg_coalesce: no kernel for device {src.device}")
    b, ne = src.shape
    acc = torch.empty((b, grid, grid), dtype=torch.float64,
                      device=src.device)
    cnt = torch.empty((b, grid, grid), dtype=torch.int32, device=src.device)
    lib = _build.library("seg_coalesce", _SIGNATURE)
    err = lib.cv_seg_coalesce(
        src.data_ptr(), dst.data_ptr(), w.data_ptr(), b, ne, grid,
        acc.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, "seg_coalesce")
    seg_coalesce.launches += 1
    return acc, cnt


seg_coalesce.launches = 0


def seg_coalesce_plain(src, dst, w, *, grid: int):
    """Plain PyTorch twin of :func:`seg_coalesce` (same signature and
    results): the reference's ``seg_coalesce_xla``, two ``index_add_``
    over the flat [B * grid^2] key domain plus one drop slot."""
    kbits = _validate(src, dst, w, grid)
    b = src.shape[0]
    n = b * grid * grid
    s, d = src.long(), dst.long()
    tenant = torch.arange(b, device=src.device)[:, None]
    real = (s >= 0) & (s < grid) & (d >= 0) & (d < grid)
    flat = torch.where(real, (((tenant << kbits) | s) << kbits) | d, n)
    acc = torch.zeros(n + 1, dtype=torch.float64, device=src.device)
    acc.index_add_(0, flat.reshape(-1),
                   torch.where(real, w, 0.0).double().reshape(-1))
    cnt = torch.zeros(n + 1, dtype=torch.int32, device=src.device)
    cnt.index_add_(0, flat.reshape(-1), real.int().reshape(-1))
    return (acc[:n].view(b, grid, grid), cnt[:n].view(b, grid, grid))


def emit_coalesced(acc, cnt, *, ne_pad: int, nv_pad: int,
                   w_dtype=torch.float32):
    """Compact B tenants' dense accumulators, each into its own slab
    prefix, in one pass.

    A slot is a row when its count is > 0 -- by presence, never by weight,
    so a zero-weight real edge is a row.  Ascending flat order is each
    tenant's sorted (src, dst) order.  Returns (src2, dst2, w2
    [B, ne_pad], ne2 [B] int64 tensor): tenant b's rows in [0, ne2[b]),
    padding (src == ``nv_pad``, dst == 0, w == 0) after."""
    from cuvite_tpu_torch.ops.segment import compact_batched

    b, grid, _ = acc.shape
    kbits = _kbits(grid)
    flat = torch.nonzero(cnt.reshape(-1) > 0).squeeze(1)
    return compact_batched(
        flat >> (2 * kbits), (flat >> kbits) & (grid - 1), flat & (grid - 1),
        acc.reshape(-1)[flat].to(w_dtype), n_tenants=b, ne_pad=ne_pad,
        nv_pad=nv_pad)


def coalesce_slabs(src, dst, w, *, nv_pad: int, grid: int):
    """One dense coalesce of B slabs: accumulate (kernel on the card, twin
    on the CPU) and emit.  Same contract as
    ``ops/segment.coalesced_runs_batched``."""
    acc, cnt = seg_coalesce(src, dst, w, grid=grid)
    return emit_coalesced(acc, cnt, ne_pad=src.shape[1], nv_pad=nv_pad,
                          w_dtype=w.dtype)
