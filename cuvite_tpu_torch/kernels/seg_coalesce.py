"""Segmented coalesce of a relabeled edge slab: the CUDA kernel wrapper,
its plain PyTorch twin, the compaction and the engine policy.

Replaces ``seg_coalesce_pallas`` (``cuvite_tpu/kernels/seg_coalesce.py:202``)
and follows that module's ``seg_coalesce_xla`` (``:246``),
``emit_coalesced`` (``:272``), ``coalesce_slab`` (``:299``) and
``coalesce_engine`` (``:106``).  The device coarsening must turn the
relabeled slab (dense ids < nv_pad, padding src == nv_pad) into one row per
distinct (src, dst), in ascending order, compacted into the slab prefix,
duplicate weights summed.  The dense engine accumulates a weight sum and a
presence count per slot of the [nv_pad, nv_pad] key grid (the kernel,
``csrc/seg_coalesce.cu``), then compacts the present slots in flat order,
which is the sorted (src, dst) order (``emit_coalesced``).

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
  instead of the reference's cumsum and drop-scatter, and returns the row
  count as a Python int.

``seg_coalesce`` launches the kernel for CUDA tensors and runs
``seg_coalesce_plain`` only for CPU tensors.  Not ported: the reference's
``hash`` engine (``:335-427``).
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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = {"cv_seg_coalesce": ([_P, _P, _P, _L, _I, _P, _P, _P], _I)}


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


def _kbits(nv_pad: int) -> int:
    if nv_pad < 1 or nv_pad & (nv_pad - 1):
        raise ValueError(f"seg_coalesce: nv_pad = {nv_pad} is not a power "
                         "of two")
    if nv_pad > FLAT_NV_MAX:
        raise ValueError(f"seg_coalesce: nv_pad = {nv_pad} over FLAT_NV_MAX "
                         f"= {FLAT_NV_MAX}: the dense key grid would exceed "
                         "2^30 slots; coalesce_engine sends this class to "
                         "'sort'")
    return (nv_pad - 1).bit_length()


def _validate(src, dst, w, nv_pad: int) -> int:
    kbits = _kbits(nv_pad)
    for name, t, dt in (("src", src, torch.int32), ("dst", dst, torch.int32),
                        ("w", w, torch.float32)):
        if t.device != src.device:
            raise ValueError(f"seg_coalesce: {name} is on {t.device}, src "
                             f"on {src.device}")
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"seg_coalesce: {name} must be a contiguous "
                             f"1-d {dt} tensor, got {t.dim()}-d {t.dtype}")
    if not src.shape == dst.shape == w.shape:
        raise ValueError(f"seg_coalesce: shapes src {tuple(src.shape)}, dst "
                         f"{tuple(dst.shape)}, w {tuple(w.shape)}")
    return kbits


def seg_coalesce(src, dst, w, *, nv_pad: int):
    """Dense accumulators of a relabeled slab.

    src, dst [ne] int32 ids (rows with src or dst outside [0, nv_pad)
    drop: padding rows carry src == nv_pad); w [ne] f32.  Returns
    (acc [nv_pad, nv_pad] f64 weight sums, cnt [nv_pad, nv_pad] int32 row
    counts); feed :func:`emit_coalesced`."""
    _validate(src, dst, w, nv_pad)
    if src.device.type == "cpu":
        return seg_coalesce_plain(src, dst, w, nv_pad=nv_pad)
    if src.device.type != "cuda":
        raise ValueError(f"seg_coalesce: no kernel for device {src.device}")
    acc = torch.empty((nv_pad, nv_pad), dtype=torch.float64,
                      device=src.device)
    cnt = torch.empty((nv_pad, nv_pad), dtype=torch.int32, device=src.device)
    lib = _build.library("seg_coalesce", _SIGNATURE)
    err = lib.cv_seg_coalesce(
        src.data_ptr(), dst.data_ptr(), w.data_ptr(), src.numel(), nv_pad,
        acc.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, "seg_coalesce")
    seg_coalesce.launches += 1
    return acc, cnt


seg_coalesce.launches = 0


def seg_coalesce_plain(src, dst, w, *, nv_pad: int):
    """Plain PyTorch twin of :func:`seg_coalesce` (same signature and
    results): the reference's ``seg_coalesce_xla``, two ``index_add_`` over
    the flat [nv_pad^2] key domain plus one drop slot."""
    kbits = _validate(src, dst, w, nv_pad)
    n = nv_pad * nv_pad
    s, d = src.long(), dst.long()
    real = (s >= 0) & (s < nv_pad) & (d >= 0) & (d < nv_pad)
    flat = torch.where(real, (s << kbits) | d, n)
    acc = torch.zeros(n + 1, dtype=torch.float64, device=src.device)
    acc.index_add_(0, flat, torch.where(real, w, 0.0).double())
    cnt = torch.zeros(n + 1, dtype=torch.int32, device=src.device)
    cnt.index_add_(0, flat, real.int())
    return acc[:n].view(nv_pad, nv_pad), cnt[:n].view(nv_pad, nv_pad)


def emit_coalesced(acc, cnt, *, ne_pad: int, w_dtype=torch.float32):
    """Compact the dense accumulators into the coalesced slab prefix.

    A slot is a row when its count is > 0 -- by presence, never by weight,
    so a zero-weight real edge is a row.  Ascending flat order is the
    sorted (src, dst) order.  Returns (src2, dst2, w2, ne2): [ne_pad]
    int32/int32/``w_dtype`` arrays with the rows in [0, ne2), padding
    (src == nv_pad, dst == 0, w == 0) after, and ``ne2`` a Python int."""
    nv_pad = acc.shape[0]
    kbits = _kbits(nv_pad)
    flat = torch.nonzero(cnt.reshape(-1) > 0).squeeze(1)
    ne2 = int(flat.numel())
    if ne2 > ne_pad:
        raise ValueError(f"emit_coalesced: {ne2} rows do not fit {ne_pad}")
    dev = acc.device
    src2 = torch.full((ne_pad,), nv_pad, dtype=torch.int32, device=dev)
    dst2 = torch.zeros(ne_pad, dtype=torch.int32, device=dev)
    w2 = torch.zeros(ne_pad, dtype=w_dtype, device=dev)
    src2[:ne2] = flat >> kbits
    dst2[:ne2] = flat & (nv_pad - 1)
    w2[:ne2] = acc.reshape(-1)[flat].to(w_dtype)
    return src2, dst2, w2, ne2


def coalesce_slab(src, dst, w, *, nv_pad: int):
    """One dense segmented coalesce: accumulate (kernel on the card, twin
    on the CPU) and emit.  Same contract as ``coalesced_runs``."""
    acc, cnt = seg_coalesce(src, dst, w, nv_pad=nv_pad)
    return emit_coalesced(acc, cnt, ne_pad=src.shape[0], w_dtype=w.dtype)
