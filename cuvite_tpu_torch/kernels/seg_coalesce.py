"""Segmented coalesce of relabeled edge slabs: the CUDA pipeline's
wrapper, its plain PyTorch twin and the engine policy.

Replaces ``seg_coalesce_pallas`` (``cuvite_tpu/kernels/seg_coalesce.py:202``)
with its emission ``emit_coalesced`` (``:272``), and follows that module's
``seg_coalesce_xla`` (``:246``), ``coalesce_slab`` (``:299``) and
``coalesce_engine`` (``:106``).  The device coarsening must turn the
relabeled slab (dense ids < nv_pad, padding src == nv_pad) into one row per
distinct (src, dst), in ascending order, compacted into the slab prefix,
duplicate weights summed.

Every function here takes a batch: B tenants' relabeled slabs
``[B, ne_pad]``, each tenant coalesced into its own slab prefix; real ids
are below ``grid``.  One slab is a batch of one with ``grid = nv_pad``
(``ops/segment.coalesced_runs``).  The batched engine
(``louvain/batched.py``) runs the pipeline on a whole batch at once; the
reference never runs its kernel on a batch (a Pallas grid does not lift
over ``vmap``), and its batched coarsening takes the XLA twin, which gives
the same rows.

On the card :func:`seg_coalesce` runs the pipeline of
``csrc/seg_coalesce.cu``: rows counted and scattered into (tenant, src)
buckets, each bucket deduplicated by dst in registers or shared memory,
the distinct rows placed by a scan -- work proportional to the rows plus
B * grid counters, no [B, grid, grid] key grid, no host sync between the
launch and the return.  Its twin :func:`seg_coalesce_plain` is the
reference's dense form: a weight sum and a presence count per slot of the
[B, grid, grid] key grid (:func:`dense_accumulate_plain`), then the
present slots compacted in flat order, which is the sorted (src, dst)
order (:func:`emit_coalesced`).

Differences from the reference, by design:

- Weights are summed in float64 and rounded to float32 once; the
  reference accumulates in the weight dtype.  So the dense engine equals
  the sort engine (``ops/segment.coalesced_runs``, which also sums each run
  in f64) wherever the f64 run sums are exact, and the reference's f32
  accumulator on unit and dyadic weights.
- The dense engine is the default for every class with
  ``nv_pad <= DEFAULT_MAX_NV``; the reference defaults to its sort
  engine, because on its CPU backend the sort was faster and its dense
  engines waited for a TPU measurement.  Both engines sum in f64 here,
  so the port needs no ds32 rule (the reference sends ds32 accumulators
  to the sort).  ``PERF.md`` holds the card's times of both engines on the
  same slab; ``CUVITE_SEG_COALESCE=sort`` pins the sort for comparisons.

``seg_coalesce`` launches the pipeline for CUDA tensors and runs
``seg_coalesce_plain`` only for CPU tensors.

The reference's big-class engines are here too, as it has them: plain
code outside any kernel.  ``msd`` (``ops/segment.sort_edges_msd``) sorts
the slab in two stable int32 passes; ``hash`` (``:335-427``) sums each
src's rows into ``hash_slots`` slots of a [nv_pad * K] table in one
scatter pass (:func:`hash_accumulate`) and emits the rows in order from
the table with an O(K^2) rank a src (:func:`hash_emit`).  A slot that
two distinct dst hash to cannot emit: the coalesce reads one collision
flag on the host and then runs either the msd tail or the emission
(``ops/segment.coalesced_runs_batched``), where the reference branches
on the device inside ``lax.cond``.  The tables sum in f64 and round
once, the port's rule, where the reference sums in the weight dtype.

The routing caps ``DEFAULT_MAX_NV`` and ``DENSE_BATCH_MAX_SLOTS`` were
set by the memory of the key grid the first CUDA form accumulated; the
pipeline needs no grid, so they now stand as routing choices that wait
for a measurement of both engines above them (``PERF.md``).  In a batch
``grid`` is the phase's largest community count rounded up to a power of
two, which the host holds after the renumber, not the class's nv_pad.
"""

from __future__ import annotations

import ctypes
import os
import warnings

import torch

from cuvite_tpu_torch.kernels import _build
from cuvite_tpu_torch.utils.envknob import env_int

# Widest slab class the dense engine takes by default.  A routing
# choice: the first CUDA form's [4096, 4096] accumulator pair (192 MiB)
# set it; the pipeline holds no such grid.
DEFAULT_MAX_NV = 4096
# Ceiling of the dense engine's ids (reference ``:94``): the twin's key
# grid is nv_pad^2 <= 2^30 slots.  ``CUVITE_SEG_COALESCE_MAX_NV`` may not
# exceed it.
FLAT_NV_MAX = 1 << 15

# Most B * grid^2 of a batched coarsening the dense engine takes; past it
# the coarsening sorts.  A routing choice, like DEFAULT_MAX_NV: the first
# CUDA form's 1.5 GiB of accumulators at 2^27 slots set it.
DENSE_BATCH_MAX_SLOTS = 1 << 27

# Most rows (B * ne_pad) and buckets (B * grid) of one launch: the
# pipeline indexes both with int32.
LAUNCH_MAX = 1 << 30

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = {
    "cv_seg_coalesce": ([_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                         _P], _I),
    "cv_seg_coalesce_scratch_bytes": ([_I, _I, _I], _L),
}


def _max_nv() -> int:
    """``CUVITE_SEG_COALESCE_MAX_NV`` (default ``DEFAULT_MAX_NV``, at most
    ``FLAT_NV_MAX``): the widest nv_pad the dense engine takes.  Read per
    call; a malformed value warns and keeps the default."""
    return env_int("CUVITE_SEG_COALESCE_MAX_NV", DEFAULT_MAX_NV,
                   maximum=FLAT_NV_MAX)


_DENSE_WORDS = ("", "1", "true", "dense", "xla", "pallas")


def coalesce_engine(nv_pad: int) -> str:
    """The coalesce engine of one slab class, from ``CUVITE_SEG_COALESCE``
    (reference ``:106-165``).  Unset, empty, ``1``, ``true``, ``dense``,
    ``xla`` or ``pallas``: the port's dense policy, ``'dense'`` when
    nv_pad is at most ``CUVITE_SEG_COALESCE_MAX_NV``, else ``'sort'``;
    ``0``, ``false`` or ``sort``: ``'sort'`` for every class; ``msd`` and
    ``hash``: those engines for every class.  Any other word warns and
    keeps the default.  Read per call, so a toggle takes effect at the
    next phase."""
    mode = os.environ.get("CUVITE_SEG_COALESCE", "").strip().lower()
    if mode in ("0", "false", "sort"):
        return "sort"
    if mode in ("msd", "hash"):
        return mode
    if mode not in _DENSE_WORDS:
        warnings.warn(
            f"unrecognized CUVITE_SEG_COALESCE={mode!r} (want sort/0, "
            "dense/xla/pallas/1, msd or hash); using the default dense "
            "policy", stacklevel=2)
    return "dense" if nv_pad <= _max_nv() else "sort"


def batched_coalesce_engine(nv_pad: int, n_tenants: int, grid: int) -> str:
    """The engine of one batched coarsening: ``coalesce_engine(nv_pad)``
    of the slab class, ``'hash'`` sent to ``'msd'`` (reference
    ``louvain/batched.py:408-421``: the collision retry is per slab), and
    ``'sort'`` for a dense class whose ``n_tenants * grid^2`` exceeds
    ``DENSE_BATCH_MAX_SLOTS``."""
    eng = coalesce_engine(nv_pad)
    if eng == "hash":
        return "msd"
    if eng != "dense":
        return eng
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


def seg_coalesce(src, dst, w, *, nv_pad: int, grid: int):
    """Coalesce B relabeled slabs: the pipeline of ``csrc/seg_coalesce.cu``
    on the card, :func:`seg_coalesce_plain` on the CPU.

    src, dst [B, ne] int32 (rows with src or dst outside [0, grid) drop;
    padding rows carry src == the class's nv_pad >= grid); w [B, ne] f32.
    Returns (src_c, dst_c, w_c [B, ne], n [B] int64), all on the device:
    tenant b's distinct (src, dst) ascending in [0, n[b]), weights summed
    in f64 and rounded once, a row by presence (never by weight); padding
    (src == ``nv_pad``, dst == 0, w == 0) after.  Nothing is read back to
    the host."""
    _validate(src, dst, w, grid)
    if src.device.type == "cpu":
        return seg_coalesce_plain(src, dst, w, nv_pad=nv_pad, grid=grid)
    if src.device.type != "cuda":
        raise ValueError(f"seg_coalesce: no kernel for device {src.device}")
    b, ne = src.shape
    if b * ne > LAUNCH_MAX or b * grid > LAUNCH_MAX:
        raise ValueError(f"seg_coalesce: {b} x {ne} rows or {b} x {grid} "
                         f"buckets over LAUNCH_MAX = {LAUNCH_MAX}")
    dev = src.device
    out = torch.empty((3, b, ne), dtype=torch.int32, device=dev)
    src_c, dst_c, w_c = out[0], out[1], out[2].view(torch.float32)
    n = torch.empty(b, dtype=torch.int64, device=dev)
    lib = _build.library("seg_coalesce", _SIGNATURE)
    scratch = torch.empty(lib.cv_seg_coalesce_scratch_bytes(b, ne, grid),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):   # launch on the tensors' card
        err = lib.cv_seg_coalesce(
            src.data_ptr(), dst.data_ptr(), w.data_ptr(), b, ne, grid,
            nv_pad, src_c.data_ptr(), dst_c.data_ptr(), w_c.data_ptr(),
            n.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "seg_coalesce")
    if b * ne:
        # The dense dedup tier runs once the rows outnumber a warp
        # table's cap (WCAP = 2048 up to grid WTABLE_MAX = 1024, else 32).
        cap = 2048 if grid <= 1024 else 32
        _build.note_form("seg_coalesce",
                         "pipeline+dense" if b * ne > cap else "pipeline",
                         dev)
    seg_coalesce.launches += 1
    return src_c, dst_c, w_c, n


seg_coalesce.launches = 0


def seg_coalesce_plain(src, dst, w, *, nv_pad: int, grid: int):
    """Plain PyTorch twin of :func:`seg_coalesce` (same signature and
    results): the reference's ``seg_coalesce_xla`` and
    ``emit_coalesced``, over the [B, grid, grid] key grid."""
    acc, cnt = dense_accumulate_plain(src, dst, w, grid=grid)
    return emit_coalesced(acc, cnt, ne_pad=src.shape[1], nv_pad=nv_pad,
                          w_dtype=w.dtype)


def dense_accumulate_plain(src, dst, w, *, grid: int):
    """The twin's accumulate step, the reference's ``seg_coalesce_xla``:
    two ``index_add_`` over the flat [B * grid^2] key domain plus one drop
    slot.  Returns (acc [B, grid, grid] f64 weight sums, cnt [B, grid,
    grid] int32 row counts)."""
    kbits = _validate(src, dst, w, grid)
    b = src.shape[0]
    n = b * grid * grid
    s, d = src.long(), dst.long()
    tenant = torch.arange(b, device=src.device)[:, None]
    real = (s >= 0) & (s < grid) & (d >= 0) & (d < grid)
    flat = torch.where(real, (((tenant << kbits) | s) << kbits) | d, n)
    acc = torch.zeros(n + 1, dtype=torch.float64, device=src.device)  # graftlint: disable=R003 — the plain twin's weight sums in f64: the H100 sums in real f64
    acc.index_add_(0, flat.reshape(-1),
                   torch.where(real, w, 0.0).double().reshape(-1))
    cnt = torch.zeros(n + 1, dtype=torch.int32, device=src.device)
    cnt.index_add_(0, flat.reshape(-1), real.int().reshape(-1))
    return (acc[:n].view(b, grid, grid), cnt[:n].view(b, grid, grid))


def emit_coalesced(acc, cnt, *, ne_pad: int, nv_pad: int,
                   w_dtype=torch.float32):
    """Compact B tenants' dense accumulators, each into its own slab
    prefix (the reference's ``emit_coalesced``, under a batch axis).

    A slot is a row when its count is > 0 -- by presence, never by weight,
    so a zero-weight real edge is a row.  Ascending flat order is each
    tenant's sorted (src, dst) order: a slot's place is the cumsum of the
    presence before it, and absent slots aim at one dropped slot past the
    end.  Returns (src2, dst2, w2 [B, ne_pad], ne2 [B] int64 tensor):
    tenant b's rows in [0, ne2[b]), padding (src == ``nv_pad``, dst == 0,
    w == 0) after."""
    b, grid, _ = acc.shape
    kbits = _kbits(grid)
    dev = acc.device
    present = (cnt > 0).reshape(b, grid * grid)
    size = b * ne_pad
    slot = torch.cumsum(present, 1)
    slot += torch.arange(b, device=dev)[:, None] * ne_pad - 1
    slot = slot.masked_fill_(~present, size).reshape(-1)
    key = torch.arange(grid * grid, dtype=torch.int32, device=dev)
    src2 = torch.full((size + 1,), nv_pad, dtype=torch.int32, device=dev)
    dst2 = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    w2 = torch.zeros(size + 1, dtype=w_dtype, device=dev)
    src2.index_copy_(0, slot, (key >> kbits).repeat(b))
    dst2.index_copy_(0, slot, (key & (grid - 1)).repeat(b))
    w2.index_copy_(0, slot, acc.reshape(-1).to(w_dtype))
    shape = (b, ne_pad)
    return (src2[:size].view(shape), dst2[:size].view(shape),
            w2[:size].view(shape), present.sum(1))


# ---------------------------------------------------------------------------
# The hash-slot engine (reference ``:318-427``): K slots a src, a
# [nv_pad * K] table instead of the dense [nv_pad^2] key grid.

# The flat index src * K + slot and the emission's cumsum count table
# slots: nv_pad * K stays <= 2^30.  hash_emit's [nv_pad, K, K] rank
# transient keeps nv_pad * K^2 <= 2^28.
HASH_TABLE_MAX = 1 << 30
HASH_RANK_MAX = 1 << 28
_HASH_MULT = 2654435761   # Knuth's 2^32 / phi

# Hash coalescings since the last zero_hash_stats(): coalescings, the
# collisions among them (each retried on the msd tail) and the host reads
# they made (one each: the collision flag).
HASH_STATS = {"coalescings": 0, "collisions": 0, "host_reads": 0}


def zero_hash_stats() -> None:
    for k in HASH_STATS:
        HASH_STATS[k] = 0


def hash_slots(nv_pad: int, ne_pad: int) -> int:
    """The slot count a src of one slab class, as the reference's: a
    power of two from the class's mean degree (4x headroom), at least 16
    and at most nv_pad, halved until the table and rank budgets hold.
    ``CUVITE_HASH_SLOTS`` (0 to 4096) overrides, rounded up to a power of
    two and held to the same budgets."""
    k = env_int("CUVITE_HASH_SLOTS", 0, minimum=0, maximum=1 << 12)
    if k <= 0:
        avg = max(ne_pad // max(nv_pad, 1), 1)
        k = min(nv_pad, max(16, 4 * avg))
    k = 1 << max(int(k - 1).bit_length(), 0)
    while k > 1 and (nv_pad * k > HASH_TABLE_MAX
                     or nv_pad * k * k > HASH_RANK_MAX):
        k >>= 1
    return k


def hash_slot_of(dst: torch.Tensor, k: int) -> torch.Tensor:
    """Each dst's slot in [0, k): ``(dst * _HASH_MULT mod 2^32) >> (32 -
    log2 k)``, the reference's uint32 product computed in int64 (dst <
    2^31, so the product stays below 2^63).  Returns int64."""
    if k == 1:
        return torch.zeros_like(dst, dtype=torch.int64)
    log2k = (k - 1).bit_length()
    return ((dst.long() * _HASH_MULT) & 0xFFFFFFFF) >> (32 - log2k)


def hash_accumulate(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                    *, nv_pad: int, k: int) -> tuple:
    """One scatter pass over the [nv_pad * k] slot table: ``src``/``dst``
    [ne] ids below nv_pad (padding src == nv_pad, w == 0).  Returns flat
    [nv_pad * k] tables (wsum f64, cnt int32, dmin int32, dmax int32):
    the weight sum, the row count and the least and greatest dst of each
    slot, equal where the slot holds one dst."""
    if k & (k - 1):
        raise ValueError(f"hash_accumulate: k = {k} is not a power of two")
    size = nv_pad * k
    real = src < nv_pad
    flat = torch.where(real, src.long() * k + hash_slot_of(dst, k), size)
    d32 = dst.to(torch.int32)
    dev = src.device
    wsum = torch.zeros(size + 1, dtype=torch.float64, device=dev)  # graftlint: disable=R003 — the hash engine's weight sums in f64: the H100 sums in real f64
    wsum.index_add_(0, flat, torch.where(real, w, 0.0).double())
    cnt = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, flat, real.to(torch.int32))
    dmin = torch.full((size + 1,), nv_pad, dtype=torch.int32, device=dev)
    dmin.scatter_reduce_(0, flat, torch.where(real, d32, nv_pad), "amin")
    dmax = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    dmax.scatter_reduce_(0, flat, torch.where(real, d32, 0), "amax")
    return wsum[:size], cnt[:size], dmin[:size], dmax[:size]


def hash_emit(wsum: torch.Tensor, cnt: torch.Tensor, dmin: torch.Tensor, *,
              nv_pad: int, ne_pad: int, k: int,
              w_dtype=torch.float32) -> tuple:
    """Compact a collision-free slot table into the coalesced slab prefix,
    rows in ascending (src, dst) order (reference ``hash_emit``).  Within
    a src the occupied slots hold distinct dst, so their order comes from
    an O(k^2) rank, empty slots (dst nv_pad) after every real one and
    ties broken by slot.  Returns (src_c, ckey_c int32, w_c [ne_pad], n
    0-dim int64), the f64 sums rounded once to ``w_dtype``."""
    dev = wsum.device
    occ = (cnt > 0).view(nv_pad, k)
    dst_t = torch.where(occ, dmin.view(nv_pad, k), nv_pad)
    w_t = torch.where(occ, wsum.view(nv_pad, k), 0.0)
    sl = torch.arange(k, device=dev)
    before = (dst_t[:, :, None] > dst_t[:, None, :]) | (
        (dst_t[:, :, None] == dst_t[:, None, :])
        & (sl[None, :, None] > sl[None, None, :]))
    rank = before.sum(2)
    del before
    flat_d = torch.full((nv_pad, k), nv_pad, dtype=torch.int32,
                        device=dev).scatter_(1, rank, dst_t).view(-1)
    flat_w = torch.zeros((nv_pad, k), dtype=torch.float64,  # graftlint: disable=R003 — the hash engine's weight sums in f64: the H100 sums in real f64
                         device=dev).scatter_(1, rank, w_t).view(-1)
    present = flat_d < nv_pad
    pos = torch.cumsum(present, 0) - 1
    slot = torch.where(present, pos, ne_pad)
    srcs = torch.arange(nv_pad, dtype=torch.int32,
                        device=dev).repeat_interleave(k)
    src_c = torch.full((ne_pad + 1,), nv_pad, dtype=torch.int32, device=dev)
    ckey_c = torch.zeros(ne_pad + 1, dtype=torch.int32, device=dev)
    w_c = torch.zeros(ne_pad + 1, dtype=w_dtype, device=dev)
    src_c.index_copy_(0, slot, srcs)
    ckey_c.index_copy_(0, slot, flat_d)
    w_c.index_copy_(0, slot, flat_w.to(w_dtype))
    return src_c[:ne_pad], ckey_c[:ne_pad], w_c[:ne_pad], present.sum()
