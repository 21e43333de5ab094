"""Segment reductions, the packed (src, key) sort, segmented coalesce and
the in-loop modularity (port of ``cuvite_tpu/ops/segment.py``).

Segments are torch ``index_add_`` / ``scatter_reduce_`` over a leading
axis.  Every float segment sum that feeds a label decision runs in float64
and is rounded once to float32, where the reference sums in float32 (or
double-single pairs, its ``ds32`` mode): an H100 has f64, so the port needs
no ds32 mode.  On CUDA ``index_add_`` adds with atomics in an order that
changes from run to run; in f64 a sum of f32 addends is exact, and so
independent of order, whenever the addends lie within ~29 bits of each
other, so card and CPU agree after the one rounding.  On the exactness
domain (unit and dyadic weights) the rounded sums equal the reference's
f32 sums bit for bit.  ``modularity_terms`` accumulates in f64 too.

``sort_edges_by_vertex_comm`` always packs ``(src << kbits) | key`` into an
int64 key (torch has int64 everywhere, so the reference's int32 packing and
two-operand variadic fallback have no use) and sorts it with a stable
``torch.sort``.  ``sort_edges_msd`` is the reference's big-class sort: two
stable int32 passes where the packed key needs more than 31 bits.

``coalesced_runs_batched`` coalesces B tenants' slabs ``[B, ne_pad]`` in
one pass, each tenant compacted into its own slab prefix, by one of four
engines: ``sort`` (one packed-key sort keyed by (tenant, src, key)),
``msd`` (the same order from ``sort_edges_msd``), ``dense`` (one
``seg_coalesce`` pipeline) and, for one slab, ``hash``
(``kernels/seg_coalesce.hash_accumulate``, one counted host read of its
collision flag).  One slab's ``coalesced_runs`` is a batch of one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuvite_tpu_torch.utils.trace import NullTracer

# Widest edge slab one call may carry (reference ``:75``).  The port's
# run ids and compaction counts are int64 and cannot wrap, but the guard
# keeps the reference's contract: a larger slab is a caller error.
SLAB_NE_MAX = 1 << 30


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_sum_drop(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """``segment_sum`` where ids equal to ``num_segments`` (the padding
    sentinel) are dropped, as ``jax.ops.segment_sum`` drops them."""
    return segment_sum(data, segment_ids, num_segments + 1)[:num_segments]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; empty segments hold the dtype's lowest value
    (-inf for floats), as ``jax.ops.segment_max`` does."""
    low = (float("-inf") if data.dtype.is_floating_point
           else torch.iinfo(data.dtype).min)
    out = torch.full((num_segments,), low, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, segment_ids.long(), data, "amax")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment min; empty segments hold the dtype's largest value."""
    high = (float("inf") if data.dtype.is_floating_point
            else torch.iinfo(data.dtype).max)
    out = torch.full((num_segments,), high, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, segment_ids.long(), data, "amin")


class TenantConstants(NamedTuple):
    """The 1/(2m) of every tenant of a folded batch (tenant b's vertex v
    is b * nv_pad + v): the float32 value the gains use, the float64 value
    Q uses.  One graph is a batch of one (:meth:`of`)."""

    c32: torch.Tensor   # [B] f32
    c64: torch.Tensor   # [B] f64

    @staticmethod
    def of(constant, device) -> "TenantConstants":
        """``constant`` as given when it is a ``TenantConstants``; one
        graph's float 1/(2m) as a batch of one (fills on ``device``, no
        host-to-device copy)."""
        if isinstance(constant, TenantConstants):
            return constant
        c = float(constant)
        return TenantConstants(
            c32=torch.full((1,), c, dtype=torch.float32, device=device),
            c64=torch.full((1,), c, dtype=torch.float64, device=device))  # graftlint: disable=R003 — 1/(2m) for Q in f64: the H100 sums in real f64


def modularity_terms(counter0: torch.Tensor, comm_deg: torch.Tensor,
                     consts: TenantConstants) -> torch.Tensor:
    """Q = e*c - a^2*c^2 in float64, from the per-vertex weight into the
    current community and the community degrees (reference
    louvain.cpp:2433-2481): the [B] f64 Q of every tenant of a folded
    batch, each summed over its own vertices ([1] for one graph)."""
    c = consts.c64
    b = c.numel()
    le = counter0.double().view(b, -1).sum(1)
    la2 = comm_deg.double().square().view(b, -1).sum(1)
    return le * c - la2 * c * c


def _check_slab(ne: int, what: str) -> None:
    if ne > SLAB_NE_MAX:
        raise ValueError(f"{what}: slab has {ne} rows, over SLAB_NE_MAX = "
                         f"{SLAB_NE_MAX}; shard the slab below the ceiling "
                         "first")


def sort_edges_by_vertex_comm(src: torch.Tensor, ckey: torch.Tensor,
                              w: torch.Tensor, *, src_bound: int,
                              key_bound: int) -> tuple:
    """Stable sort of the slab by (src, ckey) (reference ``:113``).

    Returns (src_s, ckey_s, w_s).  ``src_bound``/``key_bound`` are
    exclusive maxima: every src must be < src_bound (padding rows carry
    src == nv, so callers pass nv + 1) and every ckey < key_bound.  The
    packed key has kbits + sbits <= 62 bits; equal packed keys are equal
    pairs, and the stable sort keeps slab order within a run, which the
    run sums read."""
    kbits = max(int(key_bound) - 1, 1).bit_length()
    sbits = max(int(src_bound) - 1, 1).bit_length()
    if kbits + sbits > 62:
        raise ValueError(f"sort_edges_by_vertex_comm: {sbits} + {kbits} "
                         "key bits do not fit an int64")
    packed = (src.long() << kbits) | ckey.long()
    k_s, order = torch.sort(packed, stable=True)
    src_s = (k_s >> kbits).to(src.dtype)
    ckey_s = (k_s & ((1 << kbits) - 1)).to(ckey.dtype)
    return src_s, ckey_s, w[order]


def run_starts(src_s: torch.Tensor, ckey_s: torch.Tensor) -> torch.Tensor:
    """Mask of the first edge of every (src, ckey) run of a sorted slab."""
    starts = torch.ones_like(src_s, dtype=torch.bool)
    starts[1:] = (src_s[1:] != src_s[:-1]) | (ckey_s[1:] != ckey_s[:-1])
    return starts


def run_totals(w_s: torch.Tensor, starts: torch.Tensor) -> tuple:
    """Per-edge total weight of its run, summed in f64 and rounded once to
    ``w_s``'s dtype, and the run id of each edge (reference ``:386``).  At
    a run start this is e_{i->c}, the weight from vertex i to community
    c."""
    _check_slab(w_s.shape[0], "run_totals")
    run_id = torch.cumsum(starts, 0) - 1
    totals = segment_sum(w_s.double(), run_id, w_s.shape[0])
    return totals[run_id].to(w_s.dtype), run_id


def sort_edges_msd(src: torch.Tensor, ckey: torch.Tensor, w: torch.Tensor,
                   *, nv_pad: int, src_bound: int | None = None) -> tuple:
    """Stable sort of the slab by (src, ckey) as two stable int32 sorts
    (reference ``:168``).  Pass 1 sorts by ``(src_low << kbits) | ckey``,
    ``src_low`` the low ``31 - kbits`` bits of src; pass 2 sorts that
    order stably by ``src >> (31 - kbits)``, so the result is
    lexicographic (src_hi, src_low, ckey) = (src, ckey): the packed sort's
    order, ties kept in slab order.  ``ckey`` < nv_pad; ``src`` <
    ``src_bound`` (default nv_pad + 1, the padding rows' nv_pad included;
    a batch passes its folded bound).  Where kbits + sbits <= 31 one pass
    does it, and the packed sort runs instead; a key space past 31 bits
    on its own also goes to the (int64) packed sort.  Returns (src_s,
    ckey_s, w_s)."""
    src_bound = nv_pad + 1 if src_bound is None else int(src_bound)
    kbits = max(nv_pad - 1, 1).bit_length()
    sbits = max(src_bound - 1, 1).bit_length()
    s_low = 31 - kbits
    if kbits + sbits <= 31 or s_low <= 0 or sbits - s_low > 31:
        return sort_edges_by_vertex_comm(src, ckey, w, src_bound=src_bound,
                                         key_bound=nv_pad)
    low = (src & ((1 << s_low) - 1)).to(torch.int32)
    key1 = (low << kbits) | ckey.to(torch.int32)
    _, o1 = torch.sort(key1, stable=True)
    del key1, low
    hi = (src[o1] >> s_low).to(torch.int32)
    _, o2 = torch.sort(hi, stable=True)
    order = o1[o2]
    return src[order], ckey[order], w[order]


def coalesced_runs(src: torch.Tensor, ckey: torch.Tensor, w: torch.Tensor,
                   *, nv_pad: int, engine: str = "sort",
                   tracer=None) -> tuple:
    """Segmented coalesce of one slab by (src, ckey) (reference ``:261``):
    :func:`coalesced_runs_batched` of a batch of one, any engine.  Returns
    ``(src_c, ckey_c, w_c, n)``: [ne_pad] arrays with the real rows in
    [0, n) and padding after; ``n`` is a Python int, whose read is a
    ``host_read`` stage of ``tracer``."""
    tracer = tracer if tracer is not None else NullTracer()
    src_c, ckey_c, w_c, n = coalesced_runs_batched(
        src[None], ckey[None], w[None], nv_pad=nv_pad, engine=engine)
    with tracer.stage("host_read"):
        n = int(n[0])
    return src_c[0], ckey_c[0], w_c[0], n


def compact_batched(keep: torch.Tensor, src_f: torch.Tensor,
                    ckey: torch.Tensor, w: torch.Tensor, *, n_tenants: int,
                    ne_pad: int, nv_pad: int) -> tuple:
    """The rows of a folded slab sorted by (tenant, src, ckey) where
    ``keep`` holds, each tenant's compacted into the prefix of its own row
    of [n_tenants, ne_pad] arrays, padding (src == nv_pad, ckey == 0,
    w == 0) after.  ``src_f`` [n_tenants * ne_pad] is the folded source
    b * nv_pad + src, ascending.  Returns (src_c, ckey_c, w_c, n) with
    ``n`` the [n_tenants] int64 row counts on the device.

    No step reads a count on the host (the reference's cumsum emission,
    ``:249-258``, never does either): ``torch.nonzero_static`` lists the
    kept rows in order into a buffer of fixed length, tenant b's start
    row (one ``searchsorted`` of the sorted sources) splits them by
    tenant, and output slot (b, r) gathers tenant b's r-th kept row."""
    dev = src_f.device
    size = n_tenants * ne_pad
    last = max(size - 1, 0)
    rows = torch.nonzero_static(keep, size=size, fill_value=size)[:, 0]
    starts = torch.searchsorted(
        src_f, torch.arange(n_tenants + 1, device=dev) * nv_pad)
    before = torch.searchsorted(rows, starts)   # kept rows before each
    n = before[1:] - before[:-1]
    r = torch.arange(ne_pad, device=dev)
    take = rows[(before[:-1, None] + r).clamp_(max=last)].clamp_(max=last)
    del rows
    pad = r >= n[:, None]
    # In-place steps: these arrays are slab-sized.
    src_c = src_f[take]
    src_c -= torch.arange(n_tenants, device=dev)[:, None] * nv_pad
    src_c = src_c.masked_fill_(pad, nv_pad).to(torch.int32)
    ckey_c = ckey[take].masked_fill_(pad, 0).to(torch.int32)
    w_c = w[take].masked_fill_(pad, 0.0)
    return src_c, ckey_c, w_c, n


def coalesced_runs_batched(src: torch.Tensor, ckey: torch.Tensor,
                           w: torch.Tensor, *, nv_pad: int,
                           engine: str = "sort", grid: int | None = None
                           ) -> tuple:
    """Segmented coalesce of B tenants' slabs by (src, ckey) (reference
    ``:261``, under ``vmap`` for a batch): per tenant, one row per
    distinct real pair, in ascending (src, ckey) order, compacted into
    the tenant's slab prefix, duplicate weights summed in f64 and rounded
    once.  ``src``, ``ckey``, ``w``: [B, ne_pad], real ids < ``nv_pad`` (a
    power of two), padding rows src == nv_pad and w == 0.

    ``engine='sort'``: one stable sort of the folded key
    ((b * nv_pad + src) << kbits) | ckey, the run sums and an emission
    with no host read (:func:`compact_batched`).  ``engine='msd'``: the
    same order and tail from :func:`sort_edges_msd`'s two int32 passes,
    no host read either.  ``engine='hash'`` (one slab, B == 1): the slot
    table of ``kernels/seg_coalesce.hash_accumulate``, one host read of
    its collision flag, then either ``hash_emit`` or, after a collision,
    the msd tail; sums in f64 rounded once, like the others.
    ``engine='dense'``: the ``seg_coalesce`` pipeline on the card (rows
    bucketed by (tenant, src) and deduplicated by dst, no host sync) or
    its dense twin on the CPU, ``grid`` a power of two above every real
    id (default ``nv_pad``; ``kernels/seg_coalesce.coalesce_engine`` and
    ``batched_coalesce_engine`` pick the engine).  Both sum each run in
    f64 and round once, so they are bit-identical wherever the f64 run
    sums are exact.  A run is emitted by presence, never by weight: a
    zero-weight real edge is a row.

    Returns ``(src_c, ckey_c, w_c, n)``: [B, ne_pad] arrays with tenant
    b's rows in [0, n[b]) and padding after; ``n`` a [B] int64 tensor on
    the device."""
    b, ne_pad = src.shape
    _check_slab(b * ne_pad, "coalesced_runs")
    if engine == "dense":
        from cuvite_tpu_torch.kernels.seg_coalesce import seg_coalesce

        return seg_coalesce(src, ckey, w, nv_pad=nv_pad,
                            grid=nv_pad if grid is None else grid)
    if engine == "hash":
        hashed = _hash_coalesce(src, ckey, w, nv_pad=nv_pad)
        if hashed is not None:
            return hashed
        engine = "msd"   # a collision: the msd tail, counted
    if engine not in ("sort", "msd"):
        raise ValueError(f"coalesced_runs: unknown engine {engine!r} (the "
                         "port has 'sort', 'msd', 'dense' and 'hash')")
    folded = b * nv_pad
    base = torch.arange(b, device=src.device)[:, None] * nv_pad
    src_f = torch.where(src < nv_pad, src.long() + base, folded)
    if engine == "msd":
        src_s, ckey_s, w_s = sort_edges_msd(
            src_f.reshape(-1), ckey.reshape(-1), w.reshape(-1),
            nv_pad=nv_pad, src_bound=folded + 1)
    else:
        src_s, ckey_s, w_s = sort_edges_by_vertex_comm(
            src_f.reshape(-1), ckey.reshape(-1), w.reshape(-1),
            src_bound=folded + 1, key_bound=nv_pad)
    run_w, _ = run_totals(w_s, run_starts(src_s, ckey_s))
    last = torch.ones_like(src_s, dtype=torch.bool)
    last[:-1] = (src_s[1:] != src_s[:-1]) | (ckey_s[1:] != ckey_s[:-1])
    return compact_batched(last & (src_s < folded), src_s, ckey_s, run_w,
                           n_tenants=b, ne_pad=ne_pad, nv_pad=nv_pad)


def _hash_coalesce(src: torch.Tensor, ckey: torch.Tensor, w: torch.Tensor,
                   *, nv_pad: int):
    """The hash engine on one slab ([1, ne_pad]; reference ``:333-364``):
    the slot table in one scatter pass, then one host read of its
    collision flag.  Returns the coalesced rows as
    :func:`coalesced_runs_batched` does, or None after a collision (the
    caller runs the msd tail).  ``kernels.seg_coalesce.HASH_STATS`` counts
    the coalescings, collisions and host reads."""
    from cuvite_tpu_torch.kernels.seg_coalesce import (
        HASH_STATS,
        hash_accumulate,
        hash_emit,
        hash_slots,
    )

    b, ne_pad = src.shape
    if b != 1:
        raise ValueError(f"coalesced_runs: the hash engine coalesces one "
                         f"slab, not {b} (batched_coalesce_engine sends "
                         "batches to 'msd')")
    k = hash_slots(nv_pad, ne_pad)
    wsum, cnt, dmin, dmax = hash_accumulate(src[0], ckey[0], w[0],
                                            nv_pad=nv_pad, k=k)
    HASH_STATS["coalescings"] += 1
    HASH_STATS["host_reads"] += 1
    # A slot that two distinct dst hash to cannot emit.  The one host read:
    if bool(((cnt > 0) & (dmin != dmax)).any()):
        HASH_STATS["collisions"] += 1
        return None
    src_c, ckey_c, w_c, n = hash_emit(wsum, cnt, dmin, nv_pad=nv_pad,
                                      ne_pad=ne_pad, k=k, w_dtype=w.dtype)
    return src_c[None], ckey_c[None], w_c[None], n.reshape(1)
