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
``torch.sort``.  Not ported: the ``msd`` two-pass sort (``:168``) and the
``hash`` coalesce engine (``kernels/seg_coalesce.py:335-427``); the port's
``coalesced_runs`` has the ``sort`` and ``dense`` engines.
"""

from __future__ import annotations

import torch

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


def modularity_terms(counter0: torch.Tensor, comm_deg: torch.Tensor,
                     constant: float) -> torch.Tensor:
    """Q = e*c - a^2*c^2 in float64, from the per-vertex weight into the
    current community and the community degrees (reference
    louvain.cpp:2433-2481).  Returns a 0-dim f64 tensor on their device."""
    le = counter0.double().sum()
    la2 = comm_deg.double().square().sum()
    return le * constant - la2 * constant * constant


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


def _compact_prefix(keep: torch.Tensor, ne_pad: int, nv_pad: int,
                    src: torch.Tensor, ckey: torch.Tensor,
                    w: torch.Tensor) -> tuple:
    """Rows where ``keep`` is true, in order, compacted into the prefix of
    [ne_pad] arrays; padding (src == nv_pad, ckey == 0, w == 0) after.
    Returns (src_c, ckey_c, w_c, n) with ``n`` a Python int.

    The reference emits with a cumsum and a scatter whose dropped rows
    all aim at one out-of-range slot (``:249-258``, ``seg_coalesce.py:
    285-296``); the port takes the kept positions with ``nonzero`` -- a
    device scan, like the cumsum -- which reads the row count on the host
    once.  Both engines' callers read that count anyway."""
    idx = torch.nonzero(keep).squeeze(1)
    n = int(idx.numel())
    src_c = torch.full((ne_pad,), nv_pad, dtype=src.dtype, device=src.device)
    ckey_c = torch.zeros(ne_pad, dtype=ckey.dtype, device=ckey.device)
    w_c = torch.zeros(ne_pad, dtype=w.dtype, device=w.device)
    src_c[:n] = src[idx]
    ckey_c[:n] = ckey[idx]
    w_c[:n] = w[idx]
    return src_c, ckey_c, w_c, n


def _runs_from_sorted(src_s: torch.Tensor, ckey_s: torch.Tensor,
                      w_s: torch.Tensor, *, nv_pad: int) -> tuple:
    """Run detection, run sums (f64, rounded once) and the compacted
    emission of a slab already in stable (src, ckey) order (reference
    ``:211``).  A run is emitted at its last row; runs are contiguous, so
    the output order is the sorted (src, ckey) order."""
    ne_pad = src_s.shape[0]
    _check_slab(ne_pad, "_runs_from_sorted")
    run_w, _ = run_totals(w_s, run_starts(src_s, ckey_s))
    last = torch.ones_like(src_s, dtype=torch.bool)
    last[:-1] = (src_s[1:] != src_s[:-1]) | (ckey_s[1:] != ckey_s[:-1])
    return _compact_prefix(last & (src_s < nv_pad), ne_pad, nv_pad, src_s,
                           ckey_s, run_w)


def coalesced_runs(src: torch.Tensor, ckey: torch.Tensor, w: torch.Tensor,
                   *, nv_pad: int, engine: str = "sort") -> tuple:
    """Segmented coalesce of a slab by (src, ckey) (reference ``:261``):
    one row per distinct real pair, in ascending (src, ckey) order,
    compacted into the slab prefix, duplicate weights summed in f64 and
    rounded once.  Real ids are < ``nv_pad`` (a power of two); padding
    rows carry src == nv_pad and w == 0.

    ``engine='sort'``: the stable packed-key sort and run sums.
    ``engine='dense'``: the ``seg_coalesce`` kernel's dense (weight,
    count) accumulators and their compaction
    (``kernels/seg_coalesce.py``); the caller checks eligibility with
    ``seg_coalesce.coalesce_engine``.  Both sum each run in f64 and round
    once, so they are bit-identical wherever the f64 run sums are exact.
    A run is emitted by presence, never by weight: a zero-weight real
    edge is a row.

    Returns ``(src_c, ckey_c, w_c, n)``: [ne_pad] arrays with the real
    rows in [0, n) and padding after; ``n`` is a Python int."""
    _check_slab(src.shape[0], "coalesced_runs")
    if engine == "dense":
        from cuvite_tpu_torch.kernels.seg_coalesce import coalesce_slab

        return coalesce_slab(src, ckey, w, nv_pad=nv_pad)
    if engine != "sort":
        raise ValueError(f"coalesced_runs: unknown engine {engine!r} (the "
                         "port has 'sort' and 'dense'; 'msd' and 'hash' "
                         "are not ported, see ROADMAP.md)")
    src_s, ckey_s, w_s = sort_edges_by_vertex_comm(
        src, ckey, w, src_bound=nv_pad + 1, key_bound=nv_pad)
    return _runs_from_sorted(src_s, ckey_s, w_s, nv_pad=nv_pad)
