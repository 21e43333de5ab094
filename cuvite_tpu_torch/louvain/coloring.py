"""Distance-1 coloring by speculative multi-hash min/max (port of
``cuvite_tpu/louvain/coloring.py:38-140,224-233``, the single-device form).

The reference's distColoringMultiHashMinMax (coloring.cpp:3-72): each
round evaluates ``n_hash`` hash functions; an uncolored vertex that is the
strict minimum (maximum) of hash t among its uncolored neighbours may take
color 2t + next (2t + 1 + next), and of several such slots it takes the
(v mod possible)-th (coloring.cpp:171-197).  Rounds repeat, next += 2 *
n_hash, until target_percent of the vertices are colored or a round colors
none (coloring.cpp:41-58).  Ties remove both directions, so two adjacent
vertices never share a slot: the coloring is conflict-free by
construction, which :func:`count_conflicts` checks.

The hashes are the reference's uint32 Jenkins mix.  Torch has little
uint32 arithmetic, so :func:`jenkins_mix` computes in int64 and masks to
32 bits after every step: the values and so the colors are bit-identical
to the reference's.  A round is one edge-parallel pass on the graph's
device; the round loop reads one count per round on the host.
:func:`multi_hash_coloring_dist` colors a per-rank partition
(``io/dist_ingest.DistVite``) with the same result: each round runs over
the rank's own edges, then the ranks' owned slices are all-gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from cuvite_tpu_torch.core.device import resolve_device
from cuvite_tpu_torch.ops import segment as seg

UNCOLORED = -1
MAX_COVG = 70  # default target coverage percent (main.cpp:26)

_M32 = 0xFFFFFFFF


def jenkins_mix(a, seed: int):
    """The reference's 32-bit integer mix (coloring.cpp:74-85) of the
    non-negative ids ``a``: a tensor gives int64 tensors holding uint32
    values, an int (the round-seed chain, seed = hash(seed, 0)) an int."""
    if isinstance(a, torch.Tensor):
        a = a.long()
    a = (a ^ (seed & _M32)) & _M32
    a = ((a + 0x7ED55D16) + (a << 12)) & _M32
    a = ((a ^ 0xC761C23C) + (a >> 19)) & _M32
    a = ((a + 0x165667B1) + (a << 5)) & _M32
    a = ((a ^ 0xD3A2646C) + (a << 9)) & _M32
    a = ((a + 0xFD7046C5) + (a << 3)) & _M32
    a = ((a ^ 0xB55A4F09) + (a >> 16)) & _M32
    return a


def _coloring_round(src: torch.Tensor, dst: torch.Tensor,
                    color: torch.Tensor, seed: int, next_color: int, *,
                    n_hash: int, nv: int) -> tuple:
    """One speculative round over the edges (``src`` padding >= nv) on
    ``color`` [nv] int32.  Returns (new colors, 0-dim count of colored
    vertices)."""
    src_c = src.clamp(max=nv - 1).long()
    uncolored_v = color == UNCOLORED
    # Edges that take part (coloring.cpp:122-145): real, not self-loops,
    # the neighbour not colored in an earlier round.
    participates = ((src < nv) & (dst != src)
                    & (color[dst.long()] == UNCOLORED))
    slots = []   # [min_0, max_0, min_1, max_1, ...] eliminations
    for t in range(n_hash):
        hseed = (seed + 1043 * t) & _M32
        v_hash = jenkins_mix(src, hseed)
        j_hash = jenkins_mix(dst, hseed)
        # Eliminations (coloring.cpp:152-161); ties kill both directions.
        not_max = participates & (v_hash <= j_hash)
        not_min = participates & (v_hash >= j_hash)
        slots += [seg.segment_sum(not_min.int(), src_c, nv) > 0,
                  seg.segment_sum(not_max.int(), src_c, nv) > 0]
    avail = ~torch.stack(slots, dim=1) & uncolored_v[:, None]
    possible = avail.sum(dim=1)
    can_color = uncolored_v & (possible > 0)
    col_id = torch.where(
        can_color,
        torch.arange(nv, device=color.device) % possible.clamp(min=1), 0)
    rank = avail.long().cumsum(dim=1) - 1
    pick = avail & (rank == col_id[:, None])
    # The first picked slot (argmax returns the first maximum).
    slot = pick.int().argmax(dim=1)
    new_color = torch.where(can_color, (slot + next_color).int(), color)
    return new_color, (new_color != UNCOLORED).sum()


def multi_hash_coloring(src, dst, nv: int, n_hash: int = 4,
                        target_percent: int = MAX_COVG,
                        single_iteration: bool = False, seed: int = 1012,
                        device=None) -> tuple:
    """Color the vertices of the edge list (``src``, ``dst``) on
    ``device`` (None: the card, as ``louvain_phases``).  Rounds stop at >=
    ``target_percent`` colored, when a round colors no more, or after one
    round when ``single_iteration`` (coloring.cpp:41-58); one host read of
    the count per round.  Returns (colors [nv] int32 numpy, -1 for
    uncolored; the number of colors' upper bound, the final
    next_color)."""
    device = resolve_device(device)
    src_t = torch.as_tensor(np.asarray(src)).to(device)
    dst_t = torch.as_tensor(np.asarray(dst)).to(device)

    def round_fn(color, seed_, next_color):
        return _coloring_round(src_t, dst_t, color, seed_, next_color,
                               n_hash=n_hash, nv=nv)

    return _round_loop(round_fn, nv, n_hash, target_percent,
                       single_iteration, seed, device)


def _round_loop(round_fn, nv: int, n_hash: int, target_percent: int,
                single_iteration: bool, seed: int, device) -> tuple:
    """The rounds of coloring.cpp:41-58 over ``round_fn(color, seed,
    next_color)`` -> (new colors, count of colored vertices)."""
    color = torch.full((nv,), UNCOLORED, dtype=torch.int32, device=device)
    next_color = 0
    target = (nv * target_percent) // 100
    last = 0
    while True:
        color, count = round_fn(color, seed, next_color)
        count = int(count)
        next_color += 2 * n_hash
        if single_iteration or count >= target or count == last:
            break
        seed = jenkins_mix(seed, 0)
        last = count
    return color.cpu().numpy(), next_color


def multi_hash_coloring_dist(dv, n_hash: int = 4,
                             target_percent: int = MAX_COVG,
                             single_iteration: bool = False,
                             seed: int = 1012, device=None) -> tuple:
    """:func:`multi_hash_coloring` of a per-rank partition ``dv``
    (``io/dist_ingest.DistVite``), bit-identical to it on the whole edge
    list (reference ``coloring.py:164-221``, the counterpart of the
    reference application's ghost color exchange, coloring.cpp:204-420).
    Every rank keeps the whole [nv] color vector; each round runs over the
    rank's own edges, then the ranks' owned vertex ranges, contiguous in
    rank order, are all-gathered (``multihost.allgather_varlen``) into the
    next vector.  A vertex's new color depends only on its own edges, all
    of which its owner holds, and on the previous vector.  Collective:
    every rank calls it.  Returns (colors [nv] int32 numpy in original
    ids, the number of colors' upper bound), the same on every rank."""
    from cuvite_tpu_torch.comm.multihost import allgather_varlen

    device = resolve_device(device)
    nv = dv.num_vertices
    srcs, dsts = [], []
    for s in range(dv.local_lo, dv.local_hi):
        sh = dv.shards[s]
        real = sh.src < dv.nv_pad
        srcs.append(sh.src[real].astype(np.int64) + int(dv.parts[s]))
        dsts.append(dv.pad_to_old[sh.dst[real].astype(np.int64)])
    src_t, dst_t = (torch.from_numpy(np.concatenate(a) if a else
                                     np.zeros(0, dtype=np.int64)).to(device)
                    for a in (srcs, dsts))
    lo, hi = int(dv.parts[dv.local_lo]), int(dv.parts[dv.local_hi])

    def round_fn(color, seed_, next_color):
        new, _ = _coloring_round(src_t, dst_t, color, seed_, next_color,
                                 n_hash=n_hash, nv=nv)
        full = np.concatenate(allgather_varlen(new[lo:hi].cpu().numpy()))
        if len(full) != nv:
            raise RuntimeError(f"gathered {len(full)} colors for {nv} "
                               "vertices")
        return (torch.from_numpy(full).to(device),
                int(np.count_nonzero(full != UNCOLORED)))

    return _round_loop(round_fn, nv, n_hash, target_percent,
                       single_iteration, seed, device)


def count_conflicts(src, dst, nv, colors) -> int:
    """Conflict checker (coloring.cpp:447-593): the number of non-self
    edges whose endpoints share a color other than -1."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    colors = np.asarray(colors)
    real = (src < nv) & (dst != src)
    cs = colors[np.minimum(src, nv - 1)]
    cd = colors[dst]
    return int(np.sum(real & (cs == cd) & (cs != UNCOLORED)))
