"""One Louvain sweep over an edge slab: the sort engine (port of
``cuvite_tpu/louvain/step.py:40-138,166-176``, single shard).

Per sweep: community sizes and degrees recomputed from the assignment;
per edge the community of its tail; counter0 (weight into the current
community, self-loops included), the self-loop weight and
eix = counter0 - self-loop; a stable sort of the slab by
(src, neighbour community) and the run totals e_{i->y}; the gain

    gain(i -> y) = 2*(e_{i->y} - e_{i->x}) - ((2*k_i)*(a_y - a_x))*c

in the reference's operand order (``step.py:114``), a_x = deg(x) - k_i;
the per-vertex argmax with ties to the smaller community id; only
positive gains move; of two singletons only the move to the smaller id is
kept (louvain.cpp:2185-2244).  Q of the input assignment comes from the
port's f64 ``modularity_terms``.

Numbers: community degrees, counter0, self-loops and run totals are
summed in f64 and rounded once to f32 (the reference sums in f32), so the
card and the CPU give the same f32 values, and on the exactness domain
the reference's.  The gain is f32, one torch op per operation: no fused
multiply-adds form across ops (no ``torch.compile`` here).

Not ported: the multi-GPU form (``axis_name``, ``make_sharded_step``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuvite_tpu_torch.kernels.row_argmax import SENTINEL
from cuvite_tpu_torch.ops import segment as seg


class StepOut(NamedTuple):
    target: torch.Tensor      # [nv] int32 new community per vertex
    modularity: torch.Tensor  # 0-dim f64: Q of the INPUT assignment
    n_moved: torch.Tensor     # 0-dim int64: vertices that changed


def louvain_step_local(src: torch.Tensor, dst: torch.Tensor,
                       w: torch.Tensor, comm: torch.Tensor,
                       vdeg: torch.Tensor, constant: float) -> StepOut:
    """One synchronous sweep on one device.

    ``src`` [ne] int32 source vertex, ascending (padding rows == nv);
    ``dst`` [ne] int32 tail vertex (padding 0, w 0); ``w`` [ne] f32;
    ``comm`` [nv] int32 assignment; ``vdeg`` [nv] f32 weighted degrees;
    ``constant`` = 1/(2m), rounded to f32 for the gains and used in f64
    for Q."""
    nv = comm.shape[0]
    # A fill, not a host-to-device copy: no wait on the stream.
    cst = torch.full((), float(constant), dtype=torch.float32,
                     device=comm.device)
    comm_l = comm.long()

    # Community size and degree, recomputed fresh.
    comm_deg64 = seg.segment_sum(vdeg.double(), comm_l, nv)
    comm_deg = comm_deg64.float()
    # index_add_, not bincount: bincount reads its input's max on the host.
    comm_size = seg.segment_sum(torch.ones_like(comm_l), comm_l, nv)

    # Per-edge community keys; padding rows gather vertex nv - 1.
    src_c = src.clamp(max=nv - 1).long()
    csrc = comm[src_c]
    ckey = comm[dst.long()]
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    counter0 = seg.segment_sum_drop(
        torch.where(ckey == csrc, w, zero).double(), src, nv).float()
    self_loop = seg.segment_sum_drop(
        torch.where(dst == src, w, zero).double(), src, nv).float()
    eix = counter0 - self_loop

    # Neighbour-community aggregation: sort + run totals.
    src_s, ckey_s, w_s = seg.sort_edges_by_vertex_comm(
        src, ckey, w, src_bound=nv + 1, key_bound=nv)
    starts = seg.run_starts(src_s, ckey_s)
    eiy, _ = seg.run_totals(w_s, starts)

    i_s = src_s.clamp(max=nv - 1).long()
    comm_i = comm[i_s]
    valid = starts & (src_s < nv) & (ckey_s != comm_i)

    # Gain of every candidate run, in the reference's operand order.
    k_i = vdeg[i_s]
    a_y = comm_deg[ckey_s.long()]
    a_x = comm_deg[comm_i.long()] - k_i
    gain = 2.0 * (eiy - eix[i_s]) - 2.0 * k_i * (a_y - a_x) * cst
    gain = torch.where(valid, gain, float("-inf"))

    # Per-vertex argmax, ties to the smaller community id.
    best_gain = seg.segment_max(gain, src_s, nv + 1)[:nv]
    is_best = valid & (gain == best_gain[i_s])
    cand_c = torch.where(is_best, ckey_s, SENTINEL)
    best_c = seg.segment_min(cand_c, src_s, nv + 1)[:nv]

    move = best_gain > 0.0
    best_c_safe = best_c.clamp(max=nv - 1)
    # Singleton guard (louvain.cpp:2240-2241).
    guard = ((comm_size[best_c_safe.long()] == 1) & (comm_size[comm_l] == 1)
             & (best_c_safe > comm))
    move &= ~guard
    target = torch.where(move, best_c_safe, comm)
    modularity = seg.modularity_terms(counter0, comm_deg64, float(constant))
    return StepOut(target=target, modularity=modularity, n_moved=move.sum())
