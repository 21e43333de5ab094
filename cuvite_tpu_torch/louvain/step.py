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

Batches: with a folded batch's ``TenantConstants`` (tenant b's vertex v
at b * nv_pad + v, padding rows src == B * nv_pad) one sweep covers every
tenant -- one sort of the whole folded slab, each edge's gain taking its
tenant's constant -- and returns each tenant's Q and moved count (the
reference's ``jax.vmap`` of its fused phase, ``cuvite_tpu/louvain/
batched.py:101-130``).  One graph is a batch of one.

A vertex mesh (``comm/mesh.py``): :func:`sharded_step` is the
reference's ``louvain_step_local`` with an axis and ``make_sharded_step``
(``step.py:46-163``) under the replicated exchange -- each shard sweeps
its own slab (local src, padded-global dst) against the all-gathered
community vector and the psum'd community degree and size tables, and Q
and the moved count are psum'd.  Both run one shard's arithmetic,
``_sweep``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuvite_tpu_torch.comm.collectives import all_gather, psum
from cuvite_tpu_torch.kernels.row_argmax import SENTINEL, tenant_shift
from cuvite_tpu_torch.ops import segment as seg
from cuvite_tpu_torch.ops.segment import TenantConstants


class StepOut(NamedTuple):
    target: torch.Tensor      # [nv] int32 new community per vertex
    modularity: torch.Tensor  # [B] f64: each tenant's Q of the INPUT
    n_moved: torch.Tensor     # [B] int64: each tenant's vertices moved


def louvain_step_local(src: torch.Tensor, dst: torch.Tensor,
                       w: torch.Tensor, comm: torch.Tensor,
                       vdeg: torch.Tensor, constant) -> StepOut:
    """One synchronous sweep on one device.

    ``src`` [ne] int32 source vertex, ascending (padding rows == nv);
    ``dst`` [ne] int32 tail vertex (padding 0, w 0); ``w`` [ne] f32;
    ``comm`` [nv] int32 assignment; ``vdeg`` [nv] f32 weighted degrees;
    ``constant`` = 1/(2m), rounded to f32 for the gains and used in f64
    for Q, or a folded batch's ``TenantConstants`` (module note).  Q and
    n_moved are [B], [1] for one graph."""
    nv = comm.shape[0]
    consts = TenantConstants.of(constant, comm.device)
    comm_l = comm.long()
    # Community size and degree, recomputed fresh.
    comm_deg64 = seg.segment_sum(vdeg.double(), comm_l, nv)
    # index_add_, not bincount: bincount reads its input's max on the host.
    comm_size = seg.segment_sum(torch.ones_like(comm_l), comm_l, nv)
    target, counter0, move = _sweep(src, dst, w, comm, comm, vdeg,
                                    comm_deg64.float(), comm_size, consts, 0)
    return StepOut(
        target=target,
        modularity=seg.modularity_terms(counter0, comm_deg64, consts),
        n_moved=move.view(consts.c64.numel(), -1).sum(1))


def _sweep(src, dst, w, comm, comm_tab, vdeg, comm_deg, comm_size, consts,
           base: int) -> tuple:
    """The sweep's arithmetic over one slab: ``comm`` [nv] the slab's own
    vertices' assignment, ``comm_tab``/``comm_deg``/``comm_size`` the
    assignment, degrees and sizes of every vertex and community the tails
    ``dst`` name (``comm`` itself on one device; on a mesh the gathered
    vector and psum'd tables, tails padded-global and the slab's vertex v
    at ``base + v``).  Returns (target, counter0, move)."""
    nv = comm.shape[0]
    nv_total = comm_deg.shape[0]
    shift = tenant_shift(consts.c32, nv, "louvain_step_local")
    comm_l = comm.long()

    # Per-edge community keys; padding rows gather vertex nv - 1.
    src_c = src.clamp(max=nv - 1).long()
    csrc = comm[src_c]
    ckey = comm_tab[dst.long()]
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    counter0 = seg.segment_sum_drop(
        torch.where(ckey == csrc, w, zero).double(), src, nv).float()
    self_loop = seg.segment_sum_drop(
        torch.where(dst == src + base, w, zero).double(), src, nv).float()
    eix = counter0 - self_loop

    # Neighbour-community aggregation: sort + run totals.
    src_s, ckey_s, w_s = seg.sort_edges_by_vertex_comm(
        src, ckey, w, src_bound=nv + 1, key_bound=nv_total)
    starts = seg.run_starts(src_s, ckey_s)
    eiy, _ = seg.run_totals(w_s, starts)

    i_s = src_s.clamp(max=nv - 1).long()
    comm_i = comm[i_s]
    valid = starts & (src_s < nv) & (ckey_s != comm_i)

    # Gain of every candidate run, in the reference's operand order.
    k_i = vdeg[i_s]
    a_y = comm_deg[ckey_s.long()]
    a_x = comm_deg[comm_i.long()] - k_i
    cst = consts.c32[i_s >> shift]
    gain = 2.0 * (eiy - eix[i_s]) - 2.0 * k_i * (a_y - a_x) * cst
    gain = torch.where(valid, gain, float("-inf"))

    # Per-vertex argmax, ties to the smaller community id.
    best_gain = seg.segment_max(gain, src_s, nv + 1)[:nv]
    is_best = valid & (gain == best_gain[i_s])
    cand_c = torch.where(is_best, ckey_s, SENTINEL)
    best_c = seg.segment_min(cand_c, src_s, nv + 1)[:nv]

    move = best_gain > 0.0
    best_c_safe = best_c.clamp(max=nv_total - 1)
    # Singleton guard (louvain.cpp:2240-2241).
    guard = ((comm_size[best_c_safe.long()] == 1) & (comm_size[comm_l] == 1)
             & (best_c_safe > comm))
    move &= ~guard
    return torch.where(move, best_c_safe, comm), counter0, move


class ShardedStepOut(NamedTuple):
    targets: list             # per local shard [nv_pad] int32 communities
    modularity: torch.Tensor  # 0-dim f64 Q of the INPUT, first local device
    n_moved: torch.Tensor     # 0-dim int64 vertices moved, the same device
    overflow: torch.Tensor    # 0-dim bool: never, under this exchange


def sharded_step(mesh, srcs: list, dsts: list, ws: list, comms: list,
                 vdegs: list, constant: float) -> ShardedStepOut:
    """One synchronous sort sweep over the local shards of ``mesh`` under
    the replicated exchange.  Per local shard i: ``srcs[i]`` [ne_pad] int32
    LOCAL source (padding nv_pad), ``dsts[i]`` padded-global tail,
    ``ws[i]`` f32, ``comms[i]``/``vdegs[i]`` [nv_pad] its owned slices;
    ``constant`` = 1/(2m)."""
    nv = comms[0].shape[0]
    nv_total = mesh.size * nv
    comm_full = all_gather(comms, mesh)  # graftlint: replicated-ok=scope=ici; the sort engine's community vector (sort engine is flat-mesh-only; a flat mesh is one ICI group)
    deg_parts, size_parts = [], []
    for comm, vdeg in zip(comms, vdegs):
        comm_l = comm.long()
        deg_parts.append(seg.segment_sum(vdeg.double(), comm_l, nv_total))  # graftlint: replicated-ok=scope=ici; replicated-exchange community degree table (sort engine is flat-mesh-only; a flat mesh is one ICI group)
        size_parts.append(seg.segment_sum(torch.ones_like(comm_l), comm_l,  # graftlint: replicated-ok=scope=ici; replicated-exchange community size table (sort engine is flat-mesh-only; a flat mesh is one ICI group)
                                          nv_total))
    comm_deg64 = psum(deg_parts, mesh)
    comm_size = psum(size_parts, mesh)
    targets, le, moved = [], [], []
    for i, s in enumerate(mesh.shard_ids):
        comm = comms[i]
        target, counter0, move = _sweep(
            srcs[i], dsts[i], ws[i], comm, comm_full[i], vdegs[i],
            comm_deg64[i].float(), comm_size[i],
            TenantConstants.of(constant, comm.device), s * nv)
        targets.append(target)
        le.append(counter0.double().sum())
        moved.append(move.sum())
    le_tot = psum(le, mesh)[0]
    la2 = comm_deg64[0].square().sum()
    q = le_tot * constant - la2 * constant * constant
    return ShardedStepOut(
        targets=targets, modularity=q, n_moved=psum(moved, mesh)[0],
        overflow=torch.zeros((), dtype=torch.bool,
                             device=mesh.devices[0]))
