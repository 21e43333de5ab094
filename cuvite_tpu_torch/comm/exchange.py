"""The sparse ghost exchange of a vertex mesh, and its two-level form
(port of ``cuvite_tpu/comm/exchange.py``).

The counterpart of the reference application's three-part protocol
(exchangeVertexReqs, fillRemoteCommunities, updateRemoteCommunities):

- :class:`ExchangePlan` (host numpy, copied from the reference): once a
  phase, the ghosts of every shard -- the vertices its edges reach on
  other shards -- and a static all_to_all layout: shard t sends
  ``send_idx[t, s, :]`` of its owned values to shard s each sweep, and
  shard s reads its ghosts out of the received ``[S, B]`` block through
  ``ghost_sel[s]``.  :meth:`ExchangePlan.remap_dst` rewrites a shard's
  edge tails into its extended-local space ``[0, nv_pad + G)``: owned ->
  local index, ghost -> nv_pad + its rank in the sorted ghost list.
- :func:`sparse_env`: once a sweep, every shard's community degree and
  size, kept by the community's owner.  Each shard groups its owned
  vertices by community, sums the self-owned ones locally and routes the
  (community, partial degree, partial size) of remote-owned ones to the
  owner through a per-peer budget of ``budget`` entries; owners add and
  reply with the totals over the transposed routing; the totals are
  attached to the owned vertices and pulled, with the communities, to
  the ghosts.  More remote communities of one owner than the budget
  raise ``overflow``: that sweep is invalid and the driver re-runs the
  phase with a larger budget.
- :func:`sparse_modularity`: Q with each community's degree counted once,
  by its owner.

Values per shard are lists over the mesh's local shards
(``comm/collectives.py``): on a multi-process mesh a rank holds, routes
and sweeps only its own shards, and builds only their rows of the plan.
Degrees are summed in f64 and rounded once to f32 for the kernels
(``cdeg_ext``/``cdeg_v``); ``deg_local`` stays f64 for Q.  The reference
sums in f32 (or double-single pairs).  The ghost pull moves its three
channels in one all_to_all, floats by their bits, as the reference does.
On the exactness domain the values are the reference's bit for bit.

``sparse_env(..., info=)`` takes vertex ordering's frozen assignment: the
degree and size tables come from grouping it, the requests and the
attachment from the current communities, at the cost of one more
key-only all_to_all (the request route).

The two-level exchange of a hybrid mesh (``comm/mesh.make_hybrid_mesh``):
:meth:`ExchangePlan.build_grouped` routes between the DCN groups of
``ici`` consecutive shards -- the plan's "shards" are the groups, its
``nv_pad`` the group window ``ici * shard_nv_pad``, its ghosts the ids
referenced from outside the whole group -- and :func:`twolevel_env`
gathers each shard's community and degree vectors over its ICI group,
then runs :func:`sparse_env`, unchanged, at group scale over its DCN
column.  Every member of a group computes the same group tables; the
community tables a shard holds are O(nv_total / dcn) instead of
O(nv_total).  :func:`sparse_modularity` then sums the a^2 term over the
DCN column only.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cuvite_tpu_torch.comm.collectives import all_gather, all_to_all, psum
from cuvite_tpu_torch.comm.mesh import shard_outer
from cuvite_tpu_torch.core.types import next_pow2

SENTINEL = int(np.iinfo(np.int32).max)


@dataclasses.dataclass
class ExchangePlan:
    """Phase-static ghost routing of a multi-shard DistGraph (S shards,
    B per-pair block, G padded ghost-table length).

    ``send_idx[t, s, b]``: local index at shard t of the b-th value t
    sends to s each sweep (``nv_pad`` marks padding).  ``ghost_sel[s, g]``:
    flat index into shard s's received [S, B] block (peer-major) of ghost
    g.  ``ghost_ids[s]``: the sorted padded-global ids of s's ghosts."""

    nshards: int
    nv_pad: int
    block: int                 # B
    ghost_pad: int             # G
    send_idx: np.ndarray       # [S, S, B] int32
    ghost_sel: np.ndarray      # [S, G] int32
    ghost_ids: list            # list[np.ndarray] per shard
    max_ghosts: int
    ici: int = 1               # device shards a plan shard (DCN group)
    shard_nv_pad: int = 0      # a device shard's window (0: nv_pad)

    @staticmethod
    def build(dg, shard_ids=None) -> "ExchangePlan":
        """The plan of ``dg``.  ``shard_ids``: the shards this rank of a
        process group holds; it finds their ghosts alone and all-gathers
        every shard's ghost list (the reference's exchangeVertexReqs
        flow), as a partition read per rank (``io/dist_ingest.DistVite``,
        ``dg.local_only``) always does.  Without, every shard is on this
        host.  Every rank then lays out the whole routing alike."""
        S, nvp = dg.nshards, dg.nv_pad
        if getattr(dg, "local_only", False):
            shard_ids = range(dg.local_lo, dg.local_hi)
        ghost_ids = []
        for s in (range(S) if shard_ids is None else shard_ids):
            sh = dg.shards[s]
            real = np.asarray(sh.src) < nvp
            d = np.asarray(sh.dst)[real].astype(np.int64)
            owned = (d >= s * nvp) & (d < (s + 1) * nvp)
            ghost_ids.append(np.unique(d[~owned]))
        if shard_ids is not None:
            ghost_ids = _gather_ghost_lists(ghost_ids, S)
        return ExchangePlan._lay_out(ghost_ids, nvp)

    @staticmethod
    def build_grouped(dg, n_dcn: int, shard_ids=None) -> "ExchangePlan":
        """The two-level plan (reference ``exchange.py:165-215``): routing
        between the ``n_dcn`` groups of ``ici = dg.nshards // n_dcn``
        consecutive shards, group g owning the window ``[g * nv_grp,
        (g + 1) * nv_grp)``, ``nv_grp = ici * dg.nv_pad``.  Group g's
        ghosts are the ids its member shards reference outside that
        window.  ``shard_ids`` as in :meth:`build`: a rank finds its own
        shards' references and all-gathers the lists.  At ici = 1 it is
        :meth:`build`'s plan."""
        S, nvp = dg.nshards, dg.nv_pad
        if getattr(dg, "local_only", False):
            raise NotImplementedError(
                "two-level exchange does not support per-host ingest yet")
        if n_dcn < 1 or S % n_dcn:
            raise ValueError(f"dcn={n_dcn} must divide nshards={S}")
        ici = S // n_dcn
        nv_grp = ici * nvp
        refs = []
        for s in (range(S) if shard_ids is None else shard_ids):
            sh = dg.shards[s]
            real = np.asarray(sh.src) < nvp
            d = np.asarray(sh.dst)[real].astype(np.int64)
            g = s // ici
            refs.append(np.unique(
                d[(d < g * nv_grp) | (d >= (g + 1) * nv_grp)]))
        if shard_ids is not None:
            refs = _gather_ghost_lists(refs, S)
        ghost_ids = [np.unique(np.concatenate(refs[g * ici:(g + 1) * ici]))
                     for g in range(n_dcn)]
        plan = ExchangePlan._lay_out(ghost_ids, nv_grp)
        plan.ici, plan.shard_nv_pad = ici, nvp
        return plan

    @staticmethod
    def _lay_out(ghost_ids: list, nvp: int) -> "ExchangePlan":
        """The static all_to_all layout of every plan shard's sorted
        ghost list, plan shard t owning ``[t * nvp, (t + 1) * nvp)``."""
        S = len(ghost_ids)
        bounds = [np.searchsorted(g, np.arange(S + 1) * nvp)
                  for g in ghost_ids]
        max_g = max((len(g) for g in ghost_ids), default=0)
        G = next_pow2(max(max_g, 1))
        B = 1
        for s in range(S):
            if len(ghost_ids[s]):
                B = max(B, int(np.max(np.diff(bounds[s]))))
        B = next_pow2(B)
        # One vectorized pass per shard over its ghost list: owner =
        # id // nv_pad, rank = position within the owner's group.
        send_idx = np.full((S, S, B), nvp, dtype=np.int32)
        ghost_sel = np.zeros((S, G), dtype=np.int32)
        for s in range(S):
            gids, bnd = ghost_ids[s], bounds[s]
            if not len(gids):
                continue
            owner = gids // nvp
            rank = np.arange(len(gids), dtype=np.int64) - bnd[owner]
            ghost_sel[s, : len(gids)] = (owner * B + rank).astype(np.int32)
            send_idx[owner, s, rank] = (gids - owner * nvp).astype(np.int32)
        return ExchangePlan(
            nshards=S, nv_pad=nvp, block=B, ghost_pad=G,
            send_idx=send_idx, ghost_sel=ghost_sel, ghost_ids=ghost_ids,
            max_ghosts=max_g)

    def stats(self) -> dict:
        """Plan-shape digest (the reference's ``exchange`` event and
        ``LouvainResult.exchange_stats``): ``ghost_bytes`` is the
        three-channel ghost pull of 4-byte values sent per shard and
        sweep; a two-level plan adds ``dcn``, ``ici`` and
        ``table_bytes_per_device``, the group-window community and degree
        vectors each shard holds."""
        out = {
            "mode": "twolevel" if self.ici > 1 else "sparse",
            "nshards": self.nshards,
            "block": self.block,
            "ghost_pad": self.ghost_pad,
            "max_ghosts": self.max_ghosts,
            "ghosts_per_shard": [len(g) for g in self.ghost_ids],
            "ghost_bytes": 3 * self.nshards * self.block * 4,
        }
        if self.ici > 1:
            out["dcn"] = self.nshards
            out["ici"] = self.ici
            out["table_bytes_per_device"] = 2 * self.nv_pad * 4
        return out

    def remap_dst(self, s: int, src: np.ndarray,
                  dst: np.ndarray) -> np.ndarray:
        """Device shard s's padded-global dst ids in its extended-local
        space [0, nv_pad + ghost_pad); padding edges map to 0.  On a
        two-level plan the space is group ``s // ici``'s: owned means
        owned by the group, and shard s's own vertex v lands at
        ``(s % ici) * shard_nv_pad + v``."""
        nvp = self.nv_pad
        g = s // self.ici
        d = dst.astype(np.int64)
        out = np.zeros(len(d), dtype=np.int64)
        real = src < (self.shard_nv_pad or nvp)
        owned = real & (d >= g * nvp) & (d < (g + 1) * nvp)
        out[owned] = d[owned] - g * nvp
        ghost = real & ~owned
        out[ghost] = nvp + np.searchsorted(self.ghost_ids[g], d[ghost])
        return out

    def to_mesh(self, mesh) -> tuple:
        """(send_idx, ghost_sel) of the mesh's local shards as int64
        tensors on their devices: the [S, B] send rows and [G] ghost
        selection of each shard's plan shard (its group's on a two-level
        plan, ``comm/mesh.shard_outer``)."""
        return (shard_outer(mesh, self.send_idx.astype(np.int64), self.ici),
                shard_outer(mesh, self.ghost_sel.astype(np.int64), self.ici))


def _gather_ghost_lists(local: list, S: int) -> list:
    """Every shard's ghost (or reference) list, from each rank's lists of
    its own shards (``multihost.allgather_varlen``), in shard order."""
    from cuvite_tpu_torch.comm.multihost import allgather_varlen

    lens = np.array([len(g) for g in local], dtype=np.int64)
    flat = (np.concatenate(local) if local
            else np.zeros(0, dtype=np.int64))
    out = []
    for ls, fl in zip(allgather_varlen(lens), allgather_varlen(flat)):
        out += np.split(fl, np.cumsum(ls)[:-1])
    if len(out) != S:
        raise RuntimeError(
            f"ghost exchange gathered {len(out)} shard lists for {S} "
            "shards")
    return out


class SparseEnv(NamedTuple):
    """One shard's community state of a sweep under the sparse exchange."""

    comm_ext: torch.Tensor    # [nv_pad + G] int32 community, owned + ghost
    cdeg_ext: torch.Tensor    # [nv_pad + G] f32 degree of that community
    csize_ext: torch.Tensor   # [nv_pad + G] int32 size of that community
    cdeg_v: torch.Tensor      # [nv_pad] f32 owned slice of cdeg_ext
    csize_v: torch.Tensor     # [nv_pad] int32 owned slice of csize_ext
    deg_local: torch.Tensor   # [nv_pad] f64 degree of the OWNED communities
    overflow: torch.Tensor    # 0-dim bool: the budget overflowed


def _pull_ghosts(channels: list, send_idx: list, ghost_sel: list,
                 mesh) -> list:
    """One all_to_all over the ghost routing for every channel (the
    reference's ``_pull_ghosts``, ``_pull_ghosts2`` and ``_pull_ghosts3``):
    each channel is a per-shard list of [nv_pad] 32-bit values; every
    shard sends the requested owned values of all channels as one
    [S, C, B] block (floats by their bits) and appends its ghosts' values
    to its own.  Returns the [nv_pad + G] extended channels."""
    dts = [ch[0].dtype for ch in channels]
    sent = []
    for s, idx in enumerate(send_idx):
        vals = [ch[s].view(torch.int32) for ch in channels]
        i = idx.clamp(max=vals[0].shape[0] - 1)
        sent.append(torch.stack([v[i] for v in vals], dim=1))
    recv = all_to_all(sent, mesh)
    return [[torch.cat([ch[s], recv[s][:, k].reshape(-1)[ghost_sel[s]]
                        .view(dt)])
             for s in range(len(send_idx))]
            for k, (ch, dt) in enumerate(zip(channels, dts))]


class _Grouping(NamedTuple):
    uk: torch.Tensor         # [nv_pad] sorted distinct communities, sentinel
    run_id: torch.Tensor     # [nv_pad] run of each sorted vertex
    order: torch.Tensor      # [nv_pad] vertex of each sorted position
    is_self: torch.Tensor    # [nv_pad] uk owned by this shard
    is_remote: torch.Tensor  # [nv_pad] uk owned by another shard
    slot: torch.Tensor       # [nv_pad] owner * budget + rank
    ok: torch.Tensor         # [nv_pad] remote and within the budget
    overflow: torch.Tensor   # 0-dim bool


def _group_by_community(vec: torch.Tensor, nv_pad: int, S: int, budget: int,
                        base: int) -> _Grouping:
    """Sort-group one shard's owned community vector: the distinct
    communities in order, each vertex's run, and the owner route of the
    remote ones (slot in the per-peer block, within the budget or not)."""
    dev = vec.device
    ck, order = torch.sort(vec, stable=True)
    lead = torch.ones(nv_pad, dtype=torch.bool, device=dev)
    lead[1:] = ck[1:] != ck[:-1]
    run_id = torch.cumsum(lead, 0) - 1
    uk = torch.full((nv_pad,), SENTINEL, dtype=vec.dtype, device=dev)
    uk[run_id] = ck
    valid = uk != SENTINEL
    is_self = valid & (uk >= base) & (uk < base + nv_pad)
    is_remote = valid & ~is_self
    # uk is sorted, so each owner's communities are contiguous; the rank
    # within the owner's group is the slot in its per-peer block.
    bnd = torch.searchsorted(
        uk, torch.arange(S + 1, device=dev, dtype=vec.dtype) * nv_pad)
    o_j = (uk // nv_pad).clamp(0, S - 1).long()
    rank = torch.arange(nv_pad, device=dev) - bnd[o_j]
    slot = o_j * budget + rank
    ok = is_remote & (rank < budget)
    overflow = (is_remote & (rank >= budget)).any()
    return _Grouping(uk, run_id, order, is_self, is_remote, slot, ok,
                     overflow)


def sparse_env(comms: list, vdegs: list, send_idx: list, ghost_sel: list,
               mesh, *, budget: int, info: list | None = None) -> list:
    """The local shards' :class:`SparseEnv` for the sweep of ``comms``.

    ``comms`` [nv_pad] int32 and ``vdegs`` [nv_pad] f32 per local shard
    are the owned slices; ``send_idx``/``ghost_sel`` the plan's per-shard
    tensors (:meth:`ExchangePlan.to_mesh`).  ``info``: per local shard the
    frozen assignment of vertex ordering (reference ``exchange.py:349``):
    the tables are accumulated by grouping it, while the requests and the
    attachment follow ``comms``; its grouping's overflow joins the
    flag."""
    S = mesh.size
    nv_pad = comms[0].shape[0]
    oob = S * budget
    groups, overflows, deg_local, size_local, fwd, req = [], [], [], [], \
        [], []
    for i, (s, comm, vdeg) in enumerate(zip(mesh.shard_ids, comms, vdegs)):
        dev = comm.device
        base = s * nv_pad
        gr = _group_by_community(comm, nv_pad, S, budget, base)
        groups.append(gr)
        acc = gr
        if info is not None:
            acc = _group_by_community(info[i], nv_pad, S, budget, base)
            # The request route: the current grouping's keys, alone.
            rkey = torch.full((oob + 1,), SENTINEL, dtype=torch.int32,
                              device=dev)
            rkey[torch.where(gr.ok, gr.slot, oob)] = gr.uk
            req.append(rkey[:oob].view(S, budget))
        overflows.append(gr.overflow | acc.overflow)
        pdeg = torch.zeros(nv_pad, dtype=torch.float64, device=dev)
        pdeg.index_add_(0, acc.run_id, vdeg[acc.order].double())
        psize = torch.zeros(nv_pad, dtype=torch.int32, device=dev)
        psize.index_add_(0, acc.run_id,
                         torch.ones(nv_pad, dtype=torch.int32, device=dev))
        # Self-owned communities: accumulated here, no communication.
        self_idx = torch.where(acc.is_self, acc.uk.long() - base, nv_pad)
        dl = torch.zeros(nv_pad + 1, dtype=torch.float64, device=dev)
        dl.index_add_(0, self_idx, torch.where(acc.is_self, pdeg, 0.0))
        sl = torch.zeros(nv_pad + 1, dtype=torch.int32, device=dev)
        sl.index_add_(0, self_idx, torch.where(acc.is_self, psize, 0))
        deg_local.append(dl)
        size_local.append(sl)
        # Remote-owned: (key, partial degree, partial size) to the owner,
        # slots past the budget dropped.
        sslot = torch.where(acc.ok, acc.slot, oob)
        key = torch.full((oob + 1,), SENTINEL, dtype=torch.int32, device=dev)
        key[sslot] = acc.uk
        sdeg = torch.zeros(oob + 1, dtype=torch.float64, device=dev)
        sdeg[sslot] = pdeg
        ssize = torch.zeros(oob + 1, dtype=torch.int32, device=dev)
        ssize[sslot] = psize
        fwd.append((key[:oob].view(S, budget), sdeg[:oob].view(S, budget),
                    ssize[:oob].view(S, budget)))
    recv_key = all_to_all([f[0] for f in fwd], mesh)
    recv_deg = all_to_all([f[1] for f in fwd], mesh)
    recv_size = all_to_all([f[2] for f in fwd], mesh)
    recv_req = recv_key if info is None else all_to_all(req, mesh)

    # Owners add the partials they received (sentinel keys drop) and reply
    # with the totals of the requested keys over the transposed routing.
    rep_deg, rep_size = [], []
    for i, s in enumerate(mesh.shard_ids):
        base = s * nv_pad
        lk = recv_key[i].reshape(-1).long() - base
        lk_in = torch.where((lk >= 0) & (lk < nv_pad), lk, nv_pad)
        deg_local[i].index_add_(0, lk_in, recv_deg[i].reshape(-1))
        size_local[i].index_add_(0, lk_in, recv_size[i].reshape(-1))
        deg_local[i] = deg_local[i][:nv_pad]
        size_local[i] = size_local[i][:nv_pad]
        lk_safe = (recv_req[i].reshape(-1).long() - base).clamp(0,
                                                                nv_pad - 1)
        rep_deg.append(deg_local[i][lk_safe].view(S, budget))
        rep_size.append(size_local[i][lk_safe].view(S, budget))
    back_deg = all_to_all(rep_deg, mesh)
    back_size = all_to_all(rep_size, mesh)

    cdeg_v, csize_v = [], []
    for i, (s, gr) in enumerate(zip(mesh.shard_ids, groups)):
        base = s * nv_pad
        flat_slot = gr.slot.clamp(0, oob - 1)
        self_safe = (gr.uk.long() - base).clamp(0, nv_pad - 1)
        deg_at_uk = torch.where(gr.is_self, deg_local[i][self_safe],
                                back_deg[i].reshape(-1)[flat_slot])
        size_at_uk = torch.where(gr.is_self, size_local[i][self_safe],
                                 back_size[i].reshape(-1)[flat_slot])
        # Attach the totals to the owned vertices (invert the sort).
        cd = torch.empty(nv_pad, dtype=torch.float32, device=gr.uk.device)
        cd[gr.order] = deg_at_uk[gr.run_id].float()
        cs = torch.empty(nv_pad, dtype=torch.int32, device=gr.uk.device)
        cs[gr.order] = size_at_uk[gr.run_id]
        cdeg_v.append(cd)
        csize_v.append(cs)

    comm_ext, csize_ext, cdeg_ext = _pull_ghosts(
        [comms, csize_v, cdeg_v], send_idx, ghost_sel, mesh)
    return [SparseEnv(comm_ext=comm_ext[i], cdeg_ext=cdeg_ext[i],
                      csize_ext=csize_ext[i], cdeg_v=cdeg_v[i],
                      csize_v=csize_v[i], deg_local=deg_local[i],
                      overflow=overflows[i])
            for i in range(len(groups))]


def twolevel_env(comms: list, vdegs: list, send_idx: list,
                 ghost_sel: list, mesh, *, n_dcn: int, budget: int,
                 info: list | None = None) -> list:
    """The local shards' :class:`SparseEnv` under the two-level exchange
    of a hybrid mesh (reference ``exchange.py:497-531``).  A tiled
    all-gather over each ICI group gives every member the group's
    [nv_grp] community and degree vectors (and ``info``'s); then
    :func:`sparse_env` runs unchanged at group scale over each DCN
    column, with the grouped plan's per-shard ``send_idx``/``ghost_sel``
    (every member of a group holds the same rows and computes the same
    bits).  The ``*_ext`` fields and ``deg_local`` are group-scale;
    ``cdeg_v`` and ``csize_v`` are sliced back to the shard's own window
    at ``(s % ici) * nv_pad``."""
    n = len(comms)
    nv_pad = comms[0].shape[0]
    ici = mesh.size // n_dcn

    def over_ici(xs):
        out = [None] * n
        for view, pos in mesh.ici_views:
            for p, x in zip(pos, all_gather([xs[p] for p in pos], view)):  # graftlint: replicated-ok=scope=ici; group community and degree vectors gathered only inside the ICI group — O(nv_total/n_dcn) per card, the two-level contract
                out[p] = x
        return out

    comm_g, vdeg_g = over_ici(comms), over_ici(vdegs)
    info_g = None if info is None else over_ici(info)
    envs = [None] * n
    for view, pos in mesh.dcn_views:
        col = sparse_env([comm_g[p] for p in pos], [vdeg_g[p] for p in pos],
                         [send_idx[p] for p in pos],
                         [ghost_sel[p] for p in pos], view, budget=budget,
                         info=None if info_g is None
                         else [info_g[p] for p in pos])
        for p, env in zip(pos, col):
            envs[p] = env
    out = []
    for s, env in zip(mesh.shard_ids, envs):
        off = (s % ici) * nv_pad
        out.append(env._replace(cdeg_v=env.cdeg_v[off:off + nv_pad],
                                csize_v=env.csize_v[off:off + nv_pad]))
    return out


def sparse_modularity(counter0: list, deg_local: list, constant: float,
                      mesh, *, twolevel: bool = False) -> torch.Tensor:
    """Q = e*c - a^2*c^2 in f64, the a^2 term from each shard's OWNED
    community degrees so that every community counts once.  Under the
    two-level exchange (``twolevel``) ``deg_local`` is a group's, the
    same on every member, so the a^2 term sums over the DCN columns only
    while the e term sums over every shard.  Returns the 0-dim f64 Q on
    the first local shard's device."""
    le = psum([c.double().sum() for c in counter0], mesh)[0]
    sq = [d.double().square().sum() for d in deg_local]
    if twolevel:
        view, pos = next((v, p) for v, p in mesh.dcn_views if 0 in p)
        la2 = psum([sq[p] for p in pos], view)[pos.index(0)]
    else:
        la2 = psum(sq, mesh)[0]
    return le * constant - la2 * constant * constant
