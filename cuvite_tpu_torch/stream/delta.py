"""Delta ingestion against the resident slab on the card (port of
``cuvite_tpu/stream/delta.py``).

A live graph changes between requests.  Rebuilding the CSR and uploading
the slab again for every change would throw away the residency the fused
engine keeps, so edits apply to the slab where it lies:

  * :class:`DeltaBatch` -- one canonical edit batch: symmetrized like
    ``Graph.from_edges`` (an undirected insert lands as (u, v) and
    (v, u), a self-loop once), duplicate inserts summed, deletes
    deduplicated, rows ascending by (src, dst).  Canonical form makes the
    batch, and with it the fingerprint lineage that warm starts are
    checked against, a function of the edit multiset, not of the arrival
    order.  Host numpy, the reference's code.
  * :func:`apply_delta_slab` -- the one function that mutates a resident
    slab: deletes are found by a binary search over the sorted slab and
    retired in place as padding rows (src -> nv_pad, dst -> 0, w -> 0);
    inserts are written into the padding headroom after row ``ne``; then
    the whole slab is coalesced again (``ops/segment.
    coalesced_runs_batched``, sort engine), whose output -- ascending
    (src, dst), duplicates summed, compacted, padding after -- is the slab
    ``stream/session.canonical_slab`` builds from ``Graph.from_edges`` of
    the edited edge list.
  * :func:`delta_frontier` and :func:`plp_prepass` -- the warm start's
    active set and the label-propagation seed.

Differences from the reference, by design:

- The binary search is ``torch.searchsorted`` over the packed int64 key
  src * nv_pad + dst; the reference runs a pure-int32 lexicographic
  search because its device keeps 64-bit types out.  Both find the first
  row >= each query on a canonical slab.
- Torch has no dropping scatter.  Retired rows are marked in a mask with
  one scratch slot past the end and applied by ``torch.where`` over the
  slab; inserts are written into the slice [ne, ne + d_pad) clipped to
  the slab, since the host knows ``ne``.  Nothing here reads a device
  value on the host: the caller reads ne2, del_w, n_del_hit and the
  frontier size in one fetch.
- Duplicate weights and the retired weight are summed in f64 and rounded
  once to f32 (the reference sums in f32, or double-single pairs for a
  large 2m), so the slab and ``del_w`` equal the reference's wherever
  the sums are exact: unit base weights and the churn's dyadic insert
  weights 1..8.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from cuvite_tpu_torch.core.types import next_pow2
from cuvite_tpu_torch.ops import segment as seg
from cuvite_tpu_torch.ops.segment import TenantConstants

# Floor on the padded delta-batch class (reference ``:59``): batches pad
# to max(next_pow2(n), DELTA_PAD_MIN), the reference's compiled shapes.
DELTA_PAD_MIN = 256


def _canon_pairs(src, dst, nv: int, what: str):
    """Validate + symmetrize an edit pair list: int64 arrays, ids in
    [0, nv); (u, v) with u != v contributes both directions, a self-loop
    once -- exactly Graph.from_edges' symmetrize convention."""
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    if src.shape != dst.shape:
        raise ValueError(f"{what}: src/dst length mismatch "
                         f"({src.size} vs {dst.size})")
    if src.size and (src.min() < 0 or dst.min() < 0
                     or src.max() >= nv or dst.max() >= nv):
        raise ValueError(
            f"{what}: vertex id out of range [0, {nv}) — streaming "
            "deltas mutate edges among the session's existing vertices")
    off = src != dst
    return (np.concatenate([src, dst[off]]),
            np.concatenate([dst, src[off]]), off)


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One canonical edge edit batch against an ``nv``-vertex graph.

    ``ins_src``/``ins_dst``/``ins_w``: coalesced symmetrized inserts in
    ascending (src, dst) order; ``del_src``/``del_dst``: deduped
    symmetrized deletes, same order.  Deletes apply to the BASE slab
    first, inserts after -- so the rebuild oracle for a batch is
    ``(base_edges - deletes) + inserts``.
    """

    num_vertices: int
    ins_src: np.ndarray
    ins_dst: np.ndarray
    ins_w: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray

    @property
    def n_ins(self) -> int:
        return int(self.ins_src.size)

    @property
    def n_del(self) -> int:
        return int(self.del_src.size)

    @staticmethod
    def from_edits(num_vertices: int, ins_src=(), ins_dst=(), ins_w=None,
                   del_src=(), del_dst=()) -> "DeltaBatch":
        nv = int(num_vertices)
        if nv <= 0:
            raise ValueError("num_vertices must be positive")
        isrc, idst, off = _canon_pairs(ins_src, ins_dst, nv, "inserts")
        n_in = off.size                       # original (pre-mirror) pairs
        if ins_w is None:
            w = np.ones(isrc.shape, dtype=np.float64)
        else:
            # Weights are given per INPUT pair; mirror like the pairs.
            w0 = np.asarray(ins_w, dtype=np.float64).ravel()
            if w0.size != n_in:
                raise ValueError(f"inserts: weight length mismatch "
                                 f"({w0.size} weights, {n_in} pairs)")
            w = np.concatenate([w0, w0[off]])
        if w.size and (not np.all(np.isfinite(w)) or np.any(w < 0)):
            raise ValueError("inserts: weights must be finite and >= 0")
        # Coalesce duplicate insert pairs (sum in f64, like from_edges)
        # and land in ascending (src, dst) order.
        if isrc.size:
            key = isrc * nv + idst
            order = np.argsort(key, kind="stable")
            key, isrc, idst, w = key[order], isrc[order], idst[order], \
                w[order]
            first = np.concatenate([[True], key[1:] != key[:-1]])
            seg_id = np.cumsum(first) - 1
            wsum = np.zeros(int(seg_id[-1]) + 1, dtype=np.float64)
            np.add.at(wsum, seg_id, w)
            isrc, idst, w = isrc[first], idst[first], wsum
        dsrc, ddst, _ = _canon_pairs(del_src, del_dst, nv, "deletes")
        if dsrc.size:
            key = dsrc * nv + ddst
            key = np.unique(key)
            dsrc, ddst = key // nv, key % nv
        return DeltaBatch(
            num_vertices=nv,
            ins_src=isrc.astype(np.int64), ins_dst=idst.astype(np.int64),
            ins_w=w.astype(np.float64),
            del_src=dsrc.astype(np.int64), del_dst=ddst.astype(np.int64))

    def digest(self) -> int:
        """Content digest of the canonical batch, folded into the
        session's fingerprint lineage (stream/session.py), so a warm
        start against labels from a different edit history is refused
        by arithmetic, not by convention."""
        h = zlib.crc32(np.ascontiguousarray(self.ins_src).view(np.uint8))
        h = zlib.crc32(np.ascontiguousarray(self.ins_dst).view(np.uint8), h)
        h = zlib.crc32(np.ascontiguousarray(self.ins_w).view(np.uint8), h)
        h = zlib.crc32(np.ascontiguousarray(self.del_src).view(np.uint8), h)
        h = zlib.crc32(np.ascontiguousarray(self.del_dst).view(np.uint8), h)
        return h

    def padded(self, d_pad: int | None = None):
        """The operand arrays of :func:`apply_delta_slab`, padded to a
        pow2 ``d_pad`` class: int32 ids with -1 in the pad rows (masked
        there) and f32 insert weights.  Returns (ins_src, ins_dst, ins_w,
        del_src, del_dst, d_pad)."""
        if d_pad is None:
            d_pad = max(next_pow2(max(self.n_ins, self.n_del, 1)),
                        DELTA_PAD_MIN)

        def pad_ids(a):
            out = np.full(d_pad, -1, dtype=np.int32)
            out[:a.size] = a
            return out

        iw = np.zeros(d_pad, dtype=np.float32)
        iw[:self.n_ins] = self.ins_w
        return (pad_ids(self.ins_src), pad_ids(self.ins_dst), iw,
                pad_ids(self.del_src), pad_ids(self.del_dst), d_pad)


def _lex_search(src: torch.Tensor, dst: torch.Tensor, q_src: torch.Tensor,
                q_dst: torch.Tensor, *, nv_pad: int) -> tuple:
    """First slab row whose (src, dst) is >= each query pair (reference
    ``:183``), by ``torch.searchsorted`` over the packed key
    src * nv_pad + dst: dst < nv_pad, so the key orders as the pair, and
    a padding row (nv_pad, 0) sorts after every real one.  Returns
    (row, slab keys, query keys)."""
    key = src.long() * nv_pad + dst.long()
    qkey = q_src.long() * nv_pad + q_dst.long()
    return torch.searchsorted(key, qkey), key, qkey


def apply_delta_slab(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                     ins_src: torch.Tensor, ins_dst: torch.Tensor,
                     ins_w: torch.Tensor, del_src: torch.Tensor,
                     del_dst: torch.Tensor, ne: int, *,
                     nv_pad: int) -> tuple:
    """Apply one batch to a resident slab (reference ``:205``).

    ``src``/``dst``/``w``: the [ne_pad] canonical slab (ascending (src,
    dst), coalesced, padding src == nv_pad / dst == 0 / w == 0 after its
    first ``ne`` rows; int32, int32, f32).  ``ins_*``/``del_*``: the
    [d_pad] operands of :meth:`DeltaBatch.padded` on the slab's device
    (pad rows id == -1).  ``ne``: the real row count, a host int.  The
    inputs are not modified.

    Returns ``(src2, dst2, w2, ne2, del_w, n_del_hit)``: the edited slab
    in canonical form in the same [ne_pad] class; its real row count, the
    total weight of the retired rows (f64 sum rounded once to f32; the
    host's 2m fixup subtracts it, inserts add their own known mass) and
    how many deletes matched a resident edge (a delete of an absent edge
    is a no-op, as in the rebuild oracle's set difference), as 0-dim
    tensors on the device.
    """
    ne_pad = src.shape[0]
    dev = src.device

    # Deletes: locate and retire as padding rows.
    q_valid = del_src >= 0
    qs = torch.where(q_valid, del_src, nv_pad)
    qd = torch.where(q_valid, del_dst, 0)
    pos, key, qkey = _lex_search(src, dst, qs, qd, nv_pad=nv_pad)
    pos = pos.clamp(max=ne_pad - 1)
    hit = q_valid & (key[pos] == qkey)
    del_w = torch.where(hit, w[pos].double(), 0.0).sum().float()
    n_del_hit = hit.sum()
    # Row ne_pad is the scratch slot of the misses.  index_fill_, not
    # ``x[idx] = True``: a Python value assigned through indexing goes
    # through a host tensor, a synchronizing copy.
    retire = torch.zeros(ne_pad + 1, dtype=torch.bool, device=dev)
    retire.index_fill_(0, torch.where(hit, pos, ne_pad), True)
    retire = retire[:ne_pad]
    src1 = torch.where(retire, nv_pad, src).to(src.dtype)
    dst1 = torch.where(retire, 0, dst).to(dst.dtype)
    w1 = torch.where(retire, 0.0, w).to(w.dtype)

    # Inserts: the batch's rows into the padding headroom after row ne.
    # Rows that do not fit are dropped, as the reference's out-of-range
    # scatter drops them; pad rows write padding over padding.
    k = max(min(ins_src.shape[0], ne_pad - int(ne)), 0)
    if k:
        i_valid = ins_src[:k] >= 0
        src1[ne:ne + k] = torch.where(i_valid, ins_src[:k], nv_pad)
        dst1[ne:ne + k] = torch.where(i_valid, ins_dst[:k], 0)
        w1[ne:ne + k] = torch.where(i_valid, ins_w[:k].to(w.dtype), 0.0)

    # Canonical form again, through the sort engine's coalesce.
    src2, dst2, w2, n = seg.coalesced_runs_batched(
        src1[None], dst1[None], w1[None], nv_pad=nv_pad, engine="sort")
    return src2[0], dst2[0], w2[0], n[0], del_w, n_del_hit


def delta_frontier(src: torch.Tensor, dst: torch.Tensor,
                   ins_src: torch.Tensor, ins_dst: torch.Tensor,
                   del_src: torch.Tensor, del_dst: torch.Tensor, *,
                   nv_pad: int) -> tuple:
    """Warm-start active set of a delta (reference ``:266``): every
    insert and delete endpoint plus its slab neighbours -- the vertices
    whose best community could have changed -- instead of all of them.
    Runs on the slab after the edit, so inserted edges propagate and
    retired rows do not.  Returns ``(frontier [nv_pad] bool, n_frontier
    0-dim int64)``, both on the device."""
    dev = src.device
    touched = torch.zeros(nv_pad + 1, dtype=torch.bool, device=dev)
    for a in (ins_src, ins_dst, del_src, del_dst):
        touched.index_fill_(0, torch.where(a >= 0, a, nv_pad).long(), True)
    pad = src >= nv_pad
    s_c = src.clamp(max=nv_pad - 1).long()
    d_c = dst.long()
    hot = (touched[s_c] | touched[d_c]) & ~pad
    fr = touched
    fr.index_fill_(0, torch.where(hot, s_c, nv_pad), True)
    fr.index_fill_(0, torch.where(hot, d_c, nv_pad), True)
    fr = fr[:nv_pad]
    return fr, fr.sum()


def plp_prepass(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                vdeg: torch.Tensor, *, nv_pad: int,
                iters: int = 3) -> torch.Tensor:
    """PLP label-propagation prepass (Staudt & Meyerhenke,
    arXiv:1304.4453; reference ``:290``): ``iters`` synchronous sweeps of
    the Louvain step from the identity with ``constant = 0``, under which
    the gain degenerates to ``2*(e_{i->y} - e_{i->x})`` -- adopt the
    neighbour community with the largest incident weight, ties to the
    smaller id.  The cheap seed the ``plp`` warm-start arm sets against
    the previous labels.  Returns [nv_pad] int32 labels."""
    from cuvite_tpu_torch.louvain.step import louvain_step_local

    comm = torch.arange(nv_pad, dtype=torch.int32, device=src.device)
    zero = TenantConstants.of(0.0, src.device)
    for _ in range(int(iters)):
        comm = louvain_step_local(src, dst, w, comm, vdeg, zero).target
    return comm
