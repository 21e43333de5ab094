"""Degree-bucketed Louvain sweep on one device (port of
``cuvite_tpu/louvain/bucketed.py``).

Vertices are bucketed by degree into fixed-width padded rows ``[Nb, D]``
(``DEFAULT_BUCKETS`` 8 ... 8192) once per phase; vertices of larger degree
are the heavy residual (the hubs).  Every sweep runs the row-argmax kernel
over each bucket and the heavy kernel over the hubs, assembles the
per-vertex best moves, applies the singleton guard and computes Q and the
number of moves -- the reference's ``bucketed_step`` with its
single-device replicated exchange.

The host ``BucketPlan`` is the reference's array for array, padding rows
included: every class pads its row count to a power of two so the TPU's
compiled shapes stay few.  Eager torch has no compile cache, so the device
plan keeps no padded row: ``DevicePlan.upload`` sends only the real rows
of each bucket (a prefix, ``verts < nv_local``) with their degrees, and the
row kernel stops each row at its degree.  A padding row cost the card a
full row of work against one address (all its slots are the same key), and
a padded slot a read; neither changes a target.

The coloring and vertex-ordering schedules sweep one plan per color
class (:func:`build_class_plans`): a class's sweep runs the same kernels
over its own vertices' rows only, and ``bucketed_step(..., info_comm=)``
takes the community degree and size tables from a frozen assignment for
vertex ordering.  :func:`bucketed_modularity` gives such an iteration its
Q at its start, over the class plans together.

Batches: the batched engine (``louvain/batched.py``) folds B tenants into
one id space, tenant b's vertex v as b * nv_pad + v, and sweeps them
together: :func:`fold_plans` joins the tenants' host plans into one (one
launch per width class for every tenant), ``coarsen/rebin.device_plan``
builds one on the card from a folded slab, and ``bucketed_step`` takes
the batch's ``TenantConstants`` and returns every tenant's Q and moved
count.  Nothing in a sweep mixes tenants: a community id never leaves
its tenant's range.

A vertex mesh (``comm/mesh.py``): :func:`build_stacked_plans` builds
one plan per shard, :class:`MeshPlan` places each shard's real rows on
its device, and :func:`sharded_bucketed_step` sweeps every shard under
the replicated exchange (padded-global tails against the all-gathered
community vector and psum'd tables; each shard's hubs on the heavy
kernel) or the sparse ghost exchange (extended-local tails against
``comm/exchange.sparse_env``; the rows on the row kernel's size form,
``row_argmax_sized``, which carries the winner's size to the singleton
guard, and the hubs on the reference's sorted path with sizes, in plain
PyTorch, as the reference has no size-tracking heavy kernel).  The color
schedules run there too: :func:`build_mesh_class_plans` gives each color
class its own per-shard plans (under the sparse exchange all over the
phase's one routing), ``sharded_bucketed_step(..., info_comms=)`` is a
class step (``make_sharded_class_step``) and
:func:`sharded_bucketed_modularity` the iteration's Q pass
(``make_sharded_bucketed_mod``).  A shard with no row in a class still
takes part in every collective of its step.  The two-level exchange of
a hybrid mesh (``exchange='twolevel'``) is the sparse path over the
grouped plan: tails group-extended, each shard's self-loops found at its
offset ``(s % ici) * nv_pad`` in its group's window, the environment
from ``comm/exchange.twolevel_env`` and the a^2 term of Q summed over
the DCN columns.  Coarse phases of the
per-graph driver build their plan on the card (``coarsen/rebin.py``)
where the reference does; the host build here stays its bit-parity
oracle and the path for the other phases.

Numbers: the community degrees are summed in float64 and rounded once to
float32 for the kernels, and the in-loop Q is float64 end to end; the
reference sums in float32 (or double-single pairs).  On the exactness
domain (integer weights below 2^24, dyadic weights) the per-sweep targets
are the same.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cuvite_tpu_torch import native
from cuvite_tpu_torch.comm.collectives import all_gather, psum
from cuvite_tpu_torch.comm.exchange import (
    sparse_env,
    sparse_modularity,
    twolevel_env,
)
from cuvite_tpu_torch.kernels.heavy_bincount import (
    HeavyLayout,
    build_heavy_layout,
    heavy_argmax,
)
from cuvite_tpu_torch.kernels.row_argmax import (
    SENTINEL,
    attached_vertex_table,
    row_argmax,
    row_argmax_sized,
    slot_table,
    vertex_table,
)
from cuvite_tpu_torch.ops import segment as seg
from cuvite_tpu_torch.ops.segment import TenantConstants
from cuvite_tpu_torch.utils.upload import (
    aligned_full,
    aligned_zeros,
    to_device,
)

DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 384, 512, 768, 1024, 1536,
                   2048, 3072, 4096, 6144, 8192)


@dataclasses.dataclass
class Bucket:
    width: int
    verts: np.ndarray    # [Nb] local vertex indices (padding rows: nv_local)
    dst: np.ndarray      # [Nb, D] tail ids; pad -> the row's own vertex
    w: np.ndarray        # [Nb, D] weights; pad -> 0 (uint8 on unit graphs)


@dataclasses.dataclass
class BucketPlan:
    """Phase-static layout of one edge slab."""

    nv_local: int
    buckets: list            # list[Bucket]
    heavy_src: np.ndarray    # [NEh_pad] src of heavy edges (pad nv_local)
    heavy_dst: np.ndarray    # [NEh_pad] tail ids (pad 0)
    heavy_w: np.ndarray      # [NEh_pad] weights (pad 0)
    self_loop: np.ndarray    # [nv_local] per-vertex self-loop weight
    has_heavy: bool
    deg: np.ndarray          # [nv_local] int64 edges of each vertex

    @staticmethod
    def build(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
              nv_local: int, base: int = 0) -> "BucketPlan":
        """``src`` holds local vertex ids (pad = nv_local), ``dst`` tail ids
        in the space ``base`` + local id lives in: the single shard starts
        at 0, shard s of a mesh at s * nv_pad under the replicated
        exchange, and at 0 under the sparse one (extended-local tails).
        The reference's plan with its default widths, array for array:
        the native streamed build (:func:`_build_native`) where it
        applies, else the numpy path below, its plain version."""
        plan = _build_native(src, dst, w, nv_local, base)
        if plan is not None:
            return plan
        real = src < nv_local
        s = src[real].astype(np.int64)
        d = dst[real].astype(np.int64)
        ww = w[real].astype(np.float64)
        deg = np.bincount(s, minlength=nv_local)
        if len(s) and np.any(s[:-1] > s[1:]):
            order = np.argsort(s, kind="stable")
            s, d, ww = s[order], d[order], ww[order]
        row_start = np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(
            np.int64)

        self_loop = np.zeros(nv_local, dtype=np.float64)
        is_self = d == s + base
        np.add.at(self_loop, s[is_self], ww[is_self])

        # Every real edge weighs exactly 1: the weight matrix is the
        # has-edge mask, emitted as uint8.
        unit = len(ww) == 0 or bool(np.all(ww == 1.0))

        buckets = []
        prev = 0
        for width in DEFAULT_BUCKETS:
            sel = np.nonzero((deg > prev) & (deg <= width))[0]
            prev = width
            if len(sel) == 0:
                continue
            nb = len(sel)
            # Row counts pad to a power of two; padding rows use nv_local.
            nb_pad = 1 << int(nb - 1).bit_length() if nb > 1 else 1
            verts = aligned_full(nb_pad, nv_local, np.int64)
            verts[:nb] = sel
            dmat = aligned_zeros((nb_pad, width), dst.dtype)
            cols = np.arange(width)
            idx = row_start[sel][:, None] + cols[None, :]
            has = cols[None, :] < deg[sel][:, None]
            idx = np.minimum(idx, max(len(d) - 1, 0))
            dmat[:nb] = np.where(has, d[idx], (sel + base)[:, None])
            if unit:
                wmat = aligned_zeros((nb_pad, width), np.uint8)
                wmat[:nb] = has
            else:
                wmat = aligned_zeros((nb_pad, width), w.dtype)
                wmat[:nb] = np.where(has, ww[idx], 0.0)
            buckets.append(Bucket(width=width, verts=verts, dst=dmat,
                                  w=wmat))

        heavy_v = np.nonzero(deg > DEFAULT_BUCKETS[-1])[0]
        if len(heavy_v):
            is_heavy = np.zeros(nv_local + 1, dtype=bool)
            is_heavy[heavy_v] = True
            hmask = is_heavy[s]
            hs, hd, hw = s[hmask], d[hmask], ww[hmask]
            n = len(hs)
            npad = max(int(2 ** np.ceil(np.log2(max(n, 1)))), 8)
            heavy_src = aligned_full(npad, nv_local, src.dtype)
            heavy_dst = aligned_zeros(npad, dst.dtype)
            heavy_w = aligned_zeros(npad, w.dtype)
            heavy_src[:n] = hs
            heavy_dst[:n] = hd
            heavy_w[:n] = hw
            has_heavy = True
        else:
            heavy_src = np.full(8, nv_local, dtype=src.dtype)
            heavy_dst = np.zeros(8, dtype=dst.dtype)
            heavy_w = np.zeros(8, dtype=w.dtype)
            has_heavy = False
        return BucketPlan(
            nv_local=nv_local,
            buckets=buckets,
            heavy_src=heavy_src,
            heavy_dst=heavy_dst,
            heavy_w=heavy_w,
            self_loop=self_loop.astype(w.dtype),
            has_heavy=has_heavy,
            deg=deg,
        )


def _build_native(src, dst, w, nv_local: int, base: int):
    """The plan from the native host runtime in two O(E) passes
    (``native.plan_scan``, then ``native.bucket_fill`` into matrices
    allocated here), with no transient larger than O(nv)
    (``cuvite_tpu/louvain/bucketed.py:245-310``).  None, for the numpy
    path, when the library is off, the slab is below
    ``native.MIN_NATIVE_EDGES``, the dtypes are mixed or not contiguous,
    or the slab is not CSR-sorted with its padding at the tail."""
    if (not native.available() or len(src) < native.MIN_NATIVE_EDGES
            or src.dtype != dst.dtype
            or src.dtype not in (np.int32, np.int64)
            or w.dtype not in (np.float32, np.float64)
            or not (src.flags.c_contiguous and dst.flags.c_contiguous
                    and w.flags.c_contiguous)):
        return None
    self_loop, sorted_, unit, tail_ok = native.plan_scan(
        src, dst, w, nv_local, base)
    if not (sorted_ and tail_ok):
        return None
    deg = np.bincount(src, minlength=nv_local + 1)[:nv_local]
    widths = np.asarray(DEFAULT_BUCKETS, dtype=np.int64)
    cls_idx = np.searchsorted(widths, deg, side="left")
    heavy = deg > widths[-1]
    in_bucket = (deg > 0) & ~heavy
    counts = np.bincount(cls_idx[in_bucket], minlength=len(widths))
    kept = np.nonzero(counts)[0]
    # Class codes: the kept class's index, 254 heavy, 255 no row.
    remap = np.full(len(widths) + 1, 255, dtype=np.uint8)
    remap[kept] = np.arange(len(kept), dtype=np.uint8)
    cls = np.full(nv_local, 255, dtype=np.uint8)
    cls[in_bucket] = remap[cls_idx[in_bucket]]
    cls[heavy] = 254
    row_start = np.zeros(nv_local, dtype=np.int64)
    np.cumsum(deg[:-1], out=row_start[1:])
    nb_pad = np.array([1 << int(n - 1).bit_length() if n > 1 else 1
                       for n in counts[kept]], dtype=np.int64)
    widths_kept = widths[kept]
    wm_dtype = np.uint8 if unit else w.dtype
    # The O(E) matrices 64-byte aligned, as the reference allocates them
    # (utils/upload.py).
    verts = [aligned_full(n, nv_local, np.int64) for n in nb_pad]
    dmats = [aligned_zeros((n, width), dst.dtype)
             for n, width in zip(nb_pad, widths_kept)]
    wmats = [aligned_zeros((n, width), wm_dtype)
             for n, width in zip(nb_pad, widths_kept)]
    n_h = int(deg[heavy].sum())
    heavy_pad = max(int(2 ** np.ceil(np.log2(max(n_h, 1)))), 8)
    heavy_src = aligned_full(heavy_pad, nv_local, src.dtype)
    heavy_dst = aligned_zeros(heavy_pad, dst.dtype)
    heavy_w = aligned_zeros(heavy_pad, w.dtype)
    native.bucket_fill(dst, w, nv_local, base, row_start, deg, cls,
                       widths_kept, nb_pad, verts, dmats, wmats, unit,
                       heavy_pad, heavy_src, heavy_dst, heavy_w)
    return BucketPlan(
        nv_local=nv_local,
        buckets=[Bucket(width=int(width), verts=v, dst=d, w=wm)
                 for width, v, d, wm in zip(widths_kept, verts, dmats,
                                            wmats)],
        heavy_src=heavy_src,
        heavy_dst=heavy_dst,
        heavy_w=heavy_w,
        self_loop=self_loop.astype(w.dtype),
        has_heavy=n_h > 0,
        deg=deg,
    )


def build_class_plans(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                      classes: np.ndarray, n_classes: int,
                      nv_local: int, base: int = 0) -> list:
    """One :class:`BucketPlan` per class, each equal array for array to
    ``BucketPlan.build`` over the slab with every row of another class's
    vertex turned into padding (the reference's per-class build,
    ``cuvite_tpu/louvain/driver.py:1011-1026``).  ``classes`` [nv_local]
    gives each vertex's class in [0, n_classes); ``base`` as in
    ``BucketPlan.build``.

    One stable sort of the rows by their source's class makes each class's
    rows a slice in slab order -- the rows the masked build keeps -- so
    the slab is read once instead of once per class."""
    real = src < nv_local
    key = np.where(real, classes[np.minimum(src, nv_local - 1)], n_classes)
    # The narrowest type: numpy sorts 8- and 16-bit keys by radix, O(E).
    key = key.astype(np.min_scalar_type(n_classes))
    order = np.argsort(key, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(
        np.bincount(key, minlength=n_classes + 1))])
    plans = []
    for c in range(n_classes):
        rows = order[bounds[c]:bounds[c + 1]]
        plans.append(BucketPlan.build(src[rows], dst[rows], w[rows],
                                      nv_local=nv_local, base=base))
    return plans


def fold_plans(plans: list, nv_pad: int) -> BucketPlan:
    """B tenants' host plans (each over ``nv_pad`` vertices) as one plan
    over ``B * nv_pad`` folded vertices, tenant b's vertex v at
    b * nv_pad + v: each width's real rows of every tenant in tenant
    order, the hubs likewise, self-loops and degrees concatenated.  Only
    real rows are kept: ``DevicePlan.upload`` sends no others."""
    nv_total = len(plans) * nv_pad
    buckets = []
    for width in DEFAULT_BUCKETS:
        parts = [(b * nv_pad, bk) for b, p in enumerate(plans)
                 for bk in p.buckets if bk.width == width]
        if not parts:
            continue
        verts, dsts, ws = [], [], []
        for off, bk in parts:
            n = int(np.count_nonzero(bk.verts < nv_pad))
            verts.append(bk.verts[:n] + off)
            dsts.append(bk.dst[:n].astype(np.int64) + off)
            ws.append(bk.w[:n].astype(np.float32))
        buckets.append(Bucket(width=width, verts=np.concatenate(verts),
                              dst=np.concatenate(dsts).astype(np.int32),
                              w=np.concatenate(ws)))
    hs, hd, hw = [], [], []
    for b, p in enumerate(plans):
        real = p.heavy_src < nv_pad
        hs.append(p.heavy_src[real].astype(np.int64) + b * nv_pad)
        hd.append(p.heavy_dst[real].astype(np.int64) + b * nv_pad)
        hw.append(p.heavy_w[real].astype(np.float32))
    heavy_src = np.concatenate(hs + [np.full(8, nv_total)]).astype(np.int32)
    heavy_dst = np.concatenate(hd + [np.zeros(8)]).astype(np.int32)
    heavy_w = np.concatenate(hw + [np.zeros(8, np.float32)])
    return BucketPlan(
        nv_local=nv_total, buckets=buckets, heavy_src=heavy_src,
        heavy_dst=heavy_dst, heavy_w=heavy_w,
        self_loop=np.concatenate([p.self_loop.astype(np.float32)
                                  for p in plans]),
        has_heavy=any(p.has_heavy for p in plans),
        deg=np.concatenate([p.deg for p in plans]))


def build_assemble_perm(verts_list, nv_local: int) -> np.ndarray:
    """Vertex -> position in the concatenated bucket-row space.

    ``verts_list``: the padded per-bucket vertex arrays (padding entries
    hold >= nv_local and are skipped).  Vertices in no bucket (hubs,
    degree 0) map to the trailing default slot.  Bucket membership is
    disjoint, so assembly is a gather, not a scatter."""
    total = sum(len(v) for v in verts_list)
    perm = np.full(nv_local, total, dtype=np.int32)
    off = 0
    for v in verts_list:
        v = np.asarray(v)
        real = np.nonzero(v < nv_local)[0]
        perm[v[real]] = (off + real).astype(np.int32)
        off += len(v)
    return perm


@dataclasses.dataclass
class DevicePlan:
    """A BucketPlan placed on one device, in the kernels' dtypes."""

    # list of (verts [Nb] int32, dst [Nb, D] int32, w [Nb, D] f32,
    # deg [Nb] int32 row degrees or None for full rows)
    buckets: list
    heavy: HeavyLayout | None     # hub layout, None without hubs
    self_loop: torch.Tensor       # [nv_local] f32
    perm: torch.Tensor            # [nv_local] int64 assembly gather
    # Host facts for the kernel-coverage accounting: the width of each
    # bucket and the real edges of its rows, in bucket order, and the
    # hubs' edges.
    widths: list = dataclasses.field(default_factory=list)
    bucket_edges: list = dataclasses.field(default_factory=list)
    hub_edges: int = 0

    def coverage(self) -> list:
        """(width, edges, kernelized) of each class this plan's sweep
        traverses, width 0 the hubs (the reference's per-class coverage,
        ``driver.py:1118-1138``).  The flags follow the route the sweep
        takes: every bucket goes through the row kernel (the one-device
        and mesh steps launch it, or its size form, for each), and the
        hubs through the heavy kernel exactly when the plan carries their
        layout; without it (the sparse exchange) they ride the sorted
        path in plain PyTorch."""
        cov = [(w, e, True) for w, e in zip(self.widths, self.bucket_edges)
               if e]
        if self.hub_edges:
            cov.append((0, self.hub_edges, self.heavy is not None))
        return cov

    @staticmethod
    def upload(plan: BucketPlan, device, base: int = 0,
               nv_total: int | None = None,
               hubs: bool = True) -> "DevicePlan":
        """The real rows of every bucket (padding rows dropped) with their
        degrees, those the plan laid the rows out by.  A shard of a mesh
        under the replicated exchange passes its ``base`` and the mesh's
        ``nv_total``: the kernels then address its rows and hubs by their
        padded-global ids (``perm`` stays local).  ``hubs=False`` leaves
        the hub layout out (the sparse exchange sweeps its hubs on the
        sorted path).  The arrays go through ``utils/upload.to_device``:
        on the card the copies are left in flight on the current stream
        (``finish_uploads`` waits for them), on the CPU the tensors alias
        the plan's arrays, which no sweep writes."""
        def put(a, dtype):
            return to_device(a, dtype, device)

        nv = plan.nv_local
        buckets, real_verts, widths, edges = [], [], [], []
        for b in plan.buckets:
            nb = int(np.count_nonzero(b.verts < nv))
            v = b.verts[:nb]
            real_verts.append(v)
            deg = plan.deg[v]
            widths.append(b.width)
            edges.append(int(deg.sum()))
            buckets.append((put(v + base, torch.int32),
                            put(b.dst[:nb], torch.int32),
                            put(b.w[:nb], torch.float32),
                            put(deg, torch.int32)))
        heavy = None
        if hubs:
            hsrc, n = plan.heavy_src, nv
            if nv_total is not None:   # hubs by padded-global id
                hsrc = np.where(hsrc < nv, hsrc.astype(np.int64) + base,
                                nv_total)
                n = nv_total
            heavy = build_heavy_layout(hsrc, plan.heavy_dst, plan.heavy_w,
                                       nv_local=n)
        return DevicePlan(
            buckets=buckets,
            heavy=None if heavy is None else heavy.to(device),
            self_loop=put(plan.self_loop, torch.float32),
            perm=put(build_assemble_perm(real_verts, nv), torch.int64),
            widths=widths, bucket_edges=edges,
            hub_edges=int(plan.deg.sum()) - sum(edges),
        )


class StepResult(NamedTuple):
    target: torch.Tensor      # [nv] int32 proposed community per vertex
    modularity: torch.Tensor  # [B] f64: each tenant's Q of the INPUT
    n_moved: torch.Tensor     # [B] int64: each tenant's targets changed
    counter0: torch.Tensor    # [nv] f32 weight into the current community


def bucketed_step(plan: DevicePlan, comm: torch.Tensor, vdeg: torch.Tensor,
                  constant, *, nv_total: int,
                  info_comm: torch.Tensor | None = None) -> StepResult:
    """One full Louvain sweep (reference ``bucketed_step``, single device).

    ``comm`` [nv] int32 current assignment; ``vdeg`` [nv] f32 weighted
    degrees; ``constant`` = 1/(2m) (rounded to f32 for the gains, used in
    f64 for Q), or a folded batch's ``TenantConstants``; Q and n_moved
    are [B], one per tenant ([1] for one graph; for a batch the
    reference's ``jax.vmap`` of this step,
    ``cuvite_tpu/louvain/batched.py:133-181``).  Vertices move to
    their best candidate when its gain is positive, except that of two
    singleton communities only the move to the smaller id is kept (the
    singleton guard, reference louvain.cpp:2230-2241).

    ``info_comm``: the frozen assignment of the vertex-ordering schedule
    (louvain.cpp:1535-1562).  Only the community degree and size tables
    come from it; every vertex's and neighbour's community is the current
    ``comm``'s, and the degree table is indexed by it.  Q is then not the
    Q of ``comm``: the schedule takes it from :func:`bucketed_modularity`.
    """
    consts = TenantConstants.of(constant, comm.device)
    info = comm if info_comm is None else info_comm
    comm_deg64 = seg.segment_sum(vdeg.double(), info, nv_total)
    comm_deg = comm_deg64.float()
    # index_add_, not bincount: bincount reads its input's max on the host.
    comm_size = seg.segment_sum(torch.ones_like(info), info, nv_total)
    best_c, best_gain, counter0 = _replicated_moves(
        plan, comm, comm_deg, vdeg, plan.self_loop, consts.c32, 0)
    target, move = _guarded_targets(comm, best_c, best_gain, nv_total,
                                    comm_size=comm_size)
    return StepResult(
        target=target,
        modularity=seg.modularity_terms(counter0, comm_deg64, consts),
        n_moved=move.view(consts.c64.numel(), -1).sum(1), counter0=counter0)


def _replicated_moves(plan: DevicePlan, comm, comm_deg, vdeg, self_loop,
                      constant, base: int) -> tuple:
    """Best move of every vertex of ``plan`` against full tables: the row
    kernel over each bucket, the heavy kernel over the hubs, assembled per
    vertex.  ``comm``/``vdeg``/``self_loop`` cover every vertex the rows
    name and ``comm_deg`` every community (on a mesh under the replicated
    exchange the gathered tables, the plan's rows and hubs by padded-global
    id, its vertex v at ``base + v``).  Returns (best_c, best_gain,
    counter0) of the plan's vertices."""
    # The kernels' per-vertex records, once per sweep (the CPU twins
    # gather the tables themselves).
    vinfo = (vertex_table(comm, comm_deg, vdeg, self_loop)
             if comm.device.type == "cuda" else None)
    parts = [row_argmax(dst, w, verts, comm, comm_deg, vdeg, self_loop,
                        constant, deg, vinfo)
             for verts, dst, w, deg in plan.buckets]
    best_c, best_gain, counter0 = _assemble(
        parts, plan.perm, (SENTINEL, float("-inf"), 0.0))
    if plan.heavy is not None:
        hc, hg, hc0 = heavy_argmax(plan.heavy, comm, comm_deg, vdeg,
                                   self_loop, constant)
        hv = plan.heavy.verts.long() - base
        best_c[hv] = hc
        best_gain[hv] = hg
        counter0[hv] = hc0
    return best_c, best_gain, counter0


def _assemble(parts: list, perm: torch.Tensor, fills: tuple) -> list:
    """Per-vertex results from the buckets' row results by the phase's
    assembly gather; vertices in no bucket (the trailing slot) get
    ``fills``."""
    dev = perm.device
    out = []
    for k, fill in enumerate(fills):
        col = [p[k] for p in parts]
        dt = col[0].dtype if col else (torch.int32 if isinstance(fill, int)
                                       else torch.float32)
        out.append(torch.cat(col + [torch.full((1,), fill, dtype=dt,
                                               device=dev)])[perm])
    return out


def _guarded_targets(comm, best_c, best_gain, nv_total: int, *,
                     comm_size=None, sizes=None) -> tuple:
    """Vertices move to their best candidate when its gain is positive,
    except that of two singleton communities only the move to the smaller
    id is kept (louvain.cpp:2230-2241).  The sizes of the target and the
    current community come from ``comm_size`` (a table over every
    community) or are given per vertex (``sizes``).  Returns (target,
    move)."""
    best_c_safe = best_c.clamp(max=nv_total - 1)
    if sizes is None:
        sizes = (comm_size[best_c_safe.long()], comm_size[comm.long()])
    t_size, c_size = sizes
    move = best_gain > 0.0
    move &= ~((t_size == 1) & (c_size == 1) & (best_c_safe > comm))
    return torch.where(move, best_c_safe, comm), move


def bucketed_modularity(plans, comm: torch.Tensor, vdeg: torch.Tensor,
                        constant, *, nv_total: int) -> torch.Tensor:
    """Q of ``comm`` alone, with no argmax (reference
    ``bucketed_modularity``, single device): the weight of the edges inside
    communities from the rows of ``plans``, whose rows together hold every
    edge once -- one phase's plan, or the class plans of a color schedule.
    Summed in f64 like :func:`ops.segment.modularity_terms`.  ``constant``
    as in :func:`bucketed_step`, for one graph.  Returns a [1] f64
    tensor."""
    dev = comm.device
    le = torch.zeros((), dtype=torch.float64, device=dev)  # graftlint: disable=R003 — Q's e term in f64: the H100 sums in real f64
    for plan in plans:
        le = le + _inside_weight(plan, comm, comm)
    comm_deg64 = seg.segment_sum(vdeg.double(), comm, nv_total)
    return seg.modularity_terms(le.reshape(1), comm_deg64,
                                TenantConstants.of(constant, dev))


def _inside_weight(plan: DevicePlan, comm_v: torch.Tensor,
                   comm_d: torch.Tensor) -> torch.Tensor:
    """The f64 weight of the plan's edges that stay inside a community:
    ``comm_v`` indexed by the rows' and hubs' vertex ids, ``comm_d`` by
    their tails (the same vector on one device and under the replicated
    exchange; the owned slice and the extended-local one under the
    sparse exchange)."""
    le = torch.zeros((), dtype=torch.float64, device=comm_v.device)  # graftlint: disable=R003 — Q's e term in f64: the H100 sums in real f64
    for verts, dst, w, _deg in plan.buckets:
        # Padding slots (the row's own vertex, weight 0) add nothing.
        same = comm_d[dst.long()] == comm_v[verts.long()][:, None]
        le = le + torch.where(same, w, 0.0).sum(dtype=torch.float64)  # graftlint: disable=R003 — Q's e term in f64: the H100 sums in real f64
    lay = plan.heavy
    if lay is not None:
        hub = torch.repeat_interleave(
            lay.verts, lay.offsets[1:] - lay.offsets[:-1],
            output_size=lay.dst.numel())
        same = comm_d[lay.dst.long()] == comm_v[hub.long()]
        le = le + torch.where(same, lay.w, 0.0).sum(dtype=torch.float64)  # graftlint: disable=R003 — Q's e term in f64: the H100 sums in real f64
    return le


# ---------------------------------------------------------------------------
# A vertex mesh.


def build_stacked_plans(dg, exchange_plan=None, shard_ids=None) -> list:
    """One :class:`BucketPlan` per shard of ``dg`` in ``shard_ids`` (all
    shards by default; a rank of a process group builds its own only) --
    the plans of the reference's ``build_stacked_plans``,
    ``bucketed.py:354-528``.  The reference pads them to common shapes and
    stacks them, since one SPMD program sweeps every shard; here each
    shard launches its own plan, so there is nothing to pad and no
    ``StackedPlan``.  With ``exchange_plan`` (``comm/exchange.ExchangePlan``)
    each shard's tails are remapped into its extended-local space and
    self-loops are found at the shard's own window there (base 0; under
    a grouped plan ``(s % ici) * nv_pad``, reference
    ``bucketed.py:404-420``); without, tails stay padded-global (base
    s * nv_pad)."""
    plans = []
    for s in (range(dg.nshards) if shard_ids is None else shard_ids):
        src, dst, w = _shard_rows(dg, s, exchange_plan)
        plans.append(BucketPlan.build(
            src, dst, w, nv_local=dg.nv_pad,
            base=_plan_base(dg, s, exchange_plan)))
    return plans


def _plan_base(dg, s: int, exchange_plan) -> int:
    """Where shard s's own vertices start in the id space of its plan's
    tails: s * nv_pad padded-global, 0 extended-local, and its offset in
    its group's window under a grouped (two-level) plan."""
    if exchange_plan is None:
        return s * dg.nv_pad
    return (s % exchange_plan.ici) * dg.nv_pad


def _shard_rows(dg, s: int, exchange_plan) -> tuple:
    """Shard s's real (local src, tail, w) rows, tails extended-local
    under ``exchange_plan`` and padded-global without."""
    sh = dg.shards[s]
    real = sh.src < dg.nv_pad
    dst = sh.dst
    if exchange_plan is not None:
        dst = exchange_plan.remap_dst(s, sh.src, sh.dst).astype(sh.dst.dtype)
    return sh.src[real], dst[real], sh.w[real]


def build_mesh_class_plans(dg, class_of: np.ndarray, n_classes: int,
                           exchange_plan=None, shard_ids=None) -> list:
    """The color classes' plans on a mesh (the reference's
    ``build_stacked_plans(class_of=, class_id=)`` for every class): a list
    over the classes of the shards' plans, each keeping only its class's
    vertices' rows, as :func:`build_stacked_plans` lays them out.
    ``class_of`` [total padded vertices] gives each vertex's class; the
    routing does not depend on it.  One pass over each shard's slab
    (:func:`build_class_plans`)."""
    nvl = dg.nv_pad
    by_shard = []
    for s in (range(dg.nshards) if shard_ids is None else shard_ids):
        src, dst, w = _shard_rows(dg, s, exchange_plan)
        by_shard.append(build_class_plans(
            src, dst, w, np.asarray(class_of)[s * nvl:(s + 1) * nvl],
            n_classes, nv_local=nvl,
            base=_plan_base(dg, s, exchange_plan)))
    return [list(c) for c in zip(*by_shard)] if by_shard else \
        [[] for _ in range(n_classes)]


def merge_coverage(entries) -> list:
    """(width, edges, kernelized) entries summed by width and flag: the
    buckets in ``DEFAULT_BUCKETS`` order, the hubs (width 0) last."""
    tot: dict = {}
    for w, e, k in entries:
        tot[(w, bool(k))] = tot.get((w, bool(k)), 0) + e
    return [(w, e, k) for (w, k), e in sorted(
        tot.items(), key=lambda it: (it[0][0] == 0, it[0][0], it[0][1]))]


def plans_coverage(plans: list) -> list:
    """:meth:`DevicePlan.coverage` of plans swept together: a color
    schedule's class plans, a mesh's local shards."""
    return merge_coverage(e for p in plans for e in p.coverage())


@dataclasses.dataclass
class MeshPlan:
    """A phase's plans on the shards of a mesh, in the kernels' dtypes.

    Lists run over the mesh's local shards.  ``exchange`` 'replicated':
    shard s's :class:`DevicePlan` addresses its rows and hubs by
    padded-global id, and ``vdeg_full``/``sl_full`` hold the whole mesh's
    degrees and self-loops on every shard (gathered once a phase).
    'sparse': rows by local id, tails extended-local, hubs as raw edges
    (``heavy_edges``: local src, extended-local dst, w) and the routing
    (``send_idx``, ``ghost_sel``, ``budget``).  'twolevel': as 'sparse'
    over a grouped plan, tails group-extended, ``n_dcn`` its groups."""

    mesh: object
    nv_pad: int
    exchange: str
    plans: list                       # per shard DevicePlan
    self_loops: list                  # per shard [nv_pad] f32
    vdeg_full: list | None = None
    sl_full: list | None = None
    heavy_edges: list | None = None
    send_idx: list | None = None
    ghost_sel: list | None = None
    budget: int = 0
    n_dcn: int = 1

    @property
    def nv_total(self) -> int:
        return self.mesh.size * self.nv_pad

    @property
    def sparse(self) -> bool:
        """Whether the sweeps ride a ghost routing (sparse or two-level)."""
        return self.exchange in ("sparse", "twolevel")

    def env(self, comms: list, vdegs: list, info: list | None = None
            ) -> list:
        """The local shards' exchange environment of a sweep."""
        if self.exchange == "twolevel":
            return twolevel_env(comms, vdegs, self.send_idx, self.ghost_sel,
                                self.mesh, n_dcn=self.n_dcn,
                                budget=self.budget, info=info)
        return sparse_env(comms, vdegs, self.send_idx, self.ghost_sel,
                          self.mesh, budget=self.budget, info=info)

    def own(self, s: int) -> int:
        """Where shard s's own vertices start in its extended tables."""
        if self.exchange != "twolevel":
            return 0
        return (s % (self.mesh.size // self.n_dcn)) * self.nv_pad

    @staticmethod
    def upload(host_plans: list, mesh, nv_pad: int, vdegs: list, *,
               exchange: str = "replicated", xplan=None,
               budget: int = 0, shared: "MeshPlan | None" = None
               ) -> "MeshPlan":
        """Place the local shards' ``host_plans``
        (:func:`build_stacked_plans`) on ``mesh``; ``vdegs`` are their
        [nv_pad] f32 degrees on their devices; ``xplan`` and ``budget``
        for the sparse and two-level exchanges.  ``shared``: a plan of the
        same phase (another color class) whose routing or gathered degrees
        this one reuses instead of placing its own."""
        S = mesh.size
        nv_total = S * nv_pad
        sparse = exchange in ("sparse", "twolevel")
        plans, sls, heavy = [], [], []
        for s, p, dev in zip(mesh.shard_ids, host_plans, mesh.devices):
            if sparse:
                plans.append(DevicePlan.upload(p, dev, hubs=False))
                real = p.heavy_src < nv_pad
                heavy.append(tuple(
                    to_device(a[real], dt, dev)
                    for a, dt in ((p.heavy_src, torch.int32),
                                  (p.heavy_dst, torch.int32),
                                  (p.heavy_w, torch.float32))))
            else:
                plans.append(DevicePlan.upload(p, dev, base=s * nv_pad,
                                               nv_total=nv_total))
            sls.append(plans[-1].self_loop)
        mp = MeshPlan(mesh=mesh, nv_pad=nv_pad, exchange=exchange,
                      plans=plans, self_loops=sls)
        if sparse:
            mp.heavy_edges = heavy
            mp.send_idx, mp.ghost_sel = (
                xplan.to_mesh(mesh) if shared is None
                else (shared.send_idx, shared.ghost_sel))
            mp.budget = int(budget)
            mp.n_dcn = S // xplan.ici
        else:
            mp.vdeg_full = (all_gather(vdegs, mesh) if shared is None
                            else shared.vdeg_full)
            mp.sl_full = all_gather(sls, mesh)
        return mp


class ShardedResult(NamedTuple):
    targets: list             # per local shard [nv_pad] int32 community
    modularity: torch.Tensor  # 0-dim f64 Q of the INPUT, first local device
    n_moved: torch.Tensor     # 0-dim int64, the same device
    overflow: torch.Tensor    # 0-dim bool: a shard's budget overflowed
    counter0: list            # per local shard [nv_pad] f32


def sharded_bucketed_step(mp: MeshPlan, comms: list, vdegs: list,
                          constant: float,
                          info_comms: list | None = None) -> ShardedResult:
    """One sweep over the local shards of the mesh (reference
    ``bucketed_step`` under ``make_sharded_bucketed_step``,
    ``bucketed.py:842-1150,1251``).  ``comms``/``vdegs``: the local shards'
    [nv_pad] owned slices; ``constant`` = 1/(2m), rounded to f32 for the
    gains.  ``info_comms``: vertex ordering's frozen assignment, per local
    shard, from which the community degree and size tables come (the
    class step of ``make_sharded_class_step``; Q is then not the Q of
    ``comms``)."""
    mesh, nv = mp.mesh, mp.nv_pad
    nv_total = mp.nv_total
    c32 = float(torch.tensor(constant, dtype=torch.float32))
    sparse = mp.sparse
    if sparse:
        envs = mp.env(comms, vdegs, info_comms)
    else:
        comm_full = all_gather(comms, mesh)  # graftlint: replicated-ok=scope=ici; the replicated exchange's community vector — flat-mesh-only (a hybrid mesh runs the two-level exchange), so the gather never spans more than one ICI group; the sparse/two-level exchanges are the fix past the cutover
        deg_parts, size_parts = [], []
        for info, vdeg in zip(comms if info_comms is None else info_comms,
                              vdegs):
            deg_parts.append(seg.segment_sum(vdeg.double(), info, nv_total))  # graftlint: replicated-ok=scope=ici; replicated-exchange community degree table, flat-mesh-only (one ICI group); sparse/two-level modes ride the ghost plan instead
            size_parts.append(seg.segment_sum(torch.ones_like(info), info,  # graftlint: replicated-ok=scope=ici; replicated-exchange community size table, flat-mesh-only (one ICI group); sparse/two-level modes attach sizes to ghosts instead
                                              nv_total))
        comm_deg64 = psum(deg_parts, mesh)
        comm_size = psum(size_parts, mesh)
    targets, counter0s, moved = [], [], []
    for i, s in enumerate(mesh.shard_ids):
        plan, comm, vdeg = mp.plans[i], comms[i], vdegs[i]
        sl = mp.self_loops[i]
        if sparse:
            env = envs[i]
            cuda = comm.device.type == "cuda"
            vinfo = (attached_vertex_table(comm, env.cdeg_v, vdeg, sl)
                     if cuda else None)
            sinfo = (slot_table(env.comm_ext, env.cdeg_ext, env.csize_ext)
                     if cuda else None)
            parts = [row_argmax_sized(dst, w, verts, env.comm_ext,
                                      env.cdeg_ext, env.csize_ext,
                                      env.cdeg_v, vdeg, sl, c32, deg, vinfo,
                                      sinfo, own=mp.own(s))
                     for verts, dst, w, deg in plan.buckets]
            best_c, best_gain, counter0, best_size = _assemble(
                parts, plan.perm, (SENTINEL, float("-inf"), 0.0, 0))
            best_c, best_gain, counter0, best_size = _sparse_hubs(
                mp.heavy_edges[i], env, comm, vdeg, sl, c32, best_c,
                best_gain, counter0, best_size)
            target, move = _guarded_targets(
                comm, best_c, best_gain, nv_total,
                sizes=(best_size, env.csize_v))
        else:
            best_c, best_gain, counter0 = _replicated_moves(
                plan, comm_full[i], comm_deg64[i].float(), mp.vdeg_full[i],
                mp.sl_full[i], c32, s * nv)
            target, move = _guarded_targets(comm, best_c, best_gain,
                                            nv_total, comm_size=comm_size[i])
        targets.append(target)
        counter0s.append(counter0)
        moved.append(move.sum())
    if sparse:
        q = sparse_modularity(counter0s, [e.deg_local for e in envs],
                              constant, mesh,
                              twolevel=mp.exchange == "twolevel")
        overflow = psum([e.overflow.long() for e in envs], mesh)[0] > 0
    else:
        le = psum([c.double().sum() for c in counter0s], mesh)[0]
        la2 = comm_deg64[0].square().sum()
        q = le * constant - la2 * constant * constant
        overflow = torch.zeros((), dtype=torch.bool, device=mesh.devices[0])
    return ShardedResult(targets=targets, modularity=q,
                         n_moved=psum(moved, mesh)[0], overflow=overflow,
                         counter0=counter0s)


def sharded_bucketed_modularity(mps: list, comms: list, vdegs: list,
                                constant: float) -> tuple:
    """Q of ``comms`` alone, with no argmax, over the mesh plans ``mps``
    whose rows together hold every edge once (a phase's color-class plans;
    reference ``bucketed_modularity`` under ``make_sharded_bucketed_mod``,
    the Q of a class-scheduled iteration at its start).  Replicated: each
    shard's in-community weight against the all-gathered communities and
    the psum'd f64 degree table.  Sparse and two-level: against the
    exchange environment's extended-local communities, the a^2 term by
    owner (:func:`comm.exchange.sparse_modularity`), and the env's budget
    overflow.  Returns (0-dim f64 Q, 0-dim bool overflow) on the first
    local shard's device."""
    mp0 = mps[0]
    mesh, nv_total = mp0.mesh, mp0.nv_total
    if mp0.sparse:
        envs = mp0.env(comms, vdegs)
        les = []
        for i, (comm, env) in enumerate(zip(comms, envs)):
            le = torch.zeros((), dtype=torch.float64, device=comm.device)  # graftlint: disable=R003 — Q's e term in f64: the H100 sums in real f64
            for mp in mps:
                le = le + _inside_weight(mp.plans[i], comm, env.comm_ext)
                hs, hd, hw = mp.heavy_edges[i]
                same = env.comm_ext[hd.long()] == comm[hs.long()]
                le = le + torch.where(same, hw, 0.0).sum(
                    dtype=torch.float64)  # graftlint: disable=R003 — Q's e term in f64: the H100 sums in real f64
            les.append(le)
        q = sparse_modularity(les, [e.deg_local for e in envs], constant,
                              mesh, twolevel=mp0.exchange == "twolevel")
        return q, psum([e.overflow.long() for e in envs], mesh)[0] > 0
    comm_full = all_gather(comms, mesh)  # graftlint: replicated-ok=scope=ici; replicated-exchange mod pass, flat-mesh-only (hybrid meshes take the sparse/two-level branch above)
    les = []
    for i, comm in enumerate(comms):
        le = torch.zeros((), dtype=torch.float64, device=comm.device)  # graftlint: disable=R003 — Q's e term in f64: the H100 sums in real f64
        for mp in mps:
            le = le + _inside_weight(mp.plans[i], comm_full[i], comm_full[i])
        les.append(le)
    comm_deg64 = psum([seg.segment_sum(v.double(), c, nv_total)  # graftlint: replicated-ok=scope=ici; replicated-exchange mod pass, flat-mesh-only (hybrid meshes take the sparse/two-level branch above)
                       for c, v in zip(comms, vdegs)], mesh)[0]
    le = psum(les, mesh)[0]
    q = le * constant - comm_deg64.square().sum() * constant * constant
    return q, torch.zeros((), dtype=torch.bool, device=mesh.devices[0])


def _sparse_hubs(edges, env, comm, vdeg, sl, c32, best_c, best_gain,
                 counter0, best_size) -> tuple:
    """The hubs of one shard under the sparse exchange: the reference's
    sorted path with sizes (``bucketed.py:1063-1121``) over the shard's
    raw hub edges, merged into the row results."""
    hs, hd, hw = edges
    if hs.numel() == 0:
        return best_c, best_gain, counter0, best_size
    nv = comm.shape[0]
    hd_l = hd.long()
    ckey = env.comm_ext[hd_l]
    csrc = comm[hs.long()]
    counter0 = counter0 + seg.segment_sum(
        torch.where(ckey == csrc, hw, 0.0).double(), hs, nv).float()
    eix = counter0 - sl
    # One stable sort by (hub, community): ids are below 2^31.
    k_s, order = torch.sort((hs.long() << 31) | ckey.long(), stable=True)  # graftlint: width-ok=int64 key of two int32 ids below 2^31: 62 bits
    src_s = (k_s >> 31).long()
    ckey_s = (k_s & SENTINEL).to(torch.int32)
    w_s = hw[order]
    ay_s = env.cdeg_ext[hd_l][order]
    ts_s = env.csize_ext[hd_l][order]
    starts = seg.run_starts(src_s, ckey_s)
    eiy, _ = seg.run_totals(w_s, starts)
    comm_i = comm[src_s]
    valid = starts & (ckey_s != comm_i)
    k_i = vdeg[src_s]
    a_x = env.cdeg_v[src_s] - k_i
    gain = 2.0 * (eiy - eix[src_s]) - 2.0 * k_i * (ay_s - a_x) * c32
    gain = torch.where(valid, gain, float("-inf"))
    hg = seg.segment_max(gain, src_s, nv)
    at_best = valid & (gain == hg[src_s])
    hc = seg.segment_min(torch.where(at_best, ckey_s, SENTINEL), src_s, nv)
    chosen = at_best & (ckey_s == hc[src_s])
    h_tsize = seg.segment_min(torch.where(chosen, ts_s, SENTINEL), src_s, nv)
    better = hg > best_gain
    return (torch.where(better, hc, best_c),
            torch.where(better, hg, best_gain), counter0,
            torch.where(better, h_tsize, best_size))
