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

What the port does not do yet: no multi-GPU (no sharded plans, no sparse
or two-level exchange, so no ``szT`` size channel), no early termination
(ET), no coloring or vertex-ordering schedules, and no device re-binning of
coarse phases: every phase builds its plan on the host, which is the
reference's bit-parity oracle for its device re-binning.

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

from cuvite_tpu_torch.kernels.heavy_bincount import (
    HeavyLayout,
    build_heavy_layout,
    heavy_argmax,
)
from cuvite_tpu_torch.kernels.row_argmax import (
    SENTINEL,
    row_argmax,
    vertex_table,
)
from cuvite_tpu_torch.ops import segment as seg

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
              nv_local: int) -> "BucketPlan":
        """``src`` holds vertex ids (pad = nv_local), ``dst`` tail ids; the
        single shard starts at vertex 0.  The reference's numpy path with
        its default widths, array for array."""
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
        is_self = d == s
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
            verts = np.full(nb_pad, nv_local, dtype=np.int64)
            verts[:nb] = sel
            dmat = np.zeros((nb_pad, width), dtype=dst.dtype)
            cols = np.arange(width)
            idx = row_start[sel][:, None] + cols[None, :]
            has = cols[None, :] < deg[sel][:, None]
            idx = np.minimum(idx, max(len(d) - 1, 0))
            dmat[:nb] = np.where(has, d[idx], sel[:, None])
            if unit:
                wmat = np.zeros((nb_pad, width), dtype=np.uint8)
                wmat[:nb] = has
            else:
                wmat = np.zeros((nb_pad, width), dtype=w.dtype)
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
            heavy_src = np.full(npad, nv_local, dtype=src.dtype)
            heavy_dst = np.zeros(npad, dtype=dst.dtype)
            heavy_w = np.zeros(npad, dtype=w.dtype)
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

    @staticmethod
    def upload(plan: BucketPlan, device) -> "DevicePlan":
        """The real rows of every bucket (padding rows dropped) with their
        degrees, those the plan laid the rows out by."""
        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device).to(dtype)

        buckets, real_verts = [], []
        for b in plan.buckets:
            nb = int(np.count_nonzero(b.verts < plan.nv_local))
            v = b.verts[:nb]
            real_verts.append(v)
            buckets.append((put(v, torch.int32), put(b.dst[:nb], torch.int32),
                            put(b.w[:nb], torch.float32),
                            put(plan.deg[v], torch.int32)))
        heavy = build_heavy_layout(plan.heavy_src, plan.heavy_dst,
                                   plan.heavy_w, nv_local=plan.nv_local)
        return DevicePlan(
            buckets=buckets,
            heavy=None if heavy is None else heavy.to(device),
            self_loop=put(plan.self_loop, torch.float32),
            perm=put(build_assemble_perm(real_verts, plan.nv_local),
                     torch.int64),
        )


class StepResult(NamedTuple):
    target: torch.Tensor      # [nv] int32 proposed community per vertex
    modularity: torch.Tensor  # 0-dim f64: Q of the INPUT assignment
    n_moved: torch.Tensor     # 0-dim int64: vertices whose target differs
    counter0: torch.Tensor    # [nv] f32 weight into the current community


def bucketed_step(plan: DevicePlan, comm: torch.Tensor, vdeg: torch.Tensor,
                  constant: float, *, nv_total: int) -> StepResult:
    """One full Louvain sweep (reference ``bucketed_step``, single device).

    ``comm`` [nv] int32 current assignment; ``vdeg`` [nv] f32 weighted
    degrees; ``constant`` = 1/(2m) (rounded to f32 for the gains, used in
    f64 for Q).  Vertices move to their best candidate when its gain is
    positive, except that of two singleton communities only the move to the
    smaller id is kept (the singleton guard, reference louvain.cpp:2230-2241).
    """
    const32 = float(np.float32(constant))
    comm_deg64 = seg.segment_sum(vdeg.double(), comm, nv_total)
    comm_deg = comm_deg64.float()
    # index_add_, not bincount: bincount reads its input's max on the host.
    comm_size = seg.segment_sum(torch.ones_like(comm), comm, nv_total)
    dev = comm.device
    # The kernels' per-vertex records, once per sweep (the CPU twins
    # gather the tables themselves).
    vinfo = (vertex_table(comm, comm_deg, vdeg, plan.self_loop)
             if dev.type == "cuda" else None)
    bcs, bgs, c0s = [], [], []
    for verts, dst, w, deg in plan.buckets:
        bc, bg, c0 = row_argmax(dst, w, verts, comm, comm_deg, vdeg,
                                plan.self_loop, const32, deg, vinfo)
        bcs.append(bc)
        bgs.append(bg)
        c0s.append(c0)
    # Trailing default slot for vertices in no bucket.
    best_c = torch.cat(bcs + [torch.full((1,), SENTINEL, dtype=torch.int32,
                                         device=dev)])[plan.perm]
    best_gain = torch.cat(bgs + [torch.full((1,), float("-inf"),
                                            device=dev)])[plan.perm]
    counter0 = torch.cat(c0s + [torch.zeros(1, device=dev)])[plan.perm]
    if plan.heavy is not None:
        hc, hg, hc0 = heavy_argmax(plan.heavy, comm, comm_deg, vdeg,
                                   plan.self_loop, const32)
        hv = plan.heavy.verts.long()
        best_c[hv] = hc
        best_gain[hv] = hg
        counter0[hv] = hc0

    move = best_gain > 0.0
    best_c_safe = best_c.clamp(max=nv_total - 1)
    guard = ((comm_size[best_c_safe.long()] == 1)
             & (comm_size[comm.long()] == 1) & (best_c_safe > comm))
    move &= ~guard
    target = torch.where(move, best_c_safe, comm)
    modularity = seg.modularity_terms(counter0, comm_deg64, float(constant))
    return StepResult(target=target, modularity=modularity,
                      n_moved=move.sum(), counter0=counter0)
