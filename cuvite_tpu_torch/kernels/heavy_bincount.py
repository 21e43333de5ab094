"""Heavy-class argmax for the hubs (degree > the widest bucket, 8192): the
CSR hub layout, the CUDA kernel wrapper and its plain PyTorch twin.

Replaces ``heavy_argmax_pallas`` (``cuvite_tpu/kernels/heavy_bincount.py:200``)
and its ``[D, H]`` layout (``build_heavy_layout`` there).  It computes the
row kernel's function for each hub: counter0, the gain of every neighbour
community other than the current one, and the best move with ties to the
smaller id.  A community reached only by zero-weight edges is still a
candidate.

The TPU kernel's community-range one-hot bincount is not ported.  Each hub
is its CSR range of the heavy edge arrays, and the kernel
(``csrc/heavy_bincount.cu``) aggregates it in a per-hub hash table in
global scratch that the wrapper allocates: next_pow2(2 * degree) slots per
hub, O(heavy edges) bytes, with no element budget and no fallback.  On CUDA
the kernel is always on; ``heavy_argmax`` runs the twin only for CPU
tensors.  The twin is the reference's sorted heavy path
(``cuvite_tpu/louvain/bucketed.py:1093-1121``): one stable sort by
(hub, community), run sums, a segment max and the smallest id among the
maxima.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from cuvite_tpu_torch.kernels import _build
from cuvite_tpu_torch.kernels.row_argmax import SENTINEL
from cuvite_tpu_torch.ops import segment as seg

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = {
    "cv_heavy_argmax": ([_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                         _I, _F, _I, _P, _P, _P, _P], _I),
}


@dataclasses.dataclass
class HeavyLayout:
    """Phase-static hub layout: hub h owns edges [offsets[h], offsets[h+1])
    of ``dst``/``w`` and table slots [table_offsets[h], table_offsets[h+1])
    of the kernel's scratch."""

    verts: torch.Tensor          # [H] int32 hub vertex ids, ascending
    offsets: torch.Tensor        # [H+1] int64 edge offsets
    dst: torch.Tensor            # [E] int32 neighbour vertex ids
    w: torch.Tensor              # [E] f32 weights
    table_offsets: torch.Tensor  # [H+1] int64 scratch offsets
    table_size: int              # total scratch slots

    @property
    def num_hubs(self) -> int:
        return int(self.verts.numel())

    def to(self, device) -> "HeavyLayout":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("verts", "offsets", "dst", "w",
                               "table_offsets")})


def build_heavy_layout(heavy_src, heavy_dst, heavy_w, *,
                       nv_local: int) -> HeavyLayout | None:
    """Hub layout from a BucketPlan's padded heavy triples (pad src ==
    ``nv_local``), as CPU tensors; None when there are no heavy edges.
    Within-hub edge order is kept."""
    hs = np.asarray(heavy_src)
    real = hs < nv_local
    s = hs[real].astype(np.int64)
    if len(s) == 0:
        return None
    d = np.asarray(heavy_dst)[real]
    w = np.asarray(heavy_w)[real]
    if len(s) > 1 and np.any(s[:-1] > s[1:]):
        order = np.argsort(s, kind="stable")
        s, d, w = s[order], d[order], w[order]
    verts, counts = np.unique(s, return_counts=True)
    offsets = np.zeros(len(verts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    slots = np.left_shift(1, np.ceil(np.log2(2 * counts)).astype(np.int64))
    table_offsets = np.zeros(len(verts) + 1, dtype=np.int64)
    np.cumsum(slots, out=table_offsets[1:])
    return HeavyLayout(
        verts=torch.from_numpy(verts.astype(np.int32)),
        offsets=torch.from_numpy(offsets),
        dst=torch.from_numpy(d.astype(np.int32)),
        w=torch.from_numpy(w.astype(np.float32)),
        table_offsets=torch.from_numpy(table_offsets),
        table_size=int(table_offsets[-1]),
    )


def _validate(lay, comm, comm_deg, vdeg, self_loop):
    dev = lay.dst.device
    for name, t, dt in (("verts", lay.verts, torch.int32),
                        ("offsets", lay.offsets, torch.int64),
                        ("dst", lay.dst, torch.int32),
                        ("w", lay.w, torch.float32),
                        ("table_offsets", lay.table_offsets, torch.int64),
                        ("comm", comm, torch.int32),
                        ("comm_deg", comm_deg, torch.float32),
                        ("vdeg", vdeg, torch.float32),
                        ("self_loop", self_loop, torch.float32)):
        if t.device != dev:
            raise ValueError(f"heavy_argmax: {name} is on {t.device}, dst "
                             f"on {dev}")
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"heavy_argmax: {name} must be a contiguous "
                             f"1-d {dt} tensor")
    h = lay.verts.numel()
    if (lay.offsets.numel() != h + 1 or lay.table_offsets.numel() != h + 1
            or lay.w.numel() != lay.dst.numel()):
        raise ValueError("heavy_argmax: inconsistent hub layout")
    if not (comm.numel() == vdeg.numel() == self_loop.numel() >= 1):
        raise ValueError("heavy_argmax: comm, vdeg and self_loop must be "
                         "non-empty per-vertex tables of one length")


def heavy_argmax(lay: HeavyLayout, comm, comm_deg, vdeg, self_loop,
                 constant):
    """Best move of every hub of ``lay`` (tables as in
    ``row_argmax.row_argmax``).  Returns (best_c [H] int32,
    best_gain [H] f32, counter0 [H] f32)."""
    _validate(lay, comm, comm_deg, vdeg, self_loop)
    dev = lay.dst.device
    if dev.type == "cpu":
        return heavy_argmax_plain(lay, comm, comm_deg, vdeg, self_loop,
                                  constant)
    if dev.type != "cuda":
        raise ValueError(f"heavy_argmax: no kernel for device {dev}")
    h = lay.num_hubs
    best_c = torch.empty(h, dtype=torch.int32, device=dev)
    best_gain = torch.empty(h, dtype=torch.float32, device=dev)
    counter0 = torch.empty(h, dtype=torch.float32, device=dev)
    keys = torch.empty(lay.table_size, dtype=torch.int32, device=dev)
    vals = torch.empty(lay.table_size, dtype=torch.float32, device=dev)
    lib = _build.library("heavy_bincount", _SIGNATURE)
    err = lib.cv_heavy_argmax(
        lay.verts.data_ptr(), lay.offsets.data_ptr(), lay.dst.data_ptr(),
        lay.w.data_ptr(), h, lay.table_offsets.data_ptr(), keys.data_ptr(),
        vals.data_ptr(), comm.data_ptr(), comm_deg.data_ptr(),
        vdeg.data_ptr(), self_loop.data_ptr(), comm.numel(), float(constant),
        SENTINEL, best_c.data_ptr(), best_gain.data_ptr(),
        counter0.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "heavy_argmax")
    heavy_argmax.launches += 1
    return best_c, best_gain, counter0


heavy_argmax.launches = 0


def heavy_argmax_plain(lay: HeavyLayout, comm, comm_deg, vdeg, self_loop,
                       constant):
    """Plain PyTorch twin of :func:`heavy_argmax` (same signature and
    results)."""
    dev = lay.dst.device
    h = lay.num_hubs
    cst = torch.tensor(float(constant), dtype=torch.float32, device=dev)
    v = lay.verts.clamp(max=comm.numel() - 1).long()
    curr = comm[v]
    vd = vdeg[v]
    ax = comm_deg[curr.long()] - vd
    hub = torch.repeat_interleave(
        torch.arange(h, device=dev), lay.offsets[1:] - lay.offsets[:-1])
    c = comm[lay.dst.long()].long()
    counter0 = seg.segment_sum(torch.where(c == curr[hub], lay.w, 0.0), hub,
                               h)
    eix = counter0 - self_loop[v]
    key_s, order = torch.sort(hub * (comm.numel() + 1) + c, stable=True)
    hub_s, c_s, w_s = hub[order], c[order], lay.w[order]
    leader = torch.ones_like(key_s, dtype=torch.bool)
    leader[1:] = key_s[1:] != key_s[:-1]
    run = leader.long().cumsum(0) - 1
    n_runs = int(run[-1]) + 1 if run.numel() else 0
    wagg = seg.segment_sum(w_s, run, n_runs)[run]
    valid = leader & (c_s != curr[hub_s])
    gain = 2.0 * (wagg - eix[hub_s]) \
        - 2.0 * vd[hub_s] * (comm_deg[c_s] - ax[hub_s]) * cst
    gain = torch.where(valid, gain, float("-inf"))
    best_gain = seg.segment_max(gain, hub_s, h)
    at_best = valid & (gain == best_gain[hub_s])
    best_c = seg.segment_min(torch.where(at_best, c_s, SENTINEL), hub_s, h)
    return best_c.to(torch.int32), best_gain, counter0
