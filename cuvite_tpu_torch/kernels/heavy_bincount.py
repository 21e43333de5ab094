"""Heavy-class argmax for the hubs (degree > the widest bucket, 8192): the
CSR hub layout, the CUDA kernel wrapper and its plain PyTorch twin.

Replaces ``heavy_argmax_pallas`` (``cuvite_tpu/kernels/heavy_bincount.py:200``)
and its ``[D, H]`` layout (``build_heavy_layout`` there).  It computes the
row kernel's function for each hub: counter0, the gain of every neighbour
community other than the current one, and the best move with ties to the
smaller id.  A community reached only by zero-weight edges is still a
candidate.

The TPU kernel's community-range one-hot bincount is not ported.  Each hub
is its CSR range of the heavy edge arrays, cut into chunks of at most
``HEAVY_CHUNK`` edges that never straddle two hubs (the phase-static chunk
table), so the kernel (``csrc/heavy_bincount.cu``) spreads every hub over
the card, one block per chunk, and merges the chunks in a per-hub hash
table: next_pow2(2 * degree) slots per hub, O(heavy edges) bytes, with no
element budget and no fallback.  That table and the rest of the kernel's
scratch belong to the layout: allocated and cleared once when the layout
goes to a CUDA device (:meth:`HeavyLayout.to`), and left clean by every
launch, so a launch touches only the slots it uses.  On CUDA the kernel
is always on; ``heavy_argmax`` runs the twin only for CPU tensors.  The
twin is the reference's sorted heavy path
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

# Most edges of one chunk: one block of the kernel aggregates a chunk in a
# shared table of next_pow2(2 * HEAVY_CHUNK) slots (csrc: kChunk).
HEAVY_CHUNK = 4096

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = {
    "cv_heavy_argmax": ([_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _I, _F, _I, _P, _P,
                         _P, _P], _I),
}
_TENSORS = ("verts", "offsets", "dst", "w", "table_offsets",
            "chunk_offsets", "chunk_hub", "hub_chunks")


# An empty hub-table entry: key -1 in the low word, weight sum +0.0 in the
# high word.
EMPTY_ENTRY = 0xFFFFFFFF


@dataclasses.dataclass
class HeavyScratch:
    """The kernel's working memory for one layout.  ``table`` and ``best``
    are cleared once at allocation and every launch leaves them so again;
    the rest is written before it is read."""

    table: torch.Tensor     # [table_size] int64 hub-table (key, sum) entries
    slots: torch.Tensor     # [E] int32 claimed slots, chunk k's at its edges
    claims: torch.Tensor    # [C] int32 claimed slots per chunk
    partial: torch.Tensor   # [C] f32 counter0 of each chunk
    best: torch.Tensor      # [H] int64 packed (gain, ~id), 0 = none

    @staticmethod
    def allocate(lay: "HeavyLayout", device) -> "HeavyScratch":
        def empty(n, dtype):
            return torch.empty(n, dtype=dtype, device=device)

        return HeavyScratch(
            table=torch.full((lay.table_size,), EMPTY_ENTRY,
                             dtype=torch.int64, device=device),
            slots=empty(lay.dst.numel(), torch.int32),
            claims=empty(lay.num_chunks, torch.int32),
            partial=empty(lay.num_chunks, torch.float32),
            best=torch.zeros(lay.num_hubs, dtype=torch.int64,
                             device=device))

    def is_clean(self) -> bool:
        """Whether the table and best keys are as a launch must find them."""
        return bool((self.table == EMPTY_ENTRY).all()
                    and (self.best == 0).all())


@dataclasses.dataclass
class HeavyLayout:
    """Phase-static hub layout: hub h owns edges [offsets[h], offsets[h+1])
    of ``dst``/``w``, chunks [hub_chunks[h], hub_chunks[h+1]) and table
    slots [table_offsets[h], table_offsets[h+1]) of the kernel's scratch;
    chunk k is edges [chunk_offsets[k], chunk_offsets[k+1]) of hub
    chunk_hub[k]."""

    verts: torch.Tensor          # [H] int32 hub vertex ids, ascending
    offsets: torch.Tensor        # [H+1] int64 edge offsets
    dst: torch.Tensor            # [E] int32 neighbour vertex ids
    w: torch.Tensor              # [E] f32 weights
    table_offsets: torch.Tensor  # [H+1] int64 scratch offsets
    table_size: int              # total scratch slots
    chunk_offsets: torch.Tensor  # [C+1] int64 chunk edge offsets
    chunk_hub: torch.Tensor      # [C] int32 hub of each chunk
    hub_chunks: torch.Tensor     # [H+1] int32 first chunk of each hub
    max_chunk: int               # edges of the longest chunk
    scratch: HeavyScratch | None = None   # on a CUDA device only

    @property
    def num_hubs(self) -> int:
        return int(self.verts.numel())

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_hub.numel())

    def to(self, device) -> "HeavyLayout":
        """The layout on ``device``; on a CUDA device with the kernel's
        scratch allocated and cleared."""
        lay = dataclasses.replace(
            self, scratch=None,
            **{f: getattr(self, f).to(device) for f in _TENSORS})
        if lay.dst.device.type == "cuda":
            lay.scratch = HeavyScratch.allocate(lay, lay.dst.device)
        return lay


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
    # Chunks of HEAVY_CHUNK edges from each hub's first edge, the last one
    # of a hub shorter: no chunk straddles two hubs.
    n_chunks = (counts + HEAVY_CHUNK - 1) // HEAVY_CHUNK
    hub_chunks = np.zeros(len(verts) + 1, dtype=np.int64)
    np.cumsum(n_chunks, out=hub_chunks[1:])
    chunk_hub = np.repeat(np.arange(len(verts)), n_chunks)
    rank = np.arange(len(chunk_hub)) - hub_chunks[chunk_hub]
    chunk_offsets = np.append(offsets[chunk_hub] + rank * HEAVY_CHUNK,
                              offsets[-1])
    return HeavyLayout(
        verts=torch.from_numpy(verts.astype(np.int32)),
        offsets=torch.from_numpy(offsets),
        dst=torch.from_numpy(d.astype(np.int32)),
        w=torch.from_numpy(w.astype(np.float32)),
        table_offsets=torch.from_numpy(table_offsets),
        table_size=int(table_offsets[-1]),
        chunk_offsets=torch.from_numpy(chunk_offsets.astype(np.int64)),
        chunk_hub=torch.from_numpy(chunk_hub.astype(np.int32)),
        hub_chunks=torch.from_numpy(hub_chunks.astype(np.int32)),
        max_chunk=int(np.diff(chunk_offsets).max()),
    )


def _validate(lay, comm, comm_deg, vdeg, self_loop):
    dev = lay.dst.device
    for name, t, dt in (("verts", lay.verts, torch.int32),
                        ("offsets", lay.offsets, torch.int64),
                        ("dst", lay.dst, torch.int32),
                        ("w", lay.w, torch.float32),
                        ("table_offsets", lay.table_offsets, torch.int64),
                        ("chunk_offsets", lay.chunk_offsets, torch.int64),
                        ("chunk_hub", lay.chunk_hub, torch.int32),
                        ("hub_chunks", lay.hub_chunks, torch.int32),
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
            or lay.hub_chunks.numel() != h + 1
            or lay.chunk_offsets.numel() != lay.num_chunks + 1
            or lay.w.numel() != lay.dst.numel()
            or not 1 <= lay.max_chunk <= HEAVY_CHUNK):
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
    sc = lay.scratch
    if sc is None or sc.table.device != dev:
        raise ValueError("heavy_argmax: the layout has no scratch on "
                         f"{dev}; move it there with HeavyLayout.to")
    h = lay.num_hubs
    best_c = torch.empty(h, dtype=torch.int32, device=dev)
    best_gain = torch.empty(h, dtype=torch.float32, device=dev)
    counter0 = torch.empty(h, dtype=torch.float32, device=dev)
    lib = _build.library("heavy_bincount", _SIGNATURE)
    err = lib.cv_heavy_argmax(
        lay.verts.data_ptr(), lay.dst.data_ptr(), lay.w.data_ptr(), h,
        lay.chunk_hub.data_ptr(), lay.chunk_offsets.data_ptr(),
        lay.hub_chunks.data_ptr(), lay.num_chunks, lay.max_chunk,
        lay.table_offsets.data_ptr(), sc.table.data_ptr(),
        sc.slots.data_ptr(), sc.claims.data_ptr(), sc.partial.data_ptr(),
        sc.best.data_ptr(), comm.data_ptr(), comm_deg.data_ptr(),
        vdeg.data_ptr(), self_loop.data_ptr(), comm.numel(),
        float(constant), SENTINEL,
        best_c.data_ptr(), best_gain.data_ptr(), counter0.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
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
