"""Row argmax for the degree buckets: CUDA kernel wrapper and its plain
PyTorch twin.

Replaces ``row_argmax_pallas`` (``cuvite_tpu/kernels/row_argmax.py:166``).
Per bucket row (vertex v, D neighbour slots): dedup the neighbour
communities, sum the weights of each, compute counter0 (weight into the
current community, self-loops included) and the modularity gain of every
other community, and return the best move -- ties to the smaller id, the
sentinel and -inf when no community is a candidate.

The port keeps rows row-major ``[N, D]`` and gathers ``comm[dst]`` and
``comm_deg[c]`` inside the function: callers pass the bucket's ``dst``/``w``
matrices and its vertex ids, not pre-gathered community matrices.  The
reference's transposed ``[D, N]`` layout, 128-lane padding and the ``szT``
size channel of the sparse multi-device exchange are not carried over (no
multi-GPU yet).

An optional per-row degree ``deg`` [N] int32 stops each row at its
degree: the kernel never reads the slots past it, and the twin treats them
as padding slots (the row's own community, weight 0), which they are in
every bucket plan, so the results are those of the full width.

The kernel reads each vertex through one record of :func:`vertex_table`
(community, community degree, degree, self-loop): one gather per slot and
per row instead of two and four.  A caller that launches many buckets in
one sweep builds the table once and passes it as ``vinfo``.

``row_argmax`` launches the kernel (``csrc/row_argmax.cu``) for CUDA
tensors and runs ``row_argmax_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cuvite_tpu_torch.kernels import _build

SENTINEL = int(np.iinfo(np.int32).max)
MAX_WIDTH = 8192
# Rows x width per step of the plain twin, bounding its [rows, D] transients.
ROW_ELEMS_CHUNK = 1 << 22

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURE = {
    "cv_row_argmax": ([_P, _P, _P, _P, _L, _I, _P, _I, _F, _I, _P, _P,
                       _P, _P], _I),
}


def vertex_table(comm, comm_deg, vdeg, self_loop):
    """[nv, 4] int32 records of the vertices, as the kernels gather them:
    comm[v], comm_deg[comm[v]], vdeg[v] and self_loop[v], the floats by
    their bits."""
    out = torch.empty((comm.numel(), 4), dtype=torch.int32,
                      device=comm.device)
    out[:, 0] = comm
    out[:, 1] = torch.index_select(comm_deg, 0, comm).view(torch.int32)
    out[:, 2] = vdeg.view(torch.int32)
    out[:, 3] = self_loop.view(torch.int32)
    return out


def _validate(dst, w, verts, comm, comm_deg, vdeg, self_loop, deg):
    dev = dst.device
    checks = [("dst", dst, torch.int32, 2), ("w", w, torch.float32, 2),
              ("verts", verts, torch.int32, 1),
              ("comm", comm, torch.int32, 1),
              ("comm_deg", comm_deg, torch.float32, 1),
              ("vdeg", vdeg, torch.float32, 1),
              ("self_loop", self_loop, torch.float32, 1)]
    if deg is not None:
        checks.append(("deg", deg, torch.int32, 1))
    for name, t, dt, nd in checks:
        if t.device != dev:
            raise ValueError(f"row_argmax: {name} is on {t.device}, dst on "
                             f"{dev}")
        if t.dtype != dt or t.dim() != nd:
            raise ValueError(f"row_argmax: {name} must be a {nd}-d {dt} "
                             f"tensor, got {t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"row_argmax: {name} must be contiguous")
    if (w.shape != dst.shape or verts.shape[0] != dst.shape[0]
            or (deg is not None and deg.shape[0] != dst.shape[0])):
        raise ValueError(f"row_argmax: shapes dst {tuple(dst.shape)}, w "
                         f"{tuple(w.shape)}, verts {tuple(verts.shape)}, "
                         f"deg {None if deg is None else tuple(deg.shape)}")
    if not 1 <= dst.shape[1] <= MAX_WIDTH:
        raise ValueError(f"row_argmax: width {dst.shape[1]} outside "
                         f"1..{MAX_WIDTH}")
    if not (comm.numel() == vdeg.numel() == self_loop.numel() >= 1):
        raise ValueError("row_argmax: comm, vdeg and self_loop must be "
                         "non-empty per-vertex tables of one length")


def row_argmax(dst, w, verts, comm, comm_deg, vdeg, self_loop, constant,
               deg=None, vinfo=None):
    """Best move of every bucket row.

    dst [N, D] int32 neighbour vertex ids (padding: the row's own vertex);
    w [N, D] f32 weights (padding 0); verts [N] int32 row vertices (padding
    rows: any id >= len(comm), computed against the last vertex);
    comm [nv] int32 community per vertex; comm_deg f32 community degrees;
    vdeg / self_loop [nv] f32; constant = 1/(2m) as an f32 value; deg
    [N] int32 per-row degrees (slots past them are padding), or None for
    the full width; vinfo: the tables' :func:`vertex_table` when the
    caller has it (built here when None; the CPU twin does not use it).
    Returns (best_c [N] int32, best_gain [N] f32, counter0 [N] f32).
    """
    _validate(dst, w, verts, comm, comm_deg, vdeg, self_loop, deg)
    if dst.device.type == "cpu":
        return row_argmax_plain(dst, w, verts, comm, comm_deg, vdeg,
                                self_loop, constant, deg)
    if dst.device.type != "cuda":
        raise ValueError(f"row_argmax: no kernel for device {dst.device}")
    if vinfo is None:
        vinfo = vertex_table(comm, comm_deg, vdeg, self_loop)
    if (vinfo.device != dst.device or vinfo.dtype != torch.int32
            or vinfo.shape != (comm.numel(), 4) or not vinfo.is_contiguous()):
        raise ValueError("row_argmax: vinfo must be the contiguous [nv, 4] "
                         "int32 vertex_table on the rows' device")
    n, width = dst.shape
    best_c = torch.empty(n, dtype=torch.int32, device=dst.device)
    best_gain = torch.empty(n, dtype=torch.float32, device=dst.device)
    counter0 = torch.empty(n, dtype=torch.float32, device=dst.device)
    lib = _build.library("row_argmax", _SIGNATURE)
    err = lib.cv_row_argmax(
        dst.data_ptr(), w.data_ptr(), verts.data_ptr(),
        None if deg is None else deg.data_ptr(), n, width,
        vinfo.data_ptr(), comm.numel(), float(constant), SENTINEL,
        best_c.data_ptr(), best_gain.data_ptr(), counter0.data_ptr(),
        torch.cuda.current_stream(dst.device).cuda_stream)
    _build.check(err, "row_argmax")
    row_argmax.launches += 1
    return best_c, best_gain, counter0


row_argmax.launches = 0


def row_argmax_plain(dst, w, verts, comm, comm_deg, vdeg, self_loop,
                     constant, deg=None):
    """Plain PyTorch twin of :func:`row_argmax` (same signature and
    results): the per-row sort formulation of the reference's
    ``_row_argmax_sorted`` (``cuvite_tpu/louvain/bucketed.py:627``), in
    chunks of at most ``ROW_ELEMS_CHUNK`` slots."""
    n, width = dst.shape
    cst = torch.tensor(float(constant), dtype=torch.float32,
                       device=dst.device)
    chunk = max(ROW_ELEMS_CHUNK // width, 1)
    outs = [_rows_plain(dst[i:i + chunk], w[i:i + chunk],
                        verts[i:i + chunk], comm, comm_deg, vdeg, self_loop,
                        cst, None if deg is None else deg[i:i + chunk])
            for i in range(0, n, chunk)]
    if not outs:
        e = dst.new_empty(0)
        return e, w.new_empty(0), w.new_empty(0)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _rows_plain(dst, w, verts, comm, comm_deg, vdeg, self_loop, cst, deg):
    v = verts.clamp(max=comm.numel() - 1).long()
    curr = comm[v]
    vd = vdeg[v]
    ax = comm_deg[curr.long()] - vd
    c = comm[dst.long()]
    if deg is not None:   # slots past the degree are padding slots
        pad = torch.arange(dst.shape[1], device=dst.device) >= deg[:, None]
        c = torch.where(pad, curr[:, None], c)
        w = torch.where(pad, 0.0, w)
    is_cc = c == curr[:, None]
    counter0 = torch.where(is_cc, w, 0.0).sum(dim=1)
    eix = counter0 - self_loop[v]
    c_s, order = torch.sort(c, dim=1, stable=True)
    w_s = w.gather(1, order)
    leader = torch.ones_like(c_s, dtype=torch.bool)
    leader[:, 1:] = c_s[:, 1:] != c_s[:, :-1]
    run = leader.long().cumsum(dim=1) - 1
    wagg = torch.zeros_like(w_s).scatter_add_(1, run, w_s).gather(1, run)
    valid = leader & (c_s != curr[:, None])
    ay = comm_deg[c_s.long()]
    # Operand order of the reference: 2*(wagg-eix) - ((2*vdeg)*(ay-ax))*c.
    gain = 2.0 * (wagg - eix[:, None]) \
        - 2.0 * vd[:, None] * (ay - ax[:, None]) * cst
    gain = torch.where(valid, gain, float("-inf"))
    best_gain = gain.max(dim=1).values
    at_best = valid & (gain == best_gain[:, None])
    best_c = torch.where(at_best, c_s, SENTINEL).min(dim=1).values
    return best_c.to(torch.int32), best_gain, counter0
