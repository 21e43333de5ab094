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
reference's transposed ``[D, N]`` layout and 128-lane padding are not
carried over.

The size form, :func:`row_argmax_sized` (the reference's ``szT``
channel, ``row_argmax_pallas(..., szT=...)``), serves the sparse ghost
exchange of a vertex mesh, where a shard holds no community-indexed
table: a slot's ``dst`` is an extended-local index (owned vertex or
ghost) into the env's ``comm_ext``/``cdeg_ext``/``csize_ext`` -- the
community and the degree and size attached to it -- the row's own
community degree is the env's ``cdeg_v``, and a fourth output
``best_size`` [N] int32 is the size carried by the winning slot (the
sentinel with no candidate).  It has its own launch count.

An optional per-row degree ``deg`` [N] int32 stops each row at its
degree: the kernel never reads the slots past it, and the twin treats them
as padding slots (the row's own community, weight 0), which they are in
every bucket plan, so the results are those of the full width.

The kernel reads each vertex through one record of :func:`vertex_table`
(community, community degree, degree, self-loop): one gather per slot and
per row instead of two and four.  A caller that launches many buckets in
one sweep builds the table once and passes it as ``vinfo``.

Batches: the batched engine (``louvain/batched.py``) folds B tenants into
one id space, vertex or community v of tenant b stored as b * nv_pad + v
with nv_pad a power of two, and passes ``constant`` as the [B] float32
tensor of the tenants' 1/(2m): each row takes its tenant's
(``constant[v >> log2(nv_pad)]``), so one launch per width class covers
every tenant.  One graph is a batch of one: a float ``constant`` becomes
a one-element tensor (:func:`tenant_constants`) and the same code runs.

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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = {
    "cv_row_argmax": ([_P, _P, _P, _P, _L, _I, _P, _I, _P, _I, _I, _P, _P,
                       _P, _P], _I),
    "cv_row_argmax_sized": ([_P, _P, _P, _P, _L, _I, _P, _I, _P, _I, _I, _P,
                             _P, _P, _P, _P, _P], _I),
}


def row_body(width: int) -> str:
    """The kernel body a row class of ``width`` runs (``launch`` in
    ``csrc/row_argmax.cu``): a lane group per row up to 32, a warp per
    row up to ``kWarpMaxWidth`` = 256, a block per row above."""
    if width in (8, 16, 32):
        return f"narrow{width}"
    return "warp" if width <= 256 else "block"


def tenant_constants(constant, device) -> torch.Tensor:
    """The [B] float32 per-tenant constants as the kernels take them: a
    tensor as given, one graph's float as a batch of one (a fill on
    ``device``, rounded to f32 as the reference rounds it)."""
    if isinstance(constant, torch.Tensor):
        return constant
    return torch.full((1,), float(constant), dtype=torch.float32,
                      device=device)


def tenant_shift(consts: torch.Tensor, nv: int, where: str) -> int:
    """The shift by which a vertex id below ``nv`` maps to its tenant's
    entry of ``consts``: log2 of the tenants' vertex count ``nv // B`` (a
    power of two when B > 1); for one graph ceil(log2 nv), so every id
    maps to entry 0."""
    b = consts.numel()
    if (consts.dtype != torch.float32 or consts.dim() != 1
            or not consts.is_contiguous() or b < 1):
        raise ValueError(f"{where}: per-tenant constants must be a "
                         "contiguous non-empty 1-d float32 tensor")
    per = nv // b
    if per * b != nv or (b > 1 and per & (per - 1)):
        raise ValueError(f"{where}: {nv} folded vertices are not {b} "
                         "tenants of a power-of-two vertex count")
    return (per - 1).bit_length()


def vertex_table(comm, comm_deg, vdeg, self_loop):
    """[nv, 4] int32 records of the vertices, as the kernels gather them:
    comm[v], comm_deg[comm[v]], vdeg[v] and self_loop[v], the floats by
    their bits."""
    return attached_vertex_table(comm, torch.index_select(comm_deg, 0, comm),
                                 vdeg, self_loop)


def attached_vertex_table(comm, cdeg_v, vdeg, self_loop):
    """:func:`vertex_table` with the community degree attached to each
    vertex already (the size form's: the env's ``cdeg_v``)."""
    out = torch.empty((comm.numel(), 4), dtype=torch.int32,
                      device=comm.device)
    out[:, 0] = comm
    out[:, 1] = cdeg_v.view(torch.int32)
    out[:, 2] = vdeg.view(torch.int32)
    out[:, 3] = self_loop.view(torch.int32)
    return out


def slot_table(comm_ext, cdeg_ext, csize_ext):
    """[n_ext, 4] int32 records of the owned and ghost vertices, as the
    size form gathers them per slot: comm_ext, cdeg_ext (its bits),
    csize_ext, 0."""
    out = torch.zeros((comm_ext.numel(), 4), dtype=torch.int32,
                      device=comm_ext.device)
    out[:, 0] = comm_ext
    out[:, 1] = cdeg_ext.view(torch.int32)
    out[:, 2] = csize_ext
    return out


def _validate(dst, w, verts, comm, comm_deg, vdeg, self_loop, consts,
              deg):
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
    if consts.device != dev:
        raise ValueError("row_argmax: the per-tenant constants are on "
                         f"{consts.device}, dst on {dev}")
    return tenant_shift(consts, comm.numel(), "row_argmax")


def row_argmax(dst, w, verts, comm, comm_deg, vdeg, self_loop, constant,
               deg=None, vinfo=None):
    """Best move of every bucket row.

    dst [N, D] int32 neighbour vertex ids (padding: the row's own vertex);
    w [N, D] f32 weights (padding 0); verts [N] int32 row vertices (padding
    rows: any id >= len(comm), computed against the last vertex);
    comm [nv] int32 community per vertex; comm_deg f32 community degrees;
    vdeg / self_loop [nv] f32; constant = 1/(2m) as an f32 value, or a
    folded batch's [B] f32 tensor of them (see the module note); deg
    [N] int32 per-row degrees (slots past them are padding), or None for
    the full width; vinfo: the tables' :func:`vertex_table` when the
    caller has it (built here when None; the CPU twin does not use it).
    Returns (best_c [N] int32, best_gain [N] f32, counter0 [N] f32).
    """
    consts = tenant_constants(constant, dst.device)
    shift = _validate(dst, w, verts, comm, comm_deg, vdeg, self_loop,
                      consts, deg)
    if dst.device.type == "cpu":
        return row_argmax_plain(dst, w, verts, comm, comm_deg, vdeg,
                                self_loop, consts, deg)
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
    with torch.cuda.device(dst.device):   # launch on the tensors' card
        err = lib.cv_row_argmax(
            dst.data_ptr(), w.data_ptr(), verts.data_ptr(),
            None if deg is None else deg.data_ptr(), n, width,
            vinfo.data_ptr(), comm.numel(), consts.data_ptr(), shift,
            SENTINEL, best_c.data_ptr(), best_gain.data_ptr(),
            counter0.data_ptr(),
            torch.cuda.current_stream(dst.device).cuda_stream)
    _build.check(err, "row_argmax")
    _build.note_form("row_argmax", row_body(width), dst.device)
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
    consts = tenant_constants(constant, dst.device)
    shift = tenant_shift(consts, comm.numel(), "row_argmax_plain")
    chunk = max(ROW_ELEMS_CHUNK // width, 1)
    outs = [_rows_plain(dst[i:i + chunk], w[i:i + chunk],
                        verts[i:i + chunk], comm, comm_deg, vdeg, self_loop,
                        consts, shift,
                        None if deg is None else deg[i:i + chunk])
            for i in range(0, n, chunk)]
    if not outs:
        e = dst.new_empty(0)
        return e, w.new_empty(0), w.new_empty(0)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _rows_plain(dst, w, verts, comm, comm_deg, vdeg, self_loop, consts,
                shift, deg):
    v = verts.clamp(max=comm.numel() - 1).long()
    curr = comm[v]
    c = comm[dst.long()]
    return _argmax_rows(c, w, comm_deg[c.long()], None, curr, vdeg[v],
                        comm_deg[curr.long()] - vdeg[v], self_loop[v],
                        consts[v >> shift][:, None], deg)


def _argmax_rows(c, w, ay, sz, curr, vd, ax, sl, cst, deg):
    """The twins' row computation from per-slot communities ``c``, their
    degrees ``ay`` and (size form) sizes ``sz``: the per-row sort of the
    reference's ``_row_argmax_sorted``; ``best_size`` the min over the
    winner's slots (``bucketed.py:721-725``)."""
    if deg is not None:   # slots past the degree are padding slots
        pad = torch.arange(c.shape[1], device=c.device) >= deg[:, None]
        c = torch.where(pad, curr[:, None], c)
        w = torch.where(pad, 0.0, w)
    is_cc = c == curr[:, None]
    counter0 = torch.where(is_cc, w, 0.0).sum(dim=1)
    eix = counter0 - sl
    c_s, order = torch.sort(c, dim=1, stable=True)  # graftlint: disable=R013 — the plain twin's per-row dedup of one degree class (the CPU version the CUDA kernel is held against), not a coalesce of the slab
    w_s, ay_s = w.gather(1, order), ay.gather(1, order)
    leader = torch.ones_like(c_s, dtype=torch.bool)
    leader[:, 1:] = c_s[:, 1:] != c_s[:, :-1]
    run = leader.long().cumsum(dim=1) - 1
    wagg = torch.zeros_like(w_s).scatter_add_(1, run, w_s).gather(1, run)
    valid = leader & (c_s != curr[:, None])
    # Operand order of the reference: 2*(wagg-eix) - ((2*vdeg)*(ay-ax))*c.
    gain = 2.0 * (wagg - eix[:, None]) \
        - 2.0 * vd[:, None] * (ay_s - ax[:, None]) * cst
    gain = torch.where(valid, gain, float("-inf"))
    best_gain = gain.max(dim=1).values
    at_best = valid & (gain == best_gain[:, None])
    best_c = torch.where(at_best, c_s, SENTINEL).min(dim=1).values
    out = (best_c.to(torch.int32), best_gain, counter0)
    if sz is None:
        return out
    best_size = torch.where(c_s == best_c[:, None], sz.gather(1, order),
                            SENTINEL).min(dim=1).values
    return out + (best_size.to(torch.int32),)


def row_argmax_sized(dst, w, verts, comm_ext, cdeg_ext, csize_ext, cdeg_v,
                     vdeg, self_loop, constant, deg=None, vinfo=None,
                     sinfo=None, own: int = 0):
    """Best move of every bucket row under the sparse exchange (the size
    form, module note).

    dst [N, D] int32 extended-local slot indices (padding: the row's own
    vertex); w, verts, deg and constant as in :func:`row_argmax`, verts
    local ids < nv; comm_ext [n_ext] int32 community of every owned
    (the first nv) and ghost vertex; cdeg_ext [n_ext] f32 and csize_ext
    [n_ext] int32 the degree and size of that community; cdeg_v, vdeg,
    self_loop [nv] f32.  ``vinfo``/``sinfo``: the
    :func:`attached_vertex_table` and :func:`slot_table` when the caller
    has them.  ``own``: where the rows' own vertices start in the
    extended tables (the two-level exchange's group-extended tables put
    shard s's at ``(s % ici) * nv``; 0 otherwise).  Returns (best_c,
    best_gain, counter0, best_size [N] int32)."""
    nv = vdeg.numel()
    consts = tenant_constants(constant, dst.device)
    shift = _validate(dst, w, verts, comm_ext[own:own + nv], cdeg_v, vdeg,
                      self_loop, consts, deg)
    for name, t, dt in (("comm_ext", comm_ext, torch.int32),
                        ("cdeg_ext", cdeg_ext, torch.float32),
                        ("csize_ext", csize_ext, torch.int32),
                        ("cdeg_v", cdeg_v, torch.float32)):
        if t.device != dst.device or t.dtype != dt or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"row_argmax_sized: {name} must be a "
                             f"contiguous 1-d {dt} tensor on {dst.device}")
    n_ext = comm_ext.numel()
    if not (cdeg_ext.numel() == csize_ext.numel() == n_ext >= own + nv
            and cdeg_v.numel() == nv and own >= 0):
        raise ValueError("row_argmax_sized: comm_ext/cdeg_ext/csize_ext "
                         "must be one length >= own + nv, cdeg_v of "
                         "length nv")
    if dst.device.type == "cpu":
        return row_argmax_sized_plain(dst, w, verts, comm_ext, cdeg_ext,
                                      csize_ext, cdeg_v, vdeg, self_loop,
                                      consts, deg, own=own)
    if dst.device.type != "cuda":
        raise ValueError(f"row_argmax_sized: no kernel for device "
                         f"{dst.device}")
    if vinfo is None:
        vinfo = attached_vertex_table(comm_ext[own:own + nv], cdeg_v, vdeg,
                                      self_loop)
    if sinfo is None:
        sinfo = slot_table(comm_ext, cdeg_ext, csize_ext)
    for name, t, rows in (("vinfo", vinfo, nv), ("sinfo", sinfo, n_ext)):
        if (t.device != dst.device or t.dtype != torch.int32
                or t.shape != (rows, 4) or not t.is_contiguous()):
            raise ValueError(f"row_argmax_sized: {name} must be the "
                             f"contiguous [{rows}, 4] int32 records on the "
                             "rows' device")
    n, width = dst.shape
    best_c = torch.empty(n, dtype=torch.int32, device=dst.device)
    best_gain = torch.empty(n, dtype=torch.float32, device=dst.device)
    counter0 = torch.empty(n, dtype=torch.float32, device=dst.device)
    best_size = torch.empty(n, dtype=torch.int32, device=dst.device)
    lib = _build.library("row_argmax", _SIGNATURE)
    with torch.cuda.device(dst.device):   # launch on the tensors' card
        err = lib.cv_row_argmax_sized(
            dst.data_ptr(), w.data_ptr(), verts.data_ptr(),
            None if deg is None else deg.data_ptr(), n, width,
            vinfo.data_ptr(), nv, consts.data_ptr(), shift, SENTINEL,
            sinfo.data_ptr(), best_c.data_ptr(), best_gain.data_ptr(),
            counter0.data_ptr(), best_size.data_ptr(),
            torch.cuda.current_stream(dst.device).cuda_stream)
    _build.check(err, "row_argmax_sized")
    _build.note_form("row_argmax_sized", row_body(width), dst.device)
    row_argmax_sized.launches += 1
    return best_c, best_gain, counter0, best_size


row_argmax_sized.launches = 0


def row_argmax_sized_plain(dst, w, verts, comm_ext, cdeg_ext, csize_ext,
                           cdeg_v, vdeg, self_loop, constant, deg=None,
                           own: int = 0):
    """Plain PyTorch twin of :func:`row_argmax_sized`: the per-row sort of
    :func:`row_argmax_plain` with the per-slot degree and size read
    through ``dst``."""
    n, width = dst.shape
    nv = vdeg.numel()
    consts = tenant_constants(constant, dst.device)
    shift = tenant_shift(consts, nv, "row_argmax_sized_plain")
    chunk = max(ROW_ELEMS_CHUNK // width, 1)
    outs = [_rows_sized_plain(dst[i:i + chunk], w[i:i + chunk],
                              verts[i:i + chunk], comm_ext, cdeg_ext,
                              csize_ext, cdeg_v, vdeg, self_loop, consts,
                              shift,
                              None if deg is None else deg[i:i + chunk],
                              own)
            for i in range(0, n, chunk)]
    if not outs:
        e = dst.new_empty(0)
        return e, w.new_empty(0), w.new_empty(0), e
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _rows_sized_plain(dst, w, verts, comm_ext, cdeg_ext, csize_ext, cdeg_v,
                      vdeg, self_loop, consts, shift, deg, own):
    v = verts.clamp(max=vdeg.numel() - 1).long()
    d = dst.long()
    return _argmax_rows(comm_ext[d], w, cdeg_ext[d], csize_ext[d],
                        comm_ext[own + v], vdeg[v], cdeg_v[v] - vdeg[v],
                        self_loop[v], consts[v >> shift][:, None], deg)
