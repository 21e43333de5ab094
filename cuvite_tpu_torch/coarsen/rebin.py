"""Device re-binning: bucket plans built on the card from a coalesced slab
(port of ``cuvite_tpu/coarsen/rebin.py:74-208``).

Coarse phases need a degree-bucketed plan of the coarse graph.  The host
``BucketPlan.build`` reads the slab on the host; :func:`device_plan`
builds the same plan on the card from the slab already there (or uploaded
once): a degree histogram, the class of every vertex against
``DEFAULT_BUCKETS``, and the gathers into the ``[rows, width]`` dst/w
layout that ``bucketed_step`` sweeps.  It emits the port's de-padded
``DevicePlan`` (``louvain/bucketed.py``): real rows only, each with its
degree, columns past the degree padded with the row's own vertex and
weight 0, ``self_loop`` and the assembly ``perm`` -- equal, tensor for
tensor, to ``DevicePlan.upload(BucketPlan.build(slab))``.  There is no
host plan build and no slab download; one small host read takes the
class sizes, which fix the tensors' shapes.

Eligibility is the reference's (:func:`rebin_eligible`): a coalesced
slab's degrees are bounded by nv_pad, so a class with nv_pad <=
``DEFAULT_BUCKETS[-1]`` has no heavy residual (a slab that is not
coalesced, such as phase 0's of a CSR with repeated edges, may have one:
:class:`HubSlabError`), and the class's static
geometry (:func:`rebin_geometry`, the reference's compile-stable shapes)
must stay within ``CUVITE_REBIN_MAX_ELEMS`` elements.  The port builds no
padded rows, so the geometry serves that budget only.
``CUVITE_DEVICE_REBIN=0`` keeps the host build (the A/B lever).

Slab contract: the real rows (src < nv_local) in ascending src order,
padding rows (src == nv_local, w == 0) anywhere after them -- what a host
CSR slab, ``coalesced_runs`` and the batched coarsening all give.  The
batched engine calls :func:`device_plan` on its folded batch slab
(``core/batch.fold_slab``: tenant b's vertex v at b * nv_pad + v), which
keeps that order: for every coarse phase, and for phase 0 at pack time
(``louvain/batched.py::_phase0_plan``).
Self-loops are summed in float64 and rounded once, as the host build
does.
"""

from __future__ import annotations

import os

import torch

from cuvite_tpu_torch.louvain.bucketed import DEFAULT_BUCKETS, DevicePlan
from cuvite_tpu_torch.utils.envknob import env_int
from cuvite_tpu_torch.utils.trace import NullTracer

# Plan-element ceiling of an eligible class's geometry (sum of rows x
# width), as the reference's.
DEFAULT_REBIN_MAX_ELEMS = 1 << 27


def rebin_max_elems() -> int:
    """``CUVITE_REBIN_MAX_ELEMS`` in [1, 2^34], else the default (with a
    warning when set but malformed)."""
    return env_int("CUVITE_REBIN_MAX_ELEMS", DEFAULT_REBIN_MAX_ELEMS,
                   maximum=1 << 34)


def device_rebin_enabled() -> bool:
    """Device re-binning is the default for eligible coarse phases;
    ``CUVITE_DEVICE_REBIN=0`` pins the host ``BucketPlan.build``.  Read
    per call."""
    return os.environ.get("CUVITE_DEVICE_REBIN", "1").lower() \
        not in ("", "0", "false")


def rebin_geometry(nv_pad: int, ne_pad: int,
                   widths: tuple = DEFAULT_BUCKETS) -> tuple:
    """The reference's class-static geometry ``((width, rows), ...)``:
    every ladder width up to the first that covers nv_pad, ``rows`` the
    pow2 ceiling of min(nv_pad, ne_pad // (previous width + 1))."""
    geom = []
    prev = 0
    for width in widths:
        if prev >= nv_pad:
            break
        cap = min(nv_pad, max(ne_pad // (prev + 1), 1))
        rows = 1 << max(int(cap - 1).bit_length(), 0)
        geom.append((width, rows))
        prev = width
    return tuple(geom)


def rebin_eligible(nv_pad: int, ne_pad: int,
                   widths: tuple = DEFAULT_BUCKETS) -> bool:
    """True when the class can be re-binned on the device: no heavy
    residual possible (nv_pad <= the widest bucket) and the geometry
    within :func:`rebin_max_elems`."""
    if nv_pad > widths[-1]:
        return False
    elems = sum(r * w for w, r in rebin_geometry(nv_pad, ne_pad, widths))
    return elems <= rebin_max_elems()


class HubSlabError(ValueError):
    """:func:`device_plan` met a vertex of degree above the widest bucket:
    the slab needs the host build's heavy layout.  Only a slab that is not
    coalesced can hold one in an eligible class (a phase-0 slab of a CSR
    with repeated edges)."""


def device_plan(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, *,
                nv_local: int, tracer=None) -> DevicePlan:
    """The ``DevicePlan`` of a slab on the device (module note): ``src``,
    ``dst`` int32 and ``w`` float32, 1-d, on one device.  Raises
    :class:`HubSlabError` if a vertex's degree exceeds the widest bucket
    (an ineligible slab), before any bucket is built.
    ``tracer``: its blocking reads of the card are ``host_read``
    stages."""
    tracer = tracer if tracer is not None else NullTracer()
    dev = src.device
    real = src < nv_local
    with tracer.stage("host_read"):
        idx = torch.nonzero(real).squeeze(1)
    s = src[idx].long()
    d = dst[idx]
    ww = w[idx]
    n_e = int(idx.numel())
    deg = torch.zeros(nv_local, dtype=torch.int64, device=dev)
    deg.index_add_(0, s, torch.ones_like(s))
    row_start = torch.cumsum(deg, 0) - deg
    is_self = d.long() == s
    self_loop = torch.zeros(nv_local, dtype=torch.float64, device=dev)
    with tracer.stage("host_read"):   # the masks' sizes
        self_loop.index_add_(0, s[is_self], ww[is_self].double())

    # Class k holds degrees in (widths[k-1], widths[k]); degree 0 none.
    with tracer.stage("host_read"):   # a synchronous upload
        bounds = torch.tensor(DEFAULT_BUCKETS, dtype=torch.int64,
                              device=dev)
    n_cls = len(DEFAULT_BUCKETS)
    cls = torch.bucketize(deg, bounds)
    cls = torch.where(deg == 0, n_cls + 1, cls)
    sizes = torch.zeros((2, n_cls + 2), dtype=torch.int64, device=dev)
    sizes[0].index_add_(0, cls, torch.ones_like(cls))
    sizes[1].index_add_(0, cls, deg)
    # The one host read: the plan's shapes, and each class's edges for
    # the coverage accounting.
    with tracer.stage("host_read"):
        sizes, class_edges = sizes.tolist()
    if sizes[n_cls]:
        raise HubSlabError(
            f"device_plan: {sizes[n_cls]} vertices of degree above "
            f"{DEFAULT_BUCKETS[-1]}: the slab is not eligible for device "
            "re-binning (rebin_eligible)")
    order = torch.sort(cls, stable=True).indices  # graftlint: disable=R013 — a stable sort of the [nv_local] class ids (vertices, not the edge slab): the re-binned plan's row order
    buckets, widths, edges = [], [], []
    perm = torch.full((nv_local,), sum(sizes[:n_cls]), dtype=torch.int64,
                      device=dev)
    off = 0
    for k, width in enumerate(DEFAULT_BUCKETS):
        nb = sizes[k]
        if nb == 0:
            continue
        verts = order[off:off + nb]
        cols = torch.arange(width, device=dev)
        vdeg_r = deg[verts]
        has = cols[None, :] < vdeg_r[:, None]
        at = (row_start[verts][:, None] + cols[None, :]).clamp(
            max=max(n_e - 1, 0))
        dmat = torch.where(has, d[at].long(), verts[:, None])
        wmat = torch.where(has, ww[at], 0.0)
        buckets.append((verts.to(torch.int32), dmat.to(torch.int32),
                        wmat.contiguous(), vdeg_r.to(torch.int32)))
        widths.append(width)
        edges.append(class_edges[k])
        perm[verts] = off + torch.arange(nb, device=dev)
        off += nb
    return DevicePlan(buckets=buckets, heavy=None,
                      self_loop=self_loop.float(), perm=perm,
                      widths=widths, bucket_edges=edges)

