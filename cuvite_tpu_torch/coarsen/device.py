"""Inter-phase coarsening on the device (port of
``cuvite_tpu/coarsen/device.py:56-145,267-313``).

The sort engine keeps its edge slab on the card, so the next phase's graph
is built there too, with no O(E) host transfer: renumber the surviving
communities densely (``device_renumber``), relabel both endpoints of every
slab row, and coalesce duplicate (src, dst) pairs through
``ops/segment.coalesced_runs`` -- the ``seg_coalesce`` kernel's dense
engine for classes with nv_pad <= ``DEFAULT_MAX_NV``, the packed sort
otherwise, or the ``msd``/``hash`` engine that ``CUVITE_SEG_COALESCE``
pins (``kernels/seg_coalesce.coalesce_engine``).  Intra-community
weight collapses onto the diagonal as self-loops.  The host pipeline
(``coarsen/rebuild.py``) is the bit-parity oracle: the dense ids are
``np.unique``'s, and the coarse CSR equals ``coarsen_graph``'s wherever
the f64 run sums are exact.

Differences from the reference, by design:

- Run sums are f64, rounded once to f32 (the host oracle's f64-then-cast),
  in both engines; the reference sums in f32 or ds32 pairs.
- Slab classes: the reference pads each coarse slab to a pow2 class with
  floors nv_pad >= 4096 and ne_pad >= 16384 so phases share compiled
  steps.  Eager torch has no compile cache, so ``maybe_shrink_to_class``
  cuts every coarse slab to exactly its ne2 rows, with
  nv_pad = next_pow2(nc).  The dense/sort choice is unchanged by it.

``device_compose_labels`` composes the fused engine's labels across
phases on the card; the sort engine composes them on the host, as the
reference's sort driver does.

The batched lifts (``batched_renumber``, ``batched_compose_labels``,
``batched_coarsen_slab``, reference ``:163-190``) take the whole
``[B, ...]`` batch in one pass: each tenant's rows keep their own dense
ids and land in their own slab prefix, with one coalesce for the batch
(``ops/segment.coalesced_runs_batched``: the ``seg_coalesce`` kernel's
batched form or one folded sort).

The reference's sub-row lifts (``subrow_renumber``,
``subrow_compose_labels`` and their ``[B, ...]`` forms, ``:200-266``) have
no counterpart: the batched engine runs a packed batch as the fold of its
sub-rows (``louvain/batched.py``), where ``batched_renumber`` over the
sub-rows gives each its own dense ranks.

``grow_slab`` (reference ``:278``) lifts a canonical slab to a larger
class when a streaming insert batch overflows its padding headroom
(``stream/session.py``).
"""

from __future__ import annotations

import os

import torch

from cuvite_tpu_torch.core.types import next_pow2
from cuvite_tpu_torch.ops import segment as seg
from cuvite_tpu_torch.utils.trace import NullTracer


def device_coarsen_enabled() -> bool:
    """Device coarsening is the sort engine's default;
    ``CUVITE_DEVICE_COARSEN=0`` keeps the host pipeline (the A/B lever).
    Read per call."""
    return os.environ.get("CUVITE_DEVICE_COARSEN", "1").lower() \
        not in ("", "0", "false")


def device_renumber(comm: torch.Tensor, real_mask: torch.Tensor, *,
                    nv_pad: int, tracer=None) -> tuple:
    """Dense ids of the surviving labels, smallest label first (the
    ``np.unique`` order of ``rebuild.renumber_communities``).

    ``comm`` [nv_pad] labels in the padded id space, ``real_mask``
    [nv_pad] bool.  Returns ``(dense_map, nc)``: ``dense_map[c]`` is the
    dense id of surviving label c (entries of labels that survive nowhere
    are meaningless), ``nc`` a 0-dim int64 tensor on the device.
    ``tracer``: the scalar's upload, which blocks, is a ``host_read``
    stage."""
    tracer = tracer if tracer is not None else NullTracer()
    lab = torch.where(real_mask, comm.long(), nv_pad)
    present = torch.zeros(nv_pad + 1, dtype=torch.int64, device=comm.device)
    with tracer.stage("host_read"):
        present[lab] = 1
    present = present[:nv_pad]   # padding labels land in the dropped slot
    dense_map = (torch.cumsum(present, 0) - present).to(comm.dtype)
    return dense_map, present.sum()


def device_coarsen_slab(src: torch.Tensor, dst: torch.Tensor,
                        w: torch.Tensor, comm: torch.Tensor,
                        real_mask: torch.Tensor, *, nv_pad: int,
                        coalesce: str | None = None, tracer=None) -> tuple:
    """Relabel and coalesce the resident slab into the next phase's slab.

    ``src`` [ne] vertex ids (padding == nv_pad), ``dst`` [ne] tail ids
    (padding 0, w 0), ``comm`` [nv_pad] phase-end labels, ``real_mask``
    [nv_pad] bool.  Returns ``(src2, dst2, w2, dense_map, nc, ne2)``: the
    coarse slab in the same [ne] length, rows sorted by (src, dst) in
    [0, ne2) and padding (src == nv_pad, dst == 0, w == 0) after;
    ``dense_map``/``nc`` as :func:`device_renumber`; ``ne2`` a Python
    int.  ``coalesce``: ``'dense'``, ``'sort'``, ``'msd'`` or ``'hash'``,
    or None for ``coalesce_engine(nv_pad)``.  ``tracer``: its blocking
    reads are ``host_read`` stages."""
    dense_map, nc = device_renumber(comm, real_mask, nv_pad=nv_pad,
                                    tracer=tracer)
    pad = src >= nv_pad
    safe_src = src.clamp(max=nv_pad - 1).long()
    csrc = dense_map[comm[safe_src].long()]
    cdst = dense_map[comm[dst.long()].long()]
    new_src = torch.where(pad, nv_pad, csrc).to(src.dtype)
    new_dst = torch.where(pad, 0, cdst).to(dst.dtype)
    w_in = torch.where(pad, 0.0, w)
    if coalesce is None:
        from cuvite_tpu_torch.kernels.seg_coalesce import coalesce_engine

        coalesce = coalesce_engine(nv_pad)
    src2, dst2, w2, ne2 = seg.coalesced_runs(
        new_src, new_dst, w_in, nv_pad=nv_pad, engine=coalesce,
        tracer=tracer)
    return src2, dst2, w2, dense_map, nc, ne2


def device_weighted_degrees(src: torch.Tensor, w: torch.Tensor, *,
                            nv_pad: int) -> torch.Tensor:
    """Weighted degree of a resident slab, summed in f64 and rounded once
    to f32 (padding src == nv_pad drops)."""
    return seg.segment_sum_drop(w.double(), src, nv_pad).float()


def device_compose_labels(dense_map: torch.Tensor, labels: torch.Tensor,
                          comm_all: torch.Tensor) -> torch.Tensor:
    """Cross-phase label composition (main.cpp:374-403): original vertex ->
    current dense id, through this phase's padded-space ``labels`` and
    their ``dense_map`` (:func:`device_renumber`)."""
    return dense_map[labels[comm_all.long()].long()]


def shrink_slab(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, *,
                new_nv_pad: int, new_ne_pad: int) -> tuple:
    """The first ``new_ne_pad`` rows of a compacted slab, with padding
    sentinels rewritten to ``new_nv_pad`` (real ids are < nc <=
    new_nv_pad).  The rows are copied, so the longer buffer can be
    freed."""
    s = src[:new_ne_pad]
    s = torch.where(s >= new_nv_pad, new_nv_pad, s).to(src.dtype)
    return s, dst[:new_ne_pad].clone(), w[:new_ne_pad].clone()


def grow_slab(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, *,
              nv_pad: int, new_nv_pad: int, new_ne_pad: int) -> tuple:
    """Lift a canonical slab to a larger class, the spill twin of
    :func:`shrink_slab`: padding sentinels rewritten from ``nv_pad`` to
    ``new_nv_pad`` and the rows extended with padding to ``new_ne_pad``.
    Real rows keep their prefix order, so the grown slab is still
    canonical."""
    cur_ne_pad = src.shape[0]
    if new_nv_pad < nv_pad or new_ne_pad < cur_ne_pad:
        raise ValueError("grow_slab grows classes; use shrink_slab to drop")
    pad_n = new_ne_pad - cur_ne_pad
    s = torch.where(src >= nv_pad, new_nv_pad, src).to(src.dtype)
    s = torch.cat([s, s.new_full((pad_n,), new_nv_pad)])
    return (s, torch.cat([dst, dst.new_zeros(pad_n)]),
            torch.cat([w, w.new_zeros(pad_n)]))


def maybe_shrink_to_class(src: torch.Tensor, dst: torch.Tensor,
                          w: torch.Tensor, *, nc: int, ne2: int,
                          nv_pad: int) -> tuple:
    """The slab-class transition after a coarsening (reference ``:297``).

    The port's class is exact: nv_pad = next_pow2(nc) and ne2 rows, no
    padding rows and none of the reference's floors (4096 vertices, 16384
    rows), which only serve XLA's compile cache.  Coarsening never grows
    nv or ne, so the slab only shrinks.  Returns (src, dst, w, nv_pad)."""
    new_nv_pad = next_pow2(max(nc, 1))
    if new_nv_pad < nv_pad or ne2 < src.shape[0]:
        src, dst, w = shrink_slab(src, dst, w, new_nv_pad=new_nv_pad,
                                  new_ne_pad=ne2)
        return src, dst, w, new_nv_pad
    return src, dst, w, nv_pad


def batched_renumber(comm: torch.Tensor, real_mask: torch.Tensor, *,
                     nv_pad: int) -> tuple:
    """:func:`device_renumber` of every tenant at once: ``comm`` and
    ``real_mask`` [B, nv_pad].  Returns (dense_map [B, nv_pad], nc [B]
    int64 tensor)."""
    lab = torch.where(real_mask, comm.long(), nv_pad)
    present = torch.zeros((comm.shape[0], nv_pad + 1), dtype=torch.int64,
                          device=comm.device)
    present.scatter_(1, lab, 1)
    present = present[:, :nv_pad]
    dense_map = (torch.cumsum(present, 1) - present).to(comm.dtype)
    return dense_map, present.sum(1)


def batched_compose_labels(dense_map: torch.Tensor, labels: torch.Tensor,
                           comm_all: torch.Tensor) -> torch.Tensor:
    """:func:`device_compose_labels` of every tenant: ``comm_all``
    [B, nv0] ids into ``labels`` [B, nv_pad].  Ids past nv_pad (a tenant
    retired before the slab class shrank) are clamped, as the reference's
    gathers clamp; the caller keeps such a tenant's old labels."""
    ids = comm_all.long().clamp(max=labels.shape[1] - 1)
    return torch.gather(dense_map, 1,
                        torch.gather(labels, 1, ids).long())


def batched_coarsen_slab(src: torch.Tensor, dst: torch.Tensor,
                         w: torch.Tensor, comm: torch.Tensor,
                         dense_map: torch.Tensor, *, nv_pad: int,
                         coalesce: str, grid: int | None = None) -> tuple:
    """:func:`device_coarsen_slab` of every tenant at once, with the
    dense maps of :func:`batched_renumber`: ``src``/``dst``/``w``
    [B, ne_pad] slabs (padding src == nv_pad), ``comm`` [B, nv_pad]
    phase-end labels.  ``coalesce``: ``'dense'`` (with ``grid``, a power
    of two above every tenant's community count), ``'sort'`` or
    ``'msd'``.  Returns
    (src2, dst2, w2 [B, ne_pad], ne2 [B] int64 tensor), each tenant's
    coarse rows in its own prefix."""
    pad = src >= nv_pad
    safe_src = src.clamp(max=nv_pad - 1).long()
    csrc = torch.gather(dense_map, 1,
                        torch.gather(comm, 1, safe_src).long())
    cdst = torch.gather(dense_map, 1,
                        torch.gather(comm, 1, dst.long()).long())
    new_src = torch.where(pad, nv_pad, csrc).to(src.dtype)
    new_dst = torch.where(pad, 0, cdst).to(dst.dtype)
    w_in = torch.where(pad, 0.0, w)
    return seg.coalesced_runs_batched(new_src, new_dst, w_in,
                                      nv_pad=nv_pad, engine=coalesce,
                                      grid=grid)
