"""Per-phase reported modularity (port of
``cuvite_tpu/louvain/precise.py:34-91``).

Two paths, chosen by where the edge slab lives:

- device (``device_slab`` given): one pass over the slab already resident
  on the card -- the sort engine's -- with only the [nv_pad] assignment
  uploaded.  Q = le*c - la2*c^2 with the internal weight, the vertex and
  community degrees all summed in f64 on the card; the reference sums in
  double-single f32 pairs, because a TPU has no f64.
- host (default): the phase-end assignment is already on the host, so the
  f64 numpy oracle over the phase's graph.  The bucketed engine keeps no
  slab on the card and takes this path.

Both give the host oracle's value to f64 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from cuvite_tpu_torch.evaluate.modularity import modularity
from cuvite_tpu_torch.ops import segment as seg
from cuvite_tpu_torch.utils.trace import NullTracer


def _device_modularity(src: torch.Tensor, dst: torch.Tensor,
                       w: torch.Tensor, comm: torch.Tensor, nv_pad: int,
                       constant: float, tracer) -> float:
    """Q over one slab (padding rows src == nv_pad drop) in f64, read as
    a ``host_read`` stage of ``tracer``."""
    w64 = w.double()
    csrc = comm[src.clamp(max=nv_pad - 1).long()]
    ck = comm[dst.long()]
    internal = (csrc == ck) & (src < nv_pad)
    le = torch.where(internal, w64, 0.0).sum()
    vdeg = seg.segment_sum_drop(w64, src, nv_pad)
    la2 = seg.segment_sum(vdeg, comm.long(), nv_pad).square().sum()
    with tracer.stage("host_read"):
        return float(le * constant - la2 * constant * constant)


def phase_modularity(dg, comm_pad: np.ndarray, device_slab=None,
                     tracer=None) -> float:
    """Modularity of ``comm_pad`` (padded-space labels) on ``dg``'s graph.
    ``device_slab``: the (src, dst, w) tensors of ``dg`` already on the
    device, or None for the host oracle.  ``tracer``: on the device, the
    labels' upload and the read of Q are ``host_read`` stages."""
    if device_slab is not None:
        tracer = tracer if tracer is not None else NullTracer()
        src, dst, w = device_slab
        with tracer.stage("host_read"):
            comm = torch.from_numpy(np.ascontiguousarray(comm_pad)).to(
                src.device)
        return _device_modularity(src, dst, w, comm, dg.nv_pad,
                                  1.0 / dg.graph.total_edge_weight_twice(),
                                  tracer)
    return modularity(dg.graph, np.asarray(comm_pad)[dg.old_to_pad])
