"""Segment reductions and the in-loop modularity (port of
``cuvite_tpu/ops/segment.py:28-110``).

Segments are torch ``index_add_`` / ``scatter_reduce_`` over a leading
axis.  ``modularity_terms`` accumulates in float64 on the device: the
reference sums in f32, or in double-single pairs once 2m reaches 2^24,
because a TPU has no f64; an H100 has, so the port needs no ds32 mode.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; empty segments hold the dtype's lowest value
    (-inf for floats), as ``jax.ops.segment_max`` does."""
    low = (float("-inf") if data.dtype.is_floating_point
           else torch.iinfo(data.dtype).min)
    out = torch.full((num_segments,), low, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, segment_ids.long(), data, "amax")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment min; empty segments hold the dtype's largest value."""
    high = (float("inf") if data.dtype.is_floating_point
            else torch.iinfo(data.dtype).max)
    out = torch.full((num_segments,), high, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, segment_ids.long(), data, "amin")


def modularity_terms(counter0: torch.Tensor, comm_deg: torch.Tensor,
                     constant: float) -> torch.Tensor:
    """Q = e*c - a^2*c^2 in float64, from the per-vertex weight into the
    current community and the community degrees (reference
    louvain.cpp:2433-2481).  Returns a 0-dim f64 tensor on their device."""
    le = counter0.double().sum()
    la2 = comm_deg.double().square().sum()
    return le * constant - la2 * constant * constant
