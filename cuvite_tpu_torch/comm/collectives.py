"""Collectives over the shards of one process (the counterpart of the
reference's ``shard_map`` bodies and ``lax`` collectives,
``cuvite_tpu/comm/exchange.py``, ``louvain/step.py:74``,
``louvain/bucketed.py:835,932``).

A per-shard value is a Python list of tensors indexed by shard, entry s
on ``mesh.devices[s]``; a shard's index is its list position.  The
sharded sweeps are bulk-synchronous: per-shard stages separated by these
calls, one process driving every shard in shard order, no thread per
shard.  Blocks move with ``.to(device, non_blocking=True)``: on one
device that is no copy at all, between cards a peer copy on the current
stream.

Each function takes and returns whole per-shard lists, so a form over a
``torch.distributed`` process group (one rank per card, each holding its
own entry) can take their place without touching the callers.
"""

from __future__ import annotations

import torch


def _to(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device, non_blocking=True)


def all_gather(xs: list, mesh) -> list:
    """Tiled all_gather: every shard gets the concatenation of all blocks
    along axis 0, in shard order (``lax.all_gather(..., tiled=True)``)."""
    out, cache = [], {}
    for d in mesh.devices:
        if d not in cache:
            cache[d] = torch.cat([_to(x, d) for x in xs])
        out.append(cache[d])
    return out


def psum(xs: list, mesh) -> list:
    """Sum of the shards' values, in shard order, replicated on every shard
    (``lax.psum``).  It accumulates in the values' type: the callers sum
    their float values in f64, as the rest of the port does."""
    d0 = mesh.devices[0]
    total = _to(xs[0], d0)
    for x in xs[1:]:
        total = total + _to(x, d0)
    return [_to(total, d) for d in mesh.devices]


def all_to_all(xs: list, mesh) -> list:
    """Tiled all_to_all over ``[S, ...]`` blocks: shard t receives block
    t of every shard s at position s, ``ys[t][s] = xs[s][t]``
    (``lax.all_to_all(x, axis, 0, 0, tiled=True)`` on ``[S, ...]``)."""
    return [torch.stack([_to(x[t], d) for x in xs])
            for t, d in enumerate(mesh.devices)]
