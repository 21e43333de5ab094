"""Collectives over the shards of a mesh (the counterpart of the
reference's ``shard_map`` bodies and ``lax`` collectives,
``cuvite_tpu/comm/exchange.py``, ``louvain/step.py:74``,
``louvain/bucketed.py:835,932``).

A per-shard value is a Python list of tensors over this process's
shards, entry i belonging to shard ``mesh.shard_ids[i]`` and living on
``mesh.devices[i]``.  The sharded sweeps are bulk-synchronous: per-shard
stages separated by these calls, each process driving its own shards in
shard order, no thread per shard.  Callers index the shards' vertex
ranges by global shard id, so they walk ``mesh.shard_ids`` beside the
lists.

One process (``mesh.group`` None) holds every shard: blocks move with
``.to(device, non_blocking=True)``, which on one device is no copy at
all and between cards a peer copy on the current stream.  Under a
process group (one rank per card, ``comm/multihost.py``) each function
has a form over the group that takes and returns the LOCAL shards'
lists: ``all_gather`` and ``all_to_all`` on ``torch.distributed``'s
collectives (NCCL on the card, gloo on the CPU), and ``psum`` as an
all-gather followed by a sum in shard order, so that every rank gets the
one-process mesh's bits on any weights.  Convergence and the budget
retry branch on those sums; every rank must take the same branch, or
the collectives deadlock.

The recording seam of the mesh audit (``analysis/meshcheck.py``):
:func:`record_to` a list, and every call appends, in program order, its
name, its scope (the mesh's axis: ``v``, or ``ici``/``dcn`` for a view of
a hybrid mesh), the dtype and per-shard shapes of its input, the bytes of
one shard's output, the size of the mesh it spans and which view it was.  Off (None, the
default) it costs one test of a module global a call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# Bytes this process has handed to the process group's collectives: its
# own payload, each all-gather's local block and each all-to-all's send
# buffer (the per-rank traffic the smoke reports).
_SENT = [0]


# The audit's log, or None.
_LOG = None


def record_to(log: list | None) -> list | None:
    """Start recording into ``log`` (None stops); returns the prior log."""
    global _LOG
    prior, _LOG = _LOG, log
    return prior


def _note(name: str, xs: list, mesh, out: list) -> None:
    y = out[0]
    _LOG.append({"op": name, "scope": mesh.axis_name,
                 "dtype": str(xs[0].dtype).split(".")[-1],
                 "shapes": [tuple(x.shape) for x in xs],
                 "out_bytes": int(y.numel()) * int(y.element_size()),
                 "size": mesh.size, "view": id(mesh)})


def sent_bytes() -> int:
    return _SENT[0]


def zero_sent_bytes() -> None:
    _SENT[0] = 0


def _to(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device, non_blocking=True)


def _gather_shards(xs: list, mesh) -> torch.Tensor:
    """``[S, ...]``: every shard's value stacked in shard order, on this
    rank's device (process-group form)."""
    local = torch.stack(xs)
    _SENT[0] += local.numel() * local.element_size()
    out = [torch.empty_like(local)
           for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(out, local, group=mesh.group)
    return torch.cat(out)


def all_gather(xs: list, mesh) -> list:
    """Tiled all_gather: every shard gets the concatenation of all blocks
    along axis 0, in shard order (``lax.all_gather(..., tiled=True)``).
    The blocks have one shape."""
    if mesh.group is not None:
        full = _gather_shards(xs, mesh).flatten(0, 1)
        out = [full] * len(xs)
    else:
        out, cache = [], {}
        for d in mesh.devices:
            if d not in cache:
                cache[d] = torch.cat([_to(x, d) for x in xs])
            out.append(cache[d])
    if _LOG is not None:
        _note("all_gather", xs, mesh, out)
    return out


def psum(xs: list, mesh) -> list:
    """Sum of the shards' values, in shard order, replicated on every shard
    (``lax.psum``).  It accumulates in the values' type: the callers sum
    their float values in f64, as the rest of the port does."""
    if mesh.group is not None:
        parts = _gather_shards(xs, mesh)
        total = parts[0]
        for x in parts[1:]:
            total = total + x
        out = [total] * len(xs)
    else:
        d0 = mesh.devices[0]
        total = _to(xs[0], d0)
        for x in xs[1:]:
            total = total + _to(x, d0)
        out = [_to(total, d) for d in mesh.devices]
    if _LOG is not None:
        _note("psum", xs, mesh, out)
    return out


def all_to_all(xs: list, mesh) -> list:
    """Tiled all_to_all over ``[S, ...]`` blocks: shard t receives block
    t of every shard s at position s, ``ys[t][s] = xs[s][t]``
    (``lax.all_to_all(x, axis, 0, 0, tiled=True)`` on ``[S, ...]``).
    Under a process group: one ``all_to_all_single`` with equal splits,
    each rank's blocks packed by destination rank."""
    if mesh.group is not None:
        L, S = len(xs), mesh.size
        W = S // L
        rest = xs[0].shape[1:]
        # [L src, W dst rank, L dst, ...] -> dst-rank major.
        send = torch.stack(xs).view(L, W, L, *rest).transpose(0, 1)
        send = send.contiguous()
        recv = torch.empty_like(send)     # [W src rank, L src, L dst, ...]
        _SENT[0] += send.numel() * send.element_size()
        dist.all_to_all_single(recv, send, group=mesh.group)
        ys = recv.view(S, L, *rest).transpose(0, 1)
        out = list(ys.contiguous().unbind(0))
    else:
        out = [torch.stack([_to(x[t], d) for x in xs])
               for t, d in enumerate(mesh.devices)]
    if _LOG is not None:
        _note("all_to_all", xs, mesh, out)
    return out
