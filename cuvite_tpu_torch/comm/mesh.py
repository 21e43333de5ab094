"""The vertex mesh: an ordered list of devices, one per shard (port of
``cuvite_tpu/comm/mesh.py:16-92,142-172``, its flat 1-D mesh).

The reference shards the vertex axis over a ``jax.sharding.Mesh``.  Here
a :class:`Mesh` lists its shards' devices explicitly, in shard order:
shard s owns padded vertices ``[s * nv_pad, (s + 1) * nv_pad)`` and its
tensors live on ``mesh.devices[s]``.  Several shards may share one
device: ``make_mesh(devices=[torch.device("cuda:0")] * 4)`` runs four
shards on one card, and ``[torch.device("cpu")] * 4`` on the CPU, the
counterpart of the reference's virtual CPU devices.  The exchange code is
the same wherever a shard sits.  One process drives every shard
(``comm/collectives.py``).

Not ported: the hybrid (dcn, ici) mesh of the two-level exchange
(``make_hybrid_mesh``, ``hybrid_shape``, ``shard_outer``) and the
multi-process placement of ``comm/multihost.py`` (``ROADMAP.md`` A7).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

VERTEX_AXIS = "v"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shard s of the vertex axis lives on ``devices[s]``."""

    devices: tuple
    axis_name: str = VERTEX_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards.  Without ``devices`` they are the
    first ``n_devices`` visible CUDA cards, one shard per card (all of
    them when ``n_devices`` is None); fewer visible cards than shards
    raise.  ``devices`` lists each shard's device itself, repeats allowed
    (several shards on one card, or on the CPU); its length must then
    equal ``n_devices`` when both are given."""
    if devices is None:
        visible = torch.cuda.device_count()
        n = visible if n_devices is None else int(n_devices)
        if n < 1 or visible < n:
            raise ValueError(
                f"requested a {n}-shard mesh but only {visible} CUDA "
                "device(s) are visible; to place several shards on one "
                "device pass devices=[torch.device('cuda:0')] * n (or "
                "[torch.device('cpu')] * n)")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("make_mesh: devices is empty")
        if n_devices is not None and int(n_devices) != len(devs):
            raise ValueError(f"make_mesh: n_devices={n_devices} but "
                             f"{len(devs)} devices were given")
    return Mesh(devices=devs)


def shard_1d(mesh: Mesh, arr) -> list:
    """Split an owner-contiguous array (numpy or tensor) along axis 0 into
    ``mesh.size`` equal blocks, block s as a tensor on shard s's
    device."""
    n = mesh.size
    if arr.shape[0] % n:
        raise ValueError(f"shard_1d: axis 0 of length {arr.shape[0]} does "
                         f"not split into {n} equal blocks")
    if isinstance(arr, np.ndarray):
        arr = np.ascontiguousarray(arr)
        arr = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return [blk.to(d).contiguous()
            for blk, d in zip(torch.chunk(arr, n), mesh.devices)]
