"""The vertex mesh: the devices of the shards, in shard order (port of
``cuvite_tpu/comm/mesh.py:16-92,142-172``, its flat 1-D mesh).

The reference shards the vertex axis over a ``jax.sharding.Mesh``.  Here
a :class:`Mesh` lists its shards' devices explicitly, in shard order:
shard s owns padded vertices ``[s * nv_pad, (s + 1) * nv_pad)``.

One process (no process group): the mesh holds every shard, shard s on
``mesh.devices[s]``.  Several shards may share one device:
``make_mesh(devices=[torch.device("cuda:0")] * 4)`` runs four shards on
one card, and ``[torch.device("cpu")] * 4`` on the CPU, the counterpart
of the reference's virtual CPU devices.

Several processes (``comm/multihost.initialize`` first, one rank per
card): ``make_mesh(S)`` gives this rank's view of an S-shard mesh -- its
contiguous shards ``[lo, hi)``, all on its own device, and the process
group the collectives use.  ``mesh.size`` is the global shard count in
both; per-shard lists hold the LOCAL shards, entry i being shard
``mesh.shard_ids[i]``.

Not ported: the hybrid (dcn, ici) mesh of the two-level exchange
(``make_hybrid_mesh``, ``hybrid_shape``, ``shard_outer``; ``ROADMAP.md``
A7.3) and the batch axis of ``louvain_many`` (A7.4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

VERTEX_AXIS = "v"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shards of the vertex axis: shard ``lo + i`` lives on
    ``devices[i]``.  ``group`` is the ``torch.distributed`` process group
    of a multi-process mesh, None when one process holds every shard."""

    devices: tuple
    axis_name: str = VERTEX_AXIS
    nshards: int = 0          # shards of the whole mesh; 0: len(devices)
    lo: int = 0               # global id of this process's first shard
    group: object = dataclasses.field(default=None, compare=False)

    @property
    def size(self) -> int:
        """The global shard count."""
        return self.nshards or len(self.devices)

    @property
    def shard_ids(self) -> range:
        """Global ids of this process's shards, in list order."""
        return range(self.lo, self.lo + len(self.devices))


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards.

    Under an initialized process group (``comm/multihost.initialize``):
    this rank's view, ``n_devices / world`` contiguous shards on its own
    device (``n_devices`` defaults to the world size and must be a
    multiple of it; ``devices`` is refused).  Otherwise, without
    ``devices``: the first ``n_devices`` visible CUDA cards, one shard per
    card (all of them when ``n_devices`` is None); fewer visible cards
    than shards raise.  ``devices`` lists each shard's device itself,
    repeats allowed (several shards on one card, or on the CPU); its
    length must then equal ``n_devices`` when both are given."""
    from cuvite_tpu_torch.comm import multihost

    if multihost.is_distributed():
        import torch.distributed as dist

        if devices is not None:
            raise ValueError(
                "make_mesh: a rank of a process group places its shards "
                "on its own device; devices= is for a one-process mesh")
        world = multihost.world_size()
        n = world if n_devices is None else int(n_devices)
        if n < 1 or n % world:
            raise ValueError(
                f"a {n}-shard mesh does not split over {world} ranks: "
                "the shard count must be a multiple of the world size")
        per = n // world
        return Mesh(devices=(multihost.local_device(),) * per, nshards=n,
                    lo=multihost.rank() * per, group=dist.group.WORLD)
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
    ``mesh.size`` equal blocks; returns this process's blocks, block s as
    a tensor on shard s's device."""
    n = mesh.size
    if arr.shape[0] % n:
        raise ValueError(f"shard_1d: axis 0 of length {arr.shape[0]} does "
                         f"not split into {n} equal blocks")
    if isinstance(arr, np.ndarray):
        arr = np.ascontiguousarray(arr)
        arr = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    blocks = torch.chunk(arr, n)
    return [blocks[s].to(d).contiguous()
            for s, d in zip(mesh.shard_ids, mesh.devices)]
