"""The vertex mesh: the devices of the shards, in shard order (port of
``cuvite_tpu/comm/mesh.py:16-172``).

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

The hybrid mesh of the two-level exchange (:func:`make_hybrid_mesh`):
the same shards, in the same order, factored into ``dcn`` groups of
``ici`` consecutive shards (shard ``g * ici + i`` is member i of group
g and owns ``[s * nv_pad, (s + 1) * nv_pad)``, exactly as in the flat
``make_mesh(dcn * ici)``).  Community tables are replicated only inside
a group (the fast ICI axis); the groups exchange ghosts (the slow DCN
axis).  The mesh carries two kinds of sub-mesh view, each a
:class:`Mesh` that the collectives of ``comm/collectives.py`` accept,
with the positions of its shards in this process's per-shard lists:
the ICI group of each local shard, and its DCN column (the ``dcn``
shards with the same member index).  Under a process group the views
that span several ranks carry a ``torch.distributed`` group of their
own; :func:`make_hybrid_mesh` creates those on every rank in one fixed
order (``new_group`` is a collective over the world).  The batch axis
of ``louvain_many`` is ``louvain/batched.make_batch_mesh``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

VERTEX_AXIS = "v"
# The two axes of the hybrid mesh: the slow outer one between groups,
# the fast inner one inside a group (reference mesh.py:18-25).
DCN_AXIS = "dcn"
ICI_AXIS = "ici"


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
    hybrid: tuple = ()        # (dcn, ici) of a hybrid mesh; () when flat
    # Per local shard: (view, positions) of its ICI group and of its DCN
    # column, the positions being the view's shards in this process's
    # lists; each view listed once, in group (column) order.
    ici_views: tuple = dataclasses.field(default=(), compare=False)
    dcn_views: tuple = dataclasses.field(default=(), compare=False)

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


def make_hybrid_mesh(dcn: int, ici: int, devices=None) -> Mesh:
    """The 2-D ``(dcn, ici)`` mesh of the two-level exchange (module
    note): the shards of ``make_mesh(dcn * ici, devices)`` in the same
    order, ``ici`` consecutive ones to a group.  ``devices`` lists each
    shard's device, repeats allowed; under a process group it is refused
    and this rank's view is given, as by :func:`make_mesh`, with a
    ``torch.distributed`` group for each ICI group and DCN column that
    spans more than one rank (every rank creates all of them, groups
    first, then columns).  A rank's shard count must divide ``ici`` or be
    a multiple of it, so that every view holds as many shards on each of
    its ranks."""
    if dcn < 1 or ici < 1:
        raise ValueError(f"mesh factors must be >= 1, got {dcn}x{ici}")
    n = dcn * ici
    if devices is not None and len(devices) != n:
        raise ValueError(
            f"hybrid mesh {dcn}x{ici} needs {n} devices, got {len(devices)}")
    base = make_mesh(n, devices=devices)
    per = len(base.devices)
    if per % ici and ici % per:
        raise ValueError(
            f"a {dcn}x{ici} mesh over ranks of {per} shards each: a rank "
            "must hold whole ICI groups or an equal share of one")
    lo, hi = base.lo, base.lo + per
    distributed = base.group is not None
    ici_views, dcn_views, groups = [], [], []
    for views, axis, members, size, first in (
            (ici_views, ICI_AXIS, lambda g: [g * ici + i for i in range(ici)],
             ici, lambda g, ids: ids[0] - g * ici),
            (dcn_views, DCN_AXIS, lambda i: [g * ici + i for g in range(dcn)],
             dcn, lambda i, ids: (ids[0] - i) // ici)):
        for k in range(n // size):
            ids = members(k)
            group = None
            if distributed:
                ranks = sorted({s // per for s in ids})
                if len(ranks) > 1:
                    group = dist.new_group(ranks)
                    groups.append((group, ranks))
            mine = [s for s in ids if lo <= s < hi]
            if not mine:
                continue
            pos = tuple(s - lo for s in mine)
            views.append((Mesh(devices=tuple(base.devices[p] for p in pos),
                               axis_name=axis, nshards=size,
                               lo=first(k, mine), group=group), pos))
    # Form each group's communicator now, in creation order on its
    # members (the groups are disjoint, then the columns are), so that a
    # card that cannot join fails here and not inside a sweep.
    for group, ranks in groups:
        if dist.get_rank() in ranks:
            dist.all_reduce(torch.zeros(1, device=base.devices[0]),  # graftlint: disable=R004 — a sub-group's collective, issued by its members only (the rank test IS the membership test); every rank made every group above, in one order
                            group=group)
    return dataclasses.replace(base, hybrid=(dcn, ici),
                               ici_views=tuple(ici_views),
                               dcn_views=tuple(dcn_views))


def hybrid_shape(mesh: Mesh) -> tuple:
    """(dcn, ici) of a hybrid mesh; (1, mesh.size) of a flat one."""
    return tuple(mesh.hybrid) if mesh.hybrid else (1, mesh.size)


def shard_outer(mesh: Mesh, arr: np.ndarray, ici: int) -> list:
    """Rows of an array indexed by DCN group, placed on the shards: each
    local shard s gets row ``s // ici`` (its group's; ``ici`` 1: row s)
    as a tensor on its device.  The layout of the grouped exchange plan,
    whose rows every member of a group reads alike."""
    return [torch.from_numpy(np.ascontiguousarray(arr[s // ici])).to(d)
            for s, d in zip(mesh.shard_ids, mesh.devices)]
