"""Multi-process runs over ``torch.distributed``: one rank per card (port
of ``cuvite_tpu/comm/multihost.py``).

The reference connects one process per host with
``jax.distributed.initialize``, after which one SPMD program spans every
host's chips.  Here every rank is one process that drives the shards of
its own card: :func:`initialize` joins the process group (NCCL when the
run is on the card, gloo when the caller asks for the CPU), and
``comm.mesh.make_mesh`` then gives this rank its contiguous range of the
vertex shards.  The sweeps' collectives go over that group
(``comm/collectives.py``); the small host-side collectives below go over
a gloo group beside it, so that they never touch the card.

Launch, every rank running the same command::

    torchrun --nproc-per-node 4 -m cuvite_tpu_torch.cli --rmat 20 \\
        --shards 4 --distributed

or without torchrun, one command per rank::

    CUVITE_COORDINATOR=host0:29500 CUVITE_NUM_PROCESSES=4 \\
    CUVITE_PROCESS_ID=<0..3> LOCAL_RANK=<card> \\
    python -m cuvite_tpu_torch.cli --rmat 20 --shards 4 --distributed

A coordinator given as ``HOST:PORT`` becomes ``tcp://HOST:PORT``; a
``file://`` or ``tcp://`` URL is taken as it is (the CPU tests use a
``file://`` store in a temporary directory, so they need no port).
:func:`launch` starts such a world of local processes.

Design, as in the reference (its module note): host planning is
replicated.  Every rank computes the same partition, plans and coarse
graph from the same data; device state is what is sharded.  The labels
come back to every rank at each phase end (:func:`gather_global`).  With
per-rank ingest (``io/dist_ingest.py``) a rank reads only its shards'
edge ranges and the ghost lists are exchanged (:func:`allgather_varlen`).

There is no fallback: a run asked to be distributed raises when the
group cannot be formed, and :func:`fail_together` makes a rank that
raises destroy the group and exit non-zero, so that its peers' pending
collectives fail instead of waiting.

Not ported: ``place`` and ``place_block`` (JAX placement of global
arrays; here a rank simply places its own shards).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0

# The process group is process-wide state in torch.distributed itself;
# this records what initialize() chose beside it.
_STATE: dict = {}


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _init_method(coordinator: str | None) -> str:
    if coordinator is None:
        if not (os.environ.get("MASTER_ADDR")
                and os.environ.get("MASTER_PORT")):
            raise RuntimeError(
                "no coordinator: pass --coordinator HOST:PORT, set "
                "CUVITE_COORDINATOR, or launch under torchrun "
                "(MASTER_ADDR/MASTER_PORT)")
        return "env://"
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None,
               timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to a multi-process run (the reference's
    ``initialize``, MPI_Init's counterpart).

    Arguments fall back to ``CUVITE_COORDINATOR`` /
    ``CUVITE_NUM_PROCESSES`` / ``CUVITE_PROCESS_ID``, then to torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``.  The card is
    ``cuda:LOCAL_RANK`` (default: the rank modulo the visible cards),
    made current before the group forms; ``device="cpu"`` runs the ranks
    on the CPU under gloo.  ``timeout`` bounds every collective.  A
    second call in one process is a no-op."""
    if is_distributed():
        return
    coordinator = coordinator or os.environ.get("CUVITE_COORDINATOR")
    world = num_processes
    for name in ("CUVITE_NUM_PROCESSES", "WORLD_SIZE"):
        if world is None:
            world = _env_int(name)
    proc = process_id
    for name in ("CUVITE_PROCESS_ID", "RANK"):
        if proc is None:
            proc = _env_int(name)
    if world is None or proc is None:
        raise RuntimeError(
            "distributed run without a world size or rank: pass "
            "--num-processes/--process-id, set CUVITE_NUM_PROCESSES/"
            "CUVITE_PROCESS_ID, or launch under torchrun")
    if not 0 <= proc < world:
        raise ValueError(f"process id {proc} outside a world of {world}")
    init = _init_method(coordinator)
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        kind, dev = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "distributed run on the card, but no CUDA device is "
                "visible; pass --device cpu to run the ranks under gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL backend")
        if device is not None and torch.device(device).index is not None:
            dev = torch.device(device)
        else:
            local = _env_int("LOCAL_RANK")
            if local is None:
                local = proc % torch.cuda.device_count()
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        kind = "nccl"
    dist.init_process_group(
        kind, init_method=init, world_size=world, rank=proc,
        timeout=datetime.timedelta(seconds=float(timeout)))
    host = dist.group.WORLD if cpu else dist.new_group(backend="gloo")
    _STATE.update(device=dev, host_group=host)
    # No rank leaves before every rank's group is formed: a rank that
    # went on, failed and tore its side down while a peer still
    # connected would fail the peer inside init_process_group, outside
    # fail_together.
    dist.barrier(group=host)
    if not cpu:
        where = [None] * world
        dist.all_gather_object(where, (socket.gethostname(), dev.index),
                               group=host)
        if len(set(where)) != world:
            shutdown()
            raise ValueError(
                f"two ranks on one card ({where}): NCCL refuses duplicate "
                "GPUs in one communicator; give each rank its own "
                "LOCAL_RANK")
        # NCCL forms its communicator at the first collective, and the
        # peer-to-peer links of an all_to_all at the first one: make both
        # here, at set-up, so that a card that cannot join fails now and
        # the seconds they take are not charged to the first sweep.
        dist.all_reduce(torch.zeros(1, device=dev))
        dist.all_to_all_single(torch.empty(world, device=dev),
                               torch.zeros(world, device=dev))
        torch.cuda.synchronize(dev)


def is_distributed() -> bool:
    """Whether this process is a rank of an initialized group (a world of
    one included: its sweeps still go over the group)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def local_device() -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK``, or the CPU under gloo."""
    if not is_distributed():
        raise RuntimeError("local_device: torch.distributed is not "
                           "initialized (multihost.initialize)")
    return _STATE["device"]


def local_shard_range(nshards: int) -> tuple[int, int]:
    """This rank's contiguous ``[lo, hi)`` of ``nshards`` vertex shards
    (ranks own consecutive ranges in rank order)."""
    w, p = world_size(), rank()
    per, rem = nshards // w, nshards % w
    lo = p * per + min(p, rem)
    return lo, lo + per + (1 if p < rem else 0)


def shutdown() -> None:
    """Destroy the process group (every group of this process).  Drop the
    meshes first (``comm.mesh.Mesh`` holds its group): a gloo group object
    still referenced when the interpreter exits is destroyed during its
    finalization, which aborts the process ("terminate called without an
    active exception", status -6) after its work is done."""
    if is_distributed():
        dist.destroy_process_group()
    _STATE.clear()


@contextlib.contextmanager
def fail_together():
    """Run a rank's work; when it raises, print the traceback, destroy the
    group and end the process with status 1, so that the peers' pending
    collectives fail at once instead of waiting for the timeout.  Outside
    a distributed run the exception propagates unchanged."""
    try:
        yield
    except BaseException as exc:
        if not is_distributed() or (isinstance(exc, SystemExit)
                                    and exc.code in (0, None)):
            raise
        print(f"rank {rank()} failed; ending the group", file=sys.stderr)
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        try:
            shutdown()
        finally:
            os._exit(1)


def _host_group():
    return _STATE["host_group"]


def _gather_rows(t: torch.Tensor, group) -> list:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def barrier() -> None:
    """Wait until every rank has reached this call (over the host group);
    nothing outside a distributed run."""
    if is_distributed():
        dist.barrier(group=_host_group())


def allreduce_sum_host(x):
    """Sum a small host value (scalar or array) across the ranks, in rank
    order."""
    if not is_distributed():
        return x
    parts = _gather_rows(torch.from_numpy(np.atleast_1d(np.asarray(x))),
                         _host_group())
    total = parts[0].numpy().copy()
    for p in parts[1:]:
        total = total + p.numpy()
    return total if np.ndim(x) else total.reshape(()).item()


def allreduce_max_host(x) -> np.ndarray:
    """Element-wise max of a small host array across the ranks."""
    if not is_distributed():
        return np.asarray(x)
    parts = _gather_rows(torch.from_numpy(np.atleast_1d(np.asarray(x))),
                         _host_group())
    return np.max(np.stack([p.numpy() for p in parts]), axis=0).reshape(
        np.shape(x))


def allgather_varlen(arr) -> list:
    """All-gather one variable-length 1-D host array per rank; returns
    every rank's array in rank order (the reference's size exchange and
    id lists of exchangeVertexReqs).  Every rank passes the same dtype."""
    arr = np.ascontiguousarray(arr)
    if not is_distributed():
        return [arr]
    g = _host_group()
    lens = _gather_rows(torch.tensor([len(arr)], dtype=torch.int64), g)
    lens = [int(n) for n in torch.cat(lens)]
    buf = np.zeros(max(max(lens), 1), dtype=arr.dtype)
    buf[: len(arr)] = arr
    rows = _gather_rows(torch.from_numpy(buf), g)
    return [r.numpy()[:n] for r, n in zip(rows, lens)]  # graftlint: disable=R018 — allgather_varlen IS a sanctioned host gather (the distributed coloring's per-round host exchange); callers opt in per site


def gather_global(local) -> np.ndarray:
    """Every rank's shards of a vertex vector, concatenated in shard order
    as one host array on EVERY rank (the reference's ``gather_global``,
    the ``MPI_Allgatherv`` of the output path).  ``local`` is this rank's
    list of per-shard tensors, or one host array."""
    if isinstance(local, (list, tuple)):
        local = torch.cat([t.cpu() for t in local])  # graftlint: disable=R018 — gather_global IS the sanctioned host gather; phase-transition callers opt in per site
    else:
        local = torch.from_numpy(np.ascontiguousarray(local))
    if not is_distributed():
        return local.numpy()  # graftlint: disable=R018 — gather_global IS the sanctioned host gather; phase-transition callers opt in per site
    return torch.cat(_gather_rows(local, _host_group())).numpy()  # graftlint: disable=R018 — gather_global IS the sanctioned host gather; phase-transition callers opt in per site


def launch(argv: list, nprocs: int, init_method: str, *, env=None,
           timeout: float = 120.0, grace: float = 30.0,
           cwd=None) -> list:
    """Run ``argv`` as ``nprocs`` local ranks of one world (a stand-in for
    torchrun that needs no port: ``init_method`` may be a ``file://``
    store).  Rank r gets ``CUVITE_COORDINATOR``, ``CUVITE_NUM_PROCESSES``,
    ``CUVITE_PROCESS_ID=r`` and ``LOCAL_RANK=r``.  Once a rank has failed,
    the others get ``grace`` seconds to end on their own before they are
    killed; every rank is killed at ``timeout``.  Returns one
    ``(returncode, stdout, stderr)`` per rank; a killed rank's code is
    negative."""
    procs, files = [], []
    for r in range(nprocs):
        e = dict(os.environ if env is None else env)
        e.update(CUVITE_COORDINATOR=init_method,
                 CUVITE_NUM_PROCESSES=str(nprocs),
                 CUVITE_PROCESS_ID=str(r), LOCAL_RANK=str(r))
        # Files, not pipes: a rank that prints much never blocks on them.
        files.append((tempfile.TemporaryFile("w+"),
                      tempfile.TemporaryFile("w+")))
        procs.append(subprocess.Popen(argv, env=e, cwd=cwd,
                                      stdout=files[-1][0],
                                      stderr=files[-1][1], text=True))
    codes = [None] * nprocs
    deadline = time.monotonic() + timeout
    failed_at = None
    try:
        while any(c is None for c in codes):
            for r, p in enumerate(procs):
                if codes[r] is None and p.poll() is not None:
                    codes[r] = p.returncode
                    if p.returncode and failed_at is None:
                        failed_at = time.monotonic()
            now = time.monotonic()
            if now > deadline or (failed_at is not None
                                  and now > failed_at + grace):
                break
            time.sleep(0.05)
    finally:
        for r, p in enumerate(procs):
            if codes[r] is None:
                p.kill()
                codes[r] = p.wait()
    outs = []
    for code, (fo, fe) in zip(codes, files):
        with fo, fe:
            fo.seek(0)
            fe.seek(0)
            outs.append((code, fo.read(), fe.read()))
    return outs
