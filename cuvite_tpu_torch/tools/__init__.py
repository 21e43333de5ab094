"""Drivers that run the system and measure it (port of the reference's
``tools/`` scripts that drive ``cuvite_tpu``).

Each module is a command, ``python -m cuvite_tpu_torch.tools.<name>``,
with a ``main(argv=None) -> int`` that tests call in-process:

- ``serve_load``: the serving load tool, verbs ``sweep`` (the highest
  rate that meets the SLO), ``ab`` (admission on and off at twice that),
  ``pipeab`` (pipelined against serial dispatch), ``mix`` (the 90:10
  skewed mix, merge packing off and on) and ``daemon`` (a spawned serve
  daemon driven over its socket at a fixed rate, then SIGTERM);
- ``exchange_latency``: the all_gather / psum / all_to_all ladder over
  the port's collectives, and the replicated-against-sparse crossover
  bracket of the exchange cutover;
- ``exchange_bench``: sparse against replicated ``louvain_phases`` on a
  mesh, one child process a configuration;
- ``step_bench``: one bucketed sweep of a phase-0 R-MAT slab timed;
- ``trace_step``: three chained sweeps under ``torch.profiler``, the top
  device kernels by self time;
- ``weighted_ingest_bench``: a weighted R-MAT edge list to CSR, the
  builder the dispatch chose and the memory high-water mark.

Every command runs on the CUDA card unless ``--device cpu`` is given and
exits 2 without a card (no silent CPU fallback); it writes files only
where an ``--out``, ``--out-prefix`` or ``--log`` argument says.  Every
blocking child process carries a timeout.  Not ported: the reference's
TPU-only and audit tools, and its JAX set-up (``--host-devices``,
``XLA_FLAGS``, the compile cache).
"""

from __future__ import annotations

import os
import sys

import torch


def device_or_exit(device=None) -> torch.device:
    """The device a command runs on: the card by default, the CPU only
    when asked.  Without a card (and no ``--device cpu``) the command
    ends with status 2 and says why."""
    from cuvite_tpu_torch.core.device import resolve_device

    try:
        dev = resolve_device(device)
    except RuntimeError as err:
        print(f"# device error: {err}", file=sys.stderr)
        raise SystemExit(2) from None
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"# device error: --device {device} but no CUDA device is "
              "available; pass --device cpu", file=sys.stderr)
        raise SystemExit(2)
    return dev


def shard_devices(device, n: int) -> tuple:
    """(device of each of ``n`` shards, what carries a collective's bytes
    between them): every shard on ``device`` when one is given, else one
    shard a card while there are cards enough, else all on card 0."""
    if device is not None:
        dev = device_or_exit(device)
        where = ("the CPU's memory" if dev.type == "cpu" else
                 f"device copies on one card "
                 f"({torch.cuda.get_device_name(dev)}): no link is crossed")
        return [dev] * n, where
    device_or_exit(None)
    cards = torch.cuda.device_count()
    if cards >= n:
        names = sorted({torch.cuda.get_device_name(i) for i in range(n)})
        return ([torch.device("cuda", i) for i in range(n)],
                f"peer copies between {n} cards ({', '.join(names)}) "
                "driven from one process")
    return ([torch.device("cuda", 0)] * n,
            f"device copies on one card ({torch.cuda.get_device_name(0)}; "
            f"{cards} visible for {n} shards): no link is crossed")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def package_root() -> str:
    """The directory that holds the ``cuvite_tpu_torch`` package: the
    working directory and import path of the commands' child
    processes."""
    import cuvite_tpu_torch

    return os.path.dirname(os.path.dirname(
        os.path.abspath(cuvite_tpu_torch.__file__)))


def child_env(**extra) -> dict:
    """This process's environment with the package on ``PYTHONPATH``,
    plus ``extra``."""
    env = dict(os.environ, **extra)
    root = package_root()
    path = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = root if not path else f"{root}{os.pathsep}{path}"
    return env
