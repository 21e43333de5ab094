"""Sparse-against-replicated exchange A/B on a vertex mesh (port of the
reference's ``tools/exchange_bench.py``).

``louvain_phases(g, nshards=S, exchange=...)`` on R-MAT graphs under
both exchanges, each configuration in a child process of its own (an
independent memory high-water mark, the sparse plan's whole point being
the footprint, and no state shared between the arms).  Each row carries
the wall of the timed run (after a warm-up run that builds and loads
the kernels), Q, the sweeps, the peak resident set (``VmHWM``), the
card's ``torch.cuda.max_memory_allocated`` and a digest of the labels;
then the sparse/replicated wall ratio a scale.  The sparse plan is a
memory play (O(owned + ghosts) a shard against O(nv_total)); this ratio
is what the exchange='auto' cutover (``AUTO_SPARSE_MIN_VERTICES``)
trades.

    python -m cuvite_tpu_torch.tools.exchange_bench          # scales 18 20
    AB_SCALES="18" AB_SHARDS=4 python -m cuvite_tpu_torch.tools.exchange_bench
    AB_SCALES=8 AB_SHARDS=2 python -m cuvite_tpu_torch.tools.exchange_bench \\
        --device cpu

Environment: ``AB_SCALES`` (default "18 20"), ``AB_SHARDS`` (default 8),
``AB_CHILD_TIMEOUT`` (seconds a child may run, default 7200; a malformed
value is reported and replaced by the default before any child starts),
``AB_EXCHANGE`` (set by the parent: run that one configuration).  The
shards sit one a card while there are cards enough, else all on card 0;
``--device`` puts them all on one device (``cpu`` runs on the CPU).
The last line is one JSON object of every row and ratio.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

from cuvite_tpu_torch.kernels import launch_counts
from cuvite_tpu_torch.tools import (
    child_env,
    package_root,
    shard_devices,
    sync,
)
from cuvite_tpu_torch.utils.trace import rss_high_water_mb

def labels_digest(communities) -> str:
    """A short digest of a labelling, equal across runs iff the labels
    are."""
    import numpy as np

    arr = np.ascontiguousarray(communities, dtype=np.int64)
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def run_one(scale: int, nsh: int, exchange: str, devs) -> dict:
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.kernels import zero_launch_counts

    g = generate_rmat(scale, edge_factor=16, seed=1)
    mesh = make_mesh(devices=devs)
    cuda = devs[0].type == "cuda"
    # The warm-up run takes the kernel builds and loads; the timed run is
    # steady state.
    louvain_phases(g, mesh=mesh, exchange=exchange)
    for d in set(devs):
        sync(d)
        if cuda:
            torch.cuda.reset_peak_memory_stats(d)
    zero_launch_counts()
    t0 = time.perf_counter()
    res = louvain_phases(g, mesh=mesh, exchange=exchange)
    for d in set(devs):
        sync(d)
    wall = time.perf_counter() - t0
    peak = (max(torch.cuda.max_memory_allocated(d) for d in set(devs))
            if cuda else None)
    row = {"scale": scale, "exchange": exchange, "shards": nsh,
           "wall_s": wall, "modularity": float(res.modularity),
           "iterations": int(res.total_iterations),
           "rss_hwm_mib": int(rss_high_water_mb()), "peak_alloc_bytes": peak,
           "labels": labels_digest(res.communities),
           "launches": launch_counts()}
    print(f"scale={scale} exchange={exchange:10s} wall={wall:8.1f}s "
          f"Q={res.modularity:.5f} iters={res.total_iterations} "
          f"rss_hwm={row['rss_hwm_mib']}MiB peak_alloc={peak}B "
          f"labels={row['labels']}", flush=True)
    print(json.dumps({"exchange_row": row}), flush=True)
    return row


def _child_timeout() -> float:
    """AB_CHILD_TIMEOUT, parsed once, up front: a malformed value is
    reported and replaced by the default before any child launches."""
    raw = os.environ.get("AB_CHILD_TIMEOUT")
    try:
        return float(raw or 7200)
    except ValueError:
        print(f"# ignoring malformed AB_CHILD_TIMEOUT={raw!r}; using "
              "7200s", flush=True)
        return 7200.0


def _tail(text) -> str:
    text = text or ""
    if isinstance(text, bytes):
        text = text.decode(errors="replace")
    return text[-400:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.tools.exchange_bench",
        description="sparse-vs-replicated exchange A/B "
                    "(AB_SCALES, AB_SHARDS, AB_CHILD_TIMEOUT)")
    ap.add_argument("--device", default=None,
                    help="put every shard on this device ('cpu' runs on "
                         "the CPU); default: the CUDA cards (no card: "
                         "exit 2)")
    args = ap.parse_args(argv)
    scales = [int(s) for s in os.environ.get("AB_SCALES", "18 20").split()]
    nsh = int(os.environ.get("AB_SHARDS", "8"))
    child_timeout = _child_timeout()
    devs, where = shard_devices(args.device, nsh)
    one = os.environ.get("AB_EXCHANGE")  # child mode: one configuration
    print(f"# backend={devs[0].type} devices={len(set(devs))} shards={nsh} "
          f"({where})", flush=True)
    if one:
        for scale in scales:
            run_one(scale, nsh, one, devs)
        return 0
    rows, ratios, failed = [], {}, False
    fwd = [] if args.device is None else ["--device", args.device]
    for scale in scales:
        walls = {}
        for exchange in ("replicated", "sparse"):
            env = child_env(AB_SCALES=str(scale), AB_EXCHANGE=exchange,
                            AB_SHARDS=str(nsh))
            try:
                out = subprocess.run(
                    [sys.executable, "-m",
                     "cuvite_tpu_torch.tools.exchange_bench", *fwd],
                    env=env, cwd=package_root(), capture_output=True,
                    text=True, timeout=child_timeout)
            except subprocess.TimeoutExpired as e:
                # A killed child must be LOUD, not a silently missing row.
                print(f"scale={scale} exchange={exchange}: TIMEOUT after "
                      f"{e.timeout:.0f}s (child killed) {_tail(e.stderr)}",
                      flush=True)
                failed = True
                continue
            if out.returncode != 0:
                # A child that crashes after printing its header must be
                # LOUD, not reduced to its last stdout line.
                print(f"scale={scale} exchange={exchange}: "
                      f"rc={out.returncode} {_tail(out.stderr)}",
                      flush=True)
                failed = True
                continue
            for line in out.stdout.splitlines():
                if line.startswith(f"scale={scale} "):
                    print(line, flush=True)
                elif line.startswith('{"exchange_row"'):
                    row = json.loads(line)["exchange_row"]
                    rows.append(row)
                    walls[exchange] = row["wall_s"]
        if "replicated" in walls and "sparse" in walls:
            ratios[str(scale)] = walls["sparse"] / walls["replicated"]
            print(f"scale={scale} sparse/replicated = "
                  f"{ratios[str(scale)]:.2f}x", flush=True)
    print(json.dumps({"rows": rows, "sparse_over_replicated": ratios}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
