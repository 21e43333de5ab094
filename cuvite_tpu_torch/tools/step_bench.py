"""One bucketed sweep timed on a phase-0 R-MAT slab (port of the
reference's ``tools/step_bench.py``).

The sweep runs through the driver's own ``PhaseRunner`` (no second
upload recipe): ``PhaseRunner(DistGraph.build(g, 1), device,
engine="bucketed")`` and its ``step(comm)``.  Reported, each ended by a
real read-back of a value to the host:

- the plan and upload seconds;
- the first call's seconds (the kernels' build and load);
- the scalar round trip (min of 5), so that device time can be read off
  the difference;
- the minimum of 5 step-plus-fetch times, the sweeps chained, and the
  device time of the same sweeps read by CUDA events (on the card);
- M edges/s.

    python -m cuvite_tpu_torch.tools.step_bench          # scale 18, card
    AB_SCALE=20 python -m cuvite_tpu_torch.tools.step_bench
    AB_SCALE=10 python -m cuvite_tpu_torch.tools.step_bench --device cpu

The last line is one JSON object with every figure and the kernels'
launch counts over the 5 timed sweeps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from cuvite_tpu_torch.kernels import launch_counts
from cuvite_tpu_torch.tools import device_or_exit, sync


def build_runner(scale: int, dev):
    """(graph, PhaseRunner, plan+upload seconds) of R-MAT ``scale``'s
    phase 0 on ``dev``, the upload ended by a read-back."""
    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.louvain.driver import PhaseRunner

    g = generate_rmat(scale, edge_factor=16, seed=1)
    t0 = time.perf_counter()
    runner = PhaseRunner(DistGraph.build(g, 1), dev, engine="bucketed")
    _ = runner.comm0[0:1].cpu()
    return g, runner, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.tools.step_bench",
        description="one bucketed sweep on a phase-0 R-MAT slab "
                    "(AB_SCALE, default 18)")
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default (no card: exit 2); "
                         "'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)
    cuda = dev.type == "cuda"
    scale = int(os.environ.get("AB_SCALE", "18"))
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    print(f"# backend={dev.type} ({name}) scale={scale}", flush=True)
    g, runner, plan_s = build_runner(scale, dev)
    print(f"# plan+upload {plan_s:.2f}s", flush=True)

    t0 = time.perf_counter()
    out = runner.step(runner.comm0)
    _ = float(out.modularity[0])
    first_s = time.perf_counter() - t0
    print(f"# first call (kernel load) {first_s:.1f}s", flush=True)

    # Round-trip baseline: warm the exact timed expression first, then
    # the min of 5 like the step timing.
    x = torch.zeros((), device=dev)
    _ = float(x + 1.0)
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        _ = float(x + 1.0)
        rtts.append(time.perf_counter() - t0)
    rtt = min(rtts)
    print(f"# scalar round-trip {rtt*1e3:.1f} ms", flush=True)

    from cuvite_tpu_torch.kernels import zero_launch_counts

    c = runner.comm0
    times, device_ms = [], []
    sync(dev)
    zero_launch_counts()
    for _ in range(5):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        res = runner.step(c)
        if cuda:
            end.record()
        _ = float(res.modularity[0])
        times.append(time.perf_counter() - t0)
        if cuda:
            device_ms.append(start.elapsed_time(end))
        c = res.target
    counts = launch_counts()
    best = min(times)
    dev_ms = min(device_ms) if device_ms else None
    rate = g.num_edges / max(best - rtt, 1e-9) / 1e6
    print(f"step+fetch {best*1e3:.1f} ms  (~device {max(best-rtt, 0)*1e3:.1f} "
          f"ms, {rate:.1f} M edges/s)"
          + (f"; CUDA events {dev_ms:.4f} ms a sweep "
             f"({g.num_edges / (dev_ms / 1e3) / 1e6:.1f} M edges/s)"
             if dev_ms is not None else ""))
    print(json.dumps({
        "scale": scale, "nv": g.num_vertices, "ne": g.num_edges,
        "device": name, "plan_upload_s": plan_s,
        "first_call_s": first_s, "rtt_ms": rtt * 1e3,
        "step_fetch_ms": best * 1e3,
        "device_ms": dev_ms, "medges_per_s": rate,
        "launches": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
