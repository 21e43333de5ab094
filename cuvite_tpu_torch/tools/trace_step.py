"""A profiler trace of the bucketed sweep and its top device kernels (port
of the reference's ``tools/trace_step.py``, ``torch.profiler`` in place
of xprof).

Runs 3 chained sweeps through the driver's ``PhaseRunner`` (phase 0 of
R-MAT ``AB_SCALE``, default 18) under ``torch.profiler`` with the CPU
and, on the card, the CUDA activities; prints the total device self time
and the top 20 device kernels by self time.  On the CPU there are no
device rows, and the top CPU ops (the kernels' plain versions) are
printed instead.  The Chrome trace goes to ``TRACE_DIR`` (default: a
new temporary directory).

    python -m cuvite_tpu_torch.tools.trace_step
    AB_SCALE=20 TRACE_DIR=build/trace python -m \\
        cuvite_tpu_torch.tools.trace_step
    AB_SCALE=10 python -m cuvite_tpu_torch.tools.trace_step --device cpu

The last line is one JSON object: the device self time, the top rows and
the kernels' launch counts over the 3 traced sweeps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from cuvite_tpu_torch.kernels import launch_counts
from cuvite_tpu_torch.tools import device_or_exit, sync

TOP = 20
STEPS = 3


def top_rows(averages, device: bool) -> tuple:
    """(total self seconds, rows sorted by self time) of a profile's
    ``key_averages()``: the device kernels (events on the CUDA device)
    when ``device``, else the CPU ops."""
    from torch.autograd import DeviceType

    rows = []
    for evt in averages:
        if device and evt.device_type != DeviceType.CUDA:
            continue
        us = float(evt.self_device_time_total if device
                   else evt.self_cpu_time_total)
        if us > 0:
            rows.append({"name": evt.key, "self_ms": us / 1e3,
                         "count": int(evt.count)})
    rows.sort(key=lambda r: -r["self_ms"])
    return sum(r["self_ms"] for r in rows) / 1e3, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.tools.trace_step",
        description="torch.profiler trace of 3 bucketed sweeps "
                    "(AB_SCALE, TRACE_DIR)")
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default (no card: exit 2); "
                         "'cpu' traces the kernels' plain versions")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)
    cuda = dev.type == "cuda"
    from torch.profiler import ProfilerActivity, profile

    from cuvite_tpu_torch.kernels import zero_launch_counts
    from cuvite_tpu_torch.tools.step_bench import build_runner

    scale = int(os.environ.get("AB_SCALE", "18"))
    _g, runner, _ = build_runner(scale, dev)
    out = runner.step(runner.comm0)
    _ = float(out.modularity[0])   # warm: kernel build and load

    trace_dir = os.environ.get("TRACE_DIR") or tempfile.mkdtemp(
        prefix="cuvite_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    sync(dev)
    zero_launch_counts()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        c = runner.comm0
        for _ in range(STEPS):
            res = runner.step(c)
            c = res.target
        _ = float(res.modularity[0])
        sync(dev)
    counts = launch_counts()
    path = os.path.join(trace_dir, "trace_step.json")
    prof.export_chrome_trace(path)
    print(f"# traced {STEPS} steps in {time.perf_counter()-t0:.2f}s -> "
          f"{path}", flush=True)
    total, rows = top_rows(prof.key_averages(), cuda)
    where = "device" if cuda else "CPU (no device rows on the CPU)"
    print(f"# {where} self time over {STEPS} steps: {total:.3f}s")
    for r in rows[:TOP]:
        print(f"{r['self_ms']:9.3f} ms  {r['count']:6d}  {r['name'][:90]}")
    print(json.dumps({
        "scale": scale,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "steps": STEPS, "rows_on": "device" if cuda else "cpu",
        "self_s": total, "top": rows[:TOP], "trace": path,
        "launches": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
