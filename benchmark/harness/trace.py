"""The device trace of a traced run, reduced to what the metrics read.

``torch.profiler`` records the card's kernels, copies and sets, the host's
CUDA API calls (each with the correlation id of the device operation it
launched) and the benchmark's ``record_function`` ranges, all on one
clock.  The trace is written as Chrome JSON to a temporary file and read
back here:

- busy: the union of the device intervals inside the ``bench/window``
  range;
- phase-0 device time: the kernels launched inside a range whose label
  ends in ``phase0`` (``tracer.py``);
- the breakdown: device time by kernel name, and idle time by the host
  stage that was open, the innermost ``bench/`` range.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

from benchmark.harness.stats import busy_within, merge
from benchmark.harness.tracer import PHASE0, PREFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# Host labels of the ranges that are not system stages.
OUTER = {"window": "harness", "solve": "driver", "batch": "driver"}


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    phase0_kernel_s: float
    device_ops: list          # [[name, seconds]], most first, <= 10
    idle_gaps: list           # [[host stage, seconds]], most first, <= 10
    kernels: int
    unattributed: int         # kernels whose launch was not in the trace


def profile(enabled: bool):
    """A profiler over the card's activity and the host's ranges, or None."""
    if not enabled:
        return None
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def export_events(prof) -> list:
    """The profiler's events as Chrome trace records (via a temporary
    file in TMPDIR, removed at once)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def _label(name: str) -> str:
    label = name[len(PREFIX):]
    if label.endswith(PHASE0):
        label = label[:-len(PHASE0)].rstrip(".")
    return OUTER.get(label, label)


def _segments(ranges, lo: float, hi: float) -> list:
    """[(start, end, label)]: [lo, hi] cut where the innermost open range
    changes; ``ranges`` are properly nested (start, end, label)."""
    points = sorted({lo, hi, *[t for s, e, _ in ranges for t in (s, e)
                               if lo < t < hi]})
    by_start = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, k = [], [], 0
    for a, b in zip(points, points[1:]):
        while k < len(by_start) and by_start[k][0] <= a:
            stack.append(by_start[k])
            k += 1
        while stack and stack[-1][1] <= a:
            stack.pop()
        # An outer range may end before an inner one is popped only if
        # the ranges overlap without nesting; take the innermost live one.
        live = [r for r in stack if r[1] > a]
        out.append((a, b, live[-1][2] if live else "harness"))
    return out


def reduce_events(events) -> TraceSummary:
    """Reduce Chrome trace records (times in microseconds)."""
    device, kernels, launches, ranges = [], [], {}, []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((ts, dur, name, args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = ts
        elif cat == "user_annotation" and name.startswith(PREFIX):
            if name == PREFIX + "window":
                window = (ts, ts + dur)
            ranges.append((ts, ts + dur, name))
    if window is None:
        raise ValueError("the trace holds no bench/window range")
    lo, hi = window
    phase0 = sorted((s, e) for s, e, n in ranges if n.endswith(PHASE0))
    starts = [s for s, _ in phase0]
    by_name: dict = {}
    p0_us, unattributed = 0.0, 0
    for ts, dur, name, corr in kernels:
        if lo <= ts <= hi:
            by_name[name] = by_name.get(name, 0.0) + dur
        launch = launches.get(corr)
        if launch is None:
            unattributed += 1
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= phase0[i][1]:
            p0_us += dur
    busy = merge(device)
    idle: dict = {}
    segs = _segments([(s, e, _label(n)) for s, e, n in ranges], lo, hi)
    j = 0
    gap_lo = lo
    for s, e in busy + [[hi, hi]]:
        gap_hi = min(max(s, lo), hi)
        if gap_hi > gap_lo:
            # Split the idle gap [gap_lo, gap_hi] over the host segments.
            while j < len(segs) and segs[j][1] <= gap_lo:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < gap_hi:
                a, b = max(segs[k][0], gap_lo), min(segs[k][1], gap_hi)
                if b > a:
                    idle[segs[k][2]] = idle.get(segs[k][2], 0.0) + b - a
                k += 1
        gap_lo = max(gap_lo, min(e, hi))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=(hi - lo) * 1e-6,
        busy_s=busy_within(busy, lo, hi) * 1e-6,
        phase0_kernel_s=p0_us * 1e-6,
        device_ops=[[n[:200], v * 1e-6] for n, v in top],
        idle_gaps=[[n, v * 1e-6] for n, v in gaps],
        kernels=len(kernels), unattributed=unattributed)
