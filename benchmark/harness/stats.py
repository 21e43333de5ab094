"""The window's arithmetic: rates, tails, idle shares and least bytes."""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, at the full 700 W.
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12}}

# The least bytes of one sweep: each directed edge's endpoint id and
# weight (4 B each), each vertex's community, weighted degree and
# community degree read once and its choice written once (4 B each).
EDGE_BYTES = 8
VERTEX_BYTES = 16


def peak_of(kind: str) -> dict | None:
    """The published peaks of the card named ``kind``, or None."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None


def whole_window_mean(total_s: float, count: int) -> float:
    """Seconds a unit: the whole window over the units completed in it."""
    return total_s / count


def whole_window_rate(count: int, total_s: float) -> float:
    """Units a second: those completed over the whole window."""
    return count / total_s


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("p95 of no values")
    return xs[max(math.ceil(0.95 * len(xs)) - 1, 0)]


def merge(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_within(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    total = 0.0
    for s, e in merge(intervals):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total += e - s
    return total


def idle_pct(busy: float, window: float) -> float:
    return 100.0 * (1.0 - busy / window)


def least_sweep_bytes(sweeps: int, nv: int, ne: int) -> int:
    """Bytes that ``sweeps`` sweeps of a graph of nv vertices and ne
    directed edges need at the least."""
    return sweeps * (EDGE_BYTES * ne + VERTEX_BYTES * nv)


def roofline_pct(least_bytes: float, device_s: float,
                 bytes_per_s: float) -> float:
    """Share of the bandwidth roofline: the least time the bytes need
    over the device time taken."""
    return 100.0 * (least_bytes / bytes_per_s) / device_s
