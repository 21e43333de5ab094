"""Shared arithmetic of the metric readers in ``benchmark/metrics/``.

Each reader takes a ``main.Run`` and returns a number, or None where the
run holds nothing for it to read (another kind of cell, an untraced run,
a stage that never ran)."""

from __future__ import annotations

from benchmark.harness import stats


def loop_of(run) -> str:
    return run.cell.traffic["loop"]


def stage_per_unit(run, loop: str, stage: str):
    """Mean host seconds of the system's stage ``stage`` a solve or a
    batch of the traced window."""
    if loop_of(run) != loop or run.tracer is None:
        return None
    return run.tracer.seconds_per_unit(stage, run.window.units)


def sweep_roofline(run, loop: str):
    """Phase 0's least bytes over the device time of the kernels launched
    in phase 0's span, against the card's published bandwidth."""
    peaks = stats.peak_of(run.kind)
    if (loop_of(run) != loop or run.trace is None or peaks is None
            or run.trace.phase0_kernel_s <= 0 or run.window.least_bytes <= 0):
        return None
    return stats.roofline_pct(run.window.least_bytes,
                              run.trace.phase0_kernel_s,
                              peaks["hbm_bytes_per_s"])


def device_idle(run, loop: str):
    if loop_of(run) != loop or run.trace is None \
            or run.trace.window_s <= 0:
        return None
    return stats.idle_pct(run.trace.busy_s, run.trace.window_s)
