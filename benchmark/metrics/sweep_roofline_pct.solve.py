"""Phase 0's share of the bandwidth roofline, over the traced window."""

from benchmark.harness.readers import sweep_roofline


def read(run):
    return sweep_roofline(run, "solve")
