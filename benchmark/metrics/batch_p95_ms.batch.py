"""95th percentile, over every batch of the traced window, of the time
from a batch's submission to its labels on the host, in milliseconds:
every job of a batch waits that long."""

from benchmark.harness import stats
from benchmark.harness.readers import loop_of


def read(run):
    if loop_of(run) != "batch":
        return None
    return 1000.0 * stats.p95(run.window.unit_seconds)
