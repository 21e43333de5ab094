"""Jobs a second: every job completed in the window over the window."""

from benchmark.harness import stats
from benchmark.harness.readers import loop_of


def read(run):
    if loop_of(run) != "batch":
        return None
    return stats.whole_window_rate(run.window.jobs, run.window.seconds)
