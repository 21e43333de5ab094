"""Seconds a solve: the whole window over the solves completed in it."""

from benchmark.harness import stats
from benchmark.harness.readers import loop_of


def read(run):
    if loop_of(run) != "solve":
        return None
    return stats.whole_window_mean(run.window.seconds, run.window.units)
