"""Share of the traced window in which the card runs no kernel, copy
or set."""

from benchmark.harness.readers import device_idle


def read(run):
    return device_idle(run, "solve")
