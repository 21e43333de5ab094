"""Milliseconds a batch in the system's 'host_read' stages (its Tracer
spans): the blocking reads of the card."""

from benchmark.harness.readers import stage_per_unit


def read(run):
    s = stage_per_unit(run, "batch", "host_read")
    return None if s is None else 1000.0 * s
