"""Host seconds a batch in the system's 'iterate' stage of
``louvain_many`` (its Tracer span)."""

from benchmark.harness.readers import stage_per_unit


def read(run):
    return stage_per_unit(run, "batch", "iterate")
