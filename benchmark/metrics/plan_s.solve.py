"""Host seconds a solve in the system's 'plan' stage (its Tracer span)."""

from benchmark.harness.readers import stage_per_unit


def read(run):
    return stage_per_unit(run, "solve", "plan")
