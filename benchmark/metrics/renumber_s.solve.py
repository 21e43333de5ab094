"""Host seconds a solve in the system's 'renumber' stage (its Tracer
span): each gained phase's label renumber and composition."""

from benchmark.harness.readers import stage_per_unit


def read(run):
    return stage_per_unit(run, "solve", "renumber")
