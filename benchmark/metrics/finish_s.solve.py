"""Host seconds a solve in the system's 'finish' stage (its Tracer span):
the end of a solve after its last phase, the final Q and label gather
or the final renumber."""

from benchmark.harness.readers import stage_per_unit


def read(run):
    return stage_per_unit(run, "solve", "finish")
