"""Host seconds a batch in the system's 'coarsen' stage of
``louvain_many`` (its Tracer span): each phase's batched coarsening and
the one-notch shrink, inside the batch's 'iterate' stage."""

from benchmark.harness.readers import stage_per_unit


def read(run):
    return stage_per_unit(run, "batch", "coarsen")
