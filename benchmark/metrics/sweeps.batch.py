"""The system's 'sweep' spans a batch: the rounds of sweeps over the
batch's blocks in ``louvain_many``, counted."""


def read(run):
    if run.cell.traffic["loop"] != "batch" or run.tracer is None:
        return None
    n = sum(1 for s in run.tracer.spans if s.name == "sweep")
    return n / run.window.units if n else None
