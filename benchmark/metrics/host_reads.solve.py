"""The system's 'host_read' spans a solve: its blocking reads of the
card, counted."""


def read(run):
    if run.cell.traffic["loop"] != "solve" or run.tracer is None:
        return None
    n = sum(1 for s in run.tracer.spans if s.name == "host_read")
    return n / run.window.units if n else None
