"""Host seconds a batch of the pack, plan build and upload
(``BatchResult.pack_s``), in the traced window."""


def read(run):
    if run.cell.traffic["loop"] != "batch" or run.tracer is None:
        return None
    return sum(run.window.pack_s) / len(run.window.pack_s)
