"""The readers of the system's fine stages (``finish``, ``renumber``,
``host_read``, ``sweep`` and the batched ``coarsen``), fed hand-built
runs: each reads its number from the tracer's spans of its own loop, and
nothing from the other loop or from an untraced run."""

import pytest

from benchmark.harness import cells, main, spec
from benchmark.harness.tracer import BenchTracer, Span

SOLVE, BATCH = "graph500-s20.default", "lfr-n5000-b64.closed"
UNITS = 2
# (unit, stage, seconds) of a window of two units.
SPANS = [(0, "iterate", 1.0), (0, "sweep", 0.25), (0, "host_read", 0.125),
         (0, "sweep", 0.25), (0, "host_read", 0.0625),
         (0, "renumber", 0.5), (0, "coarsen", 0.75), (0, "finish", 0.375),
         (1, "sweep", 0.25), (1, "host_read", 0.0625),
         (1, "coarsen", 0.25), (1, "finish", 0.125)]


def _run(cell_name: str, traced: bool = True) -> main.Run:
    cell = spec.find_cell(cell_name)
    tracer = None
    if traced:
        tracer = BenchTracer(batch=cell.traffic["loop"] == "batch")
        t = 0.0
        for unit, name, secs in SPANS:
            tracer.spans.append(Span(unit, name, t, t + secs))
            t += secs
    window = cells.Window(seconds=10.0, units=UNITS, jobs=UNITS,
                          answers=[], unit_seconds=[5.0] * UNITS,
                          pack_s=[], least_bytes=0, phase0_sweeps=[1, 1])
    return main.Run(cell=cell, kind="cpu", setup_s=1.0, window=window,
                    peak_window_bytes=0, tracer=tracer, trace=None)


# metric: (its loop's cell, the value of SPANS a unit)
EXPECTED = {
    "finish_s.solve": (SOLVE, (0.375 + 0.125) / UNITS),
    "renumber_s.solve": (SOLVE, 0.5 / UNITS),
    "host_read_ms.solve": (SOLVE, 1000 * (0.125 + 0.0625 * 2) / UNITS),
    "host_reads.solve": (SOLVE, 3 / UNITS),
    "coarsen_s.batch": (BATCH, (0.75 + 0.25) / UNITS),
    "sweeps.batch": (BATCH, 3 / UNITS),
    "host_read_ms.batch": (BATCH, 1000 * (0.125 + 0.0625 * 2) / UNITS),
    "host_reads.batch": (BATCH, 3 / UNITS),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_its_loop_only(name):
    read = spec.metric_reader(name)
    cell, value = EXPECTED[name]
    other = BATCH if cell == SOLVE else SOLVE
    assert read(_run(cell)) == pytest.approx(value, rel=1e-12)
    assert read(_run(other)) is None
    assert read(_run(cell, traced=False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_where_the_stage_never_ran(name):
    """A program without the fine stages (an older one) gives spans of
    its other stages only: the reader returns None, and does not raise."""
    cell, _ = EXPECTED[name]
    run = _run(cell)
    run.tracer.spans = [s for s in run.tracer.spans if s.name == "iterate"]
    assert spec.metric_reader(name)(run) is None


def test_every_new_metric_is_declared_for_the_cells_that_read_it():
    bench = spec.load_benchmark()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name, (cell, _) in EXPECTED.items():
        m = by_name[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert cell in m["workloads"]
        loop = spec.find_cell(cell).traffic["loop"]
        assert all(spec.find_cell(w).traffic["loop"] == loop
                   for w in m["workloads"])
