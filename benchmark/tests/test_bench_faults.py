"""The check must fail what is wrong.  At CPU size: the control (the plain
reference in the system's place with its sums in float32) comes out not
correct in every cell, and a run with the timed path broken underneath
comes out not correct: a sweep that returns its state unchanged, half of
a batch left out, an answer altered where it is produced.  (One chip, so
no exchange between chips to leave out.)  The same control runs on the
card at the cells' own size through ``benchmark/readings.py``."""

import io
import json
import time

import numpy as np
import pytest

import cuvite_tpu_torch
from benchmark import readings
from benchmark.harness import main
from benchmark.tests.conftest import CELLS, tiny
from cuvite_tpu_torch.louvain import batched, driver, fused


def _run(name):
    return main.run_cell(tiny(name), 2**31 + 3, 0.2, False, "cpu",
                         time.perf_counter(), log=io.StringIO())


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    out = io.StringIO()
    readings.run(tiny(name), [2**31 + 5], [2**31 + 5, 2**31 + 7], "cpu",
                 out=out)
    rows = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [r["correct"] for r in rows] == [True, False, False]
    limit = tiny(name).traffic["limits"]["q_gap"]
    assert all(r["numbers"]["q_gap"] > limit for r in rows[1:])


def _unchanged(loop_fn):
    """A phase loop whose sweeps return the assignment they were given."""
    def broken(sweep, comm0, *a, **kw):
        def same(comm, active):
            out = sweep(comm, active)
            return (comm,) + tuple(out[1:])
        return loop_fn(same, comm0, *a, **kw)
    return broken


def _unchanged_batch(loop_fn):
    def broken(sweeps, *a, **kw):
        def wrap(s):
            return lambda comm: (comm,) + tuple(s(comm)[1:])
        return loop_fn([wrap(s) for s in sweeps], *a, **kw)
    return broken


@pytest.mark.parametrize("name", CELLS)
def test_a_sweep_that_returns_its_state_unchanged_is_caught(name,
                                                            monkeypatch):
    monkeypatch.setattr(driver, "phase_loop", _unchanged(driver.phase_loop))
    monkeypatch.setattr(fused, "phase_loop", _unchanged(fused.phase_loop))
    monkeypatch.setattr(batched, "_phase_loop",
                        _unchanged_batch(batched._phase_loop))
    r = _run(name)
    assert not r["correct"] and r["failed"] >= 1
    assert r["checks"]["label_mismatch"]["value"] > 0


def test_half_of_a_batch_left_out_is_caught(monkeypatch):
    real = batched.cluster_many

    def half(graphs, **kw):
        br = real(graphs[:len(graphs) // 2], **kw)
        return br
    monkeypatch.setattr(batched, "cluster_many", half)
    r = _run("lfr-n5000-b64.closed")
    assert not r["correct"]
    assert r["checks"]["missing"]["value"] == r["attempted"] // 2


def _altered(labels):
    out = np.array(labels, copy=True)
    # Vertex 0 joins the community of another vertex outside its own.
    other = np.flatnonzero(out != out[0])
    out[0] = out[other[0]] if len(other) else out[0] + 1
    return out


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(name,
                                                          monkeypatch):
    one, many = cuvite_tpu_torch.louvain_phases, batched.cluster_many

    def solve(graph, **kw):
        r = one(graph, **kw)
        r.communities = _altered(r.communities)
        return r

    def batch(graphs, **kw):
        br = many(graphs, **kw)
        for r in br.results:
            r.communities = _altered(r.communities)
        return br
    monkeypatch.setattr(cuvite_tpu_torch, "louvain_phases", solve)
    monkeypatch.setattr(batched, "cluster_many", batch)
    r = _run(name)
    assert not r["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_program_span_metrics(name):
    cell = tiny(name)
    r = main.run_cell(cell, 2**31 + 9, 0.2, True, "cpu",
                      time.perf_counter(), log=io.StringIO())
    assert r["correct"]
    # On the CPU there is no device trace: its metrics stay out.
    want = {m["name"] for m in cell.per_layer
            if m["source"] in ("program_span", "host_clock")}
    assert "iterate_s.solve" in r["metrics"] or \
        {"pack_s.batch", "iterate_s.batch",
         "batch_p95_ms.batch"} <= set(r["metrics"])
    assert not any("roofline" in k or "idle" in k for k in r["metrics"])
    assert set(r["metrics"]) <= want
