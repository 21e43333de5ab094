"""cuvite_tpu_torch's flight recorder held against the JAX package's on the
CPU.

The obs pieces run one script on both packages and must give the same
records with the timestamps dropped: the span emitter, the trace
validator, the memory ledger, the compile watcher (the reference's fed by
JAX's compile log, the port's by the hook of kernels/_build.py) and the
recorder.  These are the reference's own cases (tests/test_obs.py) as
parameters.  Each package's ``validate_trace`` accepts the other's
trace.  With a tracer attached, ``louvain_phases`` (bucketed, sort and
fused on R-MAT 10) and ``louvain_many`` (bucketed and fused on four synth
2048) give labels bit-identical to their runs without one, and the
counters and convergence events the reference's tracer records on the
same inputs.  The fine stages (``start``, ``sweep``, ``host_read``,
``renumber``, ``finish`` and the batch's ``coarsen``) nest where the drivers open
them, count the sweeps and reads the results imply, and become
``cuvite/`` ranges of a torch profiler's trace only while one records.
"""

import contextlib
import json
import logging

import jax
import numpy as np
import pytest

import cuvite_tpu.obs as ref_obs
import cuvite_tpu_torch.obs as port_obs
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain.driver import louvain_many as jax_many
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu.utils.trace import Tracer as RefTracer
from cuvite_tpu.workloads.synth import many_seed as jax_many_seed
from cuvite_tpu.workloads.synth import synthesize_graph as jax_synth
from cuvite_tpu_torch import Graph, louvain_many, louvain_phases
from cuvite_tpu_torch.kernels import _build
from cuvite_tpu_torch.utils.trace import Tracer

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

COUNTERS = ("traversed_edges", "coalesce_edges", "coalesce_dense_edges",
            "rebin_phases", "rebin_device_phases")
TIME_KEYS = ("wall", "mono", "dur_s", "rss_mb")


@pytest.fixture(autouse=True)
def _free_jax_executables():
    yield
    jax.clear_caches()


def _port(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


def _strip(obj):
    """Records with timestamps, durations and RSS dropped, and the port's
    extra ``kind`` of a compile event."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in TIME_KEYS + ("kind",)}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# One script, both packages.  Each package is (obs module, Tracer, fire),
# where fire(module, seconds) makes its watcher see one compile: a
# compile log pair on the reference's JAX logger, a build event through
# the port's kernels/_build.py hook.

def _ref_fire(name, secs):
    log = logging.getLogger("jax")
    log.warning(f"Compiling {name} with global shapes and types []")
    log.warning(f"Finished XLA compilation of {name} in {secs} sec")


def _port_fire(name, secs):
    _build._notify(name, secs, "build")


PKGS = {"reference": (ref_obs, RefTracer, _ref_fire),
        "port": (port_obs, Tracer, _port_fire)}


def _emitter_nesting(obs, _tracer, _fire):
    """tests/test_obs.py:270: ending the outer span with the inner open
    unwinds the leak."""
    sink = obs.MemoryTraceSink()
    em = obs.SpanEmitter(sink)
    outer = em.begin("outer")
    inner = em.begin("inner")
    em.event("ping", k=1)
    em.end(outer)
    em.close()
    recs = sink.records
    assert obs.validate_trace(recs) == []
    ev = next(r for r in recs if r.get("t") == "event")
    assert ev["parent"] == inner and ev["attrs"] == {"k": 1}
    leak = next(r for r in recs
                if r.get("t") == "span_end" and r.get("id") == inner)
    assert leak.get("leaked") is True
    return recs


def _validate_violations(obs, _tracer, _fire):
    """tests/test_obs.py:288."""
    base = {"wall": 0.0, "mono": 0.0, "host": 0}
    streams = [
        [dict(base, t="span_begin", id=1, parent=None, name="x")],
        [dict(base, t="span_begin", id=2, parent=9, name="x")],
        [dict(base, t="span_end", id=3)],
        [dict(base, t="event", name="a", mono=2.0),
         dict(base, t="event", name="b", mono=1.0)],
    ]
    out = [obs.validate_trace(s) for s in streams]
    for problems, word in zip(out, ("never closed", "not open", "unknown",
                                    "backwards")):
        assert any(word in p for p in problems)
    return out


def _ledger_peaks(obs, _tracer, _fire):
    """tests/test_obs.py:301 (objects with ``nbytes``), plus tensors,
    containers and dataclasses on the port, which its drivers hand in."""
    class Arr:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    led = obs.DeviceMemoryLedger()
    led.begin_phase()
    led.track("slab", Arr(100), Arr(50), None)
    led.track("tables", Arr(10))
    snap = led.snapshot(0)
    assert snap["by_buffer"] == {"slab": 150, "tables": 10}
    assert snap["total"] == 160 and snap["rss_mb"] > 0
    led.begin_phase()
    led.track("slab", Arr(80))
    led.track("scratch", Arr(999))
    led.snapshot(1)
    assert led.peak_by_buffer == {"slab": 150, "tables": 10, "scratch": 999}
    assert len(led.snapshots) == 2
    return [led.snapshots, led.peak_by_buffer, led.peak_per_device]


def _watcher_nesting(obs, _tracer, fire):
    """tests/test_obs.py:339: an inner watcher leaves the outer one
    installed and recording; both uninstall on exit."""
    seen = []
    with obs.CompileWatcher(on_event=seen.append) as outer:
        with obs.CompileWatcher() as inner:
            fire("nested_fresh", 0.25)
        fire("after_inner", 0.5)
    fire("outside", 0.75)
    assert len(inner.compiles) == 1 and len(outer.compiles) == 2
    return [seen, outer.events, inner.events]


def _outer_still_records(obs, _tracer, fire):
    """tests/test_obs.py:353: the outer watcher keeps receiving events
    inside a nested watcher's window."""
    with obs.CompileWatcher() as outer:
        with obs.CompileWatcher() as inner:
            fire("nested_fresh", 0.125)
        assert inner.compiles and outer.compiles
    assert len(outer.compiles) == len(inner.compiles)
    return [outer.events, inner.events]


def _no_trace(obs, tracer, fire):
    """tests/test_obs.py:371: NO_TRACE keeps no emitter and still
    collects compile events."""
    with obs.FlightRecorder(obs.NO_TRACE) as rec:
        assert rec.emitter is None and rec.sink is None
        tr = tracer(recorder=rec)
        with tr.stage("iterate"):
            fire("fresh_fn2", 0.5)
        tr.event("convergence", rows=[])
    assert rec.compile_events
    assert tr.times.get("iterate", 0) > 0
    return rec.compile_events


def _prefix_names(obs, _tracer, fire):
    """tests/test_obs.py:399: modules whose names prefix one another each
    keep their own event, in completion order, with no phantom."""
    w = obs.CompileWatcher()
    with w:
        fire("jit(step2)", 0.2)
        fire("jit(step)", 0.1)
    return [(e["module"], e["dur_s"]) for e in w.events]


def _records_compiles(obs, _tracer, fire):
    """tests/test_obs.py:413: a recorder turns a compile into a
    ``compile`` event of its trace."""
    with obs.FlightRecorder() as rec:
        fire("fresh_fn", 0.5)
    assert rec.compile_log
    assert rec.compile_events and "module" in rec.compile_events[0]
    names = [r.get("name") for r in rec.records if r.get("t") == "event"]
    assert "compile" in names
    return rec.records


@pytest.mark.parametrize("case", [
    _emitter_nesting, _validate_violations, _ledger_peaks,
    _watcher_nesting, _outer_still_records, _no_trace, _prefix_names,
    _records_compiles], ids=lambda f: f.__name__.strip("_"))
def test_obs_script_matches_reference(case):
    ref = case(*PKGS["reference"])
    mine = case(*PKGS["port"])
    assert _strip(mine) == _strip(ref)


def test_port_watcher_sees_builds_and_loads(monkeypatch, tmp_path):
    """The _build.py hook fires a ``load`` event on a library's first load
    and none on a later one, and a watcher leaves the hook list as it
    found it.  (No nvcc here: the load of an existing file is faked.)"""
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", lambda names: 0.0)

    class FakeLib:
        def __init__(self, path):
            self.path = path

    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    before = list(_build.HOOKS)
    with port_obs.CompileWatcher() as w:
        _build.library("row_argmax", {})
        _build.library("row_argmax", {})
    assert _build.HOOKS == before
    assert [(e["module"], e["kind"]) for e in w.events] == \
        [("row_argmax", "load")]
    assert w.compiles[0].startswith("load row_argmax")


def test_ledger_tracks_tensors_by_metadata():
    import torch

    from cuvite_tpu_torch.louvain.bucketed import DevicePlan

    plan = DevicePlan(
        buckets=[(torch.zeros(3, dtype=torch.int32),
                  torch.zeros((3, 8), dtype=torch.int32),
                  torch.zeros((3, 8)), None)],
        heavy=None, self_loop=torch.zeros(5),
        perm=torch.zeros(5, dtype=torch.int64))
    led = port_obs.DeviceMemoryLedger()
    led.track("plans", plan, [torch.zeros(2, dtype=torch.float64)], None)
    assert led.live == {"plans": 12 + 96 + 96 + 20 + 40 + 16}
    assert led.live_per_device == led.live


# ---------------------------------------------------------------------------
# Traces across packages and tracers on the drivers.


@pytest.fixture(scope="module")
def rmat10():
    return jax_rmat(10)


def _ref_run(jg, engine):
    with ref_obs.FlightRecorder() as rec:
        tr = RefTracer(recorder=rec)
        res = jax_louvain(jg, engine=engine, tracer=tr)
    return res, tr, rec


@pytest.mark.parametrize("engine", ["bucketed", "sort", "fused"])
def test_tracer_on_louvain_phases_matches_reference(engine, rmat10,
                                                    monkeypatch):
    g = _port(rmat10)
    plain = louvain_phases(g, engine=engine, device="cpu")
    with port_obs.FlightRecorder() as rec:
        tr = Tracer(recorder=rec)
        res = louvain_phases(g, engine=engine, device="cpu", tracer=tr)
    assert np.array_equal(res.communities, plain.communities)
    assert res.modularity == plain.modularity
    # The reference's sort engine coarsens through its dense twin, as the
    # port's parity tests run it (tests/test_torch_louvain.py).
    if engine == "sort":
        monkeypatch.setenv("CUVITE_SEG_COALESCE", "xla")
    jres, jtr, jrec = _ref_run(rmat10, engine)
    assert np.array_equal(res.communities, jres.communities)
    for k in COUNTERS:
        assert tr.counters.get(k, 0) == jtr.counters.get(k, 0), k
    if engine == "sort":
        assert tr.counters["coalesce_dense_edges"] > 0
    if engine == "bucketed":
        assert tr.counters["rebin_phases"] > 0

    def conv_events(records):
        return [r["attrs"] for r in records if r.get("t") == "event"
                and r.get("name") == "convergence"]

    mine, ref = conv_events(rec.records), conv_events(jrec.records)
    assert len(mine) == len(ref) == len(res.convergence)
    assert [(e["phase"], e["iterations"], e["gained"]) for e in mine] == \
        [(e["phase"], e["iterations"], e["gained"]) for e in ref]
    assert list(tr.breakdown())[:5] == [k + "_s" for k in
                                        Tracer.CANONICAL_STAGES]
    assert set(jtr.breakdown()) == set(tr.breakdown())
    # Each package's validator accepts the other's trace.
    assert ref_obs.validate_trace(rec.records) == []
    assert port_obs.validate_trace(jrec.records) == []
    if engine != "fused":
        # Phase spans nest the iterate stage and the convergence event;
        # the memory ledger books the phase's buffers.
        spans = port_obs.spans_of(rec.records, "phase")
        assert len(spans) == len(res.convergence)
        for span in spans:
            assert "iterate" in span["child_names"]
            assert "convergence" in {e["name"] for e in span["events"]}
        assert {"tables", "plans" if engine == "bucketed" else "slab"} <= \
            set(rec.ledger.peak_by_buffer)
        hbm = [r for r in rec.records if r.get("name") == "hbm"]
        assert len(hbm) == len(res.convergence)


@pytest.fixture(scope="module")
def synth4():
    gs = [jax_synth(2048, seed=jax_many_seed(7, k)) for k in range(4)]
    return gs, [_port(g) for g in gs]


@pytest.mark.parametrize("engine", ["bucketed", "fused"])
def test_tracer_on_louvain_many_matches_reference(engine, synth4):
    jgs, gs = synth4
    plain = louvain_many(gs, engine=engine, device="cpu")
    with port_obs.FlightRecorder() as rec:
        tr = Tracer(recorder=rec)
        br = louvain_many(gs, engine=engine, device="cpu", tracer=tr)
    for a, b in zip(br.results, plain.results):
        assert np.array_equal(a.communities, b.communities)
    with ref_obs.FlightRecorder() as jrec:
        jtr = RefTracer(recorder=jrec)
        jbr = jax_many(jgs, engine=engine, mesh=None, tracer=jtr)
    for a, b in zip(br.results, jbr.results):
        assert np.array_equal(a.communities, b.communities)
    assert tr.counters["traversed_edges"] > 0
    for k in COUNTERS:
        assert tr.counters.get(k, 0) == jtr.counters.get(k, 0), k
    n_conv = [sum(r.get("name") == "convergence" for r in recs)
              for recs in (rec.records, jrec.records)]
    assert n_conv[0] == n_conv[1]
    assert list(tr.breakdown())[:5] == [k + "_s" for k in
                                        Tracer.CANONICAL_STAGES]
    assert ref_obs.validate_trace(rec.records) == []
    assert {"slab", "tables"} <= set(rec.ledger.peak_by_buffer)


def test_phase_seconds_exclude_coarsening_as_the_reference(rmat10):
    """TEPS reads sum(p.seconds): the per-phase engines leave the
    coarsening out of a phase's seconds, the fused engine rescales its
    calls' seconds to the whole run's wall, as the reference does."""
    g = _port(rmat10)
    for engine in ("bucketed", "sort"):
        res = louvain_phases(g, engine=engine, device="cpu")
        coarsen = [p.stages["coarsen"] for p in res.phases[:-1]]
        assert len(coarsen) >= 2
        # Phase windows and coarsening windows are disjoint slices of
        # the run.
        assert sum(p.seconds for p in res.phases) + sum(coarsen) <= \
            res.total_seconds
        for p in res.phases:
            assert p.seconds >= p.stages["iterate"] + p.stages["plan"]
    res = louvain_phases(g, engine="fused", device="cpu")
    assert sum(p.seconds for p in res.phases) == \
        pytest.approx(res.total_seconds, rel=1e-9)


# ---------------------------------------------------------------------------
# The fine stages and their profiler ranges.


class _NestTracer(Tracer):
    """A Tracer that also books, for each stage name, the stages it was
    opened inside (None at the top)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.open: list = []
        self.parents: dict = {}

    @contextlib.contextmanager
    def stage(self, name, into=None):
        self.parents.setdefault(name, set()).add(
            self.open[-1] if self.open else None)
        self.open.append(name)
        try:
            with super().stage(name, into):
                yield
        finally:
            self.open.pop()


# Where each fine stage opens, by run.
NESTING = {
    "auto": {"sweep": {"iterate"},
             "host_read": {"sweep", "iterate", "rebin", "upload"},
             "renumber": {None}, "finish": {None}},
    "fused": {"sweep": {"iterate"},
              "host_read": {"sweep", "iterate", "upload", "renumber",
                            "finish"},
              "renumber": {None}, "start": {None}, "finish": {None}},
    "batch": {"sweep": {"iterate"},
              "host_read": {"sweep", "coarsen", "iterate", "plan", None},
              "coarsen": {"iterate"}},
}


def _fine_run(kind, rmat10, synth4, tracer):
    """(labels and Q of every graph, result) of one run of ``kind``."""
    if kind == "batch":
        br = louvain_many(synth4[1], engine="bucketed", device="cpu",
                          tracer=tracer)
        return [(r.communities, r.modularity) for r in br.results], br
    res = louvain_phases(_port(rmat10), engine=kind, device="cpu",
                         tracer=tracer)
    return [(res.communities, res.modularity)], res


def _fine_counts(kind, res, hub_uploads: int) -> tuple:
    """(sweeps, host reads) a run of ``kind`` makes, from its result and
    the count of hub layouts it uploaded."""
    if kind == "batch":
        # A read with its advance-mask upload a round of sweeps; a gain
        # mask upload and two reads a coarsening; four syncs a plan built
        # on the device, phase 0's at pack time and each re-binning's; the
        # constants, the upload's end, the final gather.
        rounds = sum(res.sweeps)
        return rounds, (rounds + 3 * len(res.coalesce)
                        + 4 * (res.phase_engines.count("rebinned") + 1) + 3)
    if kind == "fused":
        from cuvite_tpu_torch.louvain.driver import FUSED_SHRINK_EDGES

        # One fused call: a read a sweep, a community count a kept phase
        # and their read, the mask upload and the upload's end, the
        # renumber, then the final labels, their upload for Q, Q, and the
        # final gather.
        assert res.phases and res.phases[0].num_edges < FUSED_SHRINK_EDGES
        return res.total_iterations, (res.total_iterations
                                      + len(res.phases) + 8)
    # A read a sweep; a phase's labels, its degree and mask uploads and
    # the upload's end; the upload's end and four syncs a device
    # re-binning; a hub layout's upload.
    sweeps = sum(c.iterations for c in res.convergence)
    assert sweeps == res.total_iterations
    return sweeps, (sweeps + 4 * len(res.convergence)
                    + 5 * len(res.rebinned_phases) + hub_uploads)


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["auto", "fused", "batch"])
def test_fine_stages_nest_count_and_keep_the_labels(kind, rmat10, synth4,
                                                    tmp_path, monkeypatch):
    import torch

    from cuvite_tpu_torch.kernels.heavy_bincount import HeavyLayout

    plain, _ = _fine_run(kind, rmat10, synth4, None)
    hubs = []
    to = HeavyLayout.to
    monkeypatch.setattr(HeavyLayout, "to",
                        lambda lay, dev: hubs.append(dev) or to(lay, dev))
    tr = _NestTracer()
    got, res = _fine_run(kind, rmat10, synth4, tr)
    assert _same(got, plain)
    for name, where in NESTING[kind].items():
        assert tr.parents.get(name) == where, (name, tr.parents.get(name))
    sweeps, reads = _fine_counts(kind, res, len(hubs))
    assert tr.fine_calls["sweep"] == sweeps
    assert tr.fine_calls["host_read"] == reads
    if kind == "auto":
        assert res.rebinned_phases and tr.fine_calls["renumber"] == \
            len(res.phases)
    # The fine stages (the batch's coarsen among them) stay out of times,
    # calls, the breakdown, the report and the recorder's spans.
    fine = set(tr.fine_calls)
    assert fine == set(NESTING[kind]) and not fine & set(tr.calls)
    assert not {k[:-2] for k in tr.breakdown()} & Tracer.FINE_STAGES
    assert "host_read" not in tr.report()
    if kind == "batch":
        assert tr.breakdown()["coarsen_s"] == 0.0
        assert "coarsen" not in tr.report()
    with port_obs.FlightRecorder() as rec:
        got, _ = _fine_run(kind, rmat10, synth4, Tracer(recorder=rec))
    assert _same(got, plain)
    spans = {r["name"] for r in rec.records if r.get("t") == "span_begin"}
    assert "iterate" in spans and not spans & fine
    assert port_obs.validate_trace(rec.records) == []
    # Under a profiler every timed stage is a cuvite/ range of its trace.
    tr = Tracer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        got, _ = _fine_run(kind, rmat10, synth4, tr)
    assert _same(got, plain)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = {e.get("name") for e in json.loads(path.read_text())
              ["traceEvents"]}
    assert {"cuvite/" + k for k in [*tr.calls, *tr.fine_calls]} <= ranges
    if kind == "auto":
        assert "cuvite/phase" in ranges     # the driver's begin_span


def test_no_profiler_builds_no_range(rmat10, synth4, monkeypatch):
    """Without a recording profiler the tracer never calls
    record_function, traced or not."""
    import torch

    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append(a))
    for kind in ("auto", "fused", "batch"):
        tr = Tracer()
        _fine_run(kind, rmat10, synth4, tr)
        assert tr.fine_calls["sweep"] > 0
    assert made == []


def test_a_stage_inside_iterate_is_fine():
    """A stage opened inside an iterate on the same thread is a fine
    stage; one opened on another thread meanwhile, and a nested iterate,
    are not."""
    import threading

    with port_obs.FlightRecorder() as rec:
        tr = Tracer(recorder=rec)
        with tr.stage("iterate"):
            with tr.stage("coarsen"):
                pass
            with tr.stage("iterate"):
                pass
            with tr.stage("upload"):
                pass
            t = threading.Thread(target=_open_plan, args=(tr,))
            t.start()
            t.join()
        with tr.stage("coarsen"):
            pass
    assert tr.calls == {"iterate": 2, "plan": 1, "coarsen": 1}
    assert tr.fine_calls == {"coarsen": 1, "upload": 1}
    assert tr.breakdown()["coarsen_s"] == tr.times["coarsen"]
    spans = [r["name"] for r in rec.records if r.get("t") == "span_begin"]
    assert sorted(spans) == ["coarsen", "iterate", "iterate", "plan"]
    assert port_obs.validate_trace(rec.records) == []


def _open_plan(tr):
    with tr.stage("plan"):
        pass
