"""cuvite_tpu_torch's serving layer held against the JAX package's on the
CPU.

Queue discipline: the port's ``LouvainServer`` and the reference's are
driven by the same script (submissions, clock advances, steps, drains)
on the same fake clock, with the same stub runner and a recorder on both
tracers.  They must give the identical dispatch sequence -- every
``pack`` and ``execute`` span with its attributes (class, jobs, B,
trigger, layout, tenants, waits), every ``admit``/``reject``/``shed``/
``retry``/``autotune``/``tenant_result`` event, each runner call (jobs,
B, engine, bucket geometry), the rejected jobs with their
``retry_after_s``, failures and sheds -- and the same ``ServeStats``
counters.  The scripts cover linger, per-tenant round robin, admission
rejections, deadline shedding, autotuned b_max, overflow and measured
sub-row merging, poison isolation of a merged batch, and the
accumulator-tag gate (a ds32-scale tenant bins alone; a merge whose
tenants would cross the gate at the row class is served plain).

Faults: the reference's chaos plan (``tests/test_serve_robust.py``)
fires at the same passages on both packages; every job terminates
exactly once on the port, and the survivors equal a fault-free port run.

Real engine: small synth jobs served by both packages (the port on the
CPU), on both engines, give the same labels, each equal to its own B=1
run; a merged batch served by the port equals B=1; a transient device
fault re-runs the uploaded batch bit for bit; the pipelined dispatcher
gives the serial results.
"""

import types

import jax
import numpy as np
import pytest

import cuvite_tpu.serve as jserve
import cuvite_tpu_torch.serve as pserve
from cuvite_tpu.core.graph import Graph as JGraph
from cuvite_tpu.utils.trace import Tracer as JTracer
from cuvite_tpu.workloads.synth import many_seed as jax_many_seed
from cuvite_tpu.workloads.synth import synthesize_graph as jax_synth
from cuvite_tpu_torch import Graph, louvain_many
from cuvite_tpu_torch.serve import queue as pqueue
from cuvite_tpu_torch.serve.loadgen import (
    mix_schedule,
    run_mixed_open_loop,
    run_open_loop,
)
from cuvite_tpu_torch.utils.trace import Tracer as PTracer

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = (4096, 16384)
BIG = (8192, 32768)


@pytest.fixture(autouse=True)
def _free_jax_programs():
    yield
    jax.clear_caches()


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


class Recorder:
    """A recorder for both packages' tracers: spans and events as
    tuples, in order."""

    def __init__(self):
        self.records = []
        self.emitter = self
        self.phase = None
        self.ledger = types.SimpleNamespace(
            track=lambda *a: None, begin_phase=lambda: None,
            snapshot=lambda phase=None: {})
        self._n = 0

    def begin(self, name, **attrs):
        self._n += 1
        self.records.append(("begin", name, attrs))
        return self._n

    def end(self, handle, **attrs):
        self.records.append(("end", handle, attrs))

    def event(self, name, **attrs):
        self.records.append(("event", name, attrs))


PKGS = {
    "jax": types.SimpleNamespace(serve=jserve, Graph=JGraph, Tracer=JTracer),
    "port": types.SimpleNamespace(serve=pserve, Graph=Graph, Tracer=PTracer),
}


def _edges(seed, nv, ne, heavy=False):
    rng = np.random.default_rng(seed)
    w = np.full(ne, 1.0e5) if heavy else None
    return nv, rng.integers(0, nv, ne), rng.integers(0, nv, ne), w


# Graph keys of the scripts: ("s", k) small (class SMALL), ("b", k) big
# (class BIG: ~9k arcs on 8192 vertices), ("h", k) a ds32-scale tenant
# (2m >= 2^24 from 1e5 weights) of the small class, ("p", k) a small
# graph the poison runner refuses (17 vertices).
def _spec(key):
    kind, k = key
    if kind == "s":
        return _edges(k, 16, 32)
    if kind == "b":
        return _edges(100 + k, 8192, 9000)
    if kind == "h":
        return _edges(200 + k, 256, 300, heavy=True)
    return _edges(300 + k, 17, 32)


def _graph(pkg, key, cache={}):
    if (pkg, key) not in cache:
        nv, src, dst, w = _spec(key)
        cache[(pkg, key)] = PKGS[pkg].Graph.from_edges(nv, src, dst,
                                                       weights=w)
    return cache[(pkg, key)]


def stub_result(g):
    nv = g.num_vertices
    key = int(np.sum(g.tails)) % 997
    return types.SimpleNamespace(
        communities=(np.arange(nv) + key) % max(nv, 1),
        modularity=key / 997.0, phases=[1], total_iterations=3,
        num_communities=nv)


def make_runner(clock, service, calls, poison=False):
    def runner(graphs, **kw):
        shape = kw.get("bucket_shape")
        calls.append((len(graphs), kw.get("b_pad"), kw.get("engine"),
                      None if shape is None else
                      (shape.widths, shape.rows, shape.heavy_pad)))
        clock.sleep(service(len(graphs)))
        if poison and any(g.num_vertices == 17 for g in graphs):
            raise RuntimeError("poison tenant")
        return types.SimpleNamespace(
            results=[stub_result(g) for g in graphs], n_phases=1)

    return runner


def drive(pkg, script, cfg, *, service=lambda n: 0.0, faults=None,
          poison=False):
    """Run ``script`` on one package's server; everything observable."""
    serve = PKGS[pkg].serve
    clock = FakeClock()
    calls, rec, log = [], Recorder(), []
    cfg = dict(cfg)
    if "slo" in cfg:
        cfg["admission"] = serve.AdmissionConfig(wait_slo_s=cfg.pop("slo"))
    srv = serve.LouvainServer(
        serve.ServeConfig(**cfg), tracer=PKGS[pkg].Tracer(recorder=rec),
        clock=clock, sleep=clock.sleep,
        faults=serve.FaultPlan.parse(faults) if faults else None,
        runner=make_runner(clock, service, calls, poison))
    for op in script:
        if op[0] == "submit":
            _, key, tenant, deadline = op
            try:
                log.append(("admit", srv.submit(_graph(pkg, key),
                                                tenant=tenant,
                                                deadline_s=deadline)))
            except serve.AdmissionReject as e:
                log.append(("reject", e.retry_after_s, e.reason))
            except serve.InjectedFault as e:
                log.append(("fault", e.site, e.seq))
        elif op[0] == "advance":
            clock.t += op[1]
        else:
            done = srv.step() if op[0] == "step" else srv.drain()
            log.append((op[0], [(j, r.modularity) for j, r in done]))
    return {"log": log, "calls": calls, "records": rec.records,
            "stats": srv.stats.to_dict(), "conservation": srv.conservation(),
            "failures": list(srv.failures), "shed": list(srv.shed),
            "autotuned": {str(k): v for k, v in srv.autotuned().items()},
            "per_class": srv.stats.per_class(),
            "fired": [r.fired for r in srv.faults.rules]}


def _subs(kind, ks, tenant="t0", deadline=None):
    return [("submit", (kind, k), tenant, deadline) for k in ks]


def _script_linger_rr():
    s = _subs("s", range(6), "firehose")
    s += _subs("s", range(6, 8), "b") + _subs("s", [8], "c")
    s += [("step",), ("advance", 0.05), ("step",)]
    s += _subs("s", range(9, 11), "c") + [("advance", 0.06), ("step",),
                                          ("advance", 0.2), ("step",)]
    s += _subs("s", [11], "d") + [("drain",)]
    return s


def _script_admission():
    s = _subs("s", [0]) + [("step",)]
    for r in range(4):
        s += _subs("s", range(10 + 8 * r, 18 + 8 * r), f"t{r}")
        s += [("step",), ("advance", 0.05)]
    return s + [("drain",)]


def _script_shed():
    s = _subs("s", range(4), "t0", 0.05) + _subs("s", range(4, 6), "t1")
    s += [("advance", 0.2), ("step",)]
    s += _subs("s", range(6, 9), "t2", 0.5) + [("advance", 0.1), ("step",)]
    return s + [("drain",)]


def _script_autotune():
    s = []
    for i, rung in enumerate((8, 8, 8, 4, 4, 4, 2, 2, 2)):
        s += _subs("s", range(100 * i, 100 * i + rung)) + [("drain",)]
    return s + _subs("s", range(5000, 5008)) + [("step",), ("drain",)]


def _script_merge():
    s = _subs("b", [0, 1]) + [("step",)]
    for r in range(5):     # overflow merges warm the merged curve
        s += _subs("s", range(10 * r, 10 * r + 5), f"t{r % 2}")
        s += [("step",), ("advance", 0.01)]
    for r in range(4):     # plain small batches warm the plain curve
        s += _subs("s", range(100 + 2 * r, 102 + 2 * r)) + [("drain",)]
    s += _subs("s", range(200, 202)) + [("step",), ("advance", 0.02),
                                        ("step",)]
    s += _subs("b", [2]) + _subs("s", range(300, 303)) + [("drain",)]
    return s


def _script_poison_merge():
    s = _subs("b", [0, 1]) + [("step",)]
    s += _subs("s", [0]) + [("submit", ("p", 0), "t0", None)]
    s += _subs("s", [1]) + [("step",), ("drain",)]
    return s


def _script_accum():
    s = _subs("b", [0, 1]) + [("step",)]
    s += _subs("h", [0, 1, 2]) + _subs("s", range(3)) + [("step",)]
    return s + [("drain",)]


SCRIPTS = {
    # name: (script, config, service curve, fault plan, poison runner)
    "linger_round_robin": (_script_linger_rr(), dict(
        b_max=4, linger_s=0.1, engine="bucketed"), None, None, False),
    "admission": (_script_admission(), dict(
        b_max=2, linger_s=0.0, engine="fused", slo=0.3),
        lambda n: 0.1, None, False),
    "deadline_shed": (_script_shed(), dict(
        b_max=4, linger_s=0.02, engine="fused"), lambda n: 0.01, None,
        False),
    "autotune": (_script_autotune(), dict(
        b_max=8, linger_s=0.0, engine="fused", slo=0.5,
        autotune_b_max=True), lambda n: 0.1 + 0.05 * n, None, False),
    "merge": (_script_merge(), dict(
        b_max=2, linger_s=0.05, engine="bucketed", merge_packing=True,
        slo=10.0), lambda n: 0.01 + 0.001 * n, None, False),
    "merge_poison": (_script_poison_merge(), dict(
        b_max=2, linger_s=0.0, engine="fused", merge_packing=True),
        None, None, True),
    "accum_gate": (_script_accum(), dict(
        b_max=2, linger_s=0.0, engine="fused", merge_packing=True),
        None, None, False),
    "faults": (_script_linger_rr(), dict(
        b_max=4, linger_s=0.1, engine="fused", max_retries=1,
        retry_base_s=0.01), lambda n: 0.02,
        "pack:transient:every=3;device:transient:n=2;"
        "dispatch:raise:every=4;unpack:transient:every=5", False),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_queue_dispatch_matches_jax(name):
    script, cfg, service, faults, poison = SCRIPTS[name]
    kw = dict(service=service or (lambda n: 0.0), faults=faults,
              poison=poison)
    ref = drive("jax", script, cfg, **kw)
    mine = drive("port", script, cfg, **kw)
    for field in ref:
        assert mine[field] == ref[field], field
    assert mine["conservation"]["ok"]
    # Each script reaches the path it is named for.
    stats, log = mine["stats"], mine["log"]
    triggers = [r[2]["trigger"] for r in mine["records"]
                if r[0] == "begin" and r[1] == "pack"]
    if name == "linger_round_robin":
        assert {"full", "linger", "drain"} <= set(triggers)
    elif name == "admission":
        assert any(x[0] == "reject" and x[1] > 0 for x in log)
    elif name == "deadline_shed":
        assert stats["jobs_shed"] > 0
    elif name == "autotune":
        assert mine["autotuned"] and any(
            r[1] == "autotune" for r in mine["records"] if r[0] == "event")
    elif name == "merge":
        assert stats["merged_batches"] >= 2 and "merge" in triggers
        # A measured merge: a merged pop with no more jobs than b_max.
        assert any(r[2]["trigger"] == "merge" and r[2]["jobs"] <= 2
                   for r in mine["records"]
                   if r[0] == "begin" and r[1] == "pack")
    elif name == "merge_poison":
        assert stats["jobs_failed"] == 1 and "isolate" in triggers
    elif name == "accum_gate":
        assert any(r[2]["slab_class"] == list(SMALL) and r[2]["jobs"] == 2
                   and r[2]["trigger"] == "full" for r in mine["records"]
                   if r[0] == "begin" and r[1] == "pack")
    elif name == "faults":
        assert stats["retries"] > 0 and stats["jobs_failed"] > 0


def test_merge_demotes_to_plain_on_row_class_tag_flip(monkeypatch):
    """With the ds32 gate lowered so the row class's reduction length
    (8192) crosses it and the small class's (4096) does not, a merged pop
    re-gates its tenants at the row class and is served plain, on both
    packages alike."""
    monkeypatch.setattr("cuvite_tpu.louvain.driver.DS_MIN_TOTAL_WEIGHT",
                        6000.0)
    monkeypatch.setattr(pqueue, "DS_MIN_TOTAL_WEIGHT", 6000.0)
    script = _subs("b", [0, 1]) + [("step",)] + _subs("s", range(3)) + [
        ("step",)]
    cfg = dict(b_max=2, linger_s=0.0, engine="fused", merge_packing=True)
    ref, mine = drive("jax", script, cfg), drive("port", script, cfg)
    assert mine == ref
    assert mine["calls"][-1][0] == 3 and mine["stats"]["merged_batches"] == 0


def test_accum_tag_matches_reference():
    from cuvite_tpu.louvain.batched import accum_class_of

    for key in (("s", 0), ("b", 0), ("h", 0)):
        for nv_pad in (None, 8192, 1 << 24):
            assert pqueue.accum_tag(_graph("port", key), nv_pad) == \
                accum_class_of(_graph("jax", key), nv_pad)


def test_config_and_device_refusals(monkeypatch):
    for bad in (dict(b_max=0), dict(linger_s=-1), dict(threshold=0),
                dict(max_retries=-1), dict(engine="pallas"),
                dict(autotune_b_max=True), dict(admission=1.0)):
        with pytest.raises(ValueError):
            pserve.ServeConfig(**bad)
    with pytest.warns(UserWarning):
        assert pserve.ServeConfig(b_max=5).b_max == 8
    # No runner and no card: the server refuses instead of running on
    # the CPU; device="cpu" is the explicit opt-in.
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pserve.LouvainServer(pserve.ServeConfig())
    assert str(pserve.LouvainServer(
        pserve.ServeConfig(device="cpu")).device) == "cpu"


# ---------------------------------------------------------------------------
# Faults: the reference's chaos plan on both packages


CHAOS_PLAN = (
    "submit:raise:p=0.03,seed=11;"
    "pack:transient:p=0.05,seed=12;"
    "dispatch:raise:p=0.03,seed=13;"
    "device:transient:p=0.08,seed=14;"
    "device:raise:p=0.02,seed=15;"
    "unpack:transient:p=0.04,seed=16"
)


def _chaos_script(n_jobs):
    s = _subs("s", [10 ** 6]) + [("drain",)]
    for k in range(0, n_jobs, 6):
        s += [("submit", ("s", j), f"t{j % 7}", 0.12 if j % 5 == 0 else None)
              for j in range(k, min(k + 6, n_jobs))]
        s += [("step",), ("advance", 0.05)]
    return s + [("drain",)]


def test_chaos_plan_fires_identically_and_conserves():
    script = _chaos_script(240)
    cfg = dict(b_max=8, linger_s=0.1, max_retries=2, retry_base_s=0.01,
               engine="fused", slo=0.6)
    kw = dict(service=lambda n: 0.05, faults=CHAOS_PLAN)
    ref, mine = drive("jax", script, cfg, **kw), drive("port", script, cfg,
                                                       **kw)
    for field in ref:
        assert mine[field] == ref[field], field
    cons = mine["conservation"]
    assert cons["ok"] and cons["pending"] == 0 and cons["inflight"] == 0
    plan = pserve.FaultPlan.parse(CHAOS_PLAN)
    assert {r.site for r, n in zip(plan.rules, mine["fired"]) if n} == \
        {"submit", "pack", "dispatch", "device", "unpack"}
    s = mine["stats"]
    assert s["retries"] > 0 and s["jobs_failed"] > 0 and s["jobs_shed"] > 0
    assert s["jobs_rejected"] > 0
    # Every job terminated exactly once: done, failed, shed or rejected.
    done = [j for op in mine["log"] if op[0] in ("step", "drain")
            for j, _ in op[1]]
    failed = [j for j, _ in mine["failures"]]
    shed = [j for j, _ in mine["shed"]]
    admitted = [op[1] for op in mine["log"] if op[0] == "admit"]
    assert sorted(done + failed + shed) == sorted(admitted)
    # Survivors equal a fault-free port run of the same script.
    clean = drive("port", script,
                  {k: v for k, v in cfg.items() if k != "slo"},
                  service=lambda n: 0.05)
    clean_q = {j: q for op in clean["log"] if op[0] in ("step", "drain")
               for j, q in op[1]}
    for op in mine["log"]:
        if op[0] in ("step", "drain"):
            for j, q in op[1]:
                assert clean_q[j] == q


# ---------------------------------------------------------------------------
# Real engine


def _synth_jobs(n, edges=512, seed=21):
    gs = [jax_synth(edges, seed=jax_many_seed(seed, k)) for k in range(n)]
    return gs, [Graph.from_arrays(g.offsets, g.tails, g.weights) for g in gs]


@pytest.fixture(scope="module")
def synth_jobs():
    return _synth_jobs(4)


@pytest.mark.parametrize("engine", ["fused", "bucketed"])
def test_real_engine_serves_jax_labels_and_b1(synth_jobs, engine):
    jgs, pgs = synth_jobs
    cfg = dict(b_max=4, linger_s=0.0, engine=engine)
    jsrv = jserve.LouvainServer(jserve.ServeConfig(mesh=None, **cfg))
    psrv = pserve.LouvainServer(pserve.ServeConfig(device="cpu", **cfg))
    jids = [jsrv.submit(g, tenant=f"t{k % 2}") for k, g in enumerate(jgs)]
    pids = [psrv.submit(g, tenant=f"t{k % 2}") for k, g in enumerate(pgs)]
    assert jids == pids
    jres, pres = dict(jsrv.drain()), dict(psrv.drain())
    for jid, g in zip(pids, pgs):
        a, b = pres[jid], jres[jid]
        assert np.array_equal(a.communities, b.communities)
        assert [p.iterations for p in a.phases] == \
            [p.iterations for p in b.phases]
        assert abs(a.modularity - b.modularity) <= 1e-6
        solo = louvain_many([g], engine=engine, device="cpu").results[0]
        assert np.array_equal(solo.communities, a.communities)
        assert solo.modularity == a.modularity
    assert psrv.stats.batches == jsrv.stats.batches == 1
    assert psrv.conservation()["ok"]


def test_real_engine_transient_retry_and_pipeline_bit_identical(synth_jobs):
    """A transient device fault re-runs the uploaded batch: results equal
    a fault-free serial run bit for bit, and so do the pipelined
    dispatcher's."""
    _, pgs = synth_jobs
    cfg = pserve.ServeConfig(b_max=2, linger_s=0.0, engine="bucketed",
                             device="cpu", retry_base_s=0.0)
    clean = pserve.LouvainServer(cfg)
    for g in pgs:
        clean.submit(g)
    want = dict(clean.drain())
    faulty = pserve.LouvainServer(
        cfg, faults=pserve.FaultPlan.parse("device:transient:n=1;"
                                           "unpack:transient:n=1"))
    for g in pgs:
        faulty.submit(g)
    got = dict(faulty.drain())
    assert faulty.stats.retries == 2 and faulty.conservation()["ok"]
    pipe_srv = pserve.LouvainServer(cfg)
    pipe = pserve.PipelinedDispatcher(pipe_srv, poll_s=0.001)
    pipe.start()
    for g in pgs:
        pipe.submit(g)
    pipe.request_drain()
    assert pipe.wait_done(timeout=120)
    piped = dict(pipe.results)
    assert pipe_srv.stats.pipeline_depth == 2
    for jid, res in want.items():
        for other in (got, piped):
            assert np.array_equal(other[jid].communities, res.communities)
            assert other[jid].modularity == res.modularity


def test_real_engine_merged_batch_equals_b1():
    """Two big tenants certify the row class; three small jobs then
    overflow b_max=2 and ride one merged batch of the row class.  Each
    small tenant equals its own B=1 run."""
    rng = np.random.default_rng(5)
    bigs = []
    for k in range(2):
        nv = 8192
        src = np.concatenate([np.arange(nv), rng.integers(0, nv, 1024)])
        dst = np.concatenate([(np.arange(nv) + 1) % nv,
                              rng.integers(0, nv, 1024)])
        bigs.append(Graph.from_edges(nv, src, dst))
    assert pserve.queue.slab_class_of(bigs[0]) == BIG
    _, smalls = _synth_jobs(3, edges=1024, seed=3)
    srv = pserve.LouvainServer(pserve.ServeConfig(
        b_max=2, linger_s=5.0, engine="bucketed", merge_packing=True,
        device="cpu"))
    for g in bigs:
        srv.submit(g)
    assert len(srv.step()) == 2
    ids = [srv.submit(g) for g in smalls]
    done = dict(srv.step())
    assert sorted(done) == sorted(ids) and srv.stats.merged_batches == 1
    assert srv.stats.subrow_capacity == 2 + 2 * 2
    for jid, g in zip(ids, smalls):
        solo = louvain_many([g], engine="bucketed", device="cpu").results[0]
        assert np.array_equal(done[jid].communities, solo.communities)
        assert done[jid].modularity == solo.modularity


def test_loadgen_mix_and_open_loop_on_fake_clock():
    """The load generator's schedule and reports, through the port's
    queue with a stub runner on the fake clock."""
    sched = mix_schedule(list(range(9)), ["B"])
    assert [k for k, _ in sched].count("big") == 1 and sched[0][0] == "big"
    clock = FakeClock()
    calls = []
    srv = pserve.LouvainServer(
        pserve.ServeConfig(b_max=2, linger_s=0.01, engine="fused",
                           merge_packing=True),
        clock=clock, sleep=clock.sleep,
        runner=make_runner(clock, lambda n: 0.01, calls))
    smalls = [_graph("port", ("s", k)) for k in range(18)]
    bigs = [_graph("port", ("b", k)) for k in range(2)]
    rep = run_mixed_open_loop(srv, smalls, bigs, rate=1000.0)
    assert rep.report.conservation["ok"] and rep.report.done == 20
    assert rep.merged_batches >= 1 and rep.per_class["small"]["done"] == 18
    assert 0 < rep.subrow_util <= 1.0
    row = rep.row()
    assert row["merged_batches"] == rep.merged_batches
    srv2 = pserve.LouvainServer(
        pserve.ServeConfig(b_max=4, linger_s=0.01, engine="fused"),
        clock=clock, sleep=clock.sleep,
        runner=make_runner(clock, lambda n: 0.01, []))
    rep2 = run_open_loop(srv2, smalls, rate=50.0, tenants=3)
    assert rep2.done == 18 and rep2.conservation["ok"]


def test_side_stream_upload_only_under_the_pipeline(synth_jobs):
    """The serial server uploads on the current stream; the pipelined
    dispatcher switches its server to the side-stream upload, which a
    CPU batch ignores (no event to wait on)."""
    from cuvite_tpu_torch.louvain.batched import pack_many

    srv = pserve.LouvainServer(pserve.ServeConfig(device="cpu"))
    assert srv.side_stream_upload is False
    pserve.PipelinedDispatcher(srv)
    assert srv.side_stream_upload is True
    pm = pack_many(synth_jobs[1][:2], engine="bucketed", device="cpu",
                   side_stream=True)
    assert pm.prep.ready is None and pm.prep.slab.src.device.type == "cpu"


def test_tracer_stages_and_spans_match_reference():
    """Both packages' tracers record the same spans for stages, spans and
    events, and the same stage breakdown keys; NullTracer records
    nothing."""
    out = {}
    for pkg in PKGS:
        rec = Recorder()
        tr = PKGS[pkg].Tracer(recorder=rec)
        with tr.stage("upload"):
            pass
        sid = tr.begin_span("pack", jobs=3)
        tr.event("admit", job_id="job-0")
        tr.end_span(sid, wall_s=0.5)
        tr.count("traversed_edges", 10)
        bd = tr.breakdown()
        out[pkg] = ([r[:2] + ({k: v for k, v in r[2].items()
                                if k != "dur_s"},) for r in rec.records],
                    sorted(bd), tr.counters, tr.calls)
        assert "rss high-water" in tr.report()
    assert out["port"] == out["jax"]
    null = pserve.queue.LouvainServer(
        pserve.ServeConfig(device="cpu")).tracer
    with null.stage("x"):
        pass
    null.event("y")
    assert null.times == {} and null.begin_span("z") is None
