"""cuvite_tpu_torch's drivers (``cuvite_tpu_torch/tools/``) on the CPU,
held against the reference's ``tools/`` scripts where those can run:

- the two-level refusals of ``louvain_phases`` and ``MeshPhaseRunner``
  word for word against the reference's;
- ``serve_load``: ``sweep``, ``ab`` and ``mix`` records valid and keyed
  as the library calls at the same arguments, each verb's verdict and
  exit code equal to the reference tool's on one crafted pair of
  records, and ``daemon`` against a spawned CPU daemon (SIGTERM, exit 0,
  the summary);
- ``exchange_latency``: the crossover function on crafted rows, and the
  verdict's keys against a child run of the reference tool (flat and
  two-axis), and a world of two gloo ranks;
- ``exchange_bench``: both arms of R-MAT 8 on 2 shards, equal labels;
- ``step_bench`` and ``trace_step`` at R-MAT 10, and
  ``weighted_ingest_bench`` against the reference's ``Graph.from_edges``;
- no tool module imports ``jax`` or ``cuvite_tpu``, and every blocking
  child process call carries a timeout.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import types

import pytest

from cuvite_tpu.core.distgraph import DistGraph as JDistGraph
from cuvite_tpu.core.graph import Graph as JGraph
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain.driver import PhaseRunner as JPhaseRunner
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.comm.mesh import make_hybrid_mesh
from cuvite_tpu_torch.core.distgraph import DistGraph
from cuvite_tpu_torch.louvain.driver import MeshPhaseRunner
from cuvite_tpu_torch.tools import (
    exchange_bench,
    exchange_latency,
    serve_load,
    step_bench,
    trace_step,
    weighted_ingest_bench,
)

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "cuvite_tpu_torch", "tools")


def _json_lines(text: str) -> list:
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


# --------------------------------------------------------------------------
# The two-level refusals (ROADMAP C3).

def test_twolevel_refusals_equal_the_reference_words():
    jg = jax_rmat(8, seed=1)
    g = Graph.from_arrays(jg.offsets, jg.tails, jg.weights)
    with pytest.raises(ValueError) as ref:
        jax_louvain(jg, engine="sort", mesh_shape=(2, 2),
                    exchange="twolevel")
    with pytest.raises(ValueError) as got:
        louvain_phases(g, device="cpu", engine="sort", mesh_shape=(2, 2),
                       exchange="twolevel")
    assert str(got.value) == str(ref.value) == (
        "the two-level exchange runs on the bucketed/pallas engines only")

    from cuvite_tpu.comm.mesh import make_hybrid_mesh as jax_hybrid_mesh

    with pytest.raises(ValueError) as ref:
        JPhaseRunner(JDistGraph.build(jg, 4), mesh=jax_hybrid_mesh(2, 2),
                     engine="sort", exchange="twolevel")
    with pytest.raises(ValueError) as got:
        MeshPhaseRunner(DistGraph.build(g, 4),
                        make_hybrid_mesh(2, 2, devices=["cpu"] * 4),
                        engine="sort", exchange="twolevel")
    assert str(got.value) == str(ref.value) == (
        "exchange='twolevel' runs on the bucketed/pallas engines only")


# --------------------------------------------------------------------------
# serve_load.

SERVE = ["--device", "cpu", "--edges", "256", "--b-max", "4",
         "--seed", "3"]


def test_serve_load_sweep_rows_match_the_library(capsys):
    from cuvite_tpu_torch.serve import LouvainServer, ServeConfig
    from cuvite_tpu_torch.serve.loadgen import run_open_loop
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    rc = serve_load.main(["sweep", *SERVE, "--jobs", "8",
                          "--start-rate", "5", "--max-rounds", "1"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    lines = _json_lines(out.out)
    rows, final = lines[:-1], lines[-1]
    assert len(rows) == 1 and rows[0]["done"] == 8
    assert set(final) == {"saturation_jobs_per_s", "wait_p95_ms", "slo_ms"}
    assert final["saturation_jobs_per_s"] == 5.0
    graphs = [synthesize_graph(256, seed=many_seed(3, k)) for k in range(4)]
    rep = run_open_loop(
        LouvainServer(ServeConfig(b_max=4, device="cpu")), graphs, 1000.0)
    assert set(rows[0]) == set(rep.row())
    assert "# launches: " in out.err


def test_serve_load_ab_records_match_the_library(capsys):
    from cuvite_tpu_torch.workloads.bench import (
        run_serve_bench,
        validate_record,
    )

    serve_load.main(["ab", *SERVE, "--jobs", "8", "--start-rate", "5",
                     "--max-rounds", "1", "--ab-jobs", "8"])
    lines = _json_lines(capsys.readouterr().out)
    head = lines[1]
    assert set(head) == {"saturation_jobs_per_s",
                         "sustainable_offered_rate", "overload_rate"}
    recs = [r for r in lines if "metric" in r]
    assert [r["serve"]["admission"] for r in recs] == [True, False]
    lib = run_serve_bench(rate=head["overload_rate"], b_max=4, edges=256,
                          n_jobs=8, seed=3, admission=False,
                          device="cpu", budget_s=600.0)
    for rec in recs:
        assert validate_record(rec) == []
        assert set(rec) == set(lib)
        assert set(rec["serve"]) == set(lib["serve"])
        assert rec["serve"]["offered"] == 8
    verdict = lines[-1]["verdict"]
    assert verdict == serve_load.ab_verdict(
        head["overload_rate"], recs[0]["serve"], recs[1]["serve"])


def test_serve_load_mix_records_match_the_library(capsys):
    from cuvite_tpu_torch.workloads.bench import (
        run_mixed_serve_bench,
        validate_record,
    )

    kw = dict(rate=400.0, b_max=1, small_edges=256, n_small=9, n_big=1,
              seed=3, engine="bucketed", device="cpu", budget_s=600.0)
    rc = serve_load.main(["mix", *SERVE[:4], "--b-max", "1", "--seed", "3",
                          "--engine", "bucketed", "--rate", "400",
                          "--n-small", "9", "--n-big", "1"])
    lines = _json_lines(capsys.readouterr().out)
    recs = [r for r in lines if "metric" in r]
    assert [r["mix"]["merge_packing"] for r in recs] == [False, True]
    lib = run_mixed_serve_bench(merge_packing=True, **kw)
    for rec in recs:
        assert validate_record(rec) == []
        assert set(rec) == set(lib)
        assert set(rec["serve"]) == set(lib["serve"])
        assert set(rec["mix"]) == set(lib["mix"])
        assert rec["mix"]["ratio"] == [9, 1]
    verdict = lines[-1]["verdict"]
    assert verdict == serve_load.mix_verdict(400.0, recs[0], recs[1])
    assert rc == (0 if verdict["acceptance"] else 1)


def _reference_serve_load():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_load", os.path.join(REPO, "tools", "serve_load.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve(goodput, wait_p95, slo_met, reject_rate, pack_s, device_s):
    return {"goodput_jobs_per_s": goodput, "wait_p95_ms": wait_p95,
            "slo_met": slo_met, "reject_rate": reject_rate,
            "pack_s": pack_s, "device_s": device_s, "overlap_frac": 0.4}


# One crafted pair of records a verb: (the keyword that tells the arms
# apart, {arm: record}).
CRAFTED = {
    "ab": ("admission", {
        True: {"serve": _serve(31.5, 140.0, True, 0.37, 0.2, 0.5)},
        False: {"serve": _serve(30.0, 2210.0, False, 0.0, 0.2, 0.5)}}),
    "pipeab": ("pipelined", {
        False: {"serve": _serve(40.0, 900.0, False, 0.0, 0.9, 1.0)},
        True: {"serve": _serve(47.0, 700.0, False, 0.0, 0.8, 1.1)}}),
    "mix": ("merge_packing", {
        False: {"serve": _serve(18.0, 600.0, False, 0.0, 0.1, 0.3),
                "mix": {"small_wait_p95_ms": 636.3, "merged_batches": 0,
                        "subrow_util": 1.0}},
        True: {"serve": _serve(19.7, 560.0, False, 0.0, 0.1, 0.3),
               "mix": {"small_wait_p95_ms": 559.7, "merged_batches": 3,
                       "subrow_util": 0.9375}}}),
}


@pytest.mark.parametrize("verb", sorted(CRAFTED))
def test_serve_load_verdicts_equal_the_reference(verb, monkeypatch,
                                                 capsys):
    """Both tools' verb functions on the same crafted records (their
    sweeps and bench calls replaced): the same lines, verdict and exit
    code."""
    import cuvite_tpu.workloads.bench as jbench
    import cuvite_tpu_torch.workloads.bench as pbench

    key, recs = CRAFTED[verb]
    reports = [types.SimpleNamespace(rate=20.0, goodput_jobs_per_s=g)
               for g in (19.5, 24.0, 23.1)]
    best = types.SimpleNamespace(rate=24.0)

    def fake_sweep(*_a):
        return None, None, reports, best

    def fake_bench(**kw):
        return recs[kw[key]]

    args = types.SimpleNamespace(
        b_max=8, edges=1024, seed=1, slo_ms=500.0, linger_ms=20.0,
        engine="bucketed", pipeline="off", ab_jobs=64, budget=600.0,
        out_prefix=None, overload_factor=1.5, rate=20.0, big_scale=13,
        big_edge_factor=2, n_small=None, n_big=None, platform="cpu",
        host_devices=8, t_start=0.0)
    ref = _reference_serve_load()
    monkeypatch.setattr(ref, "_sweep_run", fake_sweep)
    monkeypatch.setattr(ref, "_setup_jax", lambda *_a: None)
    monkeypatch.setattr(serve_load, "_sweep_run", fake_sweep)
    for mod in (jbench, pbench):
        monkeypatch.setattr(mod, "validate_record", lambda rec: [])
        monkeypatch.setattr(mod, "run_serve_bench", fake_bench)
        monkeypatch.setattr(mod, "run_mixed_serve_bench", fake_bench)
    rc_ref = getattr(ref, f"cmd_{verb}")(args)
    out_ref = _json_lines(capsys.readouterr().out)
    rc = getattr(serve_load, f"cmd_{verb}")(args, "cpu")
    out = _json_lines(capsys.readouterr().out)
    assert out == out_ref
    assert "verdict" in out[-1]
    assert rc == rc_ref == (0 if out[-1]["verdict"]["acceptance"] else 1)


class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def _overload_run(serve, graph, loadgen, sigma: float):
    """``ab``'s admission arm on one package with the card removed: 1024
    jobs arriving at 400 jobs/s (job k at k/400 s, the open loop's
    schedule), b_max 16, a 20 ms linger and a 500 ms SLO, each batch
    served by a stub in a seeded lognormal time of median 82 ms (the
    card's per-batch pack plus device time in ``ab``'s admission arm,
    synth 4096 at b_max 16: capacity ~195 jobs/s, so 400 is ~2x)."""
    import numpy as np

    clock, rng = _FakeClock(), np.random.default_rng(1)

    def runner(graphs, **_kw):
        clock.sleep(0.082 * float(np.exp(rng.normal(0.0, sigma))))
        return types.SimpleNamespace(results=[types.SimpleNamespace(
            communities=np.zeros(g.num_vertices, np.int64), modularity=0.0,
            phases=[1], total_iterations=1, num_communities=1)
            for g in graphs], n_phases=1)

    srv = serve.LouvainServer(
        serve.ServeConfig(b_max=16, linger_s=0.02, engine="fused",
                          admission=serve.AdmissionConfig(wait_slo_s=0.5)),
        clock=clock, sleep=clock.sleep, runner=runner)
    rep = loadgen.run_open_loop(srv, [graph] * 1024, 400.0)
    return rep, [j for j, _ in rep.results]


@pytest.mark.parametrize("sigma,p95_ms", [(0.0, 407.5), (0.2, 529.4)],
                         ids=["steady-service", "spread-service"])
def test_admission_decisions_equal_the_reference_on_recorded_arrivals(
        sigma, p95_ms):
    """The admission behind ``ab``'s verdict, the card taken out: both
    packages' servers on the same arrivals and the same seeded service
    times admit and reject the same jobs and give the same waits.  The
    projection (full batches ahead x the median service x 1.25) holds
    p95 under the SLO when every batch takes the median time, and not
    when the times spread (sigma 0.2): the controller neither sees the
    batch in flight nor the tail of the service time, so a host-bound
    service time that varies pushes admission's p95 past 500 ms."""
    import numpy as np

    import cuvite_tpu.serve as jserve
    import cuvite_tpu.serve.loadgen as jloadgen
    import cuvite_tpu_torch.serve as pserve
    import cuvite_tpu_torch.serve.loadgen as ploadgen

    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 16, 32), rng.integers(0, 16, 32)
    ref, ref_ids = _overload_run(jserve, JGraph.from_edges(16, src, dst),
                                 jloadgen, sigma)
    got, ids = _overload_run(pserve, Graph.from_edges(16, src, dst),
                             ploadgen, sigma)
    assert ids == ref_ids
    assert (got.rejected, got.done, got.wall_s, got.wait_p50_s,
            got.wait_p95_s) == (ref.rejected, ref.done, ref.wall_s,
                                ref.wait_p50_s, ref.wait_p95_s)
    assert got.rejected > 0
    assert round(got.wait_p95_s * 1e3, 1) == p95_ms
    assert (got.wait_p95_s <= 0.5) == (sigma == 0.0)


def test_serve_load_daemon_drains_on_sigterm(capsys):
    rc = serve_load.main(["daemon", *SERVE, "--jobs", "4", "--rate", "40",
                          "--ready-timeout", "120", "--drain-timeout",
                          "120"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    row = _json_lines(out.out)[-1]
    assert row["daemon"] and row["clean_drain"] and row["daemon_rc"] == 0
    assert row["done"] == 4 and row["conservation"]["ok"]
    assert row["conservation"]["submitted"] == 4
    assert "# launches: {" in out.err


def test_serve_load_without_a_card_exits_2(capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(SystemExit) as exc:
        serve_load.main(["sweep", "--jobs", "1"])
    assert exc.value.code == 2
    assert "device error" in capsys.readouterr().err


# --------------------------------------------------------------------------
# exchange_latency.

def _rows(ns, ag, ps, aa):
    return [{"n_per_chip": n, "all_gather_s": ag(n), "psum_s": ps(n),
             "all_to_all_s": aa(n)} for n in ns]


def test_crossover_not_reached():
    rows = _rows([128, 256, 512, 1024], lambda n: 1e-5, lambda n: 1e-5,
                 lambda n: 1e-3)
    model, bracket = exchange_latency.crossover(rows, 4, 0.1)
    assert bracket == [None, None]
    assert [nv for nv, _, _ in model] == [1024, 2048, 4096]
    assert all(ts > tr for _, tr, ts in model)


def test_crossover_at_the_range_floor():
    rows = _rows([128, 256, 512, 1024], lambda n: 1e-5, lambda n: 1e-5,
                 lambda n: 1e-7)
    _, bracket = exchange_latency.crossover(rows, 4, 0.1)
    assert bracket == [None, 1024]


def test_crossover_bracket():
    """Replicated grows with n (1 ns an element a launch), sparse costs a
    flat 3 x 2 us: replicated is 3.07 us at nv 1024 and 6.14 us at 2048,
    so the bracket is [1024, 2048]."""
    rows = _rows([128, 256, 512, 1024, 2048, 4096], lambda n: n * 1e-9,
                 lambda n: n * 1e-9, lambda n: 2e-6)
    model, bracket = exchange_latency.crossover(rows, 2, 0.1)
    assert [nv for nv, _, _ in model] == [1024, 2048, 4096, 8192]
    assert bracket == [1024, 2048]


@pytest.mark.parametrize("mode", [["--devices", "2"], ["--mesh", "2x2"]],
                         ids=["flat", "mesh"])
def test_exchange_latency_verdict_keys_equal_the_reference(mode, capsys,
                                                           tmp_path):
    ladder = ["--min-log2", "7", "--max-log2", "8", "--repeats", "1",
              "--json"]
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "exchange_latency.py"),
         *mode, *ladder], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path), env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr[-2000:]
    ref_verdict = _json_lines(ref.stdout)[-1]
    out = tmp_path / "lat.json"
    rc = exchange_latency.main([*mode, *ladder, "--device", "cpu",
                                "--out", str(out)])
    assert rc == 0
    verdict = _json_lines(capsys.readouterr().out)[-1]
    assert set(verdict) == set(ref_verdict)
    assert set(verdict["launch_latency_s"]) == \
        set(ref_verdict["launch_latency_s"])
    assert verdict["devices"] == ref_verdict["devices"]
    assert json.loads(out.read_text()) == verdict
    assert "CPU" in verdict["note"]


def test_exchange_latency_world_of_two_gloo_ranks(capsys):
    rc = exchange_latency.main(["--world", "2", "--device", "cpu",
                                "--min-log2", "7", "--max-log2", "10",
                                "--repeats", "2", "--json"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    verdict = _json_lines(out.out)[-1]
    assert verdict["devices"] == 2
    assert "gloo" in verdict["note"]
    assert len(verdict["crossover_bracket_nv"]) == 2


# --------------------------------------------------------------------------
# exchange_bench, step_bench, trace_step, weighted_ingest_bench.

def test_exchange_bench_both_arms_equal_labels(monkeypatch, capsys):
    monkeypatch.setenv("AB_SCALES", "8")
    monkeypatch.setenv("AB_SHARDS", "2")
    monkeypatch.setenv("AB_CHILD_TIMEOUT", "600")
    rc = exchange_bench.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    got = _json_lines(out)[-1]
    arms = {r["exchange"]: r for r in got["rows"]}
    assert set(arms) == {"replicated", "sparse"}
    assert arms["sparse"]["labels"] == arms["replicated"]["labels"]
    assert arms["sparse"]["modularity"] == arms["replicated"]["modularity"]
    assert "8" in got["sparse_over_replicated"]
    text = [s for s in out.splitlines() if s.startswith("scale=8 exchange=")]
    assert len(text) == 2 and all("wall=" in s and "Q=" in s for s in text)


@pytest.mark.parametrize("fault", ["rc", "timeout"])
def test_exchange_bench_reports_a_failing_child(fault, monkeypatch, capsys):
    """A child that fails or is killed at its timeout is reported on its
    own line, the ratio is left out, and the tool exits 1; a malformed
    AB_CHILD_TIMEOUT is reported before any child starts."""
    calls = []

    def fake_run(argv, **kw):
        calls.append(kw)
        if fault == "timeout":
            raise subprocess.TimeoutExpired(argv, kw["timeout"],
                                            stderr=b"stuck")
        return subprocess.CompletedProcess(argv, 1, "# backend=cpu\n",
                                           "Traceback: boom")

    monkeypatch.setenv("AB_SCALES", "8")
    monkeypatch.setenv("AB_SHARDS", "2")
    monkeypatch.setenv("AB_CHILD_TIMEOUT", "not-a-number")
    monkeypatch.setattr(exchange_bench.subprocess, "run", fake_run)
    rc = exchange_bench.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "ignoring malformed AB_CHILD_TIMEOUT='not-a-number'" in out
    assert [kw["timeout"] for kw in calls] == [7200.0, 7200.0]
    assert [kw["env"]["AB_EXCHANGE"] for kw in calls] == ["replicated",
                                                           "sparse"]
    for arm in ("replicated", "sparse"):
        want = ("TIMEOUT after 7200s (child killed) stuck"
                if fault == "timeout" else "rc=1 Traceback: boom")
        assert f"scale=8 exchange={arm}: {want}" in out
    assert "sparse/replicated" not in out


def test_step_bench_rows(monkeypatch, capsys):
    monkeypatch.setenv("AB_SCALE", "10")
    assert step_bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert any(s.startswith("step+fetch ") for s in out.splitlines())
    row = _json_lines(out)[-1]
    assert row["scale"] == 10 and row["device"] == "cpu"
    assert row["device_ms"] is None          # no CUDA events on the CPU
    assert row["step_fetch_ms"] > 0 and row["medges_per_s"] > 0
    assert row["ne"] == jax_rmat(10, seed=1).num_edges


def test_trace_step_lists_the_twins_ops(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("AB_SCALE", "10")
    monkeypatch.setenv("TRACE_DIR", str(tmp_path))
    assert trace_step.main(["--device", "cpu"]) == 0
    row = _json_lines(capsys.readouterr().out)[-1]
    assert row["rows_on"] == "cpu" and row["steps"] == 3
    names = {r["name"] for r in row["top"]}
    # The row kernel's plain version sorts each row of a class.
    assert "aten::sort" in names
    assert os.path.getsize(row["trace"]) > 0
    assert os.path.dirname(row["trace"]) == str(tmp_path)


def test_weighted_ingest_matches_the_reference(capsys):
    from cuvite_tpu_torch import native

    rc = weighted_ingest_bench.main(["12", "--device", "cpu"])
    assert rc == 0
    row = _json_lines(capsys.readouterr().out)[-1]
    assert (row["scale"], row["edge_factor"]) == (12, 16)
    nv, src, dst, w = weighted_ingest_bench.weighted_rmat(12, 16)
    ref = JGraph.from_edges(nv, src, dst, weights=w, symmetrize=True)
    assert (row["nv"], row["ne"], row["wdtype"]) == (
        ref.num_vertices, ref.num_edges, str(ref.weights.dtype))
    # The dispatch of Graph.from_edges (core/graph.py) for weighted input.
    w32 = (len(src) >= native.MIN_NATIVE_EDGES and native.available()
           and (1 << 22) < nv <= (1 << 31) and 2 * len(src) < (1 << 31))
    assert row["path"] == ("w32" if w32 else "generic") == "generic"


# --------------------------------------------------------------------------
# The modules themselves.

def _tool_modules():
    return sorted(f for f in os.listdir(TOOLS) if f.endswith(".py"))


def test_tools_import_neither_jax_nor_the_reference():
    for name in _tool_modules():
        with open(os.path.join(TOOLS, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "cuvite_tpu"), (name, m)
    names = [f"cuvite_tpu_torch.tools.{f[:-3]}" for f in _tool_modules()
             if f != "__init__.py"]
    code = ("import importlib, sys\n"
            f"for m in {names!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cuvite_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_blocking_child_calls_carry_a_timeout():
    """Every subprocess.run / check_output / check_call, and every wait()
    or communicate() on a child, passes timeout= (the reference's lint
    rule R007); comm.multihost.launch takes its own timeout."""
    blocking = {"run", "check_output", "check_call", "call", "wait",
                "communicate", "launch"}
    seen = 0
    for name in _tool_modules():
        with open(os.path.join(TOOLS, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in blocking
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in ("subprocess", "proc",
                                               "multihost")):
                seen += 1
                assert any(k.arg == "timeout" for k in node.keywords), (
                    name, node.lineno)
    assert seen >= 4
