"""cuvite_tpu_torch's bench harness and command line held against the JAX
package's on the CPU.

The port's bench records pass both packages' ``validate_record`` and carry
the reference record's phases and iterations, with Q within 1e-6, on the
same graphs (R-MAT 9 edge factor 10 seed 3, and synth 1024 batches on
both batched engines).  The guard aborts a bench whose first timed run
builds or loads a kernel library or first launches a kernel form (the
set comparison on fake form counts, and a fake first launch inside the
timed run), and ``main`` then prints no JSON and exits 3.  The command
line's ``-s``, ``--json``, ``-g``, ``--trace-out`` and ``--metrics-out``
give what the reference command line gives.
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.workloads import bench as ref_bench
from cuvite_tpu_torch import Graph
from cuvite_tpu_torch.kernels import _build
from cuvite_tpu_torch.workloads import bench

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _free_jax_executables():
    """The reference compiles a program per class; free them after each
    test, so that a test worker does not accumulate them (and a later
    reference bench test finds its programs cold)."""
    yield
    jax.clear_caches()


def _port(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


def _both_valid(rec):
    assert bench.validate_record(rec) == []
    assert ref_bench.validate_record(json.loads(json.dumps(rec))) == []


@pytest.fixture(scope="module")
def rmat9_records():
    """One bench of R-MAT 9 (edge factor 10, seed 3) on each package."""
    g = jax_rmat(9, edge_factor=10, seed=3)
    ref = ref_bench.run_bench(g, repeats=2, budget_s=600, platform="cpu",
                              graph_label="rmat9", scale=9,
                              t_start=time.perf_counter())
    mine = bench.run_bench(_port(g), repeats=2, budget_s=600, device="cpu",
                           graph_label="rmat9", scale=9,
                           t_start=time.perf_counter())
    return ref, mine


def test_run_bench_record_matches_reference(rmat9_records):
    ref, mine = rmat9_records
    _both_valid(mine)
    assert mine["compile_guard"] == {"checked": True, "new_compiles": 0}
    assert mine["platform"] == "cpu" and mine["device"] == "cpu"
    assert mine["power_limit_w"] is None and mine["peak_alloc_bytes"] is None
    assert mine["runs"] == 2 and len(mine["teps_runs"]) == 2
    assert (mine["phases"], mine["iterations"]) == \
        (ref["phases"], ref["iterations"])
    assert abs(mine["modularity"] - ref["modularity"]) <= 1e-6
    assert set(ref) <= set(mine)
    # The port's bucketed record carries the kernel coverage (its classes
    # run on the hand kernels); the reference's carries it once a Pallas
    # kernel ran, which on the CPU it does not here.
    assert mine["pallas_coverage"] == 1.0 and mine["pallas_width_hits"]
    assert set(mine["stages"]) >= set(bench.REQUIRED_STAGE_KEYS)
    assert mine["stages"]["iterate_s"] > 0
    assert [d["iterations"] for d in mine["convergence_summary"]] == \
        [d["iterations"] for d in ref["convergence_summary"]]
    assert mine["rebin_device"] == ref["rebin_device"]
    # No nvcc on the CPU: the twins build nothing, so nothing is logged.
    assert mine["compile_events"] == []
    assert {"tables", "plans"} <= set(mine["hbm_peak_by_buffer"])


@pytest.mark.parametrize("engine", ["bucketed", "fused"])
def test_run_batch_bench_matches_reference(engine):
    kw = dict(B=4, edges=1024, repeats=1, budget_s=600, engine=engine)
    ref = ref_bench.run_batch_bench(platform="cpu",
                                    t_start=time.perf_counter(), **kw)
    mine = bench.run_batch_bench(device="cpu", t_start=time.perf_counter(),
                                 **kw)
    _both_valid(mine)
    assert mine["compile_guard"] == {"checked": True, "new_compiles": 0}
    for k in ("B", "n_jobs", "batches", "class", "pack_util", "engine",
              "edges_each"):
        assert mine["batch"][k] == ref["batch"][k], k
    assert (mine["graph"], mine["phases"], mine["iterations"]) == \
        (ref["graph"], ref["phases"], ref["iterations"])
    assert abs(mine["modularity"] - ref["modularity"]) <= 1e-6
    assert mine["batch"]["jobs_per_s"] > 0
    assert "slab" in mine["hbm_peak_by_buffer"]


@pytest.fixture(scope="module")
def serve_record():
    return bench.run_serve_bench(rate=400.0, b_max=4, edges=1024, n_jobs=8,
                                 device="cpu", budget_s=600,
                                 t_start=time.perf_counter())


def test_run_serve_bench_record(serve_record):
    _both_valid(serve_record)
    blk = serve_record["serve"]
    assert blk["offered"] == 8
    assert blk["done"] + blk["failed"] + blk["shed"] + blk["rejected"] == 8
    assert blk["done"] > 0 and blk["goodput_jobs_per_s"] > 0
    assert serve_record["engine"] == "batched"


# The reference's malformed-block cases (tests/test_workloads.py:411,
# tests/test_serve.py:365, :471), each rejected by both validators.
BATCH = {"B": 2, "jobs_per_s": 5.0, "pack_util": 1.0, "engine": "fused"}


def _serve(**kw):
    return lambda r: dict(r, serve=dict(r["serve"], **kw))


MALFORMED = {
    "unchecked_compiles": (lambda r: dict(r, compile_guard={
        "checked": True, "new_compiles": 2}), "new_compiles"),
    "missing_stages": (lambda r: {k: v for k, v in r.items()
                                  if k != "stages"}, "stages"),
    "batch_missing_pack_util": (lambda r: dict(r, batch={
        "B": 2, "jobs_per_s": 5.0}), "pack_util"),
    "batch_pack_util_range": (lambda r: dict(r, batch=dict(
        BATCH, pack_util=1.5)), "pack_util"),
    "batch_zero_jobs_per_s": (lambda r: dict(r, batch=dict(
        BATCH, jobs_per_s=0)), "jobs_per_s"),
    "batch_B_type": (lambda r: dict(r, batch=dict(BATCH, B="two")),
                     "batch.B"),
    "batch_engine": (lambda r: dict(r, batch=dict(BATCH, engine="sorted")),
                     "batch.engine"),
    "serve_missing_keys": (lambda r: dict(r, serve={"b_max": 2}),
                           "goodput_jobs_per_s"),
    "serve_reject_rate": (_serve(reject_rate=1.5), "reject_rate"),
    "serve_admission": (_serve(admission="yes"), "admission"),
    "serve_zero_goodput": (_serve(goodput_jobs_per_s=0),
                           "goodput_jobs_per_s"),
    "serve_engine": (_serve(engine="sorted"), "serve.engine"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_validate_record_rejects_malformed(case, serve_record):
    change, word = MALFORMED[case]
    rec = change(json.loads(json.dumps(serve_record)))
    for validate in (bench.validate_record, ref_bench.validate_record):
        assert any(word in p for p in validate(rec)), (case, validate)


@pytest.mark.parametrize("warm", ["labels", "plp", "cold"])
def test_run_churn_bench_matches_reference(warm):
    """The streaming churn bench at R-MAT 8: a record valid under both
    validators, with the reference record's Q, phases, iterations and
    stream block but its walls."""
    ref = ref_bench.run_churn_bench(churn_frac=0.02, scale=8, warm=warm,
                                    platform="cpu",
                                    t_start=time.perf_counter())
    mine = bench.run_churn_bench(churn_frac=0.02, scale=8, warm=warm,
                                 device="cpu", t_start=time.perf_counter())
    _both_valid(mine)
    assert set(ref) <= set(mine)
    assert mine["compile_guard"] == {"checked": True, "new_compiles": 0}
    assert (mine["graph"], mine["engine"], mine["platform"]) == \
        ("rmat8", "fused", "cpu")
    assert (mine["phases"], mine["iterations"]) == \
        (ref["phases"], ref["iterations"])
    assert abs(mine["modularity"] - ref["modularity"]) <= 1e-6
    walls = ("cold_wall_s", "delta_wall_s", "speedup")
    assert {k: v for k, v in mine["stream"].items() if k not in walls} == \
        {k: v for k, v in ref["stream"].items() if k not in walls}
    assert mine["stream"]["warm"] == warm


def test_churn_bench_command_prints_one_json_line(capsys, monkeypatch):
    # The budget counts from the process start; this worker's started long
    # ago, so start it now, as a fresh command's would.
    monkeypatch.setattr(bench, "_T_PROC", time.perf_counter())
    assert bench.main(["--churn-frac", "0.01", "--scale", "7",
                       "--warm-start", "plp", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    _both_valid(rec)
    assert rec["graph"] == "rmat7" and rec["stream"]["warm"] == "plp"
    assert '# launches run 1: {"row_argmax": 0, "heavy_bincount": 0, ' \
        '"seg_coalesce": 0, "row_argmax_sized": 0}' in captured.err


def test_guard_trips_on_a_build_inside_the_first_timed_run(monkeypatch):
    """A graph factory whose second call arms a build: the first timed
    run's phase set-up then fires a build event through _build.py's
    hook, as a kernel built or loaded there would, and the bench refuses
    a record."""
    from cuvite_tpu_torch.louvain import driver

    g = _port(jax_rmat(7, seed=2))
    calls = []
    build_dg = driver.DistGraph.build

    def building(graph):
        with _build._LOCK:
            _build._notify("row_argmax", 1.5, "build")
        return build_dg(graph)

    def factory():
        calls.append(1)
        if len(calls) == 2:
            monkeypatch.setattr(driver.DistGraph, "build", building)
        return g

    with pytest.raises(bench.BenchCompileGuardError) as exc:
        bench.run_bench(factory, repeats=1, budget_s=600, device="cpu",
                        t_start=time.perf_counter())
    assert exc.value.compile_log[0] == "build row_argmax in 1.500 s"


_FORM_A = ("row_argmax", "warp", "cuda:0")
_FORM_B = ("row_argmax", "block", "cuda:0")


@pytest.mark.parametrize("before,after,new", [
    ({_FORM_A: 3}, {_FORM_A: 5}, []),
    ({_FORM_A: 3}, {_FORM_A: 3, _FORM_B: 1}, [_FORM_B]),
    ({}, {_FORM_B: 2, _FORM_A: 1}, [_FORM_B, _FORM_A]),
    ({_FORM_A: 1}, {_FORM_A: 1, ("row_argmax", "warp", "cuda:1"): 1},
     [("row_argmax", "warp", "cuda:1")]),
    ({_FORM_A: 0}, {_FORM_A: 1}, [_FORM_A]),
    ({}, {_FORM_A: 0}, []),
], ids=["same", "new-body", "first-window", "new-card", "zero-before",
        "zero-after"])
def test_new_forms_compares_form_counts(before, after, new):
    """The guard's set comparison on fake form counts: a form the timed
    window launched that no earlier reading counts is new."""
    from cuvite_tpu_torch.kernels import new_forms

    assert new_forms(before, after) == sorted(new)


def test_guard_trips_on_a_first_form_inside_the_first_timed_run(
        monkeypatch):
    """A graph factory whose second call arms a first launch: the first
    timed run's set-up then records a kernel form the warm-up never
    launched, as a kernel body CUDA loads lazily there would, and the
    bench refuses a record with the form in its log."""
    from cuvite_tpu_torch.louvain import driver

    monkeypatch.setattr(_build, "FORMS", {_FORM_A: 4})
    g = _port(jax_rmat(7, seed=2))
    calls = []
    build_dg = driver.DistGraph.build

    def first_launch(graph):
        _build.note_form(*_FORM_B)
        _build.note_form(*_FORM_A)
        return build_dg(graph)

    def factory():
        calls.append(1)
        if len(calls) == 2:
            monkeypatch.setattr(driver.DistGraph, "build", first_launch)
        return g

    with pytest.raises(bench.BenchCompileGuardError) as exc:
        bench.run_bench(factory, repeats=1, budget_s=600, device="cpu",
                        t_start=time.perf_counter())
    assert exc.value.compile_log == ["first launch row_argmax block on "
                                     "cuda:0"]


def test_main_emits_no_json_on_guard_trip(monkeypatch, capsys):
    def boom(*a, **k):
        raise bench.BenchCompileGuardError(["build sabotage in 1.000 s"])

    monkeypatch.setattr(bench, "run_bench", boom)
    rc = bench.main(["--scale", "6", "--repeats", "1", "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == 3
    assert not captured.out.strip()
    assert "sabotage" in captured.err


@pytest.mark.parametrize("argv,word", [
    (["--churn-frac", "0.01", "--batch", "2"], "different benches"),
    (["--churn-frac", "0.01", "--file", "g.vite"], "does not apply"),
    (["--batch", "2", "--serve-rate", "5"], "different benches"),
    (["--batch", "2", "--scale", "8"], "do not apply"),
])
def test_main_refuses(argv, word, capsys):
    assert bench.main(argv + ["--device", "cpu"]) == 2
    assert word in capsys.readouterr().err


def test_main_without_a_card_exits_2(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--scale", "6"]) == 2
    assert "CUDA" in capsys.readouterr().err


def test_bench_command_prints_one_json_line(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "cuvite_tpu_torch.workloads", "bench",
         "--device", "cpu", "--scale", "8", "--repeats", "1",
         "--out", str(tmp_path / "rec.json")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    _both_valid(rec)
    assert rec["compile_guard"]["checked"] is True
    assert rec["graph"] == "rmat8" and rec["platform"] == "cpu"
    assert json.loads((tmp_path / "rec.json").read_text()) == rec


@pytest.mark.parametrize("argv", [["fetch", "x"], ["convert", "a"]])
def test_workloads_cli_refuses_unported(argv, capsys, tmp_path,
                                        monkeypatch):
    """``fetch`` and ``convert`` were refused before they were ported; now
    they run, offline: ``fetch`` of a catalogued name whose download fails
    writes its stand-in, ``convert`` a SNAP file."""
    from cuvite_tpu_torch.workloads import registry as reg
    from cuvite_tpu_torch.workloads.__main__ import main

    def no_network(url, dest, timeout=None):
        raise OSError("offline")

    monkeypatch.setattr(reg, "_download", no_network)
    verb, name = argv
    if verb == "fetch":
        monkeypatch.setitem(reg.DATASETS, name, reg.Dataset(
            name=name, url="http://127.0.0.1:9/x.txt.gz", fmt="snap",
            num_vertices=100, num_edges_undirected=1000, synth_edges=2000))
        args = argv + ["--dest", str(tmp_path)]
    else:
        (tmp_path / name).write_text("0 1\n1 2\n2 0\n")
        args = [verb, str(tmp_path / name), "--out",
                str(tmp_path / "a.vite")]
    assert main(args) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if verb == "fetch":
        assert line["source"] == "offline-synthesized"
        assert (tmp_path / f"{name}.vite").exists()
    else:
        assert line["num_vertices"] == 3 and line["num_edges"] == 6


def test_workloads_synth_and_verify_golden(tmp_path, capsys):
    from cuvite_tpu.workloads.synth import synthesize as jax_synthesize
    from cuvite_tpu_torch.workloads.__main__ import main

    out = str(tmp_path / "g.vite")
    assert main(["synth", "--edges", "4000", "--out", out]) == 0
    line = json.loads(capsys.readouterr().out)
    ref = jax_synthesize(str(tmp_path / "r.vite"), 4000)
    assert line["sha256"] == ref["sha256"]
    rc = main(["verify-golden", "--dataset", "tiny", "--file", out,
               "--device", "cpu", "--golden", str(tmp_path / "gold.json"),
               "--update-golden"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["measured"]["f_score"] > 0
    assert main(["verify-golden", "--dataset", "tiny", "--file", out,
                 "--device", "cpu", "--golden",
                 str(tmp_path / "gold.json")]) == 0


# ---------------------------------------------------------------------------
# The command line against the reference's.


def _run_cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def karate_file(tmp_path_factory):
    import networkx as nx

    from cuvite_tpu.core.graph import Graph as JGraph
    from cuvite_tpu.io.vite import write_vite

    e = np.array(nx.karate_club_graph().edges(), dtype=np.int64)
    path = str(tmp_path_factory.mktemp("karate") / "k.bin")
    write_vite(path, JGraph.from_edges(34, e[:, 0], e[:, 1]))
    truth = path + ".truth"
    # Two planted halves (the club's split), 1-based LFR lines.
    with open(truth, "w") as f:
        for v in range(34):
            f.write(f"{v + 1} {1 + (v >= 17)}\n")
    return path, truth


def test_cli_json_and_ground_truth_match_reference(karate_file, capsys):
    from cuvite_tpu.cli import main as ref_main
    from cuvite_tpu_torch.cli import main

    path, truth = karate_file
    argv = ["--file", path, "--bits64", "--json", "--quiet", "-g", truth]
    rc, out = _run_cli(main, argv + ["--device", "cpu"], capsys)
    ref_rc, ref_out = _run_cli(ref_main, argv, capsys)
    assert rc == ref_rc == 0
    mine, ref = out.strip().splitlines(), ref_out.strip().splitlines()
    js, ref_js = json.loads(mine[-1]), json.loads(ref_out.strip()
                                                  .splitlines()[-1])
    assert set(js) == set(ref_js)
    for k in ("graph", "nv", "ne", "communities", "iterations", "phases"):
        assert js[k] == ref_js[k], k
    assert abs(js["modularity"] - ref_js["modularity"]) <= 1e-6
    assert js["teps"] > 0
    # The comparison report is the reference's, line for line.
    assert mine[:-1] == ref[:-1]


@pytest.mark.parametrize("nv,pct,seed", [(4096, 10, 1), (3000, 10, 2),
                                         (2500, 3, 1)])
def test_cli_writes_the_reference_graph_file(nv, pct, seed, tmp_path):
    """``-n NV -e PCT -s FILE -j``: the generated graph, extra edges
    included, written byte for byte as the reference CLI writes it."""
    from cuvite_tpu.cli import main as ref_main
    from cuvite_tpu_torch.cli import main

    argv = ["-n", str(nv), "-e", str(pct), "--seed", str(seed), "-j",
            "--quiet"]
    assert main(argv + ["-s", str(tmp_path / "mine.bin")]) == 0
    assert ref_main(argv + ["-s", str(tmp_path / "ref.bin")]) == 0
    assert (tmp_path / "mine.bin").read_bytes() == \
        (tmp_path / "ref.bin").read_bytes()
    with pytest.raises(SystemExit, match="requires --generate"):
        main(["--rmat", "8", "-e", "10"])


def test_cli_trace_and_metrics_out(karate_file, tmp_path, capsys):
    from cuvite_tpu.cli import main as ref_main
    from cuvite_tpu.obs import read_trace as ref_read
    from cuvite_tpu.obs import validate_trace as ref_validate
    from cuvite_tpu_torch.cli import main
    from cuvite_tpu_torch.obs import read_trace, spans_of, validate_trace

    path, _ = karate_file
    files = {}
    for who, fn, extra in (("mine", main, ["--device", "cpu"]),
                           ("ref", ref_main, [])):
        trace = str(tmp_path / f"{who}.jsonl")
        metrics = str(tmp_path / f"{who}.json")
        rc = fn(["--file", path, "--bits64", "--trace", "--trace-out", trace,
                 "--metrics-out", metrics, "--quiet"] + extra)
        assert rc == 0
        files[who] = (trace, metrics)
    out = capsys.readouterr().out
    assert "stage breakdown" in out and "traversed_edges" in out
    records = read_trace(files["mine"][0])
    assert validate_trace(records) == [] and ref_validate(records) == []
    assert validate_trace(ref_read(files["ref"][0])) == []
    assert spans_of(records, "phase")
    m = json.load(open(files["mine"][1]))
    ref_m = json.load(open(files["ref"][1]))
    assert set(m) == set(ref_m)
    assert m["modularity"] > 0.40 and m["stages"]["iterate_s"] > 0
    assert m["convergence"] and m["convergence"][0]["rows"]
    assert [c["iterations"] for c in m["convergence"]] == \
        [c["iterations"] for c in ref_m["convergence"]]
    assert len(m["hbm_snapshots"]) == len(m["convergence"])
