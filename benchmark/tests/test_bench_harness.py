"""The harness on the CPU: its description, generators, reference and
window arithmetic, and its refusals."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import main, spec, stats, trace
from benchmark.reference import louvain as ref
from benchmark.tests.conftest import CELLS, ROOT, tiny
from benchmark.traffic import graph500, lfr

BENCH = spec.load_benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units_use_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w[k] for w in BENCH["workloads"]
                for k in ("name", "config", "traffic")]
             + [k for c in BENCH["configs"] for k in c["reduced"]]
             + [m["name"] for m in METRICS])
    for n in names:
        assert spec.NAME_RE.match(n), n
    for m in METRICS:
        assert spec.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    texts = ([w["why"] for w in BENCH["workloads"] + BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_config_and_metric_is_found_by_name(name):
    cell = spec.find_cell(name)
    assert cell.traffic["loop"] in ("solve", "batch")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "peak_mem_gib"}
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell("no-such-cell")


def _same_graph(a, b):
    ga, gb = ref.build_graph(*a), ref.build_graph(*b)
    return (torch.equal(ga.src, gb.src) and torch.equal(ga.dst, gb.dst)
            and torch.equal(ga.w, gb.w))


def test_graph500_is_drawn_from_the_seed():
    cfg = tiny("graph500-s20.default").config
    nv, s1, d1 = graph500.generate(cfg, 5, "cpu")
    _, s2, d2 = graph500.generate(cfg, 5, "cpu")
    _, s3, d3 = graph500.generate(cfg, 6, "cpu")
    _, s4, d4 = graph500.generate(cfg, 5, "cpu", index=1)
    assert nv == 1 << 10
    assert torch.equal(s1, s2) and torch.equal(d1, d2)
    assert bool((s1 != d1).all())
    # Another seed, or another graph of the pool: another graph.
    assert not _same_graph((nv, s1, d1), (nv, s3, d3))
    assert not _same_graph((nv, s1, d1), (nv, s4, d4))


LFR = dict(vertices=5000, average_degree=20, max_degree=50, tau1=2.0,
           tau2=1.0, mu=0.3, min_community=20, max_community=100)


def test_lfr_is_drawn_from_the_seed():
    cfg = tiny("lfr-n5000-b64.closed").config
    a = lfr.generate_pool(cfg, 3, 9)
    b = lfr.generate_pool(cfg, 3, 9)
    c = lfr.generate_pool(cfg, 3, 10)
    for (n1, s1, d1), (n2, s2, d2) in zip(a, b):
        assert n1 == n2 == 300
        assert np.array_equal(s1, s2) and np.array_equal(d1, d2)
    as_t = [(n, torch.from_numpy(s), torch.from_numpy(d)) for n, s, d in a]
    cs_t = [(n, torch.from_numpy(s), torch.from_numpy(d)) for n, s, d in c]
    assert not any(_same_graph(x, y) for x in as_t for y in cs_t)
    assert not _same_graph(as_t[0], as_t[1])


def test_lfr_degrees_communities_and_mixing():
    assert lfr._power_mean(lfr.solve_kmin(20, 50, 2.0), 50, 2.0) == \
        pytest.approx(20.0, rel=1e-9)
    sizes = lfr.community_sizes(np.random.default_rng(3), 5000, 20, 100, 1.0)
    assert sizes.sum() == 5000 and sizes.min() >= 20 and sizes.max() <= 100
    n, src, dst, comm = lfr.planted(np.random.default_rng(11), LFR)
    assert n == 5000 and not (src == dst).any()
    key = np.minimum(src, dst) * n + np.maximum(src, dst)
    assert len(np.unique(key)) == len(key)
    deg = np.bincount(np.concatenate([src, dst]), minlength=n)
    assert deg.max() <= 50 and 19.0 <= deg.mean() <= 20.0
    sizes = np.bincount(comm)
    assert sizes.min() >= 20 and sizes.max() <= 100
    mixing = np.count_nonzero(comm[src] != comm[dst]) / len(src)
    assert 0.28 <= mixing <= 0.33
    # The graph handed over is the same graph, its ids permuted.
    n2, s2, d2 = lfr.lfr_graph(LFR, 11)
    deg2 = np.bincount(np.concatenate([s2, d2]), minlength=n2)
    assert np.array_equal(np.sort(deg), np.sort(deg2))
    assert not np.array_equal(deg, deg2)


def _two_triangles():
    src = torch.tensor([0, 1, 0, 3, 4, 3, 2])
    dst = torch.tensor([1, 2, 2, 4, 5, 5, 3])
    return ref.build_graph(6, src, dst)


def test_reference_modularity_matches_a_hand_computation():
    g = _two_triangles()
    # m = 7; each triangle holds 3 edges and a degree of 7:
    # Q = 2 * (3/7 - (7/14)^2).
    halves = torch.tensor([0, 0, 0, 1, 1, 1])
    assert ref.modularity(g, halves) == pytest.approx(2 * (3 / 7 - 0.25),
                                                      abs=1e-15)
    # Singletons: no internal weight; degrees 2,2,3,3,2,2 over 2m = 14.
    single = torch.arange(6)
    want = -sum((d / 14) ** 2 for d in (2, 2, 3, 3, 2, 2))
    assert ref.modularity(g, single) == pytest.approx(want, abs=1e-15)
    labels, q, _ = ref.louvain(g)
    assert labels.tolist() == [0, 0, 0, 1, 1, 1]
    assert q == pytest.approx(2 * (3 / 7 - 0.25), abs=1e-15)


def test_reference_builds_the_graph_as_the_system_ingests_it():
    g = ref.build_graph(3, torch.tensor([0, 0, 1, 2]),
                        torch.tensor([1, 1, 1, 0]))
    # (0,1) twice -> weight 2 both ways; self-loop (1,1) once; (2,0).
    got = sorted(zip(g.src.tolist(), g.dst.tolist(), g.w.tolist()))
    assert got == [(0, 1, 2.0), (0, 2, 1.0), (1, 0, 2.0), (1, 1, 1.0),
                   (2, 0, 1.0)]


def test_whole_window_rate_mean_and_p95():
    assert stats.whole_window_rate(640, 3.2) == pytest.approx(200.0)
    assert stats.whole_window_mean(45.0, 6) == pytest.approx(7.5)
    lat = [0.1] * 95 + [0.5] * 5
    assert stats.p95(lat) == 0.1
    assert stats.p95(lat + [0.5]) == 0.5
    assert stats.p95([3.0]) == 3.0
    # Every job counts: a batch of 64 jobs is 64 samples.
    jobs = [0.2] * 64 * 19 + [0.9] * 64
    assert stats.p95(jobs) == 0.2
    assert stats.p95(jobs + [0.9] * 64) == 0.9


def test_idle_share_from_intervals():
    busy = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert stats.busy_within(busy, 0, 10) == pytest.approx(5.0)
    assert stats.idle_pct(5.0, 10.0) == pytest.approx(50.0)


def test_least_bytes_of_phase_zero():
    assert stats.least_sweep_bytes(3, 1 << 20, 31_399_654) == \
        3 * (8 * 31_399_654 + 16 * (1 << 20))
    assert stats.roofline_pct(3.35e9, 0.01, 3.35e12) == pytest.approx(10.0)
    assert stats.peak_of("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == \
        3.35e12
    assert stats.peak_of("cpu") is None


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_trace_reduction_on_synthetic_events():
    ev = [
        _x("user_annotation", "bench/window", 0, 100),
        _x("user_annotation", "bench/solve", 0, 100),
        _x("user_annotation", "bench/plan", 0, 20),
        _x("user_annotation", "bench/iterate.phase0", 20, 30),
        _x("user_annotation", "bench/coarsen", 60, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=3),
        _x("cuda_driver", "cuLaunchKernel", 70, 1, correlation=4),
        _x("kernel", "k_plan", 10, 5, correlation=1),
        _x("kernel", "k_sweep", 30, 10, correlation=2),
        _x("kernel", "k_sweep", 40, 10, correlation=3),
        _x("kernel", "k_coarsen", 75, 5, correlation=4),
        _x("gpu_memcpy", "Memcpy DtoH", 52, 2),
        _x("kernel", "k_lost", 90, 1, correlation=99),
    ]
    s = trace.reduce_events(ev)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(33e-6)
    assert s.phase0_kernel_s == pytest.approx(20e-6)
    assert s.unattributed == 1
    assert s.device_ops[0] == ["k_sweep", pytest.approx(20e-6)]
    idle = dict(s.idle_gaps)
    # plan [0,20]: busy 10-15 -> 15 idle; iterate [20,50]: busy 30-50 ->
    # 10 idle; [50,60] outside a stage -> driver, busy 52-54 -> 8 idle;
    # coarsen [60,100]: busy 75-80, 90-91 -> 34 idle.
    assert idle == {"plan": pytest.approx(15e-6),
                    "iterate": pytest.approx(10e-6),
                    "driver": pytest.approx(8e-6),
                    "coarsen": pytest.approx(34e-6)}


def test_trace_without_a_window_is_refused():
    with pytest.raises(ValueError):
        trace.reduce_events([_x("kernel", "k", 0, 1, correlation=1)])


def test_run_seed_takes_large_and_negative_seeds():
    assert main.run_seed(2**31 + 11) == 2**31 + 11
    assert 0 <= main.run_seed(-5) < 2**63


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "graph500-s20.default", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


_PROBE = """
import sys, time
sys.path.insert(0, {root!r})
from benchmark.harness import main
from benchmark.tests.conftest import tiny
for name in {cells!r}:
    r = main.run_cell(tiny(name), 7, 0.2, False, "cpu", time.perf_counter())
    assert r["correct"], r
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_no_run_imports_jax_or_the_jax_package():
    p = subprocess.run([sys.executable, "-c", _PROBE.format(
        root=ROOT, cells=CELLS)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "cuvite_tpu_torch" in tops
    assert not tops & set(main.FORBIDDEN)


def test_the_reference_imports_none_of_the_system():
    probe = (f"import sys; sys.path.insert(0, {ROOT!r}); "
             "import benchmark.reference.louvain; "
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    tops = set(json.loads(p.stdout.strip().replace("'", '"')))
    assert not tops & {"cuvite_tpu_torch", *main.FORBIDDEN}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cuvite_tpu_torch_x", sys)
    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert main.forbidden_modules() == ["jaxlib.xla"]


@pytest.mark.parametrize("where", ("metric_reader", "check"))
def test_jax_loaded_after_the_window_refuses_the_result(where, monkeypatch,
                                                        capsys):
    """A forbidden module that a metric reader or the check loads, after
    the window, still refuses the run: no result, a non-zero exit."""
    import types

    from benchmark.harness import check

    name = "graph500-s20.fused"

    def load():
        monkeypatch.setitem(sys.modules, "cuvite_tpu",
                            types.ModuleType("cuvite_tpu"))
    cell = tiny(name)
    monkeypatch.setattr(main.spec, "find_cell", lambda n: cell)
    monkeypatch.setattr(main, "require_cards", lambda chips: None)
    run_cell = main.run_cell
    monkeypatch.setattr(main, "run_cell", lambda c, s, secs, tr, dev, t0:
                        run_cell(c, s, 0.2, tr, "cpu", t0))
    if where == "metric_reader":
        reader = spec.metric_reader

        def loading_reader(metric):
            read = reader(metric)

            def wrapped(run):
                load()
                return read(run)
            return wrapped
        monkeypatch.setattr(main.spec, "metric_reader", loading_reader)
    else:
        judge = check.judge

        def loading_judge(*a, **kw):
            load()
            return judge(*a, **kw)
        monkeypatch.setattr(check, "judge", loading_judge)
    rc = main.main(["--workload", name, "--seed", "5", "--seconds", "1",
                    "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out.strip() == ""
    assert "cuvite_tpu" in out.err
