"""``engine='pallas'`` and the kernel-coverage accounting of
cuvite_tpu_torch held against the JAX package on the CPU.

On R-MAT 12 (edge factor 8, seed 3), on one shard and on 8 shards under
both exchanges, ``engine='pallas'`` gives the labels, iterations and Q of
the port's bucketed run and of the reference's ``engine='pallas'``.  For
every width the reference lists, ``pallas_width_hits`` holds its traversed
edges; the widths the reference leaves out are the port's extra
kernelized classes (widths above 2048, the hubs), so the port's coverage
is at least the reference's.  A bucketed run carries the accounting too,
and the command line and the bench take ``--engine pallas``.
"""

import json
import time

import jax
import numpy as np
import pytest

from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu.workloads import bench as ref_bench
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.workloads import bench

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _free_jax_executables():
    yield
    jax.clear_caches()


def _port(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


@pytest.fixture(scope="module")
def rmat12():
    return jax_rmat(12, edge_factor=8, seed=3)


@pytest.fixture(scope="module")
def hub_graph():
    """One vertex of degree 8400, above the widest bucket (8192), plus
    background structure (tests/test_kernels.py's hub graph)."""
    from cuvite_tpu.core.graph import Graph as JGraph

    rng = np.random.default_rng(0)
    nv = 9000
    hub_dst = rng.choice(np.arange(1, nv), size=8400, replace=False)
    src = np.concatenate([np.zeros(8400, np.int64),
                          rng.integers(1, nv, 12000)])
    dst = np.concatenate([hub_dst, rng.integers(1, nv, 12000)])
    return JGraph.from_edges(nv, src, dst)


def _same_run(a, b):
    assert np.array_equal(a.communities, b.communities)
    assert [p.iterations for p in a.phases] == \
        [p.iterations for p in b.phases]
    assert a.total_iterations == b.total_iterations
    assert abs(a.modularity - b.modularity) <= 1e-9


def _traced(g, **kw):
    """The port's run with a tracer, and the run's traversed edges (edges
    x sweeps of every phase attempt, the mass the coverage divides)."""
    from cuvite_tpu_torch.utils.trace import Tracer

    tr = Tracer(enabled=True)
    res = louvain_phases(_port(g), device="cpu", tracer=tr, **kw)
    return res, tr.counters["traversed_edges"]


def _check_coverage(mine, ref, traversed):
    """Per width the reference lists, the same traversed edges; the
    port's other widths kernelized classes; coverage in [0, 1] and at
    least the reference's, the kernelized share of ``traversed``."""
    assert ref.pallas_coverage is not None
    assert 0.0 <= mine.pallas_coverage <= 1.0
    assert mine.pallas_coverage >= ref.pallas_coverage - 1e-12
    hits, ref_hits = mine.pallas_width_hits, ref.pallas_width_hits
    for w, n in ref_hits.items():
        assert hits[w] == n, w
    extra = set(hits) - set(ref_hits)
    assert all(w == 0 or w > 2048 for w in extra), extra
    assert sum(hits.values()) == pytest.approx(
        mine.pallas_coverage * traversed, rel=1e-12)


CASES = [(1, "auto"), (8, "sparse"), (8, "replicated")]


@pytest.mark.parametrize("nshards,exchange", CASES,
                         ids=["one-shard", "8-sparse", "8-replicated"])
def test_pallas_matches_bucketed_and_reference(rmat12, nshards, exchange):
    kw = dict(nshards=nshards, exchange=exchange)
    ref = jax_louvain(rmat12, engine="pallas", **kw)
    mine, traversed = _traced(rmat12, engine="pallas", **kw)
    buck = louvain_phases(_port(rmat12), engine="bucketed", device="cpu",
                          **kw)
    _same_run(mine, ref)
    _same_run(mine, buck)
    assert mine.modularity == buck.modularity
    _check_coverage(mine, ref, traversed)
    # R-MAT 12 at edge factor 8 has no hub and no class above 2048: the
    # port's accounting is the reference's, and a bucketed run's equals it.
    assert mine.pallas_coverage == ref.pallas_coverage == 1.0
    assert mine.pallas_width_hits == ref.pallas_width_hits
    assert (buck.pallas_coverage, buck.pallas_width_hits) == \
        (mine.pallas_coverage, mine.pallas_width_hits)


@pytest.mark.parametrize("nshards,exchange", [(1, "auto"), (2, "sparse"),
                                              (2, "replicated")],
                         ids=["one-shard", "2-sparse", "2-replicated"])
def test_hub_coverage_follows_the_route(hub_graph, nshards, exchange,
                                        monkeypatch):
    """One phase of the hub graph.  The hub (width 0) counts as kernelized
    where the heavy kernel takes it -- one shard and the replicated mesh
    -- and not on the sparse exchange, whose hubs ride the sorted path;
    the reference (its heavy kernel off on the CPU) never flags it.  Its
    widths' edges are the port's."""
    monkeypatch.setenv("CUVITE_HEAVY_KERNEL", "0")
    kw = dict(nshards=nshards, exchange=exchange, one_phase=True)
    ref = jax_louvain(hub_graph, engine="pallas", **kw)
    mine, traversed = _traced(hub_graph, engine="pallas", **kw)
    _same_run(mine, ref)
    _check_coverage(mine, ref, traversed)
    hub = 8400 * mine.phases[0].iterations
    if exchange == "sparse":
        assert 0 not in mine.pallas_width_hits
        assert mine.pallas_coverage == pytest.approx(1 - hub / traversed)
    else:
        assert mine.pallas_width_hits[0] == hub
        assert mine.pallas_coverage == 1.0
    assert 0 not in ref.pallas_width_hits


def test_coloring_counts_class_steps_as_kernelized():
    """The reference counts class-scheduled phases as unkernelized; the
    port's class steps launch the row kernel, so they count (a
    difference by design).  The traversed edges are the run's."""
    g = jax_rmat(10, edge_factor=8, seed=5)
    ref = jax_louvain(g, engine="pallas", coloring=4)
    mine, traversed = _traced(g, engine="pallas", coloring=4)
    _same_run(mine, ref)
    assert ref.pallas_coverage < 1.0
    assert mine.pallas_coverage == 1.0
    assert sum(mine.pallas_width_hits.values()) == traversed


def test_bucketed_result_carries_coverage(rmat12):
    res, traversed = _traced(rmat12)
    assert res.pallas_coverage == 1.0
    assert sum(res.pallas_width_hits.values()) == traversed
    sort = louvain_phases(_port(rmat12), engine="sort", device="cpu")
    assert sort.pallas_coverage is None and sort.pallas_width_hits is None


def test_unknown_engine_is_refused(rmat12):
    with pytest.raises(ValueError, match="unknown engine"):
        louvain_phases(_port(rmat12), engine="xla", device="cpu")


def test_cli_engine_pallas_matches_reference(tmp_path, capsys):
    from cuvite_tpu.cli import main as ref_main
    from cuvite_tpu_torch.cli import main

    argv = ["--rmat", "10", "--engine", "pallas", "--json", "--quiet"]
    assert main(argv + ["--device", "cpu"]) == 0
    js = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref_main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(js) == set(ref)
    for k in ("graph", "nv", "ne", "communities", "iterations", "phases"):
        assert js[k] == ref[k], k
    assert abs(js["modularity"] - ref["modularity"]) <= 1e-6


def test_bench_engine_pallas_record(capsys):
    g = jax_rmat(9, edge_factor=8, seed=3)
    ref = ref_bench.run_bench(g, engine="pallas", repeats=1, budget_s=600,
                              platform="cpu", graph_label="rmat9", scale=9,
                              t_start=time.perf_counter())
    mine = bench.run_bench(_port(g), engine="pallas", repeats=1,
                           budget_s=600, device="cpu", graph_label="rmat9",
                           scale=9, t_start=time.perf_counter())
    for rec in (mine, ref):
        assert bench.validate_record(rec) == []
        assert ref_bench.validate_record(json.loads(json.dumps(rec))) == []
    assert mine["engine"] == "pallas"
    assert mine["pallas_coverage"] == ref["pallas_coverage"]
    assert mine["pallas_width_hits"] == ref["pallas_width_hits"]
    assert (mine["phases"], mine["iterations"]) == \
        (ref["phases"], ref["iterations"])
    # A record without the keys is refused by both validators.
    bad = {k: v for k, v in mine.items() if k != "pallas_width_hits"}
    assert bench.validate_record(bad) and ref_bench.validate_record(bad)


def test_bench_command_line_engine_pallas(monkeypatch, capsys):
    from cuvite_tpu_torch.workloads.__main__ import main

    monkeypatch.setenv("BENCH_ENGINE", "pallas")
    assert main(["bench", "--device", "cpu", "--scale", "8",
                 "--repeats", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["engine"] == "pallas" and rec["pallas_coverage"] == 1.0
    assert bench.validate_record(rec) == []
    assert ref_bench.validate_record(rec) == []
