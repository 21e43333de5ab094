"""cuvite_tpu_torch's sweep and driver held against the JAX package on the
CPU: the same numpy graphs go into both.

Per sweep, targets and the move count are identical to the JAX
``bucketed_step`` and counter0 equals the f64 numpy definition.  Whole runs
give identical labels, phase counts and iterations, and Q to 1e-9 (both
report the host f64 oracle).  Every graph here has integer weights, the
exactness domain of the float sums.
"""

import numpy as np
import pytest

from cuvite_tpu.core.distgraph import DistGraph as JDistGraph
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain.driver import PhaseRunner as JPhaseRunner
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.core.distgraph import DistGraph
from cuvite_tpu_torch.louvain.driver import PhaseRunner

import torch

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _port_graph(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


@pytest.fixture(scope="module")
def rmat12():
    return jax_rmat(12)


@pytest.fixture(scope="module")
def hub_graph():
    """tests/test_kernels.py's hub graph: one vertex of degree 8400, above
    the widest bucket (8192), plus background structure."""
    from cuvite_tpu.core.graph import Graph as JGraph

    rng = np.random.default_rng(0)
    nv = 9000
    hub_dst = rng.choice(np.arange(1, nv), size=8400, replace=False)
    src = np.concatenate([np.zeros(8400, np.int64),
                          rng.integers(1, nv, 12000)])
    dst = np.concatenate([hub_dst, rng.integers(1, nv, 12000)])
    return JGraph.from_edges(nv, src, dst)


def _counter0_oracle(g, comm):
    """Weight of each vertex's edges into its own community, f64."""
    src = g.sources().astype(np.int64)
    same = comm[src] == comm[g.tails.astype(np.int64)]
    return np.bincount(src[same], weights=g.weights[same].astype(np.float64),
                       minlength=len(comm))


@pytest.mark.parametrize("name", ["rmat12", "hub_graph"])
def test_slab_and_plan_match_jax(name, request):
    """The single-shard slab and the host bucket plan, array for array."""
    from cuvite_tpu.louvain.bucketed import BucketPlan as JBucketPlan
    from cuvite_tpu.louvain.bucketed import build_assemble_perm as jperm
    from cuvite_tpu_torch.louvain.bucketed import (
        BucketPlan,
        build_assemble_perm,
    )

    jg = request.getfixturevalue(name)
    jdg = JDistGraph.build(jg, 1, min_nv_pad=4096, min_ne_pad=16384,
                           pad_edges=False)
    dg = DistGraph.build(_port_graph(jg))
    sh = jdg.shards[0]
    assert dg.nv_pad == jdg.nv_pad
    for mine, ref in ((dg.src, sh.src), (dg.dst, sh.dst), (dg.w, sh.w),
                      (dg.padded_weighted_degrees(),
                       jdg.padded_weighted_degrees()),
                      (dg.vertex_mask(), jdg.vertex_mask()),
                      (dg.old_to_pad, jdg.old_to_pad)):
        assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
    p = BucketPlan.build(dg.src, dg.dst, dg.w, nv_local=dg.nv_pad)
    jp = JBucketPlan.build(np.asarray(sh.src), np.asarray(sh.dst),
                           np.asarray(sh.w), nv_local=jdg.nv_pad, base=0)
    assert [b.width for b in p.buckets] == [b.width for b in jp.buckets]
    for b, jb in zip(p.buckets, jp.buckets):
        for f in ("verts", "dst", "w"):
            mine, ref = getattr(b, f), getattr(jb, f)
            assert mine.dtype == ref.dtype and np.array_equal(mine, ref), f
    for f in ("heavy_src", "heavy_dst", "heavy_w", "self_loop"):
        assert np.array_equal(getattr(p, f), getattr(jp, f)), f
    assert p.has_heavy == jp.has_heavy == (name == "hub_graph")
    assert np.array_equal(
        build_assemble_perm([b.verts for b in p.buckets], dg.nv_pad),
        jperm([b.verts for b in jp.buckets], jdg.nv_pad))


@pytest.mark.parametrize("name", ["rmat12", "hub_graph"])
def test_sweeps_match_jax_bucketed_step(name, request, monkeypatch):
    """Three sweeps: from the identity assignment, then from the JAX
    step's own targets.  The hub graph's hub runs the heavy kernel's twin
    against the reference's sorted heavy path."""
    monkeypatch.setenv("CUVITE_HEAVY_KERNEL", "0")
    jg = request.getfixturevalue(name)
    jdg = JDistGraph.build(jg, 1, min_nv_pad=4096, min_ne_pad=16384,
                           pad_edges=False)
    jrun = JPhaseRunner(jdg, engine="bucketed")
    run = PhaseRunner(DistGraph.build(_port_graph(jg)), "cpu")
    assert run.nv_total == jdg.nv_pad
    if name == "hub_graph":
        assert run.plan.heavy is not None and run.plan.heavy.num_hubs == 1
    comm = np.arange(jdg.nv_pad, dtype=np.int32)
    for _ in range(3):
        jt, jmod, jmoved, _ovf = jrun._step(None, None, None, comm,
                                            jrun.vdeg, jrun.constant)
        res = run.step(torch.from_numpy(comm))
        assert np.array_equal(res.target.numpy(), np.asarray(jt))
        assert int(res.n_moved) == int(jmoved) > 0
        c0 = _counter0_oracle(jg, comm[: jg.num_vertices])
        assert np.array_equal(res.counter0.numpy()[: jg.num_vertices],
                              c0.astype(np.float32))
        # f64 in the port, f32 in the reference.
        assert float(res.modularity) == pytest.approx(float(jmod), abs=1e-6)
        comm = np.asarray(jt).astype(np.int32)


@pytest.mark.parametrize("name", ["rmat12", "hub_graph"])
def test_depadded_plan_matches_padded_plan_and_jax(name, request,
                                                   monkeypatch):
    """The device plan holds only real rows, each with its degree; three
    sweeps on it give the targets, move counts, counter0 and Q of the
    padded host plan uploaded whole (padding rows, full widths) and the
    targets of the JAX bucketed_step."""
    from cuvite_tpu_torch.louvain.bucketed import (
        BucketPlan,
        DevicePlan,
        bucketed_step,
        build_assemble_perm,
    )

    monkeypatch.setenv("CUVITE_HEAVY_KERNEL", "0")
    jg = request.getfixturevalue(name)
    jdg = JDistGraph.build(jg, 1, min_nv_pad=4096, min_ne_pad=16384,
                           pad_edges=False)
    jrun = JPhaseRunner(jdg, engine="bucketed")
    dg = DistGraph.build(_port_graph(jg))
    run = PhaseRunner(dg, "cpu")
    nv = run.nv_total
    host = BucketPlan.build(dg.src, dg.dst, dg.w, nv_local=nv)
    padded = DevicePlan(
        buckets=[(torch.from_numpy(b.verts.astype(np.int32)),
                  torch.from_numpy(b.dst.astype(np.int32)),
                  torch.from_numpy(b.w.astype(np.float32)), None)
                 for b in host.buckets],
        heavy=run.plan.heavy, self_loop=run.plan.self_loop,
        perm=torch.from_numpy(build_assemble_perm(
            [b.verts for b in host.buckets], nv).astype(np.int64)))
    degrees = np.bincount(dg.src, minlength=nv)
    assert np.array_equal(host.deg, degrees[:nv])
    n_pad = 0
    for (v, d, w, deg), b in zip(run.plan.buckets, host.buckets):
        real = b.verts < nv
        n_pad += int((~real).sum())
        assert torch.equal(v, torch.from_numpy(b.verts[real].astype(
            np.int32)))
        assert d.shape == (int(real.sum()), b.width) and w.shape == d.shape
        assert torch.equal(deg, torch.from_numpy(
            degrees[b.verts[real]].astype(np.int32)))
    assert n_pad > 0   # the padded plan really has padding rows
    comm = np.arange(nv, dtype=np.int32)
    for _ in range(3):
        jt, jmod, jmoved, _ovf = jrun._step(None, None, None, comm,
                                            jrun.vdeg, jrun.constant)
        tc = torch.from_numpy(comm)
        a = bucketed_step(run.plan, tc, run.vdeg, run.constant, nv_total=nv)
        b = bucketed_step(padded, tc, run.vdeg, run.constant, nv_total=nv)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert np.array_equal(a.target.numpy(), np.asarray(jt))
        assert int(a.n_moved) == int(jmoved)
        assert float(a.modularity) == pytest.approx(float(jmod), abs=1e-6)
        comm = np.asarray(jt).astype(np.int32)


def _assert_same_run(jr, tr):
    assert np.array_equal(tr.communities, jr.communities)
    assert len(tr.phases) == len(jr.phases)
    assert [p.iterations for p in tr.phases] == \
        [p.iterations for p in jr.phases]
    assert tr.total_iterations == jr.total_iterations
    assert abs(tr.modularity - jr.modularity) <= 1e-9


def test_karate_matches_jax(karate):
    tr = louvain_phases(_port_graph(karate), device="cpu")
    _assert_same_run(jax_louvain(karate), tr)
    assert tr.modularity == pytest.approx(0.4087, abs=1e-3)


def test_two_cliques_matches_jax(two_cliques):
    tr = louvain_phases(_port_graph(two_cliques), device="cpu")
    _assert_same_run(jax_louvain(two_cliques), tr)
    assert tr.num_communities == 2
    assert tr.modularity == pytest.approx(2 * (10 / 21 - 0.25), abs=1e-9)


@pytest.mark.parametrize("cycling", [False, True])
def test_rmat12_matches_jax(rmat12, cycling):
    tr = louvain_phases(_port_graph(rmat12), threshold_cycling=cycling,
                        device="cpu")
    _assert_same_run(jax_louvain(rmat12, threshold_cycling=cycling), tr)


def test_hub_graph_matches_jax_sorted_heavy_path(hub_graph, monkeypatch):
    """The JAX reference with CUVITE_HEAVY_KERNEL=0 runs the sorted heavy
    path, which its own heavy kernel is pinned bit-identical to."""
    monkeypatch.setenv("CUVITE_HEAVY_KERNEL", "0")
    jr = jax_louvain(hub_graph, engine="bucketed")
    tr = louvain_phases(_port_graph(hub_graph), device="cpu")
    _assert_same_run(jr, tr)
    assert len(tr.phases) >= 2


def test_one_phase_and_edgeless(karate):
    tr = louvain_phases(_port_graph(karate), one_phase=True, device="cpu")
    _assert_same_run(jax_louvain(karate, one_phase=True), tr)
    empty = Graph.from_edges(5, np.zeros(0, np.int64), np.zeros(0, np.int64))
    res = louvain_phases(empty, device="cpu")
    assert res.modularity == 0.0 and list(res.communities) == list(range(5))


# ---------------------------------------------------------------------------
# The sort engine with device coarsening.  The JAX reference runs its sort
# engine under CUVITE_SEG_COALESCE=xla, the Pallas kernel's bit-identical
# XLA twin, so both packages coarsen every class up to 4096 densely.


@pytest.fixture(scope="module")
def rgg4096_unit():
    """RGG -n 4096 with unit weights: the distances replaced by 1, inside
    the exactness domain of the reference's f32 sums."""
    from cuvite_tpu.core.graph import Graph as JGraph
    from cuvite_tpu.io.generate import generate_rgg as jax_rgg

    g = jax_rgg(4096)
    return JGraph(offsets=g.offsets, tails=g.tails,
                  weights=np.ones_like(g.weights))


def _jax_sort(jg, monkeypatch):
    monkeypatch.setenv("CUVITE_SEG_COALESCE", "xla")
    jr = jax_louvain(jg, engine="sort")
    monkeypatch.delenv("CUVITE_SEG_COALESCE")
    return jr


@pytest.mark.parametrize("name", ["karate", "two_cliques", "rmat12",
                                  "rgg4096_unit"])
def test_sort_engine_matches_jax(name, request, monkeypatch):
    jg = request.getfixturevalue(name)
    jr = _jax_sort(jg, monkeypatch)
    tr = louvain_phases(_port_graph(jg), engine="sort", device="cpu")
    _assert_same_run(jr, tr)
    coarsened = [p.coalesce for p in tr.phases]
    assert "dense" in coarsened and None not in coarsened


@pytest.mark.parametrize("name", ["rmat12", "rgg4096_unit"])
def test_sort_engine_matches_bucketed_and_host_coarsening(name, request,
                                                          monkeypatch):
    """The port's two engines give the same labels, and the sort engine's
    device transition the same run as its host coarsening."""
    g = _port_graph(request.getfixturevalue(name))
    tr = louvain_phases(g, engine="sort", device="cpu")
    tb = louvain_phases(g, engine="bucketed", device="cpu")
    assert np.array_equal(tr.communities, tb.communities)
    monkeypatch.setenv("CUVITE_DEVICE_COARSEN", "0")
    th = louvain_phases(g, engine="sort", device="cpu")
    assert np.array_equal(tr.communities, th.communities)
    assert [p.iterations for p in tr.phases] == \
        [p.iterations for p in th.phases]
    assert [p.coalesce for p in th.phases] == [None] * len(th.phases)
    assert abs(tr.modularity - th.modularity) <= 1e-12


def test_sort_engine_with_cycling_and_unknown_engine(karate, monkeypatch):
    monkeypatch.setenv("CUVITE_SEG_COALESCE", "xla")
    jr = jax_louvain(karate, engine="sort", threshold_cycling=True)
    monkeypatch.delenv("CUVITE_SEG_COALESCE")
    tr = louvain_phases(_port_graph(karate), engine="sort",
                        threshold_cycling=True, device="cpu")
    _assert_same_run(jr, tr)
    with pytest.raises(ValueError, match="unknown engine"):
        louvain_phases(_port_graph(karate), engine="xla", device="cpu")
    # 'pallas', the reference's kernel engine, runs the bucketed engine.
    tp = louvain_phases(_port_graph(karate), engine="pallas", device="cpu")
    _assert_same_run(jax_louvain(karate, engine="pallas"), tp)
    assert tp.pallas_coverage == 1.0
