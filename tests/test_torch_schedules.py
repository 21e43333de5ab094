"""cuvite_tpu_torch's early termination, coloring and vertex-ordering
schedules held against the JAX package on the CPU: the same numpy graphs
go into both.

Early termination (ET) modes 1-4 run on both packages' sort engines (the
reference's ET loop is the same for every engine, and its sort-engine
programs compile in a fraction of the bucketed ones' time); the class
schedules run on the bucketed engines, with and without ET.  Whole runs
give identical labels, per-phase iterations and convergence-row counts,
and Q to 1e-9.  The colors are bit-identical to the reference's, and the
class plans equal its per-class builds array for array.  Every graph has
integer weights, the exactness domain.
"""

import jax
import numpy as np
import pytest
import torch

from cuvite_tpu.core.distgraph import DistGraph as JDistGraph
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.core.distgraph import DistGraph

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _free_jax_executables():
    """The reference compiles a program per plan shape (one per color
    class); free them after each test, so a test worker does not
    accumulate their memory maps."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def rmat10():
    return jax_rmat(10)


@pytest.fixture(scope="module")
def rmat12():
    return jax_rmat(12)


def _port_graph(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


def _assert_same_run(jr, tr):
    assert np.array_equal(tr.communities, jr.communities)
    assert [p.iterations for p in tr.phases] == \
        [p.iterations for p in jr.phases]
    assert tr.total_iterations == jr.total_iterations
    assert abs(tr.modularity - jr.modularity) <= 1e-9
    assert [(c.phase, c.iterations, c.gained) for c in tr.convergence] == \
        [(c.phase, c.iterations, c.gained) for c in jr.convergence]
    for tc, jc in zip(tr.convergence, jr.convergence):
        assert np.allclose([r.q for r in tc.rows], [r.q for r in jc.rows],
                           rtol=0, atol=1e-6)


@pytest.mark.parametrize("et_mode,et_delta", [(1, 0.25), (2, 0.9),
                                              (3, 0.25), (4, 0.9)])
def test_et_modes_match_jax(rmat12, et_mode, et_delta, monkeypatch):
    """The reference's device ET loop: freezes in f32 from the third sweep
    on, the frozen stop before the threshold, moves recounted after the
    freeze mask.  Modes 1 and 3 end R-MAT 12's first phase two sweeps
    later than the plain schedule does."""
    monkeypatch.setenv("CUVITE_SEG_COALESCE", "xla")
    jr = jax_louvain(rmat12, engine="sort", et_mode=et_mode,
                     et_delta=et_delta)
    monkeypatch.delenv("CUVITE_SEG_COALESCE")
    tr = louvain_phases(_port_graph(rmat12), engine="sort", et_mode=et_mode,
                        et_delta=et_delta, device="cpu")
    _assert_same_run(jr, tr)
    for tc, jc in zip(tr.convergence, jr.convergence):
        assert [r.moved for r in tc.rows] == [r.moved for r in jc.rows]
    if et_mode in (1, 3):
        assert tr.phases[0].iterations == 7
    with pytest.raises(ValueError, match="et_mode"):
        louvain_phases(_port_graph(rmat12), et_mode=5, device="cpu")


def test_et_mode3_bucketed_matches_jax(rmat10):
    """The bucketed engine's ET on the row-argmax sweeps: the reference's
    device ET loop, its frozen stop in f32, against the JAX bucketed
    engine."""
    jr = jax_louvain(rmat10, engine="bucketed", et_mode=3)
    tr = louvain_phases(_port_graph(rmat10), engine="bucketed", et_mode=3,
                        device="cpu")
    _assert_same_run(jr, tr)
    for tc, jc in zip(tr.convergence, jr.convergence):
        assert [r.moved for r in tc.rows] == [r.moved for r in jc.rows]


@pytest.mark.parametrize("n_hash", [1, 2, 4])
def test_coloring_bit_identical_to_jax(rmat10, n_hash):
    from cuvite_tpu.louvain.coloring import jenkins_mix as jmix
    from cuvite_tpu.louvain.coloring import jenkins_mix_host as jmix_host
    from cuvite_tpu.louvain.coloring import multi_hash_coloring as jcolor
    from cuvite_tpu_torch.louvain.coloring import (
        count_conflicts,
        jenkins_mix,
        multi_hash_coloring,
    )

    ids = np.random.default_rng(n_hash).integers(0, 2**31 - 1, 4096)
    for seed in (0, 1012, 2**32 - 1043 * n_hash):
        ref = np.asarray(jmix(ids.astype(np.uint32), np.uint32(seed)))
        assert np.array_equal(jenkins_mix(torch.from_numpy(ids),
                                          seed).numpy(), ref)
        # The round-seed chain takes ints.
        assert jenkins_mix(int(ids[0]), seed) == jmix_host(int(ids[0]), seed)
    src = rmat10.sources().astype(np.int32)
    dst = rmat10.tails.astype(np.int32)
    nv = rmat10.num_vertices
    jc, jn = jcolor(src, dst, nv, n_hash=n_hash)
    tc, tn = multi_hash_coloring(src, dst, nv, n_hash=n_hash, device="cpu")
    assert tn == jn and tc.dtype == np.int32
    assert np.array_equal(tc, np.asarray(jc))
    assert count_conflicts(src, dst, nv, tc) == 0
    assert (tc >= 0).mean() >= 0.7


@pytest.fixture(scope="module")
def hub_graph():
    """One vertex of degree 8400, above the widest bucket (8192)."""
    from cuvite_tpu.core.graph import Graph as JGraph

    rng = np.random.default_rng(0)
    nv = 9000
    hub_dst = rng.choice(np.arange(1, nv), size=8400, replace=False)
    src = np.concatenate([np.zeros(8400, np.int64),
                          rng.integers(1, nv, 12000)])
    dst = np.concatenate([hub_dst, rng.integers(1, nv, 12000)])
    return JGraph.from_edges(nv, src, dst)


@pytest.mark.parametrize("name", ["rmat10", "hub_graph"])
def test_class_plans_match_per_class_build(name, request):
    """One plan per class from one sort of the slab, equal to the
    reference's build over the slab with other classes masked out
    (``cuvite_tpu/louvain/driver.py:1011-1026``)."""
    from cuvite_tpu.louvain.bucketed import BucketPlan as JBucketPlan
    from cuvite_tpu_torch.louvain.bucketed import build_class_plans

    jg = request.getfixturevalue(name)
    dg = DistGraph.build(_port_graph(jg))
    nv = dg.nv_pad
    n_classes = 7
    cls = np.random.default_rng(1).integers(0, n_classes, nv).astype(
        np.int32)
    plans = build_class_plans(dg.src, dg.dst, dg.w, cls, n_classes,
                              nv_local=nv)
    assert len(plans) == n_classes
    for c, p in enumerate(plans):
        src_c = np.where(cls[dg.src] == c, dg.src, nv).astype(dg.src.dtype)
        jp = JBucketPlan.build(src_c, dg.dst, dg.w, nv_local=nv, base=0)
        assert [b.width for b in p.buckets] == [b.width for b in jp.buckets]
        for b, jb in zip(p.buckets, jp.buckets):
            for f in ("verts", "dst", "w"):
                mine, ref = getattr(b, f), getattr(jb, f)
                assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
        for f in ("heavy_src", "heavy_dst", "heavy_w", "self_loop"):
            mine, ref = getattr(p, f), getattr(jp, f)
            assert mine.dtype == ref.dtype and np.array_equal(mine, ref), f
        assert p.has_heavy == jp.has_heavy
    assert any(p.has_heavy for p in plans) == (name == "hub_graph")


def test_bucketed_modularity_matches_jax(rmat10):
    """Q of an assignment with no argmax, from one phase's plan and from
    class plans together, against the reference's (f32 sums) and the host
    f64 oracle."""
    import jax.numpy as jnp

    from cuvite_tpu.louvain.bucketed import BucketPlan as JBucketPlan
    from cuvite_tpu.louvain.driver import _bucketed_mod_jit
    from cuvite_tpu_torch.evaluate.modularity import modularity
    from cuvite_tpu_torch.louvain.bucketed import (
        BucketPlan,
        DevicePlan,
        bucketed_modularity,
        build_class_plans,
    )

    g = _port_graph(rmat10)
    dg = DistGraph.build(g)
    nv = dg.nv_pad
    labels = np.random.default_rng(2).integers(0, 64, nv).astype(np.int32)
    vdeg = torch.from_numpy(dg.padded_weighted_degrees())
    const = 1.0 / g.total_edge_weight_twice()
    plan = DevicePlan.upload(BucketPlan.build(dg.src, dg.dst, dg.w,
                                              nv_local=nv), "cpu")
    cls = labels % 5
    class_plans = [DevicePlan.upload(p, "cpu") for p in build_class_plans(
        dg.src, dg.dst, dg.w, cls, 5, nv_local=nv)]
    comm = torch.from_numpy(labels)
    q_one = float(bucketed_modularity([plan], comm, vdeg, const,
                                      nv_total=nv))
    q_cls = float(bucketed_modularity(class_plans, comm, vdeg, const,
                                      nv_total=nv))
    q_host = modularity(g, labels[: g.num_vertices])
    assert abs(q_one - q_host) <= 1e-12 and abs(q_cls - q_host) <= 1e-12

    jdg = JDistGraph.build(rmat10, 1)
    sh = jdg.shards[0]
    jp = JBucketPlan.build(np.asarray(sh.src), np.asarray(sh.dst),
                           np.asarray(sh.w), nv_local=jdg.nv_pad, base=0)
    bk = tuple((jnp.asarray(b.verts.astype(np.int32)),
                jnp.asarray(b.dst.astype(np.int32)),
                jnp.asarray(b.w.astype(np.float32))) for b in jp.buckets)
    hv = (jnp.asarray(jp.heavy_src.astype(np.int32)),
          jnp.asarray(jp.heavy_dst.astype(np.int32)),
          jnp.asarray(jp.heavy_w.astype(np.float32)))
    jcomm = np.arange(jdg.nv_pad, dtype=np.int32)
    jcomm[: g.num_vertices] = labels[: g.num_vertices]
    q_jax = float(_bucketed_mod_jit(
        bk, hv, jnp.asarray(jp.self_loop.astype(np.float32)), jcomm,
        jnp.asarray(jdg.padded_weighted_degrees().astype(np.float32)),
        jnp.asarray(np.float32(const)), nv_total=jdg.nv_pad,
        accum_dtype="float32"))
    assert q_one == pytest.approx(q_jax, abs=1e-6)


def _check_schedules(jg, configs) -> list:
    """Run each configuration in both packages; returns the port's runs."""
    g = _port_graph(jg)
    runs = []
    for kw in configs:
        jr = jax_louvain(jg, **kw)
        tr = louvain_phases(g, device="cpu", **kw)
        _assert_same_run(jr, tr)
        # The port counts the class schedule's moves (the reference does
        # not track them).
        assert tr.convergence[0].moved_total() > 0
        runs.append(tr)
    return runs


# ET inside the class schedule runs the reference's host loop: its frozen
# stop in Python floats (mode 3 stops R-MAT 10's phase 0 after six sweeps
# instead of thirteen) and its decay (mode 2 with a steep decay adds a
# fourth phase).  One case a configuration, so that the cases spread over
# the test workers; each checks what its configuration pins.
_COLOR_CASES = {
    "coloring8": (dict(coloring=8), {"rmat10": ("phase0_sweeps", 13)}),
    "ordering8": (dict(vertex_ordering=8), {}),
    "coloring8-et3": (dict(coloring=8, et_mode=3),
                      {"rmat10": ("phase0_sweeps", 6)}),
    "coloring8-et2": (dict(coloring=8, et_mode=2, et_delta=0.9),
                      {"rmat10": ("phases", 4)}),
}


@pytest.mark.parametrize("name,case", [
    (name, case) for name in ("karate", "rmat10", "rmat12")
    for case in ("coloring8", "ordering8")] + [
    ("rmat10", "coloring8-et3"), ("rmat10", "coloring8-et2")])
def test_color_schedules_match_jax(name, case, request):
    """coloring=8 (community tables refreshed per class) and
    vertex_ordering=8 (frozen at the iteration start) on phase 0, and on
    R-MAT 10 coloring with ET."""
    kw, pins = _COLOR_CASES[case]
    run = _check_schedules(request.getfixturevalue(name), [kw])[0]
    if name in pins:
        what, want = pins[name]
        got = (run.phases[0].iterations if what == "phase0_sweeps"
               else len(run.phases))
        assert got == want, (what, got, want)


def test_sort_engine_switches_to_bucketed_for_colors(karate):
    g = _port_graph(karate)
    for kw in (dict(coloring=8), dict(vertex_ordering=8)):
        with pytest.warns(UserWarning, match="auto-switching"):
            ts = louvain_phases(g, engine="sort", device="cpu", **kw)
        tb = louvain_phases(g, engine="bucketed", device="cpu", **kw)
        assert np.array_equal(ts.communities, tb.communities)
        assert [p.iterations for p in ts.phases] == \
            [p.iterations for p in tb.phases]


@pytest.mark.parametrize("flags,kw", [
    (["--engine", "fused"], dict(engine="fused")),
    (["-t", "3", "-a", "0.5", "-c", "8"],
     dict(et_mode=3, et_delta=0.5, coloring=8)),
    (["-d", "8"], dict(vertex_ordering=8)),
])
def test_cli_flags_reach_louvain_phases(flags, kw, tmp_path, monkeypatch,
                                        capsys):
    from cuvite_tpu_torch import cli
    from cuvite_tpu_torch.io.generate import generate_rmat

    monkeypatch.chdir(tmp_path)
    assert cli.main(["--rmat", "10", "--device", "cpu", "--output"]
                    + flags) == 0
    assert "Final modularity" in capsys.readouterr().out
    got = np.loadtxt(tmp_path / "rmat10.communities", dtype=np.int64)
    ref = louvain_phases(generate_rmat(10), device="cpu", **kw)
    assert np.array_equal(got, ref.communities)
