"""cuvite_tpu_torch's two-level exchange on a hybrid mesh, held against the
JAX package on the CPU: ``ExchangePlan.build_grouped`` array for array
(and its degeneration to the flat plan at ici = 1, and the group-local
remap with each shard's self edge at ``(s % ici) * nv_pad + src``), the
per-sweep ``twolevel_env`` bit for bit against the reference's under
``shard_map`` on its 8 virtual devices, whole runs at every hybrid
factorization of 8 shards against the flat sparse run and against the
reference's ``louvain_phases(mesh_shape=...)``, ET, a checkpoint resume
and the budget retry on a 2x4 mesh, and the reference's refusals
(``tests/test_twolevel.py``).

JAX runs on the conftest's 8 virtual CPU devices, the port on
``make_hybrid_mesh(dcn, ici, devices=["cpu"] * 8)``.  Every graph has
unit weights: the exactness domain of the float sums, where Q is equal
bit for bit whatever the order of the sums.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from cuvite_tpu.comm import exchange as jx
from cuvite_tpu.comm.mesh import make_hybrid_mesh as jax_hybrid_mesh
from cuvite_tpu.comm.mesh import shard_map
from cuvite_tpu.core.distgraph import DistGraph as JDistGraph
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.comm.exchange import ExchangePlan, twolevel_env
from cuvite_tpu_torch.comm.mesh import (
    hybrid_shape,
    make_hybrid_mesh,
    make_mesh,
    shard_1d,
)
from cuvite_tpu_torch.core.distgraph import DistGraph
from cuvite_tpu_torch.louvain.driver import MeshPhaseRunner

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HYBRID_SHAPES = ((8, 1), (4, 2), (2, 4), (1, 8))


def _port_graph(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def rmat8():
    return jax_rmat(8, edge_factor=8, seed=1)


@pytest.fixture(scope="module")
def rmat10():
    return jax_rmat(10, edge_factor=8, seed=3)


@pytest.fixture(scope="module")
def rmat12():
    return jax_rmat(12, edge_factor=8, seed=3)


def _cpu_hybrid(dcn, ici):
    return make_hybrid_mesh(dcn, ici, devices=["cpu"] * (dcn * ici))


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (2, 4), (4, 2)])
def test_grouped_plan_matches_jax(rmat8, shape):
    """send_idx, ghost_sel, ghost_ids, stats and every shard's remap equal
    the reference's grouped plan; the self edge of shard s lands at
    (s % ici) * nv_pad + src; at ici = 1 the plan is the flat one."""
    dcn, ici = shape
    S = dcn * ici
    jdg = JDistGraph.build(rmat8, S)
    dg = DistGraph.build(_port_graph(rmat8), S)
    ref = jx.ExchangePlan.build_grouped(jdg, dcn)
    got = ExchangePlan.build_grouped(dg, dcn)
    for f in ("send_idx", "ghost_sel"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("nshards", "nv_pad", "block", "ghost_pad", "max_ghosts",
              "ici", "shard_nv_pad"):
        assert getattr(got, f) == getattr(ref, f), f
    for a, b in zip(got.ghost_ids, ref.ghost_ids):
        assert np.array_equal(a, b)
    assert got.stats() == ref.stats()
    nvp = dg.nv_pad
    for s, (sh, jsh) in enumerate(zip(dg.shards, jdg.shards)):
        rd = got.remap_dst(s, sh.src, sh.dst)
        assert np.array_equal(rd, ref.remap_dst(s, jsh.src, jsh.dst))
        real = sh.src < nvp
        self_e = real & (sh.dst.astype(np.int64) == s * nvp + sh.src)
        assert np.array_equal(rd[self_e], (s % ici) * nvp + sh.src[self_e])
    if ici == 1:
        flat = ExchangePlan.build(dg)
        assert np.array_equal(got.send_idx, flat.send_idx)
        assert np.array_equal(got.ghost_sel, flat.ghost_sel)
        assert got.stats() == flat.stats()
        for s, sh in enumerate(dg.shards):
            assert np.array_equal(got.remap_dst(s, sh.src, sh.dst),
                                  flat.remap_dst(s, sh.src, sh.dst))


def test_grouped_plan_group_local_remap(rmat8):
    """tests/test_twolevel.py:97 on the port: (2, 4) over 8 shards, owned
    tails at their group-local index, ghosts past the group window, and
    the per-axis stats."""
    dg = DistGraph.build(_port_graph(rmat8), 8)
    plan = ExchangePlan.build_grouped(dg, 2)
    nvp, nv_grp = dg.nv_pad, plan.nv_pad
    assert (plan.ici, plan.nshards, plan.shard_nv_pad) == (4, 2, nvp)
    assert nv_grp == 4 * nvp
    for s, sh in enumerate(dg.shards):
        grp = s // 4
        rd = plan.remap_dst(s, sh.src, sh.dst)
        real = sh.src < nvp
        dst = sh.dst.astype(np.int64)
        owned = real & (dst >= grp * nv_grp) & (dst < (grp + 1) * nv_grp)
        assert np.array_equal(rd[owned], dst[owned] - grp * nv_grp)
        assert (rd[real & ~owned] >= nv_grp).all()
    st = plan.stats()
    assert st["mode"] == "twolevel" and (st["dcn"], st["ici"]) == (2, 4)
    assert st["table_bytes_per_device"] == \
        2 * dg.total_padded_vertices // 2 * 4
    assert ExchangePlan.build(dg).stats()["mode"] == "sparse"


def _jax_twolevel_env(comm, vdeg, info, plan, dcn, ici, budget):
    """The reference's twolevel_env under shard_map on the (dcn, ici)
    mesh, every field gathered to [S, ...] (overflow to [S])."""
    mesh = jax_hybrid_mesh(dcn, ici)
    vs = P(("dcn", "ici"))
    specs = (vs, vs, vs, P("dcn"), P("dcn"))

    @functools.partial(shard_map, mesh=mesh, in_specs=specs, out_specs=vs,
                       check_vma=False)
    def env(c, v, i, si, gs):
        e = jx.twolevel_env(c, v, si.reshape(dcn, -1), gs, "dcn", "ici",
                            n_dcn=dcn, budget=budget,
                            info=None if info is None else i)
        return jax.tree.map(lambda x: x.reshape((1,) + x.shape), e)

    out = jax.jit(env)(
        jnp.asarray(comm), jnp.asarray(vdeg),
        jnp.asarray(comm if info is None else info),
        jnp.asarray(plan.send_idx.reshape(dcn * dcn, plan.block)),
        jnp.asarray(plan.ghost_sel.reshape(-1)))
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


@pytest.mark.parametrize("shape,budget,with_info", [
    ((2, 4), 512, False), ((2, 4), 512, True), ((4, 2), 1, False),
    ((4, 2), 2, True)])
def test_twolevel_env_matches_jax(rmat8, shape, budget, with_info):
    """Every SparseEnv field bit for bit against the reference's
    twolevel_env on 8 shards, on an assignment whose communities span the
    groups, with vertex ordering's frozen assignment and without:
    budget 512 holds, the budgets of 1 and 2 overflow."""
    dcn, ici = shape
    dg = DistGraph.build(_port_graph(rmat8), dcn * ici)
    plan = ExchangePlan.build_grouped(dg, dcn)
    nv_total = dg.total_padded_vertices
    rng = np.random.default_rng(budget + dcn)
    comm = rng.integers(0, nv_total // 3, nv_total).astype(np.int32)
    info = (rng.integers(0, nv_total // 5, nv_total).astype(np.int32)
            if with_info else None)
    vdeg = dg.padded_weighted_degrees().astype(np.float32)
    ref = _jax_twolevel_env(comm, vdeg, info, plan, dcn, ici, budget)
    mesh = _cpu_hybrid(dcn, ici)
    envs = twolevel_env(shard_1d(mesh, comm), shard_1d(mesh, vdeg),
                        *plan.to_mesh(mesh), mesh, n_dcn=dcn, budget=budget,
                        info=None if info is None else shard_1d(mesh, info))
    for f in ref:
        got = np.stack([getattr(e, f).numpy() for e in envs])
        want = ref[f].reshape(got.shape)
        if f == "deg_local":   # f64 here, f32 there: equal values
            want = want.astype(np.float64)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert bool(ref["overflow"].any()) == (budget < 512)


def test_hybrid_mesh_views():
    """make_hybrid_mesh's shards are make_mesh's in the same order; each
    ICI group and DCN column view lists its shards' list positions."""
    mesh = _cpu_hybrid(2, 4)
    flat = make_mesh(devices=["cpu"] * 8)
    assert mesh.devices == flat.devices and mesh.size == 8
    assert hybrid_shape(mesh) == (2, 4) and hybrid_shape(flat) == (1, 8)
    assert [p for _, p in mesh.ici_views] == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert [p for _, p in mesh.dcn_views] == [(0, 4), (1, 5), (2, 6),
                                              (3, 7)]
    assert all(v.size == 4 and v.axis_name == "ici"
               for v, _ in mesh.ici_views)
    assert all(v.size == 2 and list(v.shard_ids) == [0, 1]
               and v.axis_name == "dcn" for v, _ in mesh.dcn_views)
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_hybrid_mesh(2, 4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match=">= 1"):
        make_hybrid_mesh(0, 4)


def _run(g, **kw):
    return louvain_phases(g, device="cpu", max_phases=2, **kw)


def test_twolevel_runs_equal_flat_and_jax(rmat10):
    """tests/test_twolevel.py:60 on the port: every factorization of 8
    shards (exchange 'auto': two-level at dcn > 1, the flat mesh at
    dcn = 1) gives the flat sparse run's labels and Q bit for bit, and
    the reference's labels, iterations and exchange_stats at the same
    mesh_shape."""
    g = _port_graph(rmat10)
    flat = _run(g, nshards=8, engine="bucketed", exchange="sparse")
    jflat = jax_louvain(rmat10, nshards=8, engine="bucketed",
                        exchange="sparse", max_phases=2, verbose=False)
    assert np.array_equal(flat.communities, jflat.communities)
    assert flat.exchange_stats == jflat.exchange_stats
    for shape in HYBRID_SHAPES:
        got = _run(g, nshards=8, engine="bucketed", exchange="auto",
                   mesh_shape=shape)
        assert np.array_equal(got.communities, flat.communities), shape
        assert got.modularity == flat.modularity, shape
        ref = jax_louvain(rmat10, nshards=8, engine="bucketed",
                          exchange="auto", mesh_shape=shape, max_phases=2,
                          verbose=False)
        assert np.array_equal(got.communities, ref.communities), shape
        assert [p.iterations for p in got.phases] == \
            [p.iterations for p in ref.phases], shape
    two = _run(g, mesh_shape="2x4")
    assert two.exchange_stats["mode"] == "twolevel"
    assert (two.exchange_stats["dcn"], two.exchange_stats["ici"]) == (2, 4)
    by_mesh = _run(g, mesh=_cpu_hybrid(2, 4))
    assert np.array_equal(by_mesh.communities, flat.communities)
    assert by_mesh.exchange_stats == two.exchange_stats


def test_exchange_stats_match_jax(rmat12):
    """The first phase's exchange_stats equal the reference's at every
    factorization with dcn > 1 (the flat sparse exchange's: the previous
    test).  R-MAT 12 on
    8 shards: nv_pad 512, the reference driver's floor of 4096 / 8 padded
    vertices a shard, so that table_bytes_per_device (two group-window
    tables) is the same figure on both (the port pads no shard for a
    compile cache)."""
    g = _port_graph(rmat12)
    for kw in ({"mesh_shape": (8, 1)}, {"mesh_shape": (4, 2)},
               {"mesh_shape": (2, 4)}):
        got = louvain_phases(g, device="cpu", nshards=8, max_phases=1, **kw)
        ref = jax_louvain(rmat12, nshards=8, engine="bucketed",
                          max_phases=1, verbose=False, **kw)
        assert got.exchange_stats == ref.exchange_stats, kw
        assert np.array_equal(got.communities, ref.communities), kw


def test_twolevel_et_checkpoint_and_budget(rmat10, tmp_path):
    """ET mode 3 on a 2x4 mesh equals the flat sparse ET run; a run
    stopped after one phase and resumed from its checkpoint equals the
    uninterrupted run; a budget of 1 overflows in the runner and the
    driver's retry (grown up to the group window) lands on the labels of
    the run without it."""
    g = _port_graph(rmat10)
    et = louvain_phases(g, device="cpu", mesh_shape=(2, 4), et_mode=3)
    et_flat = louvain_phases(g, device="cpu", nshards=8, exchange="sparse",
                             et_mode=3)
    assert np.array_equal(et.communities, et_flat.communities)
    assert et.modularity == et_flat.modularity
    whole = louvain_phases(g, device="cpu", mesh_shape=(2, 4))
    ck = str(tmp_path / "ck")
    part = louvain_phases(g, device="cpu", mesh_shape=(2, 4), max_phases=1,
                          checkpoint_dir=ck)
    assert len(part.phases) == 1
    resumed = louvain_phases(g, device="cpu", mesh_shape=(2, 4),
                             checkpoint_dir=ck, resume=True)
    assert np.array_equal(resumed.communities, whole.communities)
    assert resumed.modularity == whole.modularity
    dg = DistGraph.build(g, 8)
    r = MeshPhaseRunner(dg, _cpu_hybrid(2, 4), exchange="twolevel",
                        budget=1)
    assert r.budget == 1 and r.budget_cap == 4 * dg.nv_pad
    comm, seen = r.comm0, False
    for _ in range(4):
        res = r.step(comm)
        seen |= bool(res.overflow)
        comm = res.targets
    assert seen
    retried = louvain_phases(g, device="cpu", mesh_shape=(2, 4),
                             exchange_budget=1)
    assert np.array_equal(retried.communities, whole.communities)
    assert retried.modularity == whole.modularity


def test_twolevel_validation_errors(rmat8):
    """tests/test_twolevel.py:156 on the port, plus the runner's own."""
    g = _port_graph(rmat8)
    with pytest.raises(ValueError, match="mesh_shape"):
        louvain_phases(g, device="cpu", nshards=4, mesh_shape=(2, 4))
    with pytest.raises(ValueError, match="twolevel"):
        louvain_phases(g, device="cpu", nshards=8, exchange="twolevel")
    with pytest.raises(ValueError, match="replicated"):
        louvain_phases(g, device="cpu", mesh_shape=(2, 4),
                       exchange="replicated")
    with pytest.raises(ValueError, match="coloring"):
        louvain_phases(g, device="cpu", mesh_shape=(2, 4), coloring=2)
    with pytest.raises(ValueError, match="bucketed"):
        louvain_phases(g, device="cpu", mesh_shape=(2, 4), engine="sort")
    with pytest.raises(ValueError, match=">= 1"):
        louvain_phases(g, device="cpu", mesh_shape="0x4")
    dg = DistGraph.build(g, 8)
    with pytest.raises(ValueError, match="hybrid mesh"):
        MeshPhaseRunner(dg, make_mesh(devices=["cpu"] * 8),
                        exchange="twolevel")
    with pytest.raises(ValueError, match="coloring"):
        MeshPhaseRunner(dg, _cpu_hybrid(2, 4), exchange="twolevel",
                        classes=(np.zeros(dg.total_padded_vertices,
                                          dtype=np.int32), 1))
    with pytest.raises(ValueError, match="bucketed"):
        MeshPhaseRunner(dg, _cpu_hybrid(2, 4), engine="sort",
                        exchange="twolevel")
