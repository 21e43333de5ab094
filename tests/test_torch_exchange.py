"""cuvite_tpu_torch's sparse ghost exchange held against the JAX package on
the CPU: the phase's ExchangePlan and extended-local remap array for
array, the per-sweep sparse_env bit for bit against the reference's
shard_map'd one (with budgets that do and do not overflow), the row
kernel's size form (its plain twin) against row_argmax_pallas(szT=...)
in interpret mode, and the reference's own exchange tests
(tests/test_exchange.py) on the port: a sparse trajectory equal to the
replicated one, a tiny budget that overflows and is retried, the RGG
sparse run against one shard, and the 'auto' cutover set through
CUVITE_EXCHANGE_CUTOVER.

JAX runs on the conftest's 8 virtual CPU devices, the port on
make_mesh(devices=["cpu"] * S).  Every graph has integer weights and
every kernel case dyadic ones: the exactness domain of the float sums.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cuvite_tpu.comm import exchange as jx
from cuvite_tpu.comm.mesh import make_mesh as jax_mesh
from cuvite_tpu.comm.mesh import shard_map
from cuvite_tpu.core.distgraph import DistGraph as JDistGraph
from cuvite_tpu.io.generate import generate_rgg as jax_rgg
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.kernels.row_argmax import row_argmax_pallas
from cuvite_tpu.louvain.driver import PhaseRunner as JPhaseRunner
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.comm.exchange import ExchangePlan, sparse_env
from cuvite_tpu_torch.comm.mesh import make_mesh, shard_1d
from cuvite_tpu_torch.core.distgraph import DistGraph
from cuvite_tpu_torch.kernels.row_argmax import SENTINEL, row_argmax_sized
from cuvite_tpu_torch.louvain import driver as port_driver
from cuvite_tpu_torch.louvain.driver import MeshPhaseRunner
from test_torch_cuda import sized_case

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _port_graph(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def rmat9():
    return jax_rmat(9, edge_factor=8, seed=2)


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


@pytest.mark.parametrize("nshards", [2, 4, 8])
@pytest.mark.parametrize("balanced", [False, True])
def test_exchange_plan_matches_jax(rmat9, nshards, balanced):
    """send_idx, ghost_sel, ghost_ids, stats and every shard's remap."""
    jdg = JDistGraph.build(rmat9, nshards, balanced=balanced)
    dg = DistGraph.build(_port_graph(rmat9), nshards, balanced=balanced)
    ref, got = jx.ExchangePlan.build(jdg), ExchangePlan.build(dg)
    for f in ("send_idx", "ghost_sel"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.block, got.ghost_pad, got.max_ghosts) == \
        (ref.block, ref.ghost_pad, ref.max_ghosts)
    for a, b in zip(got.ghost_ids, ref.ghost_ids):
        assert np.array_equal(a, b)
    assert got.stats() == ref.stats()
    for s, (sh, jsh) in enumerate(zip(dg.shards, jdg.shards)):
        assert np.array_equal(got.remap_dst(s, sh.src, sh.dst),
                              ref.remap_dst(s, jsh.src, jsh.dst))


def _jax_env(comm, vdeg, plan, nshards, budget):
    """The reference's sparse_env under shard_map, every field gathered
    to [S, ...] (overflow to [S])."""
    mesh = jax_mesh(nshards)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P("v"), P("v"), P("v"), P("v")),
                       out_specs=P("v"), check_vma=False)
    def env(c, v, si, gs):
        e = jx.sparse_env(c, v, si.reshape(nshards, -1), gs, "v",
                          nshards=nshards, budget=budget)
        return jax.tree.map(lambda x: x.reshape((1,) + x.shape), e)

    out = jax.jit(env)(jnp.asarray(comm), jnp.asarray(vdeg),
                       jnp.asarray(plan.send_idx.reshape(
                           nshards * nshards, plan.block)),
                       jnp.asarray(plan.ghost_sel.reshape(-1)))
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


@pytest.mark.parametrize("nshards,budget", [(4, 128), (4, 1), (2, 2)])
def test_sparse_env_matches_jax(rmat9, nshards, budget):
    """Every SparseEnv field bit for bit against the reference's, on an
    assignment whose communities span the shards: budget 128 holds, the
    budgets of 1 and 2 overflow."""
    dg = DistGraph.build(_port_graph(rmat9), nshards)
    plan = ExchangePlan.build(dg)
    nv_total = dg.total_padded_vertices
    rng = np.random.default_rng(nshards + budget)
    comm = rng.integers(0, nv_total // 3, nv_total).astype(np.int32)
    vdeg = dg.padded_weighted_degrees().astype(np.float32)
    ref = _jax_env(comm, vdeg, plan, nshards, budget)
    mesh = _cpu_mesh(nshards)
    envs = sparse_env(shard_1d(mesh, comm), shard_1d(mesh, vdeg),
                      *plan.to_mesh(mesh), mesh, budget=budget)
    for f in ref:
        got = np.stack([getattr(e, f).numpy() for e in envs])
        want = ref[f].reshape(got.shape)
        if f == "deg_local":   # f64 here, f32 there: equal values
            want = want.astype(np.float64)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert bool(ref["overflow"].any()) == (budget < 128)


def _pallas_sized(arrs, c, width):
    dst, w, verts, comm_ext, cdeg_ext, csize_ext, cdeg_v, vdeg, sl, _ = arrs
    n = len(verts)
    pad = (-n) % 128
    rows = np.concatenate([verts, np.full(pad, verts[-1], np.int32)])
    d = np.concatenate([dst, np.repeat(dst[-1:], pad, axis=0)])
    ww = np.concatenate([w, np.repeat(w[-1:], pad, axis=0)])
    out = row_argmax_pallas(
        jnp.asarray(np.ascontiguousarray(comm_ext[d].T)),
        jnp.asarray(np.ascontiguousarray(ww.T)),
        jnp.asarray(np.ascontiguousarray(cdeg_ext[d].T)),
        jnp.asarray(comm_ext[rows]), jnp.asarray(vdeg[rows]),
        jnp.asarray(sl[rows]), jnp.asarray(cdeg_v[rows] - vdeg[rows]),
        jnp.asarray(c), szT=jnp.asarray(np.ascontiguousarray(
            csize_ext[d].T)),
        sentinel=SENTINEL, tile_n=128, interpret=True)
    return [np.asarray(x)[:n] for x in out]


@pytest.mark.parametrize("width", [8, 32, 64, 256, 2048])
def test_size_form_twin_matches_pallas(width):
    """The size form's twin against the reference's szT kernel in
    interpret mode, with and without the row degrees (slots past them are
    padding slots): best_c, best_gain, counter0 and best_size bit-equal,
    including the no-candidate rows' sentinel size."""
    n_rows = 16 if width == 2048 else 128
    arrs, c = sized_case(n_rows, width, width + 11)
    ref = _pallas_sized(arrs, c, width)
    t = [torch.from_numpy(a) for a in arrs]
    for deg in (None, t[9]):
        got = row_argmax_sized(*t[:9], float(c), deg)
        for name, r, g in zip(("best_c", "best_gain", "counter0",
                               "best_size"), ref, got):
            assert np.array_equal(r, g.numpy()), name
    assert (ref[3][:4] == SENTINEL).all()


def _trajectory(runner, sweeps=4):
    comm, out = runner.comm0, []
    for _ in range(sweeps):
        res = runner.step(comm)
        assert not bool(res.overflow)
        out.append((torch.cat(res.targets).numpy(), float(res.modularity),
                    int(res.n_moved)))
        comm = res.targets
    return out


@pytest.mark.parametrize("nshards", [2, 8])
def test_sparse_equals_replicated_trajectory(rmat9, nshards):
    """tests/test_exchange.py:75 on the port: four sweeps of both
    exchanges, targets and move counts identical, Q to 1e-9; and the
    replicated sweeps' targets equal the reference's."""
    dg = DistGraph.build(_port_graph(rmat9), nshards)
    mesh = _cpu_mesh(nshards)
    rep = _trajectory(MeshPhaseRunner(dg, mesh, exchange="replicated"))
    spa = _trajectory(MeshPhaseRunner(dg, mesh, exchange="sparse"))
    for (t1, q1, m1), (t2, q2, m2) in zip(rep, spa):
        assert np.array_equal(t1, t2) and m1 == m2
        assert abs(q1 - q2) <= 1e-9
    jr = JPhaseRunner(JDistGraph.build(rmat9, nshards),
                      mesh=jax_mesh(nshards), engine="bucketed",
                      exchange="replicated")
    comm = jr.comm0
    for t, _, m in rep:
        out = jr._step(None, None, None, comm, jr.vdeg, jr.constant)
        assert np.array_equal(np.asarray(out[0]), t) and int(out[2]) == m
        comm = out[0]


def test_tiny_budget_overflows_and_driver_retries(rmat9):
    """tests/test_exchange.py:97 on the port: budget 1 overflows once
    communities span shards, and the driver's retry lands on the labels
    of the single-shard run."""
    dg = DistGraph.build(_port_graph(rmat9), 4)
    r = MeshPhaseRunner(dg, _cpu_mesh(4), exchange="sparse", budget=1)
    comm, seen = r.comm0, False
    for _ in range(4):
        res = r.step(comm)
        seen |= bool(res.overflow)
        comm = res.targets
    assert seen
    g = _port_graph(rmat9)
    r1 = louvain_phases(g, device="cpu")
    rn = louvain_phases(g, nshards=4, device="cpu", exchange="sparse",
                        exchange_budget=1)
    assert np.array_equal(rn.communities, r1.communities)
    assert abs(rn.modularity - r1.modularity) <= 1e-9


def test_full_run_sparse_rgg_matches_single():
    """tests/test_exchange.py:120 on the port: RGG 512 on 8 shards."""
    g = _port_graph(jax_rgg(512, seed=5))
    r1 = louvain_phases(g, device="cpu")
    rn = louvain_phases(g, nshards=8, device="cpu", exchange="sparse")
    assert np.array_equal(rn.communities, r1.communities)
    assert rn.exchange_stats["mode"] == "sparse"
    assert len(rn.exchange_stats["ghosts_per_shard"]) == 8


def test_exchange_auto_cutover(rmat9, monkeypatch):
    """tests/test_exchange.py:128 on the port: 'auto' resolves per phase by
    padded size; CUVITE_EXCHANGE_CUTOVER moves the cutover (a spy on
    ExchangePlan.build sees the sparse phases), a malformed value warns,
    and both resolutions cluster alike."""
    builds = []
    orig = ExchangePlan.build
    monkeypatch.setattr(port_driver.ExchangePlan, "build", staticmethod(
        lambda dg: (builds.append(dg.total_padded_vertices), orig(dg))[1]))
    g = _port_graph(rmat9)
    monkeypatch.delenv("CUVITE_EXCHANGE_CUTOVER", raising=False)
    assert port_driver.exchange_cutover() == 1 << 26
    rep = louvain_phases(g, nshards=4, device="cpu")
    assert builds == [] and rep.exchange_stats == {"mode": "replicated"}
    monkeypatch.setenv("CUVITE_EXCHANGE_CUTOVER", "0x200")
    spa = louvain_phases(g, nshards=4, device="cpu")
    assert builds and min(builds) >= 512
    assert spa.exchange_stats["mode"] == "sparse"
    assert np.array_equal(rep.communities, spa.communities)
    monkeypatch.setenv("CUVITE_EXCHANGE_CUTOVER", "lots")
    with pytest.warns(UserWarning, match="CUVITE_EXCHANGE_CUTOVER"):
        assert port_driver.exchange_cutover() == 1 << 26
