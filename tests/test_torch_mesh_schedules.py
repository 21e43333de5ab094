"""cuvite_tpu_torch's early termination, color schedules and checkpoints on
a vertex mesh, held against the JAX package's mesh on the CPU.

The pieces: ``sparse_env(info=)`` bit for bit against the reference's
under shard_map; each color class's per-shard plans against the
reference's ``build_stacked_plans(class_of=, class_id=)``; one class step
and the iteration's Q pass against ``make_sharded_class_step`` and
``make_sharded_bucketed_mod`` (the reference's replicated programs: its
sparse class programs crash long-lived test workers in JAX's compilation
cache).  Whole runs on 2 and 4 shards under both exchanges: labels and
iterations equal to the JAX mesh with the same arguments (Q to 1e-9,
both the host f64 oracle), and every mode equal to the port's one
shard.  Checkpoints: an interrupted run resumed on the
mesh equals the uninterrupted one, a mesh checkpoint crosses packages in
both directions, and another graph's is refused.

JAX runs on the conftest's 8 virtual CPU devices, the port on
make_mesh(devices=["cpu"] * S).  Every graph has unit or integer
weights, the exactness domain of the float sums.
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
from cuvite_tpu.core.graph import Graph as JGraph
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain import bucketed as jb
from cuvite_tpu.louvain.driver import PhaseRunner as JPhaseRunner
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.comm.exchange import ExchangePlan, sparse_env
from cuvite_tpu_torch.comm.mesh import make_mesh, shard_1d
from cuvite_tpu_torch.core.distgraph import DistGraph
from cuvite_tpu_torch.louvain.bucketed import (
    build_mesh_class_plans,
    build_stacked_plans,
    sharded_bucketed_modularity,
    sharded_bucketed_step,
)
from cuvite_tpu_torch.louvain.driver import MeshPhaseRunner, _color_classes

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def karate():
    nx = pytest.importorskip("networkx")
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int64)
    return JGraph.from_edges(34, e[:, 0], e[:, 1])


@pytest.fixture(scope="module")
def rmat9():
    return jax_rmat(9, edge_factor=8, seed=2)


def _port_graph(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _same_run(a, b, tol):
    assert np.array_equal(a.communities, b.communities)
    assert [p.iterations for p in a.phases] == \
        [p.iterations for p in b.phases]
    assert abs(a.modularity - b.modularity) <= tol


def _jax_env_info(comm, info, vdeg, plan, nshards, budget):
    """The reference's sparse_env(info=) under shard_map, every field
    gathered to [S, ...]."""
    mesh = jax_mesh(nshards)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P("v"),) * 5, out_specs=P("v"),
                       check_vma=False)
    def env(c, i, v, si, gs):
        e = jx.sparse_env(c, v, si.reshape(nshards, -1), gs, "v",
                          nshards=nshards, budget=budget, info=i)
        return jax.tree.map(lambda x: x.reshape((1,) + x.shape), e)

    out = jax.jit(env)(jnp.asarray(comm), jnp.asarray(info),
                       jnp.asarray(vdeg),
                       jnp.asarray(plan.send_idx.reshape(
                           nshards * nshards, plan.block)),
                       jnp.asarray(plan.ghost_sel.reshape(-1)))
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


@pytest.mark.parametrize("nshards,budget", [(4, 128), (2, 1)])
def test_sparse_env_info_matches_jax(rmat9, nshards, budget):
    """Vertex ordering's frozen tables: every SparseEnv field bit for bit
    against the reference's, the tables grouped by ``info`` and the
    requests by ``comm``; budget 128 holds, 1 overflows."""
    dg = DistGraph.build(_port_graph(rmat9), nshards)
    plan = ExchangePlan.build(dg)
    nv_total = dg.total_padded_vertices
    rng = np.random.default_rng(nshards + budget)
    comm = rng.integers(0, nv_total // 3, nv_total).astype(np.int32)
    info = rng.integers(0, nv_total // 2, nv_total).astype(np.int32)
    vdeg = dg.padded_weighted_degrees().astype(np.float32)
    ref = _jax_env_info(comm, info, vdeg, plan, nshards, budget)
    mesh = _cpu_mesh(nshards)
    envs = sparse_env(shard_1d(mesh, comm), shard_1d(mesh, vdeg),
                      *plan.to_mesh(mesh), mesh, budget=budget,
                      info=shard_1d(mesh, info))
    for f in ref:
        got = np.stack([getattr(e, f).numpy() for e in envs])
        want = ref[f].reshape(got.shape)
        if f == "deg_local":   # f64 here, f32 there: equal values
            want = want.astype(np.float64)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert bool(ref["overflow"].any()) == (budget < 128)
    # Without info the tables follow comm: info=comm is the plain env.
    plain = sparse_env(shard_1d(mesh, comm), shard_1d(mesh, vdeg),
                       *plan.to_mesh(mesh), mesh, budget=budget)
    same = sparse_env(shard_1d(mesh, comm), shard_1d(mesh, vdeg),
                      *plan.to_mesh(mesh), mesh, budget=budget,
                      info=shard_1d(mesh, comm))
    for a, b in zip(plain, same):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("exchange", ["replicated", "sparse"])
def test_class_plans_match_jax(rmat9, exchange):
    """Each color class's plan of each shard (build_mesh_class_plans)
    equals the class's block of the reference's
    build_stacked_plans(class_of=, class_id=) on its real rows; the
    classes' rows add up to the whole plan's."""
    S = 4
    jdg = JDistGraph.build(rmat9, S)
    g = _port_graph(rmat9)
    dg = DistGraph.build(g, S)
    cls, n = _color_classes(g, dg, 4, "cpu", False)
    assert len(cls) == dg.total_padded_vertices and n > 2
    jxp = xp = None
    if exchange == "sparse":
        jxp, xp = jx.ExchangePlan.build(jdg), ExchangePlan.build(dg)
    all_classes = build_mesh_class_plans(dg, cls, n, exchange_plan=xp)
    nvl = dg.nv_pad
    rows = 0
    for c in range(n):
        ref = jb.build_stacked_plans(jdg, exchange_plan=jxp, class_of=cls,
                                     class_id=c)
        plans = all_classes[c]
        widths = sorted({b.width for p in plans for b in p.buckets})
        assert widths == [b[1].shape[1] for b in ref.buckets]
        for (rv, rd, rw), width in zip(ref.buckets, widths):
            nb = len(rv) // S
            for r, p in enumerate(plans):
                blk = slice(r * nb, (r + 1) * nb)
                b = {x.width: x for x in p.buckets}.get(width)
                k = 0 if b is None else len(b.verts)
                if b is not None:
                    assert np.array_equal(b.verts, rv[blk][:k])
                    assert np.array_equal(b.dst, rd[blk][:k])
                    assert np.array_equal(b.w.astype(np.float32),
                                          rw[blk][:k])
                assert (rv[blk][k:] == nvl).all()
        assert np.array_equal(
            np.concatenate([p.self_loop for p in plans]), ref.self_loop)
        rows += sum(int(p.deg.sum()) for p in plans)
    assert rows == g.num_edges
    whole = build_stacked_plans(dg, exchange_plan=xp)
    assert rows == sum(int(p.deg.sum()) for p in whole)


@pytest.mark.parametrize("exchange", ["replicated", "sparse"])
@pytest.mark.parametrize("ordering", [False, True])
def test_class_step_and_mod_match_jax(karate, exchange, ordering):
    """Two iterations of the color schedule class by class: each class
    step's targets bit-equal to the reference's make_sharded_class_step
    from the same work and info vectors, its overflow flag likewise, and
    the iteration's Q pass to 1e-6 of make_sharded_bucketed_mod's (the
    reference's is f32).  Karate on 4 shards with coloring 4 leaves some
    shard with no row in some class.

    The port's sparse class steps are held against the reference's
    replicated ones (equal targets on both exchanges, as the reference's
    own schedule tests pin): its sparse class programs are its largest
    compiles, which crash a long-lived test worker in JAX's compilation
    cache (tests/test_schedules.py runs them in a fresh process, outside
    tier-1).  The sparse env they ride is held against the reference's
    bit for bit above."""
    S = 4
    g = _port_graph(karate)
    dg = DistGraph.build(g, S)
    cls, n = _color_classes(g, dg, 4, "cpu", False)
    jr = JPhaseRunner(JDistGraph.build(karate, S), mesh=jax_mesh(S),
                      engine="bucketed", exchange="replicated",
                      color_local=cls, n_color_classes=n, ordering=ordering)
    mesh = _cpu_mesh(S)
    r = MeshPhaseRunner(dg, mesh, exchange=exchange, classes=(cls, n),
                        ordering=ordering)
    assert len(r.class_plans) == len(jr._class_plans) == n
    empty = [not mp.plans[i].buckets and mp.plans[i].heavy is None
             for mp in r.class_plans for i in range(S)]
    assert any(empty)
    pargs = jr._class_plan_args
    comm = jr.comm0
    comms = shard_1d(mesh, np.asarray(comm))
    for _ in range(2):
        jmod = jr._mod_fn(*jr._mod_args, comm, jr.vdeg, jr.constant, *pargs)
        q, ovf = sharded_bucketed_modularity(r.class_plans, comms, r.vdeg,
                                             r.constant)
        assert not bool(ovf)
        assert abs(float(jmod) - float(q)) <= 1e-6
        work, works = comm, comms
        for (bk, hv, sl, pm, stepf), mp in zip(jr._class_plans,
                                               r.class_plans):
            t, _, _, jo = stepf(bk, hv, sl, work,
                                comm if ordering else work, jr.vdeg,
                                jr.constant, pm, *pargs)
            res = sharded_bucketed_step(
                mp, works, r.vdeg, r.constant,
                info_comms=comms if ordering else None)
            assert np.array_equal(np.asarray(t),
                                  torch.cat(res.targets).numpy())
            assert bool(jo) == bool(res.overflow)
            work, works = t, res.targets
        assert not np.array_equal(np.asarray(work), np.asarray(comm))
        comm, comms = work, works


# Whole runs against the JAX mesh: the options on karate, each exchange
# and shard count at least once.  The color schedules run the
# reference's replicated exchange only (its sparse class programs crash
# long-lived test workers; see test_class_step_and_mod_match_jax); the
# port's sparse runs of them equal its replicated ones and one shard's
# below.
_JAX_CASES = [
    ({"et_mode": 1}, "replicated", 2),
    ({"et_mode": 2, "et_delta": 0.9}, "sparse", 4),
    ({"et_mode": 3}, "replicated", 4),
    ({"et_mode": 4, "et_delta": 0.9}, "sparse", 2),
    ({"coloring": 4}, "replicated", 4),
    ({"vertex_ordering": 4}, "replicated", 2),
]


@pytest.mark.parametrize("kw,exchange,nshards", _JAX_CASES)
def test_mesh_runs_match_jax(karate, kw, exchange, nshards):
    """louvain_phases on the mesh with ET or a color schedule: labels,
    iterations and Q (1e-9) equal to the JAX mesh's with the same
    arguments, to the port's one shard, and (the color schedules) to the
    port's sparse exchange."""
    g = _port_graph(karate)
    got = louvain_phases(g, device="cpu", nshards=nshards,
                         exchange=exchange, **kw)
    _same_run(got, jax_louvain(karate, nshards=nshards, exchange=exchange,
                               **kw), 1e-9)
    _same_run(got, louvain_phases(g, device="cpu", **kw), 1e-9)
    assert got.exchange_stats["mode"] == exchange
    if "et_mode" not in kw:
        _same_run(louvain_phases(g, device="cpu", nshards=nshards,
                                 exchange="sparse", **kw), got, 1e-9)


@pytest.mark.parametrize("kw", [
    {"et_mode": 1}, {"et_mode": 2, "et_delta": 0.9}, {"et_mode": 3},
    {"et_mode": 4, "et_delta": 0.25}, {"coloring": 8},
    {"vertex_ordering": 8}, {"coloring": 4, "et_mode": 3}])
def test_mesh_runs_match_one_shard(rmat9, kw):
    """Every mode on R-MAT 9 at 2 shards and at 4 edge-balanced ones, both
    exchanges: labels, iterations, convergence rows and Q equal to one
    shard's; the sweeps' moved counts too."""
    g = _port_graph(rmat9)
    one = louvain_phases(g, device="cpu", **kw)
    for S, balanced in ((2, False), (4, True)):
        for exchange in ("replicated", "sparse"):
            got = louvain_phases(g, device="cpu", nshards=S,
                                 exchange=exchange, balanced=balanced, **kw)
            _same_run(got, one, 1e-9)
            for a, b in zip(got.convergence, one.convergence):
                assert [(r.q, r.moved) for r in a.rows] == \
                    [(r.q, r.moved) for r in b.rows]


def test_sparse_class_schedule_retries_overflow(rmat9, capsys):
    """Vertex ordering under the sparse exchange with a budget of 1: the
    class steps' overflow (the frozen grouping's included) re-runs the
    phase with a grown budget, and the labels equal the unbudgeted run's."""
    g = _port_graph(rmat9)
    want = louvain_phases(g, device="cpu", vertex_ordering=8)
    got = louvain_phases(g, device="cpu", nshards=4, exchange="sparse",
                         exchange_budget=1, vertex_ordering=8, verbose=True)
    assert "budget overflow" in capsys.readouterr().out
    _same_run(got, want, 1e-9)


def test_mesh_checkpoint_resume(rmat9, tmp_path):
    """max_phases=1 and then resume on the mesh equals the uninterrupted
    mesh run: coloring under the sparse exchange on 4 shards and ET mode
    3 under the replicated one on 2, resumed on another shard count."""
    g = _port_graph(rmat9)
    for i, (kw, s1, s2, ex) in enumerate((
            ({"coloring": 8}, 4, 2, "sparse"),
            ({"et_mode": 3}, 2, 4, "replicated"))):
        d = str(tmp_path / f"ck{i}")
        full = louvain_phases(g, device="cpu", nshards=s1, exchange=ex, **kw)
        part = louvain_phases(g, device="cpu", nshards=s1, exchange=ex,
                              checkpoint_dir=d, max_phases=1, **kw)
        assert len(part.phases) == 1 and len(full.phases) > 1
        res = louvain_phases(g, device="cpu", nshards=s2, exchange=ex,
                             checkpoint_dir=d, resume=True, **kw)
        _same_run(res, full, 1e-9)
        # The resumed phases' host Q sums over another shard layout.
        assert np.allclose([p.modularity for p in res.phases],
                           [p.modularity for p in full.phases], rtol=0,
                           atol=1e-12)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mesh_checkpoint_crosses_packages(karate, tmp_path, writer):
    """A JAX mesh run's phase-1 checkpoint resumed by the port's mesh, and
    the port mesh's resumed by the JAX mesh: labels equal the port's
    uninterrupted mesh run."""
    g = _port_graph(karate)
    d = str(tmp_path / "ck")
    kw = dict(nshards=2, exchange="replicated")
    full = louvain_phases(g, device="cpu", **kw)
    if writer == "jax":
        jax_louvain(karate, checkpoint_dir=d, max_phases=1, **kw)
        res = louvain_phases(g, device="cpu", checkpoint_dir=d, resume=True,
                             **kw)
    else:
        louvain_phases(g, device="cpu", checkpoint_dir=d, max_phases=1,
                       **kw)
        res = jax_louvain(karate, checkpoint_dir=d, resume=True, **kw)
    _same_run(res, full, 1e-9)


def test_mesh_resume_refuses_another_graph(rmat9, tmp_path):
    """A mesh checkpoint of one R-MAT 9 resumed for another seed's raises
    the fingerprint mismatch."""
    d = str(tmp_path / "ck")
    louvain_phases(_port_graph(rmat9), device="cpu", nshards=2,
                   checkpoint_dir=d, max_phases=1)
    other = _port_graph(jax_rmat(9, edge_factor=8, seed=3))
    with pytest.raises(ValueError, match="fingerprint"):
        louvain_phases(other, device="cpu", nshards=2, checkpoint_dir=d,
                       resume=True)
