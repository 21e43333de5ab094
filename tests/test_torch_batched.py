"""cuvite_tpu_torch's batched multi-tenant engine (``louvain_many``) held
against the JAX package's on the CPU: the same numpy graphs go into both.

The job set is the reference's own (tests/test_batched.py): two R-MAT 8
graphs and two synthesized power-law graphs, class (4096, 16384), mixing
convergence lengths.  Every tenant's labels, phases and iterations equal
the JAX ``louvain_many``'s, Q is within 1e-6 (the port's in-loop Q is
f64, the reference's f32), ``phase_engines`` is the same, and every
tenant equals its own B=1 run bit for bit.  One batched bucketed sweep is
held against ``jax.vmap`` of the reference's ``bucketed_step``.  The batch
axis on a mesh of CPU blocks (``make_batch_mesh(B, devices=["cpu"] * n)``)
gives every tenant the labels of ``mesh=None``, of its B=1 run and of the
reference's ``louvain_many(mesh="auto")`` on its 8 devices, for
``louvain_many``, ``cluster_packed`` and the serving queue.  Every graph
has integer weights, the exactness domain of the float sums.
"""

import jax
import numpy as np
import pytest
import torch

from cuvite_tpu.core import batch as jbatch
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain import batched as jbatched
from cuvite_tpu.louvain.driver import louvain_many as jax_many
from cuvite_tpu.workloads.synth import many_seed as jax_many_seed
from cuvite_tpu.workloads.synth import synthesize_graph as jax_synth
from cuvite_tpu_torch import Graph, louvain_many
from cuvite_tpu_torch.core import batch as pbatch
from cuvite_tpu_torch.kernels.heavy_bincount import (
    build_heavy_layout,
    heavy_argmax_plain,
)
from cuvite_tpu_torch.kernels.row_argmax import row_argmax_plain
from cuvite_tpu_torch.kernels.seg_coalesce import (
    dense_accumulate_plain,
)
from cuvite_tpu_torch.louvain import batched as pbatched
from cuvite_tpu_torch.louvain.bucketed import DevicePlan, bucketed_step
from cuvite_tpu_torch.ops.segment import (
    coalesced_runs,
    coalesced_runs_batched,
)
from cuvite_tpu_torch.utils.trace import Tracer

from test_torch_cuda import one_torch_thread  # noqa: F401
from test_torch_rebin import assert_plans_equal

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ENGINES = ("fused", "bucketed")


@pytest.fixture(autouse=True)
def _free_jax_programs():
    """The reference compiles a program per slab class; free them after
    each test, so a test worker does not accumulate their memory maps."""
    yield
    jax.clear_caches()


def _port(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


@pytest.fixture(scope="module")
def jobs():
    """tests/test_batched.py's job set, as (JAX graphs, port graphs)."""
    gs = [jax_rmat(8, edge_factor=8, seed=s) for s in (1, 2)]
    gs += [jax_synth(2048, seed=jax_many_seed(7, k)) for k in (0, 1)]
    return gs, [_port(g) for g in gs]


@pytest.fixture(scope="module")
def jax_runs(jobs):
    return {e: jax_many(jobs[0], engine=e, mesh=None) for e in ENGINES}


@pytest.fixture(scope="module")
def port_runs(jobs):
    return {e: louvain_many(jobs[1], engine=e, device="cpu")
            for e in ENGINES}


@pytest.fixture(scope="module")
def hub_jobs():
    """The hub graph of tests/test_torch_louvain.py (a vertex of degree
    8400, above the widest bucket) beside an R-MAT 8 graph, both in its
    class (16384, 65536)."""
    from cuvite_tpu.core.graph import Graph as JGraph

    rng = np.random.default_rng(0)
    nv = 9000
    hub_dst = rng.choice(np.arange(1, nv), size=8400, replace=False)
    src = np.concatenate([np.zeros(8400, np.int64),
                          rng.integers(1, nv, 12000)])
    dst = np.concatenate([hub_dst, rng.integers(1, nv, 12000)])
    gs = [JGraph.from_edges(nv, src, dst), jax_rmat(8, edge_factor=8,
                                                    seed=5)]
    return gs, [_port(g) for g in gs]


def _same_run(mine, ref, q_tol=1e-6):
    assert np.array_equal(mine.communities, ref.communities)
    assert [p.iterations for p in mine.phases] == \
        [p.iterations for p in ref.phases]
    assert mine.total_iterations == ref.total_iterations
    assert abs(mine.modularity - ref.modularity) <= q_tol


# ---------------------------------------------------------------------------
# Packing


def test_batch_slabs_match_jax(jobs):
    """The stacked slabs, the pad row of a 3-job batch and every per-row
    scalar equal the reference's, array for array."""
    for n in (4, 3):
        ref = jbatch.batch_slabs(jobs[0][:n])
        mine = pbatch.batch_slabs(jobs[1][:n])
        assert mine.slab_class == ref.slab_class == (4096, 16384)
        assert (mine.b_pad, mine.n_jobs) == (ref.b_pad, ref.n_jobs) == (4, n)
        for name in ("src", "dst", "w", "real_mask", "constant",
                     "row_valid", "nv_real", "ne_real", "tw2"):
            a, b = getattr(mine, name), np.asarray(getattr(ref, name))
            assert a.dtype == b.dtype, name
            assert np.array_equal(a, b), name
    assert not mine.row_valid[3] and (mine.src[3] == 4096).all()
    assert mine.pack_util == 0.75


def test_batch_pad_ladder_and_refusals(jobs):
    assert pbatch.BATCH_SIZES == jbatch.BATCH_SIZES
    assert pbatch.BATCH_ENGINES == jbatch.BATCH_ENGINES
    assert [pbatch.batch_pad(n) for n in (1, 2, 3, 5, 8, 9, 64, 65)] == \
        [jbatch.batch_pad(n) for n in (1, 2, 3, 5, 8, 9, 64, 65)]
    with pytest.raises(ValueError):
        pbatch.batch_pad(0)
    big = _port(jax_rmat(13, edge_factor=8, seed=1))
    assert pbatch.slab_class_of(big) == jbatch.slab_class_of(
        jax_rmat(13, edge_factor=8, seed=1))
    with pytest.raises(ValueError, match="mixed slab classes"):
        pbatch.batch_slabs([jobs[1][0], big])
    with pytest.raises(ValueError, match="do not fit"):
        pbatch.batch_slabs([big], slab_class=(4096, 16384))
    with pytest.raises(ValueError, match="b_pad"):
        louvain_many(jobs[1], b_pad=2, device="cpu")


def test_bucket_shape_matches_jax_pin_and_refusal(jobs):
    """The plan geometry, from degrees and from the built plans, equals
    the reference's; a pinned shape that covers the batch runs, one that
    does not is refused."""
    shape = pbatch.bucket_shape_for(jobs[1])
    ref = jbatch.bucket_shape_for(jobs[0])
    assert (shape.widths, shape.rows, shape.heavy_pad) == \
        (ref.widths, ref.rows, ref.heavy_pad)
    plans = pbatch.batch_bucket_plans(pbatch.batch_slabs(jobs[1]))
    assert plans.shape == shape
    # The geometry the built plans hold: each width's padded rows, the
    # heavy pad.
    built: dict = {}
    for p in plans.plans:
        for bk in p.buckets:
            built[bk.width] = max(built.get(bk.width, 0), len(bk.verts))
    assert (tuple(sorted(built)), tuple(built[w] for w in sorted(built)),
            max(max(len(p.heavy_src) for p in plans.plans), 8)) == \
        (shape.widths, shape.rows, shape.heavy_pad)
    jplans = jbatch.batch_bucket_plans(jbatch.batch_slabs(jobs[0]))
    assert plans.shape.rows == jplans.shape.rows
    # The class is rebin_eligible: phase 0's plan is built on the device,
    # and the pin is checked against the rows' degrees.
    tr = Tracer()
    br = louvain_many(jobs[1][:1], engine="bucketed", bucket_shape=shape,
                      device="cpu", tracer=tr)
    assert tr.counters["batch_device_plans"] == \
        tr.counters["batch_plans"] == 1
    solo = louvain_many(jobs[1][:1], engine="bucketed", device="cpu")
    assert np.array_equal(br.results[0].communities,
                          solo.results[0].communities)
    tiny = pbatch.BucketShape(widths=(8,), rows=(1,), heavy_pad=8)
    with pytest.raises(ValueError, match="does not fit"):
        louvain_many(jobs[1], engine="bucketed", bucket_shape=tiny,
                     device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        pbatch.batch_bucket_plans(pbatch.batch_slabs(jobs[1]), shape=tiny)
    assert pbatch.union_shapes(tiny, shape).fits(shape)


# ---------------------------------------------------------------------------
# Whole batches


@pytest.mark.parametrize("engine", ENGINES)
def test_many_matches_jax(engine, jax_runs, port_runs):
    mine, ref = port_runs[engine], jax_runs[engine]
    assert mine.phase_engines == ref.phase_engines
    assert mine.coarse_class == ref.coarse_class
    assert (mine.n_phases, mine.b_pad, mine.n_jobs, mine.slab_class) == \
        (ref.n_phases, ref.b_pad, ref.n_jobs, ref.slab_class)
    assert len({len(r.phases) for r in mine.results}) > 1
    for m, r in zip(mine.results, ref.results):
        _same_run(m, r)
        assert [p.num_vertices for p in m.phases] == \
            [p.num_vertices for p in r.phases]
        assert [pc.gained for pc in m.convergence] == \
            [pc.gained for pc in r.convergence]


def test_bucketed_engines_record(jax_runs, port_runs):
    """Phase 0 bucketed, coarse phases re-binned on the device at the
    serving-coarse class; the dense coalesce coarsens every phase."""
    eng = port_runs["bucketed"].phase_engines
    assert eng[0] == "bucketed" and len(eng) >= 2
    assert all(e == "rebinned" for e in eng[1:])
    assert port_runs["bucketed"].coarse_class == (1024, 4096)
    assert all(e == "fused" for e in port_runs["fused"].phase_engines)
    assert set(port_runs["fused"].coalesce) == {"dense"}


@pytest.mark.parametrize("engine", ENGINES)
def test_many_bit_identical_to_b1(engine, jobs, port_runs):
    for g, rb in zip(jobs[1], port_runs[engine].results):
        r1 = louvain_many([g], engine=engine, device="cpu").results[0]
        assert r1.modularity == rb.modularity
        assert np.array_equal(r1.communities, rb.communities)
        assert r1.total_iterations == rb.total_iterations
        assert len(r1.phases) == len(rb.phases)


def test_rebin_off_runs_fused_coarse_phases(jobs, jax_runs, monkeypatch):
    monkeypatch.setenv("CUVITE_DEVICE_REBIN", "0")
    br = louvain_many(jobs[1], engine="bucketed", device="cpu")
    assert br.phase_engines[0] == "bucketed"
    assert all(e == "fused" for e in br.phase_engines[1:])
    for m, r in zip(br.results, jax_runs["bucketed"].results):
        _same_run(m, r)


# ---------------------------------------------------------------------------
# Phase 0's plan built on the device at pack time


def _isolated_graph(seed: int) -> Graph:
    """A graph whose vertices 700-1499 and 2900-2999 have no edge."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.arange(700), np.arange(1500, 2900)])
    src, dst = rng.choice(ids, 6000), rng.choice(ids, 6000)
    keep = src != dst
    return Graph.from_edges(3000, src[keep], dst[keep])


def _hub_graph() -> Graph:
    """64 vertices, vertex 0 joined to each other one by ~143 repeated
    CSR entries: 9,009 in all, a degree above the widest bucket in the
    class (4096, 32768), which a coalesced slab of that class never
    has."""
    nv, rep = 64, 143
    others = np.arange(1, nv)
    tails = [np.repeat(others, rep)] + [np.full(rep, 0) for _ in others]
    counts = [len(t) for t in tails]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    tails = np.concatenate(tails)
    return Graph.from_arrays(offsets, tails, np.ones(len(tails), np.float32))


PHASE0_CASES = ("jobs", "padded", "isolated", "two-blocks")


def _phase0_case(case: str, jobs) -> tuple:
    """(graphs, mesh) of a batch whose class is ``rebin_eligible``."""
    if case == "padded":
        return jobs[1][:3], None
    if case == "isolated":
        return [_isolated_graph(1), jobs[1][0], _isolated_graph(2)], None
    if case == "two-blocks":
        return jobs[1], pbatched.make_batch_mesh(4, devices=["cpu"] * 2)
    return jobs[1], None


@pytest.mark.parametrize("case", PHASE0_CASES)
def test_phase0_plan_on_device_equals_host_plans(case, jobs):
    """The bucketed engine's phase-0 plan, built on the device from each
    block's uploaded slab, equals that block's host plans folded and
    uploaded, tensor for tensor; every block counts one plan built on
    the device."""
    graphs, mesh = _phase0_case(case, jobs)
    tr = Tracer()
    pm = pbatched.pack_many(graphs, engine="bucketed", mesh=mesh,
                            device="cpu", tracer=tr)
    batch = pbatch.batch_slabs(graphs)
    assert pbatched.rebin_eligible(batch.nv_pad, batch.ne_pad)
    blocks = pm.prep.blocks
    per = batch.b_pad // len(blocks)
    for k, blk in enumerate(blocks):
        rows = pbatched._rows(batch, k * per, (k + 1) * per)
        want = DevicePlan.upload(pbatch.batch_bucket_plans(rows).fold(),
                                 "cpu")
        assert_plans_equal(blk.plan, want)
    assert tr.counters["batch_plans"] == \
        tr.counters["batch_device_plans"] == len(blocks)
    if case == "padded":
        assert batch.b_pad > batch.n_jobs
    if case == "isolated":
        assert (np.bincount(batch.src[0], minlength=batch.nv_pad + 1)[
            700:1500] == 0).all()


@pytest.mark.parametrize("case", PHASE0_CASES)
def test_phase0_plan_on_device_keeps_every_run(case, jobs, monkeypatch):
    """Every tenant's labels, Q and iterations are the same bits with
    ``CUVITE_DEVICE_REBIN`` off (host plans, fused coarse phases) and on
    (device plans), and the counters show which path ran."""
    graphs, mesh = _phase0_case(case, jobs)
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("CUVITE_DEVICE_REBIN", flag)
        tr = Tracer()
        br = louvain_many(graphs, engine="bucketed", mesh=mesh,
                          device="cpu", tracer=tr)
        runs[flag] = br, tr.counters
    (off, c_off), (on, c_on) = runs["0"], runs["1"]
    assert off.phase_engines[0] == on.phase_engines[0] == "bucketed"
    assert c_off["batch_plans"] == c_on["batch_plans"] > 0
    assert c_off.get("batch_device_plans", 0) == 0
    assert c_on["batch_device_plans"] == c_on["batch_plans"]
    for a, b in zip(on.results, off.results):
        assert np.array_equal(a.communities, b.communities)
        assert a.modularity == b.modularity
        assert a.total_iterations == b.total_iterations
        assert [p.iterations for p in a.phases] == \
            [p.iterations for p in b.phases]


@pytest.mark.parametrize("case", ("class-16384", "hub-tenant"))
def test_ineligible_batches_keep_the_host_plan(case, jobs, monkeypatch):
    """A class above the widest bucket, and a tenant with a vertex of
    degree above it in an eligible class, keep the host plans: no plan
    is counted as built on the device, the plan equals the folded host
    plans, and the runs equal those under ``CUVITE_DEVICE_REBIN=0``."""
    if case == "class-16384":
        graphs, cls = jobs[1][:2], (16384, 65536)
        assert not pbatched.rebin_eligible(*cls)
    else:
        graphs, cls = [_hub_graph(), jobs[1][0]], (4096, 32768)
        assert pbatched.rebin_eligible(*cls)
        assert _hub_graph().degrees().max() > pbatch.DEFAULT_BUCKETS[-1]
    tr = Tracer()
    pm = pbatched.pack_many(graphs, engine="bucketed", slab_class=cls,
                            device="cpu", tracer=tr)
    assert tr.counters["batch_plans"] == 1
    assert tr.counters.get("batch_device_plans", 0) == 0
    batch = pbatch.batch_slabs(graphs, slab_class=cls)
    want = DevicePlan.upload(pbatch.batch_bucket_plans(batch).fold(), "cpu")
    assert_plans_equal(pm.prep.plan, want)
    assert (want.heavy is not None) == (case == "hub-tenant")
    mine = pbatched.execute_many(pm)
    monkeypatch.setenv("CUVITE_DEVICE_REBIN", "0")
    ref = louvain_many(graphs, engine="bucketed", slab_class=cls,
                       device="cpu")
    for a, b in zip(mine.results, ref.results):
        assert np.array_equal(a.communities, b.communities)
        assert a.modularity == b.modularity


def test_edgeless_rows_short_circuit(jobs):
    from cuvite_tpu.core.graph import Graph as JGraph

    empty = JGraph.from_edges(5, np.zeros(0, np.int64),
                              np.zeros(0, np.int64))
    ref = jax_many([jobs[0][0], empty, jobs[0][1]], mesh=None)
    br = louvain_many([jobs[1][0], _port(empty), jobs[1][1]], device="cpu")
    assert len(br.results) == 3 and br.n_jobs == 2
    assert br.results[1].modularity == 0.0
    assert np.array_equal(br.results[1].communities, np.arange(5))
    for m, r in zip(br.results, ref.results):
        _same_run(m, r)
    only = louvain_many([_port(empty)], device="cpu")
    assert only.n_jobs == 0 and only.results[0].modularity == 0.0


def test_hub_tenant_drives_heavy_twin(hub_jobs, monkeypatch):
    """A batch holding the hub graph: its hub goes through the heavy twin
    with its tenant's constant, once per phase-0 sweep, and both tenants
    match the JAX louvain_many and their own B=1 runs."""
    calls = []
    orig = heavy_argmax_plain

    def spy(lay, *args):
        calls.append(lay.num_hubs)
        return orig(lay, *args)

    monkeypatch.setattr("cuvite_tpu_torch.kernels.heavy_bincount."
                        "heavy_argmax_plain", spy)
    cls = (16384, 65536)
    br = louvain_many(hub_jobs[1], engine="bucketed", slab_class=cls,
                      device="cpu")
    # One launch of one hub per phase-0 sweep of the batch.
    assert calls == [1] * max(r.convergence[0].iterations
                              for r in br.results)
    monkeypatch.undo()
    ref = jax_many(hub_jobs[0], engine="bucketed", slab_class=cls,
                   mesh=None)
    assert br.phase_engines == ref.phase_engines
    for m, r, g in zip(br.results, ref.results, hub_jobs[1]):
        _same_run(m, r)
        solo = louvain_many([g], engine="bucketed", slab_class=cls,
                            device="cpu").results[0]
        assert solo.modularity == m.modularity
        assert np.array_equal(solo.communities, m.communities)


def test_mesh_and_engine_refusals(jobs, port_runs):
    with pytest.raises(ValueError, match="make_batch_mesh"):
        louvain_many(jobs[1], mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="equal blocks"):
        louvain_many(jobs[1], b_pad=6, device="cpu",
                     mesh=pbatched.make_batch_mesh(8, devices=["cpu"] * 4))
    two = louvain_many(jobs[1], mesh=pbatched.make_batch_mesh(
        4, devices=["cpu"] * 2), device="cpu")
    for a, b in zip(two.results, port_runs["fused"].results):
        assert np.array_equal(a.communities, b.communities)
    with pytest.raises(ValueError, match="engine"):
        louvain_many(jobs[1], engine="sorted", device="cpu")
    br = louvain_many(jobs[1][:1], mesh=None, device="cpu")
    assert br.n_jobs == 1 and pbatched.accum_class_of(jobs[1][0]) == \
        "float64"


def test_louvain_many_without_cuda_raises(jobs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        louvain_many(jobs[1])


# ---------------------------------------------------------------------------
# One batched sweep against jax.vmap of the reference's bucketed_step


def _counter0_oracle(g, comm):
    src = g.sources().astype(np.int64)
    same = comm[src] == comm[g.tails.astype(np.int64)]
    return np.bincount(src[same], weights=g.weights[same].astype(np.float64),
                       minlength=len(comm))


def test_one_batched_sweep_matches_vmap(jobs):
    """Targets and moved counts of every tenant equal ``jax.vmap`` of the
    reference's bucketed_step over its batched plans, from the identity
    and from the assignment one sweep later; counter0 equals the f64
    definition."""
    import jax.numpy as jnp

    from cuvite_tpu.louvain.driver import _bucketed_call
    from cuvite_tpu.ops import segment as jseg

    jb = jbatch.batch_slabs(jobs[0])
    jplan = jbatch.batch_bucket_plans(jb)
    nv = jb.nv_pad
    b = jb.b_pad
    call = _bucketed_call(nv, int(np.iinfo(np.int32).max), "float32")
    buckets = tuple((jnp.asarray(v.astype(np.int32)), jnp.asarray(d),
                     jnp.asarray(w)) for v, d, w in jplan.buckets)
    heavy = tuple(jnp.asarray(a) for a in jplan.heavy)

    def one(bk, hv, sl, pm, s, ww, c, comm):
        vdeg = jseg.segment_sum(ww, s, num_segments=nv, sorted_ids=True)
        t, _m, moved, _o = call(comm, (bk, hv, sl, vdeg, c, pm, None))
        return t, moved

    vstep = jax.jit(jax.vmap(one))

    pb = pbatch.batch_slabs(jobs[1])
    plan = DevicePlan.upload(pbatch.batch_bucket_plans(pb).fold(), "cpu")
    src_f, _, w_f = pbatch.fold_slab(
        torch.from_numpy(pb.src), torch.from_numpy(pb.dst),
        torch.from_numpy(pb.w), nv_pad=nv)
    vdeg = torch.zeros(b * nv + 1, dtype=torch.float64).index_add_(
        0, src_f.long(), w_f.double())[:-1].float()
    consts = pbatched._constants(pb.tw2, "cpu")
    comm = np.broadcast_to(np.arange(nv, dtype=np.int32), (b, nv)).copy()
    for _ in range(2):
        t_ref, moved_ref = vstep(
            buckets, heavy, jnp.asarray(jplan.self_loop),
            jnp.asarray(jplan.perm), jnp.asarray(jb.src), jnp.asarray(jb.w),
            jnp.asarray(jb.constant), jnp.asarray(comm))
        folded = comm + np.arange(b, dtype=np.int32)[:, None] * nv
        res = bucketed_step(plan, torch.from_numpy(folded.reshape(-1)),
                            vdeg, consts, nv_total=b * nv)
        target = res.target.numpy().reshape(b, nv) \
            - np.arange(b, dtype=np.int32)[:, None] * nv
        assert np.array_equal(target, np.asarray(t_ref))
        assert np.array_equal(res.n_moved.numpy(), np.asarray(moved_ref))
        c0 = res.counter0.numpy().reshape(b, nv)
        for i, g in enumerate(jobs[0]):
            n = g.num_vertices
            want = _counter0_oracle(g, comm[i, :n]).astype(np.float32)
            assert np.array_equal(c0[i, :n], want)
        comm = target


# ---------------------------------------------------------------------------
# The batched forms of the kernels' twins


def test_batched_row_and_heavy_twins_take_each_tenants_constant():
    """With a [B] constant tensor over a folded id space, each row and hub
    equals the one-graph twin given its own tenant's constant."""
    rng = np.random.default_rng(11)
    b, nvp, width, n_rows = 4, 64, 16, 40
    nv = b * nvp
    comm = (rng.integers(0, nvp, nv) + np.repeat(np.arange(b), nvp) * nvp
            ).astype(np.int32)
    comm_deg = (rng.integers(1, 256, nv) / 8.0).astype(np.float32)
    vdeg = (rng.integers(1, 64, nv) / 4.0).astype(np.float32)
    sl = np.zeros(nv, np.float32)
    verts = rng.integers(0, nv, n_rows).astype(np.int32)
    dst = ((verts // nvp)[:, None] * nvp
           + rng.integers(0, nvp, (n_rows, width))).astype(np.int32)
    w = (rng.integers(1, 32, (n_rows, width)) / 16.0).astype(np.float32)
    consts = np.array([0.3, 1 / 64, 1 / 1000, 0.0], np.float32)
    t = [torch.from_numpy(a) for a in (dst, w, verts, comm, comm_deg, vdeg,
                                       sl)]
    got = row_argmax_plain(*t, torch.from_numpy(consts))
    for tenant in range(b):
        rows = np.flatnonzero(verts // nvp == tenant)
        one = row_argmax_plain(t[0][rows], t[1][rows], t[2][rows], *t[3:],
                               float(consts[tenant]))
        for x, y in zip(got, one):
            assert torch.equal(x[rows], y)
    # Hubs of two tenants in one layout.
    hs = np.concatenate([np.full(9000, 5), np.full(9100, 2 * nvp + 7)])
    hd = np.concatenate([rng.integers(0, nvp, 9000),
                         2 * nvp + rng.integers(0, nvp, 9100)])
    hw = (rng.integers(1, 32, len(hs)) / 16.0).astype(np.float32)
    lay = build_heavy_layout(hs, hd, hw, nv_local=nv)
    tabs = t[3:]
    got = heavy_argmax_plain(lay, *tabs, torch.from_numpy(consts))
    for k, tenant in enumerate((0, 2)):
        one = heavy_argmax_plain(lay, *tabs, float(consts[tenant]))
        for x, y in zip(got, one):
            assert torch.equal(x[k], y[k])


def test_batched_coalesce_matches_per_tenant_and_jax():
    """The batched dense twin equals each tenant's batch of one; the
    batched coalesce, dense and sort, equals per-tenant coalesced_runs
    and the reference's coalesced_runs; a pure-padding tenant stays
    empty."""
    import jax.numpy as jnp

    from cuvite_tpu.ops.segment import coalesced_runs as jax_coalesced

    rng = np.random.default_rng(5)
    b, nvp, ne = 4, 256, 2048
    src = np.full((b, ne), nvp, np.int32)
    dst = np.zeros((b, ne), np.int32)
    w = np.zeros((b, ne), np.float32)
    for i in range(3):
        n = ne - 100 * (i + 1)
        pool = rng.choice(nvp, size=20 + 30 * i, replace=False)  # gapped
        src[i, :n] = np.sort(rng.choice(pool, n))
        dst[i, :n] = rng.choice(pool, n)
        w[i, :n] = rng.integers(1, 64, n) / 8.0
    ts = [torch.from_numpy(a) for a in (src, dst, w)]
    acc, cnt = dense_accumulate_plain(*ts, grid=nvp)
    for i in range(b):
        a1, c1 = dense_accumulate_plain(ts[0][i:i + 1], ts[1][i:i + 1],
                                        ts[2][i:i + 1], grid=nvp)
        assert torch.equal(acc[i], a1[0]) and torch.equal(cnt[i], c1[0])
    outs = {e: coalesced_runs_batched(*ts, nv_pad=nvp, engine=e, grid=nvp)
            for e in ("dense", "sort")}
    for i in range(b):
        one = coalesced_runs(ts[0][i], ts[1][i], ts[2][i], nv_pad=nvp)
        ref = jax_coalesced(jnp.asarray(src[i]), jnp.asarray(dst[i]),
                            jnp.asarray(w[i]), nv_pad=nvp)
        for e, out in outs.items():
            n = int(out[3][i])
            assert n == one[3] == int(ref[3]), e
            for x, y, r in zip(out[:3], one[:3], ref[:3]):
                assert torch.equal(x[i], y), e
                assert np.array_equal(x[i].numpy(), np.asarray(r)), e
    assert int(outs["dense"][3][3]) == 0
    assert (outs["dense"][0][3] == nvp).all()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_make_batch_mesh_matches_jax(n):
    """The block count of every b_pad over n devices is the reference's
    (None where it has no mesh)."""
    for b in (1, 3, 4, 6, 64):
        ref = jbatched.make_batch_mesh(b, devices=jax.devices()[:n])
        got = pbatched.make_batch_mesh(b, devices=["cpu"] * n)
        assert (None if ref is None else ref.devices.size) == \
            (None if got is None else got.size), (b, n)
    assert pbatched.make_batch_mesh(64, devices=["cpu"] * n) is None or \
        pbatched.make_batch_mesh(64, devices=["cpu"] * n).axis_name == \
        pbatched.BATCH_AXIS


@pytest.mark.parametrize("engine", ENGINES)
def test_batch_mesh_matches_none_b1_and_jax(engine, jobs, port_runs):
    """louvain_many on 4 CPU blocks (b_pad 4), and on 2 blocks of a b_pad
    of 6 that 4 does not divide: every tenant's labels, phases and
    iterations equal mesh=None's, its B=1 run's and the reference's
    louvain_many(mesh='auto') on 8 devices."""
    jgs, pgs = jobs
    ref = jax_many(jgs, engine=engine, mesh="auto")
    base = port_runs[engine]
    for b_pad, nd in ((None, 4), (6, 2)):
        mesh = pbatched.make_batch_mesh(b_pad or 4, devices=["cpu"] * 4)
        assert mesh.size == nd
        br = louvain_many(pgs, engine=engine, b_pad=b_pad, mesh=mesh,
                          device="cpu")
        assert br.phase_engines == base.phase_engines
        for k, (mine, none, r) in enumerate(zip(br.results, base.results,
                                                ref.results)):
            assert np.array_equal(mine.communities, none.communities), k
            assert mine.modularity == none.modularity, k
            assert [p.iterations for p in mine.phases] == \
                [p.iterations for p in none.phases], k
            assert np.array_equal(mine.communities, r.communities), k
    for g, none in zip(pgs, base.results):
        solo = louvain_many([g], engine=engine, device="cpu").results[0]
        assert np.array_equal(solo.communities, none.communities)


def test_cluster_packed_and_queue_on_a_batch_mesh():
    """A merged batch on 4 CPU blocks of one packed row each, and a
    serving queue given a 2-block CPU batch mesh: every tenant's labels
    and Q equal the runs without a mesh."""
    from cuvite_tpu_torch import serve as pserve
    from cuvite_tpu_torch.workloads.synth import (
        many_seed,
        synthesize_graph,
    )

    gs = [synthesize_graph(1024, seed=many_seed(5, k)) for k in range(7)]
    layout = pbatch.subrow_layout_for((4096, 16384), (8192, 32768))
    for engine in ENGINES:
        none = pbatched.cluster_packed(gs, layout, engine=engine,
                                       device="cpu", mesh=None)
        four = pbatched.cluster_packed(
            gs, layout, engine=engine, device="cpu",
            mesh=pbatched.make_batch_mesh(none.b_pad, devices=["cpu"] * 4))
        assert (four.b_pad, four.n_sub) == (none.b_pad, none.n_sub) == (4, 2)
        for a, b in zip(four.results, none.results):
            assert np.array_equal(a.communities, b.communities)
            assert a.modularity == b.modularity
    mesh = pbatched.make_batch_mesh(4, devices=["cpu"] * 2)
    out = []
    for m in (mesh, None):
        srv = pserve.LouvainServer(pserve.ServeConfig(
            device="cpu", mesh=m, b_max=4, linger_s=0.0))
        ids = [srv.submit(g) for g in gs[:4]]
        res = dict(srv.drain())
        assert srv.stats.batches == 1 and srv.conservation()["ok"]
        out.append([res[i] for i in ids])
    for a, b in zip(*out):
        assert np.array_equal(a.communities, b.communities)
        assert a.modularity == b.modularity
