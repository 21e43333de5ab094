"""cuvite_tpu_torch's sub-row packing held against the JAX package's on the
CPU: the same numpy graphs go into both.

The geometry is array for array the reference's (``subrow_layout_for``,
``pack_subrows``, ``unpack_subrows``, the seams included).  A merged batch
(``cluster_packed``, which runs as the fold of its sub-rows)
gives every tenant the JAX ``cluster_packed`` labels, phases and
iterations, Q within 1e-6 (the port's Q is f64, the reference's f32), and
bit for bit its own B=1 run, on both engines.  The graphs are the
reference's adversarial seam cases (``tests/test_subrow.py:115-178``): a
hub community at the last vertex id of sub-row 0 beside one at the first
id of sub-row 1, and max-degree stars whose edges fill the sub-row's edge
span to two slots short of the seam.  Every graph has unit weights, the
exactness domain of the float sums.
"""

import jax
import numpy as np
import pytest
import torch

from cuvite_tpu.core import batch as jbatch
from cuvite_tpu.core.graph import Graph as JGraph
from cuvite_tpu.louvain import batched as jbatched
from cuvite_tpu.workloads.synth import many_seed as jax_many_seed
from cuvite_tpu.workloads.synth import synthesize_graph as jax_synth
from cuvite_tpu_torch import Graph, louvain_many
from cuvite_tpu_torch.core import batch as pbatch
from cuvite_tpu_torch.louvain import batched as pbatched
from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = (4096, 16384)
BIG = (8192, 32768)
ENGINES = ("fused", "bucketed")


@pytest.fixture(autouse=True)
def _free_jax_programs():
    yield
    jax.clear_caches()


def _port(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


def _ring_graph(nv, seed, extra=0):
    """tests/test_subrow.py::_ring_graph: an nv-ring plus random chords."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(nv), rng.integers(0, nv, extra)])
    dst = np.concatenate([(np.arange(nv) + 1) % nv,
                          rng.integers(0, nv, extra)])
    keep = src != dst
    return JGraph.from_edges(nv, src[keep], dst[keep])


def _hub_graph(nv, hub, seed, extra=64):
    """tests/test_subrow.py::_hub_graph: a ring and a hub at id ``hub``."""
    rng = np.random.default_rng(seed)
    spokes = rng.choice(nv - 1, size=nv // 8, replace=False)
    spokes = np.where(spokes >= hub, spokes + 1, spokes) % nv
    src = np.concatenate([np.arange(nv), np.full(spokes.size, hub),
                          rng.integers(0, nv, extra)])
    dst = np.concatenate([(np.arange(nv) + 1) % nv, spokes,
                          rng.integers(0, nv, extra)])
    keep = src != dst
    return JGraph.from_edges(nv, src[keep], dst[keep])


def _star(nv, seed):
    """tests/test_subrow.py's max-degree star: 16,382 of 16,384 slots."""
    rng = np.random.default_rng(seed)
    hub = nv - 1
    ex_s = rng.integers(0, nv - 1, 4096)
    ex_d = rng.integers(0, nv - 1, 4096)
    keep = ex_s != ex_d
    return JGraph.from_edges(
        nv, np.concatenate([np.full(nv - 1, hub), ex_s[keep]]),
        np.concatenate([np.arange(nv - 1), ex_d[keep]]))


CASES = {
    "seam": lambda: [_hub_graph(4096, hub=4095, seed=1),
                     _hub_graph(4096, hub=0, seed=2)],
    "star": lambda: [_star(4096, 3), _star(4096, 4)],
    "synth3": lambda: [jax_synth(1024, seed=jax_many_seed(3, k))
                       for k in range(3)],
}


@pytest.fixture(scope="module")
def graphs():
    return {name: make() for name, make in CASES.items()}


# ---------------------------------------------------------------------------
# Geometry


@pytest.mark.parametrize("pair", [
    (SMALL, BIG), (SMALL, (16384, 65536)), (SMALL, (8192, 16384)),
    (SMALL, (8192, 65536)), (SMALL, SMALL), (SMALL, (12288, 49152)),
    ((1024, 4096), (4096, 16384)), ((0, 4096), BIG)])
def test_subrow_layout_for_matches_jax(pair):
    ref = jbatch.subrow_layout_for(*pair)
    mine = pbatch.subrow_layout_for(*pair)
    if ref is None:
        assert mine is None
        return
    assert (mine.n_sub, mine.sub_class, mine.row_class) == \
        (ref.n_sub, ref.sub_class, ref.row_class)
    assert mine.vertex_fences() == ref.vertex_fences()
    for s in range(ref.n_sub):
        assert mine.vertex_offset(s) == ref.vertex_offset(s)
        assert mine.edge_offset(s) == ref.edge_offset(s)
    for bad in (1, 3, 6):
        with pytest.raises(ValueError):
            pbatch.SubRowLayout(n_sub=bad, sub_class=SMALL)


@pytest.mark.parametrize("name,b_pad", [("seam", None), ("star", 4),
                                        ("synth3", None)])
def test_pack_subrows_matches_jax(graphs, name, b_pad):
    gs = graphs[name]
    ref = jbatch.pack_subrows(gs, jbatch.subrow_layout_for(SMALL, BIG),
                              b_pad=b_pad)
    mine = pbatch.pack_subrows([_port(g) for g in gs],
                               pbatch.subrow_layout_for(SMALL, BIG),
                               b_pad=b_pad)
    for f in ("src", "dst", "w", "real_mask", "constants", "sub_valid",
              "nv_real", "ne_real", "tw2", "row_valid"):
        a, b = getattr(mine, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (mine.b_pad, mine.nv_pad, mine.ne_pad, mine.slab_class,
            mine.n_jobs) == (ref.b_pad, ref.nv_pad, ref.ne_pad,
                             ref.slab_class, ref.n_jobs)
    assert mine.pack_util == ref.pack_util
    assert mine.subrow_util == ref.subrow_util
    # Unpack: labels sliced at each fence minus its offset, Q per sub-row.
    rng = np.random.default_rng(7)
    comm = rng.integers(0, BIG[0], size=(ref.b_pad, BIG[0])).astype(np.int32)
    q = rng.random((ref.b_pad, 2))
    for (la, qa), (lb, qb) in zip(pbatch.unpack_subrows(mine, comm, q),
                                  jbatch.unpack_subrows(ref, comm, q)):
        assert np.array_equal(la, lb) and la.dtype == lb.dtype and qa == qb


def test_pack_subrows_refusals(graphs):
    lay = pbatch.subrow_layout_for(SMALL, BIG)
    big = _port(jax_synth(1 << 15, seed=1))
    assert pbatch.slab_class_of(big)[1] > SMALL[1]
    for call in (lambda: pbatch.pack_subrows([big], lay),
                 lambda: pbatch.pack_subrows([], lay),
                 lambda: pbatch.pack_subrows(
                     [_port(g) for g in graphs["synth3"]], lay, b_pad=1),
                 lambda: pbatch.pack_subrows(
                     [Graph.from_edges(8, np.zeros(0, np.int64),
                                       np.zeros(0, np.int64))], lay)):
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# The sub-row lifts of coarsen/device.py


# ---------------------------------------------------------------------------
# Merged clustering


@pytest.fixture(scope="module")
def jax_packed(graphs):
    out = {}
    for name in ("seam", "star"):
        out[name] = jbatched.cluster_packed(
            graphs[name], jbatch.subrow_layout_for(SMALL, BIG), mesh=None)
        jax.clear_caches()
    return out


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["seam", "star"])
def test_cluster_packed_matches_jax_and_b1(graphs, jax_packed, name,
                                           engine):
    gs = [_port(g) for g in graphs[name]]
    br = pbatched.cluster_packed(gs, pbatch.subrow_layout_for(SMALL, BIG),
                                 engine=engine, device="cpu")
    ref = jax_packed[name]
    assert (br.b_pad, br.n_sub, br.slab_class, br.n_jobs) == \
        (ref.b_pad, ref.n_sub, ref.slab_class, ref.n_jobs)
    for k, (g, mine, want) in enumerate(zip(gs, br.results, ref.results)):
        assert np.array_equal(mine.communities, want.communities), k
        assert [p.iterations for p in mine.phases] == \
            [p.iterations for p in want.phases]
        assert abs(mine.modularity - want.modularity) <= 1e-6
        solo = louvain_many([g], engine=engine, device="cpu").results[0]
        assert np.array_equal(solo.communities, mine.communities)
        assert solo.modularity == mine.modularity
        assert solo.total_iterations == mine.total_iterations
        # Every community id stays inside the tenant's own fence.
        assert mine.communities.min() >= 0
        assert mine.communities.max() < SMALL[0]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("row,n_sub,b_pad", [(BIG, 2, 4), ((16384, 65536),
                                                           4, 2)])
def test_cluster_packed_rows_equal_b1(engine, row, n_sub, b_pad):
    """Seven synth tenants in rows of two and of four sub-rows (the last
    row partly padding): each equals its own B=1 run, ids in its fence."""
    gs = [synthesize_graph(1024, seed=many_seed(5, k)) for k in range(7)]
    layout = pbatch.subrow_layout_for(SMALL, row)
    assert layout.n_sub == n_sub
    br = pbatched.cluster_packed(gs, layout, engine=engine, device="cpu")
    assert (br.b_pad, br.n_sub, br.slab_class, br.n_jobs) == \
        (b_pad, n_sub, row, 7)
    for g, r in zip(gs, br.results):
        solo = louvain_many([g], engine=engine, device="cpu").results[0]
        assert np.array_equal(solo.communities, r.communities)
        assert solo.modularity == r.modularity
        assert solo.total_iterations == r.total_iterations
        assert 0 <= r.communities.min() and r.communities.max() < 1024


def test_cluster_packed_edgeless_and_partial_row(graphs):
    """An edgeless graph is answered inline and takes no sub-row; three
    tenants leave the second row's last sub-row empty (padding)."""
    gs = [_port(g) for g in graphs["synth3"]]
    empty = Graph.from_edges(5, np.zeros(0, np.int64), np.zeros(0, np.int64))
    br = pbatched.cluster_packed([gs[0], empty, gs[1], gs[2]],
                                 pbatch.subrow_layout_for(SMALL, BIG),
                                 engine="bucketed", device="cpu")
    assert br.n_jobs == 3 and br.b_pad == 2 and br.n_sub == 2
    assert np.array_equal(br.results[1].communities, np.arange(5))
    assert br.results[1].modularity == 0.0
    for g, r in zip(gs, (br.results[0], br.results[2], br.results[3])):
        solo = louvain_many([g], engine="bucketed", device="cpu").results[0]
        assert np.array_equal(solo.communities, r.communities)
        assert solo.modularity == r.modularity


@pytest.mark.parametrize("engine", ENGINES)
def test_prepared_merged_batch_reruns_bit_identical(graphs, engine):
    """execute_many writes nothing into the prepared buffers: one
    uploaded merged batch, executed twice, gives the same bits."""
    gs = [_port(g) for g in graphs["synth3"]]
    pm = pbatched.pack_subrow_many(gs, pbatch.subrow_layout_for(SMALL, BIG),
                                   engine=engine, device="cpu")
    before = [t.clone() for t in (pm.prep.slab.src, pm.prep.slab.dst,
                                  pm.prep.slab.w, pm.prep.slab.comm_all)]
    a = pbatched.execute_many(pm)
    b = pbatched.execute_many(pm)
    for x, y in zip(a.results, b.results):
        assert np.array_equal(x.communities, y.communities)
        assert x.modularity == y.modularity
    for t0, t1 in zip(before, (pm.prep.slab.src, pm.prep.slab.dst,
                               pm.prep.slab.w, pm.prep.slab.comm_all)):
        assert torch.equal(t0, t1)
