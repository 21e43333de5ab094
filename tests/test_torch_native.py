"""cuvite_tpu_torch's native host runtime against its numpy paths and the
JAX package, on the CPU.

Every routine of ``cuvite_tpu_torch/native`` gives the port's numpy path
bit for bit, dtypes included, and the reference's (``cuvite_tpu.native``
where it loads, and the reference's own functions): the CSR builders
(generic, unit and w32, dense and radix branches), R-MAT, the Vite
reader and writer, edge-balanced parts, the fused coarsening (dense and
radix branches), weighted degrees and the streamed bucket plan (the heavy
class and the uint8 unit weights; the decline on a masked slab).  The
dispatch sites take the library above ``MIN_NATIVE_EDGES`` and the
default path calls it at ingest, plan and coarsen.  ``CUVITE_NO_NATIVE=1``
runs the numpy paths with the same labels, a failed build raises, a
build and a load reach ``kernels/_build.HOOKS``, and torch's CPU ops run
as fast around native calls as before them.
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest

from cuvite_tpu import native as ref_native
from cuvite_tpu.coarsen.rebuild import coarsen_graph as ref_coarsen_graph
from cuvite_tpu.core.distgraph import DistGraph as RefDistGraph
from cuvite_tpu.core.distgraph import balanced_parts as ref_balanced_parts
from cuvite_tpu.core.graph import Graph as RefGraph
from cuvite_tpu.core.types import default_policy as ref_default_policy
from cuvite_tpu.core.types import wide_policy as ref_wide_policy
from cuvite_tpu.io.generate import generate_rmat as ref_rmat
from cuvite_tpu.io.generate import rmat_edges_numpy as ref_rmat_edges
from cuvite_tpu.io.vite import read_vite as ref_read_vite
from cuvite_tpu.io.vite import write_vite as ref_write_vite
from cuvite_tpu.louvain.bucketed import BucketPlan as RefBucketPlan
from cuvite_tpu_torch import Graph, louvain_phases, native
from cuvite_tpu_torch.coarsen.rebuild import (
    coarsen_graph,
    renumber_communities,
)
from cuvite_tpu_torch.core.distgraph import DistGraph, balanced_parts
from cuvite_tpu_torch.core.types import default_policy, wide_policy
from cuvite_tpu_torch.io.generate import (
    generate_rgg,
    generate_rmat,
    rmat_edges_numpy,
)
from cuvite_tpu_torch.io.vite import read_vite, write_vite
from cuvite_tpu_torch.kernels import _build
from cuvite_tpu_torch.louvain.bucketed import (
    DEFAULT_BUCKETS,
    BucketPlan,
    _build_native,
)

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def numpy_paths(monkeypatch):
    """A context that runs the port's numpy paths."""
    @contextlib.contextmanager
    def ctx():
        with monkeypatch.context() as m:
            m.setenv("CUVITE_NO_NATIVE", "1")
            yield
    return ctx


def _random_edges(ne, nv, seed, dups=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, size=ne)
    dst = rng.integers(0, nv, size=ne)
    if dups:
        src[: ne // 4] = src[ne // 2: ne // 2 + ne // 4]
        dst[: ne // 4] = dst[ne // 2: ne // 2 + ne // 4]
    return src, dst, rng.random(ne)


def _hi_edges(nv, ne, seed, span=300):
    """Edges among the top ``span`` ids of a large nv (the radix
    branches), a quarter of them duplicates."""
    rng = np.random.default_rng(seed)
    src = rng.integers(nv - span, nv, size=ne)
    dst = rng.integers(nv - span, nv, size=ne)
    src[: ne // 4] = src[ne // 2: ne // 2 + ne // 4]
    dst[: ne // 4] = dst[ne // 2: ne // 2 + ne // 4]
    return src, dst, rng.random(ne)


def _same(a, b, names=("offsets", "tails", "weights")):
    for n in names:
        x, y = getattr(a, n), getattr(b, n)
        assert x.dtype == y.dtype and np.array_equal(x, y), n


def _ref_also(fn, *args):
    """The reference library's output of the same call, where it loads."""
    return getattr(ref_native, fn)(*args) if ref_native.available() \
        else None


# -- CSR builders -----------------------------------------------------------

@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_build_csr_matches_numpy(symmetrize, seed):
    nv, ne = 257, 4096   # below the threshold: from_edges runs numpy
    src, dst, w = _random_edges(ne, nv, seed)
    off, tails, wn = native.build_csr(nv, src, dst, w, symmetrize)
    g = Graph.from_edges(nv, src, dst, weights=w, symmetrize=symmetrize)
    assert np.array_equal(off, g.offsets)
    assert np.array_equal(tails, g.tails)
    assert np.array_equal(wn.astype(g.weights.dtype), g.weights)
    ref = _ref_also("build_csr", nv, src, dst, w, symmetrize)
    if ref is not None:
        for a, b in zip((off, tails, wn), ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("symmetrize", [True, False])
def test_build_csr_radix_branch_matches_numpy(symmetrize, numpy_paths):
    """nv > 2^22 puts the generic builder on its LSD radix branch."""
    nv = (1 << 22) + 11
    src, dst, w = _hi_edges(nv, 4096, 3)
    off, tails, wn = native.build_csr(nv, src, dst, w, symmetrize)
    with numpy_paths():
        g = Graph.from_edges(nv, src, dst, weights=w, symmetrize=symmetrize)
    assert np.array_equal(off, g.offsets)
    assert np.array_equal(tails, g.tails)
    assert np.array_equal(wn.astype(g.weights.dtype), g.weights)
    _same(g, RefGraph.from_edges(nv, src, dst, weights=w,
                                 symmetrize=symmetrize))


def test_build_csr_rejects_out_of_range():
    with pytest.raises(ValueError):
        native.build_csr(4, np.array([0, 5]), np.array([1, 2]), np.ones(2),
                         True)


def test_from_edges_uses_native_above_threshold(numpy_paths):
    nv, ne = 1000, (1 << 16) + 11
    src, dst, w = _random_edges(ne, nv, 3)
    native.zero_call_counts()
    g = Graph.from_edges(nv, src, dst, weights=w)
    assert native.call_counts()["build_csr"] == 1
    with numpy_paths():
        g_np = Graph.from_edges(nv, src, dst, weights=w)
    _same(g, g_np)
    _same(g, RefGraph.from_edges(nv, src, dst, weights=w))


@pytest.mark.parametrize("symmetrize", [True, False])
def test_build_csr_unit_matches_generic(symmetrize, numpy_paths):
    nv, ne = 257, 4096
    src, dst, _ = _random_edges(ne, nv, 5)
    o, t, w = native.build_csr_unit(nv, src, dst, symmetrize=symmetrize)
    with numpy_paths():
        g = Graph.from_edges(nv, src, dst, symmetrize=symmetrize)
    assert t.dtype == np.int32 and w.dtype == np.float32
    assert np.array_equal(o, g.offsets)
    assert np.array_equal(t, g.tails)
    assert np.array_equal(w, g.weights)
    ref = _ref_also("build_csr_unit", nv, src, dst, symmetrize)
    if ref is not None:
        for a, b in zip((o, t, w), ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_build_csr_unit_radix_branch(numpy_paths):
    nv = (1 << 22) + 11
    src, dst, _ = _hi_edges(nv, 4096, 3)
    o, t, w = native.build_csr_unit(nv, src, dst, symmetrize=True)
    with numpy_paths():
        g = Graph.from_edges(nv, src, dst, symmetrize=True)
    assert np.array_equal(o, g.offsets)
    assert np.array_equal(t, g.tails)
    assert np.array_equal(w, g.weights)


def test_from_edges_unit_dispatch(numpy_paths):
    """weights=None above the threshold takes the int32 unit builder and
    gives the generic builder's graph, the numpy path's and the
    reference's."""
    nv = 1 << 12
    ne = native.MIN_NATIVE_EDGES + 17
    rng = np.random.default_rng(9)
    src = rng.integers(0, nv, ne)
    dst = rng.integers(0, nv, ne)
    native.zero_call_counts()
    g_unit = Graph.from_edges(nv, src, dst)
    g_gen = Graph.from_edges(nv, src, dst, weights=np.ones(ne))
    counts = native.call_counts()
    assert counts["build_csr_unit"] == 1 and counts["build_csr"] == 1
    with numpy_paths():
        g_np = Graph.from_edges(nv, src, dst)
    for other in (g_gen, g_np, RefGraph.from_edges(nv, src, dst)):
        _same(g_unit, other)
    # A f64 policy keeps the generic builder (no f32 duplicate counts).
    native.zero_call_counts()
    g_wide = Graph.from_edges(nv, src, dst, policy=wide_policy())
    assert native.call_counts()["build_csr_unit"] == 0
    assert np.array_equal(g_wide.weights, g_unit.weights)


@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_build_csr_w32_matches_generic(symmetrize, id_dtype):
    nv, ne = 257, 4096
    src, dst, w = _random_edges(ne, nv, 11)
    o, t, wf = native.build_csr_w(nv, src.astype(id_dtype),
                                  dst.astype(id_dtype), w,
                                  symmetrize=symmetrize)
    g = Graph.from_edges(nv, src, dst, weights=w, symmetrize=symmetrize)
    assert np.array_equal(o, g.offsets)
    assert np.array_equal(t, g.tails)
    assert wf.dtype == g.weights.dtype and np.array_equal(wf, g.weights)


def test_build_csr_w32_radix_branch_large_nv(numpy_paths):
    """nv > 2^22 above the threshold: from_edges dispatches to the w32
    builder, equal to the numpy path and the reference."""
    nv = (1 << 22) + 19
    src, dst, w = _hi_edges(nv, native.MIN_NATIVE_EDGES + 512, 13, 500)
    native.zero_call_counts()
    g = Graph.from_edges(nv, src, dst, weights=w, symmetrize=True)
    assert native.call_counts()["build_csr_w"] == 1
    with numpy_paths():
        g_np = Graph.from_edges(nv, src, dst, weights=w, symmetrize=True)
    _same(g, g_np)
    _same(g, RefGraph.from_edges(nv, src, dst, weights=w, symmetrize=True))


# -- R-MAT --------------------------------------------------------------------

@pytest.mark.parametrize("scale,ne", [(8, 1 << 11), (12, 3000)])
def test_rmat_matches_numpy(scale, ne):
    s, d = native.rmat_edges(scale, ne, 1, 0.57, 0.19, 0.19)
    for ours, theirs in ((rmat_edges_numpy, ref_rmat_edges),):
        for a, b in zip((s, d), ours(scale, ne, 1, 0.57, 0.19, 0.19)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip((s, d), theirs(scale, ne, 1, 0.57, 0.19, 0.19)):
            assert np.array_equal(a, b)
    assert s.min() >= 0 and s.max() < (1 << scale)


def test_rmat_is_skewed():
    s, d = native.rmat_edges(12, 1 << 14, 1, 0.57, 0.19, 0.19)
    deg = np.bincount(np.concatenate([s, d]), minlength=1 << 12)
    assert deg.max() > 8 * max(deg.mean(), 1)


def test_generate_rmat_native_matches_numpy_and_jax(numpy_paths):
    """R-MAT 13: the native edge list and unit CSR builder at ingest."""
    native.zero_call_counts()
    g = generate_rmat(13)
    counts = native.call_counts()
    assert counts["rmat_edges"] == 1 and counts["build_csr_unit"] == 1
    with numpy_paths():
        g_np = generate_rmat(13)
    _same(g, g_np)
    _same(g, ref_rmat(13))


# -- Vite I/O -----------------------------------------------------------------

@pytest.mark.parametrize("bits64", [True, False])
def test_vite_native_roundtrip(tmp_path, bits64, numpy_paths):
    """Above the threshold: the native writer's bytes are the numpy
    writer's and the reference's; the native reader, the numpy reader and
    the reference reader give the same graph."""
    nv, ne = 1000, 70000
    src, dst, w = _random_edges(ne, nv, 5)
    w = np.round(w * 16) / 16   # exact in f32 for the 32-bit layout
    g = Graph.from_edges(nv, src, dst, weights=w,
                         policy=wide_policy() if bits64 else default_policy())
    assert g.num_edges >= native.MIN_NATIVE_EDGES
    jg = RefGraph(g.offsets, g.tails, g.weights,
                  ref_wide_policy() if bits64 else ref_default_policy())
    paths = {k: str(tmp_path / f"{k}.bin") for k in ("nat", "np", "ref")}
    native.zero_call_counts()
    write_vite(paths["nat"], g, bits64=bits64)
    g2 = read_vite(paths["nat"], bits64=bits64)
    counts = native.call_counts()
    assert counts["vite_write"] == 1 and counts["vite_edges"] == 1
    with numpy_paths():
        write_vite(paths["np"], g, bits64=bits64)
        g3 = read_vite(paths["nat"], bits64=bits64)
    ref_write_vite(paths["ref"], jg, bits64=bits64)
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    assert raw["nat"] == raw["np"] == raw["ref"]
    for other in (g2, g3, ref_read_vite(paths["nat"], bits64=bits64)):
        _same(g2, other)
    assert np.array_equal(g2.tails, g.tails)
    assert np.array_equal(g2.weights, g.weights)
    assert native.vite_header(paths["nat"], bits64) == (nv, g.num_edges)


def test_vite_edges_slice(tmp_path):
    """An edge-record slice [e0, e1) (the reference's vertex-range read)
    equals the CSR's slice."""
    nv, ne = 1024, 70000
    src, dst, w = _random_edges(ne, nv, 9)
    g = Graph.from_edges(nv, src, dst, weights=w, policy=wide_policy())
    p = str(tmp_path / "g.bin")
    write_vite(p, g)
    assert g.num_edges >= native.MIN_NATIVE_EDGES
    e0, e1 = int(g.offsets[32]), int(g.offsets[960])
    tails, weights = native.vite_edges(p, True, nv, e0, e1)
    assert np.array_equal(tails, g.tails[e0:e1])
    assert np.array_equal(weights, g.weights[e0:e1])
    part = ref_read_vite(p, vertex_range=(32, 960))
    assert np.array_equal(part.tails, tails)


# -- partitions ---------------------------------------------------------------

def test_balanced_parts_matches_python():
    nv, ne = 500, 120000
    src, dst, w = _random_edges(ne, nv, 11)
    g = Graph.from_edges(nv, src, dst, weights=w)
    jg = RefGraph(g.offsets, g.tails, g.weights)
    for nparts in (2, 4, 7):
        nat = native.balanced_parts(g.offsets, nparts)
        assert np.array_equal(nat, balanced_parts(g, nparts))
        assert np.array_equal(nat, ref_balanced_parts(jg, nparts))


def test_balanced_parts_tiny_graph_matches_python():
    """ne < nparts: edge targets of 0; shard 0 is never empty."""
    g = Graph.from_edges(10, np.array([0, 3]), np.array([1, 4]))
    for nparts in (3, 8):
        assert np.array_equal(balanced_parts(g, nparts),
                              native.balanced_parts(g.offsets, nparts))


# -- coarsening and degrees ---------------------------------------------------

def _coarsen_numpy(g, dense, nc, numpy_paths):
    with numpy_paths():
        return coarsen_graph(g, dense, nc)


def test_coarsen_native_matches_numpy(numpy_paths):
    """A f64 policy: coarsen_graph keeps the relabel + generic builder
    route, whose builder is native above the threshold."""
    nv, ne = 400, 40000
    src, dst, w = _random_edges(ne, nv, 13)
    g = Graph.from_edges(nv, src, dst, weights=w, policy=wide_policy())
    dense, nc = renumber_communities((np.arange(nv) * 7919) % 37)
    native.zero_call_counts()
    got = coarsen_graph(g, dense, nc)
    assert native.call_counts()["coarsen_csr"] == 0
    _same(got, _coarsen_numpy(g, dense, nc, numpy_paths))
    jg = RefGraph(g.offsets, g.tails, g.weights, ref_wide_policy())
    _same(got, ref_coarsen_graph(jg, dense, nc))


@pytest.mark.parametrize("nc_target", [100, 2500])
def test_coarsen_csr_matches_numpy(nc_target, numpy_paths):
    """cv_coarsen's dense path (nc <= 2^22) on dyadic weights."""
    rng = np.random.default_rng(3)
    nv, ne = 3000, 20000
    src = rng.integers(0, nv, size=ne)
    dst = rng.integers(0, nv, size=ne)
    w = rng.integers(1, 32, size=ne) / 16.0
    g = Graph.from_edges(nv, src, dst, weights=w)
    dense, nc = renumber_communities(rng.integers(0, nc_target, size=nv))
    off, tails, wout = native.coarsen_csr(g.offsets, g.tails, g.weights,
                                          dense, nc)
    ref = _coarsen_numpy(g, dense, nc, numpy_paths)
    for a, b in zip((off, tails, wout), (ref.offsets, ref.tails,
                                         ref.weights)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    theirs = _ref_also("coarsen_csr", g.offsets, g.tails, g.weights, dense,
                       nc)
    if theirs is not None:
        for a, b in zip((off, tails, wout), theirs):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("force", ["radix", "dense"])
def test_coarsen_csr_large_nc_branches(force, numpy_paths, monkeypatch):
    """nc > 2^22: the radix branch, and the dense path forced by
    CUVITE_COARSEN_FORCE, give the numpy route's bits."""
    rng = np.random.default_rng(4)
    nv, ne = 9_000_000, 120_000
    src = rng.integers(0, nv, size=ne)
    dst = rng.integers(0, nv, size=ne)
    g = Graph.from_edges(nv, src, dst)
    dense, nc = renumber_communities(rng.integers(0, 8_500_000, size=nv))
    assert nc > 1 << 22
    monkeypatch.setenv("CUVITE_COARSEN_FORCE", force)
    off, tails, wout = native.coarsen_csr(g.offsets, g.tails, g.weights,
                                          dense, nc)
    ref = _coarsen_numpy(g, dense, nc, numpy_paths)
    assert np.array_equal(off, ref.offsets)
    assert np.array_equal(tails, ref.tails)
    assert np.array_equal(wout, ref.weights)


def test_coarsen_graph_dispatch(numpy_paths):
    """Above the threshold coarsen_graph takes the fused native path and
    gives the numpy route's graph and the reference's."""
    rng = np.random.default_rng(5)
    nv = 1 << 12
    ne = native.MIN_NATIVE_EDGES + 41
    g = Graph.from_edges(nv, rng.integers(0, nv, ne), rng.integers(0, nv, ne))
    assert g.num_edges >= native.MIN_NATIVE_EDGES
    dense, nc = renumber_communities(rng.integers(0, 500, size=nv))
    native.zero_call_counts()
    got = coarsen_graph(g, dense, nc)
    assert native.call_counts()["coarsen_csr"] == 1
    _same(got, _coarsen_numpy(g, dense, nc, numpy_paths))
    _same(got, ref_coarsen_graph(RefGraph(g.offsets, g.tails, g.weights),
                                 dense, nc))


def test_weighted_degrees_native_matches_numpy(numpy_paths):
    rng = np.random.default_rng(6)
    nv, ne = 5000, 70000
    g = Graph.from_edges(nv, rng.integers(0, nv, ne),
                         rng.integers(0, nv, ne), weights=rng.random(ne))
    native.zero_call_counts()
    got = g.weighted_degrees()
    assert native.call_counts()["weighted_degrees"] == 1
    with numpy_paths():
        ref = g.weighted_degrees()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(
        got, RefGraph(g.offsets, g.tails, g.weights).weighted_degrees())


# -- the streamed bucket plan -------------------------------------------------

def _plans_equal(a, b, deg=True):
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert x.width == y.width
        for f in ("verts", "dst", "w"):
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype and np.array_equal(u, v), f
    names = ["heavy_src", "heavy_dst", "heavy_w", "self_loop"]
    for f in names + (["deg"] if deg else []):
        u, v = getattr(a, f), getattr(b, f)
        assert u.dtype == v.dtype and np.array_equal(u, v), f
    assert a.has_heavy == b.has_heavy and a.nv_local == b.nv_local


def _check_plan(g, numpy_paths):
    """The native plan of g's one-shard slab equals the numpy plan and
    the reference's plan of the same slab."""
    dg = DistGraph.build(g)
    nv = dg.nv_pad
    native.zero_call_counts()
    pn = _build_native(dg.src, dg.dst, dg.w, nv, 0)
    assert pn is not None
    with numpy_paths():
        pp = BucketPlan.build(dg.src, dg.dst, dg.w, nv_local=nv)
    _plans_equal(pn, pp)
    ref = RefBucketPlan.build(dg.src, dg.dst, dg.w, nv, 0)
    _plans_equal(pn, ref, deg=False)
    counts = native.call_counts()
    assert counts["plan_scan"] == 1 and counts["bucket_fill"] == 1
    return pn


def test_bucket_plan_native_matches_numpy_rmat(numpy_paths):
    # R-MAT coalesces duplicates to weight 2: not a unit plan.
    pn = _check_plan(generate_rmat(14), numpy_paths)
    assert all(b.w.dtype == np.float32 for b in pn.buckets)


def test_bucket_plan_native_unit_uint8(numpy_paths):
    """A duplicate-free unit-weight ring: uint8 weight matrices on both
    paths."""
    n = 1 << 17
    s = np.arange(n, dtype=np.int64)
    pn = _check_plan(Graph.from_edges(n, s, (s + 1) % n), numpy_paths)
    assert pn.buckets and all(b.w.dtype == np.uint8 for b in pn.buckets)


def test_bucket_plan_native_matches_numpy_weighted(numpy_paths):
    pn = _check_plan(generate_rgg(1 << 15, seed=3), numpy_paths)
    assert all(b.w.dtype == np.float32 for b in pn.buckets)


def test_bucket_plan_native_heavy_class(numpy_paths):
    """A hub of degree 20,480 > DEFAULT_BUCKETS[-1] goes to the heavy
    triples in the numpy order, with uint8 unit weights in the rows."""
    nv = 80 * 256 + 1
    hub = nv - 1
    edges = []
    for c in range(80):
        b0 = c * 256
        for i in range(256):
            edges.append((b0 + i, b0 + (i + 1) % 256))
            edges.append((b0 + i, b0 + (i + 7) % 256))
    edges += [(hub, v) for v in range(hub)]
    e = np.array(edges, dtype=np.int64)
    pn = _check_plan(Graph.from_edges(nv, e[:, 0], e[:, 1]), numpy_paths)
    assert pn.has_heavy and DEFAULT_BUCKETS[-1] < 20480
    assert all(b.w.dtype == np.uint8 for b in pn.buckets)


def test_bucket_plan_native_declines_masked_slab():
    """Padding rows mid-slab (a masked color-class slab): the native
    build declines and BucketPlan.build runs the numpy path."""
    dg = DistGraph.build(generate_rmat(13, seed=2))
    src = dg.src.copy()
    src[::3] = dg.nv_pad
    assert _build_native(src, dg.dst, dg.w, dg.nv_pad, 0) is None
    # Mixed id dtypes decline too.
    assert _build_native(dg.src, dg.dst.astype(np.int64), dg.w,
                         dg.nv_pad, 0) is None
    plan = BucketPlan.build(src, dg.dst, dg.w, nv_local=dg.nv_pad)
    ref = RefBucketPlan.build(src, dg.dst, dg.w, dg.nv_pad, 0)
    _plans_equal(plan, ref, deg=False)


def test_distgraph_slab_takes_the_native_plan():
    """One shard's slab is the CSR (src the expanded rows, dst/w the
    tails and weights, no padding), so the default path's plan is the
    native one, equal to the reference's one-shard slab plan."""
    rng = np.random.default_rng(7)
    nv, ne = 1000, 40000
    g = Graph.from_edges(nv, rng.integers(0, nv, ne),
                         rng.integers(0, nv, ne), weights=rng.random(ne))
    dg = DistGraph.build(g)
    n = g.num_edges
    assert n >= native.MIN_NATIVE_EDGES and len(dg.src) == n
    assert np.array_equal(dg.src, g.sources())
    assert dg.dst is g.tails and dg.w is g.weights
    native.zero_call_counts()
    plan = BucketPlan.build(dg.src, dg.dst, dg.w, nv_local=dg.nv_pad)
    assert native.call_counts()["bucket_fill"] == 1
    rsh = RefDistGraph.build(RefGraph(g.offsets, g.tails, g.weights), 1)
    sh = rsh.shards[0]
    ref = RefBucketPlan.build(np.asarray(sh.src), np.asarray(sh.dst),
                              np.asarray(sh.w), rsh.nv_pad, 0)
    assert rsh.nv_pad == dg.nv_pad
    _plans_equal(plan, ref, deg=False)


# -- the default path and the switches ----------------------------------------

@pytest.fixture(scope="module")
def rmat12_run():
    """R-MAT 12 (131,072 slab edges) on the CPU with the library on, and
    the calls it made."""
    g = generate_rmat(12)
    native.zero_call_counts()
    res = louvain_phases(g, device="cpu")
    return g, res, native.call_counts()


def test_default_path_calls_native(rmat12_run):
    """The default path calls the library at ingest (generate_rmat above
    the threshold: R-MAT 13), at every host plan and at coarsening."""
    _, res, counts = rmat12_run
    for name in ("plan_scan", "bucket_fill", "coarsen_csr",
                 "weighted_degrees"):
        assert counts[name] >= 1, (name, counts)
    assert counts["plan_scan"] == counts["bucket_fill"]
    assert len(res.phases) >= 2
    native.zero_call_counts()
    generate_rmat(13)
    counts = native.call_counts()
    assert counts["rmat_edges"] == 1 and counts["build_csr_unit"] == 1


def test_no_native_runs_numpy_with_the_same_labels(rmat12_run, monkeypatch):
    g, res, _ = rmat12_run
    monkeypatch.setenv("CUVITE_NO_NATIVE", "1")
    native.zero_call_counts()
    res_np = louvain_phases(g, device="cpu")
    assert native.call_counts() == dict.fromkeys(native.ROUTINES, 0)
    assert np.array_equal(res.communities, res_np.communities)
    assert [p.iterations for p in res.phases] == \
        [p.iterations for p in res_np.phases]
    assert res.modularity == res_np.modularity


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no loaded library."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    return tmp_path


def test_failed_build_raises(fresh_build, monkeypatch):
    bad = fresh_build / "broken.cpp"
    bad.write_text("extern \"C\" int cv_openmp_threads(void) { return }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="build failed") as exc:
        native.rmat_edges(8, 64, 1, 0.57, 0.19, 0.19)
    assert "error" in str(exc.value)
    # No quiet numpy fallback at a dispatch site either.
    nv, ne = 1000, native.MIN_NATIVE_EDGES + 5
    src, dst, _ = _random_edges(ne, nv, 1)
    with pytest.raises(RuntimeError, match="build failed"):
        Graph.from_edges(nv, src, dst)
    assert native._LIB is None
    assert not list((fresh_build / "build").glob("*.so"))


def test_build_and_load_reach_the_hooks(fresh_build, monkeypatch):
    events = []
    monkeypatch.setattr(_build, "HOOKS", [events.append])
    s, d = native.rmat_edges(8, 1 << 11, 1, 0.57, 0.19, 0.19)
    assert [(e["module"], e["kind"]) for e in events] == \
        [("cuvite_native", "build"), ("cuvite_native", "load")]
    assert native.library_path().exists()
    assert native.openmp_threads() >= 1
    native.rmat_edges(8, 1 << 11, 1, 0.57, 0.19, 0.19)
    assert len(events) == 2   # one build and one load a process
    assert np.array_equal(s, rmat_edges_numpy(8, 1 << 11, 1, 0.57, 0.19,
                                              0.19)[0])


_TORCH_AROUND_NATIVE = r"""
import time, sys
import numpy as np, torch
from cuvite_tpu_torch import native
torch.set_num_threads(2)
x = torch.randn(600, 600)
keys = torch.randint(0, 1 << 30, (1 << 20,))
def torch_ms():
    best = 1e9
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(4):
            x @ x
        torch.sort(keys)
        best = min(best, time.perf_counter() - t)
    return best
before = torch_ms()
s, d = native.rmat_edges(16, 1 << 20, 1, 0.57, 0.19, 0.19)
g_off = native.build_csr_unit(1 << 16, s, d)[0]
after = torch_ms()
print(before, after, native.openmp_threads(), int(g_off[-1]))
"""


def test_torch_cpu_ops_around_native_calls():
    """torch's CPU ops, then OpenMP-parallel native calls, then torch
    again in one process (the library and torch share one libgomp where
    torch brings its own): nothing hangs, and torch is not slowed."""
    out = subprocess.run([sys.executable, "-c", _TORCH_AROUND_NATIVE],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    before, after, threads, ne = out.stdout.split()
    assert int(threads) >= 1 and int(ne) > 0
    assert float(after) < 3 * float(before) + 0.05
