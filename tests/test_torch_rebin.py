"""cuvite_tpu_torch's device re-binning (``coarsen/rebin.py``) held against
the host plan build and the JAX package's re-binner, on the CPU.

Across the slab configurations of tests/test_rebin.py the plan built on
the device equals ``DevicePlan.upload(BucketPlan.build(...))`` tensor for
tensor, and its real rows equal those of the reference's ``rebin_plan``.
The reference's "based" slab is built at shard base 0 on both sides: the
port has one shard, so no base; its tails then lie outside the vertex
range, which exercises the gathers all the same.  Geometry and
eligibility match the reference's, element budget included, and whole
bucketed runs are identical with re-binning on and off, and to JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvite_tpu.coarsen import rebin as jrebin
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.coarsen import rebin as prebin
from cuvite_tpu_torch.core import batch as pbatch
from cuvite_tpu_torch.louvain.bucketed import (
    BucketPlan,
    DevicePlan,
    fold_plans,
)
from test_rebin import _coalesced_slab

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONFIGS = [
    (8, 64, {}),
    (64, 1024, {"gapped": True}),
    (256, 8192, {"base": 1024, "max_deg": 40}),
    (1024, 32768, {"hubs": 4, "max_deg": 40}),
    (8192, 1 << 17, {"hubs": 3, "gapped": True, "max_deg": 12}),
]
IDS = ["tiny", "gapped", "based", "hubby", "ladder-top"]


@pytest.fixture(autouse=True)
def _free_jax_programs():
    yield
    jax.clear_caches()


def assert_plans_equal(got: DevicePlan, want: DevicePlan):
    assert len(got.buckets) == len(want.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        assert gb[1].shape == wb[1].shape
        for x, y in zip(gb, wb):
            assert x.dtype == y.dtype
            assert torch.equal(x.cpu(), y.cpu())
    assert (got.heavy is None) == (want.heavy is None)
    for x, y in ((got.self_loop, want.self_loop), (got.perm, want.perm)):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
    assert (got.widths, got.bucket_edges, got.hub_edges) == \
        (want.widths, want.bucket_edges, want.hub_edges)


@pytest.mark.parametrize("nv_pad,ne_pad,kw", CONFIGS, ids=IDS)
def test_device_plan_matches_host_and_jax(nv_pad, ne_pad, kw):
    rng = np.random.default_rng(nv_pad + ne_pad)
    src, dst, w = _coalesced_slab(rng, nv_pad, ne_pad, **kw)
    assert prebin.rebin_eligible(nv_pad, ne_pad)
    want = DevicePlan.upload(BucketPlan.build(src, dst, w, nv_local=nv_pad),
                             "cpu")
    got = prebin.device_plan(torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(w), nv_local=nv_pad)
    assert_plans_equal(got, want)

    geom = jrebin.rebin_geometry(nv_pad, ne_pad)
    bks, heavy, self_loop, perm = jax.device_get(jrebin.device_rebin_plan(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), nv_pad=nv_pad,
        base=0, geometry=geom))
    mine = {b[1].shape[1]: b for b in got.buckets}
    for (width, _rows), (verts, dmat, wmat) in zip(geom, bks):
        n = int((np.asarray(verts) < nv_pad).sum())
        if width not in mine:
            assert n == 0
            continue
        v, d, ww, deg = (t.numpy() for t in mine[width])
        assert len(v) == n
        assert np.array_equal(v, np.asarray(verts)[:n])
        assert np.array_equal(d, np.asarray(dmat)[:n])
        assert np.array_equal(ww, np.asarray(wmat)[:n])
        assert np.array_equal(deg, np.bincount(
            src[src < nv_pad], minlength=nv_pad)[v])
    assert np.array_equal(got.self_loop.numpy(), np.asarray(self_loop))


def test_geometry_and_eligibility_match_jax(monkeypatch):
    classes = [(16, 64), (1024, 4096), (4096, 16384), (4096, 65536),
               (8192, 1 << 17), (16384, 1 << 19), (1 << 20, 1 << 22)]
    for nv, ne in classes:
        assert prebin.rebin_geometry(nv, ne) == jrebin.rebin_geometry(nv, ne)
        assert prebin.rebin_eligible(nv, ne) == jrebin.rebin_eligible(nv, ne)
    assert prebin.rebin_eligible(4096, 16384)
    assert prebin.rebin_eligible(8192, 1 << 17)
    assert not prebin.rebin_eligible(16384, 1 << 19)
    monkeypatch.setenv("CUVITE_REBIN_MAX_ELEMS", "1024")
    assert prebin.rebin_max_elems() == jrebin.rebin_max_elems() == 1024
    for nv, ne in classes:
        assert prebin.rebin_eligible(nv, ne) == jrebin.rebin_eligible(nv, ne)
    monkeypatch.setenv("CUVITE_REBIN_MAX_ELEMS", "nonsense")
    with pytest.warns(UserWarning):
        assert prebin.rebin_max_elems() == prebin.DEFAULT_REBIN_MAX_ELEMS
    monkeypatch.setenv("CUVITE_DEVICE_REBIN", "0")
    assert not prebin.device_rebin_enabled()


def test_device_plan_refuses_a_hub():
    src = np.zeros(8200, np.int32)
    dst = np.arange(8200, dtype=np.int32) % 9000 + 1
    w = np.ones(8200, np.float32)
    with pytest.raises(ValueError, match="not eligible"):
        prebin.device_plan(torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(w), nv_local=16384)


@pytest.fixture(scope="module")
def rmat10():
    g = jax_rmat(10, edge_factor=8, seed=3)
    return g, Graph.from_arrays(g.offsets, g.tails, g.weights)


def test_full_runs_identical_rebin_on_off(rmat10, monkeypatch):
    """Bucketed runs with device re-binning on (the default) and off give
    identical labels, Q and iterations, equal to JAX's; with it on, phase
    0 is the only host plan build."""
    calls = []
    orig = BucketPlan.build

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.delenv("CUVITE_DEVICE_REBIN", raising=False)
    monkeypatch.setattr(BucketPlan, "build", staticmethod(spy))
    on = louvain_phases(rmat10[1], device="cpu", engine="bucketed")
    assert calls == [1]
    monkeypatch.setenv("CUVITE_DEVICE_REBIN", "0")
    off = louvain_phases(rmat10[1], device="cpu", engine="bucketed")
    assert len(on.phases) == len(off.phases) >= 3
    assert on.rebinned_phases == list(range(1, len(on.convergence)))
    assert off.rebinned_phases == []
    assert all("rebin" in p.stages for p in on.phases[1:])
    ref = jax_louvain(rmat10[0])
    for r in (on, off):
        assert np.array_equal(r.communities, ref.communities)
        assert r.total_iterations == ref.total_iterations
        assert abs(r.modularity - ref.modularity) <= 1e-9
    assert on.modularity == off.modularity


def test_folded_device_plan_equals_folded_host_plans(rmat10):
    """The batched engine's re-binned plan of a folded batch slab equals
    the tenants' host plans folded and uploaded."""
    g8 = jax_rmat(8, edge_factor=8, seed=2)
    gs = [rmat10[1], Graph.from_arrays(g8.offsets, g8.tails, g8.weights)]
    batch = pbatch.batch_slabs(gs + gs[:1])
    want = DevicePlan.upload(pbatch.batch_bucket_plans(batch).fold(), "cpu")
    got = prebin.device_plan(*pbatch.fold_slab(
        torch.from_numpy(batch.src), torch.from_numpy(batch.dst),
        torch.from_numpy(batch.w), nv_pad=batch.nv_pad),
        nv_local=batch.b_pad * batch.nv_pad)
    assert_plans_equal(got, want)
    one = fold_plans([BucketPlan.build(batch.src[0], batch.dst[0],
                                       batch.w[0], nv_local=batch.nv_pad)],
                     batch.nv_pad)
    assert_plans_equal(DevicePlan.upload(one, "cpu"), DevicePlan.upload(
        BucketPlan.build(batch.src[0], batch.dst[0], batch.w[0],
                         nv_local=batch.nv_pad), "cpu"))
