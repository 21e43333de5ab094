"""cuvite_tpu_torch's fused engine held against the JAX package's on the
CPU: the same numpy graphs go into both.

Whole runs give identical labels, per-phase iterations and vertex counts,
and Q to 1e-9; the convergence rows the same iteration and moved counts
and their Q within 1e-6 (the reference's in-loop Q is float32, the
port's float64).  ``FUSED_SHRINK_EDGES`` is lowered in both packages to
run the one-phase calls with device coarsenings between them, dense ones
included.  Every graph has integer weights, the exactness domain.
"""

import jax
import numpy as np
import pytest
import torch

import cuvite_tpu.louvain.driver as jax_driver
import cuvite_tpu_torch.louvain.driver as driver
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu_torch import Graph, louvain_phases

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _free_jax_executables():
    """The reference compiles a program per slab class; free them after
    each test, so a test worker does not accumulate their memory maps."""
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


def _assert_same_fused_run(jr, tr):
    assert np.array_equal(tr.communities, jr.communities)
    assert [p.iterations for p in tr.phases] == \
        [p.iterations for p in jr.phases]
    assert [p.num_vertices for p in tr.phases] == \
        [p.num_vertices for p in jr.phases]
    assert [p.num_edges for p in tr.phases] == \
        [p.num_edges for p in jr.phases]
    assert tr.total_iterations == jr.total_iterations
    assert abs(tr.modularity - jr.modularity) <= 1e-9
    assert len(tr.convergence) == len(jr.convergence) == len(tr.phases)
    for tc, jc in zip(tr.convergence, jr.convergence):
        assert (tc.phase, tc.iterations, tc.gained) == \
            (jc.phase, jc.iterations, jc.gained)
        assert [r.moved for r in tc.rows] == [r.moved for r in jc.rows]
        assert np.allclose([r.q for r in tc.rows], [r.q for r in jc.rows],
                           rtol=0, atol=1e-6)


@pytest.mark.parametrize("cycling", [False, True])
@pytest.mark.parametrize("name", ["karate", "two_cliques", "rmat10",
                                  "rmat12"])
def test_fused_matches_jax(name, cycling, request):
    jg = request.getfixturevalue(name)
    jr = jax_louvain(jg, engine="fused", threshold_cycling=cycling)
    tr = louvain_phases(_port_graph(jg), engine="fused",
                        threshold_cycling=cycling, device="cpu")
    _assert_same_fused_run(jr, tr)
    # One call below FUSED_SHRINK_EDGES: no coarsening between phases.
    assert [p.coalesce for p in tr.phases] == [None] * len(tr.phases)


@pytest.mark.parametrize("name,shrink,cycling", [
    ("rmat12", 256, False),
    ("rmat10", 1, True),
])
def test_fused_device_coarsenings_match_jax(name, shrink, cycling, request,
                                            monkeypatch):
    """One phase per call and a device coarsening between calls; with
    ``shrink`` = 1 every call is one phase and the cycling safety net runs
    as its own call."""
    jg = request.getfixturevalue(name)
    monkeypatch.setattr(jax_driver, "FUSED_SHRINK_EDGES", shrink)
    monkeypatch.setattr(driver, "FUSED_SHRINK_EDGES", shrink)
    jr = jax_louvain(jg, engine="fused", threshold_cycling=cycling)
    tr = louvain_phases(_port_graph(jg), engine="fused",
                        threshold_cycling=cycling, device="cpu")
    _assert_same_fused_run(jr, tr)
    assert "dense" in [p.coalesce for p in tr.phases]


def test_fused_one_phase_and_sort_engine_agree(karate, rmat12):
    """One phase is the sort engine's first phase; the whole run reaches
    the sort engine's Q on R-MAT 12."""
    g = _port_graph(karate)
    tf = louvain_phases(g, engine="fused", one_phase=True, device="cpu")
    ts = louvain_phases(g, engine="sort", one_phase=True, device="cpu")
    assert np.array_equal(tf.communities, ts.communities)
    assert abs(tf.modularity - ts.modularity) <= 1e-12
    g = _port_graph(rmat12)
    tf = louvain_phases(g, engine="fused", device="cpu")
    ts = louvain_phases(g, engine="sort", device="cpu")
    assert np.array_equal(tf.communities, ts.communities)
    assert abs(tf.modularity - ts.modularity) <= 1e-9


def test_fused_downgrades_like_jax(karate):
    """Schedules the fused program does not cover run the bucketed engine
    with the reference's warning."""
    g = _port_graph(karate)
    with pytest.warns(UserWarning, match="fused"):
        tr = louvain_phases(g, engine="fused", et_mode=1, device="cpu")
    tb = louvain_phases(g, engine="bucketed", et_mode=1, device="cpu")
    assert np.array_equal(tr.communities, tb.communities)
    assert [c.gained for c in tr.convergence] == [True, True, False]


def test_device_compose_labels_matches_jax():
    from cuvite_tpu.coarsen.device import device_compose_labels as jcompose
    from cuvite_tpu_torch.coarsen.device import (
        device_compose_labels,
        device_renumber,
    )

    rng = np.random.default_rng(3)
    nv_pad = 1024
    labels = rng.integers(0, 300, nv_pad).astype(np.int32)
    mask = np.arange(nv_pad) < 1000
    dmap, nc = device_renumber(torch.from_numpy(labels),
                               torch.from_numpy(mask), nv_pad=nv_pad)
    comm_all = rng.integers(0, nv_pad, 5000).astype(np.int32)
    got = device_compose_labels(dmap, torch.from_numpy(labels),
                                torch.from_numpy(comm_all))
    ref = jcompose(dmap.numpy(), labels, comm_all)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32 and int(got.max()) < int(nc)
