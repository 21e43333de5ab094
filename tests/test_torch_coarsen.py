"""cuvite_tpu_torch's device coarsening held against the JAX package's on
the CPU, and against the host oracle ``coarsen_graph``.

The same numpy graphs and labels go into both.  Weights are unit or dyadic,
so every run sum is exact in f32: the port's f64 sums rounded once, the
reference's f32 sums and the host's f64 sums are bit-equal.  Both of the
port's engines (the ``seg_coalesce`` twin and the packed sort) are run.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cuvite_tpu.coarsen.device import device_coarsen_slab as jax_coarsen
from cuvite_tpu.core.distgraph import DistGraph as JDistGraph
from cuvite_tpu.core.graph import Graph as JGraph
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu_torch import Graph
from cuvite_tpu_torch.coarsen.device import (
    device_coarsen_slab,
    device_renumber,
    device_weighted_degrees,
    maybe_shrink_to_class,
    shrink_slab,
)
from cuvite_tpu_torch.coarsen.rebuild import coarsen_graph, \
    renumber_communities
from cuvite_tpu_torch.core.distgraph import DistGraph

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ENGINES = ("dense", "sort")


@pytest.fixture(scope="module")
def rmat10():
    return jax_rmat(10, edge_factor=8, seed=3)


def _port(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


def _labels(nv, nv_pad, rng, gapped=False):
    """Padded-space labels: every real vertex points at a real vertex id
    (a sparse subset of them when ``gapped``); padding vertices at
    nv_pad - 1."""
    pool = (rng.choice(nv, size=max(nv // 13, 2), replace=False) if gapped
            else np.arange(nv))
    lab = np.full(nv_pad, nv_pad - 1, dtype=np.int64)
    lab[:nv] = rng.choice(pool, size=nv)
    return lab


def _port_coarse(jg, lab, engine):
    dg = DistGraph.build(_port(jg))
    src, dst, w = dg.device_slab("cpu")
    out = device_coarsen_slab(
        src, dst, w, torch.from_numpy(lab.astype(np.int32)),
        torch.from_numpy(dg.vertex_mask()), nv_pad=dg.nv_pad,
        coalesce=engine)
    src2, dst2, w2, dmap, nc, ne2 = out
    # Padding contract after the compacted prefix.
    assert (src2[ne2:] == dg.nv_pad).all() and (w2[ne2:] == 0).all()
    return (src2[:ne2].numpy(), dst2[:ne2].numpy(), w2[:ne2].numpy(),
            dmap.numpy(), int(nc), ne2, dg)


def _check_against_jax_and_host(jg, lab, engine):
    src2, dst2, w2, dmap, nc, ne2, dg = _port_coarse(jg, lab, engine)
    jdg = JDistGraph.build(jg, 1)
    sh = jdg.shards[0]
    assert jdg.nv_pad == dg.nv_pad
    js, jd, jw, jdmap, jnc, jne2 = jax_coarsen(
        jnp.asarray(sh.src), jnp.asarray(sh.dst), jnp.asarray(sh.w),
        jnp.asarray(lab.astype(np.int32)), jnp.asarray(jdg.vertex_mask()),
        nv_pad=jdg.nv_pad, coalesce="xla")
    assert (nc, ne2) == (int(jnc), int(jne2))
    assert np.array_equal(src2, np.asarray(js)[:ne2])
    assert np.array_equal(dst2, np.asarray(jd)[:ne2])
    assert np.array_equal(w2, np.asarray(jw)[:ne2])
    comm_old = lab[dg.old_to_pad]
    assert np.array_equal(dmap[comm_old], np.asarray(jdmap)[comm_old])
    # The host oracle: renumber + coalesce on numpy.
    dense, nc_h = renumber_communities(comm_old)
    gh = coarsen_graph(_port(jg), dense, nc_h)
    assert nc == nc_h and np.array_equal(dmap[comm_old], dense)
    assert np.array_equal(src2, gh.sources())
    assert np.array_equal(dst2, gh.tails)
    assert np.array_equal(w2, gh.weights)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("gapped", [False, True],
                         ids=["dense-ish", "gapped-labels"])
def test_rmat10_matches_jax_and_host(rmat10, engine, gapped):
    rng = np.random.default_rng(7)
    nv_pad = DistGraph.build(_port(rmat10)).nv_pad
    lab = _labels(rmat10.num_vertices, nv_pad, rng, gapped=gapped)
    _check_against_jax_and_host(rmat10, lab, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_two_cliques_collapse_to_self_loops(two_cliques, engine):
    lab = np.arange(16, dtype=np.int64)
    lab[:5] = 0
    lab[5:10] = 5
    _check_against_jax_and_host(two_cliques, lab, engine)
    src2, dst2, w2, _, nc, ne2, _ = _port_coarse(two_cliques, lab, engine)
    assert nc == 2 and ne2 == 4
    # Both directions of the 10 edges of each K5 land on its diagonal;
    # the bridge survives both ways.
    assert src2.tolist() == [0, 0, 1, 1] and dst2.tolist() == [0, 1, 0, 1]
    assert w2.tolist() == [20.0, 1.0, 1.0, 20.0]


@pytest.mark.parametrize("engine", ENGINES)
def test_dyadic_weights_match_jax_and_host(engine):
    rng = np.random.default_rng(3)
    nv = 96
    jg = JGraph.from_edges(nv, rng.integers(0, nv, 600),
                           rng.integers(0, nv, 600),
                           weights=rng.integers(1, 64, 600) / 8.0)
    lab = _labels(nv, 128, rng)
    _check_against_jax_and_host(jg, lab, engine)


def test_device_renumber_matches_np_unique(rmat10):
    rng = np.random.default_rng(11)
    nv = rmat10.num_vertices
    lab = _labels(nv, 1024, rng, gapped=True)
    mask = np.zeros(1024, dtype=bool)
    mask[:nv] = True
    dmap, nc = device_renumber(torch.from_numpy(lab.astype(np.int32)),
                               torch.from_numpy(mask), nv_pad=1024)
    dense, nc_h = renumber_communities(lab[:nv])
    assert int(nc) == nc_h
    assert np.array_equal(dmap.numpy()[lab[:nv]], dense)


def test_shrink_slab_and_class_policy():
    src = torch.tensor([0, 1, 2, 64, 64, 64, 64, 64], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    w = torch.ones(8)
    s, d, ww = shrink_slab(src, dst, w, new_nv_pad=4, new_ne_pad=4)
    assert s.shape == d.shape == ww.shape == (4,)
    # Real ids survive; old sentinels (64) become the new class's.
    assert s.tolist() == [0, 1, 2, 4] and s.dtype == torch.int32
    # The port's class is exact: ne2 rows, nv_pad = next_pow2(nc).
    s, d, ww, nv_pad = maybe_shrink_to_class(src, dst, w, nc=3, ne2=3,
                                             nv_pad=64)
    assert nv_pad == 4 and s.tolist() == [0, 1, 2] and d.numel() == 3
    # Already exact: the slab is kept as it is.
    exact = (s, d, ww)
    same = maybe_shrink_to_class(*exact, nc=3, ne2=3, nv_pad=4)
    assert all(a is b for a, b in zip(same, exact)) and same[3] == 4


def test_device_weighted_degrees_match_host(rmat10):
    dg = DistGraph.build(_port(rmat10))
    src, _, w = dg.device_slab("cpu")
    got = device_weighted_degrees(src, w, nv_pad=dg.nv_pad)
    assert np.array_equal(got.numpy(), dg.padded_weighted_degrees())
