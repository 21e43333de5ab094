"""cuvite_tpu_torch's sort-engine sweep (``louvain_step_local``) held
against the JAX package's ``make_single_step`` on the CPU.

The same padded slab (with its padding rows), degrees and assignment go
into both.  R-MAT edges with dyadic weights (multiples of 1/8): every
float sum is exact, so the port's f64 sums rounded once equal the
reference's f32 sums and the targets and move counts are identical.  Q is
f64 in the port and f32 in the reference, hence the 1e-6 tolerance.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cuvite_tpu.core.distgraph import DistGraph as JDistGraph
from cuvite_tpu.core.graph import Graph as JGraph
from cuvite_tpu.io.generate import rmat_edges_numpy
from cuvite_tpu.louvain.step import make_single_step
from cuvite_tpu_torch.louvain.step import louvain_step_local


def _dyadic_rmat(scale):
    src, dst = rmat_edges_numpy(scale, 16 << scale, 1, 0.57, 0.19, 0.19)
    keep = src != dst
    rng = np.random.default_rng(scale)
    w = rng.integers(1, 32, int(keep.sum())) / 8.0
    return JGraph.from_edges(1 << scale, src[keep], dst[keep], weights=w)


@pytest.mark.parametrize("scale", [10, 12])
@pytest.mark.parametrize("start", ["identity", "random"])
def test_sweep_matches_jax_single_step(scale, start):
    jg = _dyadic_rmat(scale)
    dg = JDistGraph.build(jg, 1)
    sh = dg.shards[0]
    nv = dg.nv_pad
    assert len(sh.src) > jg.num_edges   # padding rows are in the slab
    vdeg = dg.padded_weighted_degrees().astype(np.float32)
    constant = np.float32(1.0 / jg.total_edge_weight_twice())
    comm = np.arange(nv, dtype=np.int32)
    if start == "random":
        rng = np.random.default_rng(scale + 1)
        pool = rng.choice(jg.num_vertices, jg.num_vertices // 4,
                          replace=False)
        comm[: jg.num_vertices] = rng.choice(pool, jg.num_vertices)
    step = make_single_step(nv)
    jt, jmod, jmoved, _ = step(jnp.asarray(sh.src), jnp.asarray(sh.dst),
                               jnp.asarray(sh.w), jnp.asarray(comm),
                               jnp.asarray(vdeg), jnp.asarray(constant))
    out = louvain_step_local(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (sh.src, sh.dst, sh.w, comm, vdeg)),
        1.0 / jg.total_edge_weight_twice())
    assert out.target.dtype == torch.int32
    assert np.array_equal(out.target.numpy(), np.asarray(jt))
    assert int(out.n_moved) == int(jmoved) > 0
    assert float(out.modularity) == pytest.approx(float(jmod), abs=1e-6)
