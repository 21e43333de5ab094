"""Inter-phase coarsening on the host (port of
``cuvite_tpu/coarsen/rebuild.py:26-67``).

Communities become vertices: renumber the surviving communities densely,
then coalesce the relabeled edge list.  Intra-community weight collapses
onto the diagonal as self-loops, which keeps modularity consistent across
phases.  Above ``native.MIN_NATIVE_EDGES`` edges the relabel and the
coalesce run fused in the native host runtime (``native.coarsen_csr``),
as in the reference; the numpy relabel plus ``Graph.from_edges`` is its
plain version.  The sort and fused engines coarsen on the card instead
(``coarsen/device.py``).
"""

from __future__ import annotations

import numpy as np

from cuvite_tpu_torch import native
from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import Policy


def renumber_communities(comm: np.ndarray) -> tuple[np.ndarray, int]:
    """Map arbitrary community labels to dense ids [0, nc), smallest
    label first.  Returns (dense_labels, nc)."""
    uniq, dense = np.unique(comm, return_inverse=True)
    return dense.astype(np.int64).reshape(-1), int(len(uniq))


def coarsen_graph(graph: Graph, dense_comm: np.ndarray, nc: int,
                  policy: Policy | None = None) -> Graph:
    """Build the next-phase graph whose vertices are the nc communities."""
    policy = policy or graph.policy
    # Fused: relabel and coalesce straight off the CSR, with no expanded
    # int64/f64 edge list.  The same stable key order, f64 sums and one
    # f32 cast as the numpy route below.
    if (graph.num_edges >= native.MIN_NATIVE_EDGES and native.available()
            and nc <= 1 << 31 and policy.weight_dtype == np.float32):
        offsets, tails, w = native.coarsen_csr(
            graph.offsets, graph.tails, graph.weights, dense_comm, nc)
        return Graph(offsets=offsets,
                     tails=tails.astype(policy.vertex_dtype, copy=False),
                     weights=w, policy=policy)
    src = dense_comm[graph.sources()]
    dst = dense_comm[graph.tails.astype(np.int64)]
    # The slab already holds both edge directions: a plain coalesce.
    return Graph.from_edges(
        nc, src, dst, weights=graph.weights.astype(np.float64),
        symmetrize=False, policy=policy,
    )
