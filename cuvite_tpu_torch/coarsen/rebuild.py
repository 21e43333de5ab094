"""Inter-phase coarsening on the host (port of
``cuvite_tpu/coarsen/rebuild.py:26-67``, numpy path).

Communities become vertices: renumber the surviving communities densely,
then coalesce the relabeled edge list.  Intra-community weight collapses
onto the diagonal as self-loops, which keeps modularity consistent across
phases.  Device coarsening (the reference's ``coarsen/device.py`` with the
``seg_coalesce`` kernel) is not ported yet.
"""

from __future__ import annotations

import numpy as np

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
    src = dense_comm[graph.sources()]
    dst = dense_comm[graph.tails.astype(np.int64)]
    # The slab already holds both edge directions: a plain coalesce.
    return Graph.from_edges(
        nc, src, dst, weights=graph.weights.astype(np.float64),
        symmetrize=False, policy=policy,
    )
