"""Host-side modularity oracle, numpy float64 (port of
``cuvite_tpu/evaluate/modularity.py``).

    Q = sum_c e_c / (2m)  -  sum_c (a_c / 2m)^2

where e_c is the total weight of edges with both endpoints in community c
(both directions counted) and a_c the total weighted degree of community c.
"""

from __future__ import annotations

import numpy as np

from cuvite_tpu_torch.core.graph import Graph


def modularity(graph: Graph, comm: np.ndarray) -> float:
    comm = np.asarray(comm, dtype=np.int64)
    src_c = comm[graph.sources()]
    dst_c = comm[graph.tails.astype(np.int64)]
    w = graph.weights.astype(np.float64)
    two_m = w.sum()
    e_in = w[src_c == dst_c].sum()
    nc = int(comm.max()) + 1 if len(comm) else 0
    a_c = np.bincount(src_c, weights=w, minlength=nc)
    return float(e_in / two_m - np.square(a_c / two_m).sum())


def write_communities(path: str, communities: np.ndarray) -> None:
    """Write the ``.communities`` file: one label per line, vertex order."""
    np.savetxt(path, np.asarray(communities, dtype=np.int64), fmt="%d")
