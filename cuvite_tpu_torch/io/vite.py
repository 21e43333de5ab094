"""Vite binary graph format reader/writer (port of ``cuvite_tpu/io/vite.py``).

On-disk layout (reference distgraph.cpp:99-197):

    [nv: GraphElem] [ne: GraphElem]
    [edgeListIndexes: (nv+1) x GraphElem]
    [edges: ne x Edge{tail: GraphElem, weight: GraphWeight}]

GraphElem/GraphWeight are int64/double by default, or int32/float with
``bits64=False`` (the reference's ``USE_32_BIT_GRAPH`` build).

From ``native.MIN_NATIVE_EDGES`` edges on, the edge records are read and
written by the native host runtime (one sequential read or write and a
parallel (de)interleave); the numpy memmap code is its plain version.
"""

from __future__ import annotations

import os

import numpy as np

from cuvite_tpu_torch import native
from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import Policy, default_policy, wide_policy


def _elem_dtype(bits64: bool) -> np.dtype:
    return np.dtype("<i8") if bits64 else np.dtype("<i4")


def _edge_dtype(bits64: bool) -> np.dtype:
    if bits64:
        return np.dtype([("tail", "<i8"), ("weight", "<f8")])
    return np.dtype([("tail", "<i4"), ("weight", "<f4")])


def read_vite(path: str, bits64: bool = True,
              policy: Policy | None = None,
              vertex_range: tuple[int, int] | None = None) -> Graph:
    """Read a Vite binary graph, or with ``vertex_range=(lo, hi)`` only the
    rows of vertices ``[lo, hi)``: the local slice, its offsets re-based
    to 0 and its tails global (reference distgraph.cpp:194-197).  Raises
    ValueError on a header or offset table that does not fit the file (a
    wrong ``bits64`` flag) and on a range outside the graph."""
    policy = policy or (wide_policy() if bits64 else default_policy())
    elem = _elem_dtype(bits64)
    edge = _edge_dtype(bits64)
    header = np.fromfile(path, dtype=elem, count=2)
    if len(header) != 2:
        raise ValueError(f"{path}: truncated Vite header")
    nv, ne = int(header[0]), int(header[1])
    expected = 2 * elem.itemsize + (nv + 1) * elem.itemsize \
        + ne * edge.itemsize
    actual = os.path.getsize(path)
    if nv < 0 or ne < 0 or actual < expected:
        raise ValueError(
            f"{path}: header (nv={nv}, ne={ne}) implies {expected} bytes but "
            f"file has {actual} — wrong bits64={bits64} flag or corrupt file"
        )
    lo, hi = (0, nv) if vertex_range is None else map(int, vertex_range)
    if not 0 <= lo <= hi <= nv:
        raise ValueError(f"bad vertex range {(lo, hi)} for nv={nv}")
    offsets = np.array(np.memmap(path, dtype=elem, mode="r",
                                 offset=2 * elem.itemsize, shape=(nv + 1,))
                       [lo: hi + 1], dtype=np.int64)
    e0, e1 = int(offsets[0]), int(offsets[-1])
    if e0 < 0 or e1 > ne or np.any(np.diff(offsets) < 0):
        raise ValueError(
            f"{path}: non-monotone CSR offsets — wrong bits64={bits64} flag "
            f"or corrupt file"
        )
    if e1 - e0 >= native.MIN_NATIVE_EDGES and native.available():
        tails, weights = native.vite_edges(path, bits64, nv, e0, e1)
        return Graph(offsets=offsets - e0,
                     tails=tails.astype(policy.vertex_dtype),
                     weights=weights.astype(policy.weight_dtype),
                     policy=policy)
    edges_offset = 2 * elem.itemsize + (nv + 1) * elem.itemsize
    edges = (np.memmap(path, dtype=edge, mode="r",
                       offset=edges_offset + e0 * edge.itemsize,
                       shape=(e1 - e0,))
             if e1 > e0 else np.zeros(0, dtype=edge))
    return Graph(
        offsets=offsets - e0,
        tails=np.array(edges["tail"], dtype=policy.vertex_dtype),
        weights=np.array(edges["weight"], dtype=policy.weight_dtype),
        policy=policy,
    )


def write_vite(path: str, graph: Graph, bits64: bool = True) -> None:
    """Write a graph in the Vite binary format (reference
    distgraph.cpp:936-1014)."""
    if graph.num_edges >= native.MIN_NATIVE_EDGES and native.available():
        native.vite_write(path, bits64, graph.offsets,
                          graph.tails.astype(np.int64),
                          graph.weights.astype(np.float64))
        return
    elem = _elem_dtype(bits64)
    rec = np.empty(graph.num_edges, dtype=_edge_dtype(bits64))
    rec["tail"] = graph.tails
    rec["weight"] = graph.weights
    with open(path, "wb") as f:
        np.array([graph.num_vertices, graph.num_edges], dtype=elem).tofile(f)
        graph.offsets.astype(elem).tofile(f)
        rec.tofile(f)
