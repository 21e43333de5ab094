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


class ViteStreamWriter:
    """Chunked Vite writer for graphs too large to hold as a ``Graph``
    (reference ``cuvite_tpu/io/vite.py:105``; the converters' writer).

    The caller gives the final ``(nv, ne)`` and the CSR offsets up front
    (a two-pass pipeline counts the degrees first), then fills the edge
    records in any slices through :meth:`write_edges`; memory stays
    O(chunk), never O(ne).  The file is byte-equal to :func:`write_vite`'s
    for the same CSR."""

    def __init__(self, path: str, nv: int, ne: int, bits64: bool = True):
        if nv < 0 or ne < 0:
            raise ValueError(f"bad shape nv={nv}, ne={ne}")
        self.path = path
        self.nv = nv
        self.ne = ne
        self.bits64 = bits64
        self._elem = _elem_dtype(bits64)
        self._edge = _edge_dtype(bits64)
        if not bits64 and (nv > np.iinfo(np.int32).max
                           or ne > np.iinfo(np.int32).max):
            raise ValueError(
                f"nv={nv} / ne={ne} overflow the 32-bit Vite layout; "
                "pass bits64=True")
        self._edges_offset = 2 * self._elem.itemsize \
            + (nv + 1) * self._elem.itemsize
        total = self._edges_offset + ne * self._edge.itemsize
        with open(path, "wb") as f:
            np.array([nv, ne], dtype=self._elem).tofile(f)
            f.truncate(total)
        self._offsets_written = False
        # One read-write memmap over the edge records, kept open.
        self._edges_mm = (np.memmap(path, dtype=self._edge, mode="r+",
                                    offset=self._edges_offset, shape=(ne,))
                          if ne else None)

    def write_offsets(self, offsets: np.ndarray) -> None:
        offsets = np.asarray(offsets, dtype=np.int64)
        if (len(offsets) != self.nv + 1 or offsets[0] != 0
                or offsets[-1] != self.ne
                or np.any(np.diff(offsets) < 0)):
            raise ValueError("offsets must be monotone, [0 .. ne], len nv+1")
        mm = np.memmap(self.path, dtype=self._elem, mode="r+",
                       offset=2 * self._elem.itemsize, shape=(self.nv + 1,))
        mm[:] = offsets.astype(self._elem)
        mm.flush()
        del mm
        self._offsets_written = True

    def write_edges(self, index, tails: np.ndarray,
                    weights: np.ndarray) -> None:
        """Write edge records at ``index``: an int start of a contiguous
        slice, or one position per record."""
        rec = np.empty(len(tails), dtype=self._edge)
        rec["tail"] = tails
        rec["weight"] = weights
        if isinstance(index, (int, np.integer)):
            self._edges_mm[int(index):int(index) + len(rec)] = rec
        else:
            self._edges_mm[np.asarray(index, dtype=np.int64)] = rec

    def read_edges(self, lo: int, hi: int) -> np.ndarray:
        """The records [lo, hi) (the canonicalizing pass reads them)."""
        return np.array(self._edges_mm[lo:hi])

    def close(self) -> None:
        if not self._offsets_written:
            raise ValueError(f"{self.path}: offsets were never written")
        if self._edges_mm is not None:
            self._edges_mm.flush()
            del self._edges_mm
            self._edges_mm = None


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
