"""Host-side CSR graph container (port of ``cuvite_tpu/core/graph.py``).

``offsets[nv+1]``, ``tails[ne]``, ``weights[ne]`` numpy arrays.  Graphs are
undirected and stored with both directions present (the Vite binary format
stores each undirected edge twice), so ``sum(weights) == 2m``.  Above
``native.MIN_NATIVE_EDGES`` edges the CSR builders and the weighted
degrees run in the native host runtime (``cuvite_tpu_torch/native``),
under the reference's conditions; the numpy code below is their plain
version, equal bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cuvite_tpu_torch import native
from cuvite_tpu_torch.core.types import Policy, default_policy


@dataclasses.dataclass
class Graph:
    """CSR graph: ``offsets[nv+1]``, ``tails[ne]``, ``weights[ne]``."""

    offsets: np.ndarray  # [nv+1] int64
    tails: np.ndarray    # [ne]   vertex dtype (global ids)
    weights: np.ndarray  # [ne]   weight dtype
    policy: Policy = dataclasses.field(default_factory=default_policy)

    def __post_init__(self) -> None:
        self.offsets = np.ascontiguousarray(self.offsets, dtype=np.int64)
        self.tails = np.ascontiguousarray(self.tails,
                                          dtype=self.policy.vertex_dtype)
        self.weights = np.ascontiguousarray(self.weights,
                                            dtype=self.policy.weight_dtype)

    @property
    def num_vertices(self) -> int:
        return len(self.offsets) - 1

    @property
    def num_edges(self) -> int:
        """Number of directed edge slots (2x the undirected edge count)."""
        return len(self.tails)

    def degrees(self) -> np.ndarray:
        """Per-vertex edge counts."""
        return np.diff(self.offsets)

    def weighted_degrees(self) -> np.ndarray:
        """Per-vertex sum of incident edge weights, self-loops included,
        accumulated in f64 in slab order and cast once."""
        if self.num_edges >= native.MIN_NATIVE_EDGES and native.available():
            return native.weighted_degrees(
                self.offsets, self.weights).astype(self.policy.weight_dtype)
        return np.bincount(
            self.sources(), weights=self.weights.astype(np.float64),
            minlength=self.num_vertices,
        ).astype(self.policy.weight_dtype)

    def sources(self) -> np.ndarray:
        """Per-edge source vertex id (the CSR row expanded)."""
        return np.repeat(
            np.arange(self.num_vertices, dtype=self.policy.vertex_dtype),
            self.degrees(),
        )

    def total_edge_weight_twice(self) -> float:
        """Sum of all weighted degrees = 2m; its reciprocal is the gain
        constant."""
        return float(self.weights.sum(dtype=np.float64))

    @staticmethod
    def from_arrays(offsets: np.ndarray, tails: np.ndarray,
                    weights: np.ndarray) -> "Graph":
        """Wrap existing CSR arrays (for example the reference package's
        ``Graph.offsets/tails/weights``) without changing them, so two
        implementations can be fed the very same graph.  The policy is the
        one the arrays' dtypes imply."""
        tails = np.asarray(tails)
        weights = np.asarray(weights)
        return Graph(offsets=offsets, tails=tails, weights=weights,
                     policy=Policy(vertex_dtype=tails.dtype,
                                   weight_dtype=weights.dtype))

    @staticmethod
    def from_edges(
        num_vertices: int,
        src: np.ndarray,
        dst: np.ndarray,
        weights: np.ndarray | None = None,
        symmetrize: bool = True,
        policy: Policy | None = None,
    ) -> "Graph":
        """Build a CSR graph from an edge list.

        With ``symmetrize=True`` each input edge (u, v), u != v, is inserted
        in both directions; self-loops are inserted once.  Duplicate edges
        are coalesced by summing their f64 weights in input order, then cast
        to the policy dtype once.
        """
        policy = policy or default_policy()
        big = len(src) >= native.MIN_NATIVE_EDGES and native.available()
        f32 = policy.weight_dtype == np.float32
        # Unit weights: the native builder counts duplicates with int32
        # ids and no f64 array; the counts are exact integers rounded
        # once, so this needs the f32 policy (a f64 one keeps the f64 sum).
        if big and weights is None and f32 and num_vertices <= 1 << 31:
            offsets, tails, wcnt = native.build_csr_unit(
                num_vertices, src, dst, symmetrize)
            return Graph(offsets=offsets,
                         tails=tails.astype(policy.vertex_dtype, copy=False),
                         weights=wcnt, policy=policy)
        # Weighted, large nv: the sort carries an int32 edge index instead
        # of the f64 weights (~24 B a slot against 32).  Small nv keeps
        # the generic builder, whose dense counting path wins there.
        if (big and weights is not None and f32
                and (1 << 22) < num_vertices <= (1 << 31)
                and (2 * len(src) if symmetrize else len(src)) < (1 << 31)):
            offsets, tails, w32 = native.build_csr_w(
                num_vertices, src, dst, weights, symmetrize)
            return Graph(offsets=offsets,
                         tails=tails.astype(policy.vertex_dtype, copy=False),
                         weights=w32, policy=policy)
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if weights is None:
            w = np.ones(len(src), dtype=np.float64)
        else:
            w = np.asarray(weights, dtype=np.float64)
        # The generic builder's radix key src * nv + dst fits uint64 only
        # while nv <= 2^32.
        if big and num_vertices <= 1 << 32:
            offsets, tails, wsum = native.build_csr(
                num_vertices, src, dst, w, symmetrize)
            return Graph(offsets=offsets,
                         tails=tails.astype(policy.vertex_dtype),
                         weights=wsum.astype(policy.weight_dtype),
                         policy=policy)
        if symmetrize:
            keep = src != dst
            src2 = np.concatenate([src, dst[keep]])
            dst2 = np.concatenate([dst, src[keep]])
            w2 = np.concatenate([w, w[keep]])
        else:
            src2, dst2, w2 = src, dst, w
        # Coalesce duplicates and sort into CSR order.
        key = src2 * np.int64(num_vertices) + dst2
        order = np.argsort(key, kind="stable")
        key = key[order]
        uniq_mask = np.ones(len(key), dtype=bool)
        uniq_mask[1:] = key[1:] != key[:-1]
        seg_ids = np.cumsum(uniq_mask) - 1
        n_uniq = int(seg_ids[-1]) + 1 if len(seg_ids) else 0
        # bincount adds in index order, like a sequential f64 loop.
        w_out = np.bincount(seg_ids, weights=w2[order], minlength=n_uniq)
        uniq_key = key[uniq_mask]
        src_u = uniq_key // np.int64(max(num_vertices, 1))
        dst_u = uniq_key - src_u * np.int64(num_vertices)
        counts = np.bincount(src_u, minlength=num_vertices)
        offsets = np.zeros(num_vertices + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return Graph(
            offsets=offsets,
            tails=dst_u.astype(policy.vertex_dtype),
            weights=w_out.astype(policy.weight_dtype),
            policy=policy,
        )
