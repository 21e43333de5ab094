"""Whether the answers of the measured window are correct.

Every answer is a clustering of one input graph: labels for its vertices
and the modularity Q the system reports for them.  After the window, with
the system's state freed, the plain reference (``benchmark/reference``)
rebuilds each graph from the edge list the benchmark made and judges:

- ``missing``: answers that never came, or whose labels are not one
  community id for each vertex;
- ``q_gap``: the widest gap, over every distinct answer, between the Q
  the system reports and the reference's float64 Q of its labels;
- ``label_mismatch``: the most vertices, over the answers compared, that
  the system clusters otherwise than the reference's own clustering (the
  partitions compared, not their ids).  In a solve cell every answer is
  compared; in a batch cell every answer of a sample of the pool's
  graphs, drawn from the seed.

A graph's answers are grouped by their bytes first, so an answer repeated
through the window is judged once.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from benchmark.reference import louvain as ref

NUMBERS = ("missing", "label_mismatch", "q_gap")


@dataclasses.dataclass
class Verdict:
    numbers: dict        # name -> value
    limits: dict         # name -> limit
    attempted: int
    failed: int

    @property
    def correct(self) -> bool:
        return all(self.numbers[k] <= self.limits[k] for k in NUMBERS)

    def lines(self) -> list:
        return [f"check {k} {self.numbers[k]!r} limit {self.limits[k]!r}"
                for k in NUMBERS]

    def as_dict(self) -> dict:
        return {k: {"value": self.numbers[k], "limit": self.limits[k]}
                for k in NUMBERS}


def partition(labels: np.ndarray) -> np.ndarray:
    """Each vertex's community named by its smallest member: equal for
    two labellings exactly when they are the same partition."""
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    return first[inv.reshape(-1)]


def _well_formed(labels, nv: int) -> bool:
    return (isinstance(labels, np.ndarray) and labels.shape == (nv,)
            and np.issubdtype(labels.dtype, np.integer)
            and (nv == 0 or (labels.min() >= 0 and labels.max() < nv)))


def judge(graphs: list, answers: list, compare: set, limits: dict,
          device) -> Verdict:
    """``graphs[i]`` = (nv, src, dst) host arrays as handed to the system;
    ``answers[i]`` = the window's answers for graph i, each (labels, Q) or
    None for one that never came; ``compare``: the graphs whose labels are
    compared with the reference's clustering."""
    missing = label_mismatch = 0
    q_gap = 0.0
    attempted = failed = 0
    for i, (nv, src, dst) in enumerate(graphs):
        if not answers[i]:
            continue
        g = ref.build_graph(nv, torch.from_numpy(np.asarray(src)).to(device),
                            torch.from_numpy(np.asarray(dst)).to(device))
        want = None
        if i in compare:
            labels, _, _ = ref.louvain(g)
            want = partition(labels.cpu().numpy())
        distinct: dict = {}
        for ans in answers[i]:
            attempted += 1
            if ans is None or not _well_formed(ans[0], nv):
                missing += 1
                failed += 1
                continue
            key = (hashlib.sha1(ans[0].tobytes()).hexdigest(), ans[1])
            if key not in distinct:
                labels, q = ans
                gap = abs(float(q) - ref.modularity(
                    g, torch.from_numpy(labels.astype(np.int64)).to(device)))
                gap = gap if np.isfinite(gap) else float("inf")
                diff = (int(np.count_nonzero(partition(labels) != want))
                        if want is not None else 0)
                distinct[key] = (gap, diff)
                q_gap = max(q_gap, gap)
                label_mismatch = max(label_mismatch, diff)
            gap, diff = distinct[key]
            if not (gap <= limits["q_gap"]
                    and diff <= limits["label_mismatch"]):
                failed += 1
        del g
    return Verdict(numbers={"missing": missing,
                           "label_mismatch": label_mismatch,
                           "q_gap": q_gap},
                   limits=dict(limits), attempted=attempted, failed=failed)
