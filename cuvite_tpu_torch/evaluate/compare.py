"""Ground-truth community comparison: precision/recall/F-score + Gini (port
of ``cuvite_tpu/evaluate/compare.py:28-133``, numpy and scipy only).

Equivalent of the reference application's compare_communities
(compare.cpp:8-256), which counts vertex pairs that agree between ground
truth C1 and output C2:

    TP (Same-Same): pairs co-clustered in both
    FN (Same-Diff): co-clustered in truth, split in output
    FP (Diff-Same): split in truth, co-clustered in output

The reference enumerates all intra-community pairs with OpenMP; here the same
counts come from the contingency table n_ij = |{v : C1[v]=i and C2[v]=j}|:
TP = sum C(n_ij,2), pairs-same-in-C1 = sum C(a_i,2), pairs-same-in-C2 =
sum C(b_j,2) — O(N) instead of O(sum of squared community sizes).

Gini coefficient of the cluster-size distribution replicates
compute_gini_coeff (compare.cpp:260-286).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class CompareResult:
    n_vertices: int
    n_truth_comms: int
    n_output_comms: int
    true_positive: int   # Same-Same
    false_negative: int  # Same-Diff
    false_positive: int  # Diff-Same
    precision: float
    recall: float
    f_score: float
    gini_truth: float
    gini_output: float

    def report(self) -> str:
        """Formatted like the reference's rank-0 output (compare.cpp:228-246)."""
        return "\n".join([
            "*******************************************",
            "Communities comparison statistics:",
            "*******************************************",
            f"|C1| (truth)       : {self.n_vertices}",
            f"#communities in C1 : {self.n_truth_comms}",
            f"|C2| (output)      : {self.n_vertices}",
            f"#communities in C2 : {self.n_output_comms}",
            "-------------------------------------------",
            f"Same-Same (True positive)  : {self.true_positive}",
            f"Same-Diff (False negative) : {self.false_negative}",
            f"Diff-Same (False positive) : {self.false_positive}",
            "-------------------------------------------",
            f"Precision :  {self.precision:.6f} ({self.precision * 100:.4f})",
            f"Recall    :  {self.recall:.6f} ({self.recall * 100:.4f})",
            f"F-score   :  {self.f_score:.6f}",
            "-------------------------------------------",
            f"Gini coefficient, C1  :  {self.gini_truth:.6f}",
            f"Gini coefficient, C2  :  {self.gini_output:.6f}",
            "*******************************************",
        ])


def _pairs(x: np.ndarray) -> int:
    return int((x.astype(np.int64) * (x.astype(np.int64) - 1) // 2).sum())


def gini_coefficient(sizes: np.ndarray) -> float:
    """compute_gini_coeff (compare.cpp:260-286): sizes sorted ascending,
    G = 2*sum((i+1)*s_i) / (n*sum(s_i)) - (n+1)/n."""
    s = np.sort(np.asarray(sizes, dtype=np.float64))
    n = len(s)
    if n == 0 or s.sum() == 0:
        return 0.0
    num = ((np.arange(1, n + 1)) * s).sum()
    return float(2.0 * num / (n * s.sum()) - (n + 1) / n)


def compare_communities(truth: np.ndarray, output: np.ndarray) -> CompareResult:
    truth = np.asarray(truth, dtype=np.int64)
    output = np.asarray(output, dtype=np.int64)
    assert len(truth) == len(output) and len(truth) > 0
    n = len(truth)
    nc1 = int(truth.max()) + 1
    nc2 = int(output.max()) + 1

    cont = sp.coo_matrix(
        (np.ones(n, dtype=np.int64), (truth, output)), shape=(nc1, nc2)
    ).tocsr()
    tp = _pairs(cont.data)
    sizes1 = np.bincount(truth, minlength=nc1)
    sizes2 = np.bincount(output, minlength=nc2)
    same1 = _pairs(sizes1)
    same2 = _pairs(sizes2)
    fn = same1 - tp
    fp = same2 - tp

    precision = tp / (tp + fp) if (tp + fp) else 0.0
    recall = tp / (tp + fn) if (tp + fn) else 0.0
    f_score = (2.0 * precision * recall / (precision + recall)
               if (precision + recall) else 0.0)
    return CompareResult(
        n_vertices=n,
        n_truth_comms=nc1,
        n_output_comms=nc2,
        true_positive=tp,
        false_negative=fn,
        false_positive=fp,
        precision=precision,
        recall=recall,
        f_score=f_score,
        gini_truth=gini_coefficient(sizes1),
        gini_output=gini_coefficient(sizes2),
    )


def load_ground_truth(path: str, zero_based: bool = False) -> np.ndarray:
    """LFR-format ground truth: one `vertex community` pair per line
    (cf. loadGroundTruthFile, louvain.cpp:3272-3303; 1-based
    community ids unless ``zero_based``)."""
    data = np.loadtxt(path, dtype=np.int64, ndmin=2)
    comm = data[:, 1].copy()
    if not zero_based:
        comm -= 1
    return comm


def write_communities(path: str, communities: np.ndarray) -> None:
    """Write the final `.communities` file: one label per line, vertex order
    (cf. main.cpp:521-550)."""
    np.savetxt(path, np.asarray(communities, dtype=np.int64), fmt="%d")
