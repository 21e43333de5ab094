"""Plain Louvain: the benchmark's reference, written from the algorithm's
statement and independent of the code under test.

It imports torch alone, and runs on whatever device its tensors are on
(the card after the measured window; the CPU in the tests).  It reads the
edge list the benchmark made and works out everything else itself.

The algorithm is the parallel Louvain of Vite (Ghosh et al., IPDPS 2018),
as the system states it:

- The graph: every input edge (u, v), u != v, in both directions, a
  self-loop once; duplicate edges summed in float64 and rounded once to
  float32.  2m is the float64 sum of those weights.
- A sweep moves every vertex at once, from the assignment before it.  Each
  vertex i in community x weighs every neighbouring community y != x by

      gain(i -> y) = 2*(e_iy - e_ix) - ((2*k_i)*(a_y - a_x))*c

  in float32, one rounding an operation, in that order: e_iy is the
  weight from i into y, e_ix that into x without i's self-loop, k_i the
  weighted degree of i, a_y the degree of y and a_x that of x without
  k_i, c = 1/(2m) rounded to float32.  The sums behind them (degrees,
  e_iy, e_ix) are taken in ``acc`` (float64) and rounded once to float32.
  A vertex moves to its best community, ties to the smaller id, only on a
  positive gain; of two singletons only the move to the smaller id is
  kept.
- A phase sweeps until a sweep's Q, taken in ``acc`` over the input
  assignment, gains less than the threshold over the last, and keeps the
  assignment before that sweep.  A phase that raises Q by more than the
  threshold is kept: its communities are numbered densely, smallest id
  first, and become the vertices of the next phase's graph (edges between
  communities summed, internal weight as a self-loop).
- The answer is the composed labels, numbered densely, and the Q of the
  last kept phase.

``acc=torch.float32`` takes every sum in float32 instead: the benchmark's
control, the step below the precision the system states.
"""

from __future__ import annotations

import torch

MAX_TOTAL_ITERATIONS = 10_000
MAX_PHASES = 200


class Graph:
    """A directed edge list sorted by (src, dst), duplicates summed."""

    def __init__(self, nv: int, src: torch.Tensor, dst: torch.Tensor,
                 w: torch.Tensor):
        self.nv = nv
        self.src = src
        self.dst = dst
        self.w = w            # float32


def coalesce(nv: int, src: torch.Tensor, dst: torch.Tensor,
             w64: torch.Tensor) -> Graph:
    """Sum duplicate (src, dst) pairs in float64, round once to float32,
    and sort by (src, dst)."""
    key = src.long() * nv + dst.long()
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    wsum = torch.zeros(uniq.numel(), dtype=torch.float64, device=key.device)
    wsum.index_add_(0, inv, w64)
    return Graph(nv, uniq // nv, uniq % nv, wsum.float())


def build_graph(nv: int, src: torch.Tensor, dst: torch.Tensor,
                w: torch.Tensor | None = None) -> Graph:
    """The undirected graph of an edge list: each edge (u, v), u != v, in
    both directions, a self-loop once, duplicates summed."""
    src = src.long()
    dst = dst.long()
    w64 = (torch.ones(src.numel(), dtype=torch.float64, device=src.device)
           if w is None else w.double())
    off = src != dst
    return coalesce(nv, torch.cat([src, dst[off]]),
                    torch.cat([dst, src[off]]),
                    torch.cat([w64, w64[off]]))


def _sum(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.index_add_(0, index, values)


def modularity(g: Graph, comm: torch.Tensor,
               acc=torch.float64) -> float:
    """Q = sum_c (internal weight of c)/(2m) - sum_c (degree of c / 2m)^2,
    summed in ``acc``."""
    w = g.w.to(acc)
    two_m = g.w.double().sum().to(acc)
    internal = torch.where(comm[g.src] == comm[g.dst], w,
                           torch.zeros((), dtype=acc, device=w.device)).sum()
    deg = _sum(w, g.src, g.nv)
    cdeg = _sum(deg, comm, g.nv)
    return float(internal / two_m - (cdeg / two_m).square().sum())


class _Sweeper:
    """The per-phase constants of one graph and its sweep."""

    def __init__(self, g: Graph, two_m: float, acc):
        self.g = g
        self.acc = acc
        self.c64 = torch.tensor(1.0 / two_m, dtype=torch.float64,
                                device=g.src.device)
        self.c32 = self.c64.float()
        self.cacc = self.c64.to(acc)
        self.w_acc = g.w.to(acc)
        self.vdeg_acc = _sum(self.w_acc, g.src, g.nv)
        self.vdeg = self.vdeg_acc.float()
        self.is_self = g.src == g.dst

    def __call__(self, comm: torch.Tensor) -> tuple:
        """One sweep from ``comm``: (target, Q of ``comm``)."""
        g, acc = self.g, self.acc
        nv = g.nv
        zero = torch.zeros((), dtype=acc, device=comm.device)
        cdeg_acc = _sum(self.vdeg.to(acc), comm, nv)
        cdeg = cdeg_acc.float()
        csize = torch.bincount(comm, minlength=nv)
        csrc = comm[g.src]
        cdst = comm[g.dst]
        counter0 = _sum(torch.where(cdst == csrc, self.w_acc, zero), g.src,
                        nv).float()
        self_loop = _sum(torch.where(self.is_self, self.w_acc, zero), g.src,
                         nv).float()
        eix = counter0 - self_loop
        q = (counter0.to(acc).sum() * self.cacc
             - cdeg_acc.square().sum() * self.cacc * self.cacc)

        # Weight from each vertex into each neighbouring community.
        key = g.src * nv + cdst
        uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
        eiy = _sum(self.w_acc, inv, uniq.numel()).float()
        i = uniq // nv
        y = uniq % nv
        x = comm[i]
        valid = y != x
        k_i = self.vdeg[i]
        a_y = cdeg[y]
        a_x = cdeg[x] - k_i
        gain = (2.0 * (eiy - eix[i])
                - 2.0 * k_i * (a_y - a_x) * self.c32)
        gain = torch.where(valid, gain,
                           torch.tensor(float("-inf"), device=gain.device))
        best = torch.full((nv,), float("-inf"), dtype=torch.float32,
                          device=gain.device)
        best.scatter_reduce_(0, i, gain, "amax")
        tie = valid & (gain == best[i])
        cand = torch.where(tie, y, torch.full_like(y, nv))
        best_c = torch.full((nv,), nv, dtype=torch.long, device=y.device)
        best_c.scatter_reduce_(0, i, cand, "amin")
        move = best > 0.0
        best_c = best_c.clamp(max=nv - 1)
        guard = (csize[best_c] == 1) & (csize[comm] == 1) & (best_c > comm)
        move &= ~guard
        return torch.where(move, best_c, comm), float(q)


def _renumber(labels: torch.Tensor) -> tuple:
    uniq, dense = torch.unique(labels, sorted=True, return_inverse=True)
    return dense, int(uniq.numel())


def louvain(g: Graph, threshold: float = 1.0e-6,
            acc=torch.float64) -> tuple:
    """The whole clustering of ``g``.  Returns (labels [nv] int64 on the
    graph's device, Q, sweeps of each kept phase)."""
    two_m = float(g.w.double().sum())
    comm_all = torch.arange(g.nv, device=g.src.device)
    prev_mod = -1.0
    tot_iters = 0
    sweeps: list = []
    phase = 0
    while phase < MAX_PHASES and tot_iters <= MAX_TOTAL_ITERATIONS:
        sweep = _Sweeper(g, two_m, acc)
        comm = past = torch.arange(g.nv, device=g.src.device)
        last_q = -1.0
        iters = 0
        while True:
            target, q = sweep(comm)
            iters += 1
            if (q - last_q) < threshold:
                break
            last_q = max(q, -1.0)
            past, comm = comm, target
            if iters >= MAX_TOTAL_ITERATIONS:
                break
        tot_iters += iters
        curr_mod = modularity(g, past, acc)
        if not (curr_mod - prev_mod) > threshold:
            break
        dense, nc = _renumber(past)
        comm_all = dense[comm_all]
        prev_mod = curr_mod
        sweeps.append(iters)
        g = coalesce(nc, dense[g.src], dense[g.dst], g.w.double())
        phase += 1
    labels, _ = _renumber(comm_all)
    return labels, prev_mod, sweeps
