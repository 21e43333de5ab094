"""The Graph500 Kronecker generator, vectorized on the device.

From the Graph500 specification ("Graph generation"; the reference
code's ``kronecker_generator.m``): 2^SCALE vertices and edgefactor *
2^SCALE edges.  Each edge descends SCALE levels of the 2x2 initiator
[[A, B], [C, D]], choosing a quadrant at each level from two uniform
draws; the vertex labels are then permuted.  Self-loops are dropped here;
duplicates are left for the ingest to sum.

Everything is drawn from the run's seed: graph k of a run's pool comes
from ``seeds.graph_seed(seed, k)``, its edges, their directions, their
order and the label permutation alike.
"""

from __future__ import annotations

import torch

from benchmark.traffic.seeds import graph_seed


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float,
                    c: float, gen: torch.Generator, device) -> tuple:
    """Directed edge list (src, dst) int64 on ``device``, before the label
    permutation, self-loops included."""
    n_edges = edgefactor << scale
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = torch.zeros(n_edges, dtype=torch.int64, device=device)
    dst = torch.zeros(n_edges, dtype=torch.int64, device=device)
    for level in range(scale):
        r1 = torch.rand(n_edges, generator=gen, dtype=torch.float64,
                        device=device)
        r2 = torch.rand(n_edges, generator=gen, dtype=torch.float64,
                        device=device)
        ii = r1 > ab
        jj = r2 > torch.where(ii, c_norm, a_norm)
        src |= ii.long() << level
        dst |= jj.long() << level
    return src, dst


def generate(cfg: dict, seed: int, device, index: int = 0) -> tuple:
    """(nv, src, dst) on ``device``: graph ``index`` of the pool drawn from
    ``seed``, labels permuted, self-loops dropped, edges in a drawn order
    and with drawn directions."""
    scale = int(cfg["scale"])
    gen = torch.Generator(device=device)
    gen.manual_seed(graph_seed(seed, index))
    src, dst = kronecker_edges(scale, int(cfg["edgefactor"]), cfg["A"],
                               cfg["B"], cfg["C"], gen, device)
    perm = torch.randperm(1 << scale, generator=gen, device=device)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    order = torch.randperm(src.numel(), generator=gen, device=device)
    flip = torch.rand(src.numel(), generator=gen, device=device) < 0.5
    src, dst = torch.where(flip, dst, src)[order], \
        torch.where(flip, src, dst)[order]
    return 1 << scale, src, dst
