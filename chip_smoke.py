#!/usr/bin/env python3
"""Chip smoke test: cuvite_tpu_torch's main paths on one CUDA card.

    python3 chip_smoke.py [--scale 20] [--check-scale 14]
                          [--rgg-nv 4194304] [--rgg-check-nv 65536]

Run from the root of a checkout on a machine with an NVIDIA H100.  It
imports nothing of JAX or of cuvite_tpu, catches no failure, and exits
non-zero (printing no result) on any mismatch, on a machine without CUDA,
or without the cuvite_tpu_torch package beside it.  Phases:

1. card: the card's name and power limit; build the CUDA kernels (one
   nvcc per source, in parallel) and print the build seconds;
2. the row-argmax kernel against its plain twin at every DEFAULT_BUCKETS
   width (8 ... 8192): integer and dyadic weights, zero-weight and padding
   slots, ties, all-padding and no-candidate rows, each with and without
   the per-row degrees (rows shorter than their class); rows whose real
   slots all fall in one or two communities; a tie at gain zero between
   two candidates, which the smaller id wins -- outputs bit-equal;
3. the heavy kernel against its twin on seeded hubs of degree 9,000 ...
   65,536 over 2^20 communities, on hubs whose edges all reach one or two
   communities, on a hub of 2^18 edges (64 chunks) and on a tie at gain
   zero -- bit-equal, twice in a row, the scratch left clean;
4. louvain_phases on R-MAT --check-scale on the card and on the CPU (the
   twins): identical labels, phases and iterations, Q to 1e-9;
5. the main path: louvain_phases on R-MAT --scale on the card, with the
   kernels' launch counts set to 0 just before and read just after; per
   phase nv, ne, iterations, Q and seconds; fails if a kernel never
   launched or the reported Q is more than 1e-6 from the host f64
   modularity of the returned labels;
6. the row and heavy kernels timed with CUDA events at the phase-0 shapes
   of that graph (the row kernel also width by width), at the identity
   assignment and at the converged phase-0 assignment, beside their twins
   and bounds from the real rows and edges; fails if a padding row reaches
   the row kernel (real rows must equal launched rows in every class);
7. the seg_coalesce kernel against its twin at nv_pad 64, 1024 and 4096,
   dyadic and RGG-like float weights, duplicates, heavy self-loop runs,
   zero-weight rows, gapped ids and padding rows: acc and cnt bit-equal,
   and the emitted slab bit-equal to the sort engine's;
8. louvain_phases(engine="sort") on RGG --rgg-check-nv on the card and on
   the CPU: identical labels, phases and iterations, Q to 1e-9, and at
   least one dense coarsening;
9. the sort path: louvain_phases(engine="sort") on RGG --rgg-nv, with the
   kernels' launch counts set to 0 just before and read just after; per
   phase nv, ne, iterations, Q, seconds, coalesce engine and coarsen
   seconds; fails if seg_coalesce never launched, if the reported Q is
   more than 1e-6 from the host f64 modularity of the labels, or if a
   dense coarsening's rows differ from the sort engine's on the same
   relabeled slab (src, dst, count exact; weights at most one f32 ulp);
   then one phase-0 sort sweep timed on the device stream;
10. seg_coalesce timed at the first dense coarsening of that run beside
   its twin, the compaction, the whole sort engine, two torch.bincount
   calls and its bound; all three kernels printed as one JSON line.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = 34e12       # H100 SXM float64 outside the tensor cores
SLEEP_CYCLES = 20_000_000  # ~10 ms of sleep kernel ahead of each timing
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                         timeout=60)
    if out.returncode:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bits_equal(a, b) -> bool:
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return a.shape == b.shape and torch.equal(a, b)


def max_abs_err(got, ref) -> float:
    """Largest |kernel - twin| over (best_c, best_gain, counter0); -inf
    against -inf counts as 0."""
    import torch

    err = 0.0
    for g, r in zip(got, ref):
        g, r = g.cpu().double(), r.cpu().double()
        same = g == r
        d = torch.where(same, torch.zeros_like(g), (g - r).abs())
        if d.numel():
            err = max(err, float(d.max()))
    return err


def time_ms(fn, repeats: int) -> float:
    """Median milliseconds of ``fn`` over ``repeats`` CUDA-event timings,
    after one warm-up call.  A sleep kernel ahead of each timing keeps the
    stream busy while the host enqueues ``fn``, so host time between its
    launches is not counted (unless ``fn`` itself waits on the device)."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phase 2: the row kernel at every width.


def row_case(width: int, seed: int, dev):
    """Bucket rows of one width over a 2^16-vertex table.  Row degrees are
    random in [1, width]; padding slots point at the row's own vertex with
    w = 0.  Communities come from a pool of ~width/2 ids, so rows hold
    duplicates and equal-gain candidates.  Rows 0-3 are no-candidate rows
    (every neighbour in the current community), the last 4 rows are
    padding rows.  Returns (tensors, constant, row degrees)."""
    import torch

    rng = np.random.default_rng(seed)
    nv = 1 << 16
    n_rows = max(64, min(4096, (1 << 21) // width))
    pool = max(width // 2, 4)
    comm = rng.integers(0, pool, nv).astype(np.int32)
    comm_deg = np.zeros(nv, dtype=np.float32)
    comm_deg[:pool] = rng.integers(1, 64, pool)
    vdeg = rng.integers(0, 32, nv).astype(np.float32)
    verts = rng.choice(nv, n_rows, replace=False).astype(np.int32)
    deg = rng.integers(1, width + 1, n_rows)
    dst = rng.integers(0, nv, (n_rows, width)).astype(np.int32)
    slot = np.arange(width)[None, :]
    dst = np.where(slot < deg[:, None], dst, verts[:, None]).astype(np.int32)
    w = (rng.integers(0, 5, (n_rows, width)) * 0.25).astype(np.float32)
    w[slot >= deg[:, None]] = 0.0
    same = np.nonzero(comm == comm[verts[0]])[0]
    for r in range(4):   # no-candidate rows
        comm[verts[r]] = comm[verts[0]]
        dst[r] = rng.choice(same, width)
        deg[r] = width
    self_loop = (rng.integers(0, 2, nv) * 0.5).astype(np.float32)
    verts[-4:] = nv
    t = [torch.from_numpy(a).to(dev) for a in
         (dst, w, verts, comm, comm_deg, vdeg, self_loop)]
    return (t, float(np.float32(1.0 / 123457.0)),
            torch.from_numpy(deg.astype(np.int32)).to(dev))


def hot_row_case(width: int, seed: int, dev):
    """Rows whose real slots all fall in one community (even rows) or two
    (odd rows), the converged sweep's hot keys: neighbours are vertices
    [0, 2^16) with comm = id mod 1024, row r is vertex 2^16 + r.  Degrees
    are random in (width/2, width], a quarter of the rows sit in their hot
    community.  Returns (tensors, constant, row degrees)."""
    import torch

    rng = np.random.default_rng(seed)
    nb, pool = 1 << 16, 1024
    n_rows = max(64, min(4096, (1 << 21) // width))
    nv = nb + n_rows
    comm = np.concatenate([np.arange(nb) % pool,
                           rng.integers(0, pool, n_rows)]).astype(np.int32)
    a = rng.integers(0, pool, n_rows)
    b = rng.integers(0, pool, n_rows)
    comm[nb::4] = a[::4]
    two = (np.arange(n_rows) % 2 == 1)[:, None]
    pick = np.where(two & (rng.random((n_rows, width)) < 0.5), b[:, None],
                    a[:, None])
    dst = pick + pool * rng.integers(0, nb // pool, (n_rows, width))
    verts = (nb + np.arange(n_rows)).astype(np.int32)
    deg = rng.integers(width // 2 + 1, width + 1, n_rows)
    slot = np.arange(width)[None, :]
    dst = np.where(slot < deg[:, None], dst, verts[:, None]).astype(np.int32)
    w = (rng.integers(0, 5, (n_rows, width)) * 0.25).astype(np.float32)
    w[slot >= deg[:, None]] = 0.0
    comm_deg = rng.integers(1, 4 * width, nv).astype(np.float32)
    vdeg = rng.integers(1, 32, nv).astype(np.float32)
    self_loop = (rng.integers(0, 2, nv) * 0.5).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in
         (dst, w, verts, comm, comm_deg, vdeg, self_loop)]
    return (t, float(np.float32(1.0 / 7919.0)),
            torch.from_numpy(deg.astype(np.int32)).to(dev))


def tie_row_case(width: int, dev):
    """One row whose best two candidates tie at gain exactly zero: no edge
    into the current community (eix = 0), zero-weight edges into
    communities 5 and 3 (listed first) whose degree equals ax, so
    2*(0 - 0) - ((2*vdeg)*0)*c = 0 for both; community 9 is negative.  The
    smaller id, 3, must win.  Zero is where a bit-pattern order of gains
    (-0.0 below +0.0) would part from cv::better."""
    import torch

    nv = 16
    comm = np.arange(nv, dtype=np.int32)
    comm_deg = np.full(nv, 6.0, np.float32)
    comm_deg[9] = 100.0
    comm_deg[15] = 10.0                      # the row's vertex 15
    vdeg = np.full(nv, 4.0, np.float32)      # ax = 10 - 4 = 6 = ay
    dst = np.full((1, width), 15, np.int32)  # padding: the row's own vertex
    n = min(width, 6)
    dst[0, :n] = [5, 3, 9, 5, 3, 9][:n]
    w = np.zeros((1, width), np.float32)
    t = [torch.from_numpy(x).to(dev) for x in
         (dst, w, np.array([15], np.int32), comm, comm_deg, vdeg,
          np.zeros(nv, np.float32))]
    return t, float(np.float32(1.0 / 64.0))


def check_same(what: str, got, ref) -> None:
    for name, g, r in zip(("best_c", "best_gain", "counter0"), got, ref):
        if not bits_equal(g, r):
            fail(f"{what}: {name} differs from the twin (max abs err "
                 f"{max_abs_err(got, ref)})")


def check_rows(dev) -> None:
    from cuvite_tpu_torch.kernels.row_argmax import (
        row_argmax,
        row_argmax_plain,
    )
    from cuvite_tpu_torch.louvain.bucketed import DEFAULT_BUCKETS

    for width in DEFAULT_BUCKETS:
        args, const, deg = row_case(width, width, dev)
        got = row_argmax(*args, const)
        ref = row_argmax_plain(*args, const)
        check_same(f"row_argmax width {width}", got, ref)
        n_none = int((got[0].cpu() == 2**31 - 1).sum())
        if n_none < 4:
            fail(f"row_argmax width {width}: the no-candidate rows found "
                 "a candidate")
        # Stopped at each row's degree: equal to the full-width twin too.
        got_d = row_argmax(*args, const, deg)
        check_same(f"row_argmax width {width} with degrees", got_d,
                   row_argmax_plain(*args, const, deg))
        check_same(f"row_argmax width {width} with degrees vs full rows",
                   got_d, ref)
        hargs, hconst, hdeg = hot_row_case(width, width + 1, dev)
        for d in (None, hdeg):
            check_same(f"row_argmax width {width} hot-key rows "
                       f"(degrees {d is not None})",
                       row_argmax(*hargs, hconst, d),
                       row_argmax_plain(*hargs, hconst, d))
        targs, tconst = tie_row_case(width, dev)
        tie = row_argmax(*targs, tconst)
        check_same(f"row_argmax width {width} zero-gain tie", tie,
                   row_argmax_plain(*targs, tconst))
        if int(tie[0][0]) != 3 or float(tie[1][0]) != 0.0:
            fail(f"row_argmax width {width} zero-gain tie: got "
                 f"{int(tie[0][0])} at {float(tie[1][0])}, want 3 at 0")
        print(f"  row_argmax width {width:5d}: {args[0].shape[0]} rows "
              f"bit-equal to the twin ({n_none} without a candidate), with "
              f"and without degrees; {hargs[0].shape[0]} hot-key rows; "
              "zero-gain tie to the smaller id")


# ---------------------------------------------------------------------------
# Phase 3: the heavy kernel.


def hub_tensors(src, dst, w, comm, comm_deg, vdeg, self_loop, dev):
    import torch

    from cuvite_tpu_torch.kernels.heavy_bincount import build_heavy_layout

    lay = build_heavy_layout(src, dst, w, nv_local=len(comm)).to(dev)
    tabs = [torch.from_numpy(a).to(dev)
            for a in (comm, comm_deg, vdeg, self_loop)]
    return lay, tabs


def heavy_case(seed: int, dev):
    rng = np.random.default_rng(seed)
    n_comm = 1 << 20
    n_hubs = 48
    nv = n_comm + n_hubs
    # Skewed community ids: small ids repeat, so hubs see duplicates.
    comm = (n_comm * rng.random(nv) ** 3).astype(np.int32)
    deg = rng.integers(9000, 65537, n_hubs)
    hubs = n_comm + np.arange(n_hubs)
    src = np.repeat(hubs, deg)
    dst = rng.integers(0, n_comm, len(src))
    w = rng.integers(0, 4, len(src)).astype(np.float32)
    first = np.concatenate([[0], np.cumsum(deg)[:-1]])
    # Hub 0: every neighbour in its own community (no candidate).
    comm[hubs[0]] = comm[dst[0]]
    dst[: deg[0]] = dst[0]
    # Hub 1: its only candidates are reached by zero-weight edges.
    comm[hubs[1]] = comm[dst[first[1]]]
    others = slice(first[1] + 1, first[1] + deg[1])
    w[others] = np.where(comm[dst[others]] == comm[hubs[1]], w[others], 0.0)
    comm_deg = np.zeros(n_comm, dtype=np.float32)
    np.add.at(comm_deg, comm, rng.integers(1, 200, nv).astype(np.float32))
    vdeg = np.zeros(nv, dtype=np.float32)
    vdeg[hubs] = deg
    self_loop = np.zeros(nv, dtype=np.float32)
    self_loop[hubs] = rng.integers(0, 3, n_hubs)
    lay, tabs = hub_tensors(src, dst, w, comm, comm_deg, vdeg, self_loop,
                            dev)
    return lay, tabs, float(np.float32(1.0 / 987653.0))


def hot_heavy_case(seed: int, dev):
    """Hubs whose edges all reach one community (even hubs) or two (odd
    hubs); hub 2's one community is its own (no candidate), and hub 0 has
    2^18 edges (64 chunks).  Neighbours are vertices [0, 2^20) with comm =
    id mod 4096."""
    rng = np.random.default_rng(seed)
    nb, pool, n_hubs = 1 << 20, 4096, 16
    nv = nb + n_hubs
    comm = np.concatenate([np.arange(nb) % pool,
                           rng.integers(0, pool, n_hubs)]).astype(np.int32)
    deg = rng.integers(8193, 40000, n_hubs)
    deg[0] = 1 << 18
    hubs = nb + np.arange(n_hubs)
    src = np.repeat(hubs, deg)
    a = rng.integers(0, pool, n_hubs)
    b = rng.integers(0, pool, n_hubs)
    comm[hubs[2]] = a[2]
    hub = np.repeat(np.arange(n_hubs), deg)
    odd = (hub % 2 == 1) & (rng.random(len(src)) < 0.5)
    dst = np.where(odd, b[hub], a[hub]) + pool * rng.integers(
        0, nb // pool, len(src))
    w = rng.integers(0, 4, len(src)).astype(np.float32)
    comm_deg = rng.integers(1, 1 << 20, nv).astype(np.float32)
    vdeg = np.zeros(nv, dtype=np.float32)
    vdeg[hubs] = deg
    self_loop = np.zeros(nv, dtype=np.float32)
    lay, tabs = hub_tensors(src, dst, w, comm, comm_deg, vdeg, self_loop,
                            dev)
    return lay, tabs, float(np.float32(1.0 / 3000017.0))


def big_hub_case(seed: int, dev):
    """A hub of 2^18 edges (64 chunks) over skewed communities, beside two
    hubs of 8193 and 3 * 4096 edges (chunk boundaries at the edges)."""
    rng = np.random.default_rng(seed)
    n_comm = 1 << 20
    deg = np.array([1 << 18, 8193, 3 * 4096])
    nv = n_comm + len(deg)
    comm = (n_comm * rng.random(nv) ** 2).astype(np.int32)
    hubs = n_comm + np.arange(len(deg))
    src = np.repeat(hubs, deg)
    dst = rng.integers(0, n_comm, len(src))
    w = rng.integers(0, 8, len(src)).astype(np.float32)
    comm_deg = np.zeros(n_comm, dtype=np.float32)
    np.add.at(comm_deg, comm, rng.integers(1, 100, nv).astype(np.float32))
    vdeg = np.zeros(nv, dtype=np.float32)
    vdeg[hubs] = deg
    self_loop = np.zeros(nv, dtype=np.float32)
    self_loop[hubs] = 1.0
    lay, tabs = hub_tensors(src, dst, w, comm, comm_deg, vdeg, self_loop,
                            dev)
    return lay, tabs, float(np.float32(1.0 / 1234567.0))


def tie_hub_case(dev):
    """tie_row_case for a hub of 12,000 edges (three chunks): zero-weight
    edges into communities 5 (first), 3 and 9; 3 and 5 tie at gain 0."""
    nv = 16
    comm = np.arange(nv, dtype=np.int32)
    comm_deg = np.full(nv, 6.0, np.float32)
    comm_deg[9] = 100.0
    comm_deg[15] = 10.0
    vdeg = np.full(nv, 4.0, np.float32)
    dst = np.tile(np.array([5, 3, 9]), 4000)
    src = np.full(len(dst), 15)
    w = np.zeros(len(dst), np.float32)
    lay, tabs = hub_tensors(src, dst, w, comm, comm_deg, vdeg,
                            np.zeros(nv, np.float32), dev)
    return lay, tabs, float(np.float32(1.0 / 64.0))


def check_heavy(dev) -> None:
    from cuvite_tpu_torch.kernels.heavy_bincount import (
        heavy_argmax,
        heavy_argmax_plain,
    )

    cases = [("seeded hubs", *heavy_case(11, dev)),
             ("hot-key hubs", *hot_heavy_case(12, dev)),
             ("2^18-edge hub", *big_hub_case(13, dev)),
             ("zero-gain tie", *tie_hub_case(dev))]
    for what, lay, tabs, const in cases:
        got = heavy_argmax(lay, *tabs, const)
        check_same(f"heavy_argmax {what}", got,
                   heavy_argmax_plain(lay, *tabs, const))
        if not lay.scratch.is_clean():
            fail(f"heavy_argmax {what}: the scratch was left dirty")
        again = heavy_argmax(lay, *tabs, const)
        check_same(f"heavy_argmax {what}, second launch", again, got)
        bc = got[0].cpu()
        if what == "seeded hubs" and (int(bc[0]) != 2**31 - 1
                                      or int(bc[1]) == 2**31 - 1):
            fail("heavy_argmax: the no-candidate / zero-weight hubs are "
                 "wrong")
        if what == "hot-key hubs" and int(bc[2]) != 2**31 - 1:
            fail("heavy_argmax: the hub inside its one community found a "
                 "candidate")
        if what == "zero-gain tie" and (int(bc[0]) != 3
                                        or float(got[1][0]) != 0.0):
            fail(f"heavy_argmax zero-gain tie: got {int(bc[0])} at "
                 f"{float(got[1][0])}, want 3 at 0")
        print(f"  heavy_argmax {what}: {lay.num_hubs} hubs, "
              f"{lay.dst.numel()} edges, {lay.num_chunks} chunks, "
              "bit-equal to the twin, twice; scratch left clean")


# ---------------------------------------------------------------------------
# Phases 4-6.


def check_card_vs_cpu(scale: int) -> None:
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rmat

    g = generate_rmat(scale)
    rg = louvain_phases(g, device="cuda")
    rc = louvain_phases(g, device="cpu")
    if not np.array_equal(rg.communities, rc.communities):
        fail(f"R-MAT {scale}: card and CPU labels differ")
    if [p.iterations for p in rg.phases] != [p.iterations for p in rc.phases]:
        fail(f"R-MAT {scale}: phases/iterations differ: "
             f"{[p.iterations for p in rg.phases]} vs "
             f"{[p.iterations for p in rc.phases]}")
    if abs(rg.modularity - rc.modularity) > 1e-9:
        fail(f"R-MAT {scale}: Q {rg.modularity} vs {rc.modularity}")
    print(f"  R-MAT {scale}: {len(rg.phases)} phases, "
          f"{rg.total_iterations} iterations, Q {rg.modularity:.9f} on card "
          "and CPU, labels identical")


def run_main_path(g, scale: int) -> dict:
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.evaluate.modularity import modularity
    from cuvite_tpu_torch.kernels.heavy_bincount import heavy_argmax
    from cuvite_tpu_torch.kernels.row_argmax import row_argmax

    torch.cuda.reset_peak_memory_stats()
    row_argmax.launches = 0
    heavy_argmax.launches = 0
    t0 = time.perf_counter()
    res = louvain_phases(g)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"row_argmax": row_argmax.launches,
                "heavy_bincount": heavy_argmax.launches}
    for p in res.phases:
        st = " ".join(f"{k} {v:.3f}" for k, v in p.stages.items())
        print(f"  phase {p.phase}: nv {p.num_vertices} ne {p.num_edges} "
              f"iterations {p.iterations} Q {p.modularity:.9f} "
              f"seconds {p.seconds:.3f} (host stages, s: {st})")
    sweeps = res.total_iterations
    print(f"  R-MAT {scale}: total {total_s:.3f} s, {sweeps} sweeps, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
          f"launches {launches} "
          f"({launches['row_argmax'] / max(sweeps, 1):.2f} row and "
          f"{launches['heavy_bincount'] / max(sweeps, 1):.2f} heavy "
          "launches per sweep)")
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} never launched on the main path")
    q_host = modularity(g, res.communities)
    if abs(q_host - res.modularity) > 1e-6:
        fail(f"reported Q {res.modularity} vs host f64 {q_host}")
    print(f"  reported Q {res.modularity:.9f}, host f64 Q {q_host:.9f}")
    return launches, sweeps


# Bounds count the bytes the function must move on this run's data: each
# input read once, each output written once.  Padding is not work, and
# neither is the kernels' own scratch (the heavy chunk table, hub tables,
# the vertex records): per real slot or heavy edge 8 B of dst and w; per
# real row ``ROW_BYTES`` (its id, int32 degree, vdeg and self_loop, three
# 4-byte outputs), per hub ``HUB_BYTES`` (the same with an int64 edge
# offset for the degree); and the comm and comm_deg tables once, which
# every slot's gathers read.  Those tables fit in L2, so the gathers add
# no bytes here; ``bytes_with_gathers`` adds 4 B per slot or edge for a
# comm gather that misses L2.  Operations are counted as 8 f32 operations
# per real slot or heavy edge, an upper bound: one compare and one add per
# slot, and at most one 7-operation gain (plus its compare) per distinct
# community.
ROW_BYTES = 4 + 4 + 8 + 12
HUB_BYTES = 4 + 8 + 8 + 12


def bound(n_bytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bucket_work(plan, deg: np.ndarray, nv: int) -> list:
    """(width, launched rows, real rows, real slots) of each bucket."""
    out = []
    for verts, dst, _, _ in plan.buckets:
        v = verts.cpu().numpy()
        v = v[v < nv]
        out.append((dst.shape[1], dst.shape[0], len(v), int(deg[v].sum())))
    return out


def time_kernels(g, launches: dict, sweeps: int) -> list:
    """Kernel vs twin at the phase-0 shapes of ``g``, at the identity
    assignment and at the converged phase-0 assignment, with bounds from
    this graph's bytes and operations.  The row kernel's ``ms`` is one
    sweep's worth (every bucket class once)."""
    import torch

    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.kernels.heavy_bincount import (
        heavy_argmax,
        heavy_argmax_plain,
    )
    from cuvite_tpu_torch.kernels.row_argmax import (
        row_argmax,
        row_argmax_plain,
        vertex_table,
    )
    from cuvite_tpu_torch.louvain.driver import PhaseRunner
    from cuvite_tpu_torch.ops.segment import segment_sum

    run = PhaseRunner(DistGraph.build(g), "cuda")
    plan, vdeg = run.plan, run.vdeg
    nv = run.nv_total
    const = float(np.float32(run.constant))
    table_bytes = 2 * 4 * nv     # comm and comm_deg
    deg = np.zeros(nv, dtype=np.int64)
    deg[: g.num_vertices] = g.degrees()
    work = bucket_work(plan, deg, nv)
    for width, n_rows, real_rows, _ in work:
        print(f"  class {width:5d}: {real_rows} real rows, {n_rows} "
              "launched")
        if n_rows != real_rows:
            fail(f"class {width}: {n_rows - real_rows} padding rows reach "
                 "the row kernel")
    lay = plan.heavy
    if lay is None:
        fail("the phase-0 graph has no hub: the heavy kernel is untimed")

    _, _, iters = run.run(1.0e-6)   # phase 0 as louvain_phases runs it
    assignments = {"identity": run.comm0, "converged": run.labels_dev}
    print(f"  converged phase-0 assignment after {iters} sweeps: "
          f"{int(torch.unique(run.labels_dev).numel())} communities")
    t = {}
    row_err = hub_err = 0.0
    for label, comm in assignments.items():
        comm_deg = segment_sum(vdeg.double(), comm, nv).float()
        tables = (comm, comm_deg, vdeg, plan.self_loop)
        # The kernel's vertex records, built once per sweep by the sweep
        # (bucketed_step): part of the row kernel's ``ms``, and timed on
        # their own as well.
        vinfo = vertex_table(*tables)
        t[f"vinfo_{label}"] = time_ms(lambda: vertex_table(*tables), 20)

        def rows(fn, buckets=plan.buckets, tables=tables, vinfo=vinfo):
            extra = (vinfo,) if fn is row_argmax else ()
            return [fn(d, w, v, *tables, const, dg, *extra)
                    for v, d, w, dg in buckets]

        def hub(fn, tables=tables):
            return fn(lay, *tables, const)

        # One whole sweep (kernels and the torch ops around them) on the
        # device stream: with the sweep count, an upper bound on the
        # run's device-busy time.
        t[f"sweep_{label}"] = time_ms(lambda: run.step(comm), 10)
        row_err = max(row_err, max(max_abs_err(a, b) for a, b in
                                   zip(rows(row_argmax),
                                       rows(row_argmax_plain))))
        hub_err = max(hub_err, max_abs_err(hub(heavy_argmax),
                                           hub(heavy_argmax_plain)))
        t[f"row_{label}"] = time_ms(
            lambda: rows(row_argmax, vinfo=vertex_table(*tables)), 20)
        t[f"row_launches_{label}"] = time_ms(lambda: rows(row_argmax), 20)
        t[f"row_plain_{label}"] = time_ms(lambda: rows(row_argmax_plain), 3)
        t[f"hub_{label}"] = time_ms(lambda: hub(heavy_argmax), 20)
        t[f"hub_plain_{label}"] = time_ms(lambda: hub(heavy_argmax_plain), 3)
        t[f"width_{label}"] = [time_ms(lambda b=b: rows(row_argmax, [b]), 20)
                               for b in plan.buckets]
        print(f"  {label}: one phase-0 sweep {t[f'sweep_{label}']:.4f} ms "
              f"on the device stream; row {t[f'row_{label}']:.4f} ms "
              f"(class launches {t[f'row_launches_{label}']:.4f} ms, "
              f"vertex_table {t[f'vinfo_{label}']:.4f} ms), heavy "
              f"{t[f'hub_{label}']:.4f} ms")

    per_width = []
    for k, (width, n_rows, real_rows, slots) in enumerate(work):
        b_ms, _ = bound(slots * 8 + real_rows * ROW_BYTES, 8 * slots)
        per_width.append({
            "width": width, "rows": n_rows, "real_rows": real_rows,
            "real_slots": slots, "ms": t["width_identity"][k],
            "ms_converged": t["width_converged"][k], "bound_ms": b_ms})
    slots = sum(w[3] for w in work)
    real_rows = sum(w[2] for w in work)
    row_bytes = slots * 8 + real_rows * ROW_BYTES + table_bytes
    per_sweep = launches["row_argmax"] / max(sweeps, 1)
    row = {
        "name": "row_argmax", "route": "cuda",
        "source": "cuvite_tpu_torch/kernels/csrc/row_argmax.cu",
        "replaces": "cuvite_tpu/kernels/row_argmax.py:166",
        "tpu_function": "cuvite_tpu/kernels/row_argmax.py:row_argmax_pallas",
        "launches": launches["row_argmax"], "sweeps": sweeps,
        "launches_per_sweep": per_sweep, "max_abs_err": row_err,
        "ms_unit": f"one phase-0 sweep: vertex_table and {len(work)} "
                   "class launches (per_width: the launches alone)",
        "ms": t["row_identity"], "ms_converged": t["row_converged"],
        "launches_ms": t["row_launches_identity"],
        "launches_ms_converged": t["row_launches_converged"],
        "ms_per_launch": t["row_launches_identity"] / len(work),
        "plain_ms": t["row_plain_identity"],
        "plain_ms_converged": t["row_plain_converged"],
        "vertex_table_ms": t["vinfo_identity"],
        "vertex_table_ms_converged": t["vinfo_converged"],
        "bytes": row_bytes, "bytes_with_gathers": row_bytes + 4 * slots,
        "ops": 8 * slots, "real_rows": real_rows, "real_slots": slots,
        "launched_slots": sum(d.numel() for _, d, _, _ in plan.buckets),
        "per_width": per_width,
    }
    e = lay.dst.numel()
    hub_bytes = e * 8 + lay.num_hubs * HUB_BYTES + table_bytes
    hub = {
        "name": "heavy_bincount", "route": "cuda",
        "source": "cuvite_tpu_torch/kernels/csrc/heavy_bincount.cu",
        "replaces": "cuvite_tpu/kernels/heavy_bincount.py:200",
        "tpu_function":
            "cuvite_tpu/kernels/heavy_bincount.py:heavy_argmax_pallas",
        "launches": launches["heavy_bincount"], "sweeps": sweeps,
        "launches_per_sweep": launches["heavy_bincount"] / max(sweeps, 1),
        "max_abs_err": hub_err, "ms_unit": "one launch",
        "ms": t["hub_identity"], "ms_converged": t["hub_converged"],
        "ms_per_launch": t["hub_identity"],
        "plain_ms": t["hub_plain_identity"],
        "plain_ms_converged": t["hub_plain_converged"],
        "bytes": hub_bytes, "bytes_with_gathers": hub_bytes + 4 * e,
        "ops": 8 * e, "hubs": lay.num_hubs, "edges": e,
        "chunks": lay.num_chunks, "table_bytes": 8 * lay.table_size,
    }
    out = []
    for k in (row, hub):
        if k["max_abs_err"] != 0.0:
            fail(f"{k['name']} differs from its twin at the main-path "
                 f"shapes (max abs err {k['max_abs_err']})")
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k["ops"])
        k["bound_ms_with_gathers"], _ = bound(k["bytes_with_gathers"],
                                              k["ops"])
        k["library_ms"] = None   # no single PyTorch call computes it
        k["kernel_ms"] = k["ms"]
        out.append(k)
    for label in assignments:
        out[0][f"sweep_ms_{label}"] = t[f"sweep_{label}"]
    return out


# ---------------------------------------------------------------------------
# Phases 7-10: the seg_coalesce kernel and the sort path.


def coalesce_case(nv_pad: int, ne_pad: int, seed: int, gapped: bool,
                  weights: str, dev):
    """A relabeled slab: real rows in a prefix, padding (src == nv_pad,
    dst == 0, w == 0) after; the first eighth of the real rows are
    self-loops (heavy self-loop runs), 37 real rows weigh 0.  ``gapped``:
    ids from a sparse subset.  ``weights``: 'dyadic' (multiples of 1/8) or
    'float' (RGG-like distances in (0, 0.01))."""
    import torch

    rng = np.random.default_rng(seed)
    n_real = ne_pad - ne_pad // 5
    pool = (rng.choice(nv_pad, size=max(nv_pad // 11, 2), replace=False)
            if gapped else np.arange(nv_pad))
    src = np.full(ne_pad, nv_pad, np.int32)
    dst = np.zeros(ne_pad, np.int32)
    w = np.zeros(ne_pad, np.float32)
    src[:n_real] = rng.choice(pool, size=n_real)
    dst[:n_real] = rng.choice(pool, size=n_real)
    src[: n_real // 8] = dst[: n_real // 8]
    if weights == "dyadic":
        w[:n_real] = rng.integers(1, 64, n_real) / 8.0
    else:
        w[:n_real] = rng.uniform(1e-4, 1e-2, n_real)
    w[n_real // 2: n_real // 2 + 37] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (src, dst, w)]


def rows_equal(a, b) -> bool:
    """(src, dst, w, n) of two coalesced slabs, bit for bit."""
    return a[3] == b[3] and all(bits_equal(x, y) for x, y in zip(a[:3], b[:3]))


def check_coalesce(dev) -> None:
    from cuvite_tpu_torch.kernels.seg_coalesce import (
        coalesce_slab,
        seg_coalesce,
        seg_coalesce_plain,
    )
    from cuvite_tpu_torch.ops.segment import coalesced_runs

    for nv_pad in (64, 1024, 4096):
        for weights in ("dyadic", "float"):
            args = coalesce_case(nv_pad, 1 << 16, nv_pad, nv_pad == 1024,
                                 weights, dev)
            acc, cnt = seg_coalesce(*args, nv_pad=nv_pad)
            racc, rcnt = seg_coalesce_plain(*args, nv_pad=nv_pad)
            if not (bits_equal(acc, racc) and bits_equal(cnt, rcnt)):
                fail(f"seg_coalesce nv_pad {nv_pad} {weights}: acc/cnt "
                     "differ from the twin")
            got = coalesce_slab(*args, nv_pad=nv_pad)
            ref = coalesced_runs(*args, nv_pad=nv_pad, engine="sort")
            if not rows_equal(got, ref):
                fail(f"seg_coalesce nv_pad {nv_pad} {weights}: emitted "
                     "slab differs from the sort engine's")
            print(f"  seg_coalesce nv_pad {nv_pad:5d} {weights:6s}: "
                  f"{args[0].numel()} rows -> {got[3]} runs, acc/cnt "
                  "bit-equal to the twin, rows to the sort engine")


def check_sort_card_vs_cpu(nv: int) -> None:
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rgg

    g = generate_rgg(nv)
    rg = louvain_phases(g, device="cuda", engine="sort")
    rc = louvain_phases(g, device="cpu", engine="sort")
    if not np.array_equal(rg.communities, rc.communities):
        fail(f"RGG {nv} sort engine: card and CPU labels differ")
    its = ([p.iterations for p in rg.phases], [p.iterations for p in rc.phases])
    if its[0] != its[1]:
        fail(f"RGG {nv} sort engine: phases/iterations differ: {its}")
    if abs(rg.modularity - rc.modularity) > 1e-9:
        fail(f"RGG {nv} sort engine: Q {rg.modularity} vs {rc.modularity}")
    engines = [p.coalesce for p in rg.phases]
    if "dense" not in engines:
        fail(f"RGG {nv} sort engine: no dense coarsening ({engines})")
    print(f"  RGG {nv}: {g.num_edges} directed edges, {len(rg.phases)} "
          f"phases, iterations {its[0]}, Q {rg.modularity:.9f} on card and "
          f"CPU, labels identical; coarsenings {engines}")


def run_sort_path(g, nv: int) -> tuple:
    """The sort path on the card; returns (seg_coalesce launches, the
    dense coarsenings' relabeled slabs and results)."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.evaluate.modularity import modularity
    from cuvite_tpu_torch.kernels.heavy_bincount import heavy_argmax
    from cuvite_tpu_torch.kernels.row_argmax import row_argmax
    from cuvite_tpu_torch.kernels.seg_coalesce import seg_coalesce
    from cuvite_tpu_torch.ops import segment as seg

    # Observe, without changing, every coalesce of the run: keep the
    # relabeled slab and the result of each dense one.
    captured = []
    coalesced_runs = seg.coalesced_runs

    def observed(src, ckey, w, *, nv_pad, engine="sort"):
        out = coalesced_runs(src, ckey, w, nv_pad=nv_pad, engine=engine)
        if engine == "dense":
            captured.append(((src, ckey, w), nv_pad, out))
        return out

    seg.coalesced_runs = observed
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row_argmax.launches = heavy_argmax.launches = 0
        seg_coalesce.launches = 0
        t0 = time.perf_counter()
        res = louvain_phases(g, engine="sort")
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = seg_coalesce.launches
    finally:
        seg.coalesced_runs = coalesced_runs
    for p in res.phases:
        st = " ".join(f"{k} {v:.3f}" for k, v in p.stages.items())
        print(f"  phase {p.phase}: nv {p.num_vertices} ne {p.num_edges} "
              f"iterations {p.iterations} Q {p.modularity:.9f} seconds "
              f"{p.seconds:.3f} coalesce {p.coalesce} (host stages, s: "
              f"{st})")
    print(f"  RGG {nv}: total {total_s:.3f} s, {res.total_iterations} "
          f"sweeps, max_memory_allocated {torch.cuda.max_memory_allocated()}"
          f" B, seg_coalesce launches {launches} (row_argmax "
          f"{row_argmax.launches}, heavy_bincount {heavy_argmax.launches})")
    if launches == 0:
        fail(f"seg_coalesce never launched on the RGG {nv} sort path "
             f"(coarsenings {[p.coalesce for p in res.phases]})")
    q_host = modularity(g, res.communities)
    if abs(q_host - res.modularity) > 1e-6:
        fail(f"RGG {nv}: reported Q {res.modularity} vs host f64 {q_host}")
    print(f"  reported Q {res.modularity:.9f}, host f64 Q {q_host:.9f}")
    for k, (args, nv_pad, got) in enumerate(captured):
        ref = coalesced_runs(*args, nv_pad=nv_pad, engine="sort")
        if got[3] != ref[3] or not (bits_equal(got[0], ref[0])
                                    and bits_equal(got[1], ref[1])):
            fail(f"dense coarsening {k} (nv_pad {nv_pad}): rows differ "
                 "from the sort engine's")
        n = got[3]
        a = got[2][:n].cpu().view(torch.int32).long()
        b = ref[2][:n].cpu().view(torch.int32).long()
        ulps = (a - b).abs()
        if n and int(ulps.max()) > 1:
            fail(f"dense coarsening {k}: a weight differs by "
                 f"{int(ulps.max())} f32 ulps from the sort engine's")
        print(f"  dense coarsening {k}: nv_pad {nv_pad}, "
              f"{args[0].numel()} slab rows -> {n} rows, equal to the sort "
              f"engine's; {int((ulps > 0).sum())} weights one ulp apart")
    return launches, captured


def time_sort_sweep(g) -> float:
    """Milliseconds of one phase-0 sort-engine sweep (identity assignment)
    on the device stream: with the sweep count, an upper bound on the
    phase's device-busy time."""
    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.louvain.driver import PhaseRunner

    run = PhaseRunner(DistGraph.build(g), "cuda", "sort")
    return time_ms(lambda: run.step(run.comm0), 10)


def time_coalesce(launches: int, captured: list) -> dict:
    """seg_coalesce at the relabeled slab of the sort path's first dense
    coarsening.  The bound counts the bytes the function must move: 12 B
    per real slab row read (src, dst, w) and the nv_pad^2 x 12 B of
    outputs (f64 acc, i32 cnt) written once; its operations are one f64
    add per real row."""
    import torch

    from cuvite_tpu_torch.kernels.seg_coalesce import (
        emit_coalesced,
        seg_coalesce,
        seg_coalesce_plain,
    )
    from cuvite_tpu_torch.ops.segment import coalesced_runs

    (src, dst, w), nv_pad, _ = captured[0]
    acc, cnt = seg_coalesce(src, dst, w, nv_pad=nv_pad)
    racc, rcnt = seg_coalesce_plain(src, dst, w, nv_pad=nv_pad)
    err = max(float((acc - racc).abs().max()),
              float((cnt - rcnt).abs().max()))
    real = src < nv_pad
    rows = int(real.sum())
    kbits = (nv_pad - 1).bit_length()
    flat = (src[real].long() << kbits) | dst[real].long()
    w64 = w[real].double()
    slots = nv_pad * nv_pad

    def library():
        torch.bincount(flat, weights=w64, minlength=slots)
        torch.bincount(flat, minlength=slots)

    b_ms, b_by = bound(rows * 12 + slots * 12, rows, F64_OPS_PER_S)
    k_ms = time_ms(lambda: seg_coalesce(src, dst, w, nv_pad=nv_pad), 20)
    return {
        "name": "seg_coalesce", "route": "cuda",
        "source": "cuvite_tpu_torch/kernels/csrc/seg_coalesce.cu",
        "replaces": "cuvite_tpu/kernels/seg_coalesce.py:202",
        "tpu_function":
            "cuvite_tpu/kernels/seg_coalesce.py:seg_coalesce_pallas",
        "launches": launches, "max_abs_err": err,
        "ms": k_ms, "kernel_ms": k_ms,
        "emit_ms": time_ms(
            lambda: emit_coalesced(acc, cnt, ne_pad=src.numel()), 20),
        "sort_engine_ms": time_ms(
            lambda: coalesced_runs(src, dst, w, nv_pad=nv_pad,
                                   engine="sort"), 20),
        "plain_ms": time_ms(
            lambda: seg_coalesce_plain(src, dst, w, nv_pad=nv_pad), 20),
        "library_ms": time_ms(library, 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "bytes": rows * 12 + slots * 12, "ops": rows, "nv_pad": nv_pad,
        "slab_rows": src.numel(), "real_rows": rows,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="R-MAT scale of the bucketed main-path run")
    ap.add_argument("--check-scale", type=int, default=14,
                    help="R-MAT scale of the card-vs-CPU run")
    ap.add_argument("--rgg-nv", type=int, default=1 << 22,
                    help="RGG vertices of the sort-path run")
    ap.add_argument("--rgg-check-nv", type=int, default=1 << 16,
                    help="RGG vertices of the sort-engine card-vs-CPU run")
    args = ap.parse_args()

    # The run uses one card: show torch only that one, so the device count
    # on the last line is the count the run used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = \
        "0" if visible is None else visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from cuvite_tpu_torch.kernels import _build
        from cuvite_tpu_torch.io.generate import generate_rgg, generate_rmat
    except ImportError as err:
        fail(f"cuvite_tpu_torch is not beside this script ({err})")
    dev = torch.device("cuda")

    print("[1] card")
    print(f"  {smi_line()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build_s = _build.build()
    print(f"  kernels built in {build_s:.2f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    print("[2] row_argmax kernel against its twin, every bucket width")
    check_rows(dev)
    print("[3] heavy_bincount kernel against its twin")
    check_heavy(dev)
    torch.cuda.synchronize()

    print(f"[4] R-MAT {args.check_scale}: card against CPU")
    check_card_vs_cpu(args.check_scale)

    print(f"[5] main path: louvain_phases on R-MAT {args.scale}")
    t0 = time.perf_counter()
    g = generate_rmat(args.scale)
    print(f"  generated {g.num_vertices} vertices, {g.num_edges} directed "
          f"edges, max degree {int(g.degrees().max())} in "
          f"{time.perf_counter() - t0:.2f} s")
    launches, sweeps = run_main_path(g, args.scale)

    print(f"[6] kernels at the R-MAT {args.scale} phase-0 shapes")
    kernels = time_kernels(g, launches, sweeps)
    del g

    print("[7] seg_coalesce kernel against its twin and the sort engine")
    check_coalesce(dev)
    torch.cuda.synchronize()

    print(f"[8] RGG {args.rgg_check_nv}: sort engine, card against CPU")
    check_sort_card_vs_cpu(args.rgg_check_nv)

    print(f"[9] sort path: louvain_phases(engine='sort') on RGG "
          f"{args.rgg_nv}")
    t0 = time.perf_counter()
    g = generate_rgg(args.rgg_nv)
    print(f"  generated {g.num_vertices} vertices, {g.num_edges} directed "
          f"edges in {time.perf_counter() - t0:.2f} s")
    n_coalesce, captured = run_sort_path(g, args.rgg_nv)
    print(f"  one phase-0 sort sweep: {time_sort_sweep(g):.4f} ms on the "
          "device stream")
    del g

    print("[10] seg_coalesce at the first dense coarsening of the sort path")
    kernels.append(time_coalesce(n_coalesce, captured))
    for k in kernels:
        conv = (f", converged {k['ms_converged']:.4f} ms (twin "
                f"{k['plain_ms_converged']:.4f} ms)"
                if "ms_converged" in k else "")
        print(f"  {k['name']}: {k['ms']:.4f} ms (twin {k['plain_ms']:.4f} "
              f"ms){conv}, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']}, library {k['library_ms']}")
        for p in k.get("per_width", []):
            print(f"    width {p['width']:5d}: {p['real_rows']} of "
                  f"{p['rows']} rows real, {p['real_slots']} slots, "
                  f"{p['ms']:.4f} ms, converged {p['ms_converged']:.4f} "
                  f"ms, bound {p['bound_ms']:.4f} ms")
    c = kernels[-1]
    print(f"    seg_coalesce at nv_pad {c['nv_pad']}, {c['real_rows']} real "
          f"rows: emit {c['emit_ms']:.4f} ms, whole sort engine "
          f"{c['sort_engine_ms']:.4f} ms")
    if c["max_abs_err"] != 0.0:
        fail(f"seg_coalesce differs from its twin at the sort-path slab "
             f"(max abs err {c['max_abs_err']})")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
