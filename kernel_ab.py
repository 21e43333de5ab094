"""A/B timing of the port's one-graph kernel paths, or of its serving
batches, between two trees of this repo, on one CUDA card.

    python3 kernel_ab.py OLD_TREE NEW_TREE [--pairs 3] [--scale 20]
    python3 kernel_ab.py TREE TREE [TREE ...] --many [--pairs 3] [--reps 5]

Each tree's ``cuvite_tpu_torch`` runs in its own process (its kernels
built from its own sources under its own ``build/``), the trees in turn,
``--pairs`` rounds: OLD, NEW, OLD, NEW, ...  Each process prints one JSON
line: at the phase-0 shapes of
R-MAT ``--scale`` (bucketed engine, identity assignment) the row
kernel's class launches of one sweep, one whole ``bucketed_step`` sweep
and the heavy launch, and the whole dense coalesce
(``coalesced_runs_batched(engine="dense")``: whatever kernels and
emission the tree has) of a 22,059-row slab at nv_pad 4096, the shape of
the RGG 4,194,304 sort path's first dense coarsening, beside the sort
engine on the same slab; CUDA events, the median of 7 blocks of 20 calls
issued back to back (so the host's enqueue time counts when it is the
longer); the host time to enqueue one sweep; and the device memory one
dense coalesce allocates (``torch.cuda.max_memory_allocated`` over what
was live before it) and its device microseconds by kernel name
(torch.profiler).

``--many`` times ``louvain_many`` instead, on the serving batches of
``chip_smoke.py`` phase 17: B=64 synth 4096 and B=64 synth 65536 jobs
(``many_seed(1, k)``), both engines, one warm-up call and then the
median and the list of ``--reps`` calls' host wall seconds (the card
drained before and after each), of their ``pack_s`` and of their peak
device memory; then the whole dense coalesce of the synth 65536 bucketed
batch's first coarsening (the relabeled [64, 65536] slab, captured from
the warm-up call) timed, its allocation and its device microseconds by
kernel measured as above, with its (tenant, src) buckets counted by
length.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# Seconds one tree's measuring child may take (its kernel build and its
# graphs included) before it is killed.
CHILD_TIMEOUT_S = 1800


def _ms(torch, fn, reps=20, blocks=7):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(blocks):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def _host_issue_ms(torch, fn, reps=5, blocks=7):
    """Host time to enqueue one call, the device drained first."""
    out = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t0) * 1e3 / reps)
    torch.cuda.synchronize()
    return statistics.median(out)


def _device_us(torch, fn, calls=10) -> dict:
    """Device microseconds a call of ``fn`` spends in each kernel, by
    name (torch.profiler's CUDA activity over ``calls`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
        name = name.removeprefix("void ") or e.key
        out[name] = out.get(name, 0.0) + e.device_time_total / calls
    return out


def _alloc_bytes(torch, fn) -> int:
    """Device memory one call allocates beyond what was live before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def measure(root: str, scale: int) -> dict:
    """One tree's timings; ``root`` goes first on sys.path."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.kernels.heavy_bincount import heavy_argmax
    from cuvite_tpu_torch.kernels.row_argmax import row_argmax, vertex_table
    from cuvite_tpu_torch.louvain.driver import PhaseRunner
    from cuvite_tpu_torch.ops.segment import (
        coalesced_runs_batched,
        segment_sum,
    )

    run = PhaseRunner(DistGraph.build(generate_rmat(scale)), "cuda")
    c = run.constant   # a float in older trees, TenantConstants after
    const = c.c32 if hasattr(c, "c32") else float(np.float32(c))
    comm = run.comm0
    cd = segment_sum(run.vdeg.double(), comm, run.nv_total).float()
    tables = (comm, cd, run.vdeg, run.plan.self_loop)
    vinfo = vertex_table(*tables)

    def rows():
        for v, d, w, dg in run.plan.buckets:
            row_argmax(d, w, v, *tables, const, dg, vinfo)

    rng = np.random.default_rng(1)
    ne, real, nvp = 1 << 15, 22059, 4096
    src = np.full(ne, nvp, np.int32)
    src[:real] = np.sort(rng.integers(0, 3317, real))
    dst = np.zeros(ne, np.int32)
    dst[:real] = rng.integers(0, 3317, real)
    w = np.zeros(ne, np.float32)
    w[:real] = rng.random(real).astype(np.float32)
    s, d, ww = (torch.from_numpy(a)[None].cuda() for a in (src, dst, w))

    def coalesce(engine):
        return lambda: coalesced_runs_batched(s, d, ww, nv_pad=nvp,
                                              engine=engine)

    return {
        "root": root,
        "sweep_host_issue_ms": _host_issue_ms(torch, lambda: run.step(comm)),
        "row_class_launches_ms": _ms(torch, rows),
        "bucketed_sweep_ms": _ms(torch, lambda: run.step(comm)),
        "heavy_ms": _ms(torch, lambda: heavy_argmax(run.plan.heavy, *tables,
                                                    const)),
        "dense_coalesce_ms": _ms(torch, coalesce("dense")),
        "sort_coalesce_ms": _ms(torch, coalesce("sort")),
        "dense_coalesce_alloc_bytes": _alloc_bytes(torch, coalesce("dense")),
        "dense_coalesce_device_us": _device_us(torch, coalesce("dense")),
    }


def measure_many(root: str, reps: int) -> dict:
    """One tree's louvain_many timings; ``root`` goes first on sys.path."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.ops import segment as seg
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    captured = []
    batched = seg.coalesced_runs_batched

    def observed(src, ckey, w, *, nv_pad, engine="sort", grid=None):
        if engine == "dense" and not captured:
            captured.append((src, ckey, w, nv_pad, grid))
        return batched(src, ckey, w, nv_pad=nv_pad, engine=engine, grid=grid)

    out = {"root": root}
    for edges in (4096, 65536):
        gs = [synthesize_graph(edges, seed=many_seed(1, k))
              for k in range(64)]
        for engine in ("bucketed", "fused"):
            capture = edges == 65536 and engine == "bucketed"
            seg.coalesced_runs_batched = observed if capture else batched
            try:
                louvain_many(gs, engine=engine)
            finally:
                seg.coalesced_runs_batched = batched
            walls, packs, peaks = [], [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                br = louvain_many(gs, engine=engine)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                packs.append(br.pack_s)
                peaks.append(torch.cuda.max_memory_allocated())
            out[f"B=64 synth {edges} {engine}"] = {
                "wall_s": statistics.median(walls),
                "pack_s": statistics.median(packs),
                "max_memory_allocated": max(peaks),
                "walls_s": walls}
    src, ckey, w, nv_pad, grid = captured[0]

    def coalesce():
        batched(src, ckey, w, nv_pad=nv_pad, engine="dense", grid=grid)

    real = src < grid
    key = (torch.arange(src.shape[0], device=src.device)[:, None] * grid
           + src.long())[real]
    per_bucket = torch.bincount(key)
    per_bucket = per_bucket[per_bucket > 0]
    edges = (0, 32, 256, 4096, 1 << 30)
    out["B=64 synth 65536 first dense coarsening"] = {
        "shape": list(src.shape), "nv_pad": nv_pad, "grid": grid,
        "real_rows": int(real.sum()),
        "buckets_by_rows": {f"{a + 1}-{b}": int(((per_bucket > a)
                                                  & (per_bucket <= b)).sum())
                            for a, b in zip(edges, edges[1:])},
        "longest_bucket": int(per_bucket.max()),
        "dense_coalesce_ms": _ms(torch, coalesce),
        "dense_coalesce_alloc_bytes": _alloc_bytes(torch, coalesce),
        "dense_coalesce_device_us": _device_us(torch, coalesce)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", help="OLD_TREE NEW_TREE [...]")
    ap.add_argument("--pairs", type=int, default=3,
                    help="rounds over the trees")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--many", action="store_true",
                    help="time louvain_many on the serving batches")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        out = (measure_many(args.one, args.reps) if args.many
               else measure(args.one, args.scale))
        print(json.dumps(out), flush=True)
        return 0
    if len(args.trees) < 2:
        ap.error("give OLD_TREE and NEW_TREE (and more trees to compare)")
    for _ in range(args.pairs):
        for tree in args.trees:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree, "--scale", str(args.scale),
                            "--reps", str(args.reps)]
                           + (["--many"] if args.many else []),
                           check=True, timeout=CHILD_TIMEOUT_S)
    return 0


if __name__ == "__main__":
    sys.exit(main())
