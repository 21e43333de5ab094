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
and the heavy launch, and the dense coalesce (kernel and emission) of a
22,059-row slab at nv_pad 4096, the shape of the RGG 4,194,304 sort
path's first dense coarsening; CUDA events, the median of 7 blocks of 20
calls; and the host time to enqueue one sweep.

``--many`` times ``louvain_many`` instead, on the serving batches of
``chip_smoke.py`` phase 17: B=64 synth 4096 and B=64 synth 65536 jobs
(``many_seed(1, k)``), both engines, one warm-up call and then the
median and the list of ``--reps`` calls' host wall seconds (the card
drained before and after each) and of their ``pack_s``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


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
    from cuvite_tpu_torch.ops.segment import coalesced_runs, segment_sum

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
    s, d, ww = (torch.from_numpy(a).cuda() for a in (src, dst, w))
    return {
        "root": root,
        "sweep_host_issue_ms": _host_issue_ms(torch, lambda: run.step(comm)),
        "row_class_launches_ms": _ms(torch, rows),
        "bucketed_sweep_ms": _ms(torch, lambda: run.step(comm)),
        "heavy_ms": _ms(torch, lambda: heavy_argmax(run.plan.heavy, *tables,
                                                    const)),
        "dense_coalesce_ms": _ms(torch, lambda: coalesced_runs(
            s, d, ww, nv_pad=nvp, engine="dense")),
    }


def measure_many(root: str, reps: int) -> dict:
    """One tree's louvain_many timings; ``root`` goes first on sys.path."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    out = {"root": root}
    for edges in (4096, 65536):
        gs = [synthesize_graph(edges, seed=many_seed(1, k))
              for k in range(64)]
        for engine in ("bucketed", "fused"):
            louvain_many(gs, engine=engine)
            walls, packs = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                br = louvain_many(gs, engine=engine)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                packs.append(br.pack_s)
            out[f"B=64 synth {edges} {engine}"] = {
                "wall_s": statistics.median(walls),
                "pack_s": statistics.median(packs),
                "walls_s": walls}
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
                           check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
