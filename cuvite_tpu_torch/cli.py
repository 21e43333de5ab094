"""Command line for the port (a subset of ``cuvite_tpu/cli.py``).

    python -m cuvite_tpu_torch.cli --rmat 20
    python -m cuvite_tpu_torch.cli -n 4194304 --engine sort
    python -m cuvite_tpu_torch.cli --file graph.bin [--bits64] --output
    python -m cuvite_tpu_torch.cli --rmat 20 --engine fused
    python -m cuvite_tpu_torch.cli --rmat 20 -t 3 -c 8
    python -m cuvite_tpu_torch.cli --rmat 20 --checkpoint-dir ck [--resume]

``-n NV`` generates the random geometric graph of the reference
application's ``-n`` (no ``-e`` extra edges yet), ``--seed`` its stream.

Runs on the CUDA card by default; ``--device cpu`` runs the kernels' plain
PyTorch versions instead.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuvite_tpu_torch",
        description="Louvain community detection on one CUDA device")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--file", "-f", help="Vite binary graph file")
    src.add_argument("--rmat", type=int, metavar="SCALE",
                     help="generate an R-MAT graph of 2^SCALE vertices")
    src.add_argument("--generate", "-n", type=int, metavar="NV",
                     help="generate a random geometric graph of NV "
                          "vertices")
    p.add_argument("--seed", type=int, default=1,
                   help="seed of the generated graph")
    p.add_argument("--engine", choices=("auto", "bucketed", "sort", "fused"),
                   default="auto",
                   help="sweep engine (auto = bucketed)")
    p.add_argument("--bits64", action="store_true",
                   help="the file uses 64-bit ids and weights")
    p.add_argument("--threshold", type=float, default=1e-6)
    p.add_argument("--threshold-cycling", "-i", action="store_true")
    p.add_argument("--one-phase", "-p", action="store_true")
    p.add_argument("--early-term", "-t", type=int, choices=[1, 2, 3, 4],
                   help="early termination mode")
    p.add_argument("--et-delta", "-a", type=float, default=0.25)
    p.add_argument("--coloring", "-c", type=int, metavar="NC",
                   help="distance-1 coloring with NC max colors")
    p.add_argument("--vertex-ordering", "-d", type=int, metavar="NC",
                   help="color-based vertex ordering with NC max colors")
    p.add_argument("--checkpoint-dir", metavar="DIR",
                   help="save the state after each phase")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--output", "-o", action="store_true",
                   help="write <graph>.communities")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from cuvite_tpu_torch.evaluate.modularity import (
        modularity,
        write_communities,
    )
    from cuvite_tpu_torch.io.generate import generate_rgg, generate_rmat
    from cuvite_tpu_torch.io.vite import read_vite
    from cuvite_tpu_torch.louvain.driver import louvain_phases

    t0 = time.perf_counter()
    if args.file:
        graph = read_vite(args.file, bits64=args.bits64)
        name = args.file
    elif args.generate is not None:
        graph = generate_rgg(args.generate, seed=args.seed)
        name = f"rgg{args.generate}"
    else:
        graph = generate_rmat(args.rmat, seed=args.seed)
        name = f"rmat{args.rmat}"
    print(f"Loaded graph: {graph.num_vertices} vertices, "
          f"{graph.num_edges} directed edges "
          f"({time.perf_counter() - t0:.2f}s)")
    res = louvain_phases(graph, threshold=args.threshold,
                         threshold_cycling=args.threshold_cycling,
                         one_phase=args.one_phase, verbose=True,
                         device=args.device, engine=args.engine,
                         et_mode=args.early_term or 0,
                         et_delta=args.et_delta,
                         coloring=args.coloring or 0,
                         vertex_ordering=args.vertex_ordering or 0,
                         checkpoint_dir=args.checkpoint_dir,
                         resume=args.resume)
    q = modularity(graph, res.communities)
    print(f"Final modularity: {q:.6f} ({res.num_communities} communities, "
          f"{res.total_iterations} iterations, {res.total_seconds:.2f}s)")
    if args.output:
        out = name + ".communities"
        write_communities(out, res.communities)
        print(f"Wrote communities to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
