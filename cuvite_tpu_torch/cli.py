"""Command line for the port (the single-GPU flags of
``cuvite_tpu/cli.py``), the counterpart of the reference application's
``graphClustering``.

    python -m cuvite_tpu_torch.cli --rmat 20 [--edge-factor 16]
    python -m cuvite_tpu_torch.cli -n 4194304 -e 10 --engine sort
    python -m cuvite_tpu_torch.cli --file graph.bin [--bits64] --output
    python -m cuvite_tpu_torch.cli --rmat 20 --engine fused --json
    python -m cuvite_tpu_torch.cli --rmat 20 -t 3 -c 8
    python -m cuvite_tpu_torch.cli --rmat 20 --checkpoint-dir ck [--resume]
    python -m cuvite_tpu_torch.cli -n 65536 -s g.bin -j
    python -m cuvite_tpu_torch.cli --file g.bin -g truth.txt [--gt-zero-based]
    python -m cuvite_tpu_torch.cli --rmat 16 --trace --trace-out t.jsonl \\
        --metrics-out m.json [--profile-dir prof] [--quiet]

Flags as in the reference (reference application -> here): ``-f`` file,
``-n NV`` the random geometric graph of its generator with ``-e PCT``
extra long-range edges, ``-s FILE`` write the generated graph, ``-j``
load or generate only, ``-g FILE`` compare with a ground truth (1-based
ids unless ``--gt-zero-based``), ``-o`` write the communities, ``-t`` /
``-a`` early termination, ``-c`` / ``-d`` coloring and vertex ordering,
``-i`` threshold cycling, ``-p`` one phase.  ``--json`` prints the
reference's summary line, ``--trace`` the stage breakdown, ``--trace-out``
the flight recorder's JSONL trace, ``--metrics-out`` its metrics file,
``--profile-dir`` the card's allocator snapshot.

Runs on the CUDA card by default; ``--device cpu`` runs the kernels'
plain PyTorch versions instead, and the reference's ``--platform`` has no
other counterpart.

    python -m cuvite_tpu_torch.cli --rmat 20 --shards 4 --exchange sparse -b
    python -m cuvite_tpu_torch.cli --rmat 20 --shards 4 --device cuda:0

``--shards N`` runs a vertex mesh of N shards in this one process: on the
first N cards, or all on ``--device`` when it is given (``--device
cuda:0`` puts four shards on one card, ``--device cpu`` on the CPU);
``--balanced``/``-b`` cuts edge-balanced ranges, ``--exchange`` picks the
community exchange and ``--dist-stats`` prints the partition's edge
distribution.

    python -m cuvite_tpu_torch.cli --rmat 20 --mesh 2x2 --device cuda:0 \
        --json --diag-prefix diag/rmat20

``--mesh DxI`` runs the two-level exchange on a hybrid mesh of D groups
of I shards (``--exchange twolevel``; ``1xN`` is ``--shards N``):
community tables replicated only inside a group, ghosts between groups.
``--diag-prefix PREFIX`` writes one line per shard and phase to
``PREFIX.<shard>``; the ``--json`` line of a mesh run carries the
reference's ``exchange`` block.

    torchrun --nproc-per-node 4 -m cuvite_tpu_torch.cli --rmat 20 \
        --shards 4 --distributed [--exchange sparse]
    torchrun --nproc-per-node 2 -m cuvite_tpu_torch.cli --file g.bin \
        --shards 4 --distributed --dist-ingest

``--distributed`` makes this process one rank of a multi-process run
(``comm/multihost.py``: NCCL, one rank per card, or gloo under
``--device cpu``); every rank runs the same command and holds
``--shards / world`` shards.  ``--coordinator HOST:PORT`` (or a
``file://`` store), ``--num-processes`` and ``--process-id`` default to
``CUVITE_COORDINATOR`` / ``CUVITE_NUM_PROCESSES`` / ``CUVITE_PROCESS_ID``,
then to torchrun's variables.  Rank 0 alone prints and writes files
(``-o``, ``-s``, ``--json``, ``-g``, ``--trace``, ``--trace-out``,
``--metrics-out``, ``--profile-dir``, ``--dist-stats``); every rank
computes the same result.  ``--dist-ingest`` reads only this rank's
shards' edge ranges of ``--file`` (``io/dist_ingest.py``; the sparse
exchange and the bucketed engine).  ``-t``/``-a``, ``-c``, ``-d`` and
``--checkpoint-dir``/``--resume`` run with ``--shards``, ``--distributed``
and ``--dist-ingest`` too (rank 0 alone writes the checkpoints), and
``--mesh`` with ``--distributed`` (not with ``--dist-ingest``, coloring or
vertex ordering, as in the reference).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuvite_tpu_torch",
        description="Louvain community detection on CUDA devices")
    src = p.add_argument_group("input")
    src.add_argument("--file", "-f", help="Vite binary graph file")
    src.add_argument("--bits64", action="store_true",
                     help="64-bit vertex ids / double weights in the file")
    src.add_argument("--generate", "-n", type=int, metavar="NV",
                     help="generate a random geometric graph of NV "
                          "vertices")
    src.add_argument("--rmat", type=int, metavar="SCALE",
                     help="generate an R-MAT graph of 2^SCALE vertices")
    src.add_argument("--edge-factor", type=int, default=16,
                     help="R-MAT edges per vertex")
    src.add_argument("--random-edges", "-e", type=int, default=0,
                     metavar="PCT",
                     help="percent extra random edges for generated graphs")
    src.add_argument("--seed", type=int, default=1,
                     help="seed of the generated graph")
    src.add_argument("--write-graph", "-s", metavar="FILE",
                     help="write the generated graph in Vite binary format")

    run = p.add_argument_group("clustering")
    run.add_argument("--device", default=None,
                     help="torch device (default: the CUDA card)")
    run.add_argument("--engine", choices=("auto", "bucketed", "pallas",
                                          "sort", "fused"),
                     default="auto",
                     help="sweep engine (auto = bucketed; pallas, the "
                          "reference's kernel engine, runs bucketed)")
    run.add_argument("--threshold", type=float, default=1e-6)
    run.add_argument("--threshold-cycling", "-i", action="store_true")
    run.add_argument("--one-phase", "-p", action="store_true")
    run.add_argument("--early-term", "-t", type=int, choices=[1, 2, 3, 4],
                     help="early termination mode")
    run.add_argument("--et-delta", "-a", type=float, default=0.25)
    run.add_argument("--coloring", "-c", type=int, metavar="NC",
                     help="distance-1 coloring with NC max colors")
    run.add_argument("--vertex-ordering", "-d", type=int, metavar="NC",
                     help="color-based vertex ordering with NC max colors")
    run.add_argument("--shards", type=int, default=1,
                     help="vertex shards of the mesh (one process drives "
                          "them all; on the first N cards, or all on "
                          "--device when given)")
    run.add_argument("--balanced", "-b", action="store_true",
                     help="edge-balanced partition")
    run.add_argument("--mesh", metavar="DCNxICI",
                     help="2-D hybrid mesh 'dcn x ici' (e.g. 2x4) for the "
                          "two-level exchange: community tables replicate "
                          "only inside each ICI group, cross-group traffic "
                          "rides the sparse ghost protocol on the DCN "
                          "axis; 1xN is --shards N")
    run.add_argument("--exchange", default="auto",
                     choices=["auto", "replicated", "sparse", "twolevel"],
                     help="community exchange of a mesh: 'sparse' = "
                          "per-phase ghost routing, O(owned + ghosts) a "
                          "sweep; 'replicated' = all_gather of the whole "
                          "community vector; 'twolevel' = ICI-group "
                          "tables + DCN ghost routing (requires --mesh "
                          "with dcn > 1); 'auto' picks by graph size per "
                          "phase")
    run.add_argument("--dist-ingest", action="store_true",
                     help="each rank reads only its shards' edge ranges "
                          "of --file (sparse exchange, bucketed engine)")

    dist = p.add_argument_group("distributed (one rank per card)")
    dist.add_argument("--distributed", action="store_true",
                      help="join a multi-process run over torch.distributed "
                           "(NCCL; gloo with --device cpu); every rank runs "
                           "the same command")
    dist.add_argument("--coordinator", metavar="HOST:PORT",
                      help="rendezvous address, or a file:// store "
                           "(default: $CUVITE_COORDINATOR, else torchrun's "
                           "MASTER_ADDR:MASTER_PORT)")
    dist.add_argument("--num-processes", type=int,
                      help="world size (default: $CUVITE_NUM_PROCESSES, "
                           "else $WORLD_SIZE)")
    dist.add_argument("--process-id", type=int,
                      help="this process's rank (default: "
                           "$CUVITE_PROCESS_ID, else $RANK)")
    run.add_argument("--checkpoint-dir", metavar="DIR",
                     help="save the state after each phase")
    run.add_argument("--resume", action="store_true",
                     help="resume from the latest checkpoint in "
                          "--checkpoint-dir")

    out = p.add_argument_group("output")
    out.add_argument("--output", "-o", action="store_true",
                     help="write <graph>.communities")
    out.add_argument("--ground-truth", "-g", metavar="FILE",
                     help="compare against a ground truth (LFR format)")
    out.add_argument("--gt-zero-based", action="store_true",
                     help="ground-truth community ids start at 0")
    out.add_argument("--just-process", "-j", action="store_true",
                     help="load or generate (and write) the graph only")
    out.add_argument("--json", action="store_true",
                     help="emit a machine-readable summary line")
    out.add_argument("--dist-stats", action="store_true",
                     help="print the partition's edge distribution")
    out.add_argument("--diag-prefix", metavar="PREFIX",
                     help="write per-shard diagnostic files "
                          "PREFIX.<shard> (the reference application's "
                          "dat.out.<rank> streams)")
    out.add_argument("--trace", action="store_true",
                     help="print the stage-time breakdown, counters, TEPS "
                          "and RSS high-water")
    out.add_argument("--trace-out", metavar="FILE.jsonl",
                     help="write the flight recorder's span/event trace "
                          "as JSONL")
    out.add_argument("--metrics-out", metavar="FILE.json",
                     help="write a metrics summary: stage times, "
                          "convergence rows, kernel build and load "
                          "events, device-memory peaks")
    out.add_argument("--profile-dir", metavar="DIR",
                     help="write the card's allocator snapshot "
                          "(torch.cuda.memory_stats) under DIR")
    out.add_argument("--quiet", action="store_true")
    return p


def validate(args) -> None:
    """The reference's checks (``cuvite_tpu/cli.py:169``) for the flags
    the port has."""
    if args.shards < 1:
        raise SystemExit("--shards must be >= 1")
    if not args.file and args.generate is None and args.rmat is None:
        raise SystemExit("Must specify --file, --generate or --rmat")
    if sum(x is not None for x in (args.file, args.generate, args.rmat)) > 1:
        raise SystemExit("--file, --generate and --rmat are exclusive")
    if args.random_edges and args.generate is None:
        raise SystemExit("--random-edges requires --generate")
    if args.coloring and args.vertex_ordering:
        raise SystemExit("Cannot enable both --coloring and --vertex-ordering")
    if args.one_phase and args.threshold_cycling:
        raise SystemExit("Cannot combine --one-phase with --threshold-cycling")
    if args.early_term in (2, 4) and not (0.0 <= args.et_delta <= 1.0):
        raise SystemExit("--et-delta must be in [0, 1]")
    if args.dist_ingest:
        if not args.file:
            raise SystemExit("--dist-ingest requires --file")
        if args.shards < 2:
            raise SystemExit("--dist-ingest requires --shards >= 2")
        if args.engine not in ("auto", "bucketed", "pallas"):
            raise SystemExit("--dist-ingest supports only the bucketed "
                             "engine")
        if args.write_graph:
            raise SystemExit("--dist-ingest is incompatible with "
                             "--write-graph (no rank holds the full graph)")
    if not args.distributed and (args.coordinator or args.process_id
                                 is not None or args.num_processes):
        raise SystemExit("--coordinator, --num-processes and --process-id "
                         "need --distributed")
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    if args.mesh:
        try:
            d, _, i = args.mesh.lower().replace("\u00d7", "x").partition("x")
            dcn, ici = int(d), int(i)
        except ValueError:
            raise SystemExit(f"--mesh must be DCNxICI (e.g. 2x4), "
                             f"got {args.mesh!r}") from None
        if dcn < 1 or ici < 1:
            raise SystemExit("--mesh factors must be >= 1")
        if args.shards not in (1, dcn * ici):
            raise SystemExit(f"--shards {args.shards} conflicts with "
                             f"--mesh {args.mesh} ({dcn * ici} devices)")
        if dcn > 1:
            if args.coloring or args.vertex_ordering:
                raise SystemExit("--mesh with dcn > 1 (two-level exchange) "
                                 "is incompatible with --coloring/"
                                 "--vertex-ordering")
            if args.engine in ("sort", "fused"):
                raise SystemExit("--mesh with dcn > 1 requires the "
                                 "bucketed engine")
            if args.dist_ingest:
                raise SystemExit("--mesh with dcn > 1 does not support "
                                 "--dist-ingest yet")
            if args.exchange == "replicated":
                raise SystemExit("--mesh with dcn > 1 runs the two-level "
                                 "exchange; --exchange replicated needs a "
                                 "flat mesh")
    elif args.exchange == "twolevel":
        raise SystemExit("--exchange twolevel requires --mesh DCNxICI "
                         "with dcn > 1")
    if args.checkpoint_dir and args.one_phase:
        raise SystemExit("--checkpoint-dir is incompatible with --one-phase")


# What rank 0 alone does: each flag that prints a report or writes a file,
# with its value on the other ranks (the reference's list,
# cuvite_tpu/cli.py:255-266).  The driver also writes --diag-prefix on
# rank 0 alone.
_RANK0_ONLY = {"quiet": True, "output": False, "json": False,
               "ground_truth": None, "trace": False, "dist_stats": False,
               "diag_prefix": None, "write_graph": None, "trace_out": None,
               "metrics_out": None, "profile_dir": None}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    validate(args)
    if not args.distributed:
        return _run(args)
    from cuvite_tpu_torch.comm import multihost

    with multihost.fail_together():
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, device=args.device)
        if multihost.rank() != 0:
            for flag, off in _RANK0_ONLY.items():
                setattr(args, flag, off)
        rc = _run(args)
        multihost.shutdown()
    return rc


def _run(args) -> int:
    from cuvite_tpu_torch.evaluate.compare import (
        compare_communities,
        load_ground_truth,
        write_communities,
    )
    from cuvite_tpu_torch.evaluate.modularity import modularity
    from cuvite_tpu_torch.io.generate import generate_rgg, generate_rmat
    from cuvite_tpu_torch.io.vite import read_vite, write_vite
    from cuvite_tpu_torch.louvain.driver import louvain_phases
    from cuvite_tpu_torch.utils.trace import Tracer, rss_high_water_mb

    t0 = time.perf_counter()
    if args.dist_ingest:
        from cuvite_tpu_torch.io.dist_ingest import DistVite

        graph = DistVite.load(args.file, args.shards, bits64=args.bits64,
                              balanced=args.balanced)
        name = args.file
    elif args.file:
        graph = read_vite(args.file, bits64=args.bits64)
        name = args.file
    elif args.rmat is not None:
        graph = generate_rmat(args.rmat, edge_factor=args.edge_factor,
                              seed=args.seed)
        name = f"rmat{args.rmat}"
    else:
        graph = generate_rgg(args.generate, seed=args.seed,
                             random_edge_percent=args.random_edges)
        name = f"rgg{args.generate}"
    if not args.quiet:
        print(f"Loaded graph: {graph.num_vertices} vertices, "
              f"{graph.num_edges} directed edges "
              f"({time.perf_counter() - t0:.2f}s)")
    if args.write_graph:
        write_vite(args.write_graph, graph, bits64=args.bits64)
        if not args.quiet:
            print(f"Wrote graph to {args.write_graph}")
    if args.just_process:
        return 0

    # Any of --trace-out / --metrics-out / --profile-dir attaches a flight
    # recorder; without --trace-out it keeps no emitter (NO_TRACE).
    recorder = None
    rec_ctx = contextlib.nullcontext()
    if args.trace_out or args.metrics_out or args.profile_dir:
        from cuvite_tpu_torch.obs import (
            NO_TRACE,
            FlightRecorder,
            JsonlTraceSink,
        )

        sink = JsonlTraceSink(args.trace_out) if args.trace_out else NO_TRACE
        recorder = FlightRecorder(sink, profile_dir=args.profile_dir)
        rec_ctx = recorder
    tracer = Tracer(enabled=args.trace, recorder=recorder)
    with rec_ctx:
        res = louvain_phases(graph, threshold=args.threshold,
                             threshold_cycling=args.threshold_cycling,
                             one_phase=args.one_phase,
                             verbose=not args.quiet, device=args.device,
                             engine=args.engine,
                             et_mode=args.early_term or 0,
                             et_delta=args.et_delta,
                             coloring=args.coloring or 0,
                             vertex_ordering=args.vertex_ordering or 0,
                             checkpoint_dir=args.checkpoint_dir,
                             resume=args.resume, tracer=tracer,
                             nshards=args.shards, mesh_shape=args.mesh,
                             balanced=args.balanced,
                             exchange=args.exchange,
                             dist_stats=args.dist_stats,
                             diag_prefix=args.diag_prefix)
    if args.trace:
        print(tracer.report())
    if args.trace_out and not args.quiet:
        print(f"Wrote trace to {args.trace_out}")

    # No rank holds a per-rank-ingest graph whole: its Q is the driver's,
    # reduced across the ranks.
    q = (res.modularity if args.dist_ingest
         else modularity(graph, res.communities))
    teps = sum(p.num_edges * p.iterations for p in res.phases) / max(
        sum(p.seconds for p in res.phases), 1e-9)
    if not args.quiet:
        print(f"Final modularity: {q:.6f} "
              f"({res.num_communities} communities, "
              f"{res.total_iterations} iterations, "
              f"{res.total_seconds:.2f}s, TEPS {teps:.3g})")
    if args.output:
        out = name + ".communities"
        write_communities(out, res.communities)
        if not args.quiet:
            print(f"Wrote communities to {out}")
    if args.ground_truth:
        truth = load_ground_truth(args.ground_truth,
                                  zero_based=args.gt_zero_based)
        print(compare_communities(truth, res.communities).report())

    summary = {
        "graph": name,
        "nv": graph.num_vertices,
        "ne": graph.num_edges,
        "modularity": q,
        "communities": res.num_communities,
        "iterations": res.total_iterations,
        "phases": len(res.phases),
        "seconds": res.total_seconds,
        "teps": teps,
    }
    if res.exchange_stats:
        # The mesh run's exchange (reference cli.py:404-414): its mode,
        # and on a two-level run dcn, ici and the per-device bytes.
        xs = res.exchange_stats
        summary["exchange"] = {
            k: xs[k] for k in ("mode", "dcn", "ici",
                               "table_bytes_per_device", "ghost_bytes")
            if k in xs}
    if args.json:
        print(json.dumps(summary))
    if args.metrics_out:
        metrics = dict(summary)
        metrics["stages"] = tracer.breakdown()
        metrics["rss_mb"] = round(rss_high_water_mb(), 1)
        if res.convergence:
            metrics["convergence"] = [pc.to_dict() for pc in res.convergence]
        metrics["compile_events"] = recorder.compile_events
        metrics["hbm_peak_by_buffer"] = recorder.ledger.peak_by_buffer
        metrics["hbm_snapshots"] = recorder.ledger.snapshots
        with open(args.metrics_out, "w", encoding="utf-8") as f:
            json.dump(metrics, f, indent=1)
            f.write("\n")
        if not args.quiet:
            print(f"Wrote metrics to {args.metrics_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
