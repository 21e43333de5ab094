"""Workloads CLI (port of ``cuvite_tpu/workloads/__main__.py``).

    python -m cuvite_tpu_torch.workloads fetch com-orkut --dest DIR
    python -m cuvite_tpu_torch.workloads fetch --list
    python -m cuvite_tpu_torch.workloads convert in.txt.gz --out out.vite
    python -m cuvite_tpu_torch.workloads synth --edges 1e6 [--many K]
    python -m cuvite_tpu_torch.workloads synth --edges 1e6 --churn 0.01
    python -m cuvite_tpu_torch.workloads bench --graph rmat --scale 20
    python -m cuvite_tpu_torch.workloads bench --batch 64 --batch-edges 4096
    python -m cuvite_tpu_torch.workloads bench --serve-rate 200
    python -m cuvite_tpu_torch.workloads bench --churn-frac 0.01
    python -m cuvite_tpu_torch.workloads verify-golden \\
        --dataset powerlaw-test --file g.vite [--update-golden]

``bench`` forwards its arguments to ``workloads/bench.py`` and prints
exactly one JSON line on stdout (progress on stderr), or none with exit
code 3 (a build or load inside the guarded run) or 4 (an invalid
record).  Every command that clusters runs on the CUDA card unless given
``--device cpu``.  ``synth --churn FRAC`` also writes the deterministic
churn stream against the graph it wrote (``<out>.churn.npz`` and its
provenance), the input of ``bench --churn-frac``'s warm-start arms.
``fetch`` downloads, verifies and converts a catalogued dataset
(``workloads/registry.py``), or without a network writes its synthesized
stand-in and says so; ``convert`` turns a SNAP, Matrix Market or METIS
file into a Vite file (``workloads/convert.py``).  Each prints one JSON
line, and every file written sits beside a ``.provenance.json``.
"""

from __future__ import annotations

import argparse
import json
import sys

DEFAULT_DATA_DIR = "workloads_data"


def _cmd_fetch(args) -> int:
    from cuvite_tpu_torch.workloads.registry import DATASETS, fetch

    if args.list:
        for name, ds in sorted(DATASETS.items()):
            print(f"{name}: |V|={ds.num_vertices} "
                  f"|E|={ds.num_edges_undirected} (undirected) "
                  f"fmt={ds.fmt} sha256={'pinned' if ds.sha256 else 'TOFU'}")
        return 0
    payload = fetch(args.name, args.dest,
                    offline_fallback=not args.no_offline_fallback,
                    synth_edges=args.synth_edges,
                    keep_download=args.keep_download)
    print(json.dumps({"source": payload["source"],
                      "result": payload.get("result")}))
    return 0


def _cmd_convert(args) -> int:
    from cuvite_tpu_torch.workloads.convert import convert
    from cuvite_tpu_torch.workloads.synth import write_provenance

    stats = convert(args.input, args.out, fmt=args.format,
                    bits64=args.bits64, symmetrize=args.symmetrize,
                    relabel=args.relabel)
    write_provenance(args.out, {"source": "converted",
                                "input": args.input,
                                "result": stats.to_dict()})
    print(json.dumps(stats.to_dict()))
    return 0


def _cmd_synth(args) -> int:
    import os

    from cuvite_tpu_torch.workloads.synth import synthesize, synthesize_many

    out = args.out
    if out is None:
        os.makedirs(DEFAULT_DATA_DIR, exist_ok=True)
        out = os.path.join(DEFAULT_DATA_DIR,
                           f"{args.profile}_{int(args.edges)}.vite")
    kw = dict(profile=args.profile, alpha=args.alpha, mu=args.mu,
              overlap=args.overlap, edge_factor=args.edge_factor,
              bits64=args.bits64, write_truth=not args.no_truth)
    if args.many:
        prefix = out[:-5] if out.endswith(".vite") else out
        payload = synthesize_many(prefix, args.many, edges=int(args.edges),
                                  seed=args.seed, **kw)
        print(json.dumps({
            "out_prefix": prefix, "count": payload["count"],
            "provenance": prefix + ".many.provenance.json",
            "graphs": [m["path"] for m in payload["graphs"]]}))
        return 0
    payload = synthesize(out, edges=int(args.edges), seed=args.seed, **kw)
    line = {"out": out, "result": payload["result"],
            "sha256": payload["sha256"]}
    if args.churn:
        # The churn indexes the REALIZED edge set: the file just written,
        # read back.
        from cuvite_tpu_torch.io.vite import read_vite
        from cuvite_tpu_torch.workloads.synth import write_churn

        graph = read_vite(out, bits64=args.bits64)
        churn = write_churn(out, graph, frac=args.churn,
                            seed=args.churn_seed, batches=args.churn_batches)
        line["churn"] = {"npz": out + ".churn.npz",
                         "sha256": churn["sha256"],
                         "frac": churn["churn_frac"],
                         "batches": churn["batches"]}
    print(json.dumps(line))
    return 0


def _cmd_verify_golden(args) -> int:
    from cuvite_tpu_torch.core.device import resolve_device
    from cuvite_tpu_torch.io.vite import read_vite
    from cuvite_tpu_torch.louvain.driver import louvain_phases
    from cuvite_tpu_torch.workloads.golden import measure_run, verify
    from cuvite_tpu_torch.workloads.registry import load_provenance

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"# {e}", file=sys.stderr)
        return 2
    graph = read_vite(args.file, bits64=args.bits64)
    res = louvain_phases(graph, engine=args.engine, device=dev)
    prov = load_provenance(args.file)
    truth = args.truth
    if truth is None and prov and prov.get("truth_path"):
        truth = prov["truth_path"]
    measured = measure_run(res.communities, res, truth_path=truth,
                           zero_based_truth=args.truth_zero_based,
                           provenance=prov.get("source") if prov else None)
    ok, problems = verify(args.dataset, args.config, measured,
                          path=args.golden, update=args.update_golden)
    print(json.dumps({"dataset": args.dataset, "config": args.config,
                      "measured": measured, "ok": ok,
                      "problems": problems,
                      "updated": bool(args.update_golden)}))
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    from cuvite_tpu_torch.workloads.convert import FORMATS
    from cuvite_tpu_torch.workloads.golden import DEFAULT_GOLDEN_PATH
    from cuvite_tpu_torch.workloads.synth import PROFILES

    p = argparse.ArgumentParser(prog="python -m cuvite_tpu_torch.workloads",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fetch", help="download, verify and convert a "
                                     "dataset (offline: synthesize a "
                                     "stand-in)")
    f.add_argument("name", nargs="?", default="")
    f.add_argument("--dest", default=DEFAULT_DATA_DIR)
    f.add_argument("--list", action="store_true")
    f.add_argument("--no-offline-fallback", action="store_true")
    f.add_argument("--synth-edges", type=float, default=None,
                   help="edge count of the offline stand-in")
    f.add_argument("--keep-download", action="store_true")

    s = sub.add_parser("synth", help="synthesize a power-law community "
                                     "graph as a Vite file")
    s.add_argument("--edges", type=float, required=True,
                   help="target directed edge records (e.g. 1e6)")
    s.add_argument("--profile", default="powerlaw", choices=PROFILES)
    s.add_argument("--out", default=None)
    s.add_argument("--seed", type=int, default=1)
    s.add_argument("--alpha", type=float, default=2.3)
    s.add_argument("--mu", type=float, default=0.25)
    s.add_argument("--overlap", type=float, default=0.05)
    s.add_argument("--edge-factor", type=int, default=16)
    s.add_argument("--bits64", action="store_true")
    s.add_argument("--no-truth", action="store_true",
                   help="skip the ground-truth file (large graphs)")
    s.add_argument("--churn", type=float, metavar="FRAC", default=0.0,
                   help="also emit a deterministic insert/delete churn "
                        "stream (<out>.churn.npz + provenance) deleting "
                        "FRAC of the undirected pairs per batch (the "
                        "streaming warm-start bench)")
    s.add_argument("--churn-batches", type=int, default=1)
    s.add_argument("--churn-seed", type=int, default=1)
    s.add_argument("--many", type=int, metavar="K", default=0,
                   help="emit K graphs <out>_<k>.vite on distinct "
                        "splitmix64 streams with one set-level "
                        "provenance file")

    c = sub.add_parser("convert", help="convert SNAP/MTX/METIS to Vite")
    c.add_argument("input")
    c.add_argument("--out", required=True)
    c.add_argument("--format", default="auto",
                   choices=("auto",) + tuple(FORMATS))
    c.add_argument("--bits64", action="store_true")
    c.add_argument("--symmetrize", default="auto",
                   choices=["auto", "yes", "no"])
    c.add_argument("--relabel", default=None,
                   choices=[None, "auto", "none", "dense"])

    sub.add_parser("bench", help="guarded TEPS bench (arguments pass "
                                 "through; see bench --help)",
                   add_help=False)

    v = sub.add_parser("verify-golden", help="run clustering and check "
                                             "the golden envelope")
    v.add_argument("--dataset", required=True)
    v.add_argument("--config", default="default")
    v.add_argument("--file", required=True, help="Vite graph file")
    v.add_argument("--bits64", action="store_true")
    v.add_argument("--engine", default="auto",
                   choices=["auto", "bucketed", "pallas", "sort", "fused"])
    v.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    v.add_argument("--truth", default=None,
                   help="LFR ground-truth file (default: provenance's)")
    v.add_argument("--truth-zero-based", action="store_true")
    v.add_argument("--golden", default=DEFAULT_GOLDEN_PATH)
    v.add_argument("--update-golden", action="store_true")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # `bench` forwards its tail verbatim to the bench parser.
    if argv and argv[0] == "bench":
        from cuvite_tpu_torch.workloads.bench import main as bench_main

        return bench_main(argv[1:])
    args = build_parser().parse_args(argv)
    if args.cmd == "fetch":
        if not args.name and not args.list:
            raise SystemExit("fetch: dataset name required (or --list)")
        return _cmd_fetch(args)
    if args.cmd == "synth":
        return _cmd_synth(args)
    if args.cmd == "convert":
        return _cmd_convert(args)
    return _cmd_verify_golden(args)


if __name__ == "__main__":
    sys.exit(main())
