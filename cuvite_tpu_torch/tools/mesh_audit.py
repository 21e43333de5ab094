"""The mesh audit CLI of the port (M000-M003; the counterpart of the
reference's ``tools/mesh_audit.py``, rules in ``analysis/meshcheck.py``).

Runs the sharded entries -- the bucketed mesh step under the replicated
and sparse exchanges and the env-driven ``auto`` cutover, the two-level
exchange on a hybrid mesh, and the batched fused and bucketed engines
over the batch axis -- at the shapes 8x1, 4x2 and 2x4 (every shard on the
audit's device: ``[device] * 8``; the two-level entry reads a shape as
(dcn, ici)), and grades:

  * M001 -- the collective sequence a sweep (the recorder of
    ``comm/collectives.py``): one sequence for every sweep of a phase and
    one structure at every shape;
  * M002 -- labels and Q bit-identical at every shape;
  * M003 -- bytes a shard against the laws of ``replication_budget.json``
    beside this file (the closed inventory of categories);
  * M000 -- a crashed entry, an unreadable budget, a broken cutover.

Usage:
    python -m cuvite_tpu_torch.tools.mesh_audit            # exit 1 on FAIL
    python -m cuvite_tpu_torch.tools.mesh_audit --smoke    # two entries,
                                                           # two shapes
    ... --entries bucketed_sparse ... --shapes 8x1 4x2 --json --out FILE
    ... --inventory        # the R025 replicated-ok sites (static tier)
    ... --write-budget     # add observed categories (law 'sharded')
    ... --device cpu|cuda  # default: the card when visible, else the CPU

Results are never cached.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BUDGET = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "replication_budget.json")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SMOKE_ENTRIES = ("bucketed_replicated", "bucketed_sparse")
SMOKE_SHAPES = ((4, 2), (2, 4))


def _parse_shapes(tokens):
    shapes = []
    for t in tokens:
        a, _, b = t.partition("x")
        shapes.append((int(a), int(b or 1)))
    return tuple(shapes)


def _inventory() -> list:
    """The R025 replicated-ok inventory of the port's tree (static)."""
    from cuvite_tpu_torch.analysis.callgraph import summarize
    from cuvite_tpu_torch.analysis.engine import SourceFile, iter_py_files
    from cuvite_tpu_torch.analysis.meshspec import replicated_inventory

    summaries = []
    for path in iter_py_files([os.path.join(REPO_ROOT,
                                            "cuvite_tpu_torch")]):
        rel = os.path.relpath(path, REPO_ROOT).replace(os.sep, "/")
        try:
            with open(path, encoding="utf-8") as fh:
                summaries.append(summarize(SourceFile(fh.read(),
                                                      path=path, rel=rel)))
        except (OSError, SyntaxError, ValueError):
            continue
    return replicated_inventory(summaries)


def report_doc(findings, reports, shapes, device) -> dict:
    return {
        "device": device,
        "shapes": [f"{a}x{b}" for a, b in shapes],
        "entries": {
            name: {tag: {"devices": rep.devices, "sweeps": rep.sweeps,
                         "n_results": len(rep.labels),
                         "collectives_a_sweep": len(rep.seq),
                         "ledger": rep.categories if rep.m003
                         else "not graded (batch blocks)"}
                   for tag, rep in by_shape.items()}
            for name, by_shape in reports.items()},
        "findings": [f.to_dict() for f in findings],
        "ok": not findings,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.tools.mesh_audit",
        description="the port's mesh audit (M000-M003)")
    ap.add_argument("--entries", nargs="*", default=None, metavar="NAME",
                    help="subset of entries")
    ap.add_argument("--shapes", nargs="*", default=None, metavar="AxB",
                    help="mesh shapes (default: 8x1 4x2 2x4)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"fast check ({', '.join(SMOKE_ENTRIES)} at "
                         f"{'/'.join(f'{a}x{b}' for a, b in SMOKE_SHAPES)})")
    ap.add_argument("--device", default=None,
                    help="the device of every shard (default: the card "
                         "when one is visible, else the CPU)")
    ap.add_argument("--budget", default=BUDGET)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the JSON report to FILE")
    ap.add_argument("--inventory", action="store_true",
                    help="print the R025 replicated-ok inventory and exit")
    ap.add_argument("--write-budget", action="store_true",
                    help="add the observed categories to the manifest "
                         "(new ones default to law 'sharded'; edit the "
                         "reasons before committing)")
    args = ap.parse_args(argv)

    if args.inventory:
        inv = _inventory()
        if args.json:
            print(json.dumps(inv, indent=2))
        else:
            for ent in inv:
                print(f"{ent['rel']}:{ent['line']}: {ent['call']} "
                      f"[{ent['size']}] [scope={ent['scope']}] -- "
                      f"{ent['reason']}")
            print(f"mesh_audit: {len(inv)} justified replicated "
                  "buffer(s) in the inventory")
        return 0

    from cuvite_tpu_torch.analysis.meshcheck import (
        ENTRIES,
        MESH_SHAPES,
        load_budget,
        run_mesh_audit,
        write_budget,
    )

    bad = sorted(set(args.entries or ()) - set(ENTRIES))
    if bad:
        ap.error(f"unknown entries {bad}; have {sorted(ENTRIES)}")
    # A bare --entries means every entry, never a vacuous audit.
    entries = args.entries or None
    shapes = _parse_shapes(args.shapes) if args.shapes else None
    if args.smoke:
        entries = entries or list(SMOKE_ENTRIES)
        shapes = shapes or SMOKE_SHAPES
    shapes = shapes or MESH_SHAPES
    if args.device is None:
        import torch

        args.device = "cuda:0" if torch.cuda.is_available() else "cpu"

    findings, reports = run_mesh_audit(entries, shapes=shapes,
                                       budget_path=args.budget,
                                       device=args.device)
    if args.write_budget:
        try:
            cats = dict(load_budget(args.budget).get("categories", {}))
        except (OSError, ValueError):
            cats = {}
        observed = sorted({cat for by_shape in reports.values()
                           for rep in by_shape.values()
                           for cat in rep.categories})
        fresh = [cat for cat in observed if cat not in cats]
        for cat in fresh:
            cats[cat] = {"law": "sharded",
                         "reason": "written by --write-budget: declare "
                                   "the law deliberately"}
        write_budget(args.budget, cats, {
            "device_count": 8, "platform": args.device.split(":")[0],
            "shapes": [f"{a}x{b}" for a, b in shapes]})
        print(f"mesh_audit: wrote {len(cats)} categories to "
              f"{args.budget} ({len(fresh)} new)")
        return 0
    doc = report_doc(findings, reports, shapes, args.device)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        for name, by_shape in reports.items():
            state = "FAIL" if any(f.path == f"<mesh:{name}>"
                                  for f in findings) else "ok"
            tags = ", ".join(f"{t} ({r.sweeps} sweeps, {len(r.seq)} "
                             "collectives a sweep)"
                             for t, r in sorted(by_shape.items()))
            print(f"{name}: {tags} [{state}]")
        for f in findings:
            print(f.format())
        print(f"mesh_audit ({args.device}): {len(findings)} finding(s); "
              f"{'FAIL' if findings else 'ok'}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
