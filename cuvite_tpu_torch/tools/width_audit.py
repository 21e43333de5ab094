"""The width audit CLI of the port (W001-W003; the counterpart of the
reference's ``tools/width_audit.py``, rules in
``analysis/widthaudit.py``).

Runs the device-path entries -- the sort-engine step and the sort
coalesce on ``meta`` tensors at the Friendster and R-MAT 28 shard shapes,
the fused and bucketed phases and the device coarsening at reduced
shapes projected back, the batched execute and the dense coalesce at
their own classes -- and grades:

  * W001 -- index-carrying buffers (arange / cumsum run ids) wide enough
    for the extent they index;
  * W002 -- every eligibility predicate selecting its fallback at its
    boundary (the 31- and 62-bit packs, SLAB_NE_MAX, FLAT_NV_MAX, the
    dense engine's nv ceiling, DENSE_BATCH_MAX_SLOTS);
  * W003 -- a crashed entry, a manifest (``width_budget.json`` beside
    this file) that drifted from the code constants or the registry's
    max workload, or device bytes allocated by the meta entries.

Usage:
    python -m cuvite_tpu_torch.tools.width_audit           # exit 1 on FAIL
    python -m cuvite_tpu_torch.tools.width_audit --smoke   # fast check
    ... --entries solo_sort_step ... --workloads rmat_s28 --json
    ... --inventory        # the width-ok annotated sites (static tier)
    ... --out FILE.json    # write the JSON report
    ... --write-budget     # regenerate the manifest (review the diff)
    ... --device cpu|cuda  # default: the card when visible, else the CPU

Results are never cached.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BUDGET = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "width_budget.json")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# --smoke: the meta slab entries at one workload plus every probe (the
# probes carry most of W002's teeth).
SMOKE_ENTRIES = ("solo_sort_step", "coalesce_sort")
SMOKE_WORKLOADS = ("rmat_s28",)


def _inventory() -> list:
    """The width-ok inventory of the port's tree (static tier, no torch)."""
    from cuvite_tpu_torch.analysis.callgraph import summarize
    from cuvite_tpu_torch.analysis.engine import SourceFile, iter_py_files
    from cuvite_tpu_torch.analysis.widthcheck import width_inventory

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
    return width_inventory(summaries)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.tools.width_audit",
        description="the port's index-width audit (W001-W003)")
    ap.add_argument("--entries", nargs="*", default=None,
                    metavar="NAME", help="subset of entries")
    ap.add_argument("--workloads", nargs="*", default=None,
                    metavar="NAME", help="subset of workloads "
                    "(friendster, rmat_s28)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"fast check ({', '.join(SMOKE_ENTRIES)} at "
                         f"{'/'.join(SMOKE_WORKLOADS)} + every probe)")
    ap.add_argument("--device", default=None,
                    help="where the reduced and fixed entries run and "
                         "the spy reads (default: the card when one is "
                         "visible, else the CPU)")
    ap.add_argument("--budget", default=BUDGET)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the JSON report to FILE")
    ap.add_argument("--inventory", action="store_true",
                    help="print the width-ok inventory and exit")
    ap.add_argument("--write-budget", action="store_true",
                    help="regenerate the manifest from the code constants, "
                         "the registry's max workload and the shapes")
    args = ap.parse_args(argv)

    if args.inventory:
        inv = _inventory()
        if args.json:
            print(json.dumps(inv, indent=2))
        else:
            for ent in inv:
                print(f"{ent['rel']}:{ent['line']}: {ent['kind']} "
                      f"[{ent['bound']}] -- {ent['reason']}")
            print(f"width_audit: {len(inv)} justified site(s) in the "
                  "inventory")
        return 0

    from cuvite_tpu_torch.analysis.widthaudit import (
        DROPPED_LAWS,
        ENTRIES,
        audit_workloads,
        code_laws,
        run_width_audit,
        write_budget,
    )

    if args.write_budget:
        from cuvite_tpu_torch.workloads import registry

        write_budget(args.budget, {
            "laws": code_laws(),
            "dropped_laws": DROPPED_LAWS,
            "max_workload": registry.max_workload(),
            "workloads": audit_workloads(),
        })
        print(f"width_audit: wrote {args.budget} (review the diff)")
        return 0

    bad = sorted(set(args.entries or ()) - set(ENTRIES))
    if bad:
        ap.error(f"unknown entries {bad}; have {sorted(ENTRIES)}")
    # A bare --entries means every entry, never a vacuous audit.
    entries = args.entries or None
    workloads = args.workloads or None
    if args.smoke:
        entries = entries or list(SMOKE_ENTRIES)
        workloads = workloads or list(SMOKE_WORKLOADS)
    if args.device is None:
        import torch

        args.device = "cuda:0" if torch.cuda.is_available() else "cpu"

    findings, reports = run_width_audit(entries, workloads=workloads,
                                        budget_path=args.budget,
                                        device=args.device)
    doc = {"device": args.device, "reports": reports,
           "findings": [f.to_dict() for f in findings],
           "ok": not findings}
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True, default=str))
    else:
        for wname in sorted(k for k in reports
                            if k not in ("probes", "spy")):
            for name, rep in sorted(reports[wname].items()):
                state = "FAIL" if any(f.path == f"<width:{name}>"
                                      for f in findings) else "ok"
                print(f"{wname} {name}: {rep.get('mode')} nv={rep.get('nv')}"
                      f" ne={rep.get('ne')} x{rep.get('scale')} "
                      f"sorts={rep.get('sorts')} [{state}]")
        print(f"width_audit: spy {reports.get('spy')}")
        for f in findings:
            print(f.format())
        print(f"width_audit ({args.device}): {len(findings)} finding(s); "
              f"{'FAIL' if findings else 'ok'}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
