"""graftlint CLI for the port (port of ``cuvite_tpu/analysis/__main__.py``).

Usage:
    python -m cuvite_tpu_torch.analysis [paths...] [--format text|json|sarif]
        [--baseline FILE] [--write-baseline] [--prune-baseline]
        [--fail-on high|medium|low] [--cache FILE] [--no-project]
        [--list-rules]

Exit status: 0 when no NON-BASELINED finding at or above the gate
severity (default: high) remains; 1 otherwise; 2 on usage errors.
With no paths it lints the port's tree (``DEFAULT_PATHS``, from the
repo root) against the port's baseline
(``cuvite_tpu_torch/analysis/baseline.json``) unless ``--baseline`` names
another.  The canonical invocation (what tests/test_torch_analysis.py
and chip_smoke.py run) is:

    python -m cuvite_tpu_torch.analysis --cache build/.graftlint_cache.json

``--format sarif`` emits SARIF 2.1.0 for CI annotation (one result per
non-baselined finding, rule metadata included, snippet-hash partial
fingerprints).  ``--prune-baseline`` rewrites the baseline dropping
entries whose fingerprint matches no current finding (each dead entry
silently admits one future regression); a staleness count is reported
on every text run regardless.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

from cuvite_tpu_torch.analysis.engine import (
    _REPO_ROOT,
    SEVERITIES,
    all_rules,
    apply_baseline,
    gate_failures,
    linted_rels,
    load_baseline,
    prune_baseline,
    run_paths,
    stale_baseline_entries,
    write_baseline,
)
from cuvite_tpu_torch.analysis import rules as _rules        # noqa: F401
from cuvite_tpu_torch.analysis import callgraph as _cg       # noqa: F401
from cuvite_tpu_torch.analysis import lockset as _lockset    # noqa: F401
from cuvite_tpu_torch.analysis import lockorder as _lockord  # noqa: F401
from cuvite_tpu_torch.analysis import meshspec as _meshspec  # noqa: F401

# The port's tree, relative to the repo root (a glob expands there).
DEFAULT_PATHS = ["cuvite_tpu_torch", "tests/test_torch_*.py",
                 "chip_smoke.py", "kernel_ab.py"]
DEFAULT_BASELINE = os.path.join("cuvite_tpu_torch", "analysis",
                                "baseline.json")

# Reference rules with no entry in this registry, printed by --list-rules.
NOT_REGISTERED = {
    "R026-R028": "width rules (widthcheck, widthaudit): not ported yet "
                 "(ROADMAP A9 step 5)",
}

_SARIF_LEVEL = {"high": "error", "medium": "warning", "low": "note"}


def to_sarif(findings, baselined: int = 0) -> dict:
    """SARIF 2.1.0 document for a finding list.  Fingerprints hash the
    same (path, rule, snippet) triple the baseline keys on, so CI-side
    dedup tracks findings across line drift exactly like the gate."""
    rules_meta = [{
        "id": r.id,
        "name": type(r).__name__,
        "shortDescription": {"text": r.title},
        "defaultConfiguration": {"level": _SARIF_LEVEL[r.severity]},
    } for r in all_rules()]
    rules_meta.append({
        "id": "E000",
        "name": "UnprocessableInput",
        "shortDescription": {"text": "unreadable or unparsable input"},
        "defaultConfiguration": {"level": "error"},
    })
    results = []
    for f in findings:
        fp = hashlib.sha256(
            "\x1f".join((f.path, f.rule, f.snippet)).encode()).hexdigest()
        results.append({
            "ruleId": f.rule,
            "level": _SARIF_LEVEL.get(f.severity, "warning"),
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {
                        "startLine": max(f.line, 1),
                        "snippet": {"text": f.snippet},
                    },
                },
            }],
            "partialFingerprints": {"graftlintFingerprint/v1": fp},
        })
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri":
                    "https://example.invalid/cuvite_tpu_torch/analysis",
                "rules": rules_meta,
            }},
            "results": results,
            "properties": {"baselinedFindings": baselined},
        }],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.analysis",
        description="graftlint: static analysis of the PyTorch/CUDA port")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/directories/globs to lint (default, "
                         f"from the repo root: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help="JSON baseline of grandfathered findings "
                         f"(default with no paths: {DEFAULT_BASELINE})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write ALL current findings to --baseline and "
                         "exit 0 (requires --baseline)")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="drop baseline entries whose fingerprint "
                         "matches no current finding (requires "
                         "--baseline)")
    ap.add_argument("--fail-on", choices=SEVERITIES, default="high",
                    help="lowest severity that fails the gate "
                         "(default: high)")
    ap.add_argument("--cache", metavar="FILE", default=None,
                    help="incremental lint cache (per-file findings + "
                         "tier-2 summaries keyed on content sha256 + "
                         "rules version); bit-identical to a cold run")
    ap.add_argument("--no-project", action="store_true",
                    help="skip the project tiers (R017/R018, R020, "
                         "R023-R025) — per-file rules only")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  [{rule.severity:6s}] {rule.title}")
        for rid, why in sorted(_rules.DROPPED_RULES.items()):
            print(f"{rid}  [dropped] {why}")
        print("R014  [note  ] its jit/vmap half is dropped with R002 (no "
              "jit); the per-job upload half is R014 above")
        for rid, why in sorted(NOT_REGISTERED.items()):
            print(f"{rid}  [absent] {why}")
        return 0

    paths = args.paths
    if not paths:
        paths = [os.path.join(_REPO_ROOT, p) for p in DEFAULT_PATHS]
        if args.baseline is None:
            args.baseline = os.path.join(_REPO_ROOT, DEFAULT_BASELINE)
    findings = run_paths(paths, project=not args.no_project,
                         cache=args.cache)

    if args.write_baseline:
        if not args.baseline:
            ap.error("--write-baseline requires --baseline FILE")
        write_baseline(args.baseline, findings)
        errors = [f for f in findings if f.rule == "E000"]
        print(f"wrote {len(findings) - len(errors)} finding(s) to "
              f"{args.baseline}")
        if errors:
            # E000 is never baselineable (engine.write_baseline drops
            # it); pretending the rebaseline captured it would surprise
            # the operator on the very next gated run.
            for f in errors:
                print(f.format())
            print(f"graftlint: {len(errors)} unprocessable input(s) NOT "
                  "baselined; E000 always fails the gate")
            return 1
        return 0

    # Baseline hygiene is SCOPED to the files this run actually linted:
    # a subset run (explicit path args) must neither report nor prune
    # another file's live grandfathered entries.
    linted = linted_rels(paths)

    if args.prune_baseline:
        if not args.baseline:
            ap.error("--prune-baseline requires --baseline FILE")
        if args.no_project:
            # Project-tier entries would look dead with the tiers
            # switched off and be silently deleted.
            ap.error("--prune-baseline cannot run with --no-project")
        dropped = prune_baseline(args.baseline, findings, linted=linted)
        print(f"pruned {dropped} stale baseline slot(s) from "
              f"{args.baseline}")

    baseline = load_baseline(args.baseline) if args.baseline else {}
    new, grandfathered = apply_baseline(findings, baseline)
    failures = gate_failures(new, args.fail_on)
    stale = stale_baseline_entries(findings, baseline, linted=linted) \
        if baseline else []

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in new],
            "baselined": len(grandfathered),
            "stale_baseline": len(stale),
            "gate": {"fail_on": args.fail_on,
                     "failures": len(failures)},
        }, indent=2))
    elif args.format == "sarif":
        print(json.dumps(to_sarif(new, baselined=len(grandfathered)),
                         indent=2))
    else:
        for f in new:
            print(f.format())
        counts = {}
        for f in new:
            counts[f.severity] = counts.get(f.severity, 0) + 1
        summary = ", ".join(f"{counts[s]} {s}" for s in SEVERITIES
                            if s in counts) or "0"
        print(f"graftlint: {len(new)} finding(s) ({summary}); "
              f"{len(grandfathered)} baselined; "
              f"gate fail-on={args.fail_on}: "
              f"{'FAIL' if failures else 'ok'}")
        if stale:
            slots = sum(n for _k, n in stale)
            print(f"graftlint: {slots} stale baseline slot(s) match no "
                  "current finding (each silently admits one future "
                  "regression; --prune-baseline removes them)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
