"""The compile-budget and op audit CLI of the port (the counterpart of the
reference's ``tools/compile_audit.py``; ``analysis/op_audit.py`` has the
rules).

Runs the serving-path entries at the representative small slab class
(4096, 16384) -- the class every tiny graph pads to -- twice each, the
second time with other weights, and grades:

  * B001 -- a build, library load or kernel form that matches nothing in
    the closed manifest (``compile_budget.json`` beside this file, one
    section a platform: ``cpu``, the CPU budgets tier-1 grades, and
    ``cuda``, the card's, which the smoke grades);
  * B002 -- the content-changed run built, loaded or first launched
    anything;
  * B003 -- the first run's count over the entry's budget;
  * J001-J003 -- 64-bit ops in a sweep outside the entry's sanctioned
    list, host reads inside a sweep or over the loop's one a sweep, and
    host-to-device copies inside the sweep loop.

It prints, for each entry, its builds and forms, the sweeps it ran, its
host reads (inside sweeps, between them, outside the loops) and each
kernel's launches a sweep.

Usage:
    python -m cuvite_tpu_torch.tools.compile_audit [--device cpu|cuda]
        [--entries NAME ...] [--json] [--manifest FILE]
        [--write-manifest]

The device defaults to the card when one is visible, else the CPU;
exit 1 on any finding.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "compile_budget.json")

MAX_PHASES = 2  # enough to cover the coarse-class paths
SLAB_CLASS = (4096, 16384)


def _run_batched(engine, device):
    def run(seed):
        from cuvite_tpu_torch.analysis.op_audit import tiny_graphs
        from cuvite_tpu_torch.louvain.batched import cluster_many

        cluster_many(tiny_graphs(b=2, content_seed=seed),
                     threshold=1.0e-6, max_phases=MAX_PHASES,
                     engine=engine, device=device, mesh=None)
    return run


def _run_solo(engine, device):
    def run(seed):
        from cuvite_tpu_torch.analysis.op_audit import tiny_graphs
        from cuvite_tpu_torch.louvain.driver import louvain_phases

        # Phase 0 only: the per-graph driver's coarse classes follow the
        # coarsened sizes, which follow the content.
        louvain_phases(tiny_graphs(b=1, content_seed=seed)[0],
                       engine=engine, max_phases=1, device=device)
    return run


def _run_serve(device):
    def run(seed):
        from cuvite_tpu_torch.analysis.op_audit import tiny_graphs
        from cuvite_tpu_torch.serve.queue import LouvainServer, ServeConfig

        server = LouvainServer(ServeConfig(
            b_max=2, linger_s=0.0, engine="bucketed",
            max_phases=MAX_PHASES, device=device, mesh=None))
        for g in tiny_graphs(b=2, content_seed=seed):
            server.submit(g)
        server.step(force=True)
    return run


def _run_subrow(device):
    def run(seed):
        """Three small-class graphs merged as fenced sub-rows of (8192,
        32768) rows: content and sub-row occupancy are operands, never
        build keys."""
        from cuvite_tpu_torch.analysis.op_audit import tiny_graphs
        from cuvite_tpu_torch.core.batch import subrow_layout_for
        from cuvite_tpu_torch.louvain.batched import cluster_packed

        layout = subrow_layout_for(SLAB_CLASS, (8192, 32768))
        cluster_packed(tiny_graphs(b=3, content_seed=seed), layout,
                       threshold=1.0e-6, max_phases=MAX_PHASES,
                       device=device, mesh=None)
    return run


def entries(device) -> dict:
    """name -> run(content_seed) on ``device``; the names are the
    reference's (its manifest keys)."""
    return {
        "solo_fused_sort": _run_solo("sort", device),
        "solo_bucketed": _run_solo("bucketed", device),
        "batched_fused_B2": _run_batched("fused", device),
        "batched_bucketed_B2": _run_batched("bucketed", device),
        "serve_pack_bucketed_B2": _run_serve(device),
        "packed_subrow_B2": _run_subrow(device),
    }


ENTRY_NAMES = tuple(entries("cpu"))


def platform_of(device: str) -> str:
    return "cuda" if str(device).startswith("cuda") else "cpu"


def default_device() -> str:
    import torch

    return "cuda:0" if torch.cuda.is_available() else "cpu"


def run_audit(entry_names=None, manifest_path: str = MANIFEST,
              device: str = "cpu"):
    """The audit results, one :class:`~cuvite_tpu_torch.analysis.op_audit.
    AuditResult` an entry (shared by the CLI, tier-1 and the smoke)."""
    from cuvite_tpu_torch.analysis.op_audit import audit_entry, load_manifest

    try:
        manifest = load_manifest(manifest_path, platform_of(device))
    except (OSError, ValueError):
        manifest = {"entries": {}}
    union = sorted({p for e in manifest["entries"].values()
                    for p in e.get("modules", ())})
    runs = entries(device)
    return [audit_entry(name, runs[name], manifest["entries"].get(name),
                        extra_patterns=union)
            for name in (entry_names or ENTRY_NAMES)]


def write(entry_names, manifest_path: str, device: str) -> None:
    """Record the observed sets as the platform's new manifest section."""
    from cuvite_tpu_torch.analysis.op_audit import (
        audit_entry,
        write_manifest,
    )

    runs = entries(device)
    out = {}
    for name in (entry_names or ENTRY_NAMES):
        res = audit_entry(name, runs[name], manifest_entry={
            "modules": ["*"], "content_independent": False,
            "allow64": [], "reads_per_sweep": 1, "uploads_per_sweep": 0})
        reads = res.reads.get("loop", 0)
        out[name] = {
            "modules": sorted(set(res.observed)),
            "max_compiles": len(res.observed) + 4,
            "content_independent": not res.recompiled,
            "allow64": res.allow64,
            "reads_per_sweep": max(1, -(-reads // max(res.sweeps, 1))),
            "uploads_per_sweep": -(-res.reads["uploads_in_loop"]
                                   // max(res.sweeps, 1)),
        }
        print(f"{name}: {len(res.observed)} build(s)/load(s)/form(s), "
              f"{len(res.recompiled)} on content change, {res.sweeps} "
              f"sweep(s), reads {res.reads}")
    import torch

    write_manifest(manifest_path, platform_of(device), out, {
        "device": str(device),
        "torch": torch.__version__.split("+")[0],
        "max_phases": MAX_PHASES,
        "slab_class": list(SLAB_CLASS),
    })
    print(f"wrote the '{platform_of(device)}' section of {manifest_path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.tools.compile_audit",
        description="the port's compile-budget and op audit (B001-B003, "
                    "J001-J003)")
    ap.add_argument("--entries", nargs="*", default=None,
                    choices=sorted(ENTRY_NAMES), help="subset of entries")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda[:N] (default: the card when one is "
                         "visible, else the CPU)")
    ap.add_argument("--manifest", default=MANIFEST)
    ap.add_argument("--write-manifest", action="store_true",
                    help="record the observed sets as the platform's "
                         "closed manifest (review the diff)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    device = args.device or default_device()

    if args.write_manifest:
        write(args.entries, args.manifest, device)
        return 0
    results = run_audit(args.entries or None, args.manifest, device)
    findings = [f for r in results for f in r.findings]
    if args.json:
        print(json.dumps({"device": device,
                          "entries": [r.to_dict() for r in results],
                          "ok": not findings}, indent=2))
    else:
        for r in results:
            state = "ok" if r.ok else "FAIL"
            print(f"{r.entry}: {len(r.observed)} build(s)/load(s)/"
                  f"form(s), {len(r.recompiled)} on content change, "
                  f"{r.sweeps} sweep(s), reads {r.reads}, launches a "
                  f"sweep {r.launches_per_sweep()} [{state}]")
        for f in findings:
            print(f.format())
        print(f"compile_audit ({device}): {len(findings)} finding(s); "
              f"{'FAIL' if findings else 'ok'}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
