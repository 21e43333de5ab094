"""graftlint for the port — static and dynamic analysis of
``cuvite_tpu_torch`` (port of ``cuvite_tpu/analysis``, every tier).

The properties the port depends on are mostly not testable at unit-test
cost: every rank must issue the same collectives in the same order and
create its process sub-groups in one order, the sweep must not hide host
reads of the device, modularity sums must stay exact, and the serving
layer's shared counters must hold their locks.  graftlint encodes them
as lint rules so every change is checked at AST-walk cost instead of
multi-card reproduction cost.

The static tiers are host-only: they import ``ast`` and the standard
library, never torch, jax or ``cuvite_tpu``, and never touch a device
(the port's rule that entry points run on the card does not apply to
them).  The dynamic tiers run the port (torch, imported lazily: neither
this package's ``__init__`` nor ``python -m cuvite_tpu_torch.analysis``
loads them) on the card when one is visible, else on the CPU.

Layout:
  engine.py      — source loading, rule registry, the root tables
                   (DEVICE_PATH_ROOTS, MESH_ENTRIES), suppressions,
                   baseline
  rules.py       — tier 1: the per-file rules (R001, R003-R010,
                   R012-R016, R022, R029; R002 and R011 dropped)
  callgraph.py   — tier 2: cross-module device-path reach (R017/R018)
  lockset.py     — tier 2b: serve/ lockset checker (R019)
  lockorder.py   — tier 4 (static): lock-order cycles (R020) and
                   check-then-act atomicity (R021) for serve/
  meshspec.py    — tier 5 (static): mesh scopes (R023), whole-program
                   collective divergence (R024), replication audit (R025)
  widthcheck.py  — tier 6 (static): int32 bounds (R026), untied packs
                   (R027), int32 slab reductions (R028)
  concheck.py    — tier 4 (dynamic): the daemon under serve/sync.py's
                   cooperative Scheduler, races, conservation, replay
  op_audit.py    — tier 3 (dynamic): builds, loads and kernel forms
                   (B001-B003), 64-bit ops, host reads and uploads in the
                   sweep (J001-J003); the op recorder and sweep-root watch
  meshcheck.py   — tier 5 (dynamic): collective sequences (M001), mesh
                   neutrality (M002), bytes a shard (M003)
  widthaudit.py  — tier 6 (dynamic): index widths (W001), boundary
                   probes (W002), audit integrity (W003)
  cache.py       — incremental lint cache (content-hash keyed)
  baseline.json  — the port's own baseline
  __main__.py    — CLI: python -m cuvite_tpu_torch.analysis [paths]

The audits' CLIs are ``python -m cuvite_tpu_torch.analysis.concheck`` and
``python -m cuvite_tpu_torch.tools.width_audit|compile_audit|mesh_audit``,
their manifests beside the tools.

Suppression syntax: ``# graftlint: disable=R001`` on the flagged line,
``# graftlint: disable-file=R003`` in a file's first 20 lines;
``# graftlint: guarded-by=self.lock`` declares a field's lock (R019);
``# graftlint: replicated-ok=<reason>`` justifies an O(nv_total) buffer
(R025); ``# graftlint: width-ok=<reason>`` a deliberate 32-bit or packed
site (R026-R028).
"""

from cuvite_tpu_torch.analysis.engine import (
    DEVICE_PATH_ROOTS,
    MESH_ENTRIES,
    Finding,
    Rule,
    SEVERITIES,
    all_rules,
    apply_baseline,
    load_baseline,
    run_paths,
    run_source,
    write_baseline,
)

# Importing the rule modules populates the registry as a side effect.
from cuvite_tpu_torch.analysis import rules as _rules        # noqa: F401
from cuvite_tpu_torch.analysis import callgraph as _cg       # noqa: F401
from cuvite_tpu_torch.analysis import lockset as _lockset    # noqa: F401
from cuvite_tpu_torch.analysis import lockorder as _lockord  # noqa: F401
from cuvite_tpu_torch.analysis import meshspec as _meshspec  # noqa: F401
from cuvite_tpu_torch.analysis import widthcheck as _width   # noqa: F401
from cuvite_tpu_torch.analysis.callgraph import (
    run_project,
    run_project_sources,
)

__all__ = [
    "DEVICE_PATH_ROOTS",
    "Finding",
    "MESH_ENTRIES",
    "Rule",
    "SEVERITIES",
    "all_rules",
    "apply_baseline",
    "load_baseline",
    "run_paths",
    "run_project",
    "run_project_sources",
    "run_source",
    "write_baseline",
]
