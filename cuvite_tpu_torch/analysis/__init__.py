"""graftlint for the port — AST-based static analysis of
``cuvite_tpu_torch`` (port of ``cuvite_tpu/analysis``, tiers 1, 2, 2b,
4 static and 5 static).

The properties the port depends on are mostly not testable at unit-test
cost: every rank must issue the same collectives in the same order and
create its process sub-groups in one order, the sweep must not hide host
reads of the device, modularity sums must stay exact, and the serving
layer's shared counters must hold their locks.  graftlint encodes them
as lint rules so every change is checked at AST-walk cost instead of
multi-card reproduction cost.

It is a host-only tool: it imports ``ast`` and the standard library,
never torch, jax or ``cuvite_tpu``, and never touches a device (the
port's rule that entry points run on the card does not apply to it).

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
  cache.py       — incremental lint cache (content-hash keyed)
  baseline.json  — the port's own baseline
  __main__.py    — CLI: python -m cuvite_tpu_torch.analysis [paths]

Not here yet: the dynamic concurrency checker (concheck and its
cooperative Scheduler), the width rules (widthcheck, widthaudit) and the
audits that run the program (the counterparts of jaxpr_audit and
meshcheck).

Suppression syntax: ``# graftlint: disable=R001`` on the flagged line,
``# graftlint: disable-file=R003`` in a file's first 20 lines;
``# graftlint: guarded-by=self.lock`` declares a field's lock (R019);
``# graftlint: replicated-ok=<reason>`` justifies an O(nv_total) buffer
(R025).
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
