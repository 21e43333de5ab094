"""Tier 5 (dynamic half) -- the mesh audit of the port (M000-M003; the
counterpart of ``cuvite_tpu/analysis/meshcheck.py``).

The static half (``analysis/meshspec.py``: R023-R025) reads source; this
module runs the sharded entries -- the bucketed mesh step under the
replicated and sparse exchanges and the ``auto`` cutover driven by
``CUVITE_EXCHANGE_CUTOVER``, the two-level exchange on a hybrid mesh,
and the batched fused and bucketed engines over the batch axis -- at the
shapes of :data:`MESH_SHAPES` and grades what no AST walk can:

  * **M001 -- the collective sequence.**  The port's collectives are
    Python calls (``comm/collectives.py``), not program equations: the
    audit turns on their recording seam, which logs every call in
    program order with its scope (``v``, ``ici`` or ``dcn``), its dtype
    and its per-shard shapes, and splits the log into sweeps with the
    sweep-root watch of ``analysis/op_audit.py``; shard 0's part of it
    (:func:`shard0_sequence`) is graded.  A sweep whose sequence
    differs from the phase's other sweeps (a collective issued under a
    data-dependent condition: shards that disagree deadlock), or a
    sweep sequence whose structure (names, scopes, dtypes; shapes scale
    with the mesh) changes across mesh shapes, is a conviction.
  * **M002 -- mesh-shape neutrality.**  Labels and Q bit-identical at
    every shape (:func:`assert_mesh_neutral` is the shared helper).
  * **M003 -- per-device bytes against the laws** of
    ``tools/replication_budget.json`` (``sharded``: ~1/S of the global
    bytes a shard; ``ici_replicated``: the full extent over |dcn|;
    ``replicated``: allowed but listed).  Each shard is a device here
    (several shards may share one card or the CPU): a category's bytes a
    shard are ``obs/memory.per_device_nbytes`` over the buffers a
    directly built ``MeshPhaseRunner`` placed for that shard, its global
    bytes the distinct storages of all shards.  ``exchange_tables`` is
    read from the recorded collective outputs (all_gather and non-scalar
    psum) up to the end of the first sweep: per shard the outputs'
    bytes, globally each output times the shard count over the mesh it
    spans (the counterpart of ``exchange_table_bytes``).  The batched
    entries' blocks hold no per-shard ledger, and are not graded by
    M003 (their report says so).
  * **M000 -- audit integrity**: a crashed entry, an unreadable budget,
    or the cutover knob not resolving ``auto`` to the sparse plan.

The port's ``DistGraph`` pads no shard, unlike the reference's shard
floors, so the ``sharded`` law's absolute floor is set from the port's
own small-shape bytes (:data:`SHARDED_FLOOR_BYTES`, 2048 against the
reference's 4096).  Results are never
cached.  ``python -m cuvite_tpu_torch.tools.mesh_audit`` is the CLI.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np

from cuvite_tpu_torch.analysis.engine import Finding
from cuvite_tpu_torch.analysis.op_audit import env_override as _env

# (first, second) factorizations of 8 shards: the flat entries use the
# first as the shard count (vertex shards, or batch blocks); the
# two-level entry reads each as (dcn, ici) of a hybrid mesh.
MESH_SHAPES = ((8, 1), (4, 2), (2, 4))

BUDGET_VERSION = 2
_BUDGET_VERSIONS_OK = (1, 2)

DEFAULT_BUDGET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
    "replication_budget.json")

# Scaling-law tolerance: a 'sharded' category may hold global/S times
# this plus the floor a shard, and a category of at most the floor's
# global bytes is not graded.  The port's DistGraph pads no shard, so the
# floor comes from its own bytes, not from the reference's padded shard
# floors: on the audit graph every graded category of every shape fits
# global/S x SHARDED_TOL with 1152 bytes to spare or more, and the
# smallest (8x1's tables, 18,432 bytes in all, 2,304 a shard) stays
# graded: the floor admits the per-shard scalars, nothing else.
SHARDED_TOL = 1.5
SHARDED_FLOOR_BYTES = 2048

_REPLICATING = ("all_gather", "psum")


def _mfind(rule: str, entry: str, message: str, snippet: str = "") -> Finding:
    return Finding(rule=rule, severity="high", path=f"<mesh:{entry}>",
                   line=0, message=message, snippet=snippet)


# ---------------------------------------------------------------------------
# The collective log, split by sweeps.


@contextlib.contextmanager
def recorded_collectives():
    """(log, marks): every collective call while active, and the log
    index at which each sweep began."""
    from cuvite_tpu_torch.analysis.op_audit import RootWatch
    from cuvite_tpu_torch.comm import collectives

    log: list = []
    marks: list = []

    def on_sweep(k):
        marks.append(len(log))

    prior = collectives.record_to(log)
    try:
        with RootWatch(on_sweep=on_sweep):
            yield log, marks
    finally:
        collectives.record_to(prior)


def _sig(call: dict) -> tuple:
    return (call["op"], call["scope"], call["dtype"])


def shard0_sequence(calls: list) -> tuple:
    """The sequence of ``calls`` that shard 0 takes part in.  One process
    issues a view's collective once for every view of a hybrid mesh;
    shard 0 belongs to the whole mesh, to the first ICI group and to the
    first DCN column (the views first called in each scope: the driver
    walks the views in the mesh's order).  A collective a driver issues
    on one view only (``sparse_modularity``'s a^2 sum over the column of
    each rank's first shard) is in this sequence on every rank's first
    shard alike."""
    first: dict = {}
    for c in calls:
        if c["scope"] in ("ici", "dcn"):
            first.setdefault(c["scope"], c["view"])
    return tuple(_sig(c) for c in calls
                 if c["scope"] not in ("ici", "dcn")
                 or c["view"] == first[c["scope"]])


def sweep_sequences(log: list, marks: list) -> list:
    """Each sweep's shard-0 sequence (the calls from its start to the
    next sweep's; the last sweep also holds the phase's tail, so callers
    compare all but the last)."""
    bounds = list(marks) + [len(log)]
    return [shard0_sequence(log[a:b]) for a, b in zip(bounds, bounds[1:])]


def _flat_sigs(seq) -> list:
    return [f"{op}({scope}):{dt}" for op, scope, dt in seq]


def check_sweeps(entry: str, tag: str, seqs: list) -> list:
    """M001 within one run: every sweep but the last (it holds the
    phase's tail) issues the first sweep's sequence."""
    body = seqs[:-1] if len(seqs) > 1 else seqs
    for k, seq in enumerate(body[1:], start=2):
        if seq != body[0]:
            return [_mfind(
                "M001", entry,
                f"'{entry}' at mesh shape {tag}: sweep {k} issues "
                f"{_flat_sigs(seq)} but sweep 1 issued "
                f"{_flat_sigs(body[0])}: a collective under a "
                "data-dependent condition -- shards that take different "
                "branches issue different sequences and deadlock",
                snippet=f"sweep {k}")]
    return []


def check_sequences(entry: str, seq_by_shape: dict) -> list:
    """M001 across shapes: one sweep's sequence structure at every shape."""
    tags = sorted(seq_by_shape)
    if len({seq_by_shape[t] for t in tags}) <= 1:
        return []
    a = tags[0]
    b = next(t for t in tags[1:] if seq_by_shape[t] != seq_by_shape[a])
    return [_mfind(
        "M001", entry,
        f"'{entry}' issues different collective sequences a sweep at "
        f"mesh shapes {a} and {b} ({_flat_sigs(seq_by_shape[a])} vs "
        f"{_flat_sigs(seq_by_shape[b])}): the schedule forked on the mesh "
        "shape")]


def check_labels(entry: str, labels_by_shape: dict) -> list:
    """M002: per-job labels and Q bit-identical across shapes
    (``labels_by_shape``: {tag: [(labels, q), ...]})."""
    tags = sorted(labels_by_shape)
    if not tags:
        return []
    ref_tag = tags[0]
    ref = labels_by_shape[ref_tag]
    out = []
    for tag in tags[1:]:
        got = labels_by_shape[tag]
        if len(got) != len(ref):
            out.append(_mfind(
                "M002", entry,
                f"'{entry}' returned {len(got)} results at shape {tag} "
                f"vs {len(ref)} at {ref_tag}"))
            continue
        for i, ((la, qa), (lb, qb)) in enumerate(zip(ref, got)):
            if not np.array_equal(np.asarray(la), np.asarray(lb)):
                out.append(_mfind(
                    "M002", entry,
                    f"'{entry}' labels for job {i} differ between mesh "
                    f"shapes {ref_tag} and {tag}: the mesh changed what "
                    "was computed, not just where"))
                break
            if qa != qb:
                out.append(_mfind(
                    "M002", entry,
                    f"'{entry}' modularity for job {i} differs between "
                    f"{ref_tag} ({qa!r}) and {tag} ({qb!r}) with equal "
                    "labels: a shape-dependent reduction order"))
                break
    return out


def check_replication(entry: str, ledger_by_shape: dict,
                      manifest: dict) -> list:
    """M003: per-device bytes against each category's declared law
    (``ledger_by_shape``: {tag: {"devices": n, "axes": {axis: size},
    "categories": {cat: {"global": g, "per_device": p}}}})."""
    cats = manifest.get("categories", {})
    out = []
    seen = set()
    for tag in sorted(ledger_by_shape):
        rep = ledger_by_shape[tag]
        n = max(int(rep.get("devices", 1)), 1)
        n_dcn = max(int(rep.get("axes", {}).get("dcn", 1)), 1)
        for cat, row in sorted(rep.get("categories", {}).items()):
            g = int(row.get("global", 0))
            p = int(row.get("per_device", g))
            if g <= SHARDED_FLOOR_BYTES:
                continue
            law = cats.get(cat, {}).get("law")
            if law is None:
                if cat not in seen:
                    seen.add(cat)
                    out.append(_mfind(
                        "M003", entry,
                        f"'{entry}' holds device category '{cat}', which "
                        "replication_budget.json does not list: the "
                        "inventory is closed -- declare its law "
                        "deliberately", snippet=cat))
                continue
            if law == "sharded" and n > 1:
                allowed = g / n * SHARDED_TOL + SHARDED_FLOOR_BYTES
                if p > allowed:
                    out.append(_mfind(
                        "M003", entry,
                        f"'{entry}' at mesh shape {tag}: category '{cat}' "
                        f"holds {p} bytes a device but its law is "
                        f"'sharded' (global {g} over {n} devices allows "
                        f"~{int(allowed)}): an unsharded buffer rides a "
                        "sharded entry", snippet=cat))
            elif law == "ici_replicated":
                allowed = g / n_dcn * SHARDED_TOL + SHARDED_FLOOR_BYTES
                if p > allowed:
                    out.append(_mfind(
                        "M003", entry,
                        f"'{entry}' at mesh shape {tag}: category '{cat}' "
                        f"holds {p} bytes a device but its law is "
                        f"'ici_replicated' (full extent {g} over "
                        f"|dcn|={n_dcn} allows ~{int(allowed)}): a table "
                        "is replicated past the ICI group", snippet=cat))
    return out


# ---------------------------------------------------------------------------
# Manifest.


def load_budget(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") not in _BUDGET_VERSIONS_OK:
        raise ValueError(f"replication budget {path!r}: unsupported "
                         f"version {data.get('version')!r}")
    return data


def write_budget(path: str, categories: dict, env: dict) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": BUDGET_VERSION, "env": env,
                   "categories": categories}, fh, indent=2,
                  sort_keys=True)
        fh.write("\n")


# ---------------------------------------------------------------------------
# Per-shard bytes.


def _shard_bytes(objs) -> tuple:
    """(per-shard byte list, distinct-storage global bytes) of per-shard
    lists ``objs`` (each a list over the local shards)."""
    from cuvite_tpu_torch.obs.memory import _leaves, per_device_nbytes

    per = None
    storages: dict = {}
    for lst in objs:
        if not lst:
            continue
        if per is None:
            per = [0] * len(lst)
        for i, item in enumerate(lst):
            for t in _leaves([item]):
                b = per_device_nbytes(t)
                per[i] += b
                key = (t.data_ptr(), b) if hasattr(t, "data_ptr") \
                    else (id(t), b)
                storages[key] = b
    return per or [0], sum(storages.values())


def runner_categories(runner) -> dict:
    """{category: {"global", "per_device"}} of a MeshPhaseRunner's placed
    buffers (module note)."""
    mp = runner.plan
    groups = {
        "slab": [runner.slabs],
        "tables": [runner.vdeg, runner.comm0, runner.real_mask],
        "plans": [mp.plans, mp.self_loops, mp.heavy_edges]
        if mp is not None else [],
    }
    if mp is not None and mp.send_idx is not None:
        key = "exchange_grouped" if mp.exchange == "twolevel" \
            else "exchange"
        groups[key] = [mp.send_idx, mp.ghost_sel]
    out = {}
    for cat, objs in groups.items():
        per, glob = _shard_bytes([o for o in objs if o is not None])
        if glob:
            out[cat] = {"global": int(glob), "per_device": int(max(per))}
    return out


def exchange_table_bytes(log: list, upto: int, n_shards: int) -> dict:
    """The ``exchange_tables`` row from the replicating collective
    outputs in ``log[:upto]`` (module note)."""
    per = glob = 0
    for call in log[:upto]:
        if call["op"] not in _REPLICATING or not call["shapes"][0]:
            continue
        if call["op"] == "psum" and call["out_bytes"] <= 8:
            continue       # scalar sums are not tables
        per += call["out_bytes"]
        glob += call["out_bytes"] * max(n_shards // call["size"], 1)
    return {"global": int(glob), "per_device": int(per)}


# ---------------------------------------------------------------------------
# Entries.


class ShapeReport:
    """One (entry, mesh shape) observation."""

    def __init__(self, tag: str, devices: int):
        self.tag = tag
        self.devices = devices
        self.labels: list = []       # [(labels, q)]
        self.seq: tuple = ()         # the first sweep's structure
        self.sweeps = 0
        self.intrinsic: list = []    # M000/M001 findings of the run
        self.categories: dict = {}
        self.axes: dict = {}
        self.m003 = True             # graded by M003

    def ledger_row(self) -> dict:
        return {"devices": self.devices, "axes": self.axes,
                "categories": self.categories}


def audit_graph(nv: int = 2048, ne: int = 8192):
    """The solo entries' graph: fixed structure (ring plus deterministic
    extras), the reference's ``_audit_graph``."""
    from cuvite_tpu_torch.analysis.op_audit import tiny_graphs

    return tiny_graphs(b=1, nv=nv, ne=ne)[0]


def _solo(shape, exchange: str, device: str, *, twolevel: bool = False,
          cutover: bool = False, entry: str = ""):
    from cuvite_tpu_torch.comm.mesh import make_hybrid_mesh, make_mesh
    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.louvain.driver import MeshPhaseRunner, \
        louvain_phases

    n = shape[0] * shape[1] if twolevel else shape[0]
    devs = [device] * n
    report = ShapeReport(f"{shape[0]}x{shape[1]}", n)

    def mesh():
        return make_hybrid_mesh(*shape, devices=devs) if twolevel \
            else make_mesh(devices=devs)

    g = audit_graph()
    ctx = _env("CUVITE_EXCHANGE_CUTOVER", "1") if cutover \
        else contextlib.nullcontext()
    with ctx, recorded_collectives() as (log, marks):
        res = louvain_phases(g, mesh=mesh(), engine="bucketed",
                             exchange="auto" if cutover else exchange,
                             max_phases=1, device=device)
    report.labels = [(np.asarray(res.communities), float(res.modularity))]
    if cutover and (res.exchange_stats or {}).get("mode") == "replicated":
        report.intrinsic.append(_mfind(
            "M000", entry,
            "CUVITE_EXCHANGE_CUTOVER=1 did not resolve exchange='auto' "
            "to the sparse plan: the cutover knob is broken"))
    seqs = sweep_sequences(log, marks)
    report.sweeps = len(seqs)
    report.seq = seqs[0] if seqs else ()
    report.intrinsic += check_sweeps(entry, report.tag, seqs)
    report.axes = ({"dcn": shape[0], "ici": shape[1]} if twolevel
                   else {"v": n})
    runner = MeshPhaseRunner(DistGraph.build(g, n), mesh(), "bucketed",
                             "sparse" if cutover else exchange)
    report.categories = runner_categories(runner)
    report.categories["exchange_tables"] = exchange_table_bytes(
        log, marks[1] if len(marks) > 1 else len(log), n)
    return report


def _batched(shape, engine: str, device: str, b: int = 8, entry: str = ""):
    from cuvite_tpu_torch.analysis.op_audit import tiny_graphs
    from cuvite_tpu_torch.louvain.batched import cluster_many, \
        make_batch_mesh

    nd = shape[0]
    mesh = make_batch_mesh(b, devices=[device] * nd) if nd > 1 else None
    report = ShapeReport(f"{shape[0]}x{shape[1]}", nd)
    with recorded_collectives() as (log, marks):
        br = cluster_many(tiny_graphs(b=b), mesh=mesh, engine=engine,
                          max_phases=2, device=device)
    report.labels = [(np.asarray(r.communities), float(r.modularity))
                     for r in br.results]
    seqs = sweep_sequences(log, marks)
    report.sweeps = len(seqs)
    report.seq = seqs[0] if seqs else ()
    report.intrinsic += check_sweeps(entry, report.tag, seqs)
    report.m003 = False
    return report


# name -> run(shape, device) -> ShapeReport.
ENTRIES = {
    "bucketed_replicated": lambda shape, dev: _solo(
        shape, "replicated", dev, entry="bucketed_replicated"),
    "bucketed_sparse": lambda shape, dev: _solo(
        shape, "sparse", dev, entry="bucketed_sparse"),
    "bucketed_cutover": lambda shape, dev: _solo(
        shape, "sparse", dev, cutover=True, entry="bucketed_cutover"),
    "bucketed_twolevel": lambda shape, dev: _solo(
        shape, "twolevel", dev, twolevel=True, entry="bucketed_twolevel"),
    "batched_fused": lambda shape, dev: _batched(
        shape, "fused", dev, entry="batched_fused"),
    "batched_bucketed": lambda shape, dev: _batched(
        shape, "bucketed", dev, entry="batched_bucketed"),
}


def run_mesh_audit(entry_names=None, shapes=MESH_SHAPES,
                   budget_path: str | None = None, device: str = "cpu",
                   entries: dict | None = None):
    """(findings, reports): {entry: {tag: ShapeReport}}.  Shared by the
    CLI, tier-1 and the smoke.  ``entries`` replaces the registry (the
    tests' sabotage fixtures).  Never cached."""
    table = ENTRIES if entries is None else entries
    budget_path = budget_path or DEFAULT_BUDGET
    manifest_err = None
    try:
        manifest = load_budget(budget_path)
    except (OSError, ValueError) as e:
        manifest = None
        manifest_err = str(e)
    findings: list = []
    reports: dict = {}
    names = list(table) if entry_names is None else list(entry_names)
    for name in names:
        run = table[name]
        by_shape: dict = {}
        for shape in shapes:
            try:
                rep = run(shape, device)
            except Exception as e:  # fail closed: a crash is a finding
                findings.append(_mfind(
                    "M000", name,
                    f"entry '{name}' failed at mesh shape "
                    f"{shape[0]}x{shape[1]}: {type(e).__name__}: {e}"))
                continue
            by_shape[rep.tag] = rep
            findings.extend(rep.intrinsic)
        reports[name] = by_shape
        if len(by_shape) >= 2:
            findings.extend(check_sequences(
                name, {t: r.seq for t, r in by_shape.items()}))
            findings.extend(check_labels(
                name, {t: r.labels for t, r in by_shape.items()}))
        if manifest is not None:
            findings.extend(check_replication(
                name, {t: r.ledger_row() for t, r in by_shape.items()
                       if r.m003}, manifest))
    if manifest is None:
        findings.append(_mfind(
            "M000", "manifest",
            f"replication budget unreadable ({manifest_err}): restore "
            "replication_budget.json or regenerate it with "
            "--write-budget"))
    return findings, reports


def assert_mesh_neutral(run, configs, entry: str = "test") -> None:
    """Assert ``run(config)`` gives bit-identical (labels, Q) pairs for
    every config: the mesh (or engine) changes where work runs, never
    what it computes.  ``run`` returns a list of (labels, Q) pairs."""
    by_tag = {}
    for cfg in configs:
        by_tag[str(cfg)] = [(np.asarray(lab), q) for (lab, q) in run(cfg)]
    findings = check_labels(entry, by_tag)
    if findings:
        raise AssertionError("\n".join(f.format() for f in findings))
