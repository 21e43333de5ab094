"""Tier 6 (dynamic half) -- the width audit of the port (W001-W003; the
counterpart of ``cuvite_tpu/analysis/widthaudit.py``).

The static half (``analysis/widthcheck.py``: R026-R028) bounds index
arithmetic symbolically; this module runs the real device-path entries
under the op recorder of ``analysis/op_audit.py`` and grades what the
AST walk cannot see.  The reference traces its entries abstractly at the
Friendster and R-MAT 28 shapes; torch has no jaxpr, so an entry runs
either on ``meta`` tensors at the certification shape, where every op
gives its output dtype and shape and allocates nothing, or for real at a
reduced shape:

  * ``meta`` at the certification shape (nv_pad, ne_shard):
    ``solo_sort_step`` (``louvain_step_local``) and ``coalesce_sort``
    (``coalesced_runs_batched``, the sort engine's coalesce).  The stock
    meta cumsum builds an [n, n] mask, which overflows past n = 2^30;
    the recorder gives it its shape rule instead.
  * ``reduced``, run on the audit's device at (nv_pad, ne_shard) >> s
    with ne below 2^15, every index extent projected back by 2^s:
    ``solo_fused_phase`` and ``solo_bucketed_step`` (their phase loop
    reads the device once a sweep, which a meta tensor cannot answer;
    the bucketed plan is built on the host), ``coarsen_coalesce``
    (``device_coarsen_slab`` reads the coarse row count once).
  * ``fixed``, run for real at the entry's own class, which no workload
    scales: ``batched_execute`` (B = BATCH_MAX tenants of (4096, 16384))
    and ``coalesce_dense`` (the dense coalesce twin at (4096, 65536)).

The mode, shape and projection of every entry are in the report; none
is skipped in silence.  The graded properties:

  * **W001 -- index-carrying buffer width.**  Every integer output of an
    ``arange``/``cumsum``-class op must be wide enough for the extent it
    indexes (an int32 run-id cumsum over a 2^32-row slab wraps).  The law
    (``index_bits``) comes from ``tools/width_budget.json``.
  * **W002 -- fallbacks selected at the boundary.**  Each eligibility
    predicate is probed at its widest legal shape and one step past:
    the 31-bit pack of ``sort_edges_msd`` (one int64 packed sort at
    kbits + sbits == 31, two stable int32 sorts at 32), the 62-bit pack
    of ``sort_edges_by_vertex_comm`` (one int64 sort at 62, a raise at
    63), ``SLAB_NE_MAX`` and ``FLAT_NV_MAX`` (admitted at the ceiling,
    raising one doubling past), ``coalesce_engine``'s ``DEFAULT_MAX_NV``
    (and an out-of-range ``CUVITE_SEG_COALESCE_MAX_NV`` not lifting it),
    and ``batched_coalesce_engine``'s ``DENSE_BATCH_MAX_SLOTS``.  An
    entry at a shape past the 31-bit pack that still sorts the slab by
    ONE int32 key is also a conviction.  The reference's ``ds32_min`` law
    has no counterpart: the port sums in f64 on the device and has no
    double-single accumulator to cut over to.
  * **W003 -- audit integrity.**  A crashing entry, a manifest whose laws
    or max workload drifted from the code and the registry, an op of a
    meta entry that produced a tensor off ``meta`` (a concretized value),
    or device bytes allocated while the meta entries ran (on the card:
    ``torch.cuda.memory_allocated`` before and after, and the peak) fail
    closed.

Results are never cached.  ``python -m cuvite_tpu_torch.tools.width_audit``
is the CLI.
"""

from __future__ import annotations

import gc
import json
import os
import warnings

import numpy as np

from cuvite_tpu_torch.analysis.engine import Finding
from cuvite_tpu_torch.analysis.op_audit import env_override as _env
from cuvite_tpu_torch.analysis.widthcheck import MAX_WORKLOAD

BUDGET_VERSION = 1

DEFAULT_BUDGET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
    "width_budget.json")

# The fixed classes of the small entries (the reference's).
BATCHED_NV = 1 << 12
BATCHED_NE = 1 << 14
DENSE_NV = 1 << 12
DENSE_NE = 1 << 16

# A reduced entry runs with ne at most this (a few ms a sweep on a CPU).
REDUCED_NE = 1 << 14

# Laws of the reference that have no counterpart here, with the reason
# (listed in the manifest so the omission is on record).
DROPPED_LAWS = {
    "ds32_min": "the port sums Q and run weights in f64 on the device; "
                "there is no double-single accumulator to cut over to",
}

_INDEX_OPS = ("arange", "cumsum", "cummax", "cummin")


def _wfind(rule: str, entry: str, message: str,
           snippet: str = "") -> Finding:
    return Finding(rule=rule, severity="high", path=f"<width:{entry}>",
                   line=0, message=message, snippet=snippet)


# ---------------------------------------------------------------------------
# Workload shapes (from the registry, the one source).


def shard_plan(ne_pad: int) -> int:
    """Smallest power-of-two shard count that brings the per-shard slab
    under SLAB_NE_MAX."""
    from cuvite_tpu_torch.ops.segment import SLAB_NE_MAX

    s = 1
    while ne_pad // s > SLAB_NE_MAX:
        s *= 2
    return s


def audit_workloads() -> dict:
    """{name: {nv_pad, ne_pad, shards, ne_shard}}: Friendster and the
    R-MAT scale-28 law, from ``workloads/registry.py``."""
    from cuvite_tpu_torch.core.types import next_pow2
    from cuvite_tpu_torch.workloads import registry

    out = {}
    fr = registry.DATASETS["friendster"]
    pairs = [("friendster", fr.width_nv, fr.width_ne)]
    s_nv, s_ne = registry.rmat_scale_law(registry.RMAT_SCALE_MAX)
    pairs.append((f"rmat_s{registry.RMAT_SCALE_MAX}", s_nv, s_ne))
    for name, nv, ne in pairs:
        nv_pad, ne_pad = next_pow2(nv), next_pow2(ne)
        s = shard_plan(ne_pad)
        out[name] = {"nv_pad": nv_pad, "ne_pad": ne_pad, "shards": s,
                     "ne_shard": ne_pad // s}
    return out


# ---------------------------------------------------------------------------
# W001 and the sort facts over a recording.


def index_width_findings(rec, entry: str, index_bits: int,
                         scale: int = 1) -> list:
    """W001: every integer output of an index op must hold its extent
    times ``scale`` (a reduced entry's projection back to its
    certification shape)."""
    import torch

    out = []
    seen = set()
    for name, _where, outs, dim in rec.ops:
        if name not in _INDEX_OPS:
            continue
        for dt_name, shape, _dev in outs:
            dt = getattr(torch, dt_name.split(".")[-1])
            if dt.is_floating_point or dt == torch.bool or not shape:
                continue
            bits = torch.iinfo(dt).bits
            if bits > index_bits:
                continue
            cap = torch.iinfo(dt).max
            d = dim if isinstance(dim, int) and name != "arange" else 0
            extent = int(shape[d]) * scale
            worst = extent - 1 if name == "arange" else extent
            key = (name, dt_name, extent)
            if worst > cap and key not in seen:
                seen.add(key)
                out.append(_wfind(
                    "W001", entry,
                    f"'{entry}' makes a {dt_name} '{name}' over a "
                    f"{extent}-extent axis (max index {worst} > {cap}"
                    f"{'' if scale == 1 else f', projected x{scale}'}): "
                    "narrower than the manifest's index law "
                    f"({index_bits} bits) allows for this shape -- a "
                    "silent wrap giving wrong run ids or labels",
                    snippet=name))
    return out


def sort_facts(rec) -> list:
    """[(key dtype, key ndim, numel)] of every sort, in order: the
    observable that says which comparator was selected."""
    facts = []
    for name, _where, outs, _dim in rec.ops:
        if name not in ("sort", "argsort") or not outs:
            continue
        dt, shape, _dev = outs[0]
        n = 1
        for x in shape:
            n *= int(x)
        facts.append((dt.split(".")[-1], len(shape), n))
    return facts


def _pack31_eligible(nv_pad: int) -> bool:
    """The 31-bit pack predicate at the step's bounds (key_bound =
    nv_pad, src_bound = nv_pad + 1)."""
    kbits = max(nv_pad - 1, 1).bit_length()
    sbits = max(nv_pad, 1).bit_length()
    return kbits + sbits <= 31


# ---------------------------------------------------------------------------
# The entries: (mode, run(nv, ne, device)).


def _meta(*shape_dtypes):
    import torch

    return [torch.empty(s, dtype=d, device="meta") for s, d in shape_dtypes]


def _entry_solo_sort(nv, ne, device):
    import torch

    from cuvite_tpu_torch.louvain.step import louvain_step_local

    src, dst, w, comm, vdeg = _meta(
        (ne, torch.int32), (ne, torch.int32), (ne, torch.float32),
        (nv, torch.int32), (nv, torch.float32))
    louvain_step_local(src, dst, w, comm, vdeg, 1.0e-6)


def _entry_coalesce_sort(nv, ne, device):
    import torch

    from cuvite_tpu_torch.ops.segment import coalesced_runs_batched

    src, ckey, w = _meta((ne, torch.int32), (ne, torch.int32),
                         (ne, torch.float32))
    coalesced_runs_batched(src[None], ckey[None], w[None], nv_pad=nv,
                           engine="sort")


def _graph(nv: int, ne: int, seed: int = 7):
    """A reduced-shape graph: ne directed rows over nv vertices, a ring
    plus seeded extras (fixed structure)."""
    from cuvite_tpu_torch.core.graph import Graph

    rng = np.random.default_rng(seed)
    m = max(ne // 2 - nv, 0)
    src = np.concatenate([np.arange(nv), rng.integers(0, nv, m)])
    dst = np.concatenate([(np.arange(nv) + 1) % nv,
                          rng.integers(0, nv, m)])
    keep = src != dst
    return Graph.from_edges(nv, src[keep].astype(np.int64),
                            dst[keep].astype(np.int64))


def _entry_solo_engine(engine):
    def run(nv, ne, device):
        from cuvite_tpu_torch.louvain.driver import louvain_phases

        louvain_phases(_graph(nv, ne), engine=engine, max_phases=1,
                       device=device)
    return run


def _entry_coarsen(nv, ne, device):
    import torch

    from cuvite_tpu_torch.coarsen.device import device_coarsen_slab

    g = _graph(nv, ne)
    src = np.full(ne, nv, dtype=np.int32)
    dst = np.zeros(ne, dtype=np.int32)
    w = np.zeros(ne, dtype=np.float32)
    deg = np.diff(g.offsets)
    n = min(g.num_edges, ne)
    src[:n] = np.repeat(np.arange(g.num_vertices), deg)[:n]
    dst[:n] = g.tails[:n]
    w[:n] = g.weights[:n]
    comm = (np.arange(nv) // 4).astype(np.int32)
    t = [torch.from_numpy(a).to(device) for a in (src, dst, w, comm)]
    real = torch.ones(nv, dtype=torch.bool, device=device)
    device_coarsen_slab(*t, real, nv_pad=nv, coalesce="sort")


def _entry_batched(nv, ne, device):
    from cuvite_tpu_torch.analysis.op_audit import tiny_graphs
    from cuvite_tpu_torch.louvain.batched import cluster_many
    from cuvite_tpu_torch.workloads.registry import BATCH_MAX

    cluster_many(tiny_graphs(b=BATCH_MAX), engine="fused", max_phases=1,
                 device=device, mesh=None)


def _entry_coalesce_dense(nv, ne, device):
    import torch

    from cuvite_tpu_torch.kernels.seg_coalesce import seg_coalesce_plain

    rng = np.random.default_rng(3)
    src = torch.from_numpy(np.sort(rng.integers(0, DENSE_NV, DENSE_NE))
                           .astype(np.int32)).to(device)
    dst = torch.from_numpy(rng.integers(0, DENSE_NV, DENSE_NE)
                           .astype(np.int32)).to(device)
    w = torch.ones(DENSE_NE, dtype=torch.float32, device=device)
    seg_coalesce_plain(src[None], dst[None], w[None], nv_pad=DENSE_NV,
                       grid=DENSE_NV)


# name -> (mode, run, slab_sorts, own class): ``slab_sorts`` marks the
# entries whose slab rides the packed sort, where the one-int32-key check
# applies; a fixed entry runs at its own (nv, ne) class.
ENTRIES = {
    "solo_sort_step": ("meta", _entry_solo_sort, True, None),
    "coalesce_sort": ("meta", _entry_coalesce_sort, True, None),
    "solo_fused_phase": ("reduced", _entry_solo_engine("fused"), True,
                         None),
    "solo_bucketed_step": ("reduced", _entry_solo_engine("bucketed"),
                           False, None),
    "coarsen_coalesce": ("reduced", _entry_coarsen, True, None),
    "batched_execute": ("fixed", _entry_batched, False,
                        (BATCHED_NV, BATCHED_NE)),
    "coalesce_dense": ("fixed", _entry_coalesce_dense, False,
                       (DENSE_NV, DENSE_NE)),
}


def _reduced_shape(nv: int, ne: int) -> tuple:
    """(nv_r, ne_r, scale): the shape >> s with ne_r <= REDUCED_NE."""
    scale = 1
    while ne // scale > REDUCED_NE:
        scale *= 2
    return max(nv // scale, 16), max(ne // scale, 64), scale


# ---------------------------------------------------------------------------
# W002: boundary probes.


def boundary_probes(laws: dict) -> tuple:
    """(findings, facts) from probing every eligibility predicate at its
    widest legal shape and one step past (module note)."""
    import torch

    from cuvite_tpu_torch.analysis.op_audit import OpRecorder
    from cuvite_tpu_torch.kernels import seg_coalesce
    from cuvite_tpu_torch.ops import segment

    findings: list = []
    facts: dict = {}
    pack_bits = int(laws.get("pack_bits", 31))
    pack64 = int(laws.get("pack64_bits", 62))
    ne = 1 << 10

    def recorded(fn):
        with OpRecorder() as rec:
            fn()
        return sort_facts(rec)

    def msd(kb, sb):
        src, ckey, w = _meta((ne, torch.int32), (ne, torch.int32),
                             (ne, torch.float32))
        return recorded(lambda: segment.sort_edges_msd(
            src, ckey, w, nv_pad=1 << kb, src_bound=1 << sb))

    # The 31-bit pack: one int64 packed sort at kbits + sbits == 31, two
    # stable int32 sorts (the msd pair) one past.
    legal = msd(16, pack_bits - 16)
    facts["pack31_widest_legal"] = legal
    if [(d, n) for d, n, _ in legal] != [("int64", 1)]:
        findings.append(_wfind(
            "W002", "pack31",
            f"at kbits+sbits == {pack_bits} sort_edges_msd sorted "
            f"{legal}, not one int64 packed key: the one-pass path is "
            "lost at its own boundary"))
    past = msd(16, pack_bits - 15)
    facts["pack31_one_past"] = past
    if [(d, n) for d, n, _ in past] != [("int32", 1), ("int32", 1)]:
        findings.append(_wfind(
            "W002", "pack31",
            f"at kbits+sbits == {pack_bits + 1} sort_edges_msd sorted "
            f"{past}, not the two stable int32 passes of the msd "
            "fallback"))

    # The 62-bit pack of the single-key sort: legal at 62, raising at 63.
    def pack(kb, sb):
        src, ckey, w = _meta((ne, torch.int32), (ne, torch.int32),
                             (ne, torch.float32))
        return recorded(lambda: segment.sort_edges_by_vertex_comm(
            src, ckey, w, src_bound=1 << sb, key_bound=1 << kb))

    try:
        got = pack(31, pack64 - 31)
        facts["pack62_widest_legal"] = got
        if [(d, n) for d, n, _ in got] != [("int64", 1)]:
            findings.append(_wfind(
                "W002", "pack62",
                f"at kbits+sbits == {pack64} the packed sort sorted "
                f"{got}, not one int64 key"))
    except Exception as e:
        findings.append(_wfind(
            "W002", "pack62",
            f"sort_edges_by_vertex_comm at kbits+sbits == {pack64} "
            f"failed: {type(e).__name__}: {e} -- the widest legal pack "
            "must stay admissible"))
    try:
        pack(31, pack64 - 30)
        findings.append(_wfind(
            "W002", "pack62",
            f"sort_edges_by_vertex_comm accepted kbits+sbits == "
            f"{pack64 + 1}: the int64 key would wrap its sign bit -- the "
            "raise-guard is gone"))
    except ValueError:
        facts["pack62_one_past"] = "raised"

    # SLAB_NE_MAX: the coalesce admits the ceiling and raises past it.
    slab_max = int(laws.get("slab_ne_max", segment.SLAB_NE_MAX))

    def runs(n):
        src, ckey, w = _meta((n, torch.int32), (n, torch.int32),
                             (n, torch.float32))
        with OpRecorder():
            segment.coalesced_runs_batched(src[None], ckey[None], w[None],
                                           nv_pad=1 << 12, engine="sort")

    try:
        runs(slab_max)
        facts["slab_at_max"] = "ran"
    except Exception as e:
        findings.append(_wfind(
            "W002", "slab_ne_max",
            f"coalesced_runs_batched at ne == SLAB_NE_MAX ({slab_max}) "
            f"failed: {type(e).__name__}: {e} -- the widest legal slab "
            "must stay admissible"))
    try:
        runs(slab_max * 2)
        findings.append(_wfind(
            "W002", "slab_ne_max",
            f"coalesced_runs_batched accepted ne == {slab_max * 2} (one "
            "doubling past SLAB_NE_MAX): the raise-guard is gone"))
    except ValueError:
        facts["slab_one_past"] = "raised"

    # FLAT_NV_MAX: the dense key grid admits the ceiling, raises past it.
    flat_max = int(laws.get("flat_nv_max", seg_coalesce.FLAT_NV_MAX))

    def dense(grid):
        src, dst, w = _meta(((1, 1 << 10), torch.int32),
                            ((1, 1 << 10), torch.int32),
                            ((1, 1 << 10), torch.float32))
        with OpRecorder():
            seg_coalesce.dense_accumulate_plain(src, dst, w, grid=grid)

    try:
        dense(flat_max)
        facts["flat_at_max"] = "ran"
    except Exception as e:
        findings.append(_wfind(
            "W002", "flat_nv_max",
            f"the dense coalesce at grid == FLAT_NV_MAX ({flat_max}) "
            f"failed: {type(e).__name__}: {e}"))
    try:
        dense(flat_max * 2)
        findings.append(_wfind(
            "W002", "flat_nv_max",
            f"the dense coalesce accepted grid == {flat_max * 2}: the "
            "flat (src << kbits) | dst key grid passes 2^30 slots a "
            "tenant -- the raise-guard is gone"))
    except ValueError:
        facts["flat_one_past"] = "raised"

    # coalesce_engine's nv ceiling, which an out-of-range env knob must
    # not lift.
    cap = int(laws.get("coalesce_max_nv", seg_coalesce.DEFAULT_MAX_NV))
    with _env("CUVITE_SEG_COALESCE", None), \
            _env("CUVITE_SEG_COALESCE_MAX_NV", None):
        at = seg_coalesce.coalesce_engine(cap)
        over = seg_coalesce.coalesce_engine(cap * 2)
    with _env("CUVITE_SEG_COALESCE", None), \
            _env("CUVITE_SEG_COALESCE_MAX_NV", str(flat_max * 2)), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lifted = seg_coalesce.coalesce_engine(flat_max * 2)
    facts["coalesce"] = {"at_cap": at, "over_cap": over,
                         "env_past_flat": lifted}
    if at != "dense" or over != "sort":
        findings.append(_wfind(
            "W002", "coalesce_max_nv",
            f"coalesce_engine chose ({at!r}, {over!r}) at nv_pad = "
            f"{cap} and {cap * 2}; expected ('dense', 'sort') -- the "
            "dense engine's nv ceiling moved"))
    if lifted != "sort":
        findings.append(_wfind(
            "W002", "coalesce_max_nv",
            f"CUVITE_SEG_COALESCE_MAX_NV={flat_max * 2} sent nv_pad = "
            f"{flat_max * 2} to {lifted!r}: the knob lifted the dense "
            "engine past FLAT_NV_MAX"))

    # DENSE_BATCH_MAX_SLOTS: n_tenants * grid^2 at the cap stays dense.
    slots = int(laws.get("dense_batch_max_slots",
                         seg_coalesce.DENSE_BATCH_MAX_SLOTS))
    grid = min(cap, DENSE_NV)
    n_at = max(slots // (grid * grid), 1)
    with _env("CUVITE_SEG_COALESCE", None), \
            _env("CUVITE_SEG_COALESCE_MAX_NV", None):
        b_at = seg_coalesce.batched_coalesce_engine(grid, n_at, grid)
        b_past = seg_coalesce.batched_coalesce_engine(grid, n_at + 1, grid)
    facts["dense_batch"] = {"at_cap": b_at, "one_past": b_past}
    if b_at != "dense" or b_past != "sort":
        findings.append(_wfind(
            "W002", "dense_batch_max_slots",
            f"batched_coalesce_engine chose ({b_at!r}, {b_past!r}) at "
            f"{n_at} and {n_at + 1} tenants of grid {grid}; expected "
            "('dense', 'sort')"))
    return findings, facts


# ---------------------------------------------------------------------------
# Manifest.


def load_budget(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != BUDGET_VERSION:
        raise ValueError(f"width budget {path!r}: unsupported "
                         f"version {data.get('version')!r}")
    return data


def write_budget(path: str, doc: dict) -> None:
    out = dict(doc)
    out["version"] = BUDGET_VERSION
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(out, fh, indent=2, sort_keys=True)
        fh.write("\n")


def code_laws() -> dict:
    """The laws as the code declares them: what the manifest must match
    (W003) and what --write-budget writes."""
    from cuvite_tpu_torch.kernels.seg_coalesce import (
        DEFAULT_MAX_NV,
        DENSE_BATCH_MAX_SLOTS,
        FLAT_NV_MAX,
    )
    from cuvite_tpu_torch.ops.segment import SLAB_NE_MAX

    return {
        "index_bits": 32,
        "pack_bits": 31,
        "pack64_bits": 62,
        "slab_ne_max": SLAB_NE_MAX,
        "flat_nv_max": FLAT_NV_MAX,
        "coalesce_max_nv": DEFAULT_MAX_NV,
        "dense_batch_max_slots": DENSE_BATCH_MAX_SLOTS,
    }


def manifest_crosscheck(manifest: dict) -> list:
    """W003: the manifest must agree with the code constants and the
    registry's declared max workload."""
    from cuvite_tpu_torch.workloads import registry

    out = []
    laws = manifest.get("laws", {})
    want_laws = code_laws()
    for key in sorted(set(want_laws) | set(laws)):
        got, want = laws.get(key), want_laws.get(key)
        if got != want:
            out.append(_wfind(
                "W003", "manifest",
                f"width_budget.json law '{key}' is {got!r} but the code "
                f"declares {want!r}: the manifest drifted -- regenerate "
                "with --write-budget and review the diff"))
    declared = manifest.get("max_workload", {})
    actual = registry.max_workload()
    if declared != actual:
        out.append(_wfind(
            "W003", "manifest",
            f"manifest max_workload {declared} != registry "
            f"max_workload() {actual}"))
    if actual != MAX_WORKLOAD:
        out.append(_wfind(
            "W003", "manifest",
            f"registry.max_workload() {actual} != widthcheck."
            f"MAX_WORKLOAD {MAX_WORKLOAD}: the static and dynamic tiers "
            "certify different envelopes"))
    return out


# ---------------------------------------------------------------------------
# The audit.


class _Spy:
    """Device bytes while the meta entries run: on a card,
    ``torch.cuda.memory_allocated`` before and after and the peak
    between; elsewhere nothing to read (0)."""

    def __init__(self, device: str):
        import torch

        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"

    def __enter__(self):
        import torch

        gc.collect()
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
            self.before = torch.cuda.memory_allocated(self.dev)
        else:
            self.before = 0
        return self

    def __exit__(self, *exc):
        import torch

        gc.collect()
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            self.after = torch.cuda.memory_allocated(self.dev)
            self.peak = torch.cuda.max_memory_allocated(self.dev)
        else:
            self.after = self.peak = 0
        return False

    def report(self) -> dict:
        return {"device": str(self.dev), "baseline_bytes": self.before,
                "delta_bytes": self.after - self.before,
                "peak_over_baseline_bytes": self.peak - self.before}


def run_width_audit(entry_names=None, workloads=None,
                    budget_path: str | None = None, probes: bool = True,
                    device: str = "cpu"):
    """(findings, reports) over the certification workloads.

    ``reports``: {workload: {entry: {"mode", "nv", "ne", "scale",
    "sorts", "w001", "ops"}}} plus ``"probes"`` (the boundary facts) and
    ``"spy"`` (device bytes while the meta entries ran).  Never
    cached."""
    from cuvite_tpu_torch.analysis.op_audit import OpRecorder

    budget_path = budget_path or DEFAULT_BUDGET
    findings: list = []
    reports: dict = {}
    try:
        manifest = load_budget(budget_path)
    except (OSError, ValueError) as e:
        manifest = None
        findings.append(_wfind(
            "W003", "manifest",
            f"width budget unreadable ({e}): restore width_budget.json or "
            "regenerate it with --write-budget"))
    if manifest is not None:
        findings.extend(manifest_crosscheck(manifest))
    laws = (manifest or {}).get("laws") or code_laws()
    index_bits = int(laws.get("index_bits", 32))
    pack_bits = int(laws.get("pack_bits", 31))

    names = list(ENTRIES) if entry_names is None else list(entry_names)
    wl = audit_workloads()
    if workloads is not None:
        wl = {k: v for k, v in wl.items() if k in set(workloads)}

    def one(name, nv, ne, wname):
        mode, run, slab_sorts, own = ENTRIES[name]
        scale = 1
        if mode == "reduced":
            nv, ne, scale = _reduced_shape(nv, ne)
        elif own is not None:
            nv, ne = own
        try:
            with OpRecorder() as rec:
                run(nv, ne, device)
        except Exception as e:  # fail closed: a crash is a finding
            findings.append(_wfind(
                "W003", name,
                f"entry '{name}' failed at workload '{wname}' ({mode}, "
                f"nv={nv}, ne={ne}): {type(e).__name__}: {e}"))
            return None
        w001 = index_width_findings(rec, name, index_bits, scale)
        findings.extend(w001)
        sorts = sort_facts(rec)
        if mode == "meta":
            off = sorted({dev for _n, _w, outs, _d in rec.ops
                          for _dt, _s, dev in outs if dev != "meta"})
            if off:
                findings.append(_wfind(
                    "W003", name,
                    f"meta entry '{name}' produced tensors on {off}: some "
                    "op concretized a value instead of running "
                    "abstractly"))
        true_nv = nv * scale
        if slab_sorts and not _pack31_eligible(true_nv) and mode == "meta" \
                and any(dt == "int32" and nd == 1 and n >= ne
                        for dt, nd, n in sorts):
            findings.append(_wfind(
                "W002", name,
                f"'{name}' at '{wname}' (nv_pad={true_nv}: kbits+sbits > "
                f"{pack_bits}) sorted the slab by one int32 key "
                f"({sorts}): packed keys wrap the sign bit"))
        return {"mode": mode, "nv": nv, "ne": ne, "scale": scale,
                "sorts": sorts, "w001": len(w001), "ops": len(rec.ops)}

    meta_names = [n for n in names if ENTRIES[n][0] == "meta"]
    other = [n for n in names if ENTRIES[n][0] != "meta"]
    with _Spy(device) as spy:
        for wname, shapes in sorted(wl.items()):
            per = reports.setdefault(wname, {})
            for name in meta_names:
                got = one(name, shapes["nv_pad"], shapes["ne_shard"], wname)
                if got is not None:
                    per[name] = got
    for wname, shapes in sorted(wl.items()):
        per = reports.setdefault(wname, {})
        for name in other:
            if ENTRIES[name][0] == "fixed" and wname != min(wl):
                per[name] = dict(reports[min(wl)].get(name, {}),
                                 same_as=min(wl))
                continue      # one class, whatever the workload
            got = one(name, shapes["nv_pad"], shapes["ne_shard"], wname)
            if got is not None:
                per[name] = got

    if probes:
        probe_findings, probe_facts = boundary_probes(laws)
        findings.extend(probe_findings)
        reports["probes"] = probe_facts

    reports["spy"] = spy.report()
    if spy.after != spy.before or spy.peak != spy.before:
        findings.append(_wfind(
            "W003", "alloc_spy",
            f"the meta entries allocated device bytes ({spy.report()}): "
            "the certification is only honest at zero -- some op left "
            "the meta device"))
    return findings, reports
