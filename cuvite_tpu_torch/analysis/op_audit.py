"""Tier 3 of the port -- the op and compile-budget audit (the counterpart
of ``cuvite_tpu/analysis/jaxpr_audit.py``).

The reference inspects the jaxprs its source builds.  The port builds no
program: its sweeps are eager PyTorch ops around hand-written kernels.
This tier therefore watches the ops as they run, under a
``TorchDispatchMode`` (:class:`OpRecorder`) that sees every aten op with
its inputs and outputs, and knows where the sweep is through
``sys.monitoring`` events on the code objects of the sweep roots
(:data:`~cuvite_tpu_torch.analysis.engine.DEVICE_PATH_ROOTS`) and of the
phase loops (:data:`LOOP_FUNCS`), so every op and host read is placed
inside a sweep, between sweeps of a phase loop, or outside both.

  * **J001 -- 64-bit ops in a sweep.**  The port sums Q in f64 and packs
    sort keys in int64 by design, so J001 is not "no 64-bit op": each
    entry's manifest lists the sanctioned ``op:dtype`` pairs of 64-bit
    outputs inside its sweeps (``allow64``), and any other is a finding.
  * **J002 -- host reads a sweep.**  A host read inside a sweep root is
    a finding (the sweep only enqueues), and so are more reads between
    the sweeps of a phase loop than the manifest's ``reads_per_sweep``
    (``phase_loop`` reads Q and the moved count once a sweep).  Reads are
    ``aten._local_scalar_dense`` (``.item()``, ``int()``, ``float()``,
    ``bool()`` of a tensor), copies from the card to the host, and
    ``.tolist()``/``.numpy()`` of a CPU tensor (which dispatch no op: the
    recorder wraps the two methods while it is active).
  * **J003 -- host-to-device copies in the sweep loop**: ``_to_copy`` /
    ``copy_`` from the host to another device, and tensors made from
    host data (``lift_fresh``: ``torch.tensor``, ``torch.from_numpy``):
    any inside a sweep root, or more between the sweeps of a loop than
    the manifest's ``uploads_per_sweep`` (0 unless listed: the batched
    loop uploads each block's [b] advance mask once a sweep, the
    decision it takes on the host from its one read).

The compile budget (B001-B003) runs each entry twice under the port's
:class:`~cuvite_tpu_torch.obs.compile_watch.CompileWatcher` -- same slab
class, B and engine, other weights -- and grades its builds (``nvcc``,
``g++``), library loads and new kernel forms (bodies first launched in
the window) against the closed manifest
(``cuvite_tpu_torch/tools/compile_budget.json``, one section a platform):
B001 a build, load or form that matches nothing in the manifest, B002
the second run built, loaded or first-launched anything (content
reached a build key), B003 the first run's count over the entry's
budget.  The audit also counts each kernel's launches a sweep
(``kernels.launch_counts``), the counts the smoke prints a path.

Finding ids here (J*, B*) are outside the R-rule registry: they anchor
on entries (``<ops:ENTRY>``, ``<compile:ENTRY>``), not source lines.
torch is imported lazily: ``python -m cuvite_tpu_torch.analysis`` never
loads this module.  ``python -m cuvite_tpu_torch.tools.compile_audit``
is the CLI.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import sys
import types

import numpy as np

from cuvite_tpu_torch.analysis.engine import DEVICE_PATH_ROOTS, Finding

MANIFEST_VERSION = 1

# The phase loops: host reads between their sweeps are the budgeted ones.
LOOP_FUNCS = (
    ("cuvite_tpu_torch.louvain.loop", "phase_loop"),
    ("cuvite_tpu_torch.louvain.batched", "_phase_loop"),
)

WIDE_DTYPES = ("torch.int64", "torch.float64", "torch.uint64",
               "torch.complex128")

# Ops whose integer outputs carry indices of their operated extent.
INDEX_OPS = ("arange", "cumsum", "cummax", "cummin")


@contextlib.contextmanager
def env_override(name: str, value: str | None):
    """``os.environ[name]`` set to ``value`` (None: unset) while active,
    restored after (the audits' probes of the env knobs)."""
    prior = os.environ.get(name)
    try:
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
        yield
    finally:
        if prior is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prior


# ---------------------------------------------------------------------------
# Where the sweep is: sys.monitoring on the roots' code objects.


def _code_of(module: str, qualname: str):
    """The code object of ``qualname`` in ``module``; a dotted name walks
    classes by attribute and nested functions through ``co_consts``
    (``fused_sweep.sweep``: the closure a call of fused_sweep returns)."""
    obj = importlib.import_module(module)
    code = None
    for part in qualname.split("."):
        if code is not None:
            code = next((c for c in code.co_consts
                         if isinstance(c, types.CodeType)
                         and c.co_name == part), None)
            if code is None:
                raise LookupError(f"{module}.{qualname}: no nested {part}")
            continue
        obj = getattr(obj, part)
        fn = getattr(obj, "__func__", obj)
        if isinstance(fn, types.FunctionType):
            code = fn.__code__
    if code is None:
        raise LookupError(f"{module}.{qualname} is not a function")
    return code


class RootWatch:
    """Tracks whether the running code is inside a sweep root or a phase
    loop, and counts the outermost sweep-root calls (the sweeps), with
    ``sys.monitoring`` PY_START/PY_RETURN events on those code objects
    only (no cost elsewhere).  A context manager; one at a time."""

    def __init__(self, roots=DEVICE_PATH_ROOTS, loops=LOOP_FUNCS,
                 on_sweep=None):
        self.root_codes = {_code_of(m, q) for m, q in roots}
        self.loop_codes = {_code_of(m, q) for m, q in loops}
        self.in_root = 0
        self.in_loop = 0
        self.sweeps = 0
        self.on_sweep = on_sweep
        self._tool = None

    def where(self) -> str:
        if self.in_root:
            return "sweep"
        return "loop" if self.in_loop else "outside"

    def _start(self, code, offset):
        if code in self.root_codes:
            if not self.in_root:
                self.sweeps += 1
                if self.on_sweep is not None:
                    self.on_sweep(self.sweeps)
            self.in_root += 1
        elif code in self.loop_codes:
            self.in_loop += 1

    def _return(self, code, offset, retval):
        if code in self.root_codes:
            self.in_root = max(self.in_root - 1, 0)
        elif code in self.loop_codes:
            self.in_loop = max(self.in_loop - 1, 0)

    def __enter__(self) -> "RootWatch":
        mon = sys.monitoring
        self._tool = next(t for t in (2, 3, 4)
                          if mon.get_tool(t) is None)
        mon.use_tool_id(self._tool, "cuvite_op_audit")
        ev = mon.events.PY_START | mon.events.PY_RETURN
        mon.register_callback(self._tool, mon.events.PY_START, self._start)
        mon.register_callback(self._tool, mon.events.PY_RETURN,
                              self._return)
        for code in self.root_codes | self.loop_codes:
            mon.set_local_events(self._tool, code, ev)
        return self

    def __exit__(self, *exc) -> bool:
        mon = sys.monitoring
        for code in self.root_codes | self.loop_codes:
            mon.set_local_events(self._tool, code, 0)
        mon.register_callback(self._tool, mon.events.PY_START, None)
        mon.register_callback(self._tool, mon.events.PY_RETURN, None)
        mon.free_tool_id(self._tool)
        return False


# ---------------------------------------------------------------------------
# Every aten op, with its dtypes, shapes and place.


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _make_recorder():
    """The :class:`OpRecorder` class (built on first use: the dispatch
    mode base class lives in torch)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class _OpRecorder(TorchDispatchMode):
        """Records every aten op: name, where (sweep/loop/outside), output
        dtypes and shapes; host reads and host-to-device copies apart.
        On ``meta`` tensors it gives cumsum a shape rule (the stock meta
        kernel builds an [n, n] mask, which overflows past n = 2^30)."""

        def __init__(self, watch: RootWatch | None = None):
            super().__init__()
            self.watch = watch
            self.ops: list = []    # (name, where, [(dtype, shape, dev)], dim)
            self.reads: list = []      # (where, what)
            self.uploads: list = []    # (where, what)
            # id of a tensor made from host data -> its uploads entry: its
            # copy to a device is the same upload, not a second one.
            self._lifted: dict = {}

        def __enter__(self):
            # .tolist() and .numpy() of a CPU tensor dispatch no op: they
            # are counted here (on another device their copy to the host
            # is seen by the dispatch below).
            rec = self
            self._saved = (torch.Tensor.tolist, torch.Tensor.numpy)
            tolist, numpy_ = self._saved

            def counted(orig, what):
                def read(t, *a, **k):
                    if t.device.type == "cpu":
                        rec.reads.append((rec._where(), what))
                    return orig(t, *a, **k)
                return read

            torch.Tensor.tolist = counted(tolist, "tolist")
            torch.Tensor.numpy = counted(numpy_, "numpy")
            return super().__enter__()

        def __exit__(self, *exc):
            torch.Tensor.tolist, torch.Tensor.numpy = self._saved
            return super().__exit__(*exc)

        def _where(self) -> str:
            return self.watch.where() if self.watch is not None \
                else "outside"

        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            where = self._where()
            if func is aten.cumsum.default and args \
                    and args[0].device.type == "meta":
                x = args[0]
                probe = func(torch.empty(1, dtype=x.dtype, device="meta"),
                             0, **{k: v for k, v in kwargs.items()
                                   if k == "dtype"})
                out = torch.empty(x.shape, dtype=probe.dtype,
                                  device="meta")
            else:
                out = func(*args, **kwargs)
            if name == "_local_scalar_dense":
                self.reads.append((where, "item"))
            elif name in ("_to_copy", "copy_"):
                src = next(_tensors(args[1] if name == "copy_"
                                    else args[0]), None)
                dst = next(_tensors(out), None)
                if src is not None and dst is not None \
                        and src.device != dst.device:
                    if dst.device.type == "cpu":
                        self.reads.append((where, f"copy {src.device}"))
                    elif src.device.type == "cpu":
                        what = (where, f"copy to {dst.device}")
                        k = self._lifted.pop(id(src), None)
                        if k is None:
                            self.uploads.append(what)
                        else:
                            self.uploads[k] = what
            elif name == "lift_fresh":
                self._lifted[id(out)] = len(self.uploads)
                self.uploads.append((where, "tensor from host data"))
            outs = [(str(t.dtype), tuple(t.shape), t.device.type)
                    for t in _tensors(out)]
            dim = args[1] if name in INDEX_OPS[1:] and len(args) > 1 \
                else kwargs.get("dim", 0)
            self.ops.append((name, where, outs, dim))
            return out

    return _OpRecorder


_RECORDER_CLS = None


def OpRecorder(watch: RootWatch | None = None):
    """A dispatch mode recording every aten op (see the class note)."""
    global _RECORDER_CLS
    if _RECORDER_CLS is None:
        _RECORDER_CLS = _make_recorder()
    return _RECORDER_CLS(watch)


# ---------------------------------------------------------------------------
# J001-J003 over one entry's recording.


def _ofind(rule: str, entry: str, message: str, snippet: str = "") -> Finding:
    return Finding(rule=rule, severity="high", path=f"<ops:{entry}>",
                   line=0, message=message, snippet=snippet)


def wide_ops(rec) -> list:
    """Sorted ``op:dtype`` pairs of 64-bit outputs inside the sweeps."""
    out = set()
    for name, where, outs, _dim in rec.ops:
        if where != "sweep":
            continue
        for dt, _shape, _dev in outs:
            if dt in WIDE_DTYPES:
                out.add(f"{name}:{dt.split('.')[-1]}")
    return sorted(out)


def lint_ops(rec, sweeps: int, entry: str, manifest_entry: dict | None
             ) -> list:
    """J001/J002/J003 findings of one recorded entry (``sweeps``: the
    outermost sweep-root calls it made)."""
    m = manifest_entry or {}
    findings = []
    allow = set(m.get("allow64", ()))
    for pair in wide_ops(rec):
        if pair not in allow:
            findings.append(_ofind(
                "J001", entry,
                f"64-bit output '{pair}' inside a sweep of '{entry}' is "
                "not in the entry's sanctioned list (allow64 of the "
                "compile budget): the sweep is int32/f32 by contract "
                "except Q's f64 sums and the int64 sort keys; widen "
                "deliberately (--write-manifest, review the diff) or "
                "keep the op narrow", snippet=pair))
    in_sweep = [what for where, what in rec.reads if where == "sweep"]
    if in_sweep:
        findings.append(_ofind(
            "J002", entry,
            f"'{entry}' reads the device {len(in_sweep)} time(s) inside "
            f"its sweep roots ({sorted(set(in_sweep))}): a sweep only "
            "enqueues work; the phase loop reads once a sweep",
            snippet=in_sweep[0]))
    in_loop = sum(1 for where, _w in rec.reads if where == "loop")
    budget = m.get("reads_per_sweep", 1)
    if sweeps and in_loop > budget * sweeps:
        findings.append(_ofind(
            "J002", entry,
            f"'{entry}' read the device {in_loop} time(s) between the "
            f"sweeps of its phase loops over {sweeps} sweep(s): over "
            f"the budget of {budget} a sweep",
            snippet=f"{in_loop}/{sweeps}"))
    up_sweep = [what for where, what in rec.uploads if where == "sweep"]
    up_loop = [what for where, what in rec.uploads if where == "loop"]
    up_budget = m.get("uploads_per_sweep", 0)
    if up_sweep or len(up_loop) > up_budget * sweeps:
        up = up_sweep + up_loop
        findings.append(_ofind(
            "J003", entry,
            f"'{entry}' copies host data to the device {len(up)} "
            f"time(s) inside its sweep loop ({len(up_sweep)} inside its "
            f"sweep roots; {sorted(set(up))}) over {sweeps} sweep(s), "
            f"past the budget of {up_budget} a sweep between sweeps and "
            "none inside one: placement belongs to the driver's upload "
            "before the loop", snippet=up[0]))
    return findings


# ---------------------------------------------------------------------------
# The representative serving-class workload (host-side, deterministic).


def tiny_graphs(b: int = 2, nv: int = 256, ne: int = 1024,
                content_seed: int = 1) -> list:
    """``b`` same-structure graphs at the representative small slab class
    (everything below the floors pads to (4096, 16384)); only the
    weights vary with ``content_seed`` -- the batch content the compile
    budget keeps out of every build key (the reference's
    ``tiny_graphs``, same arrays)."""
    from cuvite_tpu_torch.core.graph import Graph

    rng = np.random.default_rng(12345)  # structure: seed-independent
    graphs = []
    for j in range(b):
        src = np.concatenate([np.arange(nv), rng.integers(0, nv, ne - nv)])
        dst = np.concatenate([(np.arange(nv) + 1) % nv,
                              rng.integers(0, nv, ne - nv)])
        keep = src != dst
        wrng = np.random.default_rng(100_000 * (j + 1) + content_seed)
        w = wrng.uniform(0.5, 2.0, int(keep.sum()))
        graphs.append(Graph.from_edges(
            nv, src[keep].astype(np.int64), dst[keep].astype(np.int64),
            weights=w))
    return graphs


# ---------------------------------------------------------------------------
# The compile budget.


@dataclasses.dataclass
class AuditResult:
    """One entry's audit: what the first run built, loaded and first
    launched, what the content-changed run did, its ops findings, host
    reads and launches a sweep."""

    entry: str
    observed: list          # builds/loads/forms of the first run
    recompiled: list        # those of the content-changed run
    findings: list          # B*/J* Finding objects
    sweeps: int = 0
    reads: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    allow64: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def launches_per_sweep(self) -> dict:
        return {k: round(v / self.sweeps, 3) if self.sweeps else v
                for k, v in self.launches.items()}

    def to_dict(self) -> dict:
        return {"entry": self.entry, "observed": self.observed,
                "recompiled": self.recompiled, "sweeps": self.sweeps,
                "reads": self.reads, "launches": self.launches,
                "launches_per_sweep": self.launches_per_sweep(),
                "allow64": self.allow64,
                "findings": [f.to_dict() for f in self.findings]}


def observed_modules(watcher) -> list:
    """What a CompileWatcher saw: ``build X`` / ``load X`` per event (the
    library's name without its content hash) and ``form K:B`` per kernel
    body first launched in the window."""
    out = []
    for ev in watcher.events:
        mod = str(ev["module"]).rsplit("/", 1)[-1]
        stem = mod.split("-")[0] if "-" in mod else mod
        out.append(f"{ev['kind']} {stem}")
    for form in watcher.new_forms:
        kernel, body = form[0], form[1]
        out.append(f"form {kernel}:{body}")
    return out


def _match(module: str, patterns) -> bool:
    return any(p == "*" or p in module for p in patterns)


def audit_entry(entry: str, run, manifest_entry: dict | None,
                seeds=(1, 2), extra_patterns=()) -> AuditResult:
    """Run ``run(content_seed)`` twice under the compile watcher, the
    first time also under the op recorder and the root watch, and grade
    it (see the module note; ``manifest_entry`` None: the entry is
    missing from the manifest, which fails closed).  ``extra_patterns``
    widens B001's match set to the union of every entry's patterns: which
    entry a shared library's first load lands on depends on the order."""
    from cuvite_tpu_torch import kernels
    from cuvite_tpu_torch.obs.compile_watch import CompileWatcher

    watch = RootWatch()
    kernels.zero_launch_counts()
    with CompileWatcher() as w1, watch, OpRecorder(watch) as rec:
        run(seeds[0])
    launches = kernels.launch_counts()
    with CompileWatcher() as w2:
        run(seeds[1])
    observed = observed_modules(w1)
    recompiled = observed_modules(w2)
    sweeps = watch.sweeps
    reads = {w: sum(1 for where, _ in rec.reads if where == w)
             for w in ("sweep", "loop", "outside")}
    reads["uploads_in_loop"] = sum(1 for where, _ in rec.uploads
                                   if where in ("sweep", "loop"))
    res = AuditResult(entry, observed, recompiled, [], sweeps=sweeps,
                      reads=reads,
                      launches={k: v for k, v in sorted(launches.items())
                                if v},
                      allow64=wide_ops(rec))
    if manifest_entry is None:
        res.findings.append(Finding(
            rule="B001", severity="high", path=f"<compile:{entry}>",
            line=0, snippet="",
            message=f"entry '{entry}' is not in the compile-budget "
                    "manifest: the expected build set is CLOSED -- add "
                    "the entry deliberately with --write-manifest"))
        return res
    res.findings += lint_ops(rec, sweeps, entry, manifest_entry)
    patterns = list(manifest_entry.get("modules", [])) \
        + list(extra_patterns)
    for mod in observed:
        if not _match(mod, patterns):
            res.findings.append(Finding(
                rule="B001", severity="high", path=f"<compile:{entry}>",
                line=0, snippet=mod,
                message=f"'{entry}' did '{mod}', which matches nothing in "
                        "the manifest: a new build, library or kernel "
                        "form appeared on the serving path -- extend the "
                        "manifest deliberately (--write-manifest) or find "
                        "what stopped reusing its build"))
    if manifest_entry.get("content_independent", True) and recompiled:
        res.findings.append(Finding(
            rule="B002", severity="high", path=f"<compile:{entry}>",
            line=0, snippet=", ".join(sorted(set(recompiled))[:4]),
            message=f"'{entry}' built, loaded or first launched "
                    f"{len(recompiled)} thing(s) when only batch CONTENT "
                    "changed (same class, B, engine): content has "
                    "entered a build key"))
    max_c = manifest_entry.get("max_compiles")
    if max_c is not None and len(observed) > max_c:
        res.findings.append(Finding(
            rule="B003", severity="high", path=f"<compile:{entry}>",
            line=0, snippet=str(len(observed)),
            message=f"'{entry}' built, loaded or first launched "
                    f"{len(observed)} things, over the manifest budget of "
                    f"{max_c}"))
    return res


def load_manifest(path: str, platform: str) -> dict:
    """The manifest section of ``platform`` ("cpu" or "cuda"):
    {"env": ..., "entries": ...}; a missing section raises ValueError."""
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != MANIFEST_VERSION:
        raise ValueError(f"compile budget manifest {path!r}: unsupported "
                         f"version {data.get('version')!r}")
    sec = data.get("platforms", {}).get(platform)
    if sec is None:
        raise ValueError(f"compile budget manifest {path!r} has no "
                         f"'{platform}' section")
    return sec


def write_manifest(path: str, platform: str, entries: dict,
                   env: dict) -> None:
    """Write (or replace) the ``platform`` section, keeping the others."""
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        data = {}
    data = {"version": MANIFEST_VERSION,
            "platforms": dict(data.get("platforms", {}))}
    data["platforms"][platform] = {"env": env, "entries": entries}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.write("\n")
