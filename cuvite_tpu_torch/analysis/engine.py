"""graftlint engine for the port: source model, rule registry, root
tables, suppressions, baseline (port of ``cuvite_tpu/analysis/engine.py``).

The engine is self-contained (stdlib ``ast`` only: no torch, no third-party
dependency, nothing of ``cuvite_tpu``), so it runs wherever the repo does,
on the CPU, in about a second for the whole port.  It is a host-only
tool: it reads source files and never touches a device, so the port's
rule that entry points run on the card does not apply to it.

Per-file model (``SourceFile``)
-------------------------------
Each analysed file is parsed once and annotated with the facts every
rule needs:

  * a parent map (``ast`` has no parent pointers), so rules can walk
    *up* from a call site through its enclosing ``if``/``try`` blocks;
  * the function table: every ``def`` (nested included) with its
    parameters, its qualified name inside the module (``Class.method``,
    ``outer.inner``) and its module-local call edges;
  * device-path roots: the functions of :data:`DEVICE_PATH_ROOTS` that
    this file defines.  The port has no ``@jax.jit``; what the reference
    reads from jit decorators, the port names in that table: the
    functions the sweep loop calls once a sweep;
  * the device-reachable closure: the roots plus every same-module
    function transitively called from one (the reference's
    ``jit_reachable``).  Cross-module reach is tier 2's
    (``callgraph.py``).

Suppressions
------------
``# graftlint: disable=R001`` (comma-separated ids, or ``all``) on the
flagged line suppresses findings on that line only.
``# graftlint: disable-file=R003`` within the first ``FILE_PRAGMA_LINES``
lines suppresses a rule for the whole file.

Baseline
--------
A checked-in JSON file (``cuvite_tpu_torch/analysis/baseline.json``)
grandfathers findings so the gate bites only on *new* ones.  Entries are
matched as a multiset of ``(path, rule, stripped-source-line)``
fingerprints, the reference's format: one baseline file reads in both
packages.
"""

from __future__ import annotations

import ast
import collections
import dataclasses
import json
import os
import re
from typing import Iterable, Iterator

SEVERITIES = ("high", "medium", "low")

FILE_PRAGMA_LINES = 20

_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\s]+)")
_FILE_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable-file=([A-Za-z0-9_,\s]+)")

# ---------------------------------------------------------------------------
# The root tables: the one place that says where "reachable" starts.
# Each entry is (module, qualified name in the module); a class name
# stands for every method of the class.

# The functions the sweep loop calls once a sweep (``loop.phase_loop``,
# the batched ``_phase_loop``, the mesh runner): R001 and R017 flag a
# host read reachable from one of them.
DEVICE_PATH_ROOTS = (
    ("cuvite_tpu_torch.louvain.bucketed", "bucketed_step"),
    ("cuvite_tpu_torch.louvain.step", "louvain_step_local"),
    ("cuvite_tpu_torch.louvain.bucketed", "sharded_bucketed_step"),
    ("cuvite_tpu_torch.louvain.step", "sharded_step"),
    # the batched _phase_loop's per-block steps (a re-binned coarse
    # phase runs _bucketed_phase_body's)
    ("cuvite_tpu_torch.louvain.batched", "_phase_body.sweep"),
    ("cuvite_tpu_torch.louvain.batched", "_bucketed_phase_body.sweep"),
    # the fused engine's sweep
    ("cuvite_tpu_torch.louvain.fused", "fused_sweep.sweep"),
)

# The mesh entries (the reference's shard_map wraps): R023-R025 judge
# the collectives and the O(nv_total) buffers reachable from them.
MESH_ENTRIES = (
    ("cuvite_tpu_torch.louvain.driver", "MeshPhaseRunner"),
    ("cuvite_tpu_torch.louvain.bucketed", "sharded_bucketed_step"),
    ("cuvite_tpu_torch.louvain.bucketed", "sharded_bucketed_modularity"),
    ("cuvite_tpu_torch.louvain.step", "sharded_step"),
    ("cuvite_tpu_torch.louvain.loop", "phase_loop"),
    # the rank body that multihost.launch starts (--world)
    ("cuvite_tpu_torch.tools.exchange_latency", "rank_worker"),
)


def module_of(rel: str) -> str:
    """Dotted module name for a repo-relative path
    ('cuvite_tpu_torch/louvain/step.py' -> 'cuvite_tpu_torch.louvain.step';
    a package ``__init__`` collapses to the package)."""
    mod = rel[:-3] if rel.endswith(".py") else rel
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def in_table(table, module: str, qualname: str) -> bool:
    """True when (module, qualname) is an entry of ``table``, or a method
    of a class that is."""
    for mod, name in table:
        if mod != module:
            continue
        if qualname == name or qualname.startswith(name + "."):
            return True
    return False


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    severity: str
    path: str
    line: int
    message: str
    snippet: str  # stripped source line: the baseline fingerprint

    def fingerprint(self) -> tuple:
        return (self.path, self.rule, self.snippet)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{self.severity}] {self.message}")


class Rule:
    """Base class for graftlint rules.

    Subclasses set ``id`` (``R###``), ``severity`` (one of SEVERITIES),
    ``title``, and implement ``check`` yielding raw findings — the
    engine applies suppressions and the baseline afterwards.
    """

    id: str = ""
    severity: str = "medium"
    title: str = ""

    def check(self, sf: "SourceFile") -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, sf: "SourceFile", node: ast.AST,
                message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=self.id, severity=self.severity, path=sf.rel,
                       line=line, message=message, snippet=sf.line(line))


_REGISTRY: dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule (one shared instance) to the
    registry; idempotent per id so test re-imports don't duplicate."""
    inst = cls()
    if not inst.id or inst.severity not in SEVERITIES:
        raise ValueError(f"rule {cls.__name__}: bad id/severity")
    _REGISTRY[inst.id] = inst
    return cls


def all_rules() -> list:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FunctionInfo:
    name: str
    node: ast.AST                      # FunctionDef / AsyncFunctionDef
    params: list                       # positional+kw-only param names
    qualname: str = ""                 # Class.method / outer.inner
    is_root: bool = False              # in DEVICE_PATH_ROOTS
    is_mesh_entry: bool = False        # in MESH_ENTRIES
    calls: set = dataclasses.field(default_factory=set)  # local callee names
    device_reachable: bool = False


def _params_of(node) -> list:
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args]
    kwonly = [p.arg for p in a.kwonlyargs]
    return names + kwonly


class _Builder(ast.NodeVisitor):
    """Single pass collecting parents, the function table with qualified
    names, and per-function call edges."""

    def __init__(self, sf: "SourceFile"):
        self.sf = sf
        self.stack: list[FunctionInfo] = []
        self.scope: list[str] = []

    def generic_visit(self, node):
        enc = self.stack[-1] if self.stack else None
        for child in ast.iter_child_nodes(node):
            self.sf.parent_map[child] = node
            self.sf.enclosing[child] = enc
            self.visit(child)

    def visit_ClassDef(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def _visit_funcdef(self, node):
        qual = ".".join(self.scope + [node.name])
        info = FunctionInfo(name=node.name, node=node,
                            params=_params_of(node), qualname=qual)
        info.is_root = in_table(DEVICE_PATH_ROOTS, self.sf.module, qual)
        info.is_mesh_entry = in_table(MESH_ENTRIES, self.sf.module, qual)
        self.sf.functions.append(info)
        self.sf.func_by_name[node.name].append(info)
        self.sf.func_of_node[node] = info
        self.stack.append(info)
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()
        self.stack.pop()

    visit_FunctionDef = _visit_funcdef
    visit_AsyncFunctionDef = _visit_funcdef

    def visit_Call(self, node):
        if self.stack:
            if isinstance(node.func, ast.Name):
                self.stack[-1].calls.add(node.func.id)
            elif isinstance(node.func, ast.Attribute):
                self.stack[-1].calls.add(node.func.attr)
        self.generic_visit(node)


class SourceFile:
    """Parsed + annotated source file (see module docstring)."""

    def __init__(self, text: str, path: str = "<string>",
                 rel: str | None = None):
        self.path = path
        self.rel = rel if rel is not None else path
        self.module = module_of(self.rel)
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.parent_map: dict = {}
        self.enclosing: dict = {}          # node -> FunctionInfo | None
        self.functions: list[FunctionInfo] = []
        self.func_by_name: dict = collections.defaultdict(list)
        self.func_of_node: dict = {}
        _Builder(self).visit(self.tree)
        # One BFS list of every node, walked by every rule (a fresh
        # ast.walk per rule dominated the run's time).
        self.nodes = list(ast.walk(self.tree))
        self._comments = None
        self._by_func = None
        self._propagate_reachability()
        self._line_suppress, self._file_suppress = self._parse_suppressions()

    # -- construction helpers ------------------------------------------

    def _propagate_reachability(self):
        queue = [f for f in self.functions if f.is_root]
        for f in queue:
            f.device_reachable = True
        while queue:
            f = queue.pop()
            for callee in f.calls:
                for g in self.func_by_name.get(callee, ()):
                    if not g.device_reachable:
                        g.device_reachable = True
                        queue.append(g)

    def _parse_suppressions(self):
        """Pragmas are read from real COMMENT tokens, not raw line text:
        a docstring QUOTING the suppression syntax must not silently
        disable rules for the file containing it."""
        line_sup: dict = {}
        file_sup: set = set()
        for lineno, comment in self._iter_comments():
            if "graftlint" not in comment:
                continue
            m = _SUPPRESS_RE.search(comment)
            if m:
                ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
                line_sup.setdefault(lineno, set()).update(ids)
            m = _FILE_SUPPRESS_RE.search(comment)
            if m and lineno <= FILE_PRAGMA_LINES:
                file_sup |= {s.strip() for s in m.group(1).split(",")
                             if s.strip()}
        return line_sup, file_sup

    def _iter_comments(self):
        """(lineno, text) of every comment token, tokenized once.  Falls
        back to a raw line scan if tokenize rejects what ast accepted
        (losing suppressions wholesale would flip every suppressed
        intentional finding back into a gate failure)."""
        import io
        import tokenize

        if self._comments is not None:
            return self._comments
        try:
            toks = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            self._comments = [(i, raw) for i, raw
                              in enumerate(self.lines, start=1)
                              if "#" in raw]
            return self._comments
        self._comments = [(t.start[0], t.string) for t in toks
                          if t.type == tokenize.COMMENT]
        return self._comments

    # -- rule-facing API -----------------------------------------------

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, lineno: int, rule_id: str) -> bool:
        if rule_id in self._file_suppress or "all" in self._file_suppress:
            return True
        ids = self._line_suppress.get(lineno, ())
        return rule_id in ids or "all" in ids

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self.parent_map.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parent_map.get(node)
        while cur is not None:
            yield cur
            cur = self.parent_map.get(cur)

    def enclosing_function(self, node: ast.AST) -> FunctionInfo | None:
        if node in self.enclosing:
            return self.enclosing[node]
        for anc in self.ancestors(node):
            info = self.func_of_node.get(anc)
            if info is not None:
                return info
        return None

    def nodes_of(self, info: FunctionInfo) -> list:
        """Nodes lexically inside ``info``'s body but not inside a nested
        def (those belong to the nested function)."""
        if self._by_func is None:
            self._by_func = collections.defaultdict(list)
            for n in self.nodes:
                enc = self.enclosing.get(n)
                if enc is not None:
                    self._by_func[id(enc)].append(n)
        return self._by_func.get(id(info), [])

    def walk(self):
        return self.nodes


# ---------------------------------------------------------------------------
# Running


def _severity_rank(sev: str) -> int:
    return SEVERITIES.index(sev)


def run_source(text: str, path: str = "<string>", rules=None,
               rel: str | None = None, *,
               sf: "SourceFile | None" = None) -> list:
    """Lint one source string; returns suppression-filtered findings.

    The unit-test entry point: rules see exactly what they would see for
    a real file at ``rel``/``path``.  ``sf`` lets run_paths pass the
    SourceFile it already built (it needs one for the tier-2 summary)."""
    if rules is None:
        rules = all_rules()
    if sf is None:
        sf = SourceFile(text, path=path, rel=rel)
    out = []
    for rule in rules:
        for f in rule.check(sf):
            if not sf.suppressed(f.line, f.rule):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    """All .py files under the given files/directories/globs, sorted,
    deduped.  A path with glob characters (``tests/test_torch_*.py``)
    expands relative to the CWD."""
    import glob

    seen = set()
    for p in paths:
        if any(c in p for c in "*?["):
            files = sorted(f for f in glob.glob(p) if f.endswith(".py"))
        elif os.path.isfile(p):
            # An explicit non-.py argument is not linted as Python: the
            # caller gets the 'no Python files' E000 from run_paths
            # instead of a bogus syntax-error finding on a shell script.
            files = [p] if p.endswith(".py") else []
        else:
            files = []
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        for f in files:
            key = os.path.abspath(f)
            if key not in seen:
                seen.add(key)
                yield f


# Path-scoped rules and baseline fingerprints key on repo-root-relative
# paths, so rel must be anchored to the REPO ROOT, not the CWD —
# otherwise linting from one directory up would rewrite every rel to
# 'repo/cuvite_tpu_torch/...', silently disabling the scoped rules and
# unmatching the whole baseline while still printing 'ok'.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PKG_DIR = "cuvite_tpu_torch"


def _relpath(path: str, anchor: str | None = None) -> str:
    """Repo-root-relative when inside the repo; else relative to
    ``anchor`` (the parent of the scan-root argument, so an external
    '<tree>/cuvite_tpu_torch' exercises the scoped rules REGARDLESS of
    the CWD); CWD-relative as the last resort."""
    ap = os.path.abspath(path)
    for base in (_REPO_ROOT, anchor, os.getcwd()):
        if base is None:
            continue
        rel = os.path.relpath(ap, base)
        if not rel.startswith(".."):
            return rel.replace(os.sep, "/")
    return ap.replace(os.sep, "/")


def _collect_files(paths: Iterable[str]):
    """([(file, anchor)], [E000 findings for barren inputs]) — the
    shared traversal of run_paths and linted_rels, so what counts as
    'linted' cannot drift between the gate and the baseline-hygiene
    scoping built on it."""
    files, errors = [], []
    for p in paths:
        batch = list(iter_py_files([p]))
        if not batch:
            errors.append(Finding(
                rule="E000", severity="high", path=str(p), line=1,
                message="path contains no Python files (missing or "
                        "renamed? the gate would silently pass)",
                snippet=""))
        # Anchor = parent of the SCAN ROOT: for a file (or glob)
        # argument that is the file's grandparent dir, so 'lint
        # /ext/tests/test_torch_x.py' and 'lint /ext/tests' both resolve
        # rel='tests/test_torch_x.py' and hit the same scoped rules.  A
        # scan root inside a 'cuvite_tpu_torch' directory anchors above
        # it, so that the package-scoped rules see their prefix.
        globbed = any(c in p for c in "*?[")
        anchor = os.path.dirname(os.path.abspath(p))
        if globbed or os.path.isfile(p):
            anchor = os.path.dirname(anchor)
        parts = os.path.abspath(p).split(os.sep)
        if _PKG_DIR in parts[:-1]:
            last = len(parts) - 1 - parts[::-1].index(_PKG_DIR)
            anchor = os.sep.join(parts[:last]) or os.sep
        files.extend((f, anchor) for f in batch)
    return files, errors


def linted_rels(paths: Iterable[str]) -> set:
    """The repo-relative paths a run_paths(paths) call would lint — the
    scope guard for baseline hygiene: staleness and pruning must only
    ever judge entries whose file was actually (re)checked."""
    files, _errors = _collect_files(paths)
    return {_relpath(f, anchor) for f, anchor in files}


def run_paths(paths: Iterable[str], rules=None, *, project: bool = True,
              cache: str | None = None) -> list:
    """Lint every .py file under ``paths``.  Failure is CLOSED on both
    bad inputs: an unparsable file yields a high-severity E000 finding
    instead of aborting the run, and an input path with no Python files
    under it yields one too.

    ``project=True`` (default) additionally runs the project tiers
    (callgraph.py R017/R018, lockorder.py R020, meshspec.py R023-R025)
    over the whole file set.  ``cache`` names an incremental-cache JSON
    file (cache.py): per-file findings and tier-2 summaries are reused
    for files whose content hash matches, bit-identically to a cold
    run.  The cache only engages with the full default rule set — a
    narrowed ``rules`` list always lints cold."""
    from cuvite_tpu_torch.analysis import callgraph
    from cuvite_tpu_torch.analysis.cache import LintCache, content_sha

    cache_obj = LintCache(cache) if cache and rules is None else None
    if rules is None:
        rules = all_rules()
    files, findings = _collect_files(paths)
    summaries = []
    seen = set()
    for fpath, anchor in files:
        if os.path.abspath(fpath) in seen:
            continue
        seen.add(os.path.abspath(fpath))
        rel = _relpath(fpath, anchor)
        try:
            with open(fpath, encoding="utf-8") as fh:
                text = fh.read()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding(
                rule="E000", severity="high", path=rel, line=1,
                message=f"cannot read file: {e}", snippet=""))
            continue
        if cache_obj is not None:
            sha = content_sha(text)
            hit = cache_obj.get(rel, sha)
            if hit is not None:
                cached, summary = hit
                findings.extend(Finding(**d) for d in cached)
                if summary is not None:
                    summaries.append(summary)
                continue
        try:
            sf = SourceFile(text, path=fpath, rel=rel)
        except SyntaxError as e:
            findings.append(Finding(
                rule="E000", severity="high", path=rel,
                line=e.lineno or 1,
                message=f"syntax error: {e.msg}", snippet=""))
            continue
        except ValueError as e:
            # e.g. ast.parse on a null byte: not a SyntaxError, but the
            # same fail-closed answer
            findings.append(Finding(
                rule="E000", severity="high", path=rel, line=1,
                message=f"unparsable source: {e}", snippet=""))
            continue
        per_file = run_source(text, path=fpath, rules=rules, rel=rel,
                              sf=sf)
        summary = None
        if project or cache_obj is not None:
            summary = callgraph.summarize(sf)
            summaries.append(summary)
        findings.extend(per_file)
        if cache_obj is not None:
            cache_obj.put(rel, sha, per_file, summary)
    if project:
        findings.extend(callgraph.run_project(summaries, rules=rules))
    if cache_obj is not None:
        cache_obj.save()
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------------------------
# Baseline

BASELINE_VERSION = 1


def load_baseline(path: str) -> collections.Counter:
    """Baseline file -> Counter of (path, rule, snippet) fingerprints.
    A missing file is an empty baseline (first-run ergonomics)."""
    if not os.path.exists(path):
        return collections.Counter()
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path!r}: unsupported version {data.get('version')!r}")
    counter: collections.Counter = collections.Counter()
    for ent in data.get("findings", []):
        key = (ent["path"], ent["rule"], ent["snippet"])
        counter[key] += int(ent.get("count", 1))
    return counter


def _dump_baseline(path: str, counter) -> None:
    ents = [
        {"path": p, "rule": r, "snippet": s, "count": c}
        for (p, r, s), c in sorted(counter.items())
    ]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": BASELINE_VERSION, "findings": ents}, fh,
                  indent=2, sort_keys=True)
        fh.write("\n")


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    # E000 (unreadable/unparsable file) is deliberately NOT baselineable:
    # its fingerprint carries no snippet, so one grandfathered parse
    # error would match every FUTURE parse error of that path.
    _dump_baseline(path, collections.Counter(
        f.fingerprint() for f in findings if f.rule != "E000"))


def apply_baseline(findings: list, baseline: collections.Counter):
    """Split findings into (new, grandfathered) against the baseline
    multiset.  Duplicate fingerprints consume baseline slots in source
    order, so N baselined copies admit exactly N occurrences."""
    budget = collections.Counter(baseline)
    new, old = [], []
    for f in findings:
        key = f.fingerprint()
        # E000 never matches the baseline, even a hand-edited one.
        if f.rule != "E000" and budget[key] > 0:
            budget[key] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old


def stale_baseline_entries(findings: list, baseline: collections.Counter,
                           linted: set | None = None) -> list:
    """Baseline slots no CURRENT finding consumes: [(fingerprint,
    n_unmatched)].  ``linted`` (see :func:`linted_rels`) scopes the
    judgment: an entry for a file this run did NOT lint is unknown, not
    stale."""
    have = collections.Counter(
        f.fingerprint() for f in findings if f.rule != "E000")
    out = []
    for key, n in sorted(baseline.items()):
        if linted is not None and key[0] not in linted:
            continue
        extra = n - have.get(key, 0)
        if extra > 0:
            out.append((key, extra))
    return out


def prune_baseline(path: str, findings: list,
                   linted: set | None = None) -> int:
    """Rewrite the baseline at ``path`` keeping, per fingerprint, only
    as many slots as current findings consume; returns the number of
    dead slots dropped.  Entries for files outside ``linted`` are kept
    untouched."""
    baseline = load_baseline(path)
    have = collections.Counter(
        f.fingerprint() for f in findings if f.rule != "E000")
    kept: collections.Counter = collections.Counter()
    dropped = 0
    for key, n in baseline.items():
        if linted is not None and key[0] not in linted:
            kept[key] = n
            continue
        keep = min(n, have.get(key, 0))
        if keep:
            kept[key] = keep
        dropped += n - keep
    if dropped:
        _dump_baseline(path, kept)
    return dropped


def gate_failures(findings: list, min_severity: str = "high") -> list:
    """The findings that fail the gate: severity at or above
    ``min_severity`` (after baseline filtering by the caller)."""
    cut = _severity_rank(min_severity)
    return [f for f in findings if _severity_rank(f.severity) <= cut]
