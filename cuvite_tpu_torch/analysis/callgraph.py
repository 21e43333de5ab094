"""Tier 2 — cross-module device-path reachability (R017/R018), port of
``cuvite_tpu/analysis/callgraph.py``.

The per-file engine stops at module boundaries: its device-reachable
closure links calls by bare name within one file.  This module closes
that hole with a *project-wide* pass:

  1. every linted file is reduced to a :func:`summarize` dict — imports,
     functions, their resolved callee names, the root flags
     (``engine.DEVICE_PATH_ROOTS``, ``engine.MESH_ENTRIES``), and the
     host-read / device-pull call sites the cross-module rules may need
     to anchor findings on.  Summaries are plain JSON (they ride the
     incremental lint cache, cache.py), so the whole-program pass never
     needs the ASTs of unchanged files;
  2. :class:`Project` links the summaries into one call graph.  Edges
     are followed only where they can be PROVEN: an import-resolved
     dotted call (``seg.segment_sum(...)`` under ``from
     cuvite_tpu_torch.ops import segment as seg``) crosses modules, a
     bare name links within its module.  Unresolvable receivers
     (``self.x()``, call results) fall back to the bare-name link —
     bounded, never global;
  3. reach propagates from the device-path roots (the functions the
     sweep loop calls once a sweep: the port has no ``jax.jit``, so the
     table in engine.py says where the device path starts);
  4. R017 re-runs the host-read check (R001's call set, minus the
     ``float/int/bool`` casts) against the TRANSITIVE closure: a helper
     calling ``.item()`` two modules away from a sweep step is a high
     finding, with the reach chain spelled out in the message.  R018
     re-runs the device-pull check (R010's call set) against
     reachability from the phase-transition modules (``louvain/``,
     ``coarsen/``): a pull that R010 cannot see because the helper lives
     elsewhere is flagged at its true call site.

Findings anchor on real (path, line, snippet) triples, so baselining and
inline ``# graftlint: disable=R017`` suppressions work exactly as they
do for per-file rules.
"""

from __future__ import annotations

import ast
import collections

from cuvite_tpu_torch.analysis.engine import (
    Finding,
    Rule,
    SourceFile,
    dotted,
    module_of,
    register,
)
from cuvite_tpu_torch.analysis.rules import (
    PHASE_TRANSITION_PREFIXES,
    host_pull_label,
    host_sync_label,
)

SUMMARY_VERSION = 1


def _classify_call(node: ast.Call):
    """(sync_label, pull_label) for one call node — the R001 host-read
    and R010 device-pull classifications, shared (minus the casts: across
    modules most reached helpers cast host values, ``int(nv_pad)``) so
    tier 2 cannot drift from the per-file rules."""
    return host_sync_label(node, casts=False), host_pull_label(node)


def summarize(sf: SourceFile) -> dict:
    """The JSON-serializable cross-module facts of one file (see module
    docstring).  Everything the project tiers read comes from here — the
    ASTs of cache-hit files are never rebuilt."""
    imports: dict = {}       # local alias -> full module name
    from_imports: dict = {}  # local name -> [module, symbol]
    mod = sf.module
    pkg_parts = mod.split(".")
    if not sf.rel.endswith("__init__.py"):
        pkg_parts = pkg_parts[:-1]
    for node in sf.walk():
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    imports[a.asname] = a.name
                else:
                    # `import a.b.c` binds the TOP package; the dotted
                    # call path supplies the rest.
                    head = a.name.split(".")[0]
                    imports[head] = head
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                src = ".".join(base + ([node.module] if node.module else []))
            else:
                src = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                from_imports[a.asname or a.name] = [src, a.name]

    funcs = []
    # Group call facts by enclosing FunctionInfo in ONE walk.
    per_func: dict = collections.defaultdict(
        lambda: {"calls": set(), "sync": [], "pull": []})
    for node in sf.walk():
        if not isinstance(node, ast.Call):
            continue
        info = sf.enclosing_function(node)
        if info is None:
            continue
        facts = per_func[id(info)]
        name = dotted(node.func)
        if name:
            facts["calls"].add(name)
        elif isinstance(node.func, ast.Attribute):
            facts["calls"].add(node.func.attr)
        sync, pull = _classify_call(node)
        line = getattr(node, "lineno", 1)
        if sync:
            facts["sync"].append(
                {"label": sync, "line": line, "snippet": sf.line(line)})
        if pull:
            facts["pull"].append(
                {"label": pull, "line": line, "snippet": sf.line(line)})
    for info in sf.functions:
        facts = per_func.get(id(info), {"calls": set(), "sync": [],
                                        "pull": []})
        funcs.append({
            "name": info.name,
            "qualname": info.qualname,
            "line": getattr(info.node, "lineno", 1),
            "entry": bool(info.is_root),
            "mesh_entry": bool(info.is_mesh_entry),
            "local_reachable": bool(info.device_reachable),
            "calls": sorted(facts["calls"]),
            "sync_sites": facts["sync"],
            "pull_sites": facts["pull"],
        })
    # The lock and mesh facts ride the same summary (and therefore the
    # same incremental-cache entry).  Lazy import: both modules subclass
    # ProjectRule from THIS module.
    from cuvite_tpu_torch.analysis import lockorder, meshspec

    return {
        "version": SUMMARY_VERSION,
        "rel": sf.rel,
        "module": mod,
        "imports": imports,
        "from_imports": from_imports,
        "functions": funcs,
        "locks": lockorder.lock_summary(sf),
        "mesh": meshspec.mesh_summary(sf),
        "suppress": {str(ln): sorted(ids)
                     for ln, ids in sf._line_suppress.items()},
        "file_suppress": sorted(sf._file_suppress),
    }


class Project:
    """The linked whole-program view over a set of file summaries.
    Functions are keyed by (module, qualified name), so that two classes'
    same-named methods (``PhaseRunner.step`` and ``MeshPhaseRunner.step``)
    stay apart; a bare-name call still links every same-named function
    of its module (the per-file closure's semantics), while ``self.m()``
    inside a method of class C links ``C.m`` alone when C defines it."""

    def __init__(self, summaries):
        self.summaries = [s for s in summaries
                          if s and s.get("version") == SUMMARY_VERSION]
        self.by_module: dict = {}
        for s in self.summaries:
            self.by_module[s["module"]] = s
        self.funcs: dict = collections.defaultdict(list)
        self.by_name: dict = collections.defaultdict(list)
        for s in self.summaries:
            for fn in s["functions"]:
                key = (s["module"], fn["qualname"])
                if key not in self.funcs:
                    self.by_name[(s["module"], fn["name"])].append(key)
                self.funcs[key].append(fn)
        self._edges_cache: dict = {}

    # -- linking -------------------------------------------------------

    def _named(self, module: str, name: str) -> list:
        """Keys of the functions called ``name`` in ``module``: the
        module-level one when it exists, else every same-named def."""
        keys = self.by_name.get((module, name), [])
        top = [k for k in keys if k[1] == name]
        return top or list(keys)

    def _resolve(self, summary: dict, callee: str,
                 caller: str | None = None) -> list:
        """One raw callee name -> the list of (module, qualname) keys it
        can denote.  Dotted names resolve through the module's imports;
        ``self.m`` through the caller's class; anything unresolved
        degrades to a bare-name link within the module."""
        parts = callee.split(".")
        mod = summary["module"]
        if len(parts) > 1:
            head, last = parts[0], parts[-1]
            if head == "self" and caller and "." in caller \
                    and len(parts) == 2:
                cls = caller.split(".")[0]
                if (mod, f"{cls}.{last}") in self.funcs:
                    return [(mod, f"{cls}.{last}")]
            tgt = None
            if head in summary["imports"]:
                tgt = ".".join([summary["imports"][head]] + parts[1:-1])
            elif head in summary["from_imports"]:
                m, sym = summary["from_imports"][head]
                tgt = ".".join([m, sym] + parts[1:-1])
            if tgt is not None and tgt in self.by_module:
                hit = self._named(tgt, last)
                if hit:
                    return hit
            return self._named(mod, last)
        if callee in summary["from_imports"]:
            m, sym = summary["from_imports"][callee]
            # `from pkg import mod` binds a submodule, not a symbol.
            if ".".join([m, sym]) in self.by_module:
                return []
            if (m, sym) in self.funcs:
                return [(m, sym)]
            # Symbol re-exported through a package __init__: one-hop
            # follow of ITS from-imports.
            pkg = self.by_module.get(m)
            if pkg and sym in pkg["from_imports"]:
                m2, sym2 = pkg["from_imports"][sym]
                if (m2, sym2) in self.funcs:
                    return [(m2, sym2)]
            return []
        return self._named(mod, callee)

    def _edges_of(self, module: str, fn: dict) -> list:
        key = (module, fn["qualname"], fn["line"])
        hit = self._edges_cache.get(key)
        if hit is not None:
            return hit
        summary = self.by_module[module]
        out = []
        for callee in fn["calls"]:
            out.extend(self._resolve(summary, callee, fn["qualname"]))
        self._edges_cache[key] = out
        return out

    def _reach(self, seed_keys) -> dict:
        """BFS over the call graph; returns {(module, qualname): pred-key}
        (seeds map to None) for chain reconstruction."""
        pred: dict = {}
        queue = collections.deque()
        for k in seed_keys:
            if k in self.funcs and k not in pred:
                pred[k] = None
                queue.append(k)
        while queue:
            cur = queue.popleft()
            for fn in self.funcs[cur]:
                for tgt in self._edges_of(cur[0], fn):
                    if tgt not in pred:
                        pred[tgt] = cur
                        queue.append(tgt)
        return pred

    def chain(self, pred: dict, key) -> str:
        parts = []
        seen = set()
        while key is not None and key not in seen:
            seen.add(key)
            mod, name = key
            rel = self.by_module[mod]["rel"]
            parts.append(f"{rel}::{name}")
            key = pred.get(key)
        return " <- ".join(parts)

    # -- rule-facing helpers -------------------------------------------

    def roots(self, flag: str = "entry") -> list:
        """(module, qualname) of every function whose summary carries
        ``flag`` (``entry``: a device-path root; ``mesh_entry``: a mesh
        entry)."""
        return [(s["module"], fn["qualname"]) for s in self.summaries
                for fn in s["functions"] if fn.get(flag)]

    def device_reach(self) -> dict:
        return self._reach(self.roots("entry"))

    def phase_transition_reach(self) -> dict:
        seeds = [(s["module"], fn["qualname"]) for s in self.summaries
                 if s["rel"].startswith(PHASE_TRANSITION_PREFIXES)
                 for fn in s["functions"]]
        return self._reach(seeds)

    def suppressed(self, summary: dict, line: int, rule_id: str) -> bool:
        fs = set(summary.get("file_suppress", ()))
        if rule_id in fs or "all" in fs:
            return True
        ids = set(summary.get("suppress", {}).get(str(line), ()))
        return rule_id in ids or "all" in ids


class ProjectRule(Rule):
    """A rule that needs the whole-program view.  ``check`` (per-file)
    is a no-op; the engine's project pass calls ``check_project``."""

    def check(self, sf):
        return ()

    def check_project(self, project: Project):
        raise NotImplementedError

    def project_finding(self, summary: dict, site: dict,
                        message: str) -> Finding:
        return Finding(rule=self.id, severity=self.severity,
                       path=summary["rel"], line=site["line"],
                       message=message, snippet=site["snippet"])


@register
class TransitiveHostSync(ProjectRule):
    id = "R017"
    severity = "high"
    title = "host read transitively reachable from a device-path root " \
            "(cross-module)"

    def check_project(self, project: Project):
        pred = project.device_reach()
        for summary in project.summaries:
            mod = summary["module"]
            for fn in summary["functions"]:
                key = (mod, fn["qualname"])
                if key not in pred:
                    continue
                if fn["local_reachable"]:
                    continue  # R001's per-file closure already covers it
                chain = project.chain(pred, key)
                for site in fn["sync_sites"]:
                    yield self.project_finding(
                        summary, site,
                        f"{site['label']} in '{fn['qualname']}' is "
                        f"transitively reachable from a device-path root "
                        f"({chain}): a blocking device->host read every "
                        "sweep that the per-file R001 closure cannot see "
                        "across the module boundary")


@register
class TransitiveDevicePull(ProjectRule):
    id = "R018"
    severity = "high"
    title = "device->host pull in a helper reached from phase-" \
            "transition code (cross-module)"

    def check_project(self, project: Project):
        pred = project.phase_transition_reach()
        for summary in project.summaries:
            if summary["rel"].startswith(PHASE_TRANSITION_PREFIXES):
                continue  # R010 owns the in-scope modules
            mod = summary["module"]
            for fn in summary["functions"]:
                key = (mod, fn["qualname"])
                if key not in pred:
                    continue
                chain = project.chain(pred, key)
                for site in fn["pull_sites"]:
                    yield self.project_finding(
                        summary, site,
                        f"{site['label']} in '{fn['qualname']}' is reached "
                        f"from phase-transition code ({chain}): the "
                        "O(E)/O(V) host materialization R010 polices "
                        "has moved into a helper module where the "
                        "per-file rule cannot see it; keep the slab on "
                        "the card or justify with an inline disable")


def run_project(summaries, rules=None) -> list:
    """All project-tier findings over a summary set, suppression-
    filtered.  ``rules`` (when given) selects which ProjectRules run."""
    from cuvite_tpu_torch.analysis.engine import all_rules

    project = Project(summaries)
    selected = [r for r in (all_rules() if rules is None else rules)
                if isinstance(r, ProjectRule)]
    out = []
    seen = set()
    for rule in selected:
        for f in rule.check_project(project):
            summary = project.by_module.get(module_of(f.path))
            if summary is not None \
                    and project.suppressed(summary, f.line, f.rule):
                continue
            # Same-named defs collapse in the call graph, so one site
            # can surface once per homonym — dedupe on the anchor.
            key = (f.path, f.line, f.rule)
            if key in seen:
                continue
            seen.add(key)
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def run_project_sources(sources: dict, rules=None) -> list:
    """Test-facing: lint a {rel: source text} dict as one project —
    per-file findings plus the project tiers, exactly what run_paths
    produces for the same tree on disk."""
    from cuvite_tpu_torch.analysis.engine import run_source

    findings = []
    summaries = []
    for rel, text in sorted(sources.items()):
        findings.extend(run_source(text, path=rel, rules=rules, rel=rel))
        summaries.append(summarize(SourceFile(text, path=rel, rel=rel)))
    findings.extend(run_project(summaries, rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
