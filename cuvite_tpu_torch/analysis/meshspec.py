"""Tier 5 (static half) — mesh/collective analysis of the port
(R023-R025), port of ``cuvite_tpu/analysis/meshspec.py``.

The reference's collectives name a mesh axis (``psum(x, "v")``) inside a
``shard_map`` body.  The port's collectives (``comm/collectives.py``:
``all_gather``, ``psum``, ``all_to_all`` over per-shard lists) take a
mesh object instead, and a mesh object is one of three *scopes*:

  * ``"v"``: a whole mesh, from ``make_mesh`` or ``make_hybrid_mesh``
    (the hybrid mesh is the flat vertex mesh carrying its views);
  * ``"ici"``: a view of one ICI group, from ``mesh.ici_views``;
  * ``"dcn"``: a view of one DCN column, from ``mesh.dcn_views``.

**Facts** (:func:`mesh_summary`, riding the tier-2 summary and the
incremental lint cache): per file — mesh constructions with the scopes
they make, the list collectives with their mesh argument classified
(``["lit", scope]`` for a mesh or view bound in the function,
``["param", fn, p]`` for a parameter, chased at project tier through
the call sites' bindings), and O(nv_total) materialization sites with
their ``# graftlint: replicated-ok=<reason>`` annotations.

Where the reference starts from ``shard_map`` wraps, the port starts
from the mesh entries of ``engine.MESH_ENTRIES``: ``MeshPhaseRunner``,
``sharded_bucketed_step``, ``sharded_bucketed_modularity``,
``sharded_step``, ``phase_loop`` (``mesh=``) and the rank body that
``multihost.launch`` starts.

**R023 — mesh-scope drift** (project tier).  A collective reached from
a mesh entry whose mesh argument resolves to (a) a scope no mesh in the
project constructs (a view of a project that builds no hybrid mesh: the
views of a flat mesh are empty), or (b) the whole mesh (``"v"``) in a
function whose callers hand it a view — the group tables of the
two-level exchange re-widened to every shard, the bug the reference's
``test_r023_hybrid_table_rewidened_to_flat_axis_convicted`` pins.

**R024 — whole-program collective divergence** (project tier).  A list
collective under a rank-dependent or fallible branch (R004's classifier,
plus ``try``) in ANY function reachable from a mesh entry, with the
reach chain in the message.  R004 keeps the ``torch.distributed``
collectives and ``multihost``'s host wrappers.

**R025 — replication audit** (project tier).  A buffer whose size
scales with ``nv_total`` (``torch.zeros(nv_total...)``,
``segment_sum(..., nv_total)``, an ``all_gather`` of a sharded table)
materialized in code reachable from a mesh entry is O(total vertices)
per card.  Every such site carries ``# graftlint: replicated-ok=
<reason>`` on its line, so the replicated tables form a closed,
justified inventory (:func:`replicated_inventory`).
"""

from __future__ import annotations

import ast
import re

from cuvite_tpu_torch.analysis.engine import (
    Finding,
    SourceFile,
    dotted,
    register,
)
from cuvite_tpu_torch.analysis.rules import (
    DIST_PREFIXES,
    _condition_is_divergent,
)

MESH_SUMMARY_VERSION = 1

# The port's list collectives (comm/collectives.py), matched on the
# dotted name's last part; torch.distributed's own are R004's.
LIST_COLLECTIVES = {"all_gather", "psum", "all_to_all"}

# Scopes a constructor makes.
_CONSTRUCTORS = {
    "make_mesh": ("v",),
    "make_hybrid_mesh": ("v", "ici", "dcn"),
}
_VIEW_ATTRS = {"ici_views": "ici", "dcn_views": "dcn"}

SIZE_SYMBOLS = ("nv_total",)
_ALLOC_CALLS = {"zeros", "ones", "full", "empty", "arange", "broadcast_to"}
_SEGMENT_PREFIX = "segment_"

_REPL_OK_RE = re.compile(r"#\s*graftlint:\s*replicated-ok\s*=\s*(.+?)\s*$")
# Optional scope prefix of a replicated-ok reason (``scope=ici; <prose>``):
# ``ici`` = materialized only inside one ICI group (a flat mesh is the
# one-group case), ``scalar`` = not vertex-scaled.  No prefix reads as
# scope=global.
_SCOPE_RE = re.compile(r"^scope=([A-Za-z0-9_]+)\s*;\s*")


def _last(name: str | None) -> str:
    return name.split(".")[-1] if name else ""


def is_list_collective(fname: str | None) -> bool:
    return bool(fname) and _last(fname) in LIST_COLLECTIVES \
        and not fname.startswith(DIST_PREFIXES)


def _view_scope(expr: ast.AST) -> str | None:
    """'ici'/'dcn' when ``expr`` reads a mesh's ``ici_views`` or
    ``dcn_views`` anywhere inside it."""
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and n.attr in _VIEW_ATTRS:
            return _VIEW_ATTRS[n.attr]
    return None


def _target_names(t: ast.AST) -> list:
    """The names a for/comprehension/assignment target binds, the first
    element of a tuple target first (``view, pos``)."""
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        out = []
        for el in t.elts:
            out.extend(_target_names(el))
        return out
    return []


def _local_scopes(sf: SourceFile) -> dict:
    """{(function id, name): scope} for every name a function binds to a
    mesh or a view: ``for view, pos in mesh.ici_views`` (and the
    comprehension form), ``m = make_mesh(...)``, ``v, p = next(... in
    mesh.dcn_views ...)``.  A tuple target's FIRST name is the view."""
    out: dict = {}

    def bind(node, target, scope):
        names = _target_names(target)
        if names and scope:
            info = sf.enclosing_function(node)
            out[(id(info), names[0])] = scope

    for node in sf.walk():
        if isinstance(node, (ast.For, ast.AsyncFor)):
            bind(node, node.target, _view_scope(node.iter))
        elif isinstance(node, ast.comprehension):
            bind(node, node.target, _view_scope(node.iter))
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            val = node.value
            scope = None
            if isinstance(val, ast.Call) \
                    and _last(dotted(val.func)) in _CONSTRUCTORS:
                scope = "v"
            else:
                scope = _view_scope(val)
            bind(node, node.targets[0], scope)
    return out


def _mesh_token(sf: SourceFile, scopes: dict, node: ast.AST) -> list:
    """Classify one mesh expression: ``["lit", scope]`` / ``["param", fn,
    p]`` / ``["unknown", src]``."""
    if isinstance(node, ast.Call) \
            and _last(dotted(node.func)) in _CONSTRUCTORS:
        return ["lit", "v"]
    if isinstance(node, ast.Name):
        info = sf.enclosing_function(node)
        while info is not None:
            scope = scopes.get((id(info), node.id))
            if scope:
                return ["lit", scope]
            if node.id in info.params:
                return ["param", info.qualname, node.id]
            info = sf.enclosing_function(info.node)
        return ["unknown", node.id]
    try:
        return ["unknown", ast.unparse(node)]
    except Exception:
        return ["unknown", "<expr>"]


def _collective_mesh(sf, scopes, node: ast.Call) -> list:
    for kw in node.keywords:
        if kw.arg == "mesh":
            return _mesh_token(sf, scopes, kw.value)
    if len(node.args) >= 2:
        return _mesh_token(sf, scopes, node.args[1])
    return ["unknown", "<none>"]


def _divergence_reason(sf: SourceFile, node: ast.AST) -> str | None:
    """Why the collective at ``node`` may be issued by some ranks and
    not others: R004's classifier on every enclosing ``if``/``while`` up
    to the function boundary, plus ``try``."""
    info = sf.enclosing_function(node)
    boundary = info.node if info is not None else None
    child = node
    for anc in sf.ancestors(node):
        if anc is boundary:
            return None
        if isinstance(anc, ast.Try):
            return "inside a try block (an exception skips the " \
                   "remaining collectives on that rank only)"
        if isinstance(anc, (ast.If, ast.While)) and child is not anc.test:
            why = _condition_is_divergent(anc.test)
            if why:
                return why
        child = anc
    return None


def _replicated_ok_lines(sf: SourceFile) -> dict:
    """{lineno: reason} for every ``# graftlint: replicated-ok=`` pragma
    (real comment tokens, same discipline as the disable pragmas)."""
    out: dict = {}
    for lineno, comment in sf._iter_comments():
        if "replicated-ok" not in comment:
            continue
        m = _REPL_OK_RE.search(comment)
        if m:
            out[lineno] = m.group(1)
    return out


def _size_symbol_of(expr: ast.AST) -> str | None:
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and n.id in SIZE_SYMBOLS:
            return n.id
        if isinstance(n, ast.Attribute) and n.attr in SIZE_SYMBOLS:
            return n.attr
    return None


def mesh_summary(sf: SourceFile) -> dict:
    """The JSON-serializable mesh facts of one file (see module
    docstring); rides the tier-2 summary under the ``"mesh"`` key."""
    scopes = _local_scopes(sf)
    repl_ok = _replicated_ok_lines(sf)
    meshes: list = []
    collectives: list = []
    allocs: list = []
    binds: list = []
    params: dict = {}
    for info in sf.functions:
        params.setdefault(info.qualname, list(info.params))

    for node in sf.walk():
        if not isinstance(node, ast.Call):
            continue
        fname = dotted(node.func)
        last = _last(fname)
        info = sf.enclosing_function(node)
        fn_name = info.qualname if info is not None else ""
        line = getattr(node, "lineno", 1)

        if last in _CONSTRUCTORS and (info is None
                                      or info.name not in _CONSTRUCTORS):
            meshes.append({"fn": fn_name, "line": line,
                           "snippet": sf.line(line),
                           "scopes": list(_CONSTRUCTORS[last])})

        if is_list_collective(fname):
            collectives.append({
                "fn": fn_name, "call": fname, "line": line,
                "snippet": sf.line(line),
                "mesh": _collective_mesh(sf, scopes, node),
                "divergent": _divergence_reason(sf, node),
            })
            if last == "all_gather":
                # all_gather materializes every shard's block on every
                # shard — an R025 site regardless of symbol names.
                allocs.append({
                    "fn": fn_name, "call": fname, "line": line,
                    "snippet": sf.line(line), "size": "all_gather",
                    "replicated_ok": repl_ok.get(line),
                })

        # O(nv_total) materializations (R025).
        sym = None
        if last in _ALLOC_CALLS and node.args:
            shape_arg = node.args[1] \
                if last == "broadcast_to" and len(node.args) >= 2 \
                else node.args[0]
            sym = _size_symbol_of(shape_arg)
        if sym is None and last.startswith(_SEGMENT_PREFIX):
            for kw in node.keywords:
                if kw.arg == "num_segments":
                    sym = _size_symbol_of(kw.value)
            if sym is None and len(node.args) >= 3:
                sym = _size_symbol_of(node.args[2])
        if sym is not None:
            allocs.append({
                "fn": fn_name, "call": fname or last, "line": line,
                "snippet": sf.line(line), "size": sym,
                "replicated_ok": repl_ok.get(line),
            })

        # Mesh-relevant call-site bindings, for parameter resolution:
        # arguments that are a mesh or a view bound in the caller, or a
        # caller parameter whose name says mesh/view.  Bounded: nothing
        # else is recorded.
        if not fname or info is None:
            continue
        bind_pos: dict = {}
        bind_kw: dict = {}

        def meshish(a):
            if not isinstance(a, (ast.Name, ast.Call)):
                return None
            tok = _mesh_token(sf, scopes, a)
            if tok[0] == "lit":
                return tok
            if tok[0] == "param" and ("mesh" in tok[2].lower()
                                      or "view" in tok[2].lower()):
                return tok
            return None

        for i, a in enumerate(node.args):
            tok = meshish(a)
            if tok:
                bind_pos[str(i)] = tok
        for kw in node.keywords:
            tok = meshish(kw.value) if kw.arg else None
            if tok:
                bind_kw[kw.arg] = tok
        if bind_pos or bind_kw:
            binds.append({"fn": fn_name, "callee": fname,
                          "method": isinstance(node.func, ast.Attribute),
                          "pos": bind_pos, "kw": bind_kw})

    return {
        "version": MESH_SUMMARY_VERSION,
        "params": params,
        "meshes": meshes,
        "collectives": collectives,
        "allocs": allocs,
        "binds": binds,
    }


# ---------------------------------------------------------------------------
# Project-tier linking.

_EMPTY_MESH = {"params": {}, "meshes": [], "collectives": [], "allocs": [],
               "binds": []}


class MeshProject:
    """Mesh-scope resolution over a linked summary set (wraps a
    callgraph.Project; built once per run_project pass)."""

    MAX_DEPTH = 5

    def __init__(self, project):
        self.project = project
        self.mesh_of: dict = {}
        for s in project.summaries:
            m = s.get("mesh")
            self.mesh_of[s["module"]] = (
                m if m and m.get("version") == MESH_SUMMARY_VERSION
                else _EMPTY_MESH)
        # (module, funcname) -> [(caller module, bind dict)]
        self.call_binds: dict = {}
        for s in project.summaries:
            for b in self.mesh_of[s["module"]]["binds"]:
                for tgt in project._resolve(s, b["callee"], b["fn"]):
                    self.call_binds.setdefault(tgt, []).append(
                        (s["module"], b))

    def _bound(self, key, pname: str, b: dict):
        """The token a call site binds to parameter ``pname`` of the
        function ``key``, or None."""
        tok = b["kw"].get(pname)
        if tok is not None:
            return tok
        plist = self.mesh_of.get(key[0], _EMPTY_MESH)["params"].get(
            key[1], [])
        if pname not in plist:
            return None
        idx = plist.index(pname)
        if b.get("method") and plist and plist[0] in ("self", "cls"):
            idx -= 1
        return b["pos"].get(str(idx))

    def resolve_token(self, module: str, token, depth: int = None,
                      seen=None) -> set:
        """The scopes a mesh token can denote ({} = unresolved)."""
        if depth is None:
            depth = self.MAX_DEPTH
        if not token or depth <= 0:
            return set()
        if token[0] == "lit":
            return {token[1]}
        if token[0] == "param":
            fn, pname = token[1], token[2]
            key = (module, fn)
            seen = seen or set()
            if (module, fn, pname) in seen:
                return set()
            seen = seen | {(module, fn, pname)}
            out: set = set()
            for caller_mod, b in self.call_binds.get(key, ()):
                tok = self._bound(key, pname, b)
                if tok is not None:
                    out |= self.resolve_token(caller_mod, tok, depth - 1,
                                              seen)
            return out
        return set()

    def known_scopes(self) -> set:
        out: set = set()
        for mesh in self.mesh_of.values():
            for m in mesh["meshes"]:
                out |= set(m["scopes"])
        return out

    def view_scopes_passed(self, key) -> set:
        """The view scopes ('ici'/'dcn') the callers of ``key`` hand to
        any of its parameters: the scope a two-level helper works in."""
        out: set = set()
        for caller_mod, b in self.call_binds.get(key, ()):
            for tok in list(b["pos"].values()) + list(b["kw"].values()):
                out |= self.resolve_token(caller_mod, tok) & {"ici", "dcn"}
        return out

    def entry_reach(self) -> dict:
        return self.project._reach(self.project.roots("mesh_entry"))


def replicated_inventory(summaries) -> list:
    """Every annotated O(nv_total) materialization in the summary set:
    [{rel, line, fn, call, size, scope, reason, snippet}] — the closed,
    justified inventory of per-card-replicated tables.  ``scope`` is
    parsed from the reason's ``scope=<s>;`` prefix; an unprefixed reason
    reports ``"global"``."""
    out = []
    for s in summaries:
        mesh = (s or {}).get("mesh") or {}
        for a in mesh.get("allocs", ()):
            if a.get("replicated_ok"):
                reason = a["replicated_ok"]
                m = _SCOPE_RE.match(reason)
                out.append({
                    "rel": s["rel"], "line": a["line"], "fn": a["fn"],
                    "call": a["call"], "size": a["size"],
                    "scope": m.group(1) if m else "global",
                    "reason": reason[m.end():] if m else reason,
                    "snippet": a["snippet"],
                })
    return sorted(out, key=lambda d: (d["rel"], d["line"]))


# ---------------------------------------------------------------------------
# Rules.

from cuvite_tpu_torch.analysis.callgraph import ProjectRule  # noqa: E402


def _mesh_view(project):
    """One MeshProject + entry reach per project pass, shared by the
    three rules; cached on the Project instance, which lives exactly one
    run_project pass."""
    view = getattr(project, "_tier5_view", None)
    if view is None:
        mp = MeshProject(project)
        view = (mp, mp.entry_reach())
        project._tier5_view = view
    return view


def _site_finding(rule, summary, site, message) -> Finding:
    return Finding(rule=rule.id, severity=rule.severity,
                   path=summary["rel"], line=site["line"],
                   message=message, snippet=site["snippet"])


@register
class MeshScopeDrift(ProjectRule):
    id = "R023"
    severity = "high"
    title = "collective over a mesh scope its callers do not hand it " \
            "(cross-module)"

    def check_project(self, project):
        mp, pred = _mesh_view(project)
        known = mp.known_scopes()
        for summary in project.summaries:
            mod = summary["module"]
            for c in mp.mesh_of[mod]["collectives"]:
                key = (mod, c["fn"])
                if key not in pred:
                    continue
                scopes = mp.resolve_token(mod, c["mesh"])
                if not scopes:
                    continue  # unresolved: bounded false negative
                chain = project.chain(pred, key)
                bad = sorted(scopes - known) if known else []
                if bad:
                    yield _site_finding(
                        self, summary, c,
                        f"{c['call']}(...) runs over mesh scope "
                        f"{', '.join(map(repr, bad))} which no mesh in "
                        f"the project constructs (known scopes: "
                        f"{sorted(known)}); reached from a mesh entry "
                        f"via {chain} — the views of a flat mesh are "
                        "empty, so this collective runs over no shard")
                    continue
                views = mp.view_scopes_passed(key)
                if views and "v" in scopes and not (scopes & views):
                    yield _site_finding(
                        self, summary, c,
                        f"{c['call']}(...) runs over the whole mesh "
                        f"('v') but every caller hands "
                        f"'{c['fn']}' a view over {sorted(views)} "
                        f"({chain}): the group table is re-widened to "
                        "every shard — O(nv_total) per card and a "
                        "collective the two-level exchange never issues "
                        "(the flat-axis rewidening bug class)")


@register
class WholeProgramCollectiveDivergence(ProjectRule):
    id = "R024"
    severity = "high"
    title = "collective under a rank-dependent branch in code reachable " \
            "from a mesh entry (cross-module)"

    def check_project(self, project):
        mp, pred = _mesh_view(project)
        for summary in project.summaries:
            mod = summary["module"]
            for c in mp.mesh_of[mod]["collectives"]:
                if not c.get("divergent"):
                    continue
                key = (mod, c["fn"])
                if key not in pred:
                    continue
                chain = project.chain(pred, key)
                yield _site_finding(
                    self, summary, c,
                    f"collective {c['call']}(...) is issued under a "
                    f"branch that can differ across ranks "
                    f"({c['divergent']}), and the function is reachable "
                    f"from a mesh entry ({chain}): ranks disagreeing on "
                    "the collective sequence is the canonical multi-"
                    "rank deadlock (torch.distributed and host-wrapper "
                    "cases stay R004's); issue the collective "
                    "unconditionally or branch on a replicated value")


@register
class ReplicationAudit(ProjectRule):
    id = "R025"
    severity = "high"
    title = "O(nv_total)-per-card buffer materialized in mesh-entry-" \
            "reachable code without a replicated-ok justification"

    def check_project(self, project):
        mp, pred = _mesh_view(project)
        for summary in project.summaries:
            mod = summary["module"]
            for a in mp.mesh_of[mod]["allocs"]:
                if a.get("replicated_ok"):
                    continue
                key = (mod, a["fn"])
                if key not in pred:
                    continue
                chain = project.chain(pred, key)
                what = ("all_gather replicates every shard's block"
                        if a["size"] == "all_gather"
                        else f"size scales with {a['size']}")
                yield _site_finding(
                    self, summary, a,
                    f"{a['call']}(...) materializes a buffer with no "
                    f"sharded axis in mesh-entry-reachable code "
                    f"({chain}); {what}, i.e. O(nv_total) bytes PER "
                    "CARD.  Shard it, or justify with "
                    "'# graftlint: replicated-ok=<reason>' on this line "
                    "(the annotation feeds the closed replication "
                    "inventory, meshspec.replicated_inventory)")
