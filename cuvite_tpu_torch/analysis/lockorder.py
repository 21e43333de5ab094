"""Tier 4 (static half) — lock-order and atomicity rules for the port's
serve/, port of ``cuvite_tpu/analysis/lockorder.py``.

With the pipelined dispatcher (double-buffered dispatch) the analyzer
must see the two concurrency hazard classes
R019's lockset inference cannot: *ordering* (two locks acquired in
opposite orders on two paths — deadlock potential that no single-file,
single-field view can express) and *atomicity* (a guarded-field read
outside the lock deciding a mutation made under it — the check-then-act
shape of the drain/duplicate-id paths).

**R020 — lock-order cycle** (project tier).  Every serve/ file reduces
to a :func:`lock_summary`: per class, the attr→class map its
constructor proves (``self.stats = ServeStats()``, ``self.server =
server`` with a ``server: LouvainServer`` annotation), which lock
attributes are reentrant (an ``RLock`` spelling in their declaration),
and per method the lock acquisitions, the lexically nested
acquisitions, the calls made while holding a lock, and the resolvable
calls overall.  The project pass links the summaries: lock expressions
normalize to ``OwnerClass.attr`` by walking the attr→class maps
(``self.stats.lock`` in LouvainServer → ``ServeStats.lock``), call
targets resolve the same way (param annotations and ``x = self.attr``
local aliases included), and an **acquisition graph** forms — an edge
``A → B`` wherever a thread can hold ``A`` while acquiring ``B``,
either lexically nested or through a resolved call chain.  A cycle is
a potential deadlock; a self-edge on a provably non-reentrant ``Lock``
is a guaranteed one.  Summaries are plain JSON and ride the
incremental lint cache exactly like the tier-2 dataflow summaries.

**R021 — check-then-act outside the lock** (per file).  A read of an
R019-guarded field inside an ``if``/``while`` test NOT holding the
guard, in a function that also mutates that field UNDER the guard: the
decision can go stale between the test and the mutation.  The fix is
the drain-recheck idiom daemon._handle_submit uses — take the lock,
re-check, then act.

Both rules scope to ``cuvite_tpu_torch/serve/`` (the only concurrent
package) and resolve only what imports/annotations/constructors prove
— unresolvable receivers contribute no edges (bounded false negatives,
near-zero false positives; the house contract).
"""

from __future__ import annotations

import ast

from cuvite_tpu_torch.analysis.callgraph import ProjectRule
from cuvite_tpu_torch.analysis.engine import Rule, dotted, register
from cuvite_tpu_torch.analysis.lockset import (
    LOCKSET_SCOPE,
    _annotations,
    _ClassFacts,
    _lock_of_with_item,
)

LOCK_SUMMARY_VERSION = 1


def _annotation_names(node: ast.AST | None) -> list:
    """Class names an annotation can prove: ``B``, ``"B"``,
    ``B | None``, ``Optional[B]``."""
    if node is None:
        return []
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        # 'B' / 'B | None' forward references
        return [p.strip() for p in node.value.split("|")
                if p.strip() and p.strip() != "None"]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _annotation_names(node.left) + _annotation_names(node.right)
    if isinstance(node, ast.Subscript):    # Optional[B] / Union[B, None]
        out = []
        sl = node.slice
        for el in (sl.elts if isinstance(sl, ast.Tuple) else [sl]):
            out.extend(_annotation_names(el))
        return out
    return []


def _class_attr_map(cls: ast.ClassDef) -> tuple:
    """(attrs, reentrant): ``attrs`` maps instance attribute -> the
    class name its constructor provably binds; ``reentrant`` is the set
    of own lock attrs whose declaration spells RLock."""
    attrs: dict = {}
    reentrant: set = set()
    # class-body declarations (dataclass fields): reentrancy only
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name):
            src = ast.unparse(stmt)
            if "lock" in stmt.target.id.lower() and "RLock" in src:
                reentrant.add(stmt.target.id)
    for fn in cls.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or fn.name not in ("__init__", "__post_init__"):
            continue
        ann = {a.arg: _annotation_names(a.annotation)
               for a in fn.args.args + fn.args.kwonlyargs}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            val = node.value
            if isinstance(val, ast.Call):
                callee = dotted(val.func)
                if callee:
                    last = callee.split(".")[-1]
                    attrs.setdefault(tgt.attr, last)
                    if "lock" in tgt.attr.lower() and "RLock" in callee:
                        reentrant.add(tgt.attr)
            elif isinstance(val, ast.Name) and val.id in ann:
                for name in ann[val.id]:
                    attrs.setdefault(tgt.attr, name)
                    break
    return attrs, reentrant


def _local_aliases(fn: ast.AST) -> dict:
    """name -> ('attr', 'a.b') for ``x = self.a.b`` assignments and
    ('cls', 'C') for annotated params — the receivers a method call can
    resolve through."""
    out: dict = {}
    args = fn.args
    for a in args.args + args.kwonlyargs + args.posonlyargs:
        names = _annotation_names(a.annotation)
        if names:
            out[a.arg] = ("cls", names[0])
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = dotted(node.value)
            if name and name.startswith("self."):
                out[node.targets[0].id] = ("attr", name[len("self."):])
    return out


def _method_summary(sf, cls: ast.ClassDef, fn) -> dict:
    """Acquisitions, nested acquisition edges, calls-under-lock, and
    all dotted calls of one method (raw expressions; the project pass
    normalizes)."""
    held: dict = {}     # node id -> list of lock exprs held (outer first)
    acquires: list = []
    nested: list = []
    # ast.walk visits an enclosing With before any nested one, so by
    # the time a With is processed its descendants already carry the
    # outer locks — extending with THIS With's locks keeps the held
    # list in acquisition order.
    for node in ast.walk(fn):
        if not isinstance(node, ast.With):
            continue
        outer = held.get(id(node), [])
        exprs = []
        for item in node.items:
            hit = _lock_of_with_item(item.context_expr)
            if hit is not None:
                exprs.append(hit[0])
        if not exprs:
            continue
        line = node.lineno
        for i, expr in enumerate(exprs):
            acquires.append({"lock": expr, "line": line,
                             "snippet": sf.line(line)})
            for o in outer + exprs[:i]:
                nested.append({"outer": o, "inner": expr, "line": line,
                               "snippet": sf.line(line)})
        for inner in ast.walk(node):
            if inner is node:
                continue
            held.setdefault(id(inner), []).extend(exprs)
    calls: list = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        callee = dotted(node.func)
        if not callee:
            continue
        calls.append({"callee": callee, "line": node.lineno,
                      "snippet": sf.line(node.lineno),
                      "under": list(dict.fromkeys(
                          held.get(id(node), [])))})
    return {"acquires": acquires, "nested": nested, "calls": calls,
            "aliases": {k: list(v) for k, v in _local_aliases(fn).items()}}


def lock_summary(sf) -> dict | None:
    """The file's lock-acquisition facts as plain JSON (None outside
    serve/ — the only concurrent package; elsewhere the summary would
    be dead weight in the cache)."""
    if not sf.rel.startswith(LOCKSET_SCOPE):
        return None
    classes: dict = {}
    for cls in sf.walk():
        if not isinstance(cls, ast.ClassDef):
            continue
        attrs, reentrant = _class_attr_map(cls)
        methods: dict = {}
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods[fn.name] = _method_summary(sf, cls, fn)
        classes[cls.name] = {
            "attrs": attrs,
            "reentrant": sorted(reentrant),
            "methods": methods,
        }
    return {"version": LOCK_SUMMARY_VERSION, "rel": sf.rel,
            "classes": classes}


# ---------------------------------------------------------------------------
# R020 — the project-tier acquisition graph


class _LockGraph:
    """Links per-file lock summaries into one acquisition graph."""

    def __init__(self, summaries):
        self.classes: dict = {}     # class name -> (rel, class summary)
        for s in summaries:
            locks = (s or {}).get("locks") or {}
            if locks.get("version") != LOCK_SUMMARY_VERSION:
                continue
            for cname, cdata in locks.get("classes", {}).items():
                self.classes[cname] = (locks["rel"], cdata)
        # edges: (outer, inner) -> first site {"rel", "line", "snippet",
        # "via"} — deterministic: summaries arrive in sorted-rel order.
        self.edges: dict = {}
        self._locks_in_cache: dict = {}
        self._build()

    # -- normalization -------------------------------------------------

    def _attr_class(self, cls: str, attr: str) -> str | None:
        ent = self.classes.get(cls)
        if ent is None:
            return None
        tgt = ent[1]["attrs"].get(attr)
        return tgt if tgt in self.classes else None

    def _walk_attrs(self, cls: str, parts: list) -> str | None:
        """Resolve an attribute chain of classes: cls, a, b -> class of
        ``self.a.b`` (None when any hop is unproven)."""
        cur = cls
        for p in parts:
            cur = self._attr_class(cur, p)
            if cur is None:
                return None
        return cur

    def normalize_lock(self, cls: str, expr: str,
                       aliases: dict | None = None) -> str | None:
        """'self.stats.lock' in LouvainServer -> 'ServeStats.lock';
        'client.wlock' with a ``client: _Client`` annotation ->
        '_Client.wlock'.  None when the owner cannot be proven."""
        parts = expr.split(".")
        if parts[0] == "self":
            owner = self._walk_attrs(cls, parts[1:-1])
            return f"{owner}.{parts[-1]}" if owner else None
        alias = (aliases or {}).get(parts[0])
        if alias is None:
            return None
        kind, val = alias
        base = (self._walk_attrs(cls, val.split("."))
                if kind == "attr" else
                (val if val in self.classes else None))
        if base is None:
            return None
        owner = self._walk_attrs(base, parts[1:-1])
        return f"{owner}.{parts[-1]}" if owner else None

    def resolve_call(self, cls: str, callee: str,
                     aliases: dict | None = None) -> tuple | None:
        """'self.server.submit' -> ('LouvainServer', 'submit') when the
        chain is proven and the target class defines the method."""
        parts = callee.split(".")
        if len(parts) < 2:
            return None
        if parts[0] == "self":
            owner = self._walk_attrs(cls, parts[1:-1])
        else:
            alias = (aliases or {}).get(parts[0])
            if alias is None:
                return None
            kind, val = alias
            base = (self._walk_attrs(cls, val.split("."))
                    if kind == "attr" else
                    (val if val in self.classes else None))
            if base is None:
                return None
            owner = self._walk_attrs(base, parts[1:-1])
        if owner is None:
            return None
        if parts[-1] not in self.classes[owner][1]["methods"]:
            return None
        return owner, parts[-1]

    # -- transitive lock closure ---------------------------------------

    def locks_in(self, cls: str, method: str, _seen=None) -> set:
        """Every normalized lock (cls, method) can acquire, directly or
        through resolved calls (cycle-safe, memoized)."""
        key = (cls, method)
        hit = self._locks_in_cache.get(key)
        if hit is not None:
            return hit
        seen = _seen if _seen is not None else set()
        if key in seen:
            return set()
        seen.add(key)
        m = self.classes[cls][1]["methods"][method]
        aliases = m.get("aliases", {})
        out: set = set()
        for acq in m["acquires"]:
            lk = self.normalize_lock(cls, acq["lock"], aliases)
            if lk:
                out.add(lk)
        for call in m["calls"]:
            tgt = self.resolve_call(cls, call["callee"], aliases)
            if tgt is not None:
                out |= self.locks_in(*tgt, _seen=seen)
        if _seen is None:       # memoize only fully-expanded closures
            self._locks_in_cache[key] = out
        return out

    # -- the graph ------------------------------------------------------

    def _add_edge(self, outer: str, inner: str, rel: str, line: int,
                  snippet: str, via: str) -> None:
        self.edges.setdefault((outer, inner), {
            "rel": rel, "line": line, "snippet": snippet, "via": via})

    def _build(self) -> None:
        for cname in sorted(self.classes):
            rel, cdata = self.classes[cname]
            for mname in sorted(cdata["methods"]):
                m = cdata["methods"][mname]
                aliases = m.get("aliases", {})
                for e in m["nested"]:
                    outer = self.normalize_lock(cname, e["outer"], aliases)
                    inner = self.normalize_lock(cname, e["inner"], aliases)
                    if outer and inner:
                        self._add_edge(outer, inner, rel, e["line"],
                                       e["snippet"],
                                       f"{cname}.{mname} (nested with)")
                for call in m["calls"]:
                    if not call["under"]:
                        continue
                    tgt = self.resolve_call(cname, call["callee"], aliases)
                    if tgt is None:
                        continue
                    inner_locks = self.locks_in(*tgt)
                    for outer_expr in call["under"]:
                        outer = self.normalize_lock(cname, outer_expr,
                                                    aliases)
                        if not outer:
                            continue
                        for inner in inner_locks:
                            self._add_edge(
                                outer, inner, rel, call["line"],
                                call["snippet"],
                                f"{cname}.{mname} -> "
                                f"{tgt[0]}.{tgt[1]}()")

    def is_reentrant(self, lock: str) -> bool:
        cls, _, attr = lock.rpartition(".")
        ent = self.classes.get(cls)
        return ent is not None and attr in ent[1]["reentrant"]

    def cycles(self) -> list:
        """Elementary cycles in the acquisition graph, canonicalized
        (rotation starting at the min lock) and deduplicated.  Self
        edges are returned as 1-cycles only for provably non-reentrant
        locks (re-entering an RLock is legal by construction)."""
        adj: dict = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
        out = []
        seen = set()
        for (a, b) in sorted(self.edges):
            if a == b:
                if not self.is_reentrant(a) and (a,) not in seen:
                    seen.add((a,))
                    out.append([a, a])
                continue
            # DFS from b back to a (bounded; the lock population is
            # tiny — a handful per package).
            stack = [(b, [a, b])]
            found = None
            visited = set()
            while stack and found is None:
                cur, path = stack.pop()
                if cur == a:
                    found = path
                    break
                if cur in visited or len(path) > 8:
                    continue
                visited.add(cur)
                for nxt in sorted(adj.get(cur, ())):
                    if nxt == a:
                        found = path + [a]
                        break
                    stack.append((nxt, path + [nxt]))
            if found:
                cyc = found[:-1]
                lo = cyc.index(min(cyc))
                canon = tuple(cyc[lo:] + cyc[:lo])
                if canon not in seen:
                    seen.add(canon)
                    out.append(list(canon) + [canon[0]])
        return out


@register
class LockOrderCycle(ProjectRule):
    id = "R020"
    severity = "high"
    title = "lock-acquisition cycle across serve/ classes (deadlock " \
            "potential)"

    def check_project(self, project):
        graph = _LockGraph(project.summaries)
        for cyc in graph.cycles():
            pairs = list(zip(cyc, cyc[1:]))
            site = graph.edges.get(pairs[0])
            if site is None:
                continue
            order = " -> ".join(cyc)
            vias = "; ".join(
                f"{a}->{b} at {graph.edges[(a, b)]['rel']}:"
                f"{graph.edges[(a, b)]['line']} "
                f"[{graph.edges[(a, b)]['via']}]"
                for a, b in pairs if (a, b) in graph.edges)
            if len(cyc) == 2 and cyc[0] == cyc[1]:
                msg = (f"non-reentrant lock {cyc[0]} can be re-acquired "
                       f"while already held ({vias}): guaranteed "
                       "self-deadlock; make it an RLock or restructure "
                       "the call so the lock is released first")
            else:
                msg = (f"lock-order cycle {order} ({vias}): two threads "
                       "taking these locks in opposite orders can "
                       "deadlock; pick one global order (document it) "
                       "or collapse the critical sections")
            yield self.project_finding(
                {"rel": site["rel"]},
                {"line": site["line"], "snippet": site["snippet"]},
                msg)


# ---------------------------------------------------------------------------
# R021 — check-then-act atomicity


@register
class CheckThenActOutsideLock(Rule):
    id = "R021"
    severity = "high"
    title = "guarded-field read outside the lock deciding a mutation " \
            "made under it (check-then-act, serve/)"

    def check(self, sf):
        if not sf.rel.startswith(LOCKSET_SCOPE):
            return
        annotations = _annotations(sf)
        for cls in sf.walk():
            if not isinstance(cls, ast.ClassDef):
                continue
            facts = _ClassFacts(sf, cls, annotations)
            if not facts.guards:
                continue
            for owner, field, node, held, func in facts.reads_in_test(sf):
                locks = facts.guards.get((owner, field))
                if not locks or held & locks:
                    continue
                if func is None:
                    continue
                mutated_under = [
                    m for m in facts.mutations
                    if (m[0], m[1]) == (owner, field) and (m[4] & locks)
                    and sf.enclosing_function(m[3]) is func]
                if not mutated_under:
                    continue
                want = " or ".join(sorted(locks))
                mline = mutated_under[0][3].lineno
                yield self.finding(
                    sf, node,
                    f"'{owner}.{field}' is read here WITHOUT {want} to "
                    f"decide a branch, but '{func.name}' mutates it "
                    f"under the lock (line {mline}): the decision can "
                    "go stale between the test and the mutation "
                    "(check-then-act — the drain/duplicate-id shape). "
                    "Take the lock and re-check inside it, or justify "
                    "with an inline disable")
