"""Tier 2b — lockset concurrency checker for the port's serve/ (R019),
port of ``cuvite_tpu/analysis/lockset.py``.

The bug class this gates: the async daemon runs intake on reader
threads and dispatch on one dispatcher thread, so every shared counter
(``ServeStats``) and routing table mutated from both sides must hold its
lock — and the bugs that slipped through were exactly the mutations that
DIDN'T, which no correctness test catches because the race only loses
updates under real concurrency.

The checker is class-local lockset inference over one file at a time:

  * a **lock** is any ``with X:`` context whose dotted expression ends
    in a ``*lock*``-named attribute (``self._lock``, ``self.wlock``,
    ``self.stats.lock``); the lock's *owner* is the expression minus
    that last attribute (``self.stats.lock`` guards fields of
    ``self.stats``);
  * a field is **inferred guarded** when any mutation of it in the class
    happens under the owner's lock — assignments (``owner.f = ...``,
    ``owner.f[k] = ...``, ``owner.f += ...``) and mutating method calls
    (``owner.f.append(...)``, ``.pop``, ``.clear``, ...);
  * an explicit ``# graftlint: guarded-by=<lock>`` comment on a field's
    class-body declaration (or any mutation line) declares the guard
    where inference is ambiguous — e.g. a field whose only in-class
    mutations all forgot the lock;
  * every OTHER mutation of a guarded field that does not hold the lock
    is an R019 finding.  ``__init__``/``__post_init__``/``__new__`` are
    exempt (construction happens-before sharing), as are class-body
    defaults (they are declarations, not mutations).

Known limits: aliases (``s = self.stats;
s.x += 1``) and cross-class views of the same lock object are invisible
— each class is checked against its own spelling of the lock, which is
exactly how the serve/ code is written.  Scope is ``cuvite_tpu_torch/serve/``
only; elsewhere single-threaded mutation is the norm and the rule would
be noise.
"""

from __future__ import annotations

import ast
import re

from cuvite_tpu_torch.analysis.engine import Rule, dotted, register

LOCKSET_SCOPE = ("cuvite_tpu_torch/serve/",)

# Method names that mutate their receiver (list/deque/dict/set APIs).
MUTATING_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "popitem", "remove", "discard", "clear",
    "add", "update", "setdefault", "sort", "reverse", "rotate", "fill",
}

_GUARDED_BY_RE = re.compile(
    r"#\s*graftlint:\s*guarded-by=([A-Za-z_][A-Za-z0-9_.]*)")

_CTOR_NAMES = {"__init__", "__post_init__", "__new__"}


def _lock_of_with_item(expr: ast.AST) -> tuple | None:
    """(lock_id, owner) when ``expr`` is a dotted chain whose last
    attribute names a lock; else None."""
    name = dotted(expr)
    if not name or "." not in name:
        return None
    owner, last = name.rsplit(".", 1)
    if "lock" not in last.lower():
        return None
    return name, owner


def _mutation_of(node: ast.AST) -> tuple | None:
    """(owner, field, verb) when ``node`` mutates a dotted attribute
    chain, else None.  The owner/field split mirrors the lock-owner
    convention: ``self.stats.jobs_done += 1`` mutates field
    ``jobs_done`` of owner ``self.stats``."""

    def split(attr_node) -> tuple | None:
        name = dotted(attr_node)
        if not name or "." not in name:
            return None
        owner, field = name.rsplit(".", 1)
        return owner, field

    if isinstance(node, ast.Assign):
        for tgt in node.targets:
            if isinstance(tgt, ast.Attribute):
                hit = split(tgt)
                if hit:
                    return (*hit, "=")
            elif isinstance(tgt, ast.Subscript) \
                    and isinstance(tgt.value, ast.Attribute):
                hit = split(tgt.value)
                if hit:
                    return (*hit, "[...]=")
    elif isinstance(node, ast.AnnAssign) and node.value is not None \
            and isinstance(node.target, ast.Attribute):
        # ``self.failures: list = []`` in a constructor: the annotated
        # spelling of an assignment (the reference reads only the plain
        # one, so a guarded-by pragma on such a line declared nothing).
        hit = split(node.target)
        if hit:
            return (*hit, "=")
    elif isinstance(node, ast.AugAssign):
        tgt = node.target
        if isinstance(tgt, ast.Attribute):
            hit = split(tgt)
            if hit:
                return (*hit, "+=")
        elif isinstance(tgt, ast.Subscript) \
                and isinstance(tgt.value, ast.Attribute):
            hit = split(tgt.value)
            if hit:
                return (*hit, "[...]+=")
    elif isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr in MUTATING_METHODS \
            and isinstance(node.func.value, ast.Attribute):
        hit = split(node.func.value)
        if hit:
            return (*hit, f".{node.func.attr}()")
    return None


def _annotations(sf) -> dict:
    """# graftlint: guarded-by=<lock> pragmas -> {lineno: lock_id}.
    Read from real comment tokens (same reason the engine's
    suppressions are: prose may quote the syntax)."""
    out = {}
    for lineno, comment in sf._iter_comments():
        m = _GUARDED_BY_RE.search(comment)
        if m:
            out[lineno] = m.group(1)
    return out


class _ClassFacts:
    """Lock regions, mutations, reads, and declared fields of one
    class.  Shared infrastructure: R019 consumes the mutations, R021
    (analysis/lockorder.py) additionally consumes the reads-in-test and
    the retained held-map, and :func:`lockset_summary` lists the
    guarded-field inventory built on these facts."""

    def __init__(self, sf, cls: ast.ClassDef, annotations: dict):
        self.cls = cls
        # Nodes belonging to NESTED classes are excluded wholesale: the
        # rule analyzes every ClassDef separately, and double-attributing
        # an inner class's mutations to the outer class would both
        # duplicate findings and cross-pollute the inferred guards.
        nested: set = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.ClassDef) and node is not cls:
                nested.update(id(n) for n in ast.walk(node))
        self._nested = nested
        # node-id -> set of lock ids held (lexically) at that node.
        held: dict = {}
        self.mutations: list = []   # (owner, field, verb, node, held, ctor)
        self.guards: dict = {}      # (owner, field) -> set of lock ids
        self.declared: set = set()  # (owner, field) guards from pragmas
        for node in ast.walk(cls):
            if id(node) in nested:
                continue
            if isinstance(node, ast.With):
                locks = set()
                for item in node.items:
                    hit = _lock_of_with_item(item.context_expr)
                    if hit:
                        locks.add(hit[0])
                if not locks:
                    continue
                for inner in ast.walk(node):
                    if inner is node:
                        continue
                    held.setdefault(id(inner), set()).update(locks)
        self.held = held
        body_nodes = {id(n) for n in cls.body}  # class-body declarations
        for node in ast.walk(cls):
            if id(node) in nested:
                continue
            mut = _mutation_of(node)
            if mut is None:
                continue
            owner, field, verb = mut
            if id(node) in body_nodes:
                continue  # dataclass defaults / class attrs: declarations
            fn = sf.enclosing_function(node)
            in_ctor = fn is not None and fn.name in _CTOR_NAMES
            locks_held = held.get(id(node), set())
            self.mutations.append((owner, field, verb, node, locks_held,
                                   in_ctor))
            for lock in locks_held:
                lowner = lock.rsplit(".", 1)[0]
                if lowner == owner:
                    self.guards.setdefault((owner, field), set()).add(lock)
        # Explicit annotations: on a class-body declaration the owner is
        # 'self' (the instance the lock lives on); on a mutation line the
        # owner comes from the mutation itself.
        decl_fields = {}
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                decl_fields[stmt.lineno] = stmt.target.id
            elif isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        decl_fields[stmt.lineno] = t.id
        lo, hi = cls.lineno, max(getattr(cls, "end_lineno", cls.lineno),
                                 cls.lineno)
        for lineno, lock in annotations.items():
            if not (lo <= lineno <= hi):
                continue
            if lineno in decl_fields:
                self.guards.setdefault(
                    ("self", decl_fields[lineno]), set()).add(lock)
                self.declared.add(("self", decl_fields[lineno]))
                continue
            for owner, field, _verb, node, _held, _ctor in self.mutations:
                if node.lineno == lineno:
                    self.guards.setdefault((owner, field), set()).add(lock)
                    self.declared.add((owner, field))

    def reads_in_test(self, sf) -> list:
        """(owner, field, node, held, func) for every Load of a dotted
        ``owner.field`` inside an ``if``/``while`` TEST expression of
        this class — the check-then-act shape R021 polices."""
        out = []
        for node in ast.walk(self.cls):
            if id(node) in self._nested:
                continue
            if not isinstance(node, (ast.If, ast.While)):
                continue
            for sub in ast.walk(node.test):
                if not isinstance(sub, ast.Attribute) \
                        or not isinstance(sub.ctx, ast.Load):
                    continue
                name = dotted(sub)
                if not name or "." not in name:
                    continue
                owner, field = name.rsplit(".", 1)
                out.append((owner, field, sub,
                            self.held.get(id(sub), set()),
                            sf.enclosing_function(node)))
        return out


def lockset_summary(sf) -> list:
    """The file's guarded-field inventory as plain JSON: one entry per
    (class, owner, field) whose lock discipline R019 establishes —
    inferred from locked mutations or declared via ``guarded-by``
    pragmas.  This is the shared-field inventory a dynamic checker
    seeds its instrumentation from, and the declared bit is what a
    stale-annotation cross-check keys on."""
    out = []
    annotations = _annotations(sf)
    for cls in sf.walk():
        if not isinstance(cls, ast.ClassDef):
            continue
        facts = _ClassFacts(sf, cls, annotations)
        for (owner, field), locks in sorted(facts.guards.items()):
            out.append({
                "class": cls.name,
                "owner": owner,
                "field": field,
                "locks": sorted(locks),
                "declared": (owner, field) in facts.declared,
            })
    return out


@register
class UnguardedLockedField(Rule):
    id = "R019"
    severity = "high"
    title = "mutation of a lock-guarded field outside the lock in serve/"

    def check(self, sf):
        if not sf.rel.startswith(LOCKSET_SCOPE):
            return
        annotations = _annotations(sf)
        for cls in sf.walk():
            if not isinstance(cls, ast.ClassDef):
                continue
            facts = _ClassFacts(sf, cls, annotations)
            for owner, field, verb, node, held, in_ctor in facts.mutations:
                if in_ctor:
                    continue
                locks = facts.guards.get((owner, field))
                if not locks:
                    continue
                if held & locks:
                    continue
                want = " or ".join(sorted(locks))
                yield self.finding(
                    sf, node,
                    f"'{owner}.{field}' {verb} without holding {want}: "
                    f"other mutations in class '{cls.name}' (or an "
                    "explicit guarded-by annotation) establish the "
                    "lock discipline for this field, so this write can "
                    "race the locked ones (lost update / torn read — "
                    "the ServeStats lost-update class); take the lock, "
                    "or justify with an inline disable")
