"""Deterministic fault injection for the serving dispatch path (port of
``cuvite_tpu/serve/faults.py``, stdlib only; a plan string fires at the
same passages on both packages).

A plan is a string (``--fault-plan`` or ``CUVITE_FAULT_PLAN``)::

    dispatch:raise:every=7            # every 7th dispatch raises (permanent)
    device:transient:n=2              # the first 2 device passages fail
    pack:transient:p=0.1,seed=42      # seeded coin-flip per passage
    unpack:raise:n=1;device:transient:every=5   # ';' joins directives

Grammar: directives separated by ``;`` (or newlines), each
``site:kind[:key=value[,key=value...]]``.  Sites are the points of the
queue's dispatch path (:data:`FAULT_SITES`); kinds are ``transient`` (the
dispatcher retries with exponential backoff on the injectable clock) and
``raise`` (permanent: poison isolation splits the batch, batchmates
survive, the job fails exactly once).  Selectors: ``every=N``, ``n=N``
(the first N passages), ``p=F`` with optional ``seed=S`` (an independent
``random.Random(S)`` coin per passage).  A plan is pure bookkeeping until
``check()`` raises.
"""

from __future__ import annotations

import dataclasses
import os
import random

# Named injection points in the dispatch path, in path order:
#   submit   — intake, after admission but BEFORE the job is accounted:
#              the submit call raises, the job never enqueues, and the
#              conservation ledger counts it as REJECTED (jobs_rejected,
#              a 'reject' event with reason=injected-fault — see
#              LouvainServer.submit);
#   pack     — batch assembly (shape union / slab packing decisions);
#   dispatch — immediately before the batched driver is invoked;
#   device   — wraps the driver invocation itself (the "device fell over"
#              stand-in);
#   unpack   — after the driver returns, before per-tenant results are
#              emitted.
FAULT_SITES = ("submit", "pack", "dispatch", "device", "unpack")

FAULT_KINDS = ("transient", "raise")

ENV_VAR = "CUVITE_FAULT_PLAN"


class InjectedFault(RuntimeError):
    """A fault fired by the plan.  ``permanent`` decides the recovery
    path: transient -> bounded retry with backoff; permanent -> poison
    isolation (split the batch, fail the job)."""

    def __init__(self, site: str, kind: str, seq: int, permanent: bool):
        self.site = site
        self.kind = kind
        self.seq = seq
        self.permanent = permanent
        flavor = "permanent" if permanent else "transient"
        super().__init__(
            f"injected {flavor} fault at site '{site}' (passage {seq})")


@dataclasses.dataclass
class FaultRule:
    """One parsed directive.  Exactly one selector is set."""

    site: str
    kind: str                 # 'transient' | 'raise'
    every: int | None = None  # fire on every Nth passage
    n: int | None = None      # fire on the first N passages
    p: float | None = None    # seeded coin-flip per passage
    seed: int = 0
    fired: int = 0            # bookkeeping for chaos-test assertions

    @property
    def permanent(self) -> bool:
        return self.kind == "raise"

    def spec(self) -> str:
        if self.every is not None:
            sel = f"every={self.every}"
        elif self.n is not None:
            sel = f"n={self.n}"
        else:
            sel = f"p={self.p},seed={self.seed}"
        return f"{self.site}:{self.kind}:{sel}"


def _parse_directive(text: str) -> FaultRule:
    parts = text.split(":")
    if len(parts) != 3:
        raise ValueError(
            f"fault directive {text!r}: want 'site:kind:key=value[,...]' "
            f"(sites {FAULT_SITES}, kinds {FAULT_KINDS})")
    site, kind, params = (p.strip() for p in parts)
    if site not in FAULT_SITES:
        raise ValueError(
            f"fault directive {text!r}: unknown site {site!r} "
            f"(want one of {FAULT_SITES})")
    if kind not in FAULT_KINDS:
        raise ValueError(
            f"fault directive {text!r}: unknown kind {kind!r} "
            f"(want one of {FAULT_KINDS})")
    rule = FaultRule(site=site, kind=kind)
    selectors = 0
    for kv in filter(None, (s.strip() for s in params.split(","))):
        key, _, value = kv.partition("=")
        try:
            if key == "every":
                rule.every = int(value)
                selectors += 1
                if rule.every < 1:
                    raise ValueError
            elif key == "n":
                rule.n = int(value)
                selectors += 1
                if rule.n < 1:
                    raise ValueError
            elif key == "p":
                rule.p = float(value)
                selectors += 1
                if not 0.0 <= rule.p <= 1.0:
                    raise ValueError
            elif key == "seed":
                rule.seed = int(value)
            else:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"fault directive {text!r}: bad parameter {kv!r} "
                "(want every=N>=1 | n=N>=1 | p=F in [0,1] [,seed=S])"
            ) from None
    if selectors != 1:
        raise ValueError(
            f"fault directive {text!r}: exactly one selector "
            "(every=/n=/p=) required")
    return rule


class FaultPlan:
    """A parsed set of fault rules with per-site passage counters.

    ``check(site)`` advances the site's counter and raises
    :class:`InjectedFault` when any rule elects this passage (first
    matching rule in plan order wins; its ``fired`` count increments
    either way the exception is later handled).  With no rules on the
    site it is a cheap no-op — the queue threads ``check`` calls
    unconditionally.
    """

    def __init__(self, rules: list | None = None):
        self.rules = list(rules or [])
        self.counts: dict[str, int] = {s: 0 for s in FAULT_SITES}
        self._by_site: dict[str, list] = {}
        self._rng: dict[int, random.Random] = {}
        for rule in self.rules:
            self._by_site.setdefault(rule.site, []).append(rule)
            if rule.p is not None:
                self._rng[id(rule)] = random.Random(rule.seed)

    @classmethod
    def parse(cls, spec: str | None) -> "FaultPlan":
        """Parse a plan string (None/'' -> empty plan; ValueError on a
        malformed directive — a typo'd plan must never silently run
        fault-free while the operator believes chaos is on)."""
        rules = []
        for chunk in (spec or "").replace("\n", ";").split(";"):
            chunk = chunk.strip()
            if chunk:
                rules.append(_parse_directive(chunk))
        return cls(rules)

    @classmethod
    def from_env(cls, env_var: str = ENV_VAR) -> "FaultPlan":
        return cls.parse(os.environ.get(env_var))

    def __bool__(self) -> bool:
        return bool(self.rules)

    def check(self, site: str) -> None:
        """One passage through ``site``; raises when a rule elects it."""
        rules = self._by_site.get(site)
        if not rules:
            return
        self.counts[site] += 1
        seq = self.counts[site]
        for rule in rules:
            if rule.every is not None:
                hit = seq % rule.every == 0
            elif rule.n is not None:
                hit = seq <= rule.n
            else:
                # Independent per-rule stream: other rules / sites can
                # never perturb this rule's draw sequence.
                hit = self._rng[id(rule)].random() < rule.p
            if hit:
                rule.fired += 1
                raise InjectedFault(site, rule.kind, seq, rule.permanent)

    def spec(self) -> str:
        return ";".join(r.spec() for r in self.rules)
