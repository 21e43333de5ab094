"""The dynamic half of tier 4 -- concheck: deterministic-schedule
concurrency checking of the serving daemon (port of
``cuvite_tpu/analysis/concheck.py``).

R019's lockset inference sees which fields hold their lock; it cannot
see happens-before, lock ordering or interleavings.  concheck runs the
port's real daemon code under the cooperative scheduler of
``serve/sync.py`` and judges what it observes:

  * **Inventory** -- the shared fields to watch come from the R019
    lockset summaries (:func:`cuvite_tpu_torch.analysis.lockset.
    lockset_summary` over ``cuvite_tpu_torch/serve/``): every field
    whose lock discipline the static tier establishes (the ``guarded-by``
    annotations and the inferred ones) is instrumented at run time --
    attribute interception for scalar counters, tracked proxies for
    dict/deque/list fields -- so the static and dynamic tiers watch one
    field set.
  * **Race detection** -- a vector-clock happens-before detector
    (FastTrack-style epochs): two accesses to one field, at least one a
    write, unordered by the edges the scheduler derives from lock
    release/acquire, event set/wait and thread start/join, are a race,
    reported with both access stacks.  The judgment is happens-before,
    not "did the bad interleaving fire", so one schedule can convict a
    race whose loss window is nanoseconds wide.
  * **Annotation cross-check** -- a field declared ``# graftlint:
    guarded-by=X`` whose declared lock no observed access held is a
    stale-annotation warning.
  * **Exploration** -- seeded random-walk and PCT schedules; every
    failing schedule replays from its ``(strategy, seed)`` pair.
    ``CUVITE_SCHED_BUDGET`` sets the schedules a run walks
    (``utils/envknob.env_int``).
  * **Scenarios** -- the daemon's submit/dispatch/drain/stats state
    machine driven end to end with a stub runner on the virtual clock:
    intake threads call the real ``ServeDaemon.handle``, the real
    dispatcher (the serial loop, or the pipelined packer/executor pair)
    runs on managed threads, a drainer races the drain against work in
    flight, and a stats poller reads the snapshot path.  After every
    schedule the job ledger (``done+failed+shed+pending == submitted``)
    and exactly-once delivery on the wire are asserted, and the fake
    clients assert that no lock is held across a socket send (only the
    client's own write lock may be).

Dynamic results are never cached; only the static tier's summaries ride
the incremental lint cache.  The self-check::

    python -m cuvite_tpu_torch.analysis.concheck [--budget N] [--seed S]
        [--scenario NAME] [--replay STRATEGY:SEED] [--format text|json]
        [--list]

runs the clean scenarios expecting zero findings and the known-bug
fixtures (an unlocked ``_routes`` pop, a daemon that sends under its
lock) expecting conviction; exit 1 if either side surprises.  It imports
the serving layer, hence torch, lazily: ``python -m
cuvite_tpu_torch.analysis`` never loads this module.
"""

from __future__ import annotations

import collections
import os
import traceback
import types

from cuvite_tpu_torch.serve import sync

SERVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "serve")

# Schedule budget: how many seeded schedules one explore() run walks.
BUDGET_ENV = "CUVITE_SCHED_BUDGET"
DEFAULT_BUDGET = 240


def schedule_budget(default: int = DEFAULT_BUDGET) -> int:
    from cuvite_tpu_torch.utils.envknob import env_int

    return env_int(BUDGET_ENV, default, minimum=1, maximum=1_000_000)


# ---------------------------------------------------------------------------
# Shared-field inventory (seeded from the R019 lockset summaries)


def serve_inventory(serve_dir: str = SERVE_DIR) -> list:
    """The guarded-field inventory of the real serve/ package: one
    entry per (class, owner expr, field, locks, declared) the static
    lockset tier establishes."""
    from cuvite_tpu_torch.analysis.engine import SourceFile
    from cuvite_tpu_torch.analysis.lockset import lockset_summary

    out = []
    for name in sorted(os.listdir(serve_dir)):
        if not name.endswith(".py"):
            continue
        path = os.path.join(serve_dir, name)
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        rel = f"cuvite_tpu_torch/serve/{name}"
        out.extend(lockset_summary(SourceFile(text, path=path, rel=rel)))
    return out


# ---------------------------------------------------------------------------
# Vector-clock race detection


def _stack(skip: int = 3, limit: int = 14) -> tuple:
    """A compact (file, line, func, source) stack for race reports,
    trimmed to repo frames (the sync/concheck plumbing is noise)."""
    frames = traceback.extract_stack()[:-skip]
    keep = []
    for fr in frames[-limit:]:
        fn = fr.filename.replace(os.sep, "/")
        if fn.endswith(("serve/sync.py", "analysis/concheck.py",
                        "/threading.py")):
            continue
        keep.append((fn.rsplit("cuvite_tpu_torch/", 1)[-1], fr.lineno,
                     fr.name, fr.line or ""))
    return tuple(keep[-8:])


class RaceDetector:
    """FastTrack-style epoch race detection over the scheduler's
    happens-before order (see module docstring).  ``record`` is called
    by Scheduler.access for every annotated shared-field access."""

    def __init__(self):
        # field -> {"w": {tid: (epoch, name, locks, stack)},
        #           "r": {tid: (epoch, name, locks, stack)}}
        self.state: dict = collections.defaultdict(
            lambda: {"w": {}, "r": {}})
        self.races: list = []
        self._seen: set = set()
        # field -> {"declared": set, "held": Counter, "accesses": int}
        self.guard_obs: dict = {}

    def record(self, key: str, kind: str, thread, held, declared) -> None:
        tid = thread.idx
        vc = thread.vc
        st = self.state[key]
        if declared:
            obs = self.guard_obs.setdefault(
                key, {"declared": set(), "held": collections.Counter(),
                      "accesses": 0})
            obs["declared"] |= set(declared)
            obs["held"].update(held)
            obs["accesses"] += 1
        me = (vc.get(tid, 0), thread.name, tuple(held), _stack())
        # A write conflicts with every prior unordered access; a read
        # only with prior unordered writes.
        against = (("w", "r") if kind == "write" else ("w",))
        for side in against:
            for otid, (epoch, oname, olocks, ostack) in st[side].items():
                if otid == tid:
                    continue
                if vc.get(otid, 0) >= epoch:
                    continue            # happens-before: ordered
                okind = "write" if side == "w" else "read"
                sig = (key, ostack[-1:], me[3][-1:], okind, kind)
                if sig in self._seen:
                    continue
                self._seen.add(sig)
                self.races.append({
                    "field": key,
                    "first": {"kind": okind, "thread": oname,
                              "locks": list(olocks),
                              "stack": [list(f) for f in ostack]},
                    "second": {"kind": kind, "thread": me[1],
                               "locks": list(held),
                               "stack": [list(f) for f in me[3]]},
                })
        st["w" if kind == "write" else "r"][tid] = me

    def warnings(self) -> list:
        """Stale guarded-by annotations: a declared lock that NO
        observed access of the field actually held, while the field was
        accessed at least once."""
        out = []
        for key, obs in sorted(self.guard_obs.items()):
            if not obs["accesses"]:
                continue
            never_held = sorted(lk for lk in obs["declared"]
                                if obs["held"].get(lk, 0) == 0)
            if never_held:
                observed = sorted(obs["held"]) or ["<none>"]
                out.append(
                    f"stale guarded-by annotation on {key}: declared "
                    f"{','.join(never_held)} was never held across "
                    f"{obs['accesses']} accesses (observed locks: "
                    f"{','.join(observed)})")
        return out


# ---------------------------------------------------------------------------
# Runtime instrumentation of the inventory


class _TrackedDict(dict):
    """dict proxy reporting reads/writes of the backing field to the
    scheduler (and through it the race detector)."""

    def _cc(self, kind):
        self._cc_sched.access(self._cc_key, kind, self._cc_declared)

    def __getitem__(self, k):
        self._cc("read")
        return dict.__getitem__(self, k)

    def __contains__(self, k):
        self._cc("read")
        return dict.__contains__(self, k)

    def get(self, k, default=None):
        self._cc("read")
        return dict.get(self, k, default)

    def __len__(self):
        self._cc("read")
        return dict.__len__(self)

    def __iter__(self):
        self._cc("read")
        return dict.__iter__(self)

    def values(self):
        self._cc("read")
        return dict.values(self)

    def items(self):
        self._cc("read")
        return dict.items(self)

    def __setitem__(self, k, v):
        self._cc("write")
        dict.__setitem__(self, k, v)

    def __delitem__(self, k):
        self._cc("write")
        dict.__delitem__(self, k)

    def pop(self, k, *default):
        self._cc("write")
        return dict.pop(self, k, *default)

    def clear(self):
        self._cc("write")
        dict.clear(self)

    def update(self, *a, **kw):
        self._cc("write")
        dict.update(self, *a, **kw)

    def setdefault(self, k, default=None):
        self._cc("write")
        return dict.setdefault(self, k, default)


class _TrackedDeque(collections.deque):
    def _cc(self, kind):
        self._cc_sched.access(self._cc_key, kind, self._cc_declared)

    def append(self, x):
        self._cc("write")
        collections.deque.append(self, x)

    def appendleft(self, x):
        self._cc("write")
        collections.deque.appendleft(self, x)

    def pop(self):
        self._cc("write")
        return collections.deque.pop(self)

    def popleft(self):
        self._cc("write")
        return collections.deque.popleft(self)

    def clear(self):
        self._cc("write")
        collections.deque.clear(self)

    def extend(self, it):
        self._cc("write")
        collections.deque.extend(self, it)

    def __iter__(self):
        self._cc("read")
        return collections.deque.__iter__(self)

    def __len__(self):
        self._cc("read")
        return collections.deque.__len__(self)


class _TrackedList(list):
    def _cc(self, kind):
        self._cc_sched.access(self._cc_key, kind, self._cc_declared)

    def append(self, x):
        self._cc("write")
        list.append(self, x)

    def extend(self, it):
        self._cc("write")
        list.extend(self, it)

    def clear(self):
        self._cc("write")
        list.clear(self)

    def pop(self, *a):
        self._cc("write")
        return list.pop(self, *a)

    def __iter__(self):
        self._cc("read")
        return list.__iter__(self)

    def __len__(self):
        self._cc("read")
        return list.__len__(self)


_TRACKED = {dict: _TrackedDict, collections.deque: _TrackedDeque,
            list: _TrackedList}
_attr_subclasses: dict = {}


def _attr_instrumented_class(base: type, fields: frozenset) -> type:
    """A ``base`` subclass whose __getattribute__/__setattr__ report
    accesses to ``fields`` (cached per (base, fields) — instances get
    their scheduler/keys via object.__setattr__'d control attrs)."""
    key = (base, fields)
    sub = _attr_subclasses.get(key)
    if sub is not None:
        return sub
    watched = set(fields)

    def __getattribute__(self, name):
        if name in watched:
            try:
                ctl = object.__getattribute__(self, "_cc_ctl")
            except AttributeError:
                ctl = None
            if ctl is not None:
                k, declared = ctl.fields[name]
                ctl.sched.access(k, "read", declared)
        return base.__getattribute__(self, name)

    def __setattr__(self, name, value):
        if name in watched:
            try:
                ctl = object.__getattribute__(self, "_cc_ctl")
            except AttributeError:
                ctl = None
            if ctl is not None:
                k, declared = ctl.fields[name]
                ctl.sched.access(k, "write", declared)
        base.__setattr__(self, name, value)

    sub = type(f"Concheck{base.__name__}", (base,), {
        "__getattribute__": __getattribute__,
        "__setattr__": __setattr__,
    })
    _attr_subclasses[key] = sub
    return sub


class _Ctl:
    __slots__ = ("sched", "fields")

    def __init__(self, sched, fields):
        self.sched = sched
        self.fields = fields    # attr -> (key, declared lock names)


def _resolve_chain(obj, expr: str):
    """'self.a.b' -> getattr(getattr(obj, 'a'), 'b'); None on a miss."""
    cur = obj
    parts = expr.split(".")
    if parts[0] != "self":
        return None
    for p in parts[1:]:
        cur = getattr(cur, p, None)
        if cur is None:
            return None
    return cur


def instrument(sched, roots, inventory) -> dict:
    """Attach the shared-field inventory to live objects.

    ``roots`` are the objects under test (daemon, server, stats, ...);
    each inventory entry resolves its owner expression against every
    root whose class name matches, locks get canonical
    ``OwnerClass.attr`` names (what the lock-ownership assertions and
    race reports print), and fields are wrapped: container fields with
    tracked proxies, scalars with an attribute-intercepting subclass.
    Returns {field key: declared lock names} for introspection."""
    by_cls: dict = {}
    for r in roots:
        by_cls.setdefault(type(r).__name__, []).append(r)
    # (id(owner), attr) -> (owner, key, declared names)
    plan: dict = {}
    for ent in inventory:
        for root in by_cls.get(ent["class"], ()):
            owner = (root if ent["owner"] == "self"
                     else _resolve_chain(root, ent["owner"]))
            if owner is None:
                continue
            key = f"{type(owner).__name__}.{ent['field']}"
            declared: set = set()
            for lock_expr in ent["locks"]:
                if not lock_expr.startswith("self."):
                    continue            # non-self spellings: unresolvable
                lk = _resolve_chain(root, lock_expr)
                if lk is None:
                    continue
                lk_owner = _resolve_chain(
                    root, lock_expr.rsplit(".", 1)[0]) or owner
                cname = (f"{type(lk_owner).__name__}."
                         f"{lock_expr.rsplit('.', 1)[1]}")
                if hasattr(lk, "name"):
                    lk.name = cname
                declared.add(cname)
            slot = plan.setdefault((id(owner), ent["field"]),
                                   [owner, key, set()])
            slot[2] |= (declared if ent["declared"] else set())
    out: dict = {}
    per_owner: dict = {}
    for (oid, field), (owner, key, declared) in plan.items():
        out[key] = sorted(declared)
        val = owner.__dict__.get(field)
        proxy_cls = _TRACKED.get(type(val))
        if proxy_cls is not None:
            proxy = proxy_cls(val)
            proxy._cc_sched = sched
            proxy._cc_key = key
            proxy._cc_declared = frozenset(declared)
            object.__setattr__(owner, field, proxy)
            continue
        per_owner.setdefault(id(owner), (owner, {}))[1][field] = (
            key, frozenset(declared))
    for owner, fields in per_owner.values():
        sub = _attr_instrumented_class(type(owner),
                                       frozenset(fields))
        object.__setattr__(owner, "_cc_ctl", _Ctl(sched, fields))
        owner.__class__ = sub
    return out


# ---------------------------------------------------------------------------
# The daemon harness


class _FakeConn:
    def close(self):
        pass


class FakeClient:
    """A _Client-shaped sink: records every payload, mimics the write
    lock, and asserts the "no lock held across a socket send"
    claim — a send performed while any lock other than this client's
    own wlock is held is a recorded failure (head-of-line stall: a slow
    peer would block whatever that lock guards)."""

    def __init__(self, sched, idx: int):
        self._sched = sched
        self.idx = idx
        self.conn = _FakeConn()
        # Per-INSTANCE lock name: sending to client B while holding
        # client A's wlock is exactly the cross-client stall the
        # assertion polices, so only this client's own lock is exempt.
        self._wlock_name = f"_Client.wlock#{idx}"
        self.wlock = sync.Lock(name=self._wlock_name)
        self.sent: list = []

    def send(self, payload: dict) -> bool:
        held = [n for n in self._sched.held_lock_names()
                if n != self._wlock_name]
        if held:
            self._sched.record_failure(
                "lock-across-send",
                f"socket send with lock(s) held: {','.join(held)} — a "
                "slow client would head-of-line-stall whatever these "
                "locks guard",
                stack="".join(traceback.format_stack(limit=12)))
        with self.wlock:
            self.sent.append(payload)
        return True


def _stub_runner(graphs, **kw):
    """Deterministic pure-function batch runner (no device work):
    milliseconds per schedule, identical results per graph."""
    import numpy as np

    results = []
    for g in graphs:
        nv = g.num_vertices
        key = int(np.sum(g.tails)) % 997 if g.num_edges else 0
        results.append(types.SimpleNamespace(
            communities=(np.arange(nv) + key) % max(nv, 1),
            modularity=key / 997.0, phases=[1], total_iterations=3,
            num_communities=nv))
    return types.SimpleNamespace(results=results, n_phases=1)


class _StubStreamSession:
    """Device-free StreamSession twin for the streaming scenarios: the
    daemon's ``delta`` verb and the StreamPool's LRU/ledger machinery
    run for real; only the device work (slab upload, chokepoint apply,
    re-cluster) is stubbed — the same seam LouvainServer's injected
    ``runner`` gives the batch scenarios."""

    def __init__(self, graph, tracer=None):
        import numpy as np

        self.nv = graph.num_vertices
        self.ne = graph.num_edges
        self.frontier_frac = 0.0
        self._labels = None
        self._np = np

    def hbm_bytes(self) -> int:
        return 1000

    def labels(self):
        return self._labels

    def apply_delta(self, batch):
        self.ne = self.ne + batch.n_ins - batch.n_del
        self.frontier_frac = 0.25
        return {"n_ins": batch.n_ins, "n_del": batch.n_del,
                "n_del_hit": batch.n_del, "ne": self.ne,
                "frontier_frac": 0.25, "wall_s": 0.0}

    def recluster(self, warm="labels", **kw):
        self._labels = self._np.zeros(self.nv, dtype=self._np.int64)
        return types.SimpleNamespace(
            modularity=0.5, num_communities=1, phases=[1],
            total_iterations=2, communities=self._labels)


def _delta_reqs(n: int, tenant: str, nv: int = 6) -> list:
    """A tenant's delta stream: every request carries the graph spec
    (so an LRU-evicted session transparently re-admits — maximizing
    admit/evict interleavings under a tight budget), the last one also
    re-clusters."""
    reqs = []
    for i in range(n):
        req = {"op": "delta", "tenant": tenant,
               "graph": {"nv": nv, "src": [0, 1, 2], "dst": [1, 2, 3]},
               "ins": [[i % nv, (i + 2) % nv, 1.0]],
               "del": []}
        if i == n - 1:
            req["recluster"] = True
        reqs.append(req)
    return reqs


def _graph_reqs(n_jobs: int, tenant: str, *, with_ids: bool = False,
                nv: int = 6, ne: int = 8) -> list:
    import numpy as np

    reqs = []
    for i in range(n_jobs):
        rng = np.random.default_rng(1000 + i)
        req = {"op": "submit", "graph": {
            "nv": nv,
            "src": [int(x) for x in rng.integers(0, nv, ne)],
            "dst": [int(x) for x in rng.integers(0, nv, ne)],
        }, "tenant": tenant}
        if with_ids:
            req["id"] = f"{tenant}-req-{i}"
        reqs.append(req)
    return reqs


def _racy_route_results(self, finished, fails, sheds):
    """The ``_routes`` race, resurrected as a fixture: lock-free
    pops racing intake's locked check-then-insert.  concheck MUST
    convict this within the default budget (the tier-1 regression
    pin)."""
    for job_id, res in finished:
        client, want_labels = self._routes.pop(job_id, (None, False))
        payload = {"job_id": job_id, "q": float(res.modularity)}
        self._send_or_drop(client, {"result": payload})
    for job_id, err in fails:
        client, _ = self._routes.pop(job_id, (None, False))
        self._send_or_drop(client, {"failed": {"job_id": job_id,
                                               "error": err}})
    for job_id, late_s in sheds:
        client, _ = self._routes.pop(job_id, (None, False))
        self._send_or_drop(client, {"shed": {"job_id": job_id,
                                             "late_s": late_s}})


def _send_under_lock_route_results(self, finished, fails, sheds):
    """A daemon variant that ships results while still holding the
    daemon lock — the head-of-line-stall regression the no-lock-across-
    send assertion exists to catch."""
    for job_id, res in finished:
        with self.lock:
            client, _ = self._routes.pop(job_id, (None, False))
            self._send_or_drop(client, {"result": {"job_id": job_id}})
    for job_id, err in fails:
        with self.lock:
            client, _ = self._routes.pop(job_id, (None, False))
            self._send_or_drop(client, {"failed": {"job_id": job_id,
                                                   "error": err}})
    for job_id, late_s in sheds:
        with self.lock:
            client, _ = self._routes.pop(job_id, (None, False))
            self._send_or_drop(client, {"shed": {"job_id": job_id}})


class DaemonScenario:
    """One explorable daemon workload: intake threads driving the real
    ``handle``, the real dispatcher (the serial loop, or the pipelined
    packer/executor seam-thread pair), a stats poller, and a
    drainer — conservation and exactly-once checked after every
    schedule.  ``pack_hold_s`` injects a virtual-clock sleep INSIDE the
    pack stage (a schedule point mid-pack), so schedules can interleave
    a drain request with an in-flight pack — the
    ``drain-vs-inflight-pack`` target."""

    def __init__(self, name: str, *, n_intake: int = 2, jobs_each: int = 2,
                 fault_plan: str | None = None, variant=None,
                 drain_after_s: float = 0.03, with_ids: bool = False,
                 b_max: int = 2, linger_s: float = 0.02,
                 max_retries: int = 2, retry_base_s: float = 0.05,
                 pipelined: bool = False, pack_hold_s: float = 0.0,
                 delta_tenants: int = 0, deltas_each: int = 0,
                 stream_budget_bytes: int | None = None,
                 merge_packing: bool = False, big_jobs: int = 0):
        self.name = name
        self.n_intake = n_intake
        self.jobs_each = jobs_each
        self.fault_plan = fault_plan
        self.variant = variant
        self.drain_after_s = drain_after_s
        self.with_ids = with_ids
        self.b_max = b_max
        self.linger_s = linger_s
        self.max_retries = max_retries
        self.retry_base_s = retry_base_s
        self.pipelined = pipelined
        self.pack_hold_s = pack_hold_s
        # Streaming arm: delta_tenants reader threads each
        # driving deltas_each `delta` requests through the REAL
        # _handle_delta/StreamPool path with stub sessions; a tight
        # stream_budget_bytes forces LRU evictions mid-schedule.
        self.delta_tenants = delta_tenants
        self.deltas_each = deltas_each
        self.stream_budget_bytes = stream_budget_bytes
        # Merge-aware packer arm: an extra intake thread
        # submits ``big_jobs`` larger-class graphs; once a plain big
        # batch completes, overflowing small bins may pop PAST b_max
        # and dispatch merged.  ``merged_batches_seen`` accumulates
        # across schedules so the tier-1 test can assert the scenario
        # actually exercises the merge path (teeth), not just that it
        # stays clean.
        self.merge_packing = merge_packing
        self.big_jobs = big_jobs
        self.merged_batches_seen = 0
        self.inventory = None   # filled by explore()/run_schedule()

    def setup(self, sched) -> dict:
        from cuvite_tpu_torch.serve.daemon import ServeDaemon
        from cuvite_tpu_torch.serve.faults import FaultPlan
        from cuvite_tpu_torch.serve.queue import LouvainServer, ServeConfig

        server = LouvainServer(
            ServeConfig(b_max=self.b_max, linger_s=self.linger_s,
                        engine="fused", max_retries=self.max_retries,
                        retry_base_s=self.retry_base_s,
                        merge_packing=self.merge_packing,
                        stream_budget_bytes=(self.stream_budget_bytes
                                             or 256 << 20)),
            clock=sched.clock, sleep=sched.sleep,
            faults=FaultPlan.parse(self.fault_plan),
            runner=_stub_runner,
            stream_factory=(_StubStreamSession if self.deltas_each
                            else None))
        daemon = ServeDaemon(server, sock_path="<concheck>",
                             poll_s=0.01, pipelined=self.pipelined)
        for attr in ("_wake", "_drain_req", "_done"):
            getattr(daemon, attr).name = f"ServeDaemon.{attr}"
        daemon.lock.name = "ServeDaemon.lock"
        server.streams.lock.name = "StreamPool.lock"
        if self.pack_hold_s:
            # The hold runs on the server's (scheduler) sleep: a
            # schedule point inside the pack window, BEFORE the real
            # pack — every interleaving of drain-vs-pack is reachable.
            orig_pack = server.pack_batch

            def holding_pack(jobs, key, trigger, now):
                server.sleep(self.pack_hold_s)
                return orig_pack(jobs, key, trigger, now)

            server.pack_batch = holding_pack
        if self.variant is not None:
            daemon._route_results = types.MethodType(self.variant, daemon)
        inventory = self.inventory or serve_inventory()
        instrument(sched, [daemon, server, server.stats, server.streams],
                   inventory)
        clients = [FakeClient(sched, i) for i in range(self.n_intake)]
        acks: dict = {}
        delta_resps: list = []

        def intake(client, reqs):
            for req in reqs:
                resp = daemon.handle(req, client)
                if resp.get("ok") and "job_id" in resp:
                    acks[resp["job_id"]] = client

        def delta_intake(client, reqs):
            for req in reqs:
                delta_resps.append(daemon.handle(req, client))

        def poller():
            for _ in range(2):
                daemon.handle({"op": "stats"}, clients[0])

        def drainer():
            sched.sleep(self.drain_after_s)
            daemon.request_drain()

        if self.pipelined:
            pipe = daemon.pipe
            pipe.handoff._cond.lock.name = "Handoff.lock"
            daemon._dispatch_thread = sched.spawn(
                pipe._exec_loop, name="executor")
            pipe.pack_thread = sched.spawn(pipe._pack_loop, name="packer")
        else:
            daemon._dispatch_thread = sched.spawn(
                daemon._dispatch_loop, name="dispatch")
        for i, client in enumerate(clients):
            sched.spawn(intake, name=f"intake{i}", args=(
                client, _graph_reqs(self.jobs_each, f"t{i}",
                                    with_ids=self.with_ids)))
        if self.big_jobs:
            # Larger-class intake: nv=8192 with ~9k arcs
            # symmetrizes past the 16384-edge floor, landing in
            # (8192, 32768) — an exact n_sub=2 sub-row multiple of the
            # small graphs' (4096, 16384) floor class.  Schedules where
            # the big plain batch completes before the small bin
            # overflows dispatch a MERGED small batch; the others serve
            # plain — conservation/exactly-once must hold in both.
            sched.spawn(intake, name="intake-big", args=(
                clients[0], _graph_reqs(self.big_jobs, "big",
                                        with_ids=self.with_ids,
                                        nv=8192, ne=9000)))
        for t in range(self.delta_tenants):
            sched.spawn(delta_intake, name=f"delta{t}", args=(
                clients[0], _delta_reqs(self.deltas_each, f"d{t}")))
        sched.spawn(poller, name="poller")
        sched.spawn(drainer, name="drainer")
        return {"daemon": daemon, "server": server, "clients": clients,
                "acks": acks, "delta_resps": delta_resps}

    def check(self, sched, ctx) -> None:
        daemon, server = ctx["daemon"], ctx["server"]
        self.merged_batches_seen += int(server.stats.merged_batches)
        if not daemon._done.is_set():
            sched.record_failure(
                "no-drain", "dispatcher never completed the drain")
            return
        cons = server.conservation()
        if not cons["ok"] or cons["pending"] != 0:
            sched.record_failure(
                "conservation", f"job ledger broken after drain: {cons}")
        terminal: collections.Counter = collections.Counter()
        for client in ctx["clients"]:
            for payload in client.sent:
                for kind in ("result", "failed", "shed"):
                    if kind in payload:
                        terminal[payload[kind]["job_id"]] += 1
        for job_id in ctx["acks"]:
            n = terminal.get(job_id, 0)
            if n != 1:
                sched.record_failure(
                    "exactly-once",
                    f"job {job_id} produced {n} terminal reports "
                    "(want exactly 1)")
        for job_id in terminal:
            if job_id not in ctx["acks"]:
                sched.record_failure(
                    "phantom-result",
                    f"terminal report for never-acked job {job_id}")
        if self.deltas_each:
            # Tenant deltas racing drain + LRU eviction:
            # every delta request terminates exactly once (a dict reply,
            # ok or a loud refusal — never dropped, never doubled), the
            # stream pool's byte ledger conserves, and _finalize cleared
            # all residency.
            want = self.delta_tenants * self.deltas_each
            resps = ctx["delta_resps"]
            if len(resps) != want or not all(
                    isinstance(r, dict) for r in resps):
                sched.record_failure(
                    "delta-exactly-once",
                    f"{len(resps)}/{want} delta replies "
                    f"(non-dict: {sum(not isinstance(r, dict) for r in resps)})")
            scons = server.streams.conservation()
            if not scons["ok"]:
                sched.record_failure(
                    "stream-conservation",
                    f"stream pool ledger broken after drain: {scons}")
            elif scons["resident"] != 0:
                sched.record_failure(
                    "stream-residency",
                    f"{scons['resident']} sessions survived _finalize "
                    "(pool.clear() missed them)")


# ---------------------------------------------------------------------------
# Exploration driver


class ScheduleReport:
    def __init__(self, *, scenario, strategy, seed, failures, races,
                 warnings, signature, steps, trace):
        self.scenario = scenario
        self.strategy = strategy
        self.seed = seed
        self.failures = failures
        self.races = races
        self.warnings = warnings
        self.signature = signature
        self.steps = steps
        self.trace = trace

    @property
    def clean(self) -> bool:
        return not self.failures and not self.races


class ExploreReport:
    def __init__(self, scenario: str):
        self.scenario = scenario
        self.schedules = 0
        self.distinct = 0
        self.steps = 0
        self.failing: list = []     # ScheduleReports with findings
        self.warnings: list = []
        self._sigs: set = set()

    @property
    def clean(self) -> bool:
        return not self.failing

    def races(self) -> list:
        return [r for rep in self.failing for r in rep.races]

    def failures(self) -> list:
        return [f for rep in self.failing for f in rep.failures]

    def summary(self) -> dict:
        return {
            "scenario": self.scenario,
            "schedules": self.schedules,
            "distinct_interleavings": self.distinct,
            "steps": self.steps,
            "failing_schedules": len(self.failing),
            "races": len(self.races()),
            "warnings": list(self.warnings),
            "replay": [{"strategy": rep.strategy, "seed": rep.seed}
                       for rep in self.failing[:8]],
        }


def run_schedule(scenario: DaemonScenario, *, seed: int,
                 strategy: str = "random",
                 max_steps: int = 50000) -> ScheduleReport:
    """ONE schedule, fully determined by (scenario, strategy, seed) —
    the replay unit every failure report names."""
    detector = RaceDetector()
    sched = sync.Scheduler(seed=seed, strategy=strategy,
                           max_steps=max_steps, detector=detector)
    with sync.activated(sched):
        ctx = scenario.setup(sched)
    sched.run()
    scenario.check(sched, ctx)
    return ScheduleReport(
        scenario=scenario.name, strategy=strategy, seed=seed,
        failures=list(sched.failures), races=list(detector.races),
        warnings=detector.warnings(), signature=sched.signature(),
        steps=sched.steps, trace=list(sched.trace))


def explore(scenario: DaemonScenario, *, budget: int | None = None,
            seed: int = 0, strategies=("random", "pct"),
            stop_on_failure: bool = False, tracer=None) -> ExploreReport:
    """Walk ``budget`` seeded schedules of ``scenario``; every failing
    schedule is kept with its (strategy, seed) replay handle.  Results
    are NEVER cached — each call explores live."""
    if budget is None:
        budget = schedule_budget()
    if scenario.inventory is None:
        scenario.inventory = serve_inventory()
    report = ExploreReport(scenario.name)
    warned: set = set()
    for i in range(budget):
        strat = strategies[i % len(strategies)]
        s_seed = seed * 1_000_003 + i
        rep = run_schedule(scenario, seed=s_seed, strategy=strat)
        report.schedules += 1
        report.steps += rep.steps
        report._sigs.add(rep.signature)
        for w in rep.warnings:
            if w not in warned:
                warned.add(w)
                report.warnings.append(w)
        if not rep.clean:
            report.failing.append(rep)
            if tracer is not None:
                tracer.event("sched_trace", scenario=scenario.name,
                             strategy=strat, seed=s_seed,
                             steps=rep.steps,
                             failures=[f["kind"] for f in rep.failures],
                             races=[r["field"] for r in rep.races])
            if stop_on_failure:
                break
    report.distinct = len(report._sigs)
    if tracer is not None:
        tracer.event("concheck_explore", **report.summary())
    return report


# ---------------------------------------------------------------------------
# The scenario registry + self-check CLI


def builtin_scenarios() -> dict:
    """name -> (scenario factory, expectation).  'clean' scenarios must
    explore with zero findings; 'detect' fixtures resurrect known bugs
    and MUST be convicted — a checker that stops seeing them is broken
    (the true-positive/true-negative pair)."""
    return {
        "clean": (lambda: DaemonScenario(
            "clean", n_intake=2, jobs_each=2, with_ids=True), "clean"),
        "faulty-clean": (lambda: DaemonScenario(
            "faulty-clean", n_intake=2, jobs_each=2,
            fault_plan="device:transient:n=1"), "clean"),
        "drain-vs-retry": (lambda: DaemonScenario(
            "drain-vs-retry", n_intake=1, jobs_each=2,
            fault_plan="device:transient:n=1", drain_after_s=0.06,
            retry_base_s=0.08), "clean"),
        # The pipelined dispatcher: packer + executor seam
        # threads, intake, stats poller and drainer all interleaved.
        "pipeline-clean": (lambda: DaemonScenario(
            "pipeline-clean", n_intake=2, jobs_each=2, with_ids=True,
            pipelined=True), "clean"),
        "pipeline-faulty": (lambda: DaemonScenario(
            "pipeline-faulty", n_intake=2, jobs_each=2, pipelined=True,
            fault_plan="device:transient:n=1;pack:transient:n=1"),
            "clean"),
        # Drain requested while a pack is IN FLIGHT (pack_hold_s parks
        # the packer mid-pack at a schedule point; the drain deadline
        # lands INSIDE that virtual hold window): the packed batch must
        # flush through the handoff slot exactly once, then the bins —
        # never dropped, never executed twice.
        "drain-vs-inflight-pack": (lambda: DaemonScenario(
            "drain-vs-inflight-pack", n_intake=1, jobs_each=2,
            pipelined=True, pack_hold_s=0.05, drain_after_s=0.02,
            linger_s=0.01), "clean"),
        # Tenant `delta` requests racing the daemon drain AND
        # LRU eviction: the 1500-byte budget vs 1000-byte stub sessions
        # forces admit/evict churn between the two tenants while the
        # drainer pulls the rug.  Every delta terminates exactly once
        # with the stream ledger conserved.
        "delta-vs-drain": (lambda: DaemonScenario(
            "delta-vs-drain", n_intake=1, jobs_each=1, delta_tenants=2,
            deltas_each=3, stream_budget_bytes=1500,
            drain_after_s=0.02), "clean"),
        # The merge-aware packer: three small jobs against
        # b_max=2 overflow-merge into the big class certified by the
        # intake-big thread's plain batch.  Merged pops take jobs past
        # b_max in one dispatch; conservation and exactly-once must
        # survive every interleaving of the certifying big batch with
        # the small bin's overflow.
        "merge-pack-clean": (lambda: DaemonScenario(
            "merge-pack-clean", n_intake=1, jobs_each=3, with_ids=True,
            merge_packing=True, big_jobs=2), "clean"),
        "racy-routes": (lambda: DaemonScenario(
            "racy-routes", variant=_racy_route_results), "detect"),
        "send-under-lock": (lambda: DaemonScenario(
            "send-under-lock", variant=_send_under_lock_route_results),
            "detect"),
    }


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.analysis.concheck",
        description="concheck: deterministic-schedule concurrency "
                    "self-check for the serving daemon (graftlint "
                    "tier 4)")
    ap.add_argument("--budget", type=int, default=None,
                    help=f"schedules per scenario (default: "
                         f"${BUDGET_ENV} or {DEFAULT_BUDGET})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenario", default="all",
                    help="one scenario name, or 'all'")
    ap.add_argument("--replay", metavar="STRATEGY:SEED", default=None,
                    help="replay ONE schedule of --scenario from its "
                         "(strategy, raw seed) pair — the handle every "
                         "failure report prints — and show its findings")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    scenarios = builtin_scenarios()
    if args.list:
        for name, (_f, expect) in scenarios.items():
            print(f"{name:18s} expect={expect}")
        return 0
    names = (list(scenarios) if args.scenario == "all"
             else [args.scenario])
    bad = [n for n in names if n not in scenarios]
    if bad:
        ap.error(f"unknown scenario(s) {bad}; have {sorted(scenarios)}")
    if args.replay is not None:
        if args.scenario == "all" or len(names) != 1:
            ap.error("--replay needs a single --scenario NAME")
        strat, _, raw = args.replay.partition(":")
        try:
            s_seed = int(raw)
        except ValueError:
            ap.error(f"--replay wants STRATEGY:SEED, got {args.replay!r}")
        scenario = scenarios[names[0]][0]()
        scenario.inventory = serve_inventory()
        rep = run_schedule(scenario, seed=s_seed, strategy=strat)
        print(f"concheck replay {names[0]} {strat}:{s_seed}: "
              f"{rep.steps} steps, {len(rep.failures)} failure(s), "
              f"{len(rep.races)} race(s)")
        for f in rep.failures:
            print(f"  {f['kind']}: {f['message']}")
        for r in rep.races:
            print(f"  race on {r['field']}: "
                  f"{r['first']['kind']}@{r['first']['thread']} vs "
                  f"{r['second']['kind']}@{r['second']['thread']}")
        return 0 if rep.clean else 1
    budget = args.budget if args.budget is not None else schedule_budget()
    inventory = serve_inventory()
    rc = 0
    results = []
    for name in names:
        factory, expect = scenarios[name]
        scenario = factory()
        scenario.inventory = inventory
        rep = explore(scenario, budget=budget, seed=args.seed,
                      stop_on_failure=(expect == "detect"))
        ok = rep.clean if expect == "clean" else not rep.clean
        results.append((name, expect, ok, rep))
        if not ok:
            rc = 1
    if args.format == "json":
        print(json.dumps([dict(rep.summary(), expect=expect, ok=ok)
                          for name, expect, ok, rep in results], indent=2))
        return rc
    for name, expect, ok, rep in results:
        verdict = "ok" if ok else "FAIL"
        print(f"concheck {name}: {verdict} — {rep.schedules} schedules "
              f"({rep.distinct} distinct), {len(rep.failing)} failing, "
              f"{len(rep.races())} race(s), expect={expect}")
        for w in rep.warnings:
            print(f"  warning: {w}")
        if not ok:
            for frep in rep.failing[:3]:
                print(f"  replay: --scenario {name} "
                      f"--replay {frep.strategy}:{frep.seed}")
                for f in frep.failures[:3]:
                    print(f"    {f['kind']}: {f['message']}")
                for r in frep.races[:3]:
                    print(f"    race on {r['field']}: "
                          f"{r['first']['kind']}@{r['first']['thread']} "
                          f"vs {r['second']['kind']}@"
                          f"{r['second']['thread']}")
    print(f"concheck: {'ok' if rc == 0 else 'FAIL'}")
    return rc


if __name__ == "__main__":
    import sys

    sys.exit(main())
