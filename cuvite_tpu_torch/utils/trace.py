"""Stage timers, counters, the span/event seam and per-shard diagnostic
files (port of ``cuvite_tpu/utils/trace.py:21-255``: ``rss_high_water_mb``,
``Tracer``, ``NullTracer``, ``ShardDiag``).

A :class:`Tracer` accumulates named stage timers (host wall clock) and
counters, and is the facade over the flight recorder
(``obs.FlightRecorder``): attach one and every ``stage()`` window also
becomes a nested span in the structured trace, ``event()`` /
``begin_span()`` forward to its emitter, ``set_phase()`` tags the records
with the running phase, and ``track()`` / ``ledger_*()`` feed its
device-memory ledger.  Without a recorder those calls are no-ops, so the
drivers thread them unconditionally.  None of them reads a device value:
``track`` reads tensor metadata, and the drivers hand counters and events
host values they already hold.

Stages on the profiler's clock.  While a ``torch.profiler`` records, every
``stage()`` window of an enabled tracer, and every ``begin_span()`` /
``end_span()`` pair, also opens a ``torch.profiler.record_function``
range named ``cuvite/<name>``, so the device trace names the host stage
behind each launch and each idle gap.  With no profiler recording no
range object is built, and this module never imports torch itself.

The drivers' stages (:attr:`Tracer.CANONICAL_STAGES` and ``plan``,
``evaluate``, ``color``) split a run into its pipeline.  Inside and
between them the drivers open the fine stages of
:attr:`Tracer.FINE_STAGES`, which name where the card waits on the host:

  * ``start``     -- a solve's set-up before its first plan (the fused
                     engine's sum of the weights for 1/(2m));
  * ``sweep``     -- one round of a sweep loop (``louvain/loop.py``, and
                     each round over a batch's blocks in
                     ``louvain/batched.py``);
  * ``host_read`` -- one blocking read of the card (a ``.tolist()``,
                     ``.cpu()``, ``nonzero`` or synchronous upload);
  * ``renumber``  -- a gained phase's label renumber and composition;
  * ``finish``    -- the end of a solve: the final Q, renumber and label
                     gather.

Any other stage opened inside an ``iterate`` on the same thread is a fine
stage too: a batch (``louvain_many``) times each phase's batched
coarsening as stage ``coarsen`` there.  Fine stages count in
:attr:`Tracer.fine_times` and :attr:`Tracer.fine_calls` and get their
ranges, but stay out of ``times``, ``calls``, the flight recorder's
spans, :meth:`Tracer.breakdown` and :meth:`Tracer.report`, which read
the drivers' stages as they did before the fine ones existed.

To read idle by stage, run a traced solve under the profiler and export
its Chrome trace::

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cli.main(["--rmat", "20", "--trace"])   # or louvain_phases(
                                                 # g, tracer=Tracer())
    prof.export_chrome_trace("trace.json")

Each gap between the card's kernels falls under the innermost
``cuvite/`` range open on the host: that stage is what the card waited
on.

:func:`dist_stats_report` prints a partition's edge distribution, and
:class:`ShardDiag` writes the per-shard files of ``--diag-prefix``.
"""

from __future__ import annotations

import contextlib
import math
import os
import resource
import sys
import threading
import time

RANGE_PREFIX = "cuvite/"


def _profiler_range(name: str):
    """An entered ``record_function`` range ``cuvite/<name>`` while a
    torch profiler records, else None (no range object built)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rng = torch.profiler.record_function(RANGE_PREFIX + name)
    rng.__enter__()
    return rng


class _RangedSpan:
    """A ``begin_span`` handle that also holds the span's profiler range."""

    __slots__ = ("sid", "rng")

    def __init__(self, sid, rng):
        self.sid = sid
        self.rng = rng


def rss_high_water_mb() -> float:
    """Peak resident set size of this process in MiB (getrusage)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    # ru_maxrss is KiB on Linux.
    return ru.ru_maxrss / 1024.0


def dist_stats_report(dg, ghost_counts=None) -> str:
    """Edge distribution of a DistGraph partition (reference
    ``dist_stats_report``, ``cuvite_tpu/utils/trace.py:183``; the
    reference application's PRINT_DIST_STATS block): min, max, mean,
    variance and standard deviation of the shards' edge counts, and the
    ghost counts of the phase's exchange plan when there is one."""
    counts = ([sh.n_real_edges for sh in dg.shards] if dg.shards
              else [dg.graph.num_edges])
    n = max(len(counts), 1)
    mean = sum(counts) / n
    avg_sq = sum(c * c for c in counts) / n
    var = abs(avg_sq - mean * mean)
    lines = [
        "-" * 55,
        "Graph edge distribution characteristics",
        "-" * 55,
        f"Number of vertices: {dg.graph.num_vertices}",
        f"Number of edges: {dg.graph.num_edges}",
        f"Number of shards: {dg.nshards}",
        f"Maximum number of edges: {max(counts)}",
        f"Minimum number of edges: {min(counts)}",
        f"Mean number of edges: {mean:g}",
        f"Variance: {var:g}",
        f"Standard deviation: {math.sqrt(var):g}",
    ]
    if ghost_counts is not None:
        lines.append(
            f"Ghost vertices per shard: max {max(ghost_counts)}, "
            f"min {min(ghost_counts)}, "
            f"mean {sum(ghost_counts) / max(len(ghost_counts), 1):g}")
    lines.append("-" * 55)
    return "\n".join(lines)


class Tracer:
    """Accumulating named stage timers and counters, and the facade over
    an optional recorder (module note).

    Usage::

        tr = Tracer()
        with tr.stage("load"):
            ...
        tr.count("iterations", n)
        print(tr.report())
    """

    # Stage names the drivers use, in pipeline order: always present in
    # :meth:`breakdown` (0.0 when the stage never ran).  As in the
    # reference, coalesce runs nested inside coarsen (coarsen_s contains
    # coalesce_s, 0.0 on host coarsening), and upload and rebin nested
    # inside the per-graph driver's plan stage (plan_s contains them).
    CANONICAL_STAGES = ("coarsen", "coalesce", "rebin", "upload",
                        "iterate")
    # Stages timed and ranged but kept out of times, calls, the
    # recorder's spans, breakdown() and report(), as is any other stage
    # opened inside an iterate (module note).
    FINE_STAGES = frozenset(("start", "sweep", "host_read", "renumber",
                             "finish"))

    def __init__(self, enabled: bool = True, recorder=None):
        # A recorder implies recording: its spans report stage times.
        self.enabled = enabled or recorder is not None
        self.recorder = recorder
        self.emitter = recorder.emitter if recorder is not None else None
        self.times: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.fine_times: dict[str, float] = {}
        self.fine_calls: dict[str, int] = {}
        self.counters: dict[str, float] = {}
        self._iterating: set = set()   # threads inside an iterate stage

    @contextlib.contextmanager
    def stage(self, name: str, into: dict | None = None):
        """Time a window as stage ``name``.  ``into``: a dict that also
        accumulates the window's seconds under ``name`` (a driver's
        ``PhaseStats.stages``), timed by the same clock, with or without
        an enabled tracer."""
        if not self.enabled and into is None:
            yield
            return
        fine = outer = False
        if self.enabled:
            me = threading.get_ident()
            inside = me in self._iterating
            fine = name in self.FINE_STAGES or (inside and name != "iterate")
            outer = name == "iterate" and not inside
            if outer:
                self._iterating.add(me)
        em = None if fine else self.emitter
        sid = em.begin(name) if em is not None else None
        rng = _profiler_range(name) if self.enabled else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rng is not None:
                rng.__exit__(None, None, None)
            if em is not None:
                em.end(sid, dur_s=dt)
            if into is not None:
                into[name] = into.get(name, 0.0) + dt
            if self.enabled:
                times, calls = ((self.fine_times, self.fine_calls) if fine
                                else (self.times, self.calls))
                times[name] = times.get(name, 0.0) + dt
                calls[name] = calls.get(name, 0) + 1
            if outer:
                self._iterating.discard(me)

    def count(self, name: str, value: float = 1) -> None:
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + value

    # -- recorder facade (no-ops without an attached recorder) --------------

    def event(self, name: str, **attrs) -> None:
        """A point event in the structured trace."""
        if self.emitter is not None:
            self.emitter.event(name, **attrs)

    def begin_span(self, name: str, **attrs):
        """Open a span whose extent is not a ``with`` block; returns a
        handle for :meth:`end_span`.  Its profiler range (module note)
        ends where :meth:`end_span` is called."""
        sid = (self.emitter.begin(name, **attrs)
               if self.emitter is not None else None)
        rng = _profiler_range(name) if self.enabled else None
        return sid if rng is None else _RangedSpan(sid, rng)

    def end_span(self, handle, **attrs) -> None:
        if isinstance(handle, _RangedSpan):
            handle.rng.__exit__(None, None, None)
            handle = handle.sid
        if self.emitter is not None and handle is not None:
            self.emitter.end(handle, **attrs)

    def set_phase(self, phase) -> None:
        """Tag subsequent records with the running phase index."""
        if self.emitter is not None:
            self.emitter.phase = phase

    def track(self, category: str, *buffers) -> None:
        """Account device buffers to the memory ledger by category."""
        if self.recorder is not None:
            self.recorder.ledger.track(category, *buffers)

    def ledger_phase_begin(self) -> None:
        if self.recorder is not None:
            self.recorder.ledger.begin_phase()

    def ledger_snapshot(self, phase=None) -> None:
        """Snapshot the ledger at a phase boundary and emit it as an
        ``hbm`` event."""
        if self.recorder is not None:
            snap = self.recorder.ledger.snapshot(phase)
            self.event("hbm", **snap)

    def breakdown(self) -> dict:
        """Per-stage seconds, full precision: ``<stage>_s`` for every
        CANONICAL_STAGES entry and every other recorded stage."""
        out = {k + "_s": self.times.get(k, 0.0)
               for k in self.CANONICAL_STAGES}
        for k, v in sorted(self.times.items()):
            out.setdefault(k + "_s", v)
        return out

    def teps(self) -> float:
        """Traversed edges per second: counter 'traversed_edges' over the
        'iterate' stage's wall time."""
        t = self.times.get("iterate", 0.0)
        return self.counters.get("traversed_edges", 0.0) / t if t else 0.0

    def report(self) -> str:
        lines = ["stage breakdown (s):"]
        total = sum(self.times.values())
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"  {name:<16} {t:9.3f}  ({self.calls[name]}x, "
                f"{100.0 * t / total if total else 0.0:4.1f}%)"
            )
        for name, v in sorted(self.counters.items()):
            lines.append(f"  {name:<16} {v:g}")
        if self.counters.get("traversed_edges"):
            lines.append(f"  TEPS (wall)      {self.teps():.4g}")
        lines.append(f"  rss high-water   {rss_high_water_mb():.0f} MiB")
        return "\n".join(lines)


class ShardDiag:
    """Per-shard diagnostic text files, the counterpart of the reference
    application's per-rank ``dat.out.<rank>`` streams: one
    ``<prefix>.<shard>`` file per shard, a line per :meth:`write`, each
    file opened (and truncated) at its first line."""

    def __init__(self, prefix: str, nshards: int):
        self.prefix = prefix
        self.nshards = nshards
        self._files: dict = {}

    def write(self, shard: int, line: str) -> None:
        f = self._files.get(shard)
        if f is None:
            d = os.path.dirname(self.prefix)
            if d:
                os.makedirs(d, exist_ok=True)
            f = open(f"{self.prefix}.{shard}", "w", encoding="utf-8")
            self._files[shard] = f
        f.write(line.rstrip("\n") + "\n")

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullTracer(Tracer):
    def __init__(self):
        super().__init__(enabled=False)
