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

:func:`dist_stats_report` prints a partition's edge distribution, and
:class:`ShardDiag` writes the per-shard files of ``--diag-prefix``.
"""

from __future__ import annotations

import contextlib
import math
import os
import resource
import time


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

    def __init__(self, enabled: bool = True, recorder=None):
        # A recorder implies recording: its spans report stage times.
        self.enabled = enabled or recorder is not None
        self.recorder = recorder
        self.emitter = recorder.emitter if recorder is not None else None
        self.times: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.counters: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, into: dict | None = None):
        """Time a window as stage ``name``.  ``into``: a dict that also
        accumulates the window's seconds under ``name`` (a driver's
        ``PhaseStats.stages``), timed by the same clock, with or without
        an enabled tracer."""
        if not self.enabled and into is None:
            yield
            return
        em = self.emitter
        sid = em.begin(name) if em is not None else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if em is not None:
                em.end(sid, dur_s=dt)
            if into is not None:
                into[name] = into.get(name, 0.0) + dt
            if self.enabled:
                self.times[name] = self.times.get(name, 0.0) + dt
                self.calls[name] = self.calls.get(name, 0) + 1

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
        handle for :meth:`end_span`."""
        if self.emitter is not None:
            return self.emitter.begin(name, **attrs)
        return None

    def end_span(self, handle, **attrs) -> None:
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
