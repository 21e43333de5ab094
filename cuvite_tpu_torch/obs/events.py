"""Structured span/event trace: the flight recorder's record stream
(port of ``cuvite_tpu/obs/events.py``; the record schema, ``TRACE_VERSION``
and the readers are the reference's, so one trace reader serves both
packages).

One record per line, self-describing via the ``t`` field:

    {"t": "run_begin", "v": 1, "wall": ..., "mono": ..., "host": 0,
     "attrs": {...}}
    {"t": "span_begin", "id": 3, "parent": 2, "name": "iterate",
     "phase": 1, "host": 0, "wall": ..., "mono": ..., "attrs": {...}}
    {"t": "span_end", "id": 3, "wall": ..., "mono": ..., "dur_s": 0.12}
    {"t": "event", "name": "convergence", "parent": 2, "phase": 1,
     "host": 0, "wall": ..., "mono": ..., "attrs": {...}}

``wall`` is ``time.time()`` (cross-host alignable), ``mono`` is
``time.perf_counter()`` (duration-exact within one process).  Sinks are
anything with ``emit(dict)``/``close()``; the JSONL sink is the file
exporter behind ``--trace-out``, the memory sink backs tests.

Stdlib only: emission stays cheap enough to thread through the drivers
unconditionally.  The drivers emit from the host control loop and hand
the emitter host values only, so a record never reads the device.
"""

from __future__ import annotations

import dataclasses
import json
import time

TRACE_VERSION = 1


def jsonable(obj):
    """Best-effort conversion of attrs to JSON-serializable values:
    numpy arrays and scalars and 0-d tensors (matched by duck type, so
    neither numpy nor torch is imported here), dataclasses, sets, and
    nested containers.  A tensor is read on the host: callers pass host
    values (a device tensor here would cost a sync)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [jsonable(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return jsonable(dataclasses.asdict(obj))
    if hasattr(obj, "tolist"):  # numpy array / scalar, tensor
        return jsonable(obj.tolist())
    if hasattr(obj, "item"):    # 0-d array-likes without tolist
        return jsonable(obj.item())
    return repr(obj)


class TraceSink:
    """Record consumer interface: ``emit(record)`` + ``close()``."""

    def emit(self, record: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryTraceSink(TraceSink):
    """In-memory sink (tests; programmatic consumers)."""

    def __init__(self):
        self.records: list[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)


class JsonlTraceSink(TraceSink):
    """Line-buffered JSONL file sink (the ``--trace-out`` exporter).

    The file opens lazily on the first record and truncates any previous
    run's trace.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def emit(self, record: dict) -> None:
        if self._f is None:
            import os

            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            # buffering=1 = real line buffering: a killed run (the
            # post-mortem case a flight recorder exists for) keeps every
            # fully-written record on disk.
            self._f = open(self.path, "w", encoding="utf-8", buffering=1)
        self._f.write(json.dumps(record, separators=(",", ":")) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class SpanEmitter:
    """Nested-span bookkeeping over a sink: monotonically increasing span
    ids, a parent stack, and the (host, phase) tags every record carries.
    The drivers emit from the host control loop only.

    Thread-aware: the pipelined dispatcher's packer and executor stages
    emit concurrently, so the parent stack is PER-THREAD (a packer's
    ``pack`` span can never adopt the executor's events, and ending a
    span only unwinds the ending thread's own stack) and id allocation +
    sink emission serialize under one lock (interleaved records stay
    well-formed JSONL)."""

    def __init__(self, sink: TraceSink, host: int = 0):
        import threading

        self.sink = sink
        self.host = int(host)
        self.phase = None
        self._next_id = 1
        self._stacks: dict = {}     # thread ident -> [span ids]
        self._open: set[int] = set()
        self._lock = threading.Lock()
        self._emit_base("run_begin", v=TRACE_VERSION)

    def _stack_here(self) -> list:
        import threading

        return self._stacks.setdefault(threading.get_ident(), [])

    def _emit_base(self, t: str, **fields) -> None:
        rec = {"t": t, "wall": time.time(), "mono": time.perf_counter(),
               "host": self.host}
        if self.phase is not None:
            rec["phase"] = int(self.phase)
        rec.update(fields)
        self.sink.emit(rec)

    def begin(self, name: str, **attrs) -> int:
        stack = self._stack_here()
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            parent = stack[-1] if stack else None
            self._emit_base("span_begin", id=sid, parent=parent, name=name,
                            attrs=jsonable(attrs))
            self._open.add(sid)
        stack.append(sid)
        return sid

    def end(self, sid: int, dur_s: float | None = None, **attrs) -> None:
        stack = self._stack_here()
        with self._lock:
            if sid not in self._open:
                # Stale, double-ended, or another thread's handle:
                # dropping it beats unwinding this thread's open stack
                # as "leaked" over one bad caller.
                return
            # Close any nested spans left open by a non-local exit
            # first (THIS thread's only), so "every span closes" holds
            # even on an exception path.
            while stack and stack[-1] != sid:
                leaked = stack.pop()
                self._open.discard(leaked)
                self._emit_base("span_end", id=leaked, leaked=True)
            if stack and stack[-1] == sid:
                stack.pop()
            self._open.discard(sid)
            rec = {"id": sid}
            if dur_s is not None:
                rec["dur_s"] = float(dur_s)
            if attrs:
                rec["attrs"] = jsonable(attrs)
            self._emit_base("span_end", **rec)

    def event(self, name: str, **attrs) -> None:
        stack = self._stack_here()
        with self._lock:
            parent = stack[-1] if stack else None
            self._emit_base("event", name=name, parent=parent,
                            attrs=jsonable(attrs))

    def close(self) -> None:
        with self._lock:
            # Unwind every thread's leftover spans (the emitter's
            # "every span closes" guarantee, now per-thread).
            for stack in self._stacks.values():
                while stack:
                    sid = stack.pop()
                    if sid in self._open:
                        self._open.discard(sid)
                        self._emit_base("span_end", id=sid)
            self._emit_base("run_end")
            self.sink.close()


def read_trace(path: str) -> list[dict]:
    """Load a JSONL trace back into a record list (the round-trip side
    of :class:`JsonlTraceSink`)."""
    records = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def validate_trace(records: list) -> list:
    """Structural-violation strings for a record stream (empty = valid):
    every span_begin has exactly one span_end, span_end ids exist, parent
    spans are open at child begin time, and per-record ``mono`` never
    decreases (one process writes the stream in order)."""
    problems = []
    open_spans: set = set()
    ended: set = set()
    last_mono = None
    for i, rec in enumerate(records):
        t = rec.get("t")
        mono = rec.get("mono")
        if mono is None:
            problems.append(f"record {i}: missing mono timestamp")
        elif last_mono is not None and mono < last_mono:
            problems.append(f"record {i}: mono went backwards")
        else:
            last_mono = mono
        if t == "span_begin":
            sid = rec.get("id")
            if sid in open_spans or sid in ended:
                problems.append(f"record {i}: duplicate span id {sid}")
            parent = rec.get("parent")
            if parent is not None and parent not in open_spans:
                problems.append(
                    f"record {i}: span {sid} parent {parent} not open")
            open_spans.add(sid)
        elif t == "span_end":
            sid = rec.get("id")
            if sid not in open_spans:
                problems.append(
                    f"record {i}: span_end for unknown/closed id {sid}")
            else:
                open_spans.discard(sid)
                ended.add(sid)
    for sid in sorted(open_spans):
        problems.append(f"span {sid} never closed")
    return problems


def spans_of(records: list, name: str | None = None) -> list:
    """The closed spans of a record stream as dicts with ``begin``/
    ``end`` records, children span ids and child events attached."""
    begins = {r["id"]: r for r in records if r.get("t") == "span_begin"}
    ends = {r["id"]: r for r in records if r.get("t") == "span_end"}
    out = []
    for sid, b in begins.items():
        if name is not None and b.get("name") != name:
            continue
        children = [r["id"] for r in begins.values()
                    if r.get("parent") == sid]
        events = [r for r in records
                  if r.get("t") == "event" and r.get("parent") == sid]
        out.append({"id": sid, "begin": b, "end": ends.get(sid),
                    "name": b.get("name"), "children": children,
                    "events": events,
                    "child_names": sorted(
                        begins[c].get("name") for c in children)})
    out.sort(key=lambda s: s["id"])
    return out
