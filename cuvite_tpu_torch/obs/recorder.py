"""FlightRecorder: one handle bundling the observability surfaces (port
of ``cuvite_tpu/obs/recorder.py``).

The drivers accept a ``tracer``; a recorder rides on it
(``Tracer(recorder=...)``) and gives the run:

  * a :class:`~cuvite_tpu_torch.obs.events.SpanEmitter` over a sink
    (JSONL file for ``--trace-out``, memory for tests),
  * a :class:`~cuvite_tpu_torch.obs.memory.DeviceMemoryLedger` fed by the
    drivers' uploads and snapshotted at phase boundaries,
  * an installed :class:`~cuvite_tpu_torch.obs.compile_watch.CompileWatcher`
    (context-managed) turning every kernel build and library load into a
    ``compile`` event -- the bench guard's signal, available to any run,
  * with ``profile_dir``, the card's allocator snapshot
    (``save_memory_profile``) at exit.

Use as a context manager around the run::

    with FlightRecorder(JsonlTraceSink(path)) as rec:
        louvain_phases(g, tracer=Tracer(recorder=rec))

``__exit__`` uninstalls the watcher, writes the memory profile, emits the
run_end record and closes the sink (every span closes -- the emitter
unwinds leaked spans itself).
"""

from __future__ import annotations

from cuvite_tpu_torch.obs.compile_watch import CompileWatcher
from cuvite_tpu_torch.obs.events import (
    MemoryTraceSink,
    SpanEmitter,
    TraceSink,
)
from cuvite_tpu_torch.obs.memory import DeviceMemoryLedger, \
    save_memory_profile

# Sentinel sink: the recorder is attached for its compile watcher and
# memory ledger only and keeps no emitter at all (the bench,
# --metrics-out without --trace-out).  Tracer's facade no-ops on
# emitter=None, so span/event payloads -- including the per-phase
# convergence row dicts -- are never built.
NO_TRACE = object()


class FlightRecorder:
    def __init__(self, sink: TraceSink | None = None, host: int = 0,
                 profile_dir: str | None = None,
                 watch_compiles: bool = True):
        if sink is NO_TRACE:
            self.sink = None
            self.emitter = None
        else:
            self.sink = sink if sink is not None else MemoryTraceSink()
            self.emitter = SpanEmitter(self.sink, host=host)
        self.ledger = DeviceMemoryLedger()
        self.profile_dir = profile_dir
        self.compile_events: list = []
        # One string per build or load (the bench guard's abort signal;
        # aliased to the watcher's list so it survives __exit__).
        self.compile_log: list = []
        self._watch_compiles = watch_compiles
        self._watcher = None

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self) -> "FlightRecorder":
        if self._watch_compiles:
            self._watcher = CompileWatcher(on_event=self._on_compile)
            self.compile_log = self._watcher.compiles
            self._watcher.__enter__()
        if self.profile_dir:
            import os

            os.makedirs(self.profile_dir, exist_ok=True)
            if self.emitter is not None:
                self.emitter.event("profiler_start", dir=self.profile_dir)
        return self

    def __exit__(self, *exc) -> bool:
        if self._watcher is not None:
            self._watcher.__exit__(*exc)
            self._watcher = None
        if self.profile_dir:
            path = save_memory_profile(self.profile_dir, "final")
            if self.emitter is not None:
                self.emitter.event("profiler_stop", dir=self.profile_dir,
                                   memory_profile=path)
        self.close()
        return False

    def close(self) -> None:
        if self.emitter is None:
            return
        if self.ledger.peak_by_buffer:
            self.emitter.event("hbm_peak",
                               peak_by_buffer=self.ledger.peak_by_buffer)
        self.emitter.close()

    # -- subscribers --------------------------------------------------------
    def _on_compile(self, ev: dict) -> None:
        self.compile_events.append(ev)
        if self.emitter is not None:
            self.emitter.event("compile", **ev)

    # -- programmatic access ------------------------------------------------
    @property
    def records(self) -> list:
        """The record list when the sink is a MemoryTraceSink (tests);
        raises otherwise."""
        return self.sink.records
