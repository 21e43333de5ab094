"""cuvite_tpu_torch.obs -- the flight recorder (port of ``cuvite_tpu/obs``).

Structured observability for every Louvain run:

  * ``events``        -- span/event JSONL trace (sinks, SpanEmitter,
                         round-trip readers/validators);
  * ``compile_watch`` -- the kernel build and library load watcher;
  * ``memory``        -- the per-buffer device-memory ledger, RSS, and the
                         card's allocator snapshot;
  * ``convergence``   -- per-phase convergence rows;
  * ``recorder``      -- FlightRecorder bundling the above behind one
                         context manager, attached to runs via
                         ``utils.trace.Tracer(recorder=...)``.

The trace and record schemas are the reference's, so one reader serves
both packages.  Nothing here imports torch at module level.

The device trace is the other half: under a ``torch.profiler`` the
tracer's stages are ``cuvite/<stage>`` ranges on the profiler's clock
(``utils/trace.py``), so the card's idle gaps can be read by the host
stage open during them.  The JSONL trace keeps the drivers' stages
(``plan``, ``upload``, ``rebin``, ``iterate``, ``evaluate``,
``coarsen``, ``coalesce``, ``color``); the fine stages (``start``,
``sweep``, ``host_read``, ``renumber``, ``finish``, and any stage
opened inside an ``iterate``, such as a batch's ``coarsen``) are ranges
and the tracer's ``fine_times`` and ``fine_calls`` only, so a trace's
size does not grow with the sweeps.
"""

from cuvite_tpu_torch.obs.compile_watch import CompileWatcher
from cuvite_tpu_torch.obs.convergence import (
    MOVED_UNTRACKED,
    ConvRow,
    PhaseConvergence,
    convergence_summary,
    decode_phase_conv,
)
from cuvite_tpu_torch.obs.events import (
    TRACE_VERSION,
    JsonlTraceSink,
    MemoryTraceSink,
    SpanEmitter,
    TraceSink,
    read_trace,
    spans_of,
    validate_trace,
)
from cuvite_tpu_torch.obs.memory import DeviceMemoryLedger, \
    save_memory_profile
from cuvite_tpu_torch.obs.recorder import NO_TRACE, FlightRecorder

__all__ = [
    "CompileWatcher", "ConvRow", "DeviceMemoryLedger", "FlightRecorder",
    "JsonlTraceSink", "MemoryTraceSink", "MOVED_UNTRACKED", "NO_TRACE",
    "PhaseConvergence", "SpanEmitter", "TraceSink", "TRACE_VERSION",
    "convergence_summary", "decode_phase_conv",
    "read_trace", "save_memory_profile", "spans_of", "validate_trace",
]
