"""The slab-class batching queue: the serving core under the daemon (port
of ``cuvite_tpu/serve/queue.py``).

Jobs bin by (slab class, accumulator tag): the pow2 ``(nv_pad, ne_pad)``
class their graph canonicalizes to, and the reference's in-loop
accumulator tag (:func:`accum_tag`, ``'float32'`` or ``'ds32'``).  The
port sums in f64 for every graph, so the tag changes no result here; it
is kept so that the queue splits and merges the bins the reference does.
A bin dispatches when it holds ``b_max`` jobs, or when its oldest job has
waited ``linger_s``.  Inside a bin jobs live in per-tenant sub-queues and
pack by round-robin pop across tenants.

Around that core, in path order: admission (``ServeConfig.admission``:
submit rejects with ``retry_after_s`` when the class's measured service
projects the job's wait past the SLO, ``serve/admission.py``); deadline
shedding at pop time, before packing; fault injection (``serve/
faults.py``) with bounded exponential-backoff retry of transient faults
on the injectable clock and poison isolation of permanent ones (the
batch splits, batchmates survive, the job fails exactly once); sub-row
merging (``merge_packing``: a small-class bin that overflows its cap, or
whose packed batch the measured medians say beats lingering, packs as
fenced sub-rows of a larger class already served, ``core/batch.py::
SubRowLayout``).

Job conservation: every admitted job terminates exactly once as done,
failed or shed -- ``done + failed + shed + pending + inflight ==
submitted`` at all times (:meth:`LouvainServer.conservation`).

Dispatch is two stages: ``pack_batch`` (bucket-geometry union, slab
stacking, plan build and upload: the 'pack' fault site) and
``execute_batch`` (the batched driver and result routing: the
'dispatch', 'device' and 'unpack' sites; a retry re-runs the uploaded
batch, bit for bit).  ``step``/``drain`` compose them serially; the
pipelined dispatcher (``serve/pipeline.py``) runs them on two threads.
Busy windows are measured on the injectable clock and, on the card, end
after the batch's labels reach the host.

Observability: a ``pack`` span (class, jobs, B, trigger, layout) and an
``execute`` span per dispatch, one ``tenant_result`` event per job, and
``admit``/``reject``/``shed``/``retry``/``autotune`` events, through the
tracer's recorder seam (``utils/trace.py``).

Streaming: :class:`StreamPool` keeps per-tenant resident
``stream.StreamSession`` slabs behind the daemon's ``delta`` verb, LRU-
evicted under ``ServeConfig.stream_budget_bytes``
(``LouvainServer.streams``).

This module runs no device code; the batched driver
(``louvain/batched.py``) places each batch on ``ServeConfig.device``, or
shards its rows over the batch mesh of ``ServeConfig.mesh`` (``"auto"``:
every usable card), and the pool's sessions live on the device.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import warnings

from cuvite_tpu_torch.core.batch import (
    BATCH_ENGINES,
    BATCH_SIZES,
    batch_pad,
    slab_class_of,
)
from cuvite_tpu_torch.core.device import resolve_device
from cuvite_tpu_torch.core.types import TERMINATION_PHASE_COUNT
from cuvite_tpu_torch.serve import clock as serve_clock
from cuvite_tpu_torch.serve import sync
from cuvite_tpu_torch.serve.admission import (
    AdmissionConfig,
    AdmissionController,
    AdmissionReject,
    BmaxAutotuner,
)
from cuvite_tpu_torch.serve.faults import FaultPlan, InjectedFault

# The reference's ds32 gate (``cuvite_tpu/louvain/driver.py:153-172``):
# 2m or the reduction length at or above 2^24 makes its in-loop f32 sums
# threshold-unsafe, and it accumulates such graphs in double-single.
DS_MIN_TOTAL_WEIGHT = float(1 << 24)


def accum_tag(graph, nv_pad: int | None = None) -> str:
    """The reference's accumulator tag of ``graph`` served at row class
    ``nv_pad`` (default its own class): ``'ds32'`` when
    ``max(2m, max(ne, nv_pad)) >= 2^24``, else ``'float32'`` -- the host
    arithmetic of the reference's ``accum_class_of``.  The port sums in
    f64 for every graph; the tag decides binning and merging only."""
    if nv_pad is None:
        nv_pad = slab_class_of(graph)[0]
    if max(float(graph.total_edge_weight_twice()),
           float(max(graph.num_edges, nv_pad))) >= DS_MIN_TOTAL_WEIGHT:
        return "ds32"
    return "float32"


@dataclasses.dataclass
class ServeConfig:
    """Queue knobs.  ``b_max`` should be a BATCH_SIZES rung (it is
    rounded to one, with a warning when that CHANGES the requested
    value): it caps a batch's rows.  ``linger_s`` bounds the extra
    latency batching may add to any single job.

    ``engine`` selects the batched driver's engine for plain and merged
    batches: ``'bucketed'`` (the default: phase 0 on the row and heavy
    kernels over pack-time plans, coarse phases re-binned on the device)
    or ``'fused'`` (sort sweeps every phase).  Engine choice never changes
    results.  ``device``: where batches run; None is the card, and a
    server with no injected runner raises without one.  ``mesh``:
    forwarded to the batched driver (``louvain.batched``: ``"auto"``
    shards a batch on the card over the visible cards, None pins
    ``device``, or a ``make_batch_mesh`` mesh).

    Robustness knobs: ``admission`` — an
    :class:`~cuvite_tpu_torch.serve.admission.AdmissionConfig` enables
    SLO-projected admission control (None = admit everything, the
    library default); ``max_retries``/``retry_base_s`` bound the
    transient-fault retry loop (backoff = base * 2**(attempt-1), slept
    on the server's injectable sleep)."""

    b_max: int = 64
    linger_s: float = 0.05
    threshold: float = 1.0e-6
    max_phases: int = TERMINATION_PHASE_COUNT
    device: object = None   # None: the CUDA card
    mesh: object = "auto"   # forwarded to the batched driver
    engine: str = "bucketed"
    admission: AdmissionConfig | None = None
    max_retries: int = 3
    retry_base_s: float = 0.05
    # Measured-service b_max autotuning: after a per-rung
    # warm window, each class serves at the BATCH_SIZES rung that
    # maximizes projected goodput under the admission SLO (see
    # serve/admission.py::BmaxAutotuner); config b_max stays the cap.
    # Requires `admission` (the SLO and the service estimator live
    # there).
    autotune_b_max: bool = False
    # Mixed-class sub-row merging: when on, a due small-class
    # bin may dispatch as ONE merged batch of a larger served class's
    # rows — 2^k fenced sub-rows per row (core/batch.py::SubRowLayout),
    # up to b_max * n_sub jobs per dispatch instead of b_max.  The
    # packer merges when the bin OVERFLOWS its class cap (depth > b_max)
    # or when the measured service medians say the packed batch beats
    # lingering (see LouvainServer._merge_plan).  Results stay
    # bit-identical to solo runs (the fence construction); poison
    # isolation splits a merged batch per job at its OWN class.
    merge_packing: bool = False
    # Tenant slab residency budget: total device bytes the StreamPool
    # may keep resident across per-tenant StreamSessions before LRU
    # eviction kicks in.  A returning tenant whose session survived pays
    # only its delta; an evicted one re-uploads.
    stream_budget_bytes: int = 256 << 20

    def __post_init__(self) -> None:
        # Config-time validation: a bad knob must refuse HERE, not deep
        # in the driver mid-dispatch.
        if self.b_max < 1:
            raise ValueError("b_max must be >= 1")
        if self.linger_s < 0:
            raise ValueError(f"linger_s must be >= 0, got {self.linger_s}")
        if self.threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {self.threshold}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.retry_base_s < 0:
            raise ValueError(
                f"retry_base_s must be >= 0, got {self.retry_base_s}")
        if self.engine not in BATCH_ENGINES:
            raise ValueError(f"unknown serving engine {self.engine!r}; "
                             f"use one of {BATCH_ENGINES}")
        if self.admission is not None \
                and not isinstance(self.admission, AdmissionConfig):
            raise ValueError(
                "admission must be an AdmissionConfig (or None to "
                f"disable admission control), got {self.admission!r}")
        if self.autotune_b_max and self.admission is None:
            raise ValueError(
                "autotune_b_max needs admission control: the tuner "
                "reads the admission SLO and the measured per-class "
                "service curve (serve/admission.py)")
        if self.stream_budget_bytes < 1:
            raise ValueError("stream_budget_bytes must be >= 1, got "
                             f"{self.stream_budget_bytes}")
        # Round up to a ladder rung (full bins then pack with zero
        # padding), capped at the ladder top — loudly: a silently
        # clamped b_max=1000 serving 64-row batches would mislead
        # capacity planning.
        rung = min(batch_pad(self.b_max), BATCH_SIZES[-1])
        if rung != self.b_max:
            warnings.warn(
                f"b_max={self.b_max} is not a BATCH_SIZES rung; "
                f"using {rung} (ladder {BATCH_SIZES})", stacklevel=2)
        self.b_max = rung


@dataclasses.dataclass
class Job:
    job_id: str
    graph: object
    slab_class: tuple
    t_submit: float
    tenant: str = "anon"
    # Absolute deadline on the server clock (None = never sheds).
    t_deadline: float | None = None


@dataclasses.dataclass
class PackedBatch:
    """The handoff unit between the two dispatch stages: one
    popped batch after the PACK stage — jobs, trigger provenance, the
    sticky-union bucket geometry it packed against, and the uploaded
    device-ready batch (``prep``, a louvain.batched.PreparedMany; None
    on the injected-runner path, where execute runs the runner over the
    raw graphs).  ``results`` non-None means the pack stage already
    terminated every job (pack-site failure -> isolation) and
    execute_batch passes them through."""

    jobs: list
    key: tuple
    trigger: str
    now: float               # pop-time clock (wait-measurement base)
    n_real: int
    b_pad: int
    waits: list
    shape: object = None     # geometry to record on success (bucketed)
    prep: object = None      # PreparedMany (uploaded device buffers)
    pack_s: float = 0.0      # pack-stage busy seconds (injectable clock)
    results: list | None = None
    # Sub-row merge provenance: the SubRowLayout the batch
    # packed under (None = plain batch), and the occupied-row count for
    # the rows_real accounting (a merged batch's b_pad counts ROWS).
    layout: object = None
    merged: bool = False
    rows_real: int = 0


class _ClassBin:
    """One (slab class, accum class) bin: per-tenant FIFO sub-queues
    with a round-robin pop cursor (the fairness unit — each pop takes
    the front job of the front tenant and rotates that tenant to the
    back)."""

    __slots__ = ("tenants", "order")

    def __init__(self):
        self.tenants: dict = {}              # tenant -> deque[Job]
        self.order: collections.deque = collections.deque()

    def push(self, job: Job) -> None:
        q = self.tenants.get(job.tenant)
        if q is None:
            q = self.tenants[job.tenant] = collections.deque()
            self.order.append(job.tenant)
        q.append(job)

    def depth(self) -> int:
        return sum(len(q) for q in self.tenants.values())

    def oldest_t_submit(self) -> float | None:
        """Oldest enqueue time across ALL tenants (the linger clock:
        a firehose tenant cannot hide another tenant's aging job)."""
        heads = [q[0].t_submit for q in self.tenants.values() if q]
        return min(heads) if heads else None

    def pop_rr(self) -> Job | None:
        while self.order:
            t = self.order.popleft()
            q = self.tenants.get(t)
            if not q:
                self.tenants.pop(t, None)
                continue
            job = q.popleft()
            if q:
                self.order.append(t)
            else:
                self.tenants.pop(t, None)
            return job
        return None


# Queue-wait sample window: percentiles cover the most
# recent WAIT_WINDOW dispatched jobs, so a long-lived server's latency
# readout tracks CURRENT queue pressure instead of averaging over its
# whole uptime (and the sample memory stays bounded).
WAIT_WINDOW = 4096


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) over a sequence — the
    stdlib-only serving-latency estimator; 0.0 on no samples."""
    if not samples:
        return 0.0
    s = sorted(samples)
    rank = max(int(len(s) * q / 100.0 + 0.5), 1)
    return float(s[min(rank, len(s)) - 1])


@dataclasses.dataclass
class ServeStats:
    """Aggregate serving counters.  The queue-wait percentiles
    (enqueue -> dispatch, driven by the server's injectable clock)
    price the latency the batching discipline ADDS: a p95 near
    ``linger_s`` means jobs mostly wait out the deadline (rare classes
    / low traffic); a p95 near zero means bins fill and dispatch full
    (the amortization regime).

    Thread-safety: the daemon's dispatcher
    appends ``wait_samples`` while intake threads poll ``to_dict()``
    or the percentile properties — every read snapshots (and every
    write lands) under ``lock`` (an RLock, so ``to_dict`` can read the
    properties it reuses).  Single-threaded callers pay one
    uncontended acquire."""

    # Every counter is guarded by ``lock`` below.  The explicit
    # guarded-by annotations feed graftlint R019 (analysis/lockset.py):
    # inference alone cannot see the discipline from INSIDE this class
    # (the guarded mutations live in LouvainServer and daemon code), so a
    # ServeStats method mutating a field lock-free would slip through
    # without them.
    jobs_submitted: int = 0   # graftlint: guarded-by=self.lock — ADMITTED jobs (rejections never enqueue)
    jobs_done: int = 0        # graftlint: guarded-by=self.lock
    jobs_failed: int = 0      # graftlint: guarded-by=self.lock
    jobs_rejected: int = 0    # graftlint: guarded-by=self.lock — admission turned the job away at submit
    jobs_shed: int = 0        # graftlint: guarded-by=self.lock — deadline expired before dispatch
    retries: int = 0          # graftlint: guarded-by=self.lock — transient-fault batch retries
    batches: int = 0          # graftlint: guarded-by=self.lock
    rows_real: int = 0        # graftlint: guarded-by=self.lock
    rows_padded: int = 0      # graftlint: guarded-by=self.lock — total batch rows incl. padding
    linger_dispatches: int = 0  # graftlint: guarded-by=self.lock
    # Sub-row occupancy.  pack_util counts ROWS, which
    # saturates at 1.0 the moment every row holds one tenant — a merged
    # batch needs the sub-row ledger to report honest occupancy (and
    # can never report > 1.0): graphs_real real graphs over
    # subrow_capacity total sub-row slots (b_pad * n_sub per batch;
    # n_sub == 1 for plain batches, so the two utilizations coincide
    # until merging happens).
    merged_batches: int = 0   # graftlint: guarded-by=self.lock — dispatches that packed sub-rows
    graphs_real: int = 0      # graftlint: guarded-by=self.lock — real graphs across all batches
    subrow_capacity: int = 0  # graftlint: guarded-by=self.lock — total sub-row slots dispatched
    busy_s: float = 0.0       # graftlint: guarded-by=self.lock — wall spent inside the batched driver
    # Pipeline telemetry.  inflight: jobs popped from a bin
    # but not yet terminal (packed / in the handoff slot / executing) —
    # the conservation ledger's in-transit column.  pack_s/device_s:
    # cumulative wall of the two dispatch stages on the injectable
    # clock.  overlap_s: pack wall that ran CONCURRENTLY with a device
    # execute window — overlap_frac = overlap_s / device_s is the
    # pipelining win (0 under the serial dispatcher by construction).
    inflight: int = 0         # graftlint: guarded-by=self.lock — popped, not yet terminal
    pack_s: float = 0.0       # graftlint: guarded-by=self.lock — host pack + upload wall
    device_s: float = 0.0     # graftlint: guarded-by=self.lock — execute-stage wall
    overlap_s: float = 0.0    # graftlint: guarded-by=self.lock — pack wall inside execute windows
    pipeline_depth: int = 1   # graftlint: guarded-by=self.lock — 2 under the pipelined dispatcher
    # Overlap bookkeeping: the in-progress pack/execute window starts
    # and the last completed execute window, on the injectable clock.
    # exec_depth makes the execute window an ENVELOPE over concurrent
    # windows (poison isolation can run a nested execute on the packer
    # thread while the executor's own window is open — the envelope
    # [first start, last end] is what "a device execute was in flight"
    # means for the overlap integral).
    pack_since: float | None = None   # graftlint: guarded-by=self.lock
    exec_since: float | None = None   # graftlint: guarded-by=self.lock
    exec_depth: int = 0               # graftlint: guarded-by=self.lock
    last_exec: tuple | None = None    # graftlint: guarded-by=self.lock
    # enqueue->dispatch waits of the last WAIT_WINDOW jobs (seconds).
    wait_samples: collections.deque = dataclasses.field(  # graftlint: guarded-by=self.lock
        default_factory=lambda: collections.deque(maxlen=WAIT_WINDOW))
    # Per-slab-class breakdown of COMPLETED jobs: done
    # counts and recent wait samples keyed by slab class, so a skewed
    # mix's bench record can report per-class goodput/wait_p95 without
    # a second bookkeeping path in the load generator.
    done_by_class: dict = dataclasses.field(  # graftlint: guarded-by=self.lock
        default_factory=dict)
    waits_by_class: dict = dataclasses.field(  # graftlint: guarded-by=self.lock
        default_factory=dict)
    # sync.RLock is the serve/ synchronization seam (serve/sync.py).
    lock: threading.RLock = dataclasses.field(
        default_factory=sync.RLock, repr=False, compare=False)

    @property
    def pack_util(self) -> float:
        """Occupied batch ROWS over padded rows (a merged batch's row
        is occupied when >= 1 sub-row holds a real graph)."""
        with self.lock:
            return self.rows_real / max(self.rows_padded, 1)

    @property
    def subrow_util(self) -> float:
        """Real graphs over total SUB-row capacity — the honest
        occupancy once sub-row merging is on."""
        with self.lock:
            return self.graphs_real / max(self.subrow_capacity, 1)

    @property
    def overlap_frac(self) -> float:
        """Fraction of device-execute wall during which a host pack was
        concurrently in flight (the measured pipelining win)."""
        with self.lock:
            if self.device_s <= 0:
                return 0.0
            return min(self.overlap_s / self.device_s, 1.0)

    # -- pipeline-stage windows ----------------------------------
    # The packer/executor stages report their attempt windows here; the
    # overlap integral is accumulated on the PACK side only (each pack
    # window is clipped against the running or last-completed execute
    # window), so concurrent reporting never double-counts.  All on the
    # server's injectable clock.

    def pack_begins(self, t0: float) -> None:
        with self.lock:
            self.pack_since = t0

    def pack_ends(self, t0: float, t1: float) -> None:
        with self.lock:
            self.pack_s += t1 - t0
            self.pack_since = None
            if self.exec_since is not None:
                ov = t1 - max(t0, self.exec_since)
            elif self.last_exec is not None:
                s, e = self.last_exec
                ov = min(t1, e) - max(t0, s)
            else:
                ov = 0.0
            if ov > 0.0:
                self.overlap_s += ov

    def exec_begins(self, t0: float) -> None:
        with self.lock:
            self.exec_depth += 1
            if self.exec_depth == 1:
                self.exec_since = t0

    def exec_ends(self, t0: float, t1: float) -> None:
        with self.lock:
            self.device_s += t1 - t0
            self.exec_depth -= 1
            if self.exec_depth <= 0:
                self.exec_depth = 0
                self.last_exec = (self.exec_since
                                  if self.exec_since is not None else t0,
                                  t1)
                self.exec_since = None

    @property
    def jobs_per_s(self) -> float:
        with self.lock:
            return self.jobs_done / max(self.busy_s, 1e-9)

    @property
    def wait_p50_s(self) -> float:
        with self.lock:
            samples = list(self.wait_samples)
        return percentile(samples, 50.0)

    @property
    def wait_p95_s(self) -> float:
        with self.lock:
            samples = list(self.wait_samples)
        return percentile(samples, 95.0)

    def per_class(self) -> dict:
        """``{slab_class: {done, wait_p50_s, wait_p95_s}}`` snapshot —
        the per-class goodput/latency split a skewed-mix bench record
        reports."""
        with self.lock:
            keys = set(self.done_by_class) | set(self.waits_by_class)
            out = {}
            for cls in sorted(keys):
                samples = list(self.waits_by_class.get(cls, ()))
                out[cls] = {
                    "done": self.done_by_class.get(cls, 0),
                    "wait_p50_s": percentile(samples, 50.0),
                    "wait_p95_s": percentile(samples, 95.0),
                }
            return out

    def to_dict(self) -> dict:
        with self.lock:
            samples = list(self.wait_samples)
            out = {
                "jobs_submitted": self.jobs_submitted,
                "jobs_done": self.jobs_done,
                "jobs_failed": self.jobs_failed,
                "jobs_rejected": self.jobs_rejected,
                "jobs_shed": self.jobs_shed,
                "retries": self.retries,
                "batches": self.batches,
                "pack_util": round(self.pack_util, 4),
                "merged_batches": self.merged_batches,
                "subrow_util": round(self.subrow_util, 4),
                "linger_dispatches": self.linger_dispatches,
                "busy_s": round(self.busy_s, 4),
                "jobs_per_s": round(self.jobs_per_s, 2),
                "inflight": self.inflight,
                "pack_s": round(self.pack_s, 4),
                "device_s": round(self.device_s, 4),
                "overlap_frac": round(self.overlap_frac, 4),
                "pipeline_depth": self.pipeline_depth,
            }
        out["wait_p50_ms"] = round(percentile(samples, 50.0) * 1e3, 3)
        out["wait_p95_ms"] = round(percentile(samples, 95.0) * 1e3, 3)
        return out


class StreamPool:
    """Per-tenant resident :class:`~cuvite_tpu_torch.stream.StreamSession`
    registry under a device byte budget (reference ``queue.py:509-670``).

    The pool is the serving side of streaming: a tenant's first
    ``delta`` builds a session (the full slab upload, through the
    injectable ``factory``); later deltas find it resident and pay only
    the delta.  Residency is LRU under ``budget_bytes`` of session
    ``hbm_bytes()``: admitting or growing a session evicts the least
    recently USED others until the ledger fits (the session being
    touched is never evicted -- a tenant cannot be evicted by its own
    request).  One session larger than the whole budget is admitted
    alone (and evicts everyone else): refusing it would make the budget
    a hard per-tenant cap, which is the admission controller's job, not
    the pool's.

    Conservation: every admitted session is resident or evicted exactly
    once -- ``admitted == resident + evicted`` -- and ``bytes_resident``
    is exactly the sum of the resident sessions' ledger bytes.  All state
    lives under one ``sync.RLock`` (the daemon's reader threads race its
    drain path).  ``device``: where the default factory places sessions
    (None: the card).
    """

    def __init__(self, budget_bytes: int, tracer=None, *, factory=None,
                 device=None):
        if tracer is None:
            from cuvite_tpu_torch.utils.trace import NullTracer

            tracer = NullTracer()
        self.tracer = tracer
        self.budget_bytes = int(budget_bytes)
        if self.budget_bytes < 1:
            raise ValueError("stream budget must be >= 1 byte")
        self._factory = factory
        self.device = device
        self.lock = sync.RLock("stream-pool")
        self._sessions: dict = {}   # graftlint: guarded-by=self.lock — tenant -> session
        self._order: list = []      # graftlint: guarded-by=self.lock — LRU, oldest first
        self._bytes: dict = {}      # graftlint: guarded-by=self.lock — tenant -> bytes
        self.bytes_resident: int = 0  # graftlint: guarded-by=self.lock
        self.admitted: int = 0      # graftlint: guarded-by=self.lock
        self.evicted: int = 0       # graftlint: guarded-by=self.lock

    def _make_session(self, graph):
        """Build a session OUTSIDE the lock (the slab upload is the
        expensive part)."""
        if self._factory is not None:
            return self._factory(graph, tracer=self.tracer)
        from cuvite_tpu_torch.stream.session import StreamSession

        return StreamSession.from_graph(graph, tracer=self.tracer,
                                        device=self.device)

    def _touch(self, tenant: str) -> None:
        # Callers hold self.lock already; the RLock re-entry keeps the
        # discipline lexical at zero contention cost.
        with self.lock:
            if tenant in self._order:
                self._order.remove(tenant)
            self._order.append(tenant)

    def _evict_to_fit(self, keep: str) -> None:
        # Caller holds self.lock.  Oldest-first, never ``keep``.
        while self.bytes_resident > self.budget_bytes:
            victim = next((t for t in self._order if t != keep), None)
            if victim is None:
                break
            self._evict_locked(victim, reason="budget")

    def _evict_locked(self, tenant: str, *, reason: str) -> None:
        # Callers hold self.lock already (RLock re-entry, as _touch).
        with self.lock:
            sess = self._sessions.pop(tenant)
            nb = self._bytes.pop(tenant)
            self._order.remove(tenant)
            self.bytes_resident -= nb
            self.evicted += 1
        drop = getattr(sess, "drop", None)
        if drop is not None:
            drop()  # release device buffers eagerly (stubs may omit)
        self.tracer.event("evict", tenant=tenant, bytes=nb,
                          reason=reason,
                          bytes_resident=self.bytes_resident,
                          resident=len(self._sessions))

    def get(self, tenant: str):
        """The tenant's resident session (LRU-touched), or None."""
        with self.lock:
            sess = self._sessions.get(tenant)
            if sess is not None:
                self._touch(tenant)
            return sess

    def admit(self, tenant: str, graph):
        """Build and admit a session for ``tenant`` (replacing any
        resident one), evicting LRU others to fit the budget.  Returns
        the session."""
        sess = self._make_session(graph)
        with self.lock:
            if tenant in self._sessions:
                self._evict_locked(tenant, reason="replace")
            nb = int(sess.hbm_bytes())
            self._sessions[tenant] = sess
            self._bytes[tenant] = nb
            self._order.append(tenant)
            self.bytes_resident += nb
            self.admitted += 1
            self._evict_to_fit(keep=tenant)
        self.tracer.event("stream_admit", tenant=tenant, bytes=nb)
        return sess

    def reledger(self, tenant: str) -> None:
        """Re-read a resident session's ``hbm_bytes()`` after an op that
        may have grown its slab class (a delta spill), then re-run
        eviction.  No-op for unknown tenants (evicted mid-op)."""
        with self.lock:
            sess = self._sessions.get(tenant)
            if sess is None:
                return
            nb = int(sess.hbm_bytes())
            self.bytes_resident += nb - self._bytes[tenant]
            self._bytes[tenant] = nb
            self._evict_to_fit(keep=tenant)

    def evict(self, tenant: str) -> bool:
        """Explicit eviction (daemon shutdown / operator verb)."""
        with self.lock:
            if tenant not in self._sessions:
                return False
            self._evict_locked(tenant, reason="explicit")
            return True

    def clear(self) -> None:
        with self.lock:
            for t in list(self._order):
                self._evict_locked(t, reason="shutdown")

    def conservation(self) -> dict:
        """Session and byte accounting: every admitted session is
        resident or evicted exactly once, and the byte ledger is the sum
        of the residents'."""
        with self.lock:
            s = dict(admitted=self.admitted, evicted=self.evicted,
                     resident=len(self._sessions),
                     bytes_resident=self.bytes_resident)
            s["ok"] = (s["admitted"] == s["resident"] + s["evicted"]
                       and s["bytes_resident"]
                       == sum(self._bytes.values())
                       and set(self._order) == set(self._sessions))
        return s

    def to_dict(self) -> dict:
        with self.lock:
            return {
                "resident": len(self._sessions),
                "admitted": self.admitted,
                "evicted": self.evicted,
                "bytes_resident": self.bytes_resident,
                "budget_bytes": self.budget_bytes,
            }


class LouvainServer:
    """Synchronous serving core: ``submit()`` enqueues, ``step()`` runs
    every due batch and returns finished ``(job_id, LouvainResult)``
    pairs.  The async daemon (serve/daemon.py) wraps this in its
    socket intake + dispatcher thread; keeping the core synchronous
    keeps results deterministic and testable — the queue decides WHAT
    runs together, the batched driver decides how.

    Injectables (all default to the real thing): ``clock``/``sleep``
    (serve/clock.py — tests drive linger deadlines and retry backoff
    without sleeping), ``faults`` (a FaultPlan; empty = no injection),
    ``runner`` (the batch executor, signature of
    ``louvain.batched.cluster_many`` — chaos tests swap in a stub so
    hundreds of conservation-invariant jobs cost milliseconds),
    ``stream_factory`` (the :class:`StreamPool`'s session factory).

    Without a runner, batches run on ``config.device`` (None: the card;
    constructing the server raises when there is none).
    """

    def __init__(self, config: ServeConfig | None = None, tracer=None,
                 clock=None, *, sleep=None, faults=None, runner=None,
                 stream_factory=None):
        self.config = config or ServeConfig()
        if tracer is None:
            from cuvite_tpu_torch.utils.trace import NullTracer

            tracer = NullTracer()
        self.tracer = tracer
        self.clock = clock if clock is not None else serve_clock.monotonic
        self.sleep = sleep if sleep is not None else serve_clock.sleep
        self.faults = faults if faults is not None else FaultPlan()
        self._runner = runner
        self.device = (resolve_device(self.config.device)
                       if runner is None else None)
        # Set by the pipelined dispatcher (serve/pipeline.py): its packer
        # uploads on a side stream so that the upload overlaps the
        # executor's batch (louvain/batched.py, module note).
        self.side_stream_upload = False
        self.stats = ServeStats()
        self.admission = (AdmissionController(self.config.admission)
                          if self.config.admission is not None else None)
        # Measured-service b_max autotuning: per-class
        # effective rung in _b_max, retuned after each dispatch from
        # the per-rung service curve; config.b_max stays the cap.
        self.autotuner = (BmaxAutotuner(self.config.admission)
                          if self.config.autotune_b_max else None)
        # Sub-row merge decision inputs: a DEDICATED
        # measured-service curve keyed per (bin key | merge key, rung) —
        # separate from the b_max autotuner so merge_packing without
        # autotune_b_max never retunes anything.  None without admission
        # (no SLO/window to size the estimator); the packer then merges
        # on bin overflow only.
        self.merge_tuner = (BmaxAutotuner(self.config.admission)
                            if (self.config.merge_packing
                                and self.config.admission is not None)
                            else None)
        # Slab classes that have COMPLETED at least one batch here —
        # the merge target set: merging aims small jobs at a larger
        # class the server is already running programs for.
        self._served_classes: set = set()  # graftlint: guarded-by=self.stats.lock
        # Terminal reports for jobs that never produce a result: jobs
        # whose clustering raised -> (job_id, error string) in
        # ``failures`` (poison isolation, see _dispatch); jobs whose
        # deadline expired before dispatch -> (job_id, late_s) in
        # ``shed``.  The daemon consumes-and-CLEARS both per dispatch
        # tick via consume_terminal() (a long-lived service must not
        # grow them unboundedly); library callers read them after
        # drain().  Under the pipelined dispatcher the packer appends
        # sheds while the executor appends failures, so both lists
        # live under the stats lock.
        self.failures: list = []   # graftlint: guarded-by=self.stats.lock
        self.shed: list = []       # graftlint: guarded-by=self.stats.lock
        self._bins: dict = collections.defaultdict(_ClassBin)
        # Sticky per-slab-class bucket geometry (engine='bucketed'):
        # each dispatch pins the grow-only UNION of every geometry the
        # class has served (core.batch.union_shapes), the geometry the
        # reference pins so per-batch degree-histogram jitter cannot
        # churn its compiled phase-0 programs; the port checks each
        # batch against it.  Read by the packer stage, recorded by the executor stage
        # — hence the stats-lock discipline.
        self._shapes: dict = {}    # graftlint: guarded-by=self.stats.lock
        self._b_max: dict = {}     # graftlint: guarded-by=self.stats.lock
        self._ids = itertools.count()
        # Tenant slab residency: per-tenant resident StreamSessions
        # behind the daemon's `delta` verb, LRU-evicted under the byte
        # budget, on the server's device.
        self.streams = StreamPool(self.config.stream_budget_bytes,
                                  tracer=self.tracer,
                                  factory=stream_factory,
                                  device=self.config.device)

    # -- intake -------------------------------------------------------------

    def submit(self, graph, job_id: str | None = None, *,
               tenant: str = "anon", deadline_s: float | None = None,
               t_submit: float | None = None) -> str:
        """Enqueue one clustering job; returns its id.  Binning is by
        (slab class, accumulator class) — pure host arithmetic, no slab
        is built here.

        ``deadline_s`` (relative to now, on the server clock): the job
        is SHED — never packed — once the deadline passes before
        dispatch.  ``t_submit`` backdates the enqueue timestamp (the
        open-loop load generator stamps scheduled arrival times so
        queue waits are measured from arrival, not from when the
        single-threaded loop got around to submitting).

        Raises :class:`AdmissionReject` (with ``retry_after_s``) when
        admission control is on and the class's projected wait
        breaches the SLO; the job is then terminally REJECTED and
        never enqueued.
        """
        if job_id is None:
            job_id = f"job-{next(self._ids)}"
        cls = slab_class_of(graph)
        key = (cls, accum_tag(graph, cls[0]))
        now = self.clock() if t_submit is None else t_submit
        depth = self._bins[key].depth() if key in self._bins else 0
        if self.admission is not None:
            # Under the stats lock: the executor stage observes service
            # times concurrently with intake's projection.
            with self.stats.lock:
                retry_after = self.admission.decide(key, depth,
                                                    self.b_max_for(key))
            if retry_after is not None:
                with self.stats.lock:
                    self.stats.jobs_rejected += 1
                self.tracer.event(
                    "reject", job_id=job_id, tenant=tenant,
                    slab_class=list(cls), depth=depth,
                    retry_after_s=round(retry_after, 6))
                raise AdmissionReject(
                    retry_after,
                    f"class {cls} depth {depth} projects past the "
                    f"{self.config.admission.wait_slo_s}s wait SLO")
        try:
            self.faults.check("submit")
        except InjectedFault:
            # An intake fault is a REJECTION seen from the conservation
            # ledger: the job never entered the queue, the caller got
            # an error, and it must not count as submitted.
            with self.stats.lock:
                self.stats.jobs_rejected += 1
            self.tracer.event("reject", job_id=job_id, tenant=tenant,
                              slab_class=list(cls), depth=depth,
                              reason="injected-fault")
            raise
        self._bins[key].push(
            Job(job_id=job_id, graph=graph, slab_class=cls, t_submit=now,
                tenant=tenant,
                t_deadline=(now + deadline_s
                            if deadline_s is not None else None)))
        with self.stats.lock:
            self.stats.jobs_submitted += 1
        self.tracer.event("admit", job_id=job_id, tenant=tenant,
                          slab_class=list(cls), depth=depth + 1)
        return job_id

    def pending(self) -> int:
        return sum(b.depth() for b in self._bins.values())

    def b_max_for(self, key) -> int:
        """The class's EFFECTIVE batch cap: the autotuned rung when the
        tuner has retuned it, else ``config.b_max`` (always <= the
        config cap).  Locked: the executor stage retunes concurrently
        with the packer's due-scan (stats.lock is an RLock, so callers
        already holding it nest cleanly)."""
        with self.stats.lock:
            return self._b_max.get(key, self.config.b_max)

    def autotuned(self) -> dict:
        """{class key: rung} for every class the autotuner has moved
        off the config default (empty without autotune_b_max)."""
        with self.stats.lock:
            return dict(self._b_max)

    def pin_shape(self, slab_class: tuple, shape) -> None:
        """Pre-pin a slab class's bucket geometry (engine='bucketed').
        Benches and the load generator pin the JOB-SET union
        (core.batch.bucket_shape_for); the sticky per-dispatch union
        then never grows past it."""
        from cuvite_tpu_torch.core.batch import union_shapes

        with self.stats.lock:
            prev = self._shapes.get(slab_class)
            self._shapes[slab_class] = (shape if prev is None
                                        else union_shapes(prev, shape))

    def consume_terminal(self) -> tuple:
        """Atomically take (and clear) the no-result terminal reports —
        ``(failures, shed)`` — for routing.  The daemon/dispatcher
        calls this per delivery tick so a long-lived service never
        grows the lists unboundedly."""
        with self.stats.lock:
            fails = list(self.failures)
            self.failures.clear()
            sheds = list(self.shed)
            self.shed.clear()
        return fails, sheds

    def conservation(self) -> dict:
        """Terminal accounting — the chaos invariant: every admitted
        job is pending, in flight (popped but not yet terminal — the
        pipelined dispatcher's pack/handoff/execute transit), or
        terminated exactly once (``done + failed + shed + pending +
        inflight == submitted``; rejected jobs are their own terminal
        state and never enqueue)."""
        with self.stats.lock:
            s = dict(submitted=self.stats.jobs_submitted,
                     done=self.stats.jobs_done,
                     failed=self.stats.jobs_failed,
                     shed=self.stats.jobs_shed,
                     rejected=self.stats.jobs_rejected,
                     inflight=self.stats.inflight)
        s["pending"] = self.pending()
        s["ok"] = (s["done"] + s["failed"] + s["shed"] + s["pending"]
                   + s["inflight"] == s["submitted"])
        return s

    # -- dispatch -----------------------------------------------------------

    # -- sub-row merge decision ----------------------------------

    def _merge_obs_key(self, layout) -> tuple:
        """Service-curve key of merged batches at one layout — distinct
        from any bin key, so merged medians never blur plain ones."""
        return ("merge", layout.row_class, layout.n_sub)

    def _merge_target(self, cls: tuple):
        """``(SubRowLayout, row_class)`` packing ``cls`` into the
        SMALLEST larger class this server has already served, or None
        when no served class is an exact pow2 sub-row multiple.
        Merging never invents a new class: targets are classes with
        live big-tenant traffic."""
        from cuvite_tpu_torch.core.batch import subrow_layout_for

        with self.stats.lock:
            served = sorted(c for c in self._served_classes
                            if c[0] > cls[0])
        for rc in served:
            lay = subrow_layout_for(cls, rc)
            if lay is not None:
                return lay, rc
        return None

    def _merge_plan(self, key, now: float):
        """Merge-vs-linger for one small-class bin: the SubRowLayout to
        pack under, or None to serve the bin plain.

        Merge when either
          * **overflow** — the bin holds more jobs than its class cap
            ``b_max`` (a plain dispatch would leave the excess queued
            behind the cap; sub-rows carry ``b_max * n_sub``), or
          * **measured** — the merge tuner's service medians project
            the packed batch completing before the plain alternative:
            ``est(merged @ rows rung) < remaining linger + est(plain @
            b_max rung)`` — i.e. the packed-batch service beats the
            small class's linger wait.  Cold medians never merge (the
            overflow path is what warms them).

        ds32-scale tenants never reach here: their bins carry a
        non-float32 tag, refused below (:func:`accum_tag`), and the
        row-class re-gate happens at pack time.

        An INJECTED runner (the chaos seam) still merges: the
        runner receives the popped raw graphs either way, so the whole
        merge-aware queue discipline (overflow pop past b_max,
        conservation, poison isolation of a packed batch) is
        model-checkable without the real packer."""
        if not self.config.merge_packing:
            return None
        cls, acc = key
        if acc != "float32":
            return None
        b = self._bins.get(key)
        depth = b.depth() if b is not None else 0
        if depth < 2:
            return None
        target = self._merge_target(cls)
        if target is None:
            return None
        layout, _row_cls = target
        b_max = self.b_max_for(key)
        if depth > b_max:
            return layout
        if self.merge_tuner is None:
            return None
        n = min(depth, b_max * layout.n_sub)
        rows_rung = batch_pad(-(-n // layout.n_sub))
        with self.stats.lock:
            merged_curve = self.merge_tuner.curve(
                self._merge_obs_key(layout))
            plain_curve = self.merge_tuner.curve(key)
        # Curve lookup rounds UP to the nearest warmed rung: overflow
        # merges only ever warm rows-rungs >= 2 (depth > b_max means
        # ceil(depth / n_sub) rows >= 2 whenever n_sub <= b_max), so an
        # exact-rung lookup would leave small-depth measured merges
        # permanently cold.  A larger rung's median upper-bounds the
        # smaller batch's service — the substitution only ever makes
        # the decision MORE conservative.
        def _at(curve: dict, rung: int):
            if rung in curve:
                return curve[rung]
            ge = [r for r in curve if r >= rung]
            return curve[min(ge)] if ge else None

        est_merged = _at(merged_curve, rows_rung)
        est_plain = _at(plain_curve, batch_pad(min(depth, b_max)))
        if est_merged is None or est_plain is None:
            return None
        oldest = b.oldest_t_submit()
        linger_left = max(
            0.0, self.config.linger_s - (now - (oldest or now)))
        return layout if est_merged < linger_left + est_plain else None

    def _due(self, now: float, force: bool) -> list:
        """Bin keys with a dispatchable batch: full bins always;
        partial bins once their oldest job lingered past the deadline
        (or on ``force``, the drain path); merge-eligible bins as soon
        as the measured medians say packing beats lingering."""
        due = []
        for key, b in self._bins.items():
            oldest = b.oldest_t_submit()
            if oldest is None:
                continue
            if force or b.depth() >= self.b_max_for(key) \
                    or (now - oldest) >= self.config.linger_s:
                due.append(key)
            elif self.config.merge_packing \
                    and self._merge_plan(key, now) is not None:
                due.append(key)
        return due

    def _shed_job(self, job: Job, now: float) -> None:
        late = now - job.t_deadline
        with self.stats.lock:
            self.stats.jobs_shed += 1
            self.shed.append((job.job_id, late))
        self.tracer.event("shed", job_id=job.job_id, tenant=job.tenant,
                          slab_class=list(job.slab_class),
                          late_s=round(late, 6))

    def _pop_batch(self, b: _ClassBin, key, now: float,
                   cap: int | None = None) -> list:
        """Round-robin pop up to the class's effective ``b_max`` jobs
        (or an explicit ``cap`` — the merge path pops ``b_max * n_sub``),
        shedding expired ones BEFORE they can occupy a batch
        row.  Surviving jobs are counted in flight (conservation:
        popped but not yet terminal)."""
        jobs = []
        b_max = self.b_max_for(key) if cap is None else cap
        while len(jobs) < b_max:
            job = b.pop_rr()
            if job is None:
                break
            if job.t_deadline is not None and now > job.t_deadline:
                self._shed_job(job, now)
                continue
            jobs.append(job)
        if jobs:
            with self.stats.lock:
                self.stats.inflight += len(jobs)
        return jobs

    def pop_due(self, now: float | None = None, force: bool = False):
        """Pop ONE due batch — ``(jobs, key, trigger, now)``, or None
        when nothing is due.  The packer stage's intake op: the caller
        must hold the intake lock (the daemon lock) so pops serialize
        against submits; the expensive pack then happens OUTSIDE it.
        Popped jobs are in flight until :meth:`execute_batch` (or the
        failure paths) terminate them."""
        now = self.clock() if now is None else now
        for key in self._due(now, force):
            lay = self._merge_plan(key, now)
            cap = (self.b_max_for(key) * lay.n_sub
                   if lay is not None else None)
            jobs = self._pop_batch(self._bins[key], key, now, cap=cap)
            if not jobs:
                continue  # the whole pop shed
            # Label from the ACTUALLY-PACKED size: a bin that counted
            # as full but shed down to a partial batch is a partial
            # dispatch in the telemetry, not a 'full' one.  A merge pop
            # that shed to one survivor packs plain (a lone job needs
            # no fences).
            if lay is not None and len(jobs) > 1:
                trigger = "merge"
            else:
                trigger = ("full" if len(jobs) >= self.b_max_for(key)
                           else "drain" if force else "linger")
            return jobs, key, trigger, now
        return None

    # -- the two dispatch stages ---------------------------------
    # pack_batch() — host-side batch assembly: shape union, slab
    # stacking, bucket-plan build, device upload ('pack' fault site,
    # with its own bounded transient retry).  execute_batch() — the
    # batched driver + result routing ('dispatch'/'device'/'unpack'
    # sites, retry re-runs the ALREADY-UPLOADED batch bit-identically).
    # The serial path composes them in _dispatch(); the pipelined
    # dispatcher (serve/pipeline.py) runs them on two seam-threads with
    # a depth-1 handoff slot between, so the steady-state batch period
    # is max(pack_s, device_s) instead of their sum.

    def _terminal_failure(self, job: Job, cls, wait, err) -> None:
        """One job fails terminally: ledger + report + event."""
        with self.stats.lock:
            self.stats.jobs_failed += 1
            # A failed job still waited in the queue; its sample
            # belongs in the latency percentiles like any other.
            self.stats.wait_samples.append(wait)
            self.stats.inflight -= 1
            self.failures.append((job.job_id, repr(err)))
        self.tracer.event("tenant_error", job_id=job.job_id,
                          tenant=job.tenant, slab_class=list(cls),
                          error=repr(err))

    def _fail_or_isolate(self, packed, sid, busy, err) -> list:
        """Terminal path of either stage: close the stage span, then
        isolate — a batch whose pack/clustering RAISES must not take
        its batchmates down: the batch splits and each job retries
        alone (a fresh pack+execute per job, in the thread that hit
        the failure); a job that fails alone lands in ``self.failures``
        (never back in the queue — a poison job re-queued would raise
        forever)."""
        jobs, key = packed.jobs, packed.key
        cls, _acc = key
        self.tracer.end_span(sid, wall_s=busy, error=repr(err))
        with self.stats.lock:
            self.stats.busy_s += busy
        if len(jobs) == 1:
            self._terminal_failure(jobs[0], cls, packed.waits[0], err)
            return []
        out = []
        for job in jobs:  # isolate the poison job, save the rest
            out.extend(self._dispatch([job], key, "isolate", packed.now))
        return out

    def pack_batch(self, jobs, key, trigger, now) -> "PackedBatch":
        """The PACK stage: bucket-geometry union, slab stacking + plan
        build + device upload (louvain.batched.pack_many), behind the
        'pack' fault site
        with bounded transient retry.  Returns a PackedBatch; on a
        terminal pack failure its ``results`` carry the isolation
        outcome and :meth:`execute_batch` passes them through."""
        cls, _acc = key
        # Edgeless jobs are answered inline by the driver and occupy
        # no batch row: the padded shape and the pack accounting follow
        # the rows that actually hit the device.
        n_real = sum(1 for j in jobs if j.graph.num_edges > 0)
        # Sub-row merge: a 'merge'-triggered pop packs its
        # jobs as fenced sub-rows of the target row class — IF every
        # job's tag stays f32 AT THE ROW CLASS (the padded reduction
        # length grows n_sub-fold; accum_tag re-evaluated at the row
        # nv_pad, as the reference does).  A batch any
        # of whose tenants fails the re-gate demotes to a plain pack:
        # refusal means "serve plain", never "fail the job".
        layout = None
        if trigger == "merge" and n_real > 1:
            target = self._merge_target(cls)
            if target is not None:
                lay = target[0]
                if all(accum_tag(j.graph, lay.row_class[0])
                       == "float32"
                       for j in jobs if j.graph.num_edges > 0):
                    layout = lay
        rows_real = (-(-n_real // layout.n_sub) if layout is not None
                     else n_real)
        b_pad = batch_pad(rows_real) if n_real else 0
        # Queue-wait latency of THIS batch's jobs (enqueue -> dispatch
        # decision), on the injectable clock: per-batch percentiles ride
        # the pack span; the rolling aggregate feeds the serve summary.
        waits = [max(now - j.t_submit, 0.0) for j in jobs]
        packed = PackedBatch(jobs=jobs, key=key, trigger=trigger, now=now,
                             n_real=n_real, b_pad=b_pad, waits=waits,
                             layout=layout, merged=layout is not None,
                             rows_real=rows_real)
        sid = self.tracer.begin_span(
            "pack", slab_class=list(cls), jobs=len(jobs), b_pad=b_pad,
            trigger=trigger, engine=self.config.engine,
            layout=(layout.n_sub if layout is not None else 1),
            merged=packed.merged,
            tenants=len({j.tenant for j in jobs}),
            wait_p50_s=round(percentile(waits, 50.0), 6),
            wait_p95_s=round(percentile(waits, 95.0), 6))
        # Busy windows run on the INJECTABLE clock (not perf_counter):
        # the admission controller's service-time estimates and the
        # stats' busy_s must be drivable by a fake clock + stub runner,
        # or overload behavior becomes untestable without real sleeps.
        busy = 0.0
        attempt = 0
        while True:
            t0 = self.clock()
            self.stats.pack_begins(t0)
            try:
                self.faults.check("pack")
                if (self.config.engine == "bucketed" and n_real
                        and not packed.merged):
                    from cuvite_tpu_torch.core.batch import (
                        bucket_shape_for,
                        union_shapes,
                    )

                    need = bucket_shape_for(
                        [j.graph for j in jobs if j.graph.num_edges > 0])
                    with self.stats.lock:
                        prev = self._shapes.get(cls)
                    packed.shape = (need if prev is None
                                    else union_shapes(prev, need))
                    # The sticky union is recorded only AFTER the batch
                    # completes (execute_batch): a poison job with an
                    # extreme degree histogram must not inflate the
                    # class's pinned geometry forever when it never
                    # produces a result.
                if self._runner is None and packed.merged:
                    # Merged batch: fenced sub-row pack into rows of
                    # the target class, run as the fold of its sub-rows
                    # (louvain/batched.py).  No bucket-shape union: the
                    # reference's packed engine is plan-free.
                    from cuvite_tpu_torch.louvain.batched import (
                        pack_subrow_many,
                    )

                    packed.prep = pack_subrow_many(
                        [j.graph for j in jobs], packed.layout,
                        b_pad=b_pad or None, mesh=self.config.mesh,
                        engine=self.config.engine, device=self.device,
                        tracer=self.tracer,
                        side_stream=self.side_stream_upload)
                elif self._runner is None:
                    from cuvite_tpu_torch.louvain.batched import pack_many

                    packed.prep = pack_many(
                        [j.graph for j in jobs], b_pad=b_pad or None,
                        mesh=self.config.mesh, engine=self.config.engine,
                        bucket_shape=packed.shape, device=self.device,
                        tracer=self.tracer,
                        side_stream=self.side_stream_upload)
            except InjectedFault as e:
                t1 = self.clock()
                busy += t1 - t0
                self.stats.pack_ends(t0, t1)
                if not e.permanent and attempt < self.config.max_retries:
                    attempt += 1
                    backoff = self.config.retry_base_s * (2 ** (attempt - 1))
                    with self.stats.lock:
                        self.stats.retries += 1
                    self.tracer.event(
                        "retry", site=e.site, attempt=attempt,
                        jobs=len(jobs), slab_class=list(cls),
                        backoff_s=round(backoff, 6))
                    self.sleep(backoff)
                    continue
                packed.results = self._fail_or_isolate(packed, sid, busy, e)
                return packed
            except Exception as e:  # noqa: BLE001 — isolation boundary
                t1 = self.clock()
                busy += t1 - t0
                self.stats.pack_ends(t0, t1)
                packed.results = self._fail_or_isolate(packed, sid, busy, e)
                return packed
            t1 = self.clock()
            busy += t1 - t0
            self.stats.pack_ends(t0, t1)
            break
        packed.pack_s = busy
        self.tracer.end_span(sid, wall_s=busy, attempts=attempt + 1)
        return packed

    def _run_batch(self, packed: "PackedBatch"):
        """The driver invocation, behind the 'device' fault site: the
        prepared batch through execute_many, or the injected runner
        (chaos tests) over the raw graphs."""
        self.faults.check("device")
        if self._runner is not None:
            return self._runner(
                [j.graph for j in packed.jobs],
                threshold=self.config.threshold,
                max_phases=self.config.max_phases,
                b_pad=packed.b_pad or None, mesh=self.config.mesh,
                engine=self.config.engine, bucket_shape=packed.shape,
                tracer=self.tracer)
        from cuvite_tpu_torch.louvain.batched import execute_many

        return execute_many(
            packed.prep, threshold=self.config.threshold,
            max_phases=self.config.max_phases, tracer=self.tracer)

    def execute_batch(self, packed: "PackedBatch") -> list:
        """The EXECUTE stage: run the prepared batch through the batched
        driver and unpack per-tenant results, with bounded transient-fault
        retry ('dispatch'/'device'/'unpack' sites).  A retry re-runs
        the SAME uploaded batch — execute_prepared restarts from the
        phase-0 device state, bit-identically, with no re-pack."""
        if packed.results is not None:
            return packed.results       # pack stage already terminal
        jobs, key = packed.jobs, packed.key
        cls, _acc = key
        sid = self.tracer.begin_span(
            "execute", slab_class=list(cls), jobs=len(jobs),
            b_pad=packed.b_pad, trigger=packed.trigger,
            engine=self.config.engine)
        busy = 0.0
        attempt = 0
        while True:
            t0 = self.clock()
            self.stats.exec_begins(t0)
            try:
                self.faults.check("dispatch")
                br = self._run_batch(packed)
                self.faults.check("unpack")
            except InjectedFault as e:
                t1 = self.clock()
                busy += t1 - t0
                self.stats.exec_ends(t0, t1)
                if not e.permanent and attempt < self.config.max_retries:
                    attempt += 1
                    backoff = self.config.retry_base_s * (2 ** (attempt - 1))
                    with self.stats.lock:
                        self.stats.retries += 1
                    self.tracer.event(
                        "retry", site=e.site, attempt=attempt,
                        jobs=len(jobs), slab_class=list(cls),
                        backoff_s=round(backoff, 6))
                    self.sleep(backoff)
                    continue
                # Permanent, or transient past the retry budget: the
                # existing poison machinery is the terminal path.  The
                # batch's pack busy is charged too — the pre-split
                # dispatcher accumulated the whole dispatch's busy on
                # failure, and busy_s must not depend on WHICH stage
                # raised.
                return self._fail_or_isolate(packed, sid,
                                             packed.pack_s + busy, e)
            except Exception as e:  # noqa: BLE001 — isolation boundary
                t1 = self.clock()
                busy += t1 - t0
                self.stats.exec_ends(t0, t1)
                return self._fail_or_isolate(packed, sid,
                                             packed.pack_s + busy, e)
            t1 = self.clock()
            busy += t1 - t0
            self.stats.exec_ends(t0, t1)
            break
        self.tracer.end_span(sid, wall_s=busy, phases=br.n_phases,
                             attempts=attempt + 1)
        service_s = packed.pack_s + busy
        with self.stats.lock:
            if packed.shape is not None:
                # UNION with the current sticky state, not an overwrite:
                # under the pipelined dispatcher batch k+1 packs (and
                # reads _shapes) before batch k's execute records, so a
                # plain assignment could drop k's geometry and shrink
                # the grow-only union.
                from cuvite_tpu_torch.core.batch import union_shapes

                prev = self._shapes.get(cls)
                self._shapes[cls] = (packed.shape if prev is None
                                     else union_shapes(prev, packed.shape))
            if packed.n_real:
                self.stats.batches += 1
                # rows_real counts OCCUPIED ROWS of the dispatched
                # program (pack_util's numerator); for a merged batch
                # that is ceil(n_real / n_sub), not the job count —
                # graphs_real / subrow_capacity carry the finer
                # sub-row occupancy (subrow_util).
                self.stats.rows_real += (packed.rows_real or packed.n_real)
                self.stats.rows_padded += packed.b_pad
                n_sub = packed.layout.n_sub if packed.merged else 1
                self.stats.graphs_real += packed.n_real
                self.stats.subrow_capacity += packed.b_pad * n_sub
                if packed.merged:
                    self.stats.merged_batches += 1
                else:
                    # Only PLAIN completions certify a class as a merge
                    # target: a merged batch warms the (row, n_sub)
                    # sub-row program, not the row class's own plain
                    # program, and targets must be classes with live
                    # big-tenant traffic.
                    self._served_classes.add(cls)
            self.stats.busy_s += service_s
            if packed.trigger == "linger":
                self.stats.linger_dispatches += 1
            if self.admission is not None and packed.n_real:
                self.admission.observe(key, service_s)
            if self.merge_tuner is not None and packed.n_real:
                okey = (self._merge_obs_key(packed.layout) if packed.merged
                        else key)
                self.merge_tuner.observe(okey, packed.b_pad, service_s)
        if not packed.merged:
            # Merged batches never feed the per-class b_max autotuner:
            # their rung is row-count at the ROW class, not this small
            # class's own batch depth — mixing the two would corrupt
            # the plain-service curve the merge decision compares
            # against.
            self._maybe_retune(key, packed.b_pad, service_s,
                               n_real=packed.n_real)
        out = []
        for job, res, wait in zip(jobs, br.results, packed.waits):
            with self.stats.lock:
                self.stats.jobs_done += 1
                self.stats.wait_samples.append(wait)
                self.stats.done_by_class[cls] = (
                    self.stats.done_by_class.get(cls, 0) + 1)
                self.stats.waits_by_class.setdefault(
                    cls, collections.deque(maxlen=WAIT_WINDOW)).append(wait)
                self.stats.inflight -= 1
            self.tracer.event(
                "tenant_result", job_id=job.job_id, tenant=job.tenant,
                slab_class=list(cls), q=float(res.modularity),
                phases=len(res.phases),
                iterations=int(res.total_iterations),
                communities=int(res.num_communities),
                wait_s=round(wait, 6))
            out.append((job.job_id, res))
        return out

    def _maybe_retune(self, key, b_pad: int, service_s: float, *,
                      n_real: int) -> None:
        """Feed the autotuner one (rung, service) sample and apply its
        pick; an ``autotune`` event fires on EVERY effective-b_max
        change (the operator-visible record of the retune)."""
        if self.autotuner is None or not n_real:
            return
        with self.stats.lock:
            self.autotuner.observe(key, b_pad, service_s)
            new = self.autotuner.pick(key, self.config.b_max)
            cur = self._b_max.get(key, self.config.b_max)
            if new is None or new == cur:
                return
            self._b_max[key] = new
            curve = self.autotuner.curve(key)
        self.tracer.event(
            "autotune", slab_class=list(key[0]), b_max_old=cur,
            b_max_new=new,
            curve={str(r): round(est, 6)
                   for r, est in sorted(curve.items())})

    def _dispatch(self, jobs, key, trigger, now) -> list:
        """The SERIAL dispatch: pack then execute on the calling thread
        (step()/drain() and the per-job isolation splitter).  The
        pipelined dispatcher runs the same two halves on separate
        threads."""
        return self.execute_batch(self.pack_batch(jobs, key, trigger, now))

    def step(self, now: float | None = None, force: bool = False) -> list:
        """Run every due batch; returns [(job_id, LouvainResult), ...]
        in pop order per batch.  One call may run several batches (one
        per due bin); jobs whose clustering raised are reported via
        ``self.failures``, shed jobs via ``self.shed`` — never
        returned."""
        now = self.clock() if now is None else now
        out = []
        for key in self._due(now, force):
            lay = self._merge_plan(key, now)
            cap = (self.b_max_for(key) * lay.n_sub
                   if lay is not None else None)
            jobs = self._pop_batch(self._bins[key], key, now, cap=cap)
            if not jobs:
                continue  # the whole pop shed
            # Label from the ACTUALLY-PACKED size: a bin that counted
            # as full but shed down to a partial batch is a partial
            # dispatch in the telemetry, not a 'full' one; a merge pop
            # shed to one survivor packs plain.
            if lay is not None and len(jobs) > 1:
                trigger = "merge"
            else:
                trigger = ("full" if len(jobs) >= self.b_max_for(key)
                           else "drain" if force else "linger")
            out.extend(self._dispatch(jobs, key, trigger, now))
        return out

    def drain(self) -> list:
        """Flush every queued job regardless of linger/fill state
        (expired jobs still shed rather than pack).  Emits a ``drain``
        span so a service shutdown is visible in the trace."""
        sid = self.tracer.begin_span("drain", pending=self.pending())
        out = []
        while self.pending():
            out.extend(self.step(force=True))
        self.tracer.end_span(sid, done=len(out))
        return out
