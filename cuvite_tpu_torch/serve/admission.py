"""Admission control and the measured-service b_max autotuner for the
serving queue (port of ``cuvite_tpu/serve/admission.py``, stdlib only).

* **Admission control**: per class, a sliding-window MEDIAN of measured
  batch service seconds (observed after every dispatch on the queue's
  injectable clock) projects a new job's queue wait as
  ``floor(depth / b_max) * est_batch_s * headroom``; past the
  ``wait_slo_s`` SLO the job is rejected at submit with a structured
  ``retry_after_s``.  Cold start (no estimate yet) admits.
* **Deadline shedding** happens in the queue (``serve/queue.py``).
* **b_max autotuning**: each class serves at the ``BATCH_SIZES`` rung
  with the best projected goodput ``rung / est_batch_s(rung)`` among the
  rungs measured at least ``min_obs`` times and feasible under the SLO.

On the card a batch's service window ends only after its labels reach
the host (``louvain/batched.py::execute_prepared`` ends with the label
gather), so the estimates include the device's time, not only the
launches.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics


class AdmissionReject(RuntimeError):
    """Raised by ``LouvainServer.submit`` when admission control turns
    a job away.  ``retry_after_s`` is the structured backpressure
    signal: the earliest time the projection says a resubmit could be
    admitted.  Daemon clients receive it as
    ``{"ok": false, "rejected": true, "retry_after_s": ...}``."""

    def __init__(self, retry_after_s: float, reason: str):
        self.retry_after_s = float(retry_after_s)
        self.reason = reason
        super().__init__(
            f"admission rejected: {reason} (retry_after_s="
            f"{self.retry_after_s:.3f})")


@dataclasses.dataclass
class AdmissionConfig:
    """Knobs.  ``wait_slo_s`` is the queue-wait p95 target the
    controller defends; ``window`` is how many recent batch service
    times the per-class MEDIAN estimator keeps (a median, not an EWMA,
    on purpose: a cold first batch is an outlier that an EWMA would
    drag through many batches of decay, slamming intake shut on a
    freshly-started daemon; the median sheds it as soon as two normal
    batches follow); ``headroom`` scales the projection (>1.0 rejects
    earlier): the estimator lags a rising service time and the queue
    depth cannot see the batch already in flight."""

    wait_slo_s: float = 2.0
    window: int = 16
    headroom: float = 1.25

    def __post_init__(self) -> None:
        if self.wait_slo_s <= 0:
            raise ValueError(f"wait_slo_s must be > 0, got {self.wait_slo_s}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.headroom <= 0:
            raise ValueError(f"headroom must be > 0, got {self.headroom}")


class AdmissionController:
    """Per-class service-time estimator + admit/reject decision.

    The queue calls :meth:`observe` after every completed dispatch
    (measured ``busy_s`` of the batch, on the injectable clock) and
    :meth:`decide` on every submit.  The derived per-class depth bound
    is ``(floor(wait_slo_s / (headroom * est_batch_s)) + 1) * b_max``
    jobs — expressed below as a wait projection so the reject response
    can carry an honest ``retry_after_s``.
    """

    def __init__(self, config: AdmissionConfig | None = None):
        self.config = config or AdmissionConfig()
        # class key -> deque of recent batch service seconds (median
        # estimator; see AdmissionConfig.window for why not an EWMA).
        self._obs: dict = {}

    def estimate(self, key) -> float | None:
        """Median batch-service seconds for a class over the recent
        window (None before the first observation)."""
        obs = self._obs.get(key)
        return statistics.median(obs) if obs else None

    def observe(self, key, busy_s: float) -> None:
        obs = self._obs.get(key)
        if obs is None:
            obs = self._obs[key] = collections.deque(
                maxlen=self.config.window)
        obs.append(busy_s)

    def reset(self, key=None) -> None:
        """Forget observations (one class, or all): the estimator
        restarts cold and admits until re-measured."""
        if key is None:
            self._obs.clear()
        else:
            self._obs.pop(key, None)

    def projected_wait_s(self, key, depth: int, b_max: int) -> float | None:
        """Projected enqueue->dispatch wait of a job joining a class
        bin that already holds ``depth`` jobs (None = no estimate
        yet): ``floor(depth/b_max)`` FULL batches must complete before
        the job's own batch can dispatch, each costing one estimated
        service window.  The job's own batch service is deliberately
        NOT counted — the SLO defends queue wait (enqueue->dispatch),
        and a job joining an empty bin dispatches within the linger
        window regardless of how long its batch then runs; counting
        the own-batch window would permanently lock out any class
        whose batch service exceeds ``slo/headroom`` even at depth 0
        (rejecting traffic an idle server could serve)."""
        est = self.estimate(key)
        if est is None:
            return None
        return (depth // b_max) * est * self.config.headroom

    def decide(self, key, depth: int, b_max: int) -> float | None:
        """None = admit; else the ``retry_after_s`` to reject with.

        ``retry_after_s`` is how long until enough backlog has drained
        that the same projection would admit: the excess wait beyond
        the SLO, floored at one batch service window (an immediate
        resubmit would meet the same queue)."""
        projected = self.projected_wait_s(key, depth, b_max)
        if projected is None or projected <= self.config.wait_slo_s:
            return None
        est = self.estimate(key) * self.config.headroom
        return max(projected - self.config.wait_slo_s, est)


@dataclasses.dataclass
class AutotuneConfig:
    """Knobs of the measured-service ``b_max`` autotuner.  ``min_obs``
    is the per-rung warm window: a rung is a candidate only after that
    many batches DISPATCHED AT IT have been measured, so a retune only
    ever moves to a rung the class has already served."""

    min_obs: int = 3
    window: int = 16

    def __post_init__(self) -> None:
        if self.min_obs < 1:
            raise ValueError(f"min_obs must be >= 1, got {self.min_obs}")
        if self.window < self.min_obs:
            raise ValueError(
                f"window ({self.window}) must be >= min_obs "
                f"({self.min_obs})")


class BmaxAutotuner:
    """Per-class ``b_max`` selection from MEASURED service curves:
    instead of trusting the ``ServeConfig.b_max`` constant, pick the
    BATCH_SIZES rung that maximizes projected goodput
    ``rung / est_batch_s(rung)`` among the rungs the class can serve
    INSIDE the wait SLO.  The curve comes from the same injectable-clock
    service observations the admission estimator keeps, separated by
    the rung the batch actually dispatched at (open-loop traffic
    naturally samples several rungs via linger/drain partials).

    Feasibility mirrors the admission projection: a rung whose
    headroom-scaled batch service exceeds the SLO would force every job
    that queues behind ONE full batch past its wait target — a default
    ``b_max=64`` whose batch costs seconds against a 500 ms SLO is the
    motivating misconfiguration.  When no measured rung is feasible the
    tuner falls back to the fastest measured one (least-infeasible:
    strictly better than staying on a slower rung).

    Candidates are clamped to rungs with >= ``min_obs`` observations,
    so a retune never selects a rung the class has not served."""

    def __init__(self, admission: AdmissionConfig,
                 config: AutotuneConfig | None = None):
        self.slo_s = admission.wait_slo_s
        self.headroom = admission.headroom
        self.config = config or AutotuneConfig()
        # (class key, rung) -> deque of batch service seconds
        self._obs: dict = {}

    def observe(self, key, rung: int, busy_s: float) -> None:
        """One dispatched batch of ``rung`` padded rows took ``busy_s``
        (pack + execute, on the injectable clock)."""
        if rung < 1:
            return
        obs = self._obs.get((key, rung))
        if obs is None:
            obs = self._obs[(key, rung)] = collections.deque(
                maxlen=self.config.window)
        obs.append(busy_s)

    def curve(self, key) -> dict:
        """The measured service curve: {rung: median batch seconds} over
        rungs past their warm window (the candidate set)."""
        out = {}
        for (k, rung), obs in self._obs.items():
            if k == key and len(obs) >= self.config.min_obs:
                out[rung] = statistics.median(obs)
        return out

    def pick(self, key, cap: int) -> int | None:
        """The goodput-optimal measured rung <= ``cap`` (None before
        any rung clears its warm window).  SLO-feasible rungs
        (``est * headroom <= slo``) compete on projected goodput
        ``rung / est``; with none feasible the fastest measured rung
        wins (least-infeasible)."""
        curve = {r: est for r, est in self.curve(key).items() if r <= cap}
        if not curve:
            return None
        feasible = {r: est for r, est in curve.items()
                    if est * self.headroom <= self.slo_s}
        if feasible:
            return max(feasible, key=lambda r: r / max(feasible[r], 1e-9))
        return min(curve, key=curve.get)
