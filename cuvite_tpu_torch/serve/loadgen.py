"""Open-loop load generation: drive a LouvainServer to saturation (port
of ``cuvite_tpu/serve/loadgen.py``).

Job k arrives at ``t0 + k/rate`` whether or not the server kept up, so
queue growth under overload shows instead of hiding in client
backpressure; arrivals are stamped with their scheduled time
(``submit(t_submit=...)``).  :func:`run_open_loop` runs one rate against
a fresh server (serially, or through the PipelinedDispatcher with
``pipelined=True``); :func:`run_mixed_open_loop` offers a skewed
two-class mix (:func:`mix_schedule`) and reports the per-class split;
:func:`saturation_sweep` ramps the rate geometrically to the highest
sustainable one.  Everything runs on the server's injectable
clock/sleep pair; this module runs no device code.
"""

from __future__ import annotations

import dataclasses

from cuvite_tpu_torch.serve.admission import AdmissionReject
from cuvite_tpu_torch.serve.queue import LouvainServer, percentile


@dataclasses.dataclass
class LoadReport:
    """One open-loop run's outcome (rates in jobs/s, waits seconds)."""

    rate: float               # offered arrival rate
    offered: int              # jobs the schedule presented
    done: int
    failed: int
    rejected: int
    shed: int
    wall_s: float             # first arrival -> queue fully drained
    goodput_jobs_per_s: float
    wait_p50_s: float
    wait_p95_s: float
    stats: dict               # final ServeStats snapshot
    results: list             # [(job_id, LouvainResult), ...] completed
    conservation: dict        # LouvainServer.conservation() at the end

    @property
    def reject_rate(self) -> float:
        return self.rejected / max(self.offered, 1)

    @property
    def shed_rate(self) -> float:
        return self.shed / max(self.offered, 1)

    def row(self) -> dict:
        """Compact dict for sweep tables / logs."""
        return {
            "rate": round(self.rate, 3),
            "offered": self.offered,
            "done": self.done,
            "rejected": self.rejected,
            "shed": self.shed,
            "failed": self.failed,
            "goodput_jobs_per_s": round(self.goodput_jobs_per_s, 3),
            "wait_p50_ms": round(self.wait_p50_s * 1e3, 3),
            "wait_p95_ms": round(self.wait_p95_s * 1e3, 3),
        }


def run_open_loop(server: LouvainServer, graphs, rate: float, *,
                  tenants: int = 1, deadline_s: float | None = None,
                  max_wall_s: float = 3600.0,
                  pipelined: bool = False) -> LoadReport:
    """Offer ``graphs`` to ``server`` at ``rate`` jobs/s (open loop),
    then drain; the server must be FRESH (stats start at zero).

    ``tenants`` spreads jobs round-robin over that many tenant ids
    (exercising the fairness pop); ``deadline_s`` attaches a relative
    deadline to every job (the shedding path).  ``max_wall_s`` bounds
    a pathological run on the server's clock (e.g. a misconfigured
    rate of 1e-9) — it raises rather than spins forever.

    ``pipelined`` drives the server through the two-stage
    PipelinedDispatcher (serve/pipeline.py) instead of the in-loop
    ``step()`` calls: host pack of batch k+1 overlaps device execution
    of batch k, the pipeline A/B's measured arm.  Pipelined runs need
    the REAL clock/sleep pair (the seam threads block on production
    primitives); fake-clock tests drive the serial path.
    """
    if rate <= 0:
        raise ValueError(f"rate must be > 0 jobs/s, got {rate}")
    if pipelined:
        return _run_open_loop_pipelined(
            server, graphs, rate, tenants=tenants, deadline_s=deadline_s,
            max_wall_s=max_wall_s)
    clock, sleep = server.clock, server.sleep
    poll_s = max(min(server.config.linger_s / 2.0, 0.01), 1e-4)
    finished: list = []
    rejected = 0
    t0 = clock()
    i = 0
    n = len(graphs)
    while True:
        now = clock()
        if now - t0 > max_wall_s:
            raise TimeoutError(
                f"open-loop run exceeded max_wall_s={max_wall_s}")
        while i < n and t0 + i / rate <= now:
            try:
                server.submit(graphs[i], tenant=f"t{i % tenants}",
                              deadline_s=deadline_s,
                              t_submit=t0 + i / rate)
            except AdmissionReject:
                rejected += 1
            i += 1
        before = len(finished)
        finished.extend(server.step())
        if i >= n:
            if server.pending() == 0:
                break
            if len(finished) == before:
                # Nothing was due (a partial bin waiting out its
                # linger): advance the clock toward the deadline
                # instead of spinning — on a fake clock this sleep IS
                # what moves time.
                sleep(poll_s)
            continue
        now = clock()
        next_arrival = t0 + i / rate
        if next_arrival > now:
            sleep(min(next_arrival - now, poll_s))
    wall = clock() - t0
    stats = server.stats.to_dict()
    cons = server.conservation()
    with server.stats.lock:
        samples = list(server.stats.wait_samples)
    return LoadReport(
        rate=rate, offered=n, done=stats["jobs_done"],
        failed=stats["jobs_failed"], rejected=rejected,
        shed=stats["jobs_shed"], wall_s=wall,
        goodput_jobs_per_s=stats["jobs_done"] / max(wall, 1e-9),
        wait_p50_s=percentile(samples, 50.0),
        wait_p95_s=percentile(samples, 95.0),
        stats=stats, results=finished, conservation=cons)


def _run_open_loop_pipelined(server: LouvainServer, graphs, rate: float, *,
                             tenants: int, deadline_s: float | None,
                             max_wall_s: float) -> LoadReport:
    """The pipelined arm of :func:`run_open_loop`: submissions feed the
    PipelinedDispatcher's intake lock; the packer/executor seam-threads
    do the dispatching; the report is assembled after a full drain."""
    from cuvite_tpu_torch.serve.pipeline import PipelinedDispatcher

    clock, sleep = server.clock, server.sleep
    pipe = PipelinedDispatcher(
        server, poll_s=max(min(server.config.linger_s / 2.0, 0.01), 1e-3))
    pipe.start()
    rejected = 0
    t0 = clock()
    n = len(graphs)
    for i, g in enumerate(graphs):
        target = t0 + i / rate
        now = clock()
        if target > now:
            sleep(target - now)
        try:
            pipe.submit(g, tenant=f"t{i % tenants}",
                        deadline_s=deadline_s, t_submit=target)
        except AdmissionReject:
            rejected += 1
    pipe.request_drain()
    if not pipe.wait_done(timeout=max_wall_s):
        raise TimeoutError(
            f"pipelined open-loop run exceeded max_wall_s={max_wall_s}")
    wall = clock() - t0
    stats = server.stats.to_dict()
    cons = server.conservation()
    with server.stats.lock:
        samples = list(server.stats.wait_samples)
    return LoadReport(
        rate=rate, offered=n, done=stats["jobs_done"],
        failed=stats["jobs_failed"], rejected=rejected,
        shed=stats["jobs_shed"], wall_s=wall,
        goodput_jobs_per_s=stats["jobs_done"] / max(wall, 1e-9),
        wait_p50_s=percentile(samples, 50.0),
        wait_p95_s=percentile(samples, 95.0),
        stats=stats, results=pipe.results, conservation=cons)


@dataclasses.dataclass
class MixReport:
    """A skewed two-class open-loop run: the overall
    LoadReport plus the per-class split and the packing counters the
    packed-vs-per-class A/B compares."""

    report: LoadReport
    mix: tuple                # (n_small, n_big) offered
    classes: dict             # {'small': cls, 'big': cls}
    per_class: dict           # name -> {offered, done, goodput, waits}
    merged_batches: int
    pack_util: float
    subrow_util: float

    def row(self) -> dict:
        out = self.report.row()
        out.update({
            "merged_batches": self.merged_batches,
            "pack_util": round(self.pack_util, 4),
            "subrow_util": round(self.subrow_util, 4),
        })
        for name, blk in self.per_class.items():
            out[f"{name}_goodput_jobs_per_s"] = round(
                blk["goodput_jobs_per_s"], 3)
            out[f"{name}_wait_p95_ms"] = round(blk["wait_p95_s"] * 1e3, 3)
        return out


def mix_schedule(smalls, bigs) -> list:
    """Deterministically interleave two job pools into ONE arrival
    order with the big jobs spread evenly through it (Bresenham, no
    RNG): a 90:10 pool split yields every ~10th arrival big.  Returns
    ``[('small'|'big', graph), ...]`` consuming both pools fully."""
    total = len(smalls) + len(bigs)
    out: list = []
    si = bi = 0
    for k in range(total):
        due_big = bi * total <= k * len(bigs)
        if bi < len(bigs) and (due_big or si >= len(smalls)):
            out.append(("big", bigs[bi]))
            bi += 1
        else:
            out.append(("small", smalls[si]))
            si += 1
    return out


def run_mixed_open_loop(server: LouvainServer, smalls, bigs, rate: float, *,
                        tenants: int = 1, deadline_s: float | None = None,
                        max_wall_s: float = 3600.0,
                        pipelined: bool = False) -> MixReport:
    """Offer a SKEWED two-class mix (``smalls`` + ``bigs`` interleaved
    by :func:`mix_schedule`) at ``rate`` jobs/s and drain: with
    ``merge_packing`` on, the small-class bins should ride the big
    class's rows as fenced sub-rows instead of
    lingering for same-class batchmates.  The per-class split comes
    from the server's own ``done_by_class``/``waits_by_class``
    bookkeeping, so the serial and pipelined drives report it the same
    way."""
    from cuvite_tpu_torch.core.batch import slab_class_of

    if not smalls or not bigs:
        raise ValueError("a mixed run needs BOTH pools non-empty")
    classes = {"small": slab_class_of(smalls[0]),
               "big": slab_class_of(bigs[0])}
    if classes["small"] == classes["big"]:
        raise ValueError(
            f"mix pools share slab class {classes['small']}; a one-class "
            "mix has nothing to merge — change the big pool's size")
    schedule = mix_schedule(smalls, bigs)
    offered = {"small": len(smalls), "big": len(bigs)}
    rep = run_open_loop(server, [g for _, g in schedule], rate,
                        tenants=tenants, deadline_s=deadline_s,
                        max_wall_s=max_wall_s, pipelined=pipelined)
    split = server.stats.per_class()
    per_class = {}
    for name, cls in classes.items():
        blk = split.get(cls, {"done": 0, "wait_p50_s": 0.0,
                              "wait_p95_s": 0.0})
        per_class[name] = {
            "offered": offered[name],
            "done": blk["done"],
            "goodput_jobs_per_s": blk["done"] / max(rep.wall_s, 1e-9),
            "wait_p50_s": blk["wait_p50_s"],
            "wait_p95_s": blk["wait_p95_s"],
        }
    stats = rep.stats
    return MixReport(
        report=rep, mix=(len(smalls), len(bigs)), classes=classes,
        per_class=per_class,
        merged_batches=stats.get("merged_batches", 0),
        pack_util=stats.get("pack_util", 0.0),
        subrow_util=stats.get("subrow_util", 0.0))


def saturation_sweep(make_server, make_graphs, *, start_rate: float,
                     slo_s: float, growth: float = 1.6,
                     max_rounds: int = 8, sustain_frac: float = 0.9,
                     tenants: int = 1,
                     deadline_s: float | None = None,
                     pipelined: bool = False) -> tuple:
    """Geometric arrival-rate ramp; stops at the first UNSUSTAINABLE
    rate (goodput < sustain_frac * rate, or wait p95 past the SLO).

    ``make_server``/``make_graphs`` are zero-arg factories (each round
    needs a fresh server with zeroed stats; reusing one graph list is
    fine — factories let callers re-synthesize when graphs are
    consumed).  Returns ``(reports, best)`` where ``best`` is the last
    sustainable report (None if even ``start_rate`` overloads).
    """
    reports: list = []
    best = None
    rate = start_rate
    for _ in range(max_rounds):
        rep = run_open_loop(make_server(), make_graphs(), rate,
                            tenants=tenants, deadline_s=deadline_s,
                            pipelined=pipelined)
        reports.append(rep)
        sustainable = (rep.goodput_jobs_per_s >= sustain_frac * rate
                       and rep.wait_p95_s <= slo_s
                       and rep.rejected == 0)
        if not sustainable:
            break
        best = rep
        rate *= growth
    return reports, best
