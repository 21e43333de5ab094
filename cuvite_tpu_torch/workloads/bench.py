"""The bench harness on one CUDA card (port of
``cuvite_tpu/workloads/bench.py``): warm-up plus guarded best-of-N timed
runs, one JSON record per run, under the reference's record schema.

    python -m cuvite_tpu_torch.workloads bench --graph rmat --scale 20
    python -m cuvite_tpu_torch.workloads bench --batch 64 --batch-edges 4096
    python -m cuvite_tpu_torch.workloads bench --serve-rate 200 \\
        --batch-edges 1024 --serve-b-max 8 [--device cpu]
    python -m cuvite_tpu_torch.workloads bench --churn-frac 0.01 \\
        --scale 20 [--warm-start labels|plp|cold]

One JSON line goes to stdout; progress goes to stderr.  The schema
(``validate_record``, ``BENCH_SCHEMA_VERSION`` and its block validators)
is the reference's, so a record validates the same in both packages.

The guard.  The first timed run executes under a compile watcher; any
build (an ``nvcc`` or ``g++`` run), first library load, or first launch
of a kernel form in the process inside it aborts the bench with the log
on stderr and no JSON (rc 3), because a number that paid for a build or
a load is not a steady-state number.  CUDA loads each kernel body at its
first launch, so a form (the kernel, its body and the card,
``kernels.form_counts``) that the warm-up never launched is a load inside
the window.  The warm-up runs the same work first: the same graph, one
batch of the same class, B and engine, or one batch at every serving
rung, so every build, load and form of a timed run happens before it.

Every timed window ends with the result on the host: the drivers return
numpy labels read from the device (``louvain_phases``' final label read,
the batched engine's final gather), so the device work is done when the
clock stops and no extra ``synchronize`` is needed.

Metric: the reference application's TEPS accounting (main.cpp:448, :509),
    TEPS = sum over phases (phase_edges * phase_iterations) / clustering_s
with ``BASELINE_EDGES_PER_SEC_PER_CHIP`` and ``vs_baseline`` kept as the
reference computes them.

What differs from the reference:

- ``platform`` is ``"cuda"`` on the card and ``"cpu"`` under ``--device
  cpu``; the default is the card, and without one the bench exits 2
  (the reference probes JAX backends in a subprocess and falls back to
  the CPU).
- Records add ``device`` (the card's name), ``power_limit_w`` (from
  ``nvidia-smi``; None without it) and ``peak_alloc_bytes``
  (``torch.cuda.max_memory_allocated`` over the timed runs, reset after
  the warm-up; None on the CPU).
- ``compile_guard`` and ``compile_events`` keep their names and shape;
  their events are kernel builds and library loads
  (``obs/compile_watch.py``).
- Dropped: ``--host-devices`` (it only gives XLA virtual CPU devices)
  and the XLA compile cache.
- ``warm_subrow_rungs`` takes the queue's engine: the port runs a merged
  batch on the queue's engine, where the reference always runs its
  sub-row program.

Env knobs as in the reference: BENCH_SCALE, BENCH_EF, BENCH_GRAPH,
BENCH_ENGINE, BENCH_REPEATS, BENCH_TIME_BUDGET, BENCH_BATCH,
BENCH_BATCH_ENGINE, BENCH_SERVE_RATE, BENCH_CHURN_FRAC.  Flags override
them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from cuvite_tpu_torch import native
from cuvite_tpu_torch.core.batch import BATCH_ENGINES

_T_PROC = time.perf_counter()  # budget accounting starts at import

BASELINE_EDGES_PER_SEC_PER_CHIP = 1.0e9 / 64.0

# Bench record schema generation: v4 records are self-describing via
# this field; validate_record enforces the v4 keys.  v5 adds the
# optional `mix` block — a skewed two-class
# open-loop run's per-class goodput/wait split plus the sub-row packing
# counters; v4 records without it stay valid.
BENCH_SCHEMA_VERSION = 5

REQUIRED_RECORD_KEYS = (
    "metric", "value", "unit", "vs_baseline", "platform", "graph",
    "modularity", "phases", "compile_guard", "stages", "engine",
    "schema", "convergence_summary", "compile_events",
    "hbm_peak_by_buffer",
)

# Kernel-coverage fields every engine='pallas' record must carry (schema
# v3): without them a pallas TEPS number cannot say how much of
# the edge mass actually ran through the kernel vs the XLA fallbacks.
REQUIRED_PALLAS_KEYS = ("pallas_coverage", "pallas_width_hits")

# Per-stage wall-clock fields every record must carry (schema v2;
# coalesce_s — the device relabel+coalesce slice nested
# inside coarsen_s, the sort tax as its own gated number;
# rebin_s — the device plan re-bin of coarse bucketed
# phases, nested inside the driver's plan_s, 0.0 on the host
# BucketPlan.build path): the breakdown that makes the device-resident
# coarsening win measurable per phase instead of hiding inside one wall
# number.  Taken from the tracer of the RECORDED run
# (utils.trace.Tracer.breakdown).
REQUIRED_STAGE_KEYS = ("coarsen_s", "coalesce_s", "rebin_s", "upload_s",
                       "iterate_s")


class BenchCompileGuardError(RuntimeError):
    """The first timed run built or loaded a library, or launched a
    kernel form for the first time: the warm-up did not take every
    one-time cost, so the measurement is invalid."""

    def __init__(self, compile_log: list):
        self.compile_log = compile_log
        super().__init__(
            f"first timed run built, loaded or first launched "
            f"{len(compile_log)} librar(ies) or kernel form(s); refusing "
            "to emit a bench record")


def check_guard(watch) -> None:
    """Raise :class:`BenchCompileGuardError` if the watched window built
    or loaded a library or launched a kernel form for the first time."""
    log = list(watch.compiles) + [
        f"first launch {kernel} {body} on {card}"
        for kernel, body, card in watch.new_forms]
    if log:
        raise BenchCompileGuardError(log)


def validate_record(rec: dict) -> list:
    """Schema-violation strings for a bench record (empty = valid)."""
    problems = [f"missing key {k!r}" for k in REQUIRED_RECORD_KEYS
                if k not in rec]
    if not problems:
        if not isinstance(rec["value"], (int, float)) or rec["value"] <= 0:
            problems.append(f"non-positive value {rec['value']!r}")
        guard = rec["compile_guard"]
        if not isinstance(guard, dict) or "checked" not in guard:
            problems.append("compile_guard must carry 'checked'")
        elif guard["checked"] and guard.get("new_compiles", -1) != 0:
            problems.append("a checked record must have new_compiles == 0")
        stages = rec["stages"]
        if not isinstance(stages, dict):
            problems.append("stages must be a dict of <stage>_s seconds")
        else:
            for k in REQUIRED_STAGE_KEYS:
                v = stages.get(k)
                if not isinstance(v, (int, float)) or v < 0:
                    problems.append(
                        f"stages[{k!r}] must be a non-negative number, "
                        f"got {v!r}")
        if rec["engine"] == "pallas":
            for k in REQUIRED_PALLAS_KEYS:
                if k not in rec:
                    problems.append(
                        f"a pallas record must carry {k!r} (kernel "
                        "coverage, schema v3)")
            cov = rec.get("pallas_coverage")
            if cov is not None and not (
                    isinstance(cov, (int, float)) and 0.0 <= cov <= 1.0):
                problems.append(
                    f"pallas_coverage must be a fraction in [0, 1], "
                    f"got {cov!r}")
            hits = rec.get("pallas_width_hits")
            if "pallas_width_hits" in rec and not isinstance(hits, dict):
                problems.append("pallas_width_hits must be a dict of "
                                "width -> traversed kernel edges")
        # Schema v4: telemetry fields from the run's flight
        # recorder — per-phase convergence digests, XLA compile events
        # (module + duration), per-buffer HBM peaks.
        if not isinstance(rec["schema"], int) or rec["schema"] < 4:
            problems.append(
                f"schema must be an int >= 4, got {rec['schema']!r}")
        cs = rec["convergence_summary"]
        if not isinstance(cs, list):
            problems.append("convergence_summary must be a list of "
                            "per-phase digests")
        else:
            for i, d in enumerate(cs):
                if not isinstance(d, dict) or "iterations" not in d:
                    problems.append(
                        f"convergence_summary[{i}] must be a dict with "
                        "'iterations'")
                    break
        ce = rec["compile_events"]
        if not isinstance(ce, list) or any(
                not isinstance(e, dict) or "module" not in e for e in ce):
            problems.append("compile_events must be a list of "
                            "{'module', 'dur_s'} dicts")
        if not isinstance(rec["hbm_peak_by_buffer"], dict):
            problems.append("hbm_peak_by_buffer must be a dict of "
                            "category -> peak nbytes")
        ck = rec.get("coalesce_kernel")
        if ck is not None and not (isinstance(ck, (int, float))
                                   and 0.0 <= ck <= 1.0):
            # Optional (device-coarsening runs only): the edge-weighted
            # fraction of inter-phase coalesces that ran a dense
            # seg_coalesce engine instead of the packed-sort fallback
            # — the honesty label tools/perf_regress.py needs
            # next to a coalesce_s number.
            problems.append(
                f"coalesce_kernel must be a fraction in [0, 1], got "
                f"{ck!r}")
        rd = rec.get("rebin_device")
        if rd is not None and not (isinstance(rd, (int, float))
                                   and 0.0 <= rd <= 1.0):
            # Optional (bucketed-engine runs only): the
            # fraction of coarse phases whose bucket plan was built ON
            # DEVICE (coarsen/rebin.py) instead of by the host
            # BucketPlan.build — the arm label perf_regress needs to
            # keep device-rebin and host-rebin plan_s non-comparable.
            problems.append(
                f"rebin_device must be a fraction in [0, 1], got "
                f"{rd!r}")
        # Optional `batch` block: multi-tenant serving runs
        # carry the batch size, the serving throughput and the padding
        # tax — tools/perf_regress.py gates jobs_per_s like-for-like
        # (same slab class, same B).
        problems.extend(_validate_batch_block(rec.get("batch")))
        # Optional `serve` block: open-loop saturation runs
        # against the serving queue — goodput at an arrival rate under
        # a wait-p95 SLO, with the admission/shedding outcome rates.
        problems.extend(_validate_serve_block(rec.get("serve")))
        # Optional `stream` block: one churn batch against a
        # resident slab — cold full-run wall vs warm-start delta
        # re-cluster wall, same graph, same compile guard.
        problems.extend(_validate_stream_block(rec.get("stream")))
        # Optional `exchange` block: which SPMD exchange arm
        # the run used — a two-level record must carry its (dcn, ici)
        # factorization and per-device table/ghost bytes.
        problems.extend(_validate_exchange_block(rec.get("exchange")))
        # Optional `mix` block (schema v5): a skewed
        # two-class run — per-class goodput/wait_p95 plus the sub-row
        # packing counters of the packed-vs-per-class A/B.
        problems.extend(_validate_mix_block(rec.get("mix")))
    return problems


# Required keys of the optional `mix` bench block (schema v5): one skewed
# two-class open-loop run.  merge_packing — which A/B
# arm ran (sub-row merging on, or plain per-class queues); the
# per-class goodput/wait split is what the acceptance compares at equal
# SLO; pack_util (occupied ROWS / padded rows) vs subrow_util (real
# graphs / total sub-row slots) are the two occupancy views that
# diverge exactly when merging happens; merged_batches counts the
# dispatches that actually packed sub-rows (0 in the per-class arm, and
# perf_regress refuses to compare across arms).
REQUIRED_MIX_KEYS = ("merge_packing", "small_goodput_jobs_per_s",
                     "big_goodput_jobs_per_s", "small_wait_p95_ms",
                     "big_wait_p95_ms", "pack_util", "merged_batches",
                     "subrow_util")


def _validate_mix_block(mix) -> list:
    if mix is None:
        return []
    if not isinstance(mix, dict):
        return [f"mix must be a dict, got {type(mix).__name__}"]
    problems = [f"mix block missing key {k!r}"
                for k in REQUIRED_MIX_KEYS if k not in mix]
    if problems:
        return problems
    if not isinstance(mix["merge_packing"], bool):
        problems.append(
            f"mix.merge_packing must be a bool, got "
            f"{mix['merge_packing']!r}")
    for k in ("small_goodput_jobs_per_s", "big_goodput_jobs_per_s",
              "small_wait_p95_ms", "big_wait_p95_ms"):
        v = mix[k]
        if not isinstance(v, (int, float)) or v < 0:
            problems.append(f"mix.{k} must be non-negative, got {v!r}")
    pu = mix["pack_util"]
    if not isinstance(pu, (int, float)) or not 0.0 < pu <= 1.0:
        problems.append(
            f"mix.pack_util must be a fraction in (0, 1], got {pu!r}")
    su = mix["subrow_util"]
    if not isinstance(su, (int, float)) or not 0.0 < su <= 1.0:
        problems.append(
            f"mix.subrow_util must be a fraction in (0, 1], got {su!r}")
    mb = mix["merged_batches"]
    if not isinstance(mb, int) or mb < 0:
        problems.append(
            f"mix.merged_batches must be a non-negative int, got {mb!r}")
    if mix["merge_packing"] is False and mb != 0:
        problems.append(
            "mix.merged_batches must be 0 when merge_packing is off "
            f"(got {mb}) — the per-class arm cannot have merged")
    return problems


# Required keys of the optional `batch` bench block (schema v4): B — the
# padded batch size the compiled program ran at; jobs_per_s
# — real jobs completed per second of serving wall (packing, upload,
# phases, unpack); pack_util — real rows / padded rows (the pack tax).
# `engine` (always emitted by run_batch_bench) tags the
# batched per-phase engine so fused and bucketed serving trajectories
# never gate each other in tools/perf_regress.py; it stays OPTIONAL in
# validation — older v4 batch records could only be fused, and
# perf_regress's comparable() defaults the missing tag the same way, so
# a historical round log must not retroactively fail --self-check.
REQUIRED_BATCH_KEYS = ("B", "jobs_per_s", "pack_util")


def _validate_batch_block(batch) -> list:
    if batch is None:
        return []
    if not isinstance(batch, dict):
        return [f"batch must be a dict, got {type(batch).__name__}"]
    problems = [f"batch block missing key {k!r}"
                for k in REQUIRED_BATCH_KEYS if k not in batch]
    if problems:
        return problems
    if not isinstance(batch["B"], int) or batch["B"] < 1:
        problems.append(f"batch.B must be a positive int, "
                        f"got {batch['B']!r}")
    jps = batch["jobs_per_s"]
    if not isinstance(jps, (int, float)) or jps <= 0:
        problems.append(f"batch.jobs_per_s must be positive, got {jps!r}")
    pu = batch["pack_util"]
    if not isinstance(pu, (int, float)) or not 0.0 < pu <= 1.0:
        problems.append(
            f"batch.pack_util must be a fraction in (0, 1], got {pu!r}")
    if "engine" in batch and batch["engine"] not in BATCH_ENGINES:
        problems.append(
            f"batch.engine must be one of {BATCH_ENGINES}, "
            f"got {batch['engine']!r}")
    return problems


# Required keys of the optional `serve` bench block (schema v4): one open-
# loop load-generator run against the serving queue.
# arrival_jobs_per_s — the OFFERED rate; goodput_jobs_per_s — jobs
# actually completed per second of wall (the serving capacity number);
# wait_p95_ms vs slo_ms — whether the queue-wait SLO held;
# admission — whether admission control was on (the A/B axis of the
# overload acceptance run); reject_rate / shed_rate — the fraction of
# offered jobs terminally rejected (admission) or shed (deadline).
# perf_regress gates goodput like-for-like (same b_max, admission,
# SLO, job shape, engine, pipeline mode).  `pipelined` is
# REQUIRED: a serve record must say which dispatcher architecture ran —
# the pipelined goodput sits well above the serial one by design, so an
# untagged record would poison whichever trajectory it landed in.
# `autotuned_b_max` is optional: the rung the measured-service
# autotuner settled on, when autotuning moved the class off the config
# default.
REQUIRED_SERVE_KEYS = ("b_max", "arrival_jobs_per_s", "goodput_jobs_per_s",
                       "wait_p95_ms", "slo_ms", "admission", "reject_rate",
                       "shed_rate", "pipelined")


def _validate_serve_block(serve) -> list:
    if serve is None:
        return []
    if not isinstance(serve, dict):
        return [f"serve must be a dict, got {type(serve).__name__}"]
    problems = [f"serve block missing key {k!r}"
                for k in REQUIRED_SERVE_KEYS if k not in serve]
    if problems:
        return problems
    if not isinstance(serve["pipelined"], bool):
        problems.append(
            f"serve.pipelined must be a bool, got {serve['pipelined']!r}")
    ab = serve.get("autotuned_b_max")
    if ab is not None and (not isinstance(ab, int) or ab < 1):
        problems.append(
            f"serve.autotuned_b_max must be a positive int rung, "
            f"got {ab!r}")
    if not isinstance(serve["b_max"], int) or serve["b_max"] < 1:
        problems.append(
            f"serve.b_max must be a positive int, got {serve['b_max']!r}")
    for k in ("arrival_jobs_per_s", "goodput_jobs_per_s", "slo_ms"):
        v = serve[k]
        if not isinstance(v, (int, float)) or v <= 0:
            problems.append(f"serve.{k} must be positive, got {v!r}")
    w = serve["wait_p95_ms"]
    if not isinstance(w, (int, float)) or w < 0:
        problems.append(
            f"serve.wait_p95_ms must be non-negative, got {w!r}")
    if not isinstance(serve["admission"], bool):
        problems.append(
            f"serve.admission must be a bool, got {serve['admission']!r}")
    for k in ("reject_rate", "shed_rate"):
        v = serve[k]
        if not isinstance(v, (int, float)) or not 0.0 <= v <= 1.0:
            problems.append(
                f"serve.{k} must be a fraction in [0, 1], got {v!r}")
    if "engine" in serve and serve["engine"] not in BATCH_ENGINES:
        problems.append(
            f"serve.engine must be one of {BATCH_ENGINES}, "
            f"got {serve['engine']!r}")
    return problems


# Required keys of the optional `stream` bench block (schema v4): cold_wall_s
# — a full cold re-cluster of the post-churn graph;
# delta_wall_s — apply_delta_slab + warm-start re-cluster of the SAME
# churn on a resident session; speedup — cold/delta (the streaming
# win); frontier_frac — the delta frontier's share of vertices (how
# local the churn was — the number the speedup must be read against).
# `warm` and `churn_frac` tag the A/B arm and the churn size so
# tools/perf_regress.py gates speedup like-for-like only.
REQUIRED_STREAM_KEYS = ("cold_wall_s", "delta_wall_s", "speedup",
                        "frontier_frac")

STREAM_WARM_MODES = ("labels", "plp", "cold")


def _validate_stream_block(stream) -> list:
    if stream is None:
        return []
    if not isinstance(stream, dict):
        return [f"stream must be a dict, got {type(stream).__name__}"]
    problems = [f"stream block missing key {k!r}"
                for k in REQUIRED_STREAM_KEYS if k not in stream]
    if problems:
        return problems
    for k in ("cold_wall_s", "delta_wall_s", "speedup"):
        v = stream[k]
        if not isinstance(v, (int, float)) or v <= 0:
            problems.append(f"stream.{k} must be positive, got {v!r}")
    ff = stream["frontier_frac"]
    if not isinstance(ff, (int, float)) or not 0.0 <= ff <= 1.0:
        problems.append(
            f"stream.frontier_frac must be a fraction in [0, 1], "
            f"got {ff!r}")
    if "warm" in stream and stream["warm"] not in STREAM_WARM_MODES:
        problems.append(
            f"stream.warm must be one of {STREAM_WARM_MODES}, "
            f"got {stream['warm']!r}")
    cf = stream.get("churn_frac")
    if cf is not None and not (isinstance(cf, (int, float))
                               and 0.0 < cf < 1.0):
        problems.append(
            f"stream.churn_frac must be a fraction in (0, 1), got {cf!r}")
    return problems


# Required keys of the optional `exchange` bench block (schema v4) when the
# record ran the two-level exchange: dcn / ici — the
# hybrid-mesh factorization; table_bytes_per_device — the ICI-gathered
# group-table bytes per chip (the O(nv_total / dcn) figure the per-axis
# replication budget checks); ghost_bytes — the per-iteration DCN ghost
# payload.  Flat SPMD records carry only `mode`.  perf_regress treats
# flat and two-level records as separate arms on this block: shrinking
# the per-chip table window by |dcn| changes the exchange cost model,
# so their TEPS never gate each other.
REQUIRED_TWOLEVEL_KEYS = ("dcn", "ici", "table_bytes_per_device",
                          "ghost_bytes")

EXCHANGE_MODES = ("replicated", "sparse", "twolevel")


def _validate_exchange_block(exch) -> list:
    if exch is None:
        return []
    if not isinstance(exch, dict):
        return [f"exchange must be a dict, got {type(exch).__name__}"]
    mode = exch.get("mode")
    if mode not in EXCHANGE_MODES:
        return [f"exchange.mode must be one of {EXCHANGE_MODES}, "
                f"got {mode!r}"]
    problems = []
    if mode == "twolevel":
        problems += [f"a twolevel exchange block must carry {k!r}"
                     for k in REQUIRED_TWOLEVEL_KEYS if k not in exch]
        for k in REQUIRED_TWOLEVEL_KEYS:
            v = exch.get(k)
            if k in exch and (not isinstance(v, int) or v <= 0):
                problems.append(
                    f"exchange.{k} must be a positive int, got {v!r}")
    return problems



def _loadavg() -> float:
    try:
        with open("/proc/loadavg") as f:
            return float(f.read().split()[0])
    except OSError:  # non-Linux
        return -1.0


def _one_teps(res, wall: float) -> tuple:
    traversed = sum(p.num_edges * p.iterations for p in res.phases)
    clustering_s = sum(p.seconds for p in res.phases) or wall
    return traversed / clustering_s, clustering_s


def _power_limit_w(dev) -> float | None:
    """The card's power limit in W from ``nvidia-smi --query-gpu=name,
    power.limit``, for the card torch calls ``dev`` (through
    CUDA_VISIBLE_DEVICES); None when nvidia-smi is absent or fails."""
    import torch

    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    visible = [v.strip() for v in
               os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    smi_id = visible[idx] if idx < len(visible) else str(idx)
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={smi_id}", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.strip().splitlines()[0].rsplit(",", 1)[1])
    except (IndexError, ValueError):
        return None


class _Card:
    """Where a bench runs, and the record keys that say so."""

    def __init__(self, device=None):
        import torch

        from cuvite_tpu_torch.core.device import resolve_device

        self.dev = resolve_device(device)
        self.cuda = self.dev.type == "cuda"
        self.platform = "cuda" if self.cuda else self.dev.type
        self.fields = {
            "platform": self.platform,
            "device": (torch.cuda.get_device_name(self.dev) if self.cuda
                       else self.platform),
            "power_limit_w": _power_limit_w(self.dev) if self.cuda else None,
        }

    def reset_peak(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.reset_peak_memory_stats(self.dev)

    def peak(self) -> int | None:
        if not self.cuda:
            return None
        import torch

        return int(torch.cuda.max_memory_allocated(self.dev))


def _launches() -> dict:
    """The kernels' launch counts so far (host ints)."""
    from cuvite_tpu_torch.kernels import launch_counts

    return launch_counts()


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _telemetry(frec, tr, conv) -> dict:
    """The schema-v4 keys every record carries: stages of the recorded
    run, convergence digests, every build and load the bench saw, and
    the per-buffer memory peaks."""
    from cuvite_tpu_torch.obs import convergence_summary

    return {
        "stages": tr.breakdown(),
        "schema": BENCH_SCHEMA_VERSION,
        "convergence_summary": convergence_summary(conv),
        "compile_events": [dict(e) for e in frec.compile_events],
        "hbm_peak_by_buffer": dict(frec.ledger.peak_by_buffer),
    }


def run_bench(
    graph_source,
    *,
    engine: str = "auto",
    repeats: int = 3,
    budget_s: float = 420.0,
    device=None,
    graph_label: str = "?",
    scale: int | None = None,
    t_start: float | None = None,
    provenance: str | None = None,
) -> dict:
    """Warm-up + guarded best-of-N timed runs of ``louvain_phases`` ->
    bench record.

    ``graph_source`` is a Graph, or a zero-arg callable returning one
    per run (a factory; how the guard's own test injects a build).
    Raises :class:`BenchCompileGuardError` when the first timed run
    builds or loads a kernel library.  ``device``: None is the card."""
    from cuvite_tpu_torch.louvain.driver import louvain_phases
    from cuvite_tpu_torch.obs import NO_TRACE, CompileWatcher, \
        FlightRecorder
    from cuvite_tpu_torch.utils.trace import Tracer, rss_high_water_mb

    card = _Card(device)
    get = graph_source if callable(graph_source) else (lambda: graph_source)
    t_start = _T_PROC if t_start is None else t_start
    # One recorder for the whole bench: the warm-up's builds and loads
    # become the record's compile events, and the memory ledger peaks
    # over every run.  NO_TRACE: no emitter inside the timed windows.
    frec = FlightRecorder(NO_TRACE, watch_compiles=False)

    t1 = time.perf_counter()
    warm_tr = Tracer(recorder=frec)
    with CompileWatcher(on_event=frec._on_compile):
        res = louvain_phases(get(), engine=engine, device=card.dev,
                             tracer=warm_tr)
    warm_wall = time.perf_counter() - t1
    elapsed = time.perf_counter() - t_start

    def record(res, wall, compile_guard, all_teps=(), load=(), tr=None):
        teps, clustering_s = _one_teps(res, wall)
        best = max((teps, *all_teps))
        print(f"# Q={res.modularity:.5f} phases={len(res.phases)} "
              f"iters={res.total_iterations} clustering={clustering_s:.2f}s "
              f"wall={wall:.2f}s guard={compile_guard}", file=sys.stderr)
        out = {
            "metric": "louvain_teps_per_chip",
            "value": round(best, 1),
            "unit": "traversed_edges/sec",
            "vs_baseline": round(best / BASELINE_EDGES_PER_SEC_PER_CHIP, 4),
            **card.fields,
            "graph": graph_label,
            "modularity": round(float(res.modularity), 6),
            "phases": len(res.phases),
            "iterations": int(res.total_iterations),
            "rss_mb": round(rss_high_water_mb(), 1),
            "peak_alloc_bytes": card.peak(),
            "compile_guard": compile_guard,
            "engine": engine,
            **_telemetry(frec, tr, getattr(res, "convergence", None)),
        }
        if scale is not None:
            out["scale"] = scale
        co_total = tr.counters.get("coalesce_edges", 0)
        if co_total:
            # Edge-weighted share of the inter-phase coalesces that ran
            # the dense seg_coalesce engine instead of the sort.
            out["coalesce_kernel"] = round(
                tr.counters.get("coalesce_dense_edges", 0) / co_total, 4)
        rb_total = tr.counters.get("rebin_phases", 0)
        if rb_total:
            # Share of the coarse bucketed phases whose plan was built
            # on the device.
            out["rebin_device"] = round(
                tr.counters.get("rebin_device_phases", 0) / rb_total, 4)
        if res.pallas_coverage is not None:
            # Kernel coverage (the reference's record keys): the share of
            # the traversed edges the hand kernels swept, and the
            # traversed edges of each kernelized class by width.
            out["pallas_coverage"] = round(float(res.pallas_coverage), 4)
            out["pallas_width_hits"] = {
                str(w): int(n)
                for w, n in sorted(res.pallas_width_hits.items())}
        if not compile_guard["checked"]:
            out["compile_included"] = True
        if all_teps:
            out["runs"] = len(all_teps)
            out["teps_runs"] = [round(t, 1) for t in all_teps]
            out["spread"] = round(max(all_teps) / min(all_teps), 3)
        if load:
            out["loadavg"] = [round(x, 2) for x in load]
        if provenance:
            out["provenance"] = provenance
        return out

    if elapsed + 1.5 * warm_wall > budget_s:
        # A killed bench reports nothing; better a flagged warm-up number
        # than none.  compile_guard.checked=False marks it unguarded.
        print(f"# budget: {elapsed:.0f}s elapsed of {budget_s:.0f}s — "
              f"skipping the steady-state rerun", file=sys.stderr)
        return record(res, warm_wall,
                      {"checked": False, "reason": "budget"},
                      load=[_loadavg()], tr=warm_tr)
    del res  # free the warm-up labels before the timed runs

    card.reset_peak()
    all_teps, loads = [], [_loadavg()]
    last_res, last_wall, last_tr = None, warm_wall, warm_tr
    guard = {"checked": True, "new_compiles": 0}
    while len(all_teps) < max(1, repeats):
        elapsed = time.perf_counter() - t_start
        if all_teps and elapsed + 1.2 * last_wall > budget_s:
            print(f"# budget: stopping after {len(all_teps)} timed runs "
                  f"({elapsed:.0f}s of {budget_s:.0f}s)", file=sys.stderr)
            break
        g = get()
        t1 = time.perf_counter()
        last_tr = Tracer(recorder=frec)
        if not all_teps:
            # The gate: any build or load inside the first timed run
            # invalidates the measurement.
            before = _launches()
            calls = native.call_counts()
            with CompileWatcher(on_event=frec._on_compile) as watch:
                last_res = louvain_phases(g, engine=engine, device=card.dev,
                                          tracer=last_tr)
            check_guard(watch)
            print(f"# launches run 1: {json.dumps(_since(before))}",
                  file=sys.stderr)
            calls = {k: v - calls[k]
                     for k, v in native.call_counts().items()}
            print(f"# native calls run 1: {json.dumps(calls)}",
                  file=sys.stderr)
        else:
            last_res = louvain_phases(g, engine=engine, device=card.dev,
                                      tracer=last_tr)
        last_wall = time.perf_counter() - t1
        teps, _ = _one_teps(last_res, last_wall)
        all_teps.append(teps)
        loads.append(_loadavg())
        print(f"# run {len(all_teps)}: {teps/1e6:.2f}M TEPS "
              f"(wall {last_wall:.1f}s, load {loads[-1]:.2f})",
              file=sys.stderr)
    return record(last_res, last_wall, guard, all_teps=all_teps,
                  load=loads, tr=last_tr)


def run_batch_bench(
    *,
    B: int,
    n_jobs: int | None = None,
    edges: int = 4096,
    seed: int = 1,
    repeats: int = 3,
    budget_s: float = 420.0,
    device=None,
    engine: str = "fused",
    t_start: float | None = None,
) -> dict:
    """Batched multi-tenant serving bench: K deterministic synth
    power-law graphs (distinct splitmix64 streams) through
    ``louvain_many`` in chunks of ``B``, guarded like the TEPS bench.  The
    record keeps the standard schema (metric = aggregate TEPS over all
    tenants) and adds the ``batch`` block: B, jobs/s of the best pass,
    pack_util, the slab class, the engine.  Under ``engine='bucketed'``
    the bucket-plan geometry is pinned over the whole job set
    (``core.batch.bucket_shape_for``), as the reference pins it.

    ``n_jobs`` defaults to 3*B, rounded up to a multiple of B, so every
    pass runs whole batches of the class, B and engine the warm-up ran.
    """
    from cuvite_tpu_torch.core.batch import bucket_shape_for, slab_class_of
    from cuvite_tpu_torch.louvain.driver import louvain_many
    from cuvite_tpu_torch.obs import NO_TRACE, CompileWatcher, \
        FlightRecorder
    from cuvite_tpu_torch.utils.trace import Tracer, rss_high_water_mb
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    t_start = _T_PROC if t_start is None else t_start
    B = int(B)
    if B < 1:
        raise ValueError(f"--batch must be >= 1, got {B}")
    if engine not in BATCH_ENGINES:
        raise ValueError(f"--batch-engine must be one of {BATCH_ENGINES}, "
                         f"got {engine!r}")
    card = _Card(device)
    if n_jobs is None:
        n_jobs = 3 * B
    n_jobs = max(B, ((n_jobs + B - 1) // B) * B)
    graphs = [synthesize_graph(edges, seed=many_seed(seed, k))
              for k in range(n_jobs)]
    # One slab class (and one bucket geometry) for the whole set, so
    # every chunk is the batch the warm-up ran.
    cls = tuple(max(d) for d in zip(*(slab_class_of(g) for g in graphs)))
    shape = bucket_shape_for(graphs) if engine == "bucketed" else None
    chunks = [graphs[i:i + B] for i in range(0, n_jobs, B)]
    frec = FlightRecorder(NO_TRACE, watch_compiles=False)

    def many(chunk, tracer):
        return louvain_many(chunk, b_pad=B, slab_class=cls, engine=engine,
                            bucket_shape=shape, device=card.dev,
                            tracer=tracer)

    def one_pass(tracer, launches=None):
        t0 = time.perf_counter()
        results = []
        for chunk in chunks:
            before = _launches()
            results.extend(many(chunk, tracer).results)
            if launches is not None:
                launches.append(_since(before))
        wall = time.perf_counter() - t0
        traversed = sum(p.num_edges * p.iterations
                        for r in results for p in r.phases)
        return results, wall, traversed, len(chunks)

    # Warm-up: one chunk launches every kernel form a pass launches (the
    # same class, B and engine; the coarse phases' shrink takes the same
    # arm on this homogeneous set).
    with CompileWatcher(on_event=frec._on_compile):
        many(chunks[0], Tracer(recorder=frec))

    card.reset_peak()
    best = None
    guard = {"checked": True, "new_compiles": 0}
    passes = 0
    while passes < max(1, repeats):
        elapsed = time.perf_counter() - t_start
        if best is not None and elapsed + 1.2 * best[1] > budget_s:
            print(f"# budget: stopping after {passes} timed passes",
                  file=sys.stderr)
            break
        tr = Tracer(recorder=frec)
        if passes == 0:
            launches = []
            with CompileWatcher(on_event=frec._on_compile) as watch:
                out = one_pass(tr, launches)
            check_guard(watch)
            print(f"# launches pass 1, by batch: {json.dumps(launches)}",
                  file=sys.stderr)
        else:
            out = one_pass(tr)
        passes += 1
        if best is None or out[1] < best[1]:
            best = out + (tr,)
        print(f"# pass {passes}: {n_jobs / out[1]:.1f} jobs/s "
              f"(wall {out[1]:.2f}s)", file=sys.stderr)

    results, wall, traversed, batches, tr = best
    teps = traversed / wall
    qs = [float(r.modularity) for r in results]
    return {
        "metric": "louvain_teps_per_chip",
        "value": round(teps, 1),
        "unit": "traversed_edges/sec",
        "vs_baseline": round(teps / BASELINE_EDGES_PER_SEC_PER_CHIP, 4),
        **card.fields,
        "graph": f"synthpl-{edges}x{n_jobs}",
        # Mean per-tenant Q (every tenant is an independent clustering).
        "modularity": round(sum(qs) / len(qs), 6),
        "phases": sum(len(r.phases) for r in results),
        "iterations": sum(int(r.total_iterations) for r in results),
        "rss_mb": round(rss_high_water_mb(), 1),
        "peak_alloc_bytes": card.peak(),
        "compile_guard": guard,
        "engine": "batched",
        # Tenant 0's convergence stands in for the batch.
        **_telemetry(frec, tr, getattr(results[0], "convergence", None)),
        "batch": {
            "B": int(B),
            "jobs_per_s": round(n_jobs / wall, 2),
            "pack_util": round(n_jobs / (batches * B), 4),
            "n_jobs": int(n_jobs),
            "batches": int(batches),
            "class": list(cls),
            "edges_each": int(edges),
            "engine": engine,
        },
    }


def warm_serve_rungs(graphs, b_max: int, engine: str,
                     device=None) -> tuple:
    """Serve-path warm-up: one batch at every BATCH_SIZES rung <= ``b_max``
    with the job-set-pinned bucket geometry, because open-loop arrivals
    dispatch partial batches whose padded size can be any rung.  Returns
    ``(slab_class, shape)`` for pinning the server.  Raises when the job
    set straddles slab classes (the queue would split it over several
    bins)."""
    from cuvite_tpu_torch.core.batch import (
        BATCH_SIZES,
        batch_pad,
        bucket_shape_for,
        slab_class_of,
    )
    from cuvite_tpu_torch.louvain.driver import louvain_many

    # ServeConfig rounds b_max up to a rung; warm the rounded ladder.
    b_max = min(batch_pad(b_max), BATCH_SIZES[-1])
    classes = {slab_class_of(g) for g in graphs}
    if len(classes) != 1:
        raise ValueError(
            f"serve job set straddles slab classes {sorted(classes)}; "
            "pick an edge count away from a pow2 boundary so the queue "
            "serves one bin")
    cls = classes.pop()
    shape = bucket_shape_for(graphs) if engine == "bucketed" else None
    for r in (r for r in BATCH_SIZES if r <= b_max):
        louvain_many(graphs[:r], b_pad=r, slab_class=cls, engine=engine,
                     bucket_shape=shape, device=device)
    return cls, shape


def _serve_block(rep, server_stats: dict, *, b_max, engine, pipelined,
                 rate, slo_ms, admission, edges, linger_ms) -> dict:
    return {
        "b_max": int(b_max),
        "engine": engine,
        "pipelined": bool(pipelined),
        "overlap_frac": server_stats["overlap_frac"],
        "pack_s": server_stats["pack_s"],
        "device_s": server_stats["device_s"],
        "arrival_jobs_per_s": round(rate, 3),
        "goodput_jobs_per_s": round(rep.goodput_jobs_per_s, 3),
        "wait_p50_ms": round(rep.wait_p50_s * 1e3, 3),
        "wait_p95_ms": round(rep.wait_p95_s * 1e3, 3),
        "slo_ms": float(slo_ms),
        "slo_met": bool(rep.wait_p95_s * 1e3 <= slo_ms),
        "admission": bool(admission),
        "reject_rate": round(rep.reject_rate, 4),
        "shed_rate": round(rep.shed_rate, 4),
        "offered": int(rep.offered),
        "done": int(rep.done),
        "rejected": int(rep.rejected),
        "shed": int(rep.shed),
        "failed": int(rep.failed),
        "edges_each": int(edges),
        "linger_ms": float(linger_ms),
        "wall_s": round(rep.wall_s, 3),
        "conservation": dict(rep.conservation),
    }


def _served_record(rep, card, frec, tr, graph: str) -> dict:
    """The standard keys of a serving run's record."""
    from cuvite_tpu_torch.utils.trace import rss_high_water_mb

    if not rep.results:
        raise RuntimeError("serve bench completed no jobs (everything "
                           "rejected or shed); lower the rate")
    if not rep.conservation["ok"]:
        raise RuntimeError(
            f"job-conservation violation: {rep.conservation}")
    results = [r for _, r in rep.results]
    traversed = sum(p.num_edges * p.iterations
                    for r in results for p in r.phases)
    teps = traversed / max(rep.wall_s, 1e-9)
    qs = [float(r.modularity) for r in results]
    return {
        "metric": "louvain_teps_per_chip",
        "value": round(teps, 1),
        "unit": "traversed_edges/sec",
        "vs_baseline": round(teps / BASELINE_EDGES_PER_SEC_PER_CHIP, 4),
        **card.fields,
        "graph": graph,
        "modularity": round(sum(qs) / len(qs), 6),
        "phases": sum(len(r.phases) for r in results),
        "iterations": sum(int(r.total_iterations) for r in results),
        "rss_mb": round(rss_high_water_mb(), 1),
        "peak_alloc_bytes": card.peak(),
        "compile_guard": {"checked": True, "new_compiles": 0},
        "engine": "batched",
        **_telemetry(frec, tr, getattr(results[0], "convergence", None)),
    }


def run_serve_bench(
    *,
    rate: float,
    b_max: int = 8,
    edges: int = 1024,
    n_jobs: int | None = None,
    seed: int = 1,
    slo_ms: float = 500.0,
    admission: bool = True,
    linger_ms: float = 20.0,
    deadline_ms: float | None = None,
    tenants: int = 1,
    engine: str = "bucketed",
    device=None,
    budget_s: float = 420.0,
    pipelined: bool = False,
    autotune: bool = False,
    t_start: float | None = None,
) -> dict:
    """Open-loop serving bench: offer ``n_jobs`` deterministic synth
    graphs to a fresh ``LouvainServer`` at ``rate`` jobs/s (scheduled
    arrival stamps, ``serve/loadgen.py``), then drain; the record carries
    the ``serve`` block (goodput at the offered rate, queue-wait p95
    against the SLO, reject/shed rates).  ``admission=False`` is the
    overload arm; ``pipelined`` drives the two-stage dispatcher;
    ``autotune`` the measured-service b_max tuner (needs admission).
    The warm-up runs one batch at every rung <= ``b_max``
    (:func:`warm_serve_rungs`); the open loop then runs under the guard.
    """
    from cuvite_tpu_torch.core.batch import BATCH_SIZES, batch_pad
    from cuvite_tpu_torch.obs import NO_TRACE, CompileWatcher, \
        FlightRecorder
    from cuvite_tpu_torch.serve import AdmissionConfig, LouvainServer, \
        ServeConfig
    from cuvite_tpu_torch.serve.loadgen import run_open_loop
    from cuvite_tpu_torch.utils.trace import Tracer
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    t_start = _T_PROC if t_start is None else t_start
    if rate <= 0:
        raise ValueError(f"--serve-rate must be > 0 jobs/s, got {rate}")
    if engine not in BATCH_ENGINES:
        raise ValueError(f"serve engine must be one of {BATCH_ENGINES}, "
                         f"got {engine!r}")
    if autotune and not admission:
        raise ValueError("--serve-autotune needs admission on (the "
                         "tuner reads the admission SLO + estimator)")
    card = _Card(device)
    # Round to the rung ServeConfig serves at.
    b_max = min(batch_pad(int(b_max)), BATCH_SIZES[-1])
    if n_jobs is None:
        n_jobs = max(4 * b_max, 32)
    graphs = [synthesize_graph(edges, seed=many_seed(seed, k))
              for k in range(n_jobs)]
    frec = FlightRecorder(NO_TRACE, watch_compiles=False)
    with CompileWatcher(on_event=frec._on_compile):
        cls, shape = warm_serve_rungs(graphs, b_max, engine, card.dev)
    elapsed = time.perf_counter() - t_start
    if elapsed > budget_s:
        raise RuntimeError(
            f"serve bench warm-up alone spent {elapsed:.0f}s of the "
            f"{budget_s:.0f}s budget; shrink --serve-b-max/--batch-edges")

    config = ServeConfig(
        b_max=b_max, linger_s=linger_ms / 1e3, engine=engine,
        device=card.dev,
        admission=(AdmissionConfig(wait_slo_s=slo_ms / 1e3)
                   if admission else None),
        autotune_b_max=bool(autotune))
    tr = Tracer(recorder=frec)
    server = LouvainServer(config, tracer=tr)
    if shape is not None:
        server.pin_shape(cls, shape)
    card.reset_peak()
    with CompileWatcher(on_event=frec._on_compile) as watch:
        rep = run_open_loop(
            server, graphs, rate, tenants=tenants,
            deadline_s=(deadline_ms / 1e3 if deadline_ms is not None
                        else None),
            max_wall_s=max(budget_s - elapsed, 30.0), pipelined=pipelined)
    check_guard(watch)
    rec = _served_record(rep, card, frec, tr,
                         f"synthpl-{edges}x{n_jobs}-serve")
    print(f"# serve: rate={rate:.1f}/s goodput="
          f"{rep.goodput_jobs_per_s:.1f}/s wait_p95="
          f"{rep.wait_p95_s * 1e3:.0f}ms (slo {slo_ms:.0f}ms) "
          f"rejected={rep.rejected} shed={rep.shed}", file=sys.stderr)
    serve = _serve_block(rep, server.stats.to_dict(), b_max=b_max,
                         engine=engine, pipelined=pipelined, rate=rate,
                         slo_ms=slo_ms, admission=admission, edges=edges,
                         linger_ms=linger_ms)
    tuned = server.autotuned()
    if tuned:
        serve["autotuned_b_max"] = int(next(iter(tuned.values())))
    rec["serve"] = serve
    return rec


def warm_subrow_rungs(smalls, layout, b_max: int, engine: str,
                      device=None) -> None:
    """Merged-batch warm-up: one packed batch at every rows rung <=
    ``b_max`` under ``layout`` on the queue's ``engine`` (a merge pops up
    to ``b_max * n_sub`` jobs, so packed dispatches pad to any rows
    rung)."""
    from cuvite_tpu_torch.core.batch import BATCH_SIZES, batch_pad
    from cuvite_tpu_torch.louvain.batched import cluster_packed

    b_max = min(batch_pad(int(b_max)), BATCH_SIZES[-1])
    for r in (r for r in BATCH_SIZES if r <= b_max):
        take = min(r * layout.n_sub, len(smalls))
        cluster_packed(smalls[:take], layout, b_pad=r, engine=engine,
                       device=device)


def run_mixed_serve_bench(
    *,
    rate: float,
    merge_packing: bool,
    b_max: int = 4,
    small_edges: int = 1024,
    big_scale: int = 13,
    big_edge_factor: int = 2,
    n_small: int | None = None,
    n_big: int | None = None,
    seed: int = 1,
    slo_ms: float = 500.0,
    linger_ms: float = 20.0,
    engine: str = "bucketed",
    device=None,
    budget_s: float = 420.0,
    pipelined: bool = False,
    t_start: float | None = None,
) -> dict:
    """Skewed two-class open-loop serving bench: a 90:10 small:big
    arrival mix (``mix_schedule``) offered at ``rate`` jobs/s to one
    server, drained, and reported with the per-class split; the
    ``merge_packing`` flag is the A/B axis (small-class bins may pack as
    fenced sub-rows of the big class's rows).  The warm-up covers every
    plain rung of both classes and, in the merged arm, every packed rows
    rung; the timed loop runs under the guard."""
    from cuvite_tpu_torch.core.batch import (
        BATCH_SIZES,
        batch_pad,
        slab_class_of,
        subrow_layout_for,
    )
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.obs import NO_TRACE, CompileWatcher, \
        FlightRecorder
    from cuvite_tpu_torch.serve import AdmissionConfig, LouvainServer, \
        ServeConfig
    from cuvite_tpu_torch.serve.loadgen import run_mixed_open_loop
    from cuvite_tpu_torch.utils.trace import Tracer
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    t_start = _T_PROC if t_start is None else t_start
    if rate <= 0:
        raise ValueError(f"mix rate must be > 0 jobs/s, got {rate}")
    card = _Card(device)
    b_max = min(batch_pad(int(b_max)), BATCH_SIZES[-1])
    # 90:10 by count: nine smalls per big.
    if n_big is None:
        n_big = max(2 * b_max, 8)
    if n_small is None:
        n_small = 9 * n_big
    smalls = [synthesize_graph(small_edges, seed=many_seed(seed, k))
              for k in range(n_small)]
    bigs = [generate_rmat(big_scale, edge_factor=big_edge_factor,
                          seed=seed * 1000 + k) for k in range(n_big)]
    cls_s, cls_b = slab_class_of(smalls[0]), slab_class_of(bigs[0])
    layout = subrow_layout_for(cls_s, cls_b)
    if layout is None:
        raise ValueError(
            f"big class {cls_b} is not an exact pow2 sub-row multiple of "
            f"small class {cls_s}; pick big_scale/big_edge_factor so the "
            "mix has a packable layout")
    frec = FlightRecorder(NO_TRACE, watch_compiles=False)
    with CompileWatcher(on_event=frec._on_compile):
        _, shape_s = warm_serve_rungs(smalls, b_max, engine, card.dev)
        _, shape_b = warm_serve_rungs(bigs, b_max, engine, card.dev)
        if merge_packing:
            warm_subrow_rungs(smalls, layout, b_max, engine, card.dev)
    elapsed = time.perf_counter() - t_start
    if elapsed > budget_s:
        raise RuntimeError(
            f"mix bench warm-up alone spent {elapsed:.0f}s of the "
            f"{budget_s:.0f}s budget; shrink b_max or the pools")

    config = ServeConfig(
        b_max=b_max, linger_s=linger_ms / 1e3, engine=engine,
        device=card.dev,
        admission=AdmissionConfig(wait_slo_s=slo_ms / 1e3),
        merge_packing=bool(merge_packing))
    tr = Tracer(recorder=frec)
    server = LouvainServer(config, tracer=tr)
    if shape_s is not None:
        server.pin_shape(cls_s, shape_s)
    if shape_b is not None:
        server.pin_shape(cls_b, shape_b)
    card.reset_peak()
    with CompileWatcher(on_event=frec._on_compile) as watch:
        mrep = run_mixed_open_loop(
            server, smalls, bigs, rate,
            max_wall_s=max(budget_s - elapsed, 30.0), pipelined=pipelined)
    check_guard(watch)
    rep = mrep.report
    rec = _served_record(rep, card, frec, tr,
                         f"mixpl-{small_edges}x{n_small}"
                         f"+rmat{big_scale}ef{big_edge_factor}x{n_big}")
    small, big = mrep.per_class["small"], mrep.per_class["big"]
    print(f"# mix[{'packed' if merge_packing else 'per-class'}]: "
          f"rate={rate:.1f}/s goodput={rep.goodput_jobs_per_s:.1f}/s "
          f"small p95={small['wait_p95_s'] * 1e3:.0f}ms "
          f"big p95={big['wait_p95_s'] * 1e3:.0f}ms "
          f"merged={mrep.merged_batches} "
          f"subrow_util={mrep.subrow_util:.2f}", file=sys.stderr)
    rec["serve"] = dict(
        _serve_block(rep, rep.stats, b_max=b_max, engine=engine,
                     pipelined=pipelined, rate=rate, slo_ms=slo_ms,
                     admission=True, edges=small_edges,
                     linger_ms=linger_ms),
        merge_packing=bool(merge_packing))
    rec["mix"] = {
        "merge_packing": bool(merge_packing),
        "ratio": [int(n_small), int(n_big)],
        "small_class": list(cls_s),
        "big_class": list(cls_b),
        "n_sub": int(layout.n_sub),
        "small_goodput_jobs_per_s": round(small["goodput_jobs_per_s"], 3),
        "big_goodput_jobs_per_s": round(big["goodput_jobs_per_s"], 3),
        "small_wait_p95_ms": round(small["wait_p95_s"] * 1e3, 3),
        "big_wait_p95_ms": round(big["wait_p95_s"] * 1e3, 3),
        "small_done": int(small["done"]),
        "big_done": int(big["done"]),
        "pack_util": round(mrep.pack_util, 4),
        "subrow_util": round(mrep.subrow_util, 4),
        "merged_batches": int(mrep.merged_batches),
    }
    return rec


def run_churn_bench(
    *,
    churn_frac: float,
    scale: int,
    edge_factor: int = 16,
    warm: str = "labels",
    seed: int = 1,
    device=None,
    budget_s: float = 420.0,
    t_start: float | None = None,
) -> dict:
    """Streaming warm-start bench: ONE deterministic churn batch
    (``churn_frac`` of the undirected pairs deleted, as many inserted;
    ``workloads/synth.churn_batches``) against an R-MAT ``scale`` graph,
    measured two ways on one resident session:

    * cold -- the session re-clusters the pre-churn slab from scratch
      (``warm='cold'``: identity seed, every vertex active), the full
      re-run a deployment without streaming pays per update;
    * delta -- the session ingests the batch (``apply_delta``) and
      re-clusters with ``warm`` seeding (previous labels and the delta
      frontier, or the PLP prepass).

    The warm-up runs both arms end to end on a throwaway session first;
    the timed arms then run under the guard (no kernel build or library
    load may fall inside them).  The record carries the ``stream`` block
    (cold_wall_s, delta_wall_s, speedup, frontier_frac); its Q is the
    delta arm's, the number the golden envelope judges.
    """
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.obs import NO_TRACE, CompileWatcher, \
        FlightRecorder
    from cuvite_tpu_torch.stream import DeltaBatch, StreamSession
    from cuvite_tpu_torch.utils.trace import Tracer, rss_high_water_mb
    from cuvite_tpu_torch.workloads.synth import churn_batches

    t_start = _T_PROC if t_start is None else t_start
    if not 0.0 < churn_frac < 1.0:
        raise ValueError(
            f"--churn-frac must be in (0, 1), got {churn_frac}")
    if warm not in STREAM_WARM_MODES:
        raise ValueError(f"--warm-start must be one of "
                         f"{STREAM_WARM_MODES}, got {warm!r}")
    card = _Card(device)

    t0 = time.perf_counter()
    graph = generate_rmat(scale, edge_factor=edge_factor, seed=seed)
    print(f"# graph: rmat scale={scale} nv={graph.num_vertices} "
          f"ne={graph.num_edges} gen={time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    batch = DeltaBatch.from_edits(
        graph.num_vertices,
        **churn_batches(graph, frac=churn_frac, seed=seed)[0])

    frec = FlightRecorder(NO_TRACE, watch_compiles=False)
    with CompileWatcher(on_event=frec._on_compile):
        wsess = StreamSession.from_graph(graph, device=card.dev)
        wsess.recluster(warm="cold")
        wsess.apply_delta(batch)
        wsess.recluster(warm=warm)
        del wsess
    elapsed = time.perf_counter() - t_start
    if elapsed > budget_s:
        raise RuntimeError(
            f"churn bench warm-up alone spent {elapsed:.0f}s of the "
            f"{budget_s:.0f}s budget; shrink --scale")

    tr = Tracer(recorder=frec)
    sess = StreamSession.from_graph(graph, tracer=tr, device=card.dev)
    card.reset_peak()
    before = _launches()
    with CompileWatcher(on_event=frec._on_compile) as watch:
        t1 = time.perf_counter()
        res_cold = sess.recluster(warm="cold")
        cold_wall = time.perf_counter() - t1
        t1 = time.perf_counter()
        info = sess.apply_delta(batch)
        res_warm = sess.recluster(warm=warm)
        delta_wall = time.perf_counter() - t1
    check_guard(watch)
    print(f"# launches run 1: {json.dumps(_since(before))}",
          file=sys.stderr)

    teps, _clustering_s = _one_teps(res_cold, cold_wall)
    speedup = cold_wall / max(delta_wall, 1e-9)
    print(f"# stream: cold={cold_wall:.2f}s delta={delta_wall:.2f}s "
          f"speedup={speedup:.1f}x frontier={info['frontier_frac']:.4f} "
          f"Q_cold={res_cold.modularity:.5f} "
          f"Q_warm={res_warm.modularity:.5f}", file=sys.stderr)
    return {
        "metric": "louvain_teps_per_chip",
        "value": round(teps, 1),
        "unit": "traversed_edges/sec",
        "vs_baseline": round(teps / BASELINE_EDGES_PER_SEC_PER_CHIP, 4),
        **card.fields,
        "graph": f"rmat{scale}",
        "scale": int(scale),
        # The DELTA arm's quality: a warm start that converged somewhere
        # worse must not hide behind the cold run's Q.
        "modularity": round(float(res_warm.modularity), 6),
        "phases": len(res_warm.phases),
        "iterations": int(res_warm.total_iterations),
        "rss_mb": round(rss_high_water_mb(), 1),
        "peak_alloc_bytes": card.peak(),
        "compile_guard": {"checked": True, "new_compiles": 0},
        "engine": "fused",
        **_telemetry(frec, tr, res_warm.convergence),
        "stream": {
            "cold_wall_s": round(cold_wall, 4),
            "delta_wall_s": round(delta_wall, 4),
            "speedup": round(speedup, 3),
            "frontier_frac": round(float(info["frontier_frac"]), 5),
            "warm": warm,
            "churn_frac": float(churn_frac),
            "n_ins": int(info["n_ins"]),
            "n_del": int(info["n_del"]),
            "modularity_cold": round(float(res_cold.modularity), 6),
        },
    }


def _build_parser() -> argparse.ArgumentParser:
    env = os.environ
    p = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.workloads bench",
        description="guarded Louvain TEPS benchmark on one CUDA card")
    p.add_argument("--file", help="Vite binary graph input")
    p.add_argument("--bits64", action="store_true")
    p.add_argument("--graph", default=env.get("BENCH_GRAPH", "rmat"),
                   choices=["rmat", "rgg"],
                   help="generated-graph kind when --file is absent")
    p.add_argument("--scale", type=int,
                   default=int(env["BENCH_SCALE"])
                   if "BENCH_SCALE" in env else None)
    p.add_argument("--edge-factor", type=int,
                   default=int(env.get("BENCH_EF", "16")))
    p.add_argument("--engine", default=env.get("BENCH_ENGINE", "auto"),
                   choices=["auto", "bucketed", "pallas", "sort", "fused"])
    p.add_argument("--repeats", type=int,
                   default=int(env.get("BENCH_REPEATS", "3")))
    p.add_argument("--budget", type=float,
                   default=float(env.get("BENCH_TIME_BUDGET", "420")))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; no card: "
                        "exit 2); 'cpu' runs the kernels' plain versions")
    p.add_argument("--out", metavar="FILE",
                   help="also write the JSON record to FILE")
    b = p.add_argument_group("batched multi-tenant serving")
    b.add_argument("--batch", type=int, metavar="B",
                   default=int(env["BENCH_BATCH"])
                   if "BENCH_BATCH" in env else None,
                   help="serve K synth power-law graphs through "
                        "louvain_many in chunks of B; the record carries "
                        "the `batch` block (jobs_per_s, pack_util)")
    b.add_argument("--batch-engine", default=env.get("BENCH_BATCH_ENGINE",
                                                     "fused"),
                   choices=list(BATCH_ENGINES),
                   help="batched engine: 'fused' (sort sweeps every "
                        "phase) or 'bucketed' (phase 0 on the row and "
                        "heavy kernels, coarse phases re-binned)")
    b.add_argument("--batch-jobs", type=int, default=None,
                   help="total jobs K (default 3*B, rounded up to a "
                        "multiple of B)")
    b.add_argument("--batch-edges", type=int, default=4096,
                   help="directed edge records per synthetic graph")
    s = p.add_argument_group("open-loop serving bench")
    s.add_argument("--serve-rate", type=float, metavar="JOBS_PER_S",
                   default=float(env["BENCH_SERVE_RATE"])
                   if "BENCH_SERVE_RATE" in env else None,
                   help="offer synth jobs to the serving queue at this "
                        "open-loop arrival rate; the record carries the "
                        "`serve` block.  Uses --batch-edges / "
                        "--batch-engine / --batch-jobs for the job set")
    s.add_argument("--serve-b-max", type=int, default=8,
                   help="serving queue b_max (BATCH_SIZES rung)")
    s.add_argument("--serve-slo-ms", type=float, default=500.0,
                   help="queue-wait p95 SLO the admission controller "
                        "defends")
    s.add_argument("--serve-admission", default="on", choices=["on", "off"],
                   help="'off' is the overload arm: no intake bound")
    s.add_argument("--serve-linger-ms", type=float, default=20.0)
    s.add_argument("--serve-deadline-ms", type=float, default=None,
                   help="attach a relative deadline to every job "
                        "(exercises shedding)")
    s.add_argument("--serve-tenants", type=int, default=1,
                   help="spread jobs round-robin over N tenant ids")
    s.add_argument("--serve-pipeline", default="off", choices=["on", "off"],
                   help="'on' drives the two-stage pipelined dispatcher")
    s.add_argument("--serve-autotune", action="store_true",
                   help="measured-service b_max autotuning (needs "
                        "admission on)")
    c = p.add_argument_group("streaming churn bench")
    c.add_argument("--churn-frac", type=float, metavar="FRAC",
                   default=float(env["BENCH_CHURN_FRAC"])
                   if "BENCH_CHURN_FRAC" in env else None,
                   help="one deterministic churn batch (FRAC of the "
                        "undirected pairs deleted + as many inserted) "
                        "against an rmat --scale graph: cold full "
                        "re-cluster vs apply_delta + warm-start "
                        "re-cluster on a resident session; the record "
                        "carries the `stream` block (cold_wall_s, "
                        "delta_wall_s, speedup, frontier_frac)")
    c.add_argument("--warm-start", default="labels",
                   choices=list(STREAM_WARM_MODES),
                   help="delta-arm seeding: 'labels' (previous run's "
                        "labels + delta frontier), 'plp' (the "
                        "label-propagation prepass), or 'cold' "
                        "(identity, the null arm)")
    return p


def _emit(rec: dict, out: str | None) -> int:
    problems = validate_record(rec)
    if problems:
        print(f"# BENCH ABORTED: invalid record: {problems}",
              file=sys.stderr)
        return 4
    line = json.dumps(rec)
    print(line)
    if out:
        with open(out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.churn_frac is not None:
        if args.batch is not None or args.serve_rate is not None:
            print("# --churn-frac, --batch and --serve-rate are "
                  "different benches; pick one", file=sys.stderr)
            return 2
        if args.file:
            print("# --churn-frac generates its own rmat graph: --file "
                  "does not apply (use --scale)", file=sys.stderr)
            return 2
    if args.serve_rate is not None and args.batch is not None:
        print("# --serve-rate and --batch are different benches; pick one",
              file=sys.stderr)
        return 2
    if (args.serve_rate is not None or args.batch is not None) and (
            args.file or args.scale is not None):
        print("# --serve-rate/--batch are the synthetic serving benches: "
              "--file/--scale do not apply (use --batch-edges/"
              "--batch-jobs to shape the job set)", file=sys.stderr)
        return 2
    if args.batch is not None and args.batch < 1:
        print(f"# --batch must be >= 1, got {args.batch}", file=sys.stderr)
        return 2
    if args.batch is not None and args.engine != "auto":
        print(f"# --batch ignores --engine {args.engine!r}: the batched "
              "driver takes --batch-engine {fused,bucketed}",
              file=sys.stderr)
    from cuvite_tpu_torch.core.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"# {e}", file=sys.stderr)
        return 2
    try:
        if args.churn_frac is not None:
            rec = run_churn_bench(
                churn_frac=args.churn_frac,
                scale=args.scale if args.scale is not None else (
                    18 if dev.type == "cpu" else 20),
                edge_factor=args.edge_factor, warm=args.warm_start,
                device=dev, budget_s=args.budget)
        elif args.serve_rate is not None:
            rec = run_serve_bench(
                rate=args.serve_rate, b_max=args.serve_b_max,
                edges=args.batch_edges, n_jobs=args.batch_jobs,
                slo_ms=args.serve_slo_ms,
                admission=args.serve_admission == "on",
                linger_ms=args.serve_linger_ms,
                deadline_ms=args.serve_deadline_ms,
                tenants=args.serve_tenants, engine=args.batch_engine,
                device=dev, budget_s=args.budget,
                pipelined=args.serve_pipeline == "on",
                autotune=args.serve_autotune)
        elif args.batch is not None:
            rec = run_batch_bench(
                B=args.batch, n_jobs=args.batch_jobs,
                edges=args.batch_edges, repeats=args.repeats,
                budget_s=args.budget, device=dev,
                engine=args.batch_engine)
        else:
            graph, kw = _graph_of(args, dev)
            rec = run_bench(graph, engine=args.engine, repeats=args.repeats,
                            budget_s=args.budget, device=dev, **kw)
    except BenchCompileGuardError as e:
        print(f"# BENCH ABORTED: {e}", file=sys.stderr)
        for line in e.compile_log:
            print(f"#   {line[:200]}", file=sys.stderr)
        print("# no JSON emitted: the warm-up did not launch every kernel "
              "the timed run launched", file=sys.stderr)
        return 3
    return _emit(rec, args.out)


def _graph_of(args, dev) -> tuple:
    """(graph, keyword arguments of run_bench) for the per-graph bench."""
    if args.file:
        from cuvite_tpu_torch.io.vite import read_vite
        from cuvite_tpu_torch.workloads.registry import load_provenance

        prov = load_provenance(args.file)
        return read_vite(args.file, bits64=args.bits64), {
            "graph_label": os.path.basename(args.file), "scale": None,
            "provenance": prov.get("source") if prov else None}
    scale = args.scale if args.scale is not None else (
        18 if dev.type == "cpu" else 20)
    from cuvite_tpu_torch.io.generate import generate_rgg, generate_rmat

    t0 = time.perf_counter()
    if args.graph == "rgg":
        graph = generate_rgg(1 << scale, seed=1)
    else:
        graph = generate_rmat(scale, edge_factor=args.edge_factor, seed=1)
    print(f"# graph: {args.graph} scale={scale} "
          f"nv={graph.num_vertices} ne={graph.num_edges} "
          f"gen={time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return graph, {"graph_label": f"{args.graph}{scale}", "scale": scale,
                   "provenance": "generated"}


if __name__ == "__main__":
    sys.exit(main())
