"""One run of one cell: set-up, the measured window, the check, and the
result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

With ``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` the window runs under ``torch.profiler`` and the result
carries its per-layer metrics, ``busy_s``, ``window_s`` and a
``breakdown``.  The last line of standard output is the result, one JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error.  Without a CUDA card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded once the window closes,
the run exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark.harness import cells, check, spec, trace
from benchmark.harness.tracer import PREFIX, BenchTracer

FORBIDDEN = ("jax", "jaxlib", "flax", "cuvite_tpu")


class NoCard(RuntimeError):
    """The run cannot measure: no card, or too few."""


class Forbidden(RuntimeError):
    """JAX or the JAX package was loaded in the measuring process."""


@dataclasses.dataclass
class Run:
    """What the metric readers read (``benchmark/metrics/<name>.py``)."""

    cell: spec.Cell
    kind: str                   # the card's name
    setup_s: float
    window: cells.Window
    peak_window_bytes: int
    tracer: BenchTracer | None
    trace: trace.TraceSummary | None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def require_cards(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: this benchmark measures the card and "
                     "does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} visible")


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_seed(seed: int) -> int:
    """The run's seed as the generators take it (non-negative, 63 bits)."""
    return seed % (1 << 63)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_process: float, log=sys.stderr) -> dict:
    """Set up, measure, check; returns the result object.  ``device``:
    'cuda' on the card; 'cpu' only in the tests, which drive the rest of
    a run without a card."""
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def annotate(name):
        return (torch.profiler.record_function(PREFIX + name) if traced
                else contextlib.nullcontext())

    seed = run_seed(seed)
    marks = [("start", time.perf_counter() - t_process)]
    inputs = cells.make_inputs(cell, seed, device)
    marks.append(("inputs", time.perf_counter() - t_process))
    graphs = cells.ingest(inputs)
    marks.append(("ingest", time.perf_counter() - t_process))
    program = cells.Program(cell.traffic, device)
    cells.warm_up(inputs, graphs, program, sync)
    marks.append(("warm-up", time.perf_counter() - t_process))
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    tracer = BenchTracer(batch=program.loop == "batch") if traced else None
    prof = trace.profile(traced and on_card)
    from cuvite_tpu_torch.obs.compile_watch import CompileWatcher

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process
    with CompileWatcher() as watch, \
            (prof if prof is not None else contextlib.nullcontext()):
        with annotate("window"):
            window = cells.run_window(inputs, graphs, program, seconds,
                                      tracer, sync, annotate)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if watch.compiles or watch.new_forms:
        print(f"# inside the window: builds/loads {watch.compiles}, forms "
              f"first launched {watch.new_forms}", file=log)
    print("# set-up marks (s since start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in marks), file=log)
    summary = None
    if prof is not None:
        t0 = time.perf_counter()
        summary = trace.reduce_events(trace.export_events(prof))
        del prof
        print(f"# trace read in {time.perf_counter() - t0:.3f} s; phase-0 "
              f"span against the system's phase-0 iterate seconds: "
              f"{window.phase0_check}", file=log)
    run = Run(cell=cell, kind=kind, setup_s=setup_s, window=window,
              peak_window_bytes=peak, tracer=tracer, trace=summary)
    metrics = read_metrics(cell.per_layer if traced else cell.end_to_end,
                           run, required=on_card and not traced)

    # The check: with the system's state freed, the reference judges.
    del graphs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    verdict = check.judge(inputs.graphs, window.answers,
                          compare_set(cell, seed, len(inputs.graphs)),
                          cell.traffic["limits"], device)
    check_s = time.perf_counter() - t0
    print("# unit seconds: " + " ".join(
        f"{x:.3f}" for x in window.unit_seconds), file=log)
    print(f"# set-up {setup_s:.3f} s; {window.units} units in "
          f"{window.seconds:.3f} s; phase-0 "
          f"sweeps {window.phase0_sweeps}; check {check_s:.3f} s; "
          f"{power_limit() if on_card else 'cpu'}", file=log)
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": verdict.correct, "attempted": verdict.attempted,
              "failed": verdict.failed, "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
        print(f"# trace: {summary.kernels} kernels, {summary.unattributed} "
              f"without their launch", file=log)
    result["checks"] = verdict.as_dict()
    for line in verdict.lines():
        print(line, file=log)
    return result


def compare_set(cell: spec.Cell, seed: int, n: int) -> set:
    """The graphs whose labels are compared with the reference's: all, or
    ``check_graphs`` of them drawn from the seed."""
    k = int(cell.traffic.get("check_graphs", n))
    if k >= n:
        return set(range(n))
    rng = np.random.default_rng([seed, 0x636865636B])
    return {int(i) for i in rng.choice(n, size=k, replace=False)}


def read_metrics(entries: list, run: Run, required: bool) -> dict:
    out = {}
    for m in entries:
        value = spec.metric_reader(m["name"])(run)
        if value is None:
            if required:
                raise RuntimeError(f"metric {m['name']} read nothing")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, t_process: float | None = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse(argv)
    try:
        cell = spec.find_cell(args.workload)
        require_cards(int(cell.workload["chips"]))
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", t_process)
        # Last before the result: what the readers and the check loaded
        # counts too.
        loaded = forbidden_modules()
        if loaded:
            raise Forbidden(f"modules of JAX or the JAX package loaded: "
                            f"{', '.join(loaded)}")
    except NoCard as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (KeyError, Forbidden) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
