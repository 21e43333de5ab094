#!/usr/bin/env python3
"""Readings of the correctness check, for setting its limits: the system
and the control, each on its own seeds, at the cell's own size, in one
process.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6]

Per seed, the system answers every input graph once (one solve, or each
batch of the pool once) and the control (the plain reference with its
sums in float32) answers the same graphs; each is judged as a run's
window is (``harness/check.py``).  One JSON line a reading on standard
output, with each submission's seconds and phase-0 sweeps.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import cells, check, main, spec  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def program_answers(cell, inputs, device) -> tuple:
    """The system's answers to every input graph, and the seconds and
    phase-0 sweeps of each submission (one solve or batch)."""
    graphs = cells.ingest(inputs)
    program = cells.Program(cell.traffic, device)
    answers = [[] for _ in inputs.graphs]
    units = []
    for idx in cells.submissions(inputs):
        t0 = time.perf_counter()
        got, res, _ = program.run([graphs[i] for i in idx], None)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        units.append((time.perf_counter() - t0,
                      max(cells.phase0_sweeps(r) for r in res)))
        for j, i in enumerate(idx):
            answers[i].append(got[j] if j < len(got) else None)
    return answers, units


def control_answers(inputs, device) -> list:
    control = cells.Control(device)
    return [[control.answer(*g)] for g in inputs.graphs]


def reading(cell, seed: int, who: str, device) -> dict:
    seed = main.run_seed(seed)
    t0 = time.perf_counter()
    inputs = cells.make_inputs(cell, seed, device)
    units = None
    if who == "program":
        answers, units = program_answers(cell, inputs, device)
    else:
        answers = control_answers(inputs, device)
    t1 = time.perf_counter()
    verdict = check.judge(inputs.graphs, answers,
                          main.compare_set(cell, seed, len(inputs.graphs)),
                          cell.traffic["limits"], device)
    return {"who": who, "seed": seed, "numbers": verdict.numbers,
            "correct": verdict.correct, "answer_s": t1 - t0,
            "check_s": time.perf_counter() - t1, "units": units}


def run(cell, seeds: list, control_seeds: list, device, out=sys.stdout):
    for who, ss in (("program", seeds), ("control", control_seeds)):
        for s in ss:
            print(json.dumps(reading(cell, s, who, device)), file=out,
                  flush=True)


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    args = p.parse_args(argv)
    cell = spec.find_cell(args.workload)
    try:
        main.require_cards(int(cell.workload["chips"]))
    except main.NoCard as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    run(cell, args.seeds, args.control_seeds, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(cli())
