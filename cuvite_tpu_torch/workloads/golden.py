"""Golden result envelopes for workload runs (port of
``cuvite_tpu/workloads/golden.py:35-154``).  ``golden.json`` beside this
module is a copy of the reference's registry, byte for byte.

The reference's de-facto correctness oracle is "run the pipeline, compare
against known-good output" (its -g ground-truth path).  This module is
the per-dataset generalization: a checked-in JSON registry maps
``<dataset>/<config>`` keys to expected envelopes for modularity Q,
phase count, community count and (when ground truth exists) F-score.
``verify-golden`` runs fail when a measurement leaves its envelope;
``--update-golden`` re-derives envelopes from a fresh measurement using
the tolerance model below (so updating is one deliberate command, not a
hand-edit).

Tolerance model (envelope = measured value ± slack):
  * Q: ±``q_tol`` absolute (default 0.01 — cross-platform f32 reduction
    order moves Q by ~1e-6; a real quality regression moves it by >0.01);
  * phases: ±``phase_slack`` (count is discrete and stable);
  * communities: ±``comm_rel`` relative (default 10%);
  * F-score: -``f_tol`` one-sided (better-than-golden never fails).
"""

from __future__ import annotations

import json
import os

DEFAULT_GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden.json")
GOLDEN_VERSION = 1

Q_TOL = 0.01
PHASE_SLACK = 1
COMM_REL = 0.10
F_TOL = 0.02


def golden_key(dataset: str, config: str = "default") -> str:
    return f"{dataset}/{config}"


def load_golden(path: str = DEFAULT_GOLDEN_PATH) -> dict:
    if not os.path.exists(path):
        return {"version": GOLDEN_VERSION, "entries": {}}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != GOLDEN_VERSION:
        raise ValueError(f"golden registry {path!r}: unsupported version "
                         f"{data.get('version')!r}")
    return data


def save_golden(data: dict, path: str = DEFAULT_GOLDEN_PATH) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


def envelope_from_measurement(measured: dict, q_tol: float = Q_TOL,
                              phase_slack: int = PHASE_SLACK,
                              comm_rel: float = COMM_REL,
                              f_tol: float = F_TOL) -> dict:
    """Derive a golden envelope from one measured run (the
    ``--update-golden`` path)."""
    q = float(measured["modularity"])
    phases = int(measured["phases"])
    comms = int(measured["communities"])
    env = {
        "q": [round(q - q_tol, 6), round(q + q_tol, 6)],
        "phases": [max(1, phases - phase_slack), phases + phase_slack],
        "communities": [int(comms * (1 - comm_rel)),
                        int(comms * (1 + comm_rel)) + 1],
        "measured": {"modularity": round(q, 6), "phases": phases,
                     "communities": comms},
    }
    if measured.get("f_score") is not None:
        f = float(measured["f_score"])
        env["f_score_min"] = round(f - f_tol, 6)
        env["measured"]["f_score"] = round(f, 6)
    if measured.get("provenance") is not None:
        env["provenance"] = measured["provenance"]
    return env


def check_envelope(entry: dict, measured: dict) -> list:
    """Violation strings for ``measured`` against golden ``entry``
    (empty list = within envelope)."""
    problems = []
    q = float(measured["modularity"])
    lo, hi = entry["q"]
    if not (lo <= q <= hi):
        problems.append(f"Q={q:.6f} outside [{lo}, {hi}]")
    phases = int(measured["phases"])
    lo, hi = entry["phases"]
    if not (lo <= phases <= hi):
        problems.append(f"phases={phases} outside [{lo}, {hi}]")
    comms = int(measured["communities"])
    lo, hi = entry["communities"]
    if not (lo <= comms <= hi):
        problems.append(f"communities={comms} outside [{lo}, {hi}]")
    f_min = entry.get("f_score_min")
    if f_min is not None:
        f = measured.get("f_score")
        if f is None:
            problems.append("golden pins an F-score but the run has no "
                            "ground truth to compare against")
        elif float(f) < f_min:
            problems.append(f"f_score={float(f):.6f} below {f_min}")
    return problems


def measure_run(communities, res, truth_path: str | None = None,
                zero_based_truth: bool = False,
                provenance: str | None = None) -> dict:
    """Distill a clustering result into the measurement dict the golden
    machinery consumes; wires evaluate.compare when truth exists."""
    measured = {
        "modularity": float(res.modularity),
        "phases": len(res.phases),
        "communities": int(res.num_communities),
        "iterations": int(res.total_iterations),
        "provenance": provenance,
    }
    if truth_path:
        from cuvite_tpu_torch.evaluate.compare import (
            compare_communities, load_ground_truth,
        )

        truth = load_ground_truth(truth_path, zero_based=zero_based_truth)
        cmp_res = compare_communities(truth, communities)
        measured["f_score"] = float(cmp_res.f_score)
        measured["precision"] = float(cmp_res.precision)
        measured["recall"] = float(cmp_res.recall)
    return measured


def verify(dataset: str, config: str, measured: dict,
           path: str = DEFAULT_GOLDEN_PATH,
           update: bool = False) -> tuple:
    """Check (or, with ``update``, record) a measurement.

    Returns ``(ok, problems)``; a missing entry is a failure unless
    updating (a golden gate that silently passes on absent goldens
    would never catch a deleted entry).
    """
    data = load_golden(path)
    key = golden_key(dataset, config)
    if update:
        data["entries"][key] = envelope_from_measurement(measured)
        save_golden(data, path)
        return True, []
    entry = data["entries"].get(key)
    if entry is None:
        return False, [f"no golden entry for {key!r} in {path} "
                       "(run with --update-golden to record one)"]
    problems = check_envelope(entry, measured)
    return not problems, problems
