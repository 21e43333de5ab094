"""Inputs, the system under test, and the measured window of each kind of
cell.

A cell's traffic file names its ``loop``:

- ``solve``: a pool of ``pool_graphs`` graphs of the configuration (one
  unless the file says more), clustered one after another, cycled, by
  ``louvain_phases(graph, engine=...)``, each solve ending with its labels
  on the host;
- ``batch``: a pool of ``pool_graphs`` graphs in batches of the
  configuration's ``batch``, cycled in a closed loop, each batch submitted
  to ``louvain_many(graphs, engine=...)`` when the last one's labels are
  back.

The set-up makes the inputs from the seed, hands them to the system's
ingest (``Graph.from_edges``) and runs every shape of the window once.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.traffic import graph500, lfr


@dataclasses.dataclass
class Inputs:
    graphs: list        # [(nv, src, dst)] host arrays, as handed over
    batch: int          # graphs a submission; 1 for a solve loop


def make_inputs(cell, seed: int, device) -> Inputs:
    """The cell's pool of ``pool_graphs`` input graphs (default 1), each
    drawn from ``seed``."""
    cfg, traffic = cell.config, cell.traffic
    count = int(traffic.get("pool_graphs", 1))
    if cfg["generator"] == "graph500":
        graphs = []
        for k in range(count):
            nv, src, dst = graph500.generate(cfg, seed, device, k)
            graphs.append((nv, src.to(torch.int32).cpu().numpy(),
                           dst.to(torch.int32).cpu().numpy()))
            del src, dst
    elif cfg["generator"] == "lfr":
        graphs = lfr.generate_pool(cfg, count, seed)
    else:
        raise ValueError(f"unknown generator {cfg['generator']!r}")
    return Inputs(graphs=graphs, batch=int(cfg.get("batch", 1)))


def ingest(inputs: Inputs) -> list:
    """The system's graphs, built by its own ingest."""
    from cuvite_tpu_torch import Graph

    return [Graph.from_edges(nv, src, dst) for nv, src, dst in inputs.graphs]


class Program:
    """The system under test: the port's public entries."""

    def __init__(self, traffic: dict, device):
        self.loop = traffic["loop"]
        self.engine = traffic["engine"]
        self.device = None if torch.device(device).type == "cuda" else device

    def run(self, graphs: list, tracer) -> tuple:
        """One submission: (answers [(labels, Q)], results, pack seconds
        or None).  A solve loop submits one graph, a batch loop a batch."""
        if self.loop == "solve":
            from cuvite_tpu_torch import louvain_phases

            (graph,) = graphs
            r = louvain_phases(graph, engine=self.engine, device=self.device,
                               tracer=tracer)
            return [(r.communities, r.modularity)], [r], None
        from cuvite_tpu_torch import louvain_many

        br = louvain_many(graphs, engine=self.engine, device=self.device,
                          tracer=tracer)
        return ([(r.communities, r.modularity) for r in br.results],
                br.results, br.pack_s)


def submissions(inputs: Inputs) -> list:
    """The input graphs' indices, one list a submission, in the order a
    loop cycles through them."""
    n, b = len(inputs.graphs), inputs.batch
    return [list(range(k * b, min((k + 1) * b, n)))
            for k in range(max(n // b, 1))]


class Control:
    """The plain reference in the system's place, its sums taken in
    float32: one step below the float64 the configuration states."""

    def __init__(self, device):
        self.device = device

    def answer(self, nv: int, src: np.ndarray, dst: np.ndarray) -> tuple:
        """(labels, Q) of one input graph."""
        from benchmark.reference import louvain as ref

        g = ref.build_graph(nv, torch.from_numpy(src).to(self.device),
                            torch.from_numpy(dst).to(self.device))
        labels, q, _ = ref.louvain(g, acc=torch.float32)
        return labels.cpu().numpy(), q


@dataclasses.dataclass
class Window:
    seconds: float                # start of the first unit to end of last
    units: int                    # solves or batches completed
    jobs: int                     # graphs answered (a solve is one job)
    answers: list                 # per input graph: [(labels, Q) | None]
    unit_seconds: list            # submission to labels, a solve or batch
    pack_s: list                  # a batch's host pack, from the system
    least_bytes: int              # phase-0 least bytes over the units
    phase0_sweeps: list           # phase-0 sweeps of each unit
    # The first solve's phase-0 span (tracer) beside the seconds the
    # system books to its phase 0's iterate stage: equal when the span
    # holds phase 0 alone.
    phase0_check: tuple | None = None


def phase0_sweeps(result) -> int:
    return int(result.convergence[0].iterations) if result.convergence \
        else 0


def run_window(inputs: Inputs, graphs: list, program: Program, seconds: float,
               tracer, sync, annotate) -> Window:
    """Units back to back until ``seconds`` have passed; the last unit
    runs to its end.  ``graphs`` are the system's ingested graphs,
    ``sync`` waits for the device, ``annotate(name)`` opens a host range
    of the trace."""
    from benchmark.harness.stats import least_sweep_bytes

    answers: list = [[] for _ in inputs.graphs]
    unit_s, pack_s, p0 = [], [], []
    least = jobs = 0
    subs = submissions(inputs)
    check0 = None
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        idx = subs[len(unit_s) % len(subs)]
        if tracer is not None:
            tracer.begin_unit(len(unit_s))
        t0 = time.perf_counter()
        with annotate(program.loop):
            got, res, pk = program.run([graphs[i] for i in idx], tracer)
        sync()
        t1 = time.perf_counter()
        unit_s.append(t1 - t0)
        jobs += len(idx)
        for j, i in enumerate(idx):
            answers[i].append(got[j] if j < len(got) else None)
        if pk is not None:
            pack_s.append(pk)
        sweeps = 0
        for i, r in zip(idx, res):
            s0 = phase0_sweeps(r)
            least += least_sweep_bytes(s0, graphs[i].num_vertices,
                                       graphs[i].num_edges)
            sweeps = max(sweeps, s0)
        p0.append(sweeps)
        if (check0 is None and tracer is not None
                and program.loop == "solve" and res[0].phases):
            span = [x.seconds for x in tracer.spans
                    if x.unit == len(unit_s) - 1 and x.name == "phase0"]
            check0 = (span[0] if span else None,
                      res[0].phases[0].stages.get("iterate"))
        if t1 >= deadline:
            break
    return Window(seconds=time.perf_counter() - t_start, units=len(unit_s),
                  jobs=jobs, answers=answers, unit_seconds=unit_s,
                  pack_s=pack_s, least_bytes=least, phase0_sweeps=p0,
                  phase0_check=check0)


def warm_up(inputs: Inputs, graphs: list, program: Program, sync) -> None:
    """Every shape of the window once: each graph or batch of the pool."""
    for idx in submissions(inputs):
        program.run([graphs[i] for i in idx], None)
    sync()
