"""Multi-phase Louvain driver on one device (port of
``cuvite_tpu/louvain/driver.py``, the single-shard ``bucketed`` and
``sort`` engines).

Replicates the reference application loop (main.cpp:218-495,
louvain.cpp:425-588): per-phase sweeps until the modularity gain drops
below the threshold, keeping the last assignment whose gain passed;
threshold cycling 1e-3 -> 1e-6 over a 13-phase cycle with the final 1e-6
safety pass; coarsening and cross-phase label composition; at most 200
phases and 10,000 iterations.

Engines (``engine=``): ``'bucketed'`` (and ``'auto'``, as in the
reference, ``driver.py:1866``) sweeps the degree-bucketed plan on the
row-argmax and heavy-bincount kernels, builds each phase's plan on the
host and coarsens on the host.  ``'sort'`` keeps the edge slab on the
card, sweeps it with ``louvain_step_local`` and coarsens it on the card
(``coarsen/device.py``, the ``seg_coalesce`` kernel for classes with
nv_pad <= 4096): phases after the first get their graph from that device
transition, as a resident slab plus ``SlabMeta``, with one host read of
the coarse edge count per phase (``driver.py:2310-2368``).  Labels are
composed on the host in both.

Differences from the reference, by design rather than fault:

- Torch has no device while-loop, so the phase loop reads the stop flag on
  the host once per sweep (one 0-dim f64 fetch); the reference runs the
  whole phase in one ``lax.while_loop`` and syncs once per phase.
- The in-loop Q is float64 on the device.  The reference's is float32 (or
  double-single pairs), so a gain within f32 rounding of the threshold can
  end a phase one sweep apart from the reference.
- The reported per-phase Q is the host f64 oracle for the bucketed engine
  and an f64 pass over the resident slab for the sort engine, as in the
  reference (which uses ds32 pairs there).
- No accumulator tag feeds the coalesce engine choice: every float sum
  is f64 on the port, so there is no ds32 mode to route to the sort.

Not ported yet: multi-GPU (meshes, exchanges), the fused engine, early
termination (ET), coloring / vertex ordering, checkpointing and device
re-binning.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from cuvite_tpu_torch.coarsen.device import (
    device_coarsen_enabled,
    device_coarsen_slab,
    maybe_shrink_to_class,
)
from cuvite_tpu_torch.coarsen.rebuild import coarsen_graph, \
    renumber_communities
from cuvite_tpu_torch.core.distgraph import DistGraph
from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import (
    MAX_TOTAL_ITERATIONS,
    TERMINATION_PHASE_COUNT,
)
from cuvite_tpu_torch.louvain.bucketed import (
    BucketPlan,
    DevicePlan,
    bucketed_step,
)
from cuvite_tpu_torch.kernels.seg_coalesce import coalesce_engine
from cuvite_tpu_torch.louvain.precise import phase_modularity
from cuvite_tpu_torch.louvain.step import louvain_step_local

ENGINES = ("bucketed", "sort")


def threshold_for_phase(short_phase: int) -> float:
    """Threshold-cycling schedule (main.cpp:225-237)."""
    sp = short_phase % 13
    if sp <= 2:
        return 1.0e-3
    if sp <= 6:
        return 1.0e-4
    if sp <= 9:
        return 1.0e-5
    return 1.0e-6


@dataclasses.dataclass
class PhaseStats:
    phase: int
    modularity: float
    iterations: int
    num_vertices: int
    num_edges: int
    seconds: float
    # Host seconds by stage: plan (host bucket plan or slab, upload),
    # iterate (the sweeps, each ending in the host read of Q), evaluate
    # (the reported Q), coarsen (coarsening after the phase; not part of
    # ``seconds``).
    stages: dict = dataclasses.field(default_factory=dict)
    # Coalesce engine of the device coarsening after this phase ('dense'
    # or 'sort'); None when the phase was not coarsened on the device.
    coalesce: str | None = None


@dataclasses.dataclass
class LouvainResult:
    communities: np.ndarray   # [nv original] dense community label per vertex
    modularity: float
    phases: list
    total_iterations: int
    total_seconds: float

    @property
    def num_communities(self) -> int:
        return int(self.communities.max()) + 1 if len(self.communities) else 0


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without CUDA that raises instead of
    running on the CPU.  Pass ``"cpu"`` to run the plain twins."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cuvite_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class PhaseRunner:
    """Runs the sweeps of one phase on one device.  ``engine='bucketed'``
    builds the phase's bucket plan on the host, uploads it and iterates
    ``bucketed_step``; ``engine='sort'`` keeps the edge slab on the
    device (``src``/``dst``/``w``) and iterates ``louvain_step_local``."""

    def __init__(self, dg: DistGraph, device, engine: str = "bucketed"):
        self.dg = dg
        self.device = torch.device(device)
        nv = dg.nv_pad
        self.nv_total = nv
        self.src = self.dst = self.w = self.plan = None
        if engine == "sort":
            self.src, self.dst, self.w = dg.device_slab(self.device)
        else:
            plan = BucketPlan.build(dg.src, dg.dst, dg.w, nv_local=nv)
            self.plan = DevicePlan.upload(plan, self.device)
        self.vdeg = torch.as_tensor(dg.padded_weighted_degrees()).to(
            self.device, torch.float32)
        self.comm0 = torch.arange(nv, dtype=torch.int32, device=self.device)
        self.constant = 1.0 / dg.graph.total_edge_weight_twice()
        self.labels_dev = None   # device labels of the last run()

    def step(self, comm: torch.Tensor):
        if self.plan is None:
            return louvain_step_local(self.src, self.dst, self.w, comm,
                                      self.vdeg, self.constant)
        return bucketed_step(self.plan, comm, self.vdeg, self.constant,
                             nv_total=self.nv_total)

    def run(self, threshold: float):
        """One phase (louvain.cpp:471-588): sweep from the identity
        assignment until the gain drops below ``threshold``.  The sweep
        that gains too little is rolled back, and the result is the
        assignment before it.  Returns (labels in padded space as numpy,
        last in-loop Q, iterations)."""
        lower = -1.0
        past = comm = self.comm0
        prev_mod = lower
        iters = 0
        while True:
            res = self.step(comm)
            iters += 1
            mod = float(res.modularity)   # the one host read per sweep
            if mod - prev_mod < threshold:
                break
            prev_mod = max(mod, lower)
            past, comm = comm, res.target
            if iters >= MAX_TOTAL_ITERATIONS:
                break
        self.labels_dev = past
        return past.cpu().numpy(), prev_mod, iters


def _runner_slab(runner: PhaseRunner):
    """The resident (src, dst, w) of a sort-engine runner, else None: the
    bucketed engine keeps no slab on the device, and none is uploaded just
    for the phase-end Q (reference ``driver.py:187-194``)."""
    if runner.src is None:
        return None
    return runner.src, runner.dst, runner.w


def _device_transition(runner: PhaseRunner, nc: int):
    """Coarsen the runner's resident slab on the device into the next
    phase's ``DistGraph`` (reference ``driver.py:2310-2368``).  Returns
    (next dg, coalesce engine)."""
    dg = runner.dg
    eng = coalesce_engine(dg.nv_pad)
    real_mask = torch.from_numpy(dg.vertex_mask()).to(runner.device)
    src2, dst2, w2, _dmap, _nc, ne2 = device_coarsen_slab(
        runner.src, runner.dst, runner.w, runner.labels_dev, real_mask,
        nv_pad=dg.nv_pad, coalesce=eng)
    src2, dst2, w2, nv_pad2 = maybe_shrink_to_class(
        src2, dst2, w2, nc=nc, ne2=ne2, nv_pad=dg.nv_pad)
    nxt = DistGraph.from_device_slab(
        src2, dst2, w2, num_vertices=nc, num_edges=ne2, nv_pad=nv_pad2,
        policy=dg.graph.policy,
        total_weight_twice=dg.graph.total_edge_weight_twice())
    return nxt, eng


def louvain_phases(
    graph: Graph,
    threshold: float = 1.0e-6,
    threshold_cycling: bool = False,
    one_phase: bool = False,
    max_phases: int = TERMINATION_PHASE_COUNT,
    verbose: bool = False,
    device=None,
    engine: str = "auto",
) -> LouvainResult:
    """Full multi-phase Louvain (the main.cpp:218-495 loop) on one device.

    ``device=None`` runs on the card and raises when there is none;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.
    ``engine``: ``'auto'`` (= ``'bucketed'``), ``'bucketed'`` or
    ``'sort'``."""
    if engine == "auto":
        engine = "bucketed"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: the port has 'auto', "
                         "'bucketed' and 'sort'; the reference's 'pallas' "
                         "and 'fused' engines are not ported (ROADMAP.md)")
    dev = resolve_device(device)
    # Read once per run: a sort-engine run that coarsened on the device
    # has no host graph to coarsen later.
    dev_coarsen = engine == "sort" and device_coarsen_enabled()
    nv0 = graph.num_vertices
    comm_all = np.arange(nv0, dtype=np.int64)
    if graph.num_edges == 0:
        return LouvainResult(communities=comm_all, modularity=0.0,
                             phases=[], total_iterations=0,
                             total_seconds=0.0)
    phases: list[PhaseStats] = []
    prev_mod = -1.0
    tot_iters = 0
    t_start = time.perf_counter()
    phase = 0
    g = graph
    pending = None   # next phase's device-resident DistGraph
    cycling = threshold_cycling and not one_phase
    while phase < max_phases and tot_iters <= MAX_TOTAL_ITERATIONS:
        th = threshold_for_phase(phase) if cycling else threshold
        t1 = time.perf_counter()
        dg = pending if pending is not None else DistGraph.build(g)
        pending = None
        runner = PhaseRunner(dg, dev, engine)
        t_plan = time.perf_counter()
        comm_pad, _, iters = runner.run(th)
        t_iter = time.perf_counter()
        curr_mod = phase_modularity(dg, comm_pad, _runner_slab(runner))
        stages = {"plan": t_plan - t1, "iterate": t_iter - t_plan,
                  "evaluate": time.perf_counter() - t_iter}
        tot_iters += iters
        if (curr_mod - prev_mod) > th:
            comm_old = comm_pad[dg.old_to_pad]
            dense, nc = renumber_communities(comm_old)
            comm_all = dense[comm_all]
            t2 = time.perf_counter()
            phases.append(PhaseStats(
                phase=phase, modularity=curr_mod, iterations=iters,
                num_vertices=g.num_vertices, num_edges=g.num_edges,
                seconds=t2 - t1, stages=stages))
            if verbose:
                print(f"Level {phase}, Modularity: {curr_mod:.6f}, "
                      f"Iterations: {iters}, nv: {g.num_vertices}, "
                      f"time: {t2 - t1:.3f}s")
            prev_mod = curr_mod
            if one_phase:
                break
            if dev_coarsen:
                pending, phases[-1].coalesce = _device_transition(runner,
                                                                  nc)
                g = pending.graph   # SlabMeta: scalar facts only
                runner = None
            else:
                runner = None   # free the phase's device plan first
                g = coarsen_graph(g, dense, nc)
            stages["coarsen"] = time.perf_counter() - t2
            phase += 1
            continue
        # No gain.  Safety net: when cycling exits early, run one final
        # 1e-6 pass from the identity assignment (main.cpp:432-442).
        if cycling and phase < 10 and th > 1.0e-6:
            comm_pad, _, iters = runner.run(1.0e-6)
            curr_mod = phase_modularity(dg, comm_pad, _runner_slab(runner))
            tot_iters += iters
            if (curr_mod - prev_mod) > 1.0e-6:
                dense, _ = renumber_communities(comm_pad[dg.old_to_pad])
                comm_all = dense[comm_all]
                prev_mod = curr_mod
                phases.append(PhaseStats(
                    phase=phase, modularity=curr_mod, iterations=iters,
                    num_vertices=g.num_vertices, num_edges=g.num_edges,
                    seconds=time.perf_counter() - t1))
        break
    # Final contiguous renumber of the composed labels (main.cpp:374-394).
    dense_all, _ = renumber_communities(comm_all)
    return LouvainResult(
        communities=dense_all,
        modularity=prev_mod,
        phases=phases,
        total_iterations=tot_iters,
        total_seconds=time.perf_counter() - t_start,
    )
