"""The fused engine on one device (port of
``cuvite_tpu/louvain/fused.py:45-268``).

The reference runs a whole clustering -- sweeps, convergence tests,
coarsening and label composition -- as one jitted program with one host
sync.  Between its phases it neither renumbers nor coalesces: coarsening
is RELABEL-ONLY, each slab row's endpoints rewritten to their communities,
ids kept in the padded vertex space, parallel edges kept.  Louvain is
multigraph-invariant and a dense renumbering preserves order, so every
id comparison (ties to the smaller id, the singleton guard) decides as on
the coalesced graph, and the slab's shape never changes.  Labels compose
by one gather a phase.  ``driver._run_fused`` calls this once per phase
while the slab is big, coarsening it on the device in between, then once
for all remaining phases.

Differences from the reference, by design:

- Torch has no device while-loop, so the phases and their sweeps are host
  loops.  Each sweep makes one host read, of its Q and moved count
  together (``loop.phase_loop``); each call makes one more, of its
  phases' community counts.
- The in-loop Q is float64 (the reference's float32), as in every engine
  of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from cuvite_tpu_torch.coarsen.device import device_weighted_degrees
from cuvite_tpu_torch.core.types import MAX_TOTAL_ITERATIONS
from cuvite_tpu_torch.louvain.loop import phase_loop
from cuvite_tpu_torch.louvain.step import louvain_step_local
from cuvite_tpu_torch.obs.convergence import PhaseConvergence
from cuvite_tpu_torch.ops.segment import TenantConstants
from cuvite_tpu_torch.utils.trace import NullTracer


@dataclasses.dataclass
class FusedPhase:
    modularity: float        # the loop's Q of the phase's result
    iterations: int
    num_communities: int     # distinct labels of the real vertices after it
    convergence: PhaseConvergence


@dataclasses.dataclass
class FusedResult:
    labels: torch.Tensor     # [nv_pad] int32 composed labels of the slab's
                             # vertices at the call's start
    modularity: float        # Q of the last gaining phase (or prev_mod0)
    phases: list             # FusedPhase of each gaining phase
    iterations: int          # sweeps of every phase run, gaining or not


def fused_sweep(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                vdeg: torch.Tensor, constant):
    """The sort-engine sweep over a resident slab with the caller's
    weighted degrees and 1/(2m) (reference ``_fused_step_call``), as the
    ``sweep(comm, active)`` of ``loop.phase_loop``, which masks the
    targets by ``active`` itself."""
    consts = TenantConstants.of(constant, src.device)

    def sweep(comm, _active):
        out = louvain_step_local(src, dst, w, comm, vdeg, consts)
        return out.target, out.modularity[0]

    return sweep


def fused_phase(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                constant: float, threshold: float, *, nv_pad: int,
                tracer=None) -> tuple:
    """One phase on a resident slab (reference ``fused_phase``): its
    weighted degrees, then sort-engine sweeps from the identity until the
    gain drops below ``threshold``.  Returns ``loop.phase_loop``'s
    (past, Q, sweeps, PhaseConvergence)."""
    vdeg = device_weighted_degrees(src, w, nv_pad=nv_pad)
    comm0 = torch.arange(nv_pad, dtype=torch.int32, device=src.device)
    return phase_loop(fused_sweep(src, dst, w, vdeg, constant), comm0,
                      threshold, tracer=tracer)


def _relabel(src, dst, w, past, nv_pad: int) -> tuple:
    """Relabel-only coarsening (reference ``fused.py:168-187``): both
    endpoints to their communities, rows stably sorted by the new source
    (so the slab stays sorted, padding last), parallel edges kept."""
    new_src = torch.where(src >= nv_pad, nv_pad,
                          past[src.clamp(max=nv_pad - 1).long()])
    new_src = new_src.to(src.dtype)
    new_dst = past[dst.clamp(max=nv_pad - 1).long()].to(dst.dtype)
    order = torch.sort(new_src, stable=True).indices
    return new_src[order], new_dst[order], w[order]


def _count_communities(labels, real_mask, nv_pad: int,
                       tracer) -> torch.Tensor:
    present = torch.zeros(nv_pad + 1, dtype=torch.bool, device=labels.device)
    with tracer.stage("host_read"):   # the scalar's upload blocks
        present[torch.where(real_mask, labels.long(), nv_pad)] = True
    return present[:nv_pad].sum()


def fused_louvain(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                  thresholds: list, constant: float, real_mask: torch.Tensor,
                  *, nv_pad: int, cycling: bool = False,
                  prev_mod0: float = -1.0, phase_budget: int | None = None,
                  phase0: int = 0,
                  iter_budget: int = MAX_TOTAL_ITERATIONS,
                  tracer=None) -> FusedResult:
    """Multi-phase Louvain on a resident slab (reference ``fused_louvain``).

    ``src``/``dst`` [ne] int32, ``src`` ascending, padding rows (if any)
    ``src == nv_pad``, ``w == 0``; ``thresholds`` the gain threshold of
    each phase of the call (cycling schedule or constant; its length is
    the most phases); ``real_mask`` [nv_pad] bool, the slab's real
    vertices.  A phase is kept when its Q beats the previous one by its
    threshold, starting from ``prev_mod0``.  At most ``phase_budget``
    phases run; the call stops once its sweeps pass ``iter_budget``.
    ``cycling``: after a phase that did not gain, with global phase
    ``phase0 + phases < 10`` and a threshold above 1e-6, run the 1e-6
    safety phase (main.cpp:432-442) -- not after the budgets end it.
    ``tracer``: the sweep loop's ``sweep`` and ``host_read`` stages, and
    the read of the community counts."""
    tracer = tracer if tracer is not None else NullTracer()
    max_phases = len(thresholds)
    budget = max_phases if phase_budget is None else phase_budget
    labels = torch.arange(nv_pad, dtype=torch.int32, device=src.device)
    prev_mod = prev_mod0
    kept, counts = [], []
    tot_iters = 0

    def keep(past, mod, iters, conv):
        nonlocal labels, prev_mod
        labels = past[labels.long()]
        prev_mod = max(mod, -1.0)
        kept.append((mod, iters, conv))
        counts.append(_count_communities(labels, real_mask, nv_pad, tracer))

    while True:
        th = thresholds[min(len(kept), max_phases - 1)]
        past, mod, iters, conv = fused_phase(src, dst, w, constant, th,
                                             nv_pad=nv_pad, tracer=tracer)
        tot_iters += iters
        gained = (mod - prev_mod) > th
        if gained:
            src, dst, w = _relabel(src, dst, w, past, nv_pad)
            keep(past, mod, iters, conv)
        if not gained or len(kept) >= budget or tot_iters > iter_budget:
            break
    th_last = thresholds[min(len(kept), max_phases - 1)]
    if (cycling and not gained and phase0 + len(kept) < 10
            and th_last > 1e-6 and len(kept) < budget):
        past, mod, iters, conv = fused_phase(src, dst, w, constant, 1e-6,
                                             nv_pad=nv_pad, tracer=tracer)
        tot_iters += iters
        if (mod - prev_mod) > 1e-6:
            keep(past, mod, iters, conv)
    ncs = []
    if counts:
        with tracer.stage("host_read"):
            ncs = torch.stack(counts).tolist()  # graftlint: disable=R010 — scalar/stat-only sync, O(max_phases)
    return FusedResult(
        labels=labels, modularity=prev_mod,
        phases=[FusedPhase(m, i, int(n), c)
                for (m, i, c), n in zip(kept, ncs)],
        iterations=tot_iters)
