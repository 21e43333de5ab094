"""The sweep loop of one phase, shared by every engine on one device
(port of the reference's ``_run_phase_loop`` and ``_run_phase_loop_et``,
``cuvite_tpu/louvain/driver.py:292-397``).

Torch has no device while-loop, so the loop reads the stop test's values
on the host once per sweep: Q, the moved count (the convergence rows),
on a mesh the sparse exchange's budget flag and, under ET modes 3/4, the
active count, in one fetch.  On a mesh the state is a list over the
local shards and the counts are summed over every shard.
"""

from __future__ import annotations

import numpy as np
import torch

from cuvite_tpu_torch.core.types import (
    CONV_ROWS_CAP,
    ET_CUTOFF,
    MAX_TOTAL_ITERATIONS,
    P_CUTOFF,
)
from cuvite_tpu_torch.obs.convergence import decode_phase_conv
from cuvite_tpu_torch.utils.trace import NullTracer


class BudgetOverflow(Exception):
    """A mesh sweep overflowed the sparse exchange's per-peer budget: the
    phase is invalid, and the caller re-runs it with a larger budget (the
    reference reads the flag once, at the phase's end, with the same
    outcome)."""


def phase_loop(sweep, comm0, threshold: float, *,
               et_mode: int = 0, et_delta: float = 0.25,
               real_mask=None, active0=None, host_et: bool = False,
               mesh=None, tracer=None) -> tuple:
    """One phase (louvain.cpp:471-588): sweep from ``comm0`` until the gain
    drops below ``threshold``.  The sweep that gains too little is rolled
    back; the result is the assignment before it.

    ``sweep(comm, active)`` returns (target [nv] int32, Q of ``comm`` as a
    0-dim f64 tensor); ``active`` is the ET mask of movable vertices, None
    without ET.  On a mesh (``mesh``, ``comm/mesh.py``) the state is the
    list of the local shards' assignments, ``real_mask``, ``active0`` and
    ``active`` are lists alike, and ``sweep`` returns (targets, Q, the
    moved count, the budget-overflow flag), 0-dim on the first local
    device; a sweep that overflows raises :class:`BudgetOverflow`.  Early
    termination (reference ``_run_phase_loop_et``, ``driver.py:332-397``):
    targets are masked by ``active`` and the moves recounted after the
    mask; from the third sweep on, and only when the loop goes on, modes
    1/3 freeze a vertex whose target, assignment and previous assignment
    agree, modes 2/4 decay its probability by (1 - et_delta) whenever its
    assignment did not change and freeze it at P_CUTOFF; modes 3/4 stop
    the phase once ET_CUTOFF of the ``real_mask`` vertices are frozen,
    tested before the threshold.  On a mesh the active count is summed
    over every shard in shard order, and read with Q, so every rank of a
    process group takes the same stop decision.  ``active0``: the movable
    vertices of the first sweep (default ``real_mask``), the caller's
    active set of a warm start (``driver.warm_start_phase``).
    ``host_et``: make those float decisions as the reference's host loop
    (the class schedules) does, in Python floats, instead of as its
    device loop, in float32.  ``tracer``: each pass of the loop is a
    ``sweep`` stage, and its read a ``host_read`` stage.

    Returns (past, Q of past, sweeps, PhaseConvergence)."""
    tracer = tracer if tracer is not None else NullTracer()
    on_mesh = mesh is not None
    if on_mesh:
        from cuvite_tpu_torch.comm.collectives import psum

        def each(fn, *xs):
            return [fn(*a) for a in zip(*xs)]

        def total(xs):
            return psum([x.sum() for x in xs], mesh)[0]
    else:
        def each(fn, *xs):
            return fn(*xs)

        def total(x):
            return x.sum()
    lower = -1.0
    past = comm = comm0
    prev_mod = lower
    iters = 0
    qs, moved_rows = [], []
    active = p_act = None
    et_stop = et_mode in (3, 4)
    if et_mode:
        active = real_mask if active0 is None else active0
        with tracer.stage("host_read"):
            nv_real = int(total(real_mask))
        if host_et:
            cutoff = ET_CUTOFF * nv_real
            decay = float(np.float32(1.0 - et_delta))
        else:
            cutoff = float(np.float32(ET_CUTOFF * nv_real))
            decay = float(np.float32(1.0) - np.float32(et_delta))
        if et_mode in (2, 4):
            p_act = each(lambda c: torch.ones(c.shape, dtype=torch.float32,
                                              device=c.device), comm0)
    p_cut = float(np.float32(P_CUTOFF))
    while True:
        with tracer.stage("sweep"):
            out = sweep(comm, active)
            target, mod = out[0], out[1]
            if active is not None:
                target = each(torch.where, active, target, comm)
            iters += 1
            if on_mesh and active is None:
                vals = [mod, out[2].double(), out[3].double()]
            elif on_mesh:
                vals = [mod, total(each(torch.ne, target, comm)).double(),
                        out[3].double()]
            else:
                vals = [mod, (target != comm).sum().double()]
            if et_stop:
                vals.append(total(active).double())
            with tracer.stage("host_read"):
                read = torch.stack(vals).tolist()   # the one host read per sweep  # graftlint: disable=R010 — scalar/stat-only sync, O(1) a sweep
            if on_mesh and read[2]:
                raise BudgetOverflow(f"sweep {iters} overflowed the budget")
            q = read[0]
            frozen_stop = False
            if et_stop:
                frozen = nv_real - int(read[-1])
                frozen_stop = ((frozen if host_et
                                else float(np.float32(frozen))) >= cutoff)
            stop = frozen_stop or (q - prev_mod) < threshold
            if len(qs) < CONV_ROWS_CAP:
                qs.append(q)
                moved_rows.append(0 if stop else int(read[1]))
            if stop:
                break
            prev_mod = max(q, lower)
            if et_mode and iters > 2:
                if p_act is None:
                    active = each(
                        lambda a, t, c, p: a & ~((t == c) & (c == p)),
                        active, target, comm, past)
                else:
                    decayed = each(lambda a, c, p: a & (c == p), active, comm,
                                   past)
                    p_act = each(lambda d, pa: torch.where(d, pa * decay, pa),
                                 decayed, p_act)
                    active = each(lambda a, d, pa: a & ~(d & (pa <= p_cut)),
                                  active, decayed, p_act)
            past, comm = comm, target
            if iters >= MAX_TOTAL_ITERATIONS:
                break
    return past, prev_mod, iters, decode_phase_conv(-1, iters, qs,
                                                    moved_rows)
