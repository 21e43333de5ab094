"""Per-phase convergence rows (port of ``cuvite_tpu/obs/convergence.py``).

Every sweep of a phase gives one row: Q of the sweep's input assignment
and the number of vertices the sweep moved.  The port's phase loops read
both with the one host read each sweep already makes for its stop test,
so the rows cost no extra synchronisation; the reference collects them in
device buffers read once per phase.  A sweep that ends the phase is rolled
back, so its row records 0 moves.

Stdlib only: the rows are decoded from values already on the host.
"""

from __future__ import annotations

import dataclasses

# The moved count of a row whose schedule does not track it (the
# reference's class schedules); every loop of the port tracks it.
MOVED_UNTRACKED = -1


@dataclasses.dataclass
class ConvRow:
    """One sweep of one phase."""

    iteration: int
    # Q of this sweep's INPUT assignment: row i's moves show in row i+1's
    # q.  The phase's resulting Q is the driver's, not rows[-1].q (the
    # last sweep is the one that failed the threshold).
    q: float
    moved: int              # vertices this sweep moved (-1: untracked)

    def to_dict(self) -> dict:
        return {"iteration": self.iteration, "q": self.q,
                "moved": self.moved}


@dataclasses.dataclass
class PhaseConvergence:
    """Rows of one phase attempt.  ``gained``: whether the phase passed the
    threshold and entered the result's phases.  ``truncated``: the phase
    ran more sweeps than the rows kept (``core.types.CONV_ROWS_CAP``);
    ``iterations`` is exact either way."""

    phase: int
    rows: list           # list[ConvRow]
    iterations: int
    truncated: bool = False
    gained: bool | None = None

    def dq(self) -> list:
        """Per-row Q gains: ``dq()[i] = q[i] - q[i-1]`` is the gain of
        sweep i-1's moves; None for row 0."""
        return [None if i == 0 else r.q - self.rows[i - 1].q
                for i, r in enumerate(self.rows)]

    def moved_total(self) -> int | None:
        """Total moved vertices, or None when any row is untracked."""
        if any(r.moved == MOVED_UNTRACKED for r in self.rows):
            return None
        return sum(r.moved for r in self.rows)

    def to_dict(self) -> dict:
        return {
            "phase": self.phase,
            "iterations": self.iterations,
            "truncated": self.truncated,
            "gained": self.gained,
            "rows": [r.to_dict() for r in self.rows],
        }

    def summary(self) -> dict:
        """Endpoints instead of the whole curve (``q_last`` is the last
        sweep's input Q)."""
        first = self.rows[0] if self.rows else None
        last = self.rows[-1] if self.rows else None
        return {
            "phase": self.phase,
            "iterations": self.iterations,
            "q_first": None if first is None else first.q,
            "q_last": None if last is None else last.q,
            "moved_first": None if first is None else first.moved,
            "moved_total": self.moved_total(),
            "truncated": self.truncated,
            "gained": self.gained,
        }


def decode_phase_conv(phase: int, iterations: int, q_rows,
                      moved_rows=None) -> PhaseConvergence:
    """Rows of one phase from its per-sweep values.  ``q_rows`` holds at
    most ``CONV_ROWS_CAP`` values; only the first min(iterations, cap) are
    meaningful.  ``moved_rows=None`` marks an untracked schedule.  (The
    reference's per-row sparse-exchange overflow flag is not kept: the
    mesh loop stops at the first sweep that overflows, and the driver
    discards that attempt.)"""
    cap = len(q_rows)
    n = min(int(iterations), cap)
    rows = [ConvRow(
        iteration=i,
        q=float(q_rows[i]),
        moved=(MOVED_UNTRACKED if moved_rows is None
               else int(moved_rows[i])))
        for i in range(n)]
    return PhaseConvergence(phase=phase, rows=rows,
                            iterations=int(iterations),
                            truncated=int(iterations) > cap)


def convergence_summary(convergence) -> list:
    """One summary per phase attempt (empty without rows)."""
    if not convergence:
        return []
    return [pc.summary() for pc in convergence]
