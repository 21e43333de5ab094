"""The benchmark's recorder, handed to the system through its public
``tracer=`` argument.

It keeps the system's own stage spans (``Tracer.stage``) with the unit
(solve or batch) they fell in, and opens a
``torch.profiler.record_function`` range for each, so that the device
trace can name the host stage behind every launch and every idle gap.
A solve's first ``iterate`` stage is phase 0's sweeps, whose work is the
same on every engine: its range is named ``iterate.phase0``.  A batch has
no such span (its ``iterate`` stage holds every phase and the batched
coarsening), so a batch marks none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from cuvite_tpu_torch.utils.trace import Tracer

PREFIX = "bench/"
PHASE0 = "phase0"


@dataclasses.dataclass
class Span:
    unit: int
    name: str
    t0: float
    t1: float

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class BenchTracer(Tracer):
    def __init__(self, batch: bool):
        super().__init__(enabled=True)
        self.batch = batch
        self.spans: list = []
        self.unit = -1
        self._first_iterate = False

    def begin_unit(self, unit: int) -> None:
        self.unit = unit
        self._first_iterate = not self.batch

    @staticmethod
    def _range(label: str):
        return torch.profiler.record_function(PREFIX + label)

    @contextlib.contextmanager
    def stage(self, name: str, into: dict | None = None):
        phase0 = name == "iterate" and self._first_iterate
        self._first_iterate = self._first_iterate and not phase0
        t0 = time.perf_counter()
        try:
            with self._range(f"{name}.{PHASE0}" if phase0 else name), \
                    super().stage(name, into):
                yield
        finally:
            t1 = time.perf_counter()
            self.spans.append(Span(self.unit, name, t0, t1))
            if phase0:
                self.spans.append(Span(self.unit, PHASE0, t0, t1))

    def seconds_per_unit(self, name: str, units: int) -> float | None:
        """Mean seconds of stage ``name`` a unit, None if it never ran."""
        spans = [s.seconds for s in self.spans if s.name == name]
        return sum(spans) / units if spans else None
