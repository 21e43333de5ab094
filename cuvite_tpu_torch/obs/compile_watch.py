"""The compile watcher of the port (the counterpart of
``cuvite_tpu/obs/compile_watch.py``).

On the card, "compiling" means the work ``kernels/_build.py`` does before
a kernel can launch: an ``nvcc`` run for a source whose library is not
built yet, and the first ``ctypes`` load of a library in the process.
The watcher subscribes to that module's hook (``_build.HOOKS``) while
active, so each build or load becomes one event.  The port uses no
``torch.compile``, so there is no torch-level compilation to watch.  A
library's kernels are loaded by CUDA at their first launch (lazy module
loading), which no hook sees: a warm-up must launch every kernel form a
measured window launches.

The contract is the reference's: ``compiles`` (one string per event, the
bench guard's abort signal), ``events`` (one dict per event, with the
reference's ``module`` and ``dur_s`` keys and the port's ``kind``,
``"build"`` or ``"load"``), ``on_event`` (called with each event as it
happens), and nesting: an inner watcher leaves an outer one recording.
"""

from __future__ import annotations

from cuvite_tpu_torch.kernels import _build


class CompileWatcher:
    """Collects kernel builds and library loads while active."""

    def __init__(self, on_event=None):
        self.compiles: list = []
        self.events: list = []
        self.on_event = on_event

    def _hook(self, ev: dict) -> None:
        # Runs under _build._LOCK: record only, never build.
        ev = dict(ev)
        self.events.append(ev)
        self.compiles.append(
            f"{ev['kind']} {ev['module']} in {ev['dur_s']:.3f} s")
        if self.on_event is not None:
            self.on_event(ev)

    def __enter__(self) -> "CompileWatcher":
        with _build._LOCK:
            _build.HOOKS.append(self._hook)
        return self

    def __exit__(self, *exc) -> bool:
        with _build._LOCK:
            _build.HOOKS.remove(self._hook)
        return False
