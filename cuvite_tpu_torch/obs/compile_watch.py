"""The compile watcher of the port (the counterpart of
``cuvite_tpu/obs/compile_watch.py``).

On the card, "compiling" means the work done before a kernel or a host
routine can run: an ``nvcc`` run for a source whose library is not built
yet, a ``g++`` run for the native host runtime, and the first ``ctypes``
load of a library in the process.  The watcher subscribes to
``kernels/_build.HOOKS`` while active, so each build or load becomes one
event.  The port uses no ``torch.compile``, so there is no torch-level
compilation to watch.

CUDA loads a library's kernel bodies at their first launch (lazy module
loading), which no hook sees.  The watcher therefore also reads the
launched kernel forms (``kernels.form_counts``) when it starts and when
it stops: ``new_forms`` lists the forms first launched while it was
active, each one a body CUDA loaded inside the window.  They are not
events (``compiles`` and ``on_event`` see builds and loads only); the
bench guard refuses a timed window with either.

The contract is the reference's: ``compiles`` (one string per event, the
bench guard's abort signal), ``events`` (one dict per event, with the
reference's ``module`` and ``dur_s`` keys and the port's ``kind``,
``"build"`` or ``"load"``), ``on_event`` (called with each event as it
happens), and nesting: an inner watcher leaves an outer one recording.
"""

from __future__ import annotations

from cuvite_tpu_torch.kernels import _build, form_counts, new_forms


class CompileWatcher:
    """Collects kernel builds and library loads while active."""

    def __init__(self, on_event=None):
        self.compiles: list = []
        self.events: list = []
        self.on_event = on_event
        self.new_forms: list = []
        self._forms_before: dict = {}

    def _hook(self, ev: dict) -> None:
        # Runs under _build._LOCK: record only, never build.
        ev = dict(ev)
        self.events.append(ev)
        self.compiles.append(
            f"{ev['kind']} {ev['module']} in {ev['dur_s']:.3f} s")
        if self.on_event is not None:
            self.on_event(ev)

    def __enter__(self) -> "CompileWatcher":
        self._forms_before = form_counts()
        with _build._LOCK:
            _build.HOOKS.append(self._hook)
        return self

    def __exit__(self, *exc) -> bool:
        with _build._LOCK:
            _build.HOOKS.remove(self._hook)
        self.new_forms = new_forms(self._forms_before, form_counts())
        return False
