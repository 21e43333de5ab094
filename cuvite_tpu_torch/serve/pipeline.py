"""Pipelined dispatch: overlap the host pack with the device execution
(port of ``cuvite_tpu/serve/pipeline.py``).

  * **packer** -- pops one due batch under the intake lock
    (``LouvainServer.pop_due``), then outside the lock runs the pack
    stage (``pack_batch``: shape union, slab stacking, plan build,
    upload) and hands the PackedBatch over;
  * **handoff** -- a depth-1 blocking slot (:class:`Handoff`): at most
    one batch packed ahead;
  * **executor** -- runs each PackedBatch's execute stage
    (``execute_batch``) and delivers results, failures and sheds to the
    routing callback.

The steady-state batch period becomes ``max(pack_s, device_s)`` instead
of their sum; ``ServeStats.overlap_frac`` measures the overlap.  On the
card the packer uploads from pinned memory on a side stream of its own
and the executor's stream waits on the upload's event (the server's
``side_stream_upload``, ``louvain/batched.py``, module note): the default
stream is shared by every thread, so without it an upload would queue
behind the previous batch's kernels.  The serial ``step``/``drain`` path
uploads on the current stream.

Drain: once drain is requested the packer flushes every queued bin
through pack and the slot, then closes it; the executor finishes the
in-flight batch, drains the slot, sweeps the last terminal reports and
calls ``on_done``.  A pack in flight when the drain arrives is executed
exactly once.  Fault sites keep their stages: ``pack`` faults fire and
retry on the packer thread, ``dispatch``/``device``/``unpack`` on the
executor; poison isolation runs in whichever stage hit the failure.
Every primitive comes from ``serve/sync.py``.
"""

from __future__ import annotations

from cuvite_tpu_torch.serve import sync

# Handoff close sentinel: posted by the packer after the final batch
# (drain) so the executor can finish the slot and run the epilogue.
_CLOSED = object()


class Handoff:
    """Depth-1 blocking handoff slot between the packer and the
    executor (double buffering).  ``put`` blocks while the previous
    item is still unconsumed; ``get`` blocks until an item (or the
    close sentinel) arrives.  Built on the serve/sync.py Condition."""

    def __init__(self, name: str = "handoff"):
        self._cond = sync.Condition(name=name)
        self._item = None
        self._has = False
        self._closed = False

    def put(self, item) -> None:
        with self._cond:
            while self._has:
                self._cond.wait()
            self._item = item
            self._has = True
            self._cond.notify_all()

    def close(self) -> None:
        """Post the end-of-stream marker (after the last ``put``)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def get(self):
        """The next item, or the ``CLOSED`` sentinel once the packer
        closed an empty slot."""
        with self._cond:
            while not self._has:
                if self._closed:
                    return _CLOSED
                self._cond.wait()
            item = self._item
            self._item = None
            self._has = False
            self._cond.notify_all()
            return item

    @property
    def closed_sentinel(self):
        return _CLOSED


class PipelinedDispatcher:
    """The two seam-threads around a LouvainServer (see module
    docstring).  ``lock`` is the INTAKE lock — pops and submits
    serialize under it (the daemon passes its own lock so the
    drain-recheck invariant spans both); the pack and execute stages
    run outside it.  ``route(finished, fails, sheds)`` delivers
    per-job outcomes (the daemon's ``_route_results``); None collects
    them on the dispatcher (``results``/``fails``/``sheds``) for
    library callers like the load generator.  ``on_done`` runs on the
    executor thread after the drain completes (the daemon's summary
    emission) — ``wait_done`` unblocks after it."""

    def __init__(self, server, *, lock=None, wake=None, drain_req=None,
                 poll_s: float = 0.01, route=None, on_done=None):
        self.server = server
        self.lock = lock if lock is not None else sync.RLock(
            name="PipelinedDispatcher.lock")
        self._wake = wake if wake is not None else sync.Event(
            name="PipelinedDispatcher._wake")
        self._drain_req = drain_req if drain_req is not None else sync.Event(
            name="PipelinedDispatcher._drain_req")
        self._done = sync.Event(name="PipelinedDispatcher._done")
        self.poll_s = poll_s
        self.handoff = Handoff()
        self._route = route
        self._on_done = on_done
        self.results: list = []
        self.fails: list = []
        self.sheds: list = []
        self.pack_thread = None
        self.exec_thread = None
        with server.stats.lock:
            server.stats.pipeline_depth = 2
        server.side_stream_upload = True

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.pack_thread = sync.Thread(
            target=self._pack_loop, name="serve-pack", daemon=True)
        self.exec_thread = sync.Thread(
            target=self._exec_loop, name="serve-execute", daemon=True)
        self.pack_thread.start()
        self.exec_thread.start()

    def submit(self, graph, job_id=None, **kw) -> str:
        """Intake for library callers (the daemon uses its own handle
        path under the shared lock): enqueue under the intake lock and
        wake the packer."""
        with self.lock:
            jid = self.server.submit(graph, job_id, **kw)
        self._wake.set()
        return jid

    def wake(self) -> None:
        self._wake.set()

    def request_drain(self) -> None:
        """Begin the drain (idempotent, signal-handler safe)."""
        self._drain_req.set()
        self._wake.set()

    def wait_done(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    # -- the two stages -----------------------------------------------------

    def _pack_loop(self) -> None:
        server = self.server
        try:
            while True:
                self._wake.wait(timeout=self.poll_s)
                self._wake.clear()
                draining = self._drain_req.is_set()
                while True:
                    with self.lock:
                        popped = server.pop_due(force=draining)
                    if popped is None:
                        break
                    # The expensive stage, OUTSIDE the intake lock: a
                    # slow pack must never stall submits or the stats
                    # poll.  put() then blocks until the executor takes
                    # the previous batch (depth-1 double buffering).
                    packed = server.pack_batch(*popped)
                    self.handoff.put(packed)
                if draining:
                    with self.lock:
                        # Same-lock recheck as the serial loop: a submit
                        # that saw drain_req unset enqueued under this
                        # lock BEFORE this check, so its job is visible
                        # here; one that sees it set is refused.
                        if server.pending() == 0:
                            break
        finally:
            self.handoff.close()

    def _exec_loop(self) -> None:
        server = self.server
        while True:
            item = self.handoff.get()
            if item is _CLOSED:
                break
            finished = server.execute_batch(item)
            self._deliver(finished)
        # Final sweep: sheds/failures recorded by the packer after the
        # executor's last delivery (e.g. a drain that shed everything).
        self._deliver([])
        if self._on_done is not None:
            self._on_done()
        self._done.set()

    def _deliver(self, finished) -> None:
        fails, sheds = self.server.consume_terminal()
        if self._route is not None:
            self._route(finished, fails, sheds)
        else:
            self.results.extend(finished)
            self.fails.extend(fails)
            self.sheds.extend(sheds)
