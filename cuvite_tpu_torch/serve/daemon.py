"""The serving daemon: socket intake, the dispatcher, graceful drain (port
of ``cuvite_tpu/serve/daemon.py``).

  * **Intake**: newline-delimited JSON over a unix-domain socket
    (``--socket PATH``) or a TCP port (``--port N``), stdlib only.  Each
    connection gets a reader thread; requests are dicts with an ``op``:
    ``submit`` (a graph spec and optional ``tenant``/``deadline_s``/
    ``id``/``labels``), ``stats`` (a ServeStats snapshot, the pending
    count, the conservation ledger and, beyond the reference's reply,
    ``kernels``: each CUDA kernel's launch count, which the CLI zeroes
    before its readiness line; all zero on the CPU), ``drain`` (graceful shutdown,
    the same path as SIGTERM), ``delta`` (streaming: edit the tenant's
    resident slab and optionally re-cluster it warm, answered on the
    reader thread).
  * **Dispatcher**: the two-stage pipeline by default
    (``serve/pipeline.py``: a packer thread packs and uploads batch k+1
    while an executor thread runs batch k); ``pipelined=False`` keeps one
    thread owning ``LouvainServer.step()``.  Queue mutation happens only
    under the daemon lock.
  * **Graceful drain**: ``request_drain()`` closes intake, flushes every
    queued bin (expired jobs still shed, poison jobs still isolate),
    evicts every resident stream session, emits the final ServeStats
    with the stream pool's ledger as a ``serve_summary``, notifies
    clients and lets ``serve_forever`` return.  Submits and deltas after
    the drain began get ``{"ok": false, "draining": true}``.

Wire protocol (one JSON object per line, both directions)::

    -> {"op": "submit", "graph": {"nv": 4, "src": [0,1], "dst": [1,2],
        "w": [1.0, 1.0]}, "tenant": "t0", "deadline_s": 2.5}
    <- {"ok": true, "job_id": "job-0"}
    -> {"op": "submit", "synth": {"edges": 4096, "seed": 7}}
    <- {"ok": false, "rejected": true, "retry_after_s": 0.81}
    <- {"result": {"job_id": "job-0", "q": 0.71, "communities": 9,
        "phases": 2, "iterations": 11}}
    <- {"failed": {"job_id": "job-3", "error": "..."}}
    <- {"shed": {"job_id": "job-4", "late_s": 0.12}}
    -> {"op": "delta", "tenant": "t0", "synth": {"edges": 4096,
        "seed": 7}, "ins": [[0, 9, 2.0]], "del": [[1, 2]],
        "recluster": true, "warm": "labels"}
    <- {"ok": true, "tenant": "t0", "resident": false, "delta": {"n_ins":
        2, "n_del": 2, "n_del_hit": 2, "ne": 8190, "frontier_frac": 0.1},
        "recluster": {"warm": "cold", "q": 0.7, "communities": 12,
        "phases": 3, "iterations": 20}}

Graph specs: inline ``graph`` (nv/src/dst/optional w), ``file`` (a Vite
binary path readable by the daemon), or ``synth`` (the deterministic
generator: both sides derive the same graph from (edges, seed)).
``"labels": true`` adds the per-vertex labels to the result line.
"""

from __future__ import annotations

import json
import os
import re
import socket

from cuvite_tpu_torch.kernels import launch_counts
from cuvite_tpu_torch.serve import sync
from cuvite_tpu_torch.serve.admission import AdmissionReject
from cuvite_tpu_torch.serve.queue import LouvainServer

# The server's auto-generated job-id namespace (queue.py: f"job-{n}");
# client-supplied ids may not squat on it (route-collision hazard).
_AUTO_ID = re.compile(r"job-\d+")


def _decode_graph(req: dict):
    """Build a Graph from a submit request's spec (exactly one of
    ``graph`` / ``file`` / ``synth``)."""
    import numpy as np

    specs = [k for k in ("graph", "file", "synth") if k in req]
    if len(specs) != 1:
        raise ValueError(
            f"submit needs exactly one of graph/file/synth, got {specs}")
    if "graph" in req:
        from cuvite_tpu_torch.core.graph import Graph

        g = req["graph"]
        w = g.get("w")
        return Graph.from_edges(
            int(g["nv"]),
            np.asarray(g["src"], dtype=np.int64),
            np.asarray(g["dst"], dtype=np.int64),
            weights=(np.asarray(w, dtype=np.float64)
                     if w is not None else None))
    if "file" in req:
        from cuvite_tpu_torch.io.vite import read_vite

        return read_vite(req["file"], bits64=bool(req.get("bits64")))
    from cuvite_tpu_torch.workloads.synth import synthesize_graph

    s = req["synth"]
    return synthesize_graph(int(s["edges"]), seed=int(s["seed"]))


class _Client:
    """One connection: a line reader thread plus a write lock (the
    dispatcher and the reader both write response lines).  The socket
    carries a timeout (``ServeDaemon.io_timeout_s``): a send that
    cannot complete within it marks the client dead — the ONE
    dispatcher thread must never block on a tenant that stopped
    reading (head-of-line starvation of every other tenant); read
    timeouts just mean the client is idle and the reader keeps
    listening."""

    def __init__(self, daemon: "ServeDaemon", conn: socket.socket,
                 idx: int):
        self.daemon = daemon
        self.conn = conn
        self.idx = idx
        self.wlock = sync.Lock()
        self.thread = sync.Thread(
            target=self._read_loop, name=f"serve-client-{idx}", daemon=True)

    def send(self, payload: dict) -> bool:
        """False = the client is dead or too slow to take the payload
        (callers drop it); never blocks past the socket timeout."""
        data = (json.dumps(payload) + "\n").encode()
        try:
            with self.wlock:
                self.conn.sendall(data)
            return True
        except OSError:   # includes socket.timeout: a non-reading peer
            return False

    def _read_loop(self) -> None:
        buf = bytearray()
        limit = self.daemon.max_line_bytes
        try:
            while True:
                try:
                    chunk = self.conn.recv(1 << 16)
                except socket.timeout:
                    continue          # idle client: keep listening
                except OSError:
                    break
                if not chunk:
                    break             # orderly close
                buf.extend(chunk)
                if len(buf) > limit and buf.find(b"\n") < 0:
                    # A newline-free stream past the line cap is a
                    # broken or hostile client; dropping IT beats
                    # growing the buffer until the daemon OOMs and
                    # takes every other tenant down.
                    self.send({"ok": False,
                               "error": f"request line exceeds "
                                        f"{limit} bytes"})
                    break
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line = bytes(buf[:nl]).decode("utf-8",
                                                  "replace").strip()
                    del buf[:nl + 1]
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError as e:
                        self.send({"ok": False, "error": f"bad json: {e}"})
                        continue
                    self.send(self.daemon.handle(req, self))
        finally:
            self.daemon._forget(self)


class ServeDaemon:
    """The async service around a LouvainServer (see module docstring).

    ``poll_s`` bounds how late a linger deadline can fire when no
    submits arrive to wake the dispatcher; it defaults to half the
    server's linger window (floored at 5 ms).
    """

    def __init__(self, server: LouvainServer, *, sock_path: str | None = None,
                 host: str = "127.0.0.1", port: int | None = None,
                 poll_s: float | None = None, io_timeout_s: float = 10.0,
                 max_line_bytes: int = 64 << 20, pipelined: bool = True):
        if (sock_path is None) == (port is None):
            raise ValueError("exactly one of sock_path / port required")
        self.server = server
        self.sock_path = sock_path
        self.host = host
        self.port = port
        self.poll_s = (poll_s if poll_s is not None
                       else max(server.config.linger_s / 2.0, 0.005))
        self.io_timeout_s = io_timeout_s
        self.max_line_bytes = max_line_bytes
        self.pipelined = bool(pipelined)
        # Every primitive comes from serve/sync.py (the seam).
        self.lock = sync.RLock()             # guards `server` wholesale
        self._wake = sync.Event()            # submit -> dispatcher
        self._drain_req = sync.Event()
        self._done = sync.Event()
        self._listener: socket.socket | None = None
        self._clients: dict = {}
        self._routes: dict = {}     # job_id -> (client, want_labels)
        self._accept_thread = None
        self._dispatch_thread = None
        self.summary: dict | None = None
        # Pipelined dispatch (the default): the packer and
        # executor seam-threads replace the single dispatcher; they
        # share THIS daemon's lock/wake/drain events so the submit-vs-
        # drain recheck invariant spans both architectures.  The serial
        # loop (_dispatch_loop) stays selectable for A/Bs.
        self.pipe = None
        if self.pipelined:
            from cuvite_tpu_torch.serve.pipeline import PipelinedDispatcher

            # route looks _route_results up LATE (per call), so an
            # instance-level replacement reaches the pipelined path the
            # same way it reaches the serial loop's attribute lookup.
            self.pipe = PipelinedDispatcher(
                server, lock=self.lock, wake=self._wake,
                drain_req=self._drain_req, poll_s=self.poll_s,
                route=lambda *a: self._route_results(*a),
                on_done=self._finalize)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self.sock_path is not None:
            if os.path.exists(self.sock_path):
                os.unlink(self.sock_path)
            ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ls.bind(self.sock_path)
        else:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind((self.host, self.port))
            self.port = ls.getsockname()[1]   # resolve port 0
        ls.listen(16)
        ls.settimeout(0.2)                    # accept loop polls the stop flag
        self._listener = ls
        self._accept_thread = sync.Thread(
            target=self._accept_loop, name="serve-accept", daemon=True)
        self._accept_thread.start()
        if self.pipe is not None:
            self.pipe.start()
            self._dispatch_thread = self.pipe.exec_thread
        else:
            self._dispatch_thread = sync.Thread(
                target=self._dispatch_loop, name="serve-dispatch",
                daemon=True)
            self._dispatch_thread.start()

    def request_drain(self) -> None:
        """Begin graceful shutdown (idempotent; signal-handler safe:
        only sets events)."""
        self._drain_req.set()
        self._wake.set()

    def serve_forever(self, timeout: float | None = None) -> dict:
        """Block until the drain completes; returns the final summary
        (also emitted as the ``serve_summary`` trace event)."""
        self._done.wait(timeout)
        if not self._done.is_set():
            raise TimeoutError("daemon did not drain within the timeout")
        if self.pipe is not None and self.pipe.pack_thread is not None:
            self.pipe.pack_thread.join(timeout=10.0)
        self._dispatch_thread.join(timeout=10.0)
        return self.summary

    # -- intake -------------------------------------------------------------

    def _accept_loop(self) -> None:
        idx = 0
        while not self._drain_req.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(self.io_timeout_s)
            client = _Client(self, conn, idx)
            idx += 1
            self._clients[id(client)] = client
            client.thread.start()
        try:
            self._listener.close()
        except OSError:
            pass
        if self.sock_path is not None:
            try:
                os.unlink(self.sock_path)
            except OSError:
                pass

    def _forget(self, client: _Client) -> None:
        self._clients.pop(id(client), None)
        try:
            client.conn.close()
        except OSError:
            pass

    def handle(self, req: dict, client: _Client) -> dict:
        op = req.get("op")
        if op == "submit":
            return self._handle_submit(req, client)
        if op == "stats":
            # The stats poll that makes ServeStats' lock a requirement:
            # this runs on a reader thread while the dispatcher appends.
            # (stats.to_dict() is safe under its own lock; the daemon
            # lock additionally keeps the bin dict stable for pending.)
            with self.lock:
                return {"ok": True, "stats": self.server.stats.to_dict(),
                        "pending": self.server.pending(),
                        "conservation": self.server.conservation(),
                        "kernels": launch_counts()}
        if op == "delta":
            return self._handle_delta(req, client)
        if op == "drain":
            self.request_drain()
            return {"ok": True, "draining": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _handle_delta(self, req: dict, client: _Client) -> dict:
        """The streaming verb (reference ``daemon.py:344-420``): edit the
        tenant's RESIDENT slab and optionally re-cluster it warm,
        answering on the reader thread (synchronous -- a delta is one
        tenant's own slab, there is no batch to join; exactly one
        response line per request).  First contact must carry a graph
        spec (the one full upload); later deltas find the session
        resident in the StreamPool and pay only the delta -- unless the
        LRU budget evicted it, in which case the client is told to
        upload again.  The session's tensors are made and used on this
        thread's current stream, never on the packer's side stream."""
        if self._drain_req.is_set():
            return {"ok": False, "draining": True,
                    "error": "daemon is draining; not accepting deltas"}
        tenant = req.get("tenant")
        if not tenant:
            return {"ok": False, "error": "delta needs a tenant"}
        tenant = str(tenant)
        graph = None
        if any(k in req for k in ("graph", "file", "synth")):
            try:
                graph = _decode_graph(req)
            except Exception as e:  # noqa: BLE001 — protocol boundary
                return {"ok": False, "error": f"bad graph spec: {e!r}"}
        ins = req.get("ins") or []
        dels = req.get("del") or []
        try:
            with self.lock:
                # Same recheck as submit: a delta that sees drain_req
                # here must not touch (or admit to) the pool the drain
                # epilogue is about to clear.
                if self._drain_req.is_set():
                    return {"ok": False, "draining": True,
                            "error": "daemon is draining; "
                                     "not accepting deltas"}
                streams = self.server.streams
                sess = streams.get(tenant)
                resident = sess is not None
                if sess is None:
                    if graph is None:
                        return {"ok": False, "resident": False,
                                "error": f"tenant {tenant!r} has no "
                                         "resident session (first "
                                         "contact, or evicted); include "
                                         "a graph/file/synth spec to "
                                         "(re-)upload"}
                    sess = streams.admit(tenant, graph)
                out = {"ok": True, "tenant": tenant, "resident": resident}
                if ins or dels:
                    from cuvite_tpu_torch.stream.delta import DeltaBatch

                    batch = DeltaBatch.from_edits(
                        sess.nv,
                        ins_src=[e[0] for e in ins],
                        ins_dst=[e[1] for e in ins],
                        ins_w=[(e[2] if len(e) > 2 else 1.0)
                               for e in ins],
                        del_src=[e[0] for e in dels],
                        del_dst=[e[1] for e in dels])
                    info = sess.apply_delta(batch)
                    # A spill may have grown the slab class: re-read
                    # the ledger and let LRU eviction re-balance.
                    streams.reledger(tenant)
                    out["delta"] = {k: info[k] for k in
                                    ("n_ins", "n_del", "n_del_hit", "ne",
                                     "frontier_frac")}
                if req.get("recluster"):
                    warm = str(req.get("warm", "labels"))
                    if warm == "labels" and sess.labels() is None:
                        # A fresh (or re-uploaded) session has no prior
                        # labels: its first recluster is cold, and the
                        # reply says so.
                        warm = "cold"
                    res = sess.recluster(warm=warm)
                    rc = {"warm": warm,
                          "q": round(float(res.modularity), 6),
                          "communities": int(res.num_communities),
                          "phases": len(res.phases),
                          "iterations": int(res.total_iterations)}
                    if req.get("labels"):
                        rc["labels"] = [int(x) for x in res.communities]
                    out["recluster"] = rc
                return out
        except Exception as e:  # noqa: BLE001 — protocol boundary
            return {"ok": False, "error": repr(e)}

    def _handle_submit(self, req: dict, client: _Client) -> dict:
        if self._drain_req.is_set():
            return {"ok": False, "draining": True,
                    "error": "daemon is draining; not accepting jobs"}
        try:
            graph = _decode_graph(req)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            return {"ok": False, "error": f"bad graph spec: {e!r}"}
        try:
            with self.lock:
                # Re-check under the lock: the dispatcher only exits
                # once drain_req is set AND the queue is empty, so a
                # submit that sees drain_req here can never enqueue a
                # job the drain would miss.
                if self._drain_req.is_set():
                    return {"ok": False, "draining": True,
                            "error": "daemon is draining; "
                                     "not accepting jobs"}
                rid = req.get("id")
                if rid is not None:
                    # A duplicate id would overwrite the first job's
                    # route: its result would be DELIVERED TO THE
                    # WRONG CLIENT and the second job's dropped.  The
                    # 'job-N' namespace is reserved outright — the
                    # server's auto-generated ids live there, and a
                    # client squatting on one collides with a future
                    # auto id no in-flight check can foresee.
                    if _AUTO_ID.fullmatch(str(rid)):
                        return {"ok": False,
                                "error": f"job id {rid!r} is reserved "
                                         "(server-generated namespace "
                                         "'job-<n>'); pick another"}
                    if rid in self._routes:
                        return {"ok": False,
                                "error": f"duplicate job id {rid!r} "
                                         "still in flight"}
                job_id = self.server.submit(
                    graph, rid,
                    tenant=str(req.get("tenant", "anon")),
                    deadline_s=req.get("deadline_s"))
                self._routes[job_id] = (client, bool(req.get("labels")))
        except AdmissionReject as e:
            return {"ok": False, "rejected": True,
                    "retry_after_s": round(e.retry_after_s, 6),
                    "reason": e.reason}
        except Exception as e:  # noqa: BLE001 — injected submit faults etc.
            return {"ok": False, "error": repr(e)}
        self._wake.set()
        return {"ok": True, "job_id": job_id}

    # -- dispatch -----------------------------------------------------------

    def _send_or_drop(self, client: _Client | None, payload: dict) -> None:
        """Deliver to a client, dropping the CONNECTION (not the
        dispatcher) when it is dead or too slow to read — one stalled
        tenant must never head-of-line-block everyone else's results."""
        if client is not None and not client.send(payload):
            self._forget(client)

    def _route_results(self, finished, fails, sheds) -> None:
        # The route-table pops hold the daemon lock like the inserts in
        # _handle_submit do (_routes' lock discipline is established
        # there) — an unlocked pop could interleave with a
        # reader thread's duplicate-id check and route a result to the
        # wrong client.  Taken per pop, NOT around the sends: a slow
        # client must never stall intake on a held lock.
        for job_id, res in finished:
            with self.lock:
                client, want_labels = self._routes.pop(job_id,
                                                       (None, False))
            payload = {"job_id": job_id,
                       "q": round(float(res.modularity), 6),
                       "communities": int(res.num_communities),
                       "phases": len(res.phases),
                       "iterations": int(res.total_iterations)}
            if want_labels:
                payload["labels"] = [int(x) for x in res.communities]
            self._send_or_drop(client, {"result": payload})
        for job_id, err in fails:
            with self.lock:
                client, _ = self._routes.pop(job_id, (None, False))
            self._send_or_drop(client,
                               {"failed": {"job_id": job_id, "error": err}})
        for job_id, late_s in sheds:
            with self.lock:
                client, _ = self._routes.pop(job_id, (None, False))
            self._send_or_drop(client,
                               {"shed": {"job_id": job_id,
                                         "late_s": round(late_s, 6)}})

    def _dispatch_loop(self) -> None:
        """The SERIAL dispatcher (pipelined=False): one thread owns the
        whole pack+execute lifecycle under the daemon lock, kept for the
        pipeline A/B."""
        server = self.server
        while True:
            self._wake.wait(timeout=self.poll_s)
            self._wake.clear()
            draining = self._drain_req.is_set()
            with self.lock:
                finished = (server.drain() if draining
                            else server.step())
            # Terminal reports with no result object: the daemon
            # CONSUMES these (consume_terminal copies + clears) — a
            # long-lived service under sustained shedding or a standing
            # fault plan must not grow them unboundedly.
            fails, sheds = server.consume_terminal()
            self._route_results(finished, fails, sheds)
            if draining and server.pending() == 0:
                break
        self._finalize()

    def _finalize(self) -> None:
        """Drain epilogue (both architectures; runs on the executor /
        dispatcher thread): emit the serve_summary, notify clients,
        unblock serve_forever."""
        server = self.server
        # Resident tenant slabs do not outlive the service: evict all
        # (freeing device memory, one `evict` event each) BEFORE the
        # summary, so its stream block shows the final ledger.
        server.streams.clear()
        summary = dict(server.stats.to_dict(),
                       conservation=server.conservation(),
                       stream=dict(server.streams.to_dict(),
                                   conservation=server.streams
                                   .conservation()))
        server.tracer.event("serve_summary", **summary)
        self.summary = summary
        for client in list(self._clients.values()):
            client.send({"serve_summary": summary})
            self._forget(client)
        self._done.set()
