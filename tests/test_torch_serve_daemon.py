"""cuvite_tpu_torch's serving daemon on the CPU: the socket protocol held
against the reference daemon's, refusals, the ``delta`` verb beside the
batch path, the drain, pipelined results equal to serial ones, and the
CLI end to end (the ``delta`` verb against the reference daemon's is in
tests/test_torch_stream.py).

In-process daemons run a stub runner over a unix socket, so the protocol
and threading machinery is tested in milliseconds; the reference daemon
answers the same request lines with the same reply lines.  The real
engine runs on the CPU (``device="cpu"`` / ``--device cpu``): in process
for the pipelined-against-serial comparison, and in a subprocess for the
SIGTERM drain under an injected fault plan.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

import cuvite_tpu.serve as jserve
import cuvite_tpu_torch.serve as pserve

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stub_runner(graphs, **kw):
    results = []
    for g in graphs:
        nv = g.num_vertices
        key = int(np.sum(g.tails)) % 997
        results.append(types.SimpleNamespace(
            communities=(np.arange(nv) + key) % max(nv, 1),
            modularity=key / 997.0, phases=[1], total_iterations=3,
            num_communities=nv))
    return types.SimpleNamespace(results=results, n_phases=1)


class DaemonClient:
    """Minimal line-protocol client."""

    def __init__(self, sock_path):
        self.conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.conn.connect(sock_path)
        self.conn.settimeout(60.0)
        self.lines = self.conn.makefile("r", encoding="utf-8")
        self.pending: list = []

    def send(self, req: dict) -> None:
        self.conn.sendall((json.dumps(req) + "\n").encode())

    def _raw(self) -> dict:
        line = self.lines.readline()
        assert line, "daemon closed the connection unexpectedly"
        return json.loads(line)

    def recv(self) -> dict:
        if self.pending:
            return self.pending.pop(0)
        return self._raw()

    def call(self, req: dict) -> dict:
        """Send a request and return its reply (an 'ok' line), keeping
        the result lines that arrive first."""
        self.send(req)
        while True:
            msg = self._raw()
            if "ok" in msg:
                return msg
            self.pending.append(msg)

    def until_summary(self) -> list:
        msgs = []
        while True:
            msg = self.recv()
            msgs.append(msg)
            if "serve_summary" in msg:
                return msgs

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


def graph_req(seed: int, nv: int = 12, ne: int = 24, **extra) -> dict:
    rng = np.random.default_rng(seed)
    return dict({"op": "submit", "graph": {
        "nv": nv,
        "src": [int(x) for x in rng.integers(0, nv, ne)],
        "dst": [int(x) for x in rng.integers(0, nv, ne)],
        "w": None}}, **extra)


def start_daemon(pkg, path, *, runner=stub_runner, pipelined=True, **cfg):
    cfg.setdefault("b_max", 2)
    cfg.setdefault("linger_s", 0.01)
    cfg.setdefault("engine", "fused")
    srv = pkg.LouvainServer(pkg.ServeConfig(**cfg), runner=runner)
    d = pkg.ServeDaemon(srv, sock_path=str(path), poll_s=0.005,
                        pipelined=pipelined)
    d.start()
    return d


def stop(d):
    if not d._done.is_set():
        d.request_drain()
    return d.serve_forever(timeout=60.0)


# The request lines of the protocol comparison, and the replies each
# gets, as the reference answers them.
SESSION = [
    {"op": "explode"},
    {"op": "submit"},
    dict(graph_req(9), id="job-7"),
    dict(graph_req(1), labels=True, tenant="a"),
    dict(graph_req(2), id="mine-1", tenant="b"),
    dict(graph_req(2), id="mine-1"),
    {"op": "submit", "synth": {"edges": 256, "seed": 4}},
    {"op": "submit", "graph": {"nv": 3}},
]


def _session(pkg, path):
    d = start_daemon(pkg, path, pipelined=False, linger_s=10.0, b_max=8)
    c = DaemonClient(str(path))
    try:
        replies = [c.call(req) for req in SESSION]
        c.conn.sendall(b"this is not json\n")
        replies.append(c.recv())
        assert c.call({"op": "drain"}) == {"ok": True, "draining": True}
        rest = c.until_summary()
    finally:
        c.close()
    stop(d)
    for m in rest:        # wall-clock fields differ run to run
        for k in ("busy_s", "jobs_per_s", "pack_s", "device_s",
                  "wait_p50_ms", "wait_p95_ms"):
            m.get("serve_summary", {}).pop(k, None)
    return replies, sorted(json.dumps(m, sort_keys=True) for m in rest)


def test_protocol_replies_match_reference(tmp_path):
    ref = _session(jserve, tmp_path / "j.sock")
    mine = _session(pserve, tmp_path / "p.sock")
    assert mine == ref
    replies, rest = mine
    assert [r["ok"] for r in replies[:8]] == [False, False, False, True,
                                              True, False, True, False]
    assert "reserved" in replies[2]["error"]
    assert "duplicate" in replies[5]["error"]
    assert "bad json" in replies[8]["error"]
    results = [json.loads(m) for m in rest if '"result"' in m]
    assert len(results) == 3
    assert sum("labels" in m["result"] for m in results) == 1


class _StreamStub:
    """Daemon-facing session stub (tests/test_stream.py's): a real
    DeltaBatch in, canned numbers out."""

    def __init__(self, graph):
        self.nv = graph.num_vertices
        self.ne = graph.num_edges
        self._labels = None

    def hbm_bytes(self):
        return 1000

    def labels(self):
        return self._labels

    def apply_delta(self, batch):
        self.ne += batch.n_ins
        return {"n_ins": batch.n_ins, "n_del": batch.n_del,
                "n_del_hit": 0, "ne": self.ne, "frontier_frac": 0.25,
                "wall_s": 0.0}

    def recluster(self, warm="labels", **kw):
        self._labels = np.zeros(self.nv, dtype=np.int64)
        return types.SimpleNamespace(
            modularity=0.5, num_communities=2, phases=[1],
            total_iterations=3, communities=self._labels)


def test_delta_verb_and_daemon_keeps_serving(tmp_path):
    """The ``delta`` verb beside the batch path: first contact without a
    graph is refused, an upload admits the tenant, a bare delta finds it
    resident, a warm recluster without labels runs cold and says so; the
    daemon keeps serving jobs, and its drain clears the pool into the
    summary's ``stream`` block."""
    srv = pserve.LouvainServer(
        pserve.ServeConfig(b_max=2, linger_s=0.01, engine="fused",
                           stream_budget_bytes=1500),
        runner=stub_runner,
        stream_factory=lambda graph, tracer=None: _StreamStub(graph))
    d = pserve.ServeDaemon(srv, sock_path=str(tmp_path / "d.sock"),
                           poll_s=0.005)
    d.start()
    c = DaemonClient(str(tmp_path / "d.sock"))
    gspec = {"nv": 8, "src": [0, 1, 2, 3], "dst": [1, 2, 3, 4]}
    try:
        r = c.call({"op": "delta", "tenant": "t0", "ins": [[0, 1]]})
        assert not r["ok"] and r["resident"] is False
        assert "upload" in r["error"]
        r = c.call({"op": "delta", "tenant": "t0", "graph": gspec,
                    "ins": [[0, 5], [1, 6, 2.0]], "del": [[0, 1]]})
        assert r["ok"] and r["resident"] is False
        assert r["delta"] == {"n_ins": 4, "n_del": 2, "n_del_hit": 0,
                              "ne": 12, "frontier_frac": 0.25}
        r = c.call({"op": "delta", "tenant": "t0", "ins": [[2, 7]],
                    "recluster": True, "warm": "labels"})
        assert r["ok"] and r["resident"] is True
        assert r["recluster"]["warm"] == "cold"
        r = c.call({"op": "delta", "tenant": "t0", "recluster": True,
                    "labels": True})
        assert r["recluster"]["warm"] == "labels"
        assert r["recluster"]["labels"] == [0] * 8
        # A second tenant over the 1500-byte budget evicts the first.
        assert c.call({"op": "delta", "tenant": "t1", "graph": gspec})["ok"]
        assert srv.streams.to_dict()["evicted"] == 1
        assert c.call(graph_req(3))["ok"]
        assert "result" in c.recv()
        st = c.call({"op": "stats"})
        assert st["ok"] and st["stats"]["jobs_done"] == 1
        assert st["conservation"]["ok"] and st["pending"] == 0
        # Beyond the reference's reply: the kernels' launch counts, none
        # on the CPU.
        assert st["kernels"] == dict.fromkeys(
            ("row_argmax", "heavy_bincount", "seg_coalesce",
             "row_argmax_sized"), 0)
    finally:
        c.close()
    summary = stop(d)
    assert summary["conservation"]["ok"]
    assert summary["stream"] == {
        "resident": 0, "admitted": 2, "evicted": 2, "bytes_resident": 0,
        "budget_bytes": 1500,
        "conservation": {"admitted": 2, "evicted": 2, "resident": 0,
                         "bytes_resident": 0, "ok": True}}


def test_submit_refused_while_draining(tmp_path):
    d = start_daemon(pserve, tmp_path / "r.sock", linger_s=10.0)
    c = DaemonClient(str(tmp_path / "r.sock"))
    try:
        assert c.call(graph_req(1))["ok"]
        # Drain requested but the epilogue not run yet: the daemon lock
        # holds the dispatcher back while the refusal is checked.
        with d.lock:
            d.request_drain()
            resp = c.call(graph_req(2))
        assert resp["ok"] is False and resp["draining"] is True
        msgs = c.until_summary()
        assert msgs[-1]["serve_summary"]["jobs_done"] == 1
        assert msgs[-1]["serve_summary"]["conservation"]["ok"]
    finally:
        c.close()
    stop(d)


def _real_results(path, pipelined):
    d = start_daemon(pserve, path, runner=None, pipelined=pipelined,
                     device="cpu", engine="bucketed", b_max=2,
                     linger_s=0.005)
    c = DaemonClient(str(path))
    try:
        acks = [c.call({"op": "submit", "id": f"s{k}", "labels": True,
                        "synth": {"edges": 512, "seed": 50 + k}})
                for k in range(5)]
        assert all(a["ok"] for a in acks), acks
        c.send({"op": "drain"})
        msgs = c.until_summary()
    finally:
        c.close()
    summary = stop(d)
    assert summary["conservation"]["ok"] and summary["jobs_done"] == 5
    assert summary["pipeline_depth"] == (2 if pipelined else 1)
    return {m["result"]["job_id"]: m["result"] for m in msgs
            if "result" in m}


def test_pipelined_results_equal_serial_and_direct(tmp_path):
    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.workloads.synth import synthesize_graph

    piped = _real_results(tmp_path / "p.sock", True)
    serial = _real_results(tmp_path / "s.sock", False)
    assert piped == serial and len(piped) == 5
    for k in range(5):
        g = synthesize_graph(512, seed=50 + k)
        solo = louvain_many([g], engine="bucketed", device="cpu").results[0]
        assert piped[f"s{k}"]["labels"] == solo.communities.tolist()
        assert piped[f"s{k}"]["q"] == round(solo.modularity, 6)


def test_daemon_sigterm_clean_drain_subprocess(tmp_path):
    sock = str(tmp_path / "d.sock")
    env = dict(os.environ, CUVITE_FAULT_PLAN="device:transient:n=1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cuvite_tpu_torch.serve", "daemon",
         "--socket", sock, "--b-max", "2", "--linger-ms", "5",
         "--device", "cpu", "--max-retries", "2", "--retry-base-ms", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env)
    try:
        ready = json.loads(proc.stdout.readline())["ready"]
        assert ready["socket"] == sock and ready["device"] == "cpu"
        assert ready["fault_plan"] == "device:transient:n=1"
        assert ready["pipelined"] is True
        assert ready["build_s"] == ready["warm_s"] == 0.0
        c = DaemonClient(sock)
        try:
            acks = [c.call({"op": "submit",
                            "synth": {"edges": 256, "seed": 40 + s},
                            "tenant": f"t{s % 2}"}) for s in range(4)]
            assert all(a["ok"] for a in acks), acks
            proc.send_signal(signal.SIGTERM)
            seen = c.until_summary()
        finally:
            c.close()
        rc = proc.wait(timeout=120)
        assert rc == 0, proc.stderr.read()[-2000:]
        summary = seen[-1]["serve_summary"]
        assert summary["jobs_done"] == 4 and summary["jobs_failed"] == 0
        assert summary["retries"] >= 1 and summary["conservation"]["ok"]
        assert len([m for m in seen if "result" in m]) == 4
        out = proc.stdout.read().strip().splitlines()
        assert json.loads(out[-1])["serve_summary"]["jobs_done"] == 4
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


@pytest.mark.parametrize("argv,why", [
    (["daemon", "--socket", "/tmp/x.sock", "--port", "7", "--device",
      "cpu"], "exactly one"),
    (["daemon", "--device", "cpu"], "exactly one"),
    (["daemon", "--socket", "/tmp/x.sock", "--fault-plan", "bogus:nope",
      "--device", "cpu"], "fault directive"),
    (["demo", "--jobs", "1"], "device error"),
])
def test_cli_errors_exit_2(argv, why):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "cuvite_tpu_torch.serve",
                          *argv], capture_output=True, text=True,
                         timeout=120, cwd=REPO, env=env)
    assert out.returncode == 2 and why in out.stderr, out.stderr[-500:]
    assert out.stdout == ""


def test_cli_demo_and_cluster_many_on_cpu(tmp_path, capsys):
    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.io.vite import write_vite
    from cuvite_tpu_torch.serve.__main__ import _build_parser, main
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    assert main(["demo", "--jobs", "3", "--edges", "512", "--b-max", "4",
                 "--json", "--device", "cpu", "--engine", "fused"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["job"] for x in lines[:3]] == ["synth-0", "synth-1",
                                             "synth-2"]
    assert lines[-1]["summary"]["jobs_done"] == 3
    g = synthesize_graph(512, seed=many_seed(1, 0))
    solo = louvain_many([g], engine="bucketed", device="cpu").results[0]
    assert lines[0]["q"] == round(solo.modularity, 6)
    assert lines[0]["communities"] == solo.num_communities
    path = str(tmp_path / "a.vite")
    write_vite(path, g, bits64=False)
    assert main(["cluster-many", path, "--output", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1])["summary"]["jobs_done"] == 1
    assert np.array_equal(np.loadtxt(path + ".communities", dtype=np.int64),
                          solo.communities)
    assert _build_parser().parse_args(
        ["demo", "--trace-out", "t.jsonl"]).trace_out == "t.jsonl"
