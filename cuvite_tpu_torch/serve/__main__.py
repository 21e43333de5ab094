"""Serving CLI (port of ``cuvite_tpu/serve/__main__.py``).

    # synthetic multi-tenant load through the batching queue
    python -m cuvite_tpu_torch.serve demo --jobs 64 --edges 4096 --b-max 64

    # cluster many Vite files as one multi-tenant workload
    python -m cuvite_tpu_torch.serve cluster-many a.vite b.vite --output

    # the daemon: socket intake, admission control, graceful drain
    python -m cuvite_tpu_torch.serve daemon --socket /tmp/cuvite.sock \\
        --wait-slo-ms 500 --fault-plan "device:transient:n=1"

Every command runs the slab-class batching queue (``serve/queue.py``)
over the batched driver: jobs bin by class with per-tenant fairness,
pack to ``--b-max`` with a ``--linger-ms`` deadline, and per-tenant
results stream out as JSON lines, followed by one summary line.  The
daemon adds socket intake (``serve/daemon.py`` documents the wire
protocol), admission control (``--wait-slo-ms``), deadline shedding,
fault injection (``--fault-plan`` / ``CUVITE_FAULT_PLAN``), the streaming
``delta`` verb (per-tenant resident slabs under ``--stream-budget-mb``)
and a graceful drain on SIGTERM/SIGINT, after which the process exits 0.

Batches run on the CUDA card unless ``--device cpu`` is given; without a
card the command exits 2.  On the card the kernels are built and one
small batch is clustered before the first job is taken, so that no
kernel build and none of the card's first-use costs (module loading, the
pinned-memory pool, the upload stream) fall inside a served batch; the
daemon prints its readiness line after that, with both times.
``--trace-out FILE.jsonl`` writes the flight recorder's trace of the run
(the queue's ``pack`` and ``execute`` spans, its admission, shedding and
per-tenant events, and the ``serve_summary``).  The reference's
``--host-devices`` (virtual CPU devices for its batch axis) has no
counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from cuvite_tpu_torch.core.batch import BATCH_ENGINES


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.serve",
        description="slab-class batched Louvain serving on one CUDA card")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(q):
        q.add_argument("--b-max", type=int, default=64,
                       help="max jobs per packed batch (BATCH_SIZES rung)")
        q.add_argument("--linger-ms", type=float, default=50.0,
                       help="max wait of the oldest job before a partial "
                            "batch dispatches")
        q.add_argument("--threshold", type=float, default=1e-6)
        q.add_argument("--engine", default="bucketed",
                       choices=list(BATCH_ENGINES),
                       help="batched engine: 'bucketed' (default: phase 0 "
                            "on the row and heavy kernels over pack-time "
                            "plans, coarse phases re-binned on the card) "
                            "or 'fused' (sort sweeps every phase); results "
                            "are identical either way")
        q.add_argument("--device", default=None,
                       help="where batches run: the CUDA card by default "
                            "(no card: exit 2); 'cpu' runs the kernels' "
                            "plain PyTorch versions")
        q.add_argument("--trace-out", metavar="FILE.jsonl",
                       help="flight-recorder span/event trace (pack and "
                            "execute spans, tenant_result events)")
        q.add_argument("--json", action="store_true",
                       help="per-tenant JSON result lines")
        q.add_argument("--wait-slo-ms", type=float, default=None,
                       help="enable admission control: reject (with "
                            "retry_after_s) when a class's projected "
                            "queue wait breaches this SLO")
        q.add_argument("--fault-plan", default=None,
                       metavar="SITE:KIND:PARAMS[;...]",
                       help="deterministic fault injection plan "
                            "(serve/faults.py grammar; default: the "
                            "CUVITE_FAULT_PLAN env var)")
        q.add_argument("--max-retries", type=int, default=3,
                       help="transient-fault retry budget per dispatch")
        q.add_argument("--retry-base-ms", type=float, default=50.0,
                       help="retry backoff base (doubles per attempt)")
        q.add_argument("--pipeline", default="on", choices=["on", "off"],
                       help="two-stage pipelined dispatch: the host pack "
                            "of batch k+1 overlaps the device execution "
                            "of batch k ('on', the default); 'off' keeps "
                            "the serial single-dispatcher loop.  Results "
                            "are identical either way")
        q.add_argument("--autotune-b-max", action="store_true",
                       help="per-class b_max autotuning from the "
                            "measured service curve (needs "
                            "--wait-slo-ms), capped at --b-max")
        q.add_argument("--merge-packing", action="store_true",
                       help="sub-row merge packing: small-class bins may "
                            "pack 2^k jobs per row of a larger served "
                            "class (fenced sub-rows, results identical "
                            "to B=1); merges on bin overflow, and -- with "
                            "--wait-slo-ms -- whenever measured service "
                            "medians project the packed batch beating "
                            "the linger wait")

    d = sub.add_parser("demo", help="synthetic multi-tenant load")
    common(d)
    d.add_argument("--jobs", type=int, default=32)
    d.add_argument("--edges", type=int, default=4096,
                   help="directed edge records per synthetic graph")
    d.add_argument("--seed", type=int, default=1)

    c = sub.add_parser("cluster-many",
                       help="cluster many Vite files through the queue")
    common(c)
    c.add_argument("files", nargs="+", metavar="FILE.vite")
    c.add_argument("--bits64", action="store_true")
    c.add_argument("--output", action="store_true",
                   help="write <file>.communities per input")

    dm = sub.add_parser("daemon",
                        help="serving daemon (socket intake, graceful "
                             "SIGTERM drain)")
    common(dm)
    dm.add_argument("--socket", metavar="PATH",
                    help="unix-domain socket path for intake")
    dm.add_argument("--port", type=int, default=None,
                    help="TCP port for intake (0 = ephemeral; mutually "
                         "exclusive with --socket)")
    dm.add_argument("--host", default="127.0.0.1")
    dm.add_argument("--stream-budget-mb", type=float, default=256.0,
                    help="device byte budget for resident StreamSessions "
                         "(the `delta` verb's per-tenant live slabs; "
                         "LRU-evicted past the budget)")
    return p


def _make_server(args):
    from cuvite_tpu_torch.serve.admission import AdmissionConfig
    from cuvite_tpu_torch.serve.faults import FaultPlan
    from cuvite_tpu_torch.serve.queue import LouvainServer, ServeConfig

    admission = (AdmissionConfig(wait_slo_s=args.wait_slo_ms / 1e3)
                 if args.wait_slo_ms is not None else None)
    faults = (FaultPlan.parse(args.fault_plan)
              if args.fault_plan is not None else FaultPlan.from_env())
    config = ServeConfig(
        b_max=args.b_max, linger_s=args.linger_ms / 1e3,
        threshold=args.threshold, engine=args.engine, device=args.device,
        admission=admission, max_retries=args.max_retries,
        retry_base_s=args.retry_base_ms / 1e3,
        autotune_b_max=bool(getattr(args, "autotune_b_max", False)),
        merge_packing=bool(getattr(args, "merge_packing", False)),
        stream_budget_bytes=int(
            getattr(args, "stream_budget_mb", 256.0) * (1 << 20)))
    return config, faults, LouvainServer


def _warm(server) -> tuple:
    """Build the CUDA kernels and cluster one small batch on the card
    (module note), then zero the kernels' launch counts, so that the
    daemon's ``stats`` reply counts the served jobs' launches only.
    Returns (build seconds, warm-up seconds), zeros on the CPU."""
    if server.device.type != "cuda":
        return 0.0, 0.0
    from cuvite_tpu_torch.kernels import _build, zero_launch_counts
    from cuvite_tpu_torch.louvain.batched import cluster_many
    from cuvite_tpu_torch.workloads.synth import synthesize_graph

    build_s = _build.build()
    t0 = time.perf_counter()
    cluster_many([synthesize_graph(4096, seed=1)],
                 engine=server.config.engine, device=server.device)
    warm_s = time.perf_counter() - t0
    zero_launch_counts()
    return build_s, warm_s


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    from cuvite_tpu_torch.utils.trace import Tracer

    rec_ctx = contextlib.nullcontext()
    recorder = None
    if args.trace_out:
        from cuvite_tpu_torch.obs import FlightRecorder, JsonlTraceSink

        recorder = FlightRecorder(JsonlTraceSink(args.trace_out))
        rec_ctx = recorder
    tracer = Tracer(recorder=recorder)
    try:
        config, faults, make = _make_server(args)
    except ValueError as e:
        print(f"# config error: {e}", file=sys.stderr)
        return 2
    try:
        server = make(config, tracer=tracer, faults=faults)
    except RuntimeError as e:
        print(f"# device error: {e}", file=sys.stderr)
        return 2
    build_s, warm_s = _warm(server)

    if args.cmd == "daemon":
        import signal

        from cuvite_tpu_torch.serve.daemon import ServeDaemon

        if (args.socket is None) == (args.port is None):
            print("# daemon needs exactly one of --socket / --port",
                  file=sys.stderr)
            return 2
        daemon = ServeDaemon(server, sock_path=args.socket,
                             host=args.host, port=args.port,
                             pipelined=args.pipeline == "on")
        with rec_ctx:
            daemon.start()
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, lambda *_a: daemon.request_drain())
            # The readiness line tells harnesses (tests, the load
            # generator) when to connect and where; the card is warm by
            # now.
            print(json.dumps({"ready": {
                "socket": args.socket, "port": daemon.port,
                "b_max": config.b_max, "engine": config.engine,
                "admission": config.admission is not None,
                "pipelined": daemon.pipelined,
                "autotune": config.autotune_b_max,
                "merge_packing": config.merge_packing,
                "fault_plan": faults.spec(),
                "device": str(server.device),
                "build_s": round(build_s, 3),
                "warm_s": round(warm_s, 3)}}), flush=True)
            summary = daemon.serve_forever()
        print(json.dumps({"serve_summary": summary}), flush=True)
        # Per-job failures are handled per job (isolated, reported);
        # a clean drain is a clean exit.
        return 0

    t0 = time.perf_counter()
    ids = {}
    with rec_ctx:
        if args.cmd == "demo":
            from cuvite_tpu_torch.workloads.synth import (
                many_seed,
                synthesize_graph,
            )

            for k in range(args.jobs):
                g = synthesize_graph(args.edges,
                                     seed=many_seed(args.seed, k))
                ids[server.submit(g)] = f"synth-{k}"
            finished = server.drain()
        else:
            from cuvite_tpu_torch.io.vite import read_vite

            for path in args.files:
                g = read_vite(path, bits64=args.bits64)
                ids[server.submit(g)] = path
            finished = server.drain()
            if args.output:
                from cuvite_tpu_torch.evaluate.compare import (
                    write_communities,
                )

                by_id = dict(finished)
                for jid, path in ids.items():
                    if jid in by_id:  # failed jobs have no result
                        write_communities(path + ".communities",
                                          by_id[jid].communities)
        wall = time.perf_counter() - t0
        summary = dict(server.stats.to_dict(), wall_s=round(wall, 3),
                       wall_jobs_per_s=round(
                           len(finished) / max(wall, 1e-9), 2))
        tracer.event("serve_summary", **summary)

    if args.json:
        for jid, res in finished:
            print(json.dumps({
                "job": ids[jid], "job_id": jid,
                "q": round(float(res.modularity), 6),
                "communities": int(res.num_communities),
                "phases": len(res.phases),
                "iterations": int(res.total_iterations),
            }))
    if server.failures:
        summary["failures"] = [
            {"job": ids.get(jid, jid), "error": err}
            for jid, err in server.failures]
    print(json.dumps({"summary": summary}))
    return 0 if not server.failures else 1


if __name__ == "__main__":
    sys.exit(main())
