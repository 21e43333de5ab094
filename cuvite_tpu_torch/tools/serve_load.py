"""Serving saturation load tool (port of the reference's
``tools/serve_load.py``).

Five verbs around the open-loop generator (``serve/loadgen.py``):

    # geometric arrival-rate ramp: the highest sustainable jobs/s at the SLO
    python -m cuvite_tpu_torch.tools.serve_load sweep --b-max 8 --edges 1024

    # 2x the measured saturation rate, admission on (wait_p95 holds, the
    # excess rejected with retry_after_s) against admission off (the wait
    # grows); two bench records
    python -m cuvite_tpu_torch.tools.serve_load ab --b-max 8 --out-prefix r

    # pipelined against serial dispatcher at a saturating rate
    python -m cuvite_tpu_torch.tools.serve_load pipeab --b-max 8

    # the 90:10 small:big open-loop mix, per-class queues (merge_packing
    # off) against sub-row packing (on); two records with a `mix` block
    python -m cuvite_tpu_torch.tools.serve_load mix --rate 20

    # drive a spawned `python -m cuvite_tpu_torch.serve daemon` over its
    # socket at a fixed rate, then SIGTERM it and check the clean drain
    python -m cuvite_tpu_torch.tools.serve_load daemon --rate 20 --jobs 64

``sweep``/``ab``/``pipeab``/``mix`` run in process (records from
``workloads.bench.run_serve_bench`` / ``run_mixed_serve_bench``, checked
by ``validate_record``); ``daemon`` exercises the socket intake, the
dispatcher and the SIGTERM drain and prints one JSON row (goodput,
wait_p95 against the SLO, reject and shed counts, the daemon's exit
code).  Every verb runs on the CUDA card unless ``--device cpu`` is
given (no card: exit 2).  The kernels' launch counts over the command
go to stderr (``# launches: {...}``; the daemon's from its ``stats``
reply).  Records are written only under ``--out-prefix``, the daemon's
row only under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import select
import signal
import socket
import subprocess
import sys
import threading
import time

from cuvite_tpu_torch.kernels import launch_counts
from cuvite_tpu_torch.tools import child_env, device_or_exit, package_root


def _sweep_run(args, dev):
    """Shared sweep machinery for ``sweep``/``ab``/``pipeab``: synthesize
    the job set, warm the rungs (``workloads.bench.warm_serve_rungs``, the
    one place the warm-up policy lives), ramp rates printing a row per
    round.  Returns ``(graphs, make_server, reports, best)``; ``best is
    None`` means even the start rate overloads (callers return 1)."""
    from cuvite_tpu_torch.serve import (
        AdmissionConfig,
        LouvainServer,
        ServeConfig,
    )
    from cuvite_tpu_torch.serve.loadgen import saturation_sweep
    from cuvite_tpu_torch.workloads.bench import warm_serve_rungs
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    graphs = [synthesize_graph(args.edges, seed=many_seed(args.seed, k))
              for k in range(args.jobs)]
    cls, shape = warm_serve_rungs(graphs, args.b_max, args.engine, dev)

    def make_server():
        srv = LouvainServer(ServeConfig(
            b_max=args.b_max, linger_s=args.linger_ms / 1e3,
            engine=args.engine, device=dev,
            admission=AdmissionConfig(wait_slo_s=args.slo_ms / 1e3)))
        if shape is not None:
            srv.pin_shape(cls, shape)
        return srv

    reports, best = saturation_sweep(
        make_server, lambda: graphs, start_rate=args.start_rate,
        slo_s=args.slo_ms / 1e3, growth=args.growth,
        max_rounds=args.max_rounds,
        pipelined=getattr(args, "pipeline", "off") == "on")
    for rep in reports:
        print(json.dumps(rep.row()), flush=True)
    if best is None:
        print(f"# even {args.start_rate} jobs/s overloads; lower "
              "--start-rate", file=sys.stderr)
    return graphs, make_server, reports, best


def _write(path: str, line: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(line + "\n")
    print(f"# wrote {path}", file=sys.stderr)


def _checked(rec: dict, what: str) -> bool:
    """Print a record's problems on stderr; True when it is valid."""
    from cuvite_tpu_torch.workloads.bench import validate_record

    problems = validate_record(rec)
    if problems:
        print(f"# invalid record ({what}): {problems}", file=sys.stderr)
    return not problems


def saturation(best, reports) -> float:
    """The measured saturation: the highest GOODPUT any sweep round
    showed, not the last sustainable offered rate.  Short sweep bursts
    carry a fixed linger/drain tail that inflates the wall and biases the
    offered-rate knee low, so twice the knee can land under the queue's
    real capacity and never overload it."""
    return max(best.rate, *(r.goodput_jobs_per_s for r in reports))


def ab_verdict(rate2x: float, on: dict, off: dict) -> dict:
    """The ``ab`` verdict from the two records' ``serve`` blocks."""
    return {
        "overload_rate": round(rate2x, 3),
        "admit_wait_p95_ms": on["wait_p95_ms"],
        "admit_slo_met": on["slo_met"],
        "admit_reject_rate": on["reject_rate"],
        "noadmit_wait_p95_ms": off["wait_p95_ms"],
        "noadmit_slo_met": off["slo_met"],
        "acceptance": bool(on["slo_met"] and on["reject_rate"] > 0
                           and not off["slo_met"]),
    }


def pipeab_verdict(ser: dict, pip: dict) -> dict:
    """The ``pipeab`` verdict from the serial and pipelined ``serve``
    blocks.  The acceptance is conditional: >= 1.25x is demanded only
    when pack is at least half of device, since below that even perfect
    overlap cannot reach 1.25x."""
    speedup = pip["goodput_jobs_per_s"] / max(ser["goodput_jobs_per_s"],
                                              1e-9)
    ratio = ser["pack_s"] / max(ser["device_s"], 1e-9)
    return {
        "serial_goodput_jobs_per_s": ser["goodput_jobs_per_s"],
        "pipelined_goodput_jobs_per_s": pip["goodput_jobs_per_s"],
        "speedup": round(speedup, 3),
        "pack_over_device": round(ratio, 3),
        "overlap_frac": pip.get("overlap_frac"),
        "acceptance": bool(speedup >= 1.25 or ratio < 0.5),
    }


def mix_verdict(rate: float, plain: dict, packed: dict) -> dict:
    """The ``mix`` verdict: the packed arm must beat the per-class arm
    on total goodput AND small-class wait_p95, with a merged batch."""
    ps, pl = packed["serve"], plain["serve"]
    pm, lm = packed["mix"], plain["mix"]
    return {
        "rate_jobs_per_s": round(rate, 3),
        "perclass_goodput_jobs_per_s": pl["goodput_jobs_per_s"],
        "packed_goodput_jobs_per_s": ps["goodput_jobs_per_s"],
        "perclass_small_wait_p95_ms": lm["small_wait_p95_ms"],
        "packed_small_wait_p95_ms": pm["small_wait_p95_ms"],
        "merged_batches": pm["merged_batches"],
        "packed_subrow_util": pm["subrow_util"],
        "acceptance": bool(
            ps["goodput_jobs_per_s"] >= pl["goodput_jobs_per_s"]
            and pm["small_wait_p95_ms"] <= lm["small_wait_p95_ms"]
            and pm["merged_batches"] > 0),
    }


def cmd_sweep(args, dev) -> int:
    _graphs, _mk, _reports, best = _sweep_run(args, dev)
    if best is None:
        return 1
    print(json.dumps({"saturation_jobs_per_s": round(best.rate, 3),
                      "wait_p95_ms": round(best.wait_p95_s * 1e3, 3),
                      "slo_ms": args.slo_ms}))
    return 0


def _serve_arms(args, dev, rate: float, arms, kw_of, names) -> dict | None:
    """One ``run_serve_bench`` record per arm at ``rate``, each validated,
    printed and written under ``--out-prefix``; None on an invalid one."""
    from cuvite_tpu_torch.workloads.bench import run_serve_bench

    out = {}
    for arm in arms:
        rec = run_serve_bench(
            rate=rate, b_max=args.b_max, edges=args.edges,
            n_jobs=args.ab_jobs, seed=args.seed, slo_ms=args.slo_ms,
            linger_ms=args.linger_ms, engine=args.engine, device=dev,
            budget_s=args.budget, t_start=args.t_start, **kw_of(arm))
        if not _checked(rec, names[arm]):
            return None
        out[arm] = rec
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out_prefix:
            _write(f"{args.out_prefix}_{names[arm]}.json", line)
    return out


def cmd_ab(args, dev) -> int:
    """Sweep, then twice the saturation with admission on and off; both
    records printed (and written under ``--out-prefix``)."""
    _graphs, _mk, reports, best = _sweep_run(args, dev)
    if best is None:
        return 1
    sat = saturation(best, reports)
    rate2x = 2.0 * sat
    print(json.dumps({"saturation_jobs_per_s": round(sat, 3),
                      "sustainable_offered_rate": round(best.rate, 3),
                      "overload_rate": round(rate2x, 3)}), flush=True)
    out = _serve_arms(
        args, dev, rate2x, (True, False),
        lambda arm: {"admission": arm,
                     "pipelined": args.pipeline == "on"},
        {True: "admit", False: "noadmit"})
    if out is None:
        return 2
    verdict = ab_verdict(rate2x, out[True]["serve"], out[False]["serve"])
    print(json.dumps({"verdict": verdict}))
    return 0 if verdict["acceptance"] else 1


def cmd_pipeab(args, dev) -> int:
    """Pipelined against serial dispatcher on the SAME seeded job set at
    the same saturating offered rate (admission off, so goodput is the
    measured capacity, not an intake policy): one record per arm and a
    verdict with the speedup and the serial arm's pack_s/device_s."""
    _graphs, _mk, reports, best = _sweep_run(args, dev)
    if best is None:
        return 1
    sat = saturation(best, reports)
    rate = args.overload_factor * sat
    print(json.dumps({"serial_saturation_jobs_per_s": round(sat, 3),
                      "ab_rate": round(rate, 3)}), flush=True)
    out = _serve_arms(
        args, dev, rate, (False, True),
        lambda pipe: {"admission": False, "pipelined": pipe},
        {False: "serial", True: "pipelined"})
    if out is None:
        return 2
    verdict = pipeab_verdict(out[False]["serve"], out[True]["serve"])
    print(json.dumps({"verdict": verdict}))
    return 0 if verdict["acceptance"] else 1


def cmd_mix(args, dev) -> int:
    """One 90:10 skewed small:big arrival mix at one offered rate, served
    twice: merge_packing on (small bins pack as fenced sub-rows of the big
    class's rows) and off (strict per-class queues)."""
    from cuvite_tpu_torch.workloads.bench import run_mixed_serve_bench

    out = {}
    for packed in (False, True):
        rec = run_mixed_serve_bench(
            rate=args.rate, merge_packing=packed, b_max=args.b_max,
            small_edges=args.edges, big_scale=args.big_scale,
            big_edge_factor=args.big_edge_factor,
            n_small=args.n_small, n_big=args.n_big, seed=args.seed,
            slo_ms=args.slo_ms, linger_ms=args.linger_ms,
            engine=args.engine, device=dev, budget_s=args.budget,
            pipelined=args.pipeline == "on", t_start=args.t_start)
        if not _checked(rec, f"merge_packing={packed}"):
            return 2
        out[packed] = rec
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out_prefix:
            _write(f"{args.out_prefix}_"
                   f"{'packed' if packed else 'perclass'}.json", line)
    verdict = mix_verdict(args.rate, out[False], out[True])
    print(json.dumps({"verdict": verdict}))
    return 0 if verdict["acceptance"] else 1


def _read_ready(proc, timeout_s: float) -> dict:
    """The daemon's readiness line, with a hard deadline (a wedged
    start-up must fail this tool, not hang it)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        r, _, _ = select.select([proc.stdout], [], [], 0.5)
        if not r:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"daemon exited rc={proc.returncode} before ready")
            continue
        chunk = proc.stdout.readline()
        if not chunk:
            raise RuntimeError("daemon stdout closed before ready")
        buf = chunk.strip()
        if buf.startswith("{"):
            msg = json.loads(buf)
            if "ready" in msg:
                return msg["ready"]
    raise RuntimeError(f"daemon not ready within {timeout_s}s")


def daemon_argv(args) -> list:
    """The spawned daemon's command line: the port's own flags."""
    cmd = [sys.executable, "-m", "cuvite_tpu_torch.serve", "daemon",
           "--port", "0", "--b-max", str(args.b_max),
           "--linger-ms", str(args.linger_ms),
           "--engine", args.engine,
           "--pipeline", args.pipeline]
    if args.device is not None:
        cmd += ["--device", args.device]
    if args.slo_ms > 0:
        cmd += ["--wait-slo-ms", str(args.slo_ms)]
    if args.fault_plan:
        cmd += ["--fault-plan", args.fault_plan]
    return cmd


def cmd_daemon(args, dev) -> int:
    """Spawn the daemon, drive an open-loop synth load over its socket,
    SIGTERM it, and check the graceful drain (exit 0 and the summary)."""
    proc = subprocess.Popen(daemon_argv(args), stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True,
                            cwd=package_root(), env=child_env())
    conn = None
    try:
        ready = _read_ready(proc, args.ready_timeout)
        port = ready["port"]
        # Loopback to the daemon this tool just spawned.
        conn = socket.create_connection(("127.0.0.1", port), timeout=30.0)  # graftlint: disable=R009 — localhost control channel to our own child process
        lines = conn.makefile("r", encoding="utf-8")
        events = {"result": 0, "failed": 0, "shed": 0, "rejected": 0,
                  "acked": 0, "refused": 0, "summary": None,
                  "kernels": None}
        done_evt = threading.Event()

        def reader():
            for line in lines:
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "serve_summary" in msg:
                    events["summary"] = msg["serve_summary"]
                    done_evt.set()
                elif "result" in msg:
                    events["result"] += 1
                elif "failed" in msg:
                    events["failed"] += 1
                elif "shed" in msg:
                    events["shed"] += 1
                elif msg.get("rejected"):
                    events["rejected"] += 1
                elif "stats" in msg:
                    events["kernels"] = msg.get("kernels")
                elif "ok" in msg:
                    events["acked" if msg["ok"] else "refused"] += 1
            done_evt.set()

        threading.Thread(target=reader, daemon=True).start()
        t0 = time.perf_counter()
        wlock = threading.Lock()
        for k in range(args.jobs):
            target = t0 + k / args.rate
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            req = {"op": "submit", "synth": {"edges": args.edges,
                                             "seed": 1000 + k},
                   "tenant": f"t{k % max(args.tenants, 1)}"}
            if args.deadline_ms:
                req["deadline_s"] = args.deadline_ms / 1e3
            with wlock:
                conn.sendall((json.dumps(req) + "\n").encode())
        # Submits are pipelined (no per-request round trip); wait until
        # the daemon has ANSWERED every one before pulling the trigger,
        # or the SIGTERM would drain-refuse intake it never saw.
        ack_deadline = time.monotonic() + args.ready_timeout
        while time.monotonic() < ack_deadline:
            if (events["acked"] + events["rejected"]
                    + events["refused"]) >= args.jobs:
                break
            time.sleep(0.05)
        # The served jobs' launches, from the daemon's own counts.
        with wlock:
            conn.sendall((json.dumps({"op": "stats"}) + "\n").encode())
        stats_deadline = time.monotonic() + 30.0
        while (events["kernels"] is None
               and time.monotonic() < stats_deadline):
            time.sleep(0.05)
        # Graceful shutdown through the signal path (the check).
        proc.send_signal(signal.SIGTERM)
        done_evt.wait(timeout=args.drain_timeout)
        rc = proc.wait(timeout=60)
        wall = time.perf_counter() - t0
        summary = events["summary"] or {}
        stats = summary if "jobs_done" in summary else {}
        row = {
            "daemon": True,
            "b_max": args.b_max,
            "engine": args.engine,
            "pipelined": args.pipeline == "on",
            "arrival_jobs_per_s": round(args.rate, 3),
            "offered": args.jobs,
            "done": stats.get("jobs_done", events["result"]),
            "failed": stats.get("jobs_failed", events["failed"]),
            "shed": stats.get("jobs_shed", events["shed"]),
            "rejected": stats.get("jobs_rejected", events["rejected"]),
            "goodput_jobs_per_s": round(
                stats.get("jobs_done", events["result"]) / max(wall, 1e-9),
                3),
            "wait_p95_ms": stats.get("wait_p95_ms"),
            "slo_ms": args.slo_ms,
            "conservation": summary.get("conservation"),
            "daemon_rc": rc,
            "clean_drain": bool(rc == 0 and summary),
        }
        print(f"# launches: {json.dumps(events['kernels'])}",
              file=sys.stderr)
        print(json.dumps(row))
        if args.out:
            _write(args.out, json.dumps(row))
        return 0 if row["clean_drain"] else 1
    finally:
        if conn is not None:
            conn.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.tools.serve_load",
        description="serving saturation load generator")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(q):
        q.add_argument("--b-max", type=int, default=8)
        q.add_argument("--edges", type=int, default=1024)
        q.add_argument("--jobs", type=int, default=64)
        q.add_argument("--seed", type=int, default=1)
        q.add_argument("--slo-ms", type=float, default=500.0)
        q.add_argument("--linger-ms", type=float, default=20.0)
        q.add_argument("--engine", default="bucketed",
                       choices=["bucketed", "fused"])
        q.add_argument("--device", default=None,
                       help="where the batches run: the CUDA card by "
                            "default (no card: exit 2); 'cpu' runs the "
                            "kernels' plain PyTorch versions")
        q.add_argument("--pipeline", default="off", choices=["on", "off"],
                       help="two-stage pipelined dispatch: sweep/ab run "
                            "the in-process dispatcher in this mode; "
                            "daemon forwards it to the spawned daemon")

    sw = sub.add_parser("sweep", help="find max sustainable jobs/s")
    common(sw)
    sw.add_argument("--start-rate", type=float, default=4.0)
    sw.add_argument("--growth", type=float, default=1.6)
    sw.add_argument("--max-rounds", type=int, default=8)

    ab = sub.add_parser("ab", help="2x-saturation admission on/off A/B")
    common(ab)
    ab.add_argument("--start-rate", type=float, default=4.0)
    ab.add_argument("--growth", type=float, default=1.5)
    ab.add_argument("--max-rounds", type=int, default=12)
    ab.add_argument("--ab-jobs", type=int, default=512,
                    help="job count for the two 2x-overload runs: must "
                         "offer enough WORK that the backlog a 2x rate "
                         "builds can push queue waits past the SLO "
                         "(64 jobs drain before the wait integral shows)")
    ab.add_argument("--budget", type=float, default=600.0)
    ab.add_argument("--out-prefix", default=None,
                    help="write <prefix>_admit.json / <prefix>_noadmit.json")

    pab = sub.add_parser("pipeab",
                         help="pipelined-vs-serial dispatcher A/B at a "
                              "saturating rate")
    common(pab)
    pab.add_argument("--start-rate", type=float, default=4.0)
    pab.add_argument("--growth", type=float, default=1.5)
    pab.add_argument("--max-rounds", type=int, default=12)
    pab.add_argument("--overload-factor", type=float, default=1.5,
                     help="offered rate = factor * measured serial "
                          "saturation (must exceed BOTH arms' capacity "
                          "so goodput reads capacity, not arrival)")
    pab.add_argument("--ab-jobs", type=int, default=256)
    pab.add_argument("--budget", type=float, default=600.0)
    pab.add_argument("--out-prefix", default=None,
                     help="write <prefix>_serial.json / "
                          "<prefix>_pipelined.json")

    mx = sub.add_parser("mix",
                        help="90:10 skewed-mix packed-vs-per-class A/B")
    common(mx)
    mx.add_argument("--mix", default="90:10",
                    help="small:big arrival ratio by count (informational"
                         " -- pool sizes come from --n-small/--n-big; the "
                         "default pools realize 90:10)")
    mx.add_argument("--rate", type=float, default=20.0,
                    help="offered arrival rate over the WHOLE mix")
    mx.add_argument("--big-scale", type=int, default=13,
                    help="R-MAT scale of the big pool (default 13 with "
                         "--big-edge-factor 2 lands in (8192, 32768), an "
                         "n_sub=2 row class for 1024-edge smalls)")
    mx.add_argument("--big-edge-factor", type=int, default=2)
    mx.add_argument("--n-small", type=int, default=None)
    mx.add_argument("--n-big", type=int, default=None)
    mx.add_argument("--budget", type=float, default=600.0)
    mx.add_argument("--out-prefix", default=None,
                    help="write <prefix>_packed.json / "
                         "<prefix>_perclass.json")
    # The packed program is plan-free (fused-style specs); defaulting the
    # PLAIN arm to bucketed would measure the engine gap, not the packing
    # policy -- the A/B runs fused on both arms unless overridden.
    mx.set_defaults(engine="fused")

    dm = sub.add_parser("daemon",
                        help="drive a spawned serve daemon over its socket")
    common(dm)
    dm.add_argument("--rate", type=float, default=10.0)
    dm.add_argument("--tenants", type=int, default=4)
    dm.add_argument("--deadline-ms", type=float, default=None)
    dm.add_argument("--fault-plan", default=None)
    dm.add_argument("--ready-timeout", type=float, default=180.0)
    dm.add_argument("--drain-timeout", type=float, default=600.0)
    dm.add_argument("--out", default=None)
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    args.t_start = time.perf_counter()
    dev = device_or_exit(args.device)
    if args.cmd == "daemon":
        return cmd_daemon(args, dev)
    from cuvite_tpu_torch.kernels import zero_launch_counts

    zero_launch_counts()
    cmd = {"sweep": cmd_sweep, "ab": cmd_ab, "pipeab": cmd_pipeab,
           "mix": cmd_mix}[args.cmd]
    try:
        return cmd(args, dev)
    finally:
        print(f"# launches: {json.dumps(launch_counts())}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
