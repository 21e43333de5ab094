"""Collective launch-latency ladder: bracket the exchange cutover (port of
the reference's ``tools/exchange_latency.py``).

The exchange='auto' cutover (``louvain.driver.AUTO_SPARSE_MIN_VERTICES``)
decides when the sparse ghost exchange replaces the replicated one.  This
ladder times the three collectives the two exchanges are made of, over
the port's own collectives (``comm/collectives.py``), and prints the
bracket where three modeled sparse launches become cheaper than three
modeled replicated ones:

  all_gather(n)  -- the replicated exchange's community pull (with two
                    psum'd tables of the same extent: ~3 launches of
                    O(nv_total) elements a shard a sweep);
  psum(n)        -- the replicated tables' reduction;
  all_to_all(b)  -- the sparse exchange's transport (3 launches a sweep,
                    each ~ghost_frac * nv elements).

Per size: a warm-up call, then the minimum of ``--repeats`` calls, the
devices synchronized before and after each (min, not mean: noise only
adds).  The launch latency is the smallest size's time; the bracket
comes from :func:`crossover`, a pure function of the measured rows.

Where the bytes go (the verdict's ``note`` says which):

- one process, per-shard lists (default): the shards' blocks move with
  device copies.  With every shard on one card (``--device cuda:0``, or
  fewer visible cards than shards) no link is crossed; with one shard a
  card the copies are peer copies driven from one process;
- ``--world W``: W ranks, one per card, through ``comm.multihost.launch``
  (NCCL on the cards, gloo under ``--device cpu``): the only mode that
  measures the cards' links.

``--mesh DCNxICI``: the same ladder per axis of a hybrid mesh
(``comm.mesh.make_hybrid_mesh``): the ICI-group all_gather and psum that
build the two-level exchange's group tables against the DCN-column
all_to_all that moves its ghosts, plus the global gather the scheme
avoids.

    python -m cuvite_tpu_torch.tools.exchange_latency --devices 4 --json
    python -m cuvite_tpu_torch.tools.exchange_latency --mesh 2x2 --json
    python -m cuvite_tpu_torch.tools.exchange_latency --world 4 --json
    python -m cuvite_tpu_torch.tools.exchange_latency --devices 2 \\
        --device cpu --min-log2 7 --max-log2 10 --json --out lat.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from cuvite_tpu_torch.tools import (
    child_env,
    device_or_exit,
    package_root,
    shard_devices,
    sync,
)

FLAT_KEYS = ("all_gather_s", "psum_s", "all_to_all_s")
# --world: the ranks are killed after WORLD_START_S (start, group join)
# plus CALL_S for each collective call of the ladder.
WORLD_START_S = 300.0
CALL_S = 0.25


def build_argparser():
    ap = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.tools.exchange_latency",
        description="all_to_all / all_gather launch-latency ladder")
    ap.add_argument("--devices", type=int, default=8,
                    help="shards of the mesh (one process: on one card "
                         "each while there are cards enough, else all on "
                         "card 0; with --device all on that device)")
    ap.add_argument("--device", default=None,
                    help="put every shard on this device ('cpu' runs on "
                         "the CPU); default: the CUDA cards (no card: "
                         "exit 2)")
    ap.add_argument("--repeats", type=int, default=30,
                    help="timed calls per size (min is reported)")
    ap.add_argument("--min-log2", type=int, default=7,
                    help="smallest per-shard element count, log2")
    ap.add_argument("--max-log2", type=int, default=22,
                    help="largest per-shard element count, log2")
    ap.add_argument("--ghost-frac", type=float, default=0.10,
                    help="modeled ghost+budget fraction of nv for the "
                         "sparse side (scale-free; R-MAT partitions "
                         "measure 0.05-0.2 a shard)")
    ap.add_argument("--mesh", metavar="DCNxICI", default=None,
                    help="two-axis mode: each collective per hybrid-mesh "
                         "axis (ICI-group table gather against DCN-column "
                         "ghost all_to_all) instead of the flat ladder")
    ap.add_argument("--world", type=int, default=None, metavar="W",
                    help="run the flat ladder as W ranks, one per card "
                         "(NCCL; gloo with --device cpu), one shard each")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON line at the end")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON verdict to FILE")
    ap.add_argument("--rank-worker", action="store_true",
                    help=argparse.SUPPRESS)
    return ap


def world_timeout_s(args) -> float:
    """Seconds before the ranks of ``--world`` are killed: the start
    allowance and ``CALL_S`` for each of the ladder's calls (three
    collectives, a warm-up and ``--repeats`` timed calls a size)."""
    sizes = args.max_log2 - args.min_log2 + 1
    return WORLD_START_S + 3 * sizes * (args.repeats + 1) * CALL_S


def _emit(verdict, args):
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=2, sort_keys=True)
            f.write("\n")
    if args.json:
        print(json.dumps(verdict))


def _timer(devs, repeats: int, barrier=None):
    """min-of-``repeats`` wall seconds of a call, the devices synchronized
    before and after each (and a host barrier before each under a
    process group), after one warm-up call."""
    uniq = list(dict.fromkeys(devs))

    def sync_all():
        for d in uniq:
            sync(d)

    def timed(fn):
        fn()
        sync_all()
        best = float("inf")
        for _ in range(repeats):
            if barrier is not None:
                barrier()
            sync_all()
            t0 = time.perf_counter()
            fn()
            sync_all()
            best = min(best, time.perf_counter() - t0)
        return best

    return timed


def flat_rows(mesh, args, barrier=None, echo: bool = False) -> list:
    """The flat ladder over ``mesh``'s (local) shards; ``echo`` prints
    each row as it is measured."""
    from cuvite_tpu_torch.comm.collectives import all_gather, all_to_all, psum

    S = mesh.size
    timed = _timer(mesh.devices, args.repeats, barrier)
    rows = []
    for k in range(args.min_log2, args.max_log2 + 1):
        n = 1 << k
        xs = [torch.ones(n, dtype=torch.float32, device=d)
              for d in mesh.devices]
        t_ag = timed(lambda: all_gather(xs, mesh))  # graftlint: replicated-ok=scope=bench; launch-latency microbenchmark measuring this collective itself, not a product table
        t_ps = timed(lambda: psum(xs, mesh))
        # all_to_all: the same per-shard element count, [S, n/S] blocks
        # (padded so that every pair's block is non-empty).
        b = max(n // S, 1)
        ys = [torch.ones((S, b), dtype=torch.float32, device=d)
              for d in mesh.devices]
        t_aa = timed(lambda: all_to_all(ys, mesh))
        del xs, ys
        rows.append({"n_per_chip": n, "all_gather_s": t_ag,
                     "psum_s": t_ps, "all_to_all_s": t_aa})
        if echo:
            _print_rows(rows[-1:], FLAT_KEYS)
    return rows


def _print_rows(rows, keys) -> None:
    for r in rows:
        print(f"  {r['n_per_chip']:>10} "
              + " ".join(f"{r[k]:>12.3e}" for k in keys), flush=True)


def interp(rows, series: str, n: float) -> float:
    """Piecewise-linear read of a measured curve at per-shard count n
    (clamped; log-domain interpolation between the pow2 samples)."""
    pts = [(r["n_per_chip"], r[series]) for r in rows]
    if n <= pts[0][0]:
        return pts[0][1]
    for (n0, t0), (n1, t1) in zip(pts, pts[1:]):
        if n <= n1:
            f = (np.log2(n) - np.log2(n0)) / (np.log2(n1) - np.log2(n0))
            return t0 + f * (t1 - t0)
    return pts[-1][1]


def crossover(rows, shards: int, ghost_frac: float) -> tuple:
    """The per-sweep exchange TRANSPORT model over padded total vertex
    count nv, from the measured ``rows`` (the sparse exchange's sort and
    route compute is out of scope; ``exchange_bench`` times it end to
    end):

      replicated: all_gather(comm) + psum(comm_deg) + psum(comm_size),
                  each nv elements a shard;
      sparse:     3 all_to_alls of ~ghost_frac * nv elements a shard.

    nv runs over the powers of two from 8x the smallest measured size to
    ``shards`` times the largest.  Returns ``(model, [lo, hi])``, model a
    list of (nv, replicated s, sparse s) and ``[lo, hi]`` the bracket of
    the first nv where sparse is cheaper: ``[None, None]`` when it never
    is, ``[None, floor]`` when it already is at the range floor."""
    lo_k = int(np.log2(rows[0]["n_per_chip"]))
    hi_k = int(np.log2(rows[-1]["n_per_chip"]))
    model = []
    for k in range(lo_k + 3, hi_k + int(np.log2(shards)) + 1):
        nv = 1 << k
        t_rep = interp(rows, "all_gather_s", nv) \
            + 2.0 * interp(rows, "psum_s", nv)
        t_sp = 3.0 * interp(rows, "all_to_all_s",
                            max(int(ghost_frac * nv), 1))
        model.append((nv, t_rep, t_sp))
    first_win = next((i for i, (_, tr, ts) in enumerate(model) if ts < tr),
                     None)
    if first_win is None:
        return model, [None, None]
    if first_win == 0:
        return model, [None, model[0][0]]
    return model, [model[first_win - 1][0], model[first_win][0]]


def flat_verdict(args, rows, platform: str, shards: int, note: str) -> int:
    """Print the model, the launch latencies and the bracket; emit the
    verdict (the reference's keys)."""
    lat = {k: rows[0][k] for k in FLAT_KEYS}
    model, (lo, hi) = crossover(rows, shards, args.ghost_frac)
    print(f"# modeled per-iteration exchange transport "
          f"(ghost_frac={args.ghost_frac}):")
    print(f"# {'nv_total':>12} {'replicated':>12} {'sparse':>12}")
    for nv, t_rep, t_sp in model:
        print(f"  {nv:>12} {t_rep:>12.3e} {t_sp:>12.3e}")
    verdict = {
        "platform": platform, "devices": shards,
        "ghost_frac": args.ghost_frac,
        "launch_latency_s": lat,
        "crossover_bracket_nv": [lo, hi],
        "note": ("transport-only model; launch latencies from the "
                 f"smallest measured size; the bytes moved by {note}"),
    }
    print(f"# launch latency (smallest size): "
          f"all_gather {lat['all_gather_s']*1e6:.0f}us, "
          f"psum {lat['psum_s']*1e6:.0f}us, "
          f"all_to_all {lat['all_to_all_s']*1e6:.0f}us")
    if lo is None and hi is None:
        print("# crossover: NOT reached -- the 3 replicated launches stay "
              "cheaper over the whole modeled range; the cutover remains "
              "the MEMORY bound (driver.AUTO_SPARSE_MIN_VERTICES)")
    elif lo is None:
        print(f"# crossover: at or below nv={hi} (sparse transport already "
              f"cheaper at the range floor) -- the collective model does "
              f"NOT bind the cutover; the memory bound does")
    else:
        print(f"# crossover bracket: nv in [{lo}, {hi}]")
    _emit(verdict, args)
    return 0


def _header(what: str, repeats: int) -> None:
    print(f"# mesh: {what}; per-shard elements n; times are "
          f"min-of-{repeats} wall seconds", flush=True)


def _two_axis(args, shape, devs, platform: str, where: str) -> int:
    """The per-axis ladder on the hybrid (dcn, ici) mesh: the ICI-group
    collectives that build the two-level exchange's group tables against
    the DCN-column all_to_all that moves its ghosts, and the global
    gather the scheme exists to avoid."""
    from cuvite_tpu_torch.comm.collectives import all_gather, all_to_all, psum
    from cuvite_tpu_torch.comm.mesh import make_hybrid_mesh

    n_dcn, n_ici = shape
    S = n_dcn * n_ici
    mesh = make_hybrid_mesh(n_dcn, n_ici, devices=devs)
    timed = _timer(mesh.devices, args.repeats)

    def per_view(views, fn, xs):
        def run():
            for view, pos in views:
                fn([xs[p] for p in pos], view)
        return run

    rows = []
    _header(f"{n_dcn}x{n_ici} {platform} (dcn x ici)", args.repeats)
    keys = ("all_gather_ici_s", "psum_ici_s", "all_gather_global_s",
            "all_to_all_dcn_s")
    print(f"# {'n/chip':>10} {'ag(ici)':>12} {'psum(ici)':>12} "
          f"{'ag(global)':>12} {'a2a(dcn)':>12}")
    for k in range(args.min_log2, args.max_log2 + 1):
        n = 1 << k
        xs = [torch.ones(n, dtype=torch.float32, device=d)
              for d in mesh.devices]
        t_agi = timed(per_view(mesh.ici_views, all_gather, xs))
        t_psi = timed(per_view(mesh.ici_views, psum, xs))
        t_agg = timed(lambda: all_gather(xs, mesh))
        b = max(n // n_dcn, 1)
        ys = [torch.ones((n_dcn, b), dtype=torch.float32, device=d)
              for d in mesh.devices]
        t_aad = timed(per_view(mesh.dcn_views, all_to_all, ys))
        del xs, ys
        rows.append({"n_per_chip": n, "all_gather_ici_s": t_agi,
                     "psum_ici_s": t_psi, "all_gather_global_s": t_agg,
                     "all_to_all_dcn_s": t_aad})
        _print_rows(rows[-1:], keys)

    lat = {k: rows[0][k] for k in keys}
    print(f"# per-axis launch latency (smallest size): "
          f"ag(ici) {lat['all_gather_ici_s']*1e6:.0f}us, "
          f"psum(ici) {lat['psum_ici_s']*1e6:.0f}us, "
          f"ag(global) {lat['all_gather_global_s']*1e6:.0f}us, "
          f"a2a(dcn) {lat['all_to_all_dcn_s']*1e6:.0f}us")
    # The two-level transport a sweep at the largest measured count: 2
    # ICI gathers build the group tables (comm and vdeg at the nv/|dcn|
    # window) + 3 DCN all_to_alls move the ghosts (~ghost_frac of the
    # window); the flat alternative pays the global gather + 2 global
    # psums at the full nv window.
    last = rows[-1]
    t_two = (2.0 * last["all_gather_ici_s"]
             + 3.0 * last["all_to_all_dcn_s"] * args.ghost_frac)
    t_flat = (last["all_gather_global_s"] + 2.0 * last["psum_ici_s"]
              * n_dcn)
    print(f"# modeled per-iteration transport at n/chip="
          f"{last['n_per_chip']} (ghost_frac={args.ghost_frac}): "
          f"two-level {t_two:.3e}s vs flat-replicated {t_flat:.3e}s")
    verdict = {
        "platform": platform, "mesh": f"{n_dcn}x{n_ici}", "devices": S,
        "ghost_frac": args.ghost_frac,
        "launch_latency_s": lat,
        "rows": rows,
        "modeled_iteration_s": {"twolevel": t_two,
                                "flat_replicated": t_flat},
        "note": ("per-axis collective ladder on the hybrid mesh; both axes "
                 f"move their bytes by {where}, so the split shows the "
                 "harness, not two fabrics"),
    }
    _emit(verdict, args)
    return 0


def rank_worker(args) -> int:
    """One rank of ``--world``: join the group, run the flat ladder over a
    mesh of one shard a rank, and print the rows on rank 0 (each time
    the slowest rank's minimum)."""
    from cuvite_tpu_torch.comm import multihost
    from cuvite_tpu_torch.comm.mesh import make_mesh

    multihost.initialize(device=args.device)
    with multihost.fail_together():
        mesh = make_mesh(multihost.world_size())
        rows = flat_rows(mesh, args, barrier=multihost.barrier)
        for r in rows:
            for k in FLAT_KEYS:
                r[k] = float(multihost.allreduce_max_host(
                    np.array([r[k]]))[0])
        dev = multihost.local_device()
        name = ("cpu" if dev.type == "cpu"
                else torch.cuda.get_device_name(dev))
        if multihost.rank() == 0:
            print(json.dumps({"rows": rows, "device": name}), flush=True)
        del mesh
    multihost.shutdown()
    return 0


def _world(args) -> int:
    """``--world W``: W ranks of one world through
    ``comm.multihost.launch``, then the verdict from rank 0's rows."""
    from cuvite_tpu_torch.comm import multihost

    W = args.world
    if args.device is None:
        device_or_exit(None)
        if torch.cuda.device_count() < W:
            print(f"# device error: --world {W} needs {W} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
    elif device_or_exit(args.device).type != "cpu":
        print("# --world places one rank a card; give --device only as "
              "'cpu' (gloo ranks)", file=sys.stderr)
        return 2
    argv = [sys.executable, "-m", "cuvite_tpu_torch.tools.exchange_latency",
            "--rank-worker", "--repeats", str(args.repeats),
            "--min-log2", str(args.min_log2),
            "--max-log2", str(args.max_log2)]
    if args.device is not None:
        argv += ["--device", args.device]
    with tempfile.TemporaryDirectory() as tmp:
        outs = multihost.launch(
            argv, W, "file://" + os.path.join(tmp, "store"),
            env=child_env(OMP_NUM_THREADS="1"),
            timeout=world_timeout_s(args),
            cwd=package_root())
    for r, (code, out, err) in enumerate(outs):
        if code:
            print(f"# rank {r} exited {code}: {err[-2000:]}",
                  file=sys.stderr)
            return 1
    got = json.loads(outs[0][1].strip().splitlines()[-1])
    rows = got["rows"]
    cpu = args.device is not None
    platform = "cpu" if cpu else "cuda"
    _header(f"{W}x {platform}, {W} ranks ({got['device']})", args.repeats)
    print(f"# {'n/chip':>10} {'all_gather':>12} {'psum':>12} "
          f"{'all_to_all':>12}")
    _print_rows(rows, FLAT_KEYS)
    where = (f"gloo between {W} CPU processes" if cpu else
             f"NCCL between {W} ranks, one a card ({got['device']}): the "
             "cards' links")
    return flat_verdict(args, rows, platform, W, where)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.rank_worker:
        return rank_worker(args)
    if args.world is not None:
        if args.mesh:
            print("# --world and --mesh are exclusive", file=sys.stderr)
            return 2
        return _world(args)
    shape = None
    if args.mesh:
        d_s, _, i_s = args.mesh.lower().replace("×", "x").partition("x")
        try:
            shape = (int(d_s), int(i_s or 1))
        except ValueError:
            raise SystemExit(f"--mesh must be DCNxICI (e.g. 2x4), "
                             f"got {args.mesh!r}")
        if shape[0] < 1 or shape[1] < 1:
            raise SystemExit("--mesh factors must be >= 1")
        args.devices = shape[0] * shape[1]
    S = args.devices
    devs, where = shard_devices(args.device, S)
    platform = devs[0].type
    if shape is not None:
        return _two_axis(args, shape, devs, platform, where)

    from cuvite_tpu_torch.comm.mesh import make_mesh

    mesh = make_mesh(devices=devs)
    _header(f"{S}x {platform}", args.repeats)
    print(f"# {'n/chip':>10} {'all_gather':>12} {'psum':>12} "
          f"{'all_to_all':>12}")
    rows = flat_rows(mesh, args, echo=True)
    return flat_verdict(args, rows, platform, S, where)


if __name__ == "__main__":
    sys.exit(main())
