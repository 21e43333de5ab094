#!/usr/bin/env python3
"""Chip smoke test: cuvite_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py [--scale 20] [--check-scale 14]

Run from the root of a checkout on a machine with an NVIDIA H100.  It
imports nothing of JAX or of cuvite_tpu, catches no failure, and exits
non-zero (printing no result) on any mismatch, on a machine without CUDA,
or without the cuvite_tpu_torch package beside it.  Phases:

1. card: the card's name and power limit; build the CUDA kernels (one
   nvcc per source, in parallel) and print the build seconds;
2. the row-argmax kernel against its plain twin at every DEFAULT_BUCKETS
   width (8 ... 8192): integer and dyadic weights, zero-weight and padding
   slots, ties, all-padding and no-candidate rows -- outputs bit-equal;
3. the heavy kernel against its twin on seeded hubs of degree 9,000 ...
   65,536 over 2^20 communities -- bit-equal;
4. louvain_phases on R-MAT --check-scale on the card and on the CPU (the
   twins): identical labels, phases and iterations, Q to 1e-9;
5. the main path: louvain_phases on R-MAT --scale on the card, with the
   kernels' launch counts set to 0 just before and read just after; per
   phase nv, ne, iterations, Q and seconds; fails if a kernel never
   launched or the reported Q is more than 1e-6 from the host f64
   modularity of the returned labels;
6. each kernel timed with CUDA events at the phase-0 shapes of that graph
   (the row kernel also width by width), beside its twin and its bound
   from the real rows and edges, printed as one JSON line.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
SLEEP_CYCLES = 20_000_000  # ~10 ms of sleep kernel ahead of each timing
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                         timeout=60)
    if out.returncode:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bits_equal(a, b) -> bool:
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def max_abs_err(got, ref) -> float:
    """Largest |kernel - twin| over (best_c, best_gain, counter0); -inf
    against -inf counts as 0."""
    import torch

    err = 0.0
    for g, r in zip(got, ref):
        g, r = g.cpu().double(), r.cpu().double()
        same = g == r
        d = torch.where(same, torch.zeros_like(g), (g - r).abs())
        if d.numel():
            err = max(err, float(d.max()))
    return err


def time_ms(fn, repeats: int) -> float:
    """Median milliseconds of ``fn`` over ``repeats`` CUDA-event timings,
    after one warm-up call.  A sleep kernel ahead of each timing keeps the
    stream busy while the host enqueues ``fn``, so host time between its
    launches is not counted (unless ``fn`` itself waits on the device)."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phase 2: the row kernel at every width.


def row_case(width: int, seed: int, dev):
    """Bucket rows of one width over a 2^16-vertex table.  Row degrees are
    random in [1, width]; padding slots point at the row's own vertex with
    w = 0.  Communities come from a pool of ~width/2 ids, so rows hold
    duplicates and equal-gain candidates.  Rows 0-3 are no-candidate rows
    (every neighbour in the current community), the last 4 rows are
    padding rows."""
    import torch

    rng = np.random.default_rng(seed)
    nv = 1 << 16
    n_rows = max(64, min(4096, (1 << 21) // width))
    pool = max(width // 2, 4)
    comm = rng.integers(0, pool, nv).astype(np.int32)
    comm_deg = np.zeros(nv, dtype=np.float32)
    comm_deg[:pool] = rng.integers(1, 64, pool)
    vdeg = rng.integers(0, 32, nv).astype(np.float32)
    verts = rng.choice(nv, n_rows, replace=False).astype(np.int32)
    deg = rng.integers(1, width + 1, n_rows)
    dst = rng.integers(0, nv, (n_rows, width)).astype(np.int32)
    slot = np.arange(width)[None, :]
    dst = np.where(slot < deg[:, None], dst, verts[:, None]).astype(np.int32)
    w = (rng.integers(0, 5, (n_rows, width)) * 0.25).astype(np.float32)
    w[slot >= deg[:, None]] = 0.0
    same = np.nonzero(comm == comm[verts[0]])[0]
    for r in range(4):   # no-candidate rows
        comm[verts[r]] = comm[verts[0]]
        dst[r] = rng.choice(same, width)
    self_loop = (rng.integers(0, 2, nv) * 0.5).astype(np.float32)
    verts[-4:] = nv
    t = [torch.from_numpy(a).to(dev) for a in
         (dst, w, verts, comm, comm_deg, vdeg, self_loop)]
    return t, float(np.float32(1.0 / 123457.0))


def check_rows(dev) -> None:
    from cuvite_tpu_torch.kernels.row_argmax import (
        row_argmax,
        row_argmax_plain,
    )
    from cuvite_tpu_torch.louvain.bucketed import DEFAULT_BUCKETS

    for width in DEFAULT_BUCKETS:
        args, const = row_case(width, width, dev)
        got = row_argmax(*args, const)
        ref = row_argmax_plain(*args, const)
        for name, g, r in zip(("best_c", "best_gain", "counter0"), got, ref):
            if not bits_equal(g, r):
                fail(f"row_argmax width {width}: {name} differs from the "
                     f"twin (max abs err {max_abs_err(got, ref)})")
        n_none = int((got[0].cpu() == 2**31 - 1).sum())
        if n_none < 4:
            fail(f"row_argmax width {width}: the no-candidate rows found "
                 "a candidate")
        print(f"  row_argmax width {width:5d}: {args[0].shape[0]} rows "
              f"bit-equal to the twin ({n_none} without a candidate)")


# ---------------------------------------------------------------------------
# Phase 3: the heavy kernel.


def heavy_case(seed: int, dev):
    import torch

    from cuvite_tpu_torch.kernels.heavy_bincount import build_heavy_layout

    rng = np.random.default_rng(seed)
    n_comm = 1 << 20
    n_hubs = 48
    nv = n_comm + n_hubs
    # Skewed community ids: small ids repeat, so hubs see duplicates.
    comm = (n_comm * rng.random(nv) ** 3).astype(np.int32)
    deg = rng.integers(9000, 65537, n_hubs)
    hubs = n_comm + np.arange(n_hubs)
    src = np.repeat(hubs, deg)
    dst = rng.integers(0, n_comm, len(src))
    w = rng.integers(0, 4, len(src)).astype(np.float32)
    first = np.concatenate([[0], np.cumsum(deg)[:-1]])
    # Hub 0: every neighbour in its own community (no candidate).
    comm[hubs[0]] = comm[dst[0]]
    dst[: deg[0]] = dst[0]
    # Hub 1: its only candidates are reached by zero-weight edges.
    comm[hubs[1]] = comm[dst[first[1]]]
    others = slice(first[1] + 1, first[1] + deg[1])
    w[others] = np.where(comm[dst[others]] == comm[hubs[1]], w[others], 0.0)
    comm_deg = np.zeros(n_comm, dtype=np.float32)
    np.add.at(comm_deg, comm, rng.integers(1, 200, nv).astype(np.float32))
    vdeg = np.zeros(nv, dtype=np.float32)
    vdeg[hubs] = deg
    self_loop = np.zeros(nv, dtype=np.float32)
    self_loop[hubs] = rng.integers(0, 3, n_hubs)
    lay = build_heavy_layout(src, dst, w, nv_local=nv).to(dev)
    tabs = [torch.from_numpy(a).to(dev)
            for a in (comm, comm_deg, vdeg, self_loop)]
    return lay, tabs, float(np.float32(1.0 / 987653.0))


def check_heavy(dev) -> None:
    from cuvite_tpu_torch.kernels.heavy_bincount import (
        heavy_argmax,
        heavy_argmax_plain,
    )

    lay, tabs, const = heavy_case(11, dev)
    got = heavy_argmax(lay, *tabs, const)
    ref = heavy_argmax_plain(lay, *tabs, const)
    for name, g, r in zip(("best_c", "best_gain", "counter0"), got, ref):
        if not bits_equal(g, r):
            fail(f"heavy_argmax: {name} differs from the twin (max abs err "
                 f"{max_abs_err(got, ref)})")
    bc = got[0].cpu()
    if int(bc[0]) != 2**31 - 1 or int(bc[1]) == 2**31 - 1:
        fail("heavy_argmax: the no-candidate / zero-weight hubs are wrong")
    print(f"  heavy_argmax: {lay.num_hubs} hubs, {lay.dst.numel()} edges "
          "bit-equal to the twin")


# ---------------------------------------------------------------------------
# Phases 4-6.


def check_card_vs_cpu(scale: int) -> None:
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rmat

    g = generate_rmat(scale)
    rg = louvain_phases(g, device="cuda")
    rc = louvain_phases(g, device="cpu")
    if not np.array_equal(rg.communities, rc.communities):
        fail(f"R-MAT {scale}: card and CPU labels differ")
    if [p.iterations for p in rg.phases] != [p.iterations for p in rc.phases]:
        fail(f"R-MAT {scale}: phases/iterations differ: "
             f"{[p.iterations for p in rg.phases]} vs "
             f"{[p.iterations for p in rc.phases]}")
    if abs(rg.modularity - rc.modularity) > 1e-9:
        fail(f"R-MAT {scale}: Q {rg.modularity} vs {rc.modularity}")
    print(f"  R-MAT {scale}: {len(rg.phases)} phases, "
          f"{rg.total_iterations} iterations, Q {rg.modularity:.9f} on card "
          "and CPU, labels identical")


def run_main_path(g, scale: int) -> dict:
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.evaluate.modularity import modularity
    from cuvite_tpu_torch.kernels.heavy_bincount import heavy_argmax
    from cuvite_tpu_torch.kernels.row_argmax import row_argmax

    torch.cuda.reset_peak_memory_stats()
    row_argmax.launches = 0
    heavy_argmax.launches = 0
    t0 = time.perf_counter()
    res = louvain_phases(g)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"row_argmax": row_argmax.launches,
                "heavy_bincount": heavy_argmax.launches}
    for p in res.phases:
        st = " ".join(f"{k} {v:.3f}" for k, v in p.stages.items())
        print(f"  phase {p.phase}: nv {p.num_vertices} ne {p.num_edges} "
              f"iterations {p.iterations} Q {p.modularity:.9f} "
              f"seconds {p.seconds:.3f} (host stages, s: {st})")
    sweeps = res.total_iterations
    print(f"  R-MAT {scale}: total {total_s:.3f} s, {sweeps} sweeps, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
          f"launches {launches} "
          f"({launches['row_argmax'] / max(sweeps, 1):.2f} row and "
          f"{launches['heavy_bincount'] / max(sweeps, 1):.2f} heavy "
          "launches per sweep)")
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} never launched on the main path")
    q_host = modularity(g, res.communities)
    if abs(q_host - res.modularity) > 1e-6:
        fail(f"reported Q {res.modularity} vs host f64 {q_host}")
    print(f"  reported Q {res.modularity:.9f}, host f64 Q {q_host:.9f}")
    return launches


# Bounds count the bytes the function must move on this run's data: each
# input read once, each output written once.  Padding is not work: the
# row kernel's bound counts the real slots of each bucket (the degrees of
# its vertices, 8 B of dst and w each) and its real rows (4 B of vertex id,
# 12 B of outputs), and the four per-vertex tables (comm, comm_deg, vdeg,
# self_loop) once.  The comm[dst] and comm_deg[c] gathers read those
# tables, which fit in L2, so they add no bytes here;
# ``bytes_with_gathers`` adds 4 B per slot or edge for a comm gather that
# misses L2.  Operations are counted as 8 f32 operations per real slot or
# heavy edge, an upper bound: one compare and one add per slot, and at most
# one 7-operation gain (plus its compare) per distinct community.
def bound(n_bytes: int, ops: int) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bucket_work(plan, deg: np.ndarray, nv: int) -> list:
    """(width, padded rows, real rows, real slots) of each bucket."""
    out = []
    for verts, dst, _ in plan.buckets:
        v = verts.cpu().numpy()
        v = v[v < nv]
        out.append((dst.shape[1], dst.shape[0], len(v), int(deg[v].sum())))
    return out


def time_kernels(g, launches: dict) -> list:
    """Kernel vs twin at the phase-0 shapes of ``g`` (identity
    assignment), with bounds from this graph's bytes and operations."""
    import torch

    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.kernels.heavy_bincount import (
        heavy_argmax,
        heavy_argmax_plain,
    )
    from cuvite_tpu_torch.kernels.row_argmax import (
        row_argmax,
        row_argmax_plain,
    )
    from cuvite_tpu_torch.louvain.driver import PhaseRunner
    from cuvite_tpu_torch.ops.segment import segment_sum

    run = PhaseRunner(DistGraph.build(g), "cuda")
    plan, comm, vdeg = run.plan, run.comm0, run.vdeg
    nv = run.nv_total
    const = float(np.float32(run.constant))
    comm_deg = segment_sum(vdeg.double(), comm, nv).float()
    tables = (comm, comm_deg, vdeg, plan.self_loop)
    table_bytes = 4 * 4 * nv
    deg = np.zeros(nv, dtype=np.int64)
    deg[: g.num_vertices] = g.degrees()

    def rows(fn, buckets=plan.buckets):
        return [fn(d, w, v, comm, comm_deg, vdeg, plan.self_loop, const)
                for v, d, w in buckets]

    # One whole sweep (kernels and the torch ops around them) on the
    # device stream: with the sweep count, an upper bound on the run's
    # device-busy time.
    sweep_ms = time_ms(lambda: run.step(comm), 10)
    print(f"  one phase-0 sweep: {sweep_ms:.4f} ms on the device stream")
    got, ref = rows(row_argmax), rows(row_argmax_plain)
    row_err = max(max_abs_err(a, b) for a, b in zip(got, ref))
    work = bucket_work(plan, deg, nv)
    per_width = []
    for b, (width, n_rows, real_rows, slots) in zip(plan.buckets, work):
        b_ms, _ = bound(slots * 8 + real_rows * 16, 8 * slots)
        per_width.append({
            "width": width, "rows": n_rows, "real_rows": real_rows,
            "real_slots": slots, "ms": time_ms(lambda: rows(row_argmax, [b]),
                                               20),
            "bound_ms": b_ms})
    slots = sum(w[3] for w in work)
    real_rows = sum(w[2] for w in work)
    row_bytes = slots * 8 + real_rows * 16 + table_bytes
    row = {
        "name": "row_argmax", "route": "cuda",
        "source": "cuvite_tpu_torch/kernels/csrc/row_argmax.cu",
        "replaces": "cuvite_tpu/kernels/row_argmax.py:166",
        "tpu_function": "cuvite_tpu/kernels/row_argmax.py:row_argmax_pallas",
        "launches": launches["row_argmax"], "max_abs_err": row_err,
        "ms": time_ms(lambda: rows(row_argmax), 20),
        "plain_ms": time_ms(lambda: rows(row_argmax_plain), 3),
        "bytes": row_bytes, "bytes_with_gathers": row_bytes + 4 * slots,
        "ops": 8 * slots, "real_rows": real_rows, "real_slots": slots,
        "padded_slots": sum(d.numel() for _, d, _ in plan.buckets),
        "per_width": per_width,
    }
    lay = plan.heavy
    hub = {
        "name": "heavy_bincount", "route": "cuda",
        "source": "cuvite_tpu_torch/kernels/csrc/heavy_bincount.cu",
        "replaces": "cuvite_tpu/kernels/heavy_bincount.py:200",
        "tpu_function":
            "cuvite_tpu/kernels/heavy_bincount.py:heavy_argmax_pallas",
        "launches": launches["heavy_bincount"],
    }
    if lay is None:
        fail("the phase-0 graph has no hub: the heavy kernel is untimed")
    hg = heavy_argmax(lay, *tables, const)
    hr = heavy_argmax_plain(lay, *tables, const)
    e = lay.dst.numel()
    # Per edge dst + w; per hub its id, two int64 offsets of each kind and
    # three outputs.
    hub_bytes = e * 8 + lay.num_hubs * (4 + 16 + 16 + 12) + table_bytes
    hub.update({
        "max_abs_err": max_abs_err(hg, hr),
        "ms": time_ms(lambda: heavy_argmax(lay, *tables, const), 20),
        "plain_ms": time_ms(
            lambda: heavy_argmax_plain(lay, *tables, const), 3),
        "bytes": hub_bytes, "bytes_with_gathers": hub_bytes + 4 * e,
        "ops": 8 * e, "hubs": lay.num_hubs, "edges": e,
    })
    out = []
    for k in (row, hub):
        if k["max_abs_err"] != 0.0:
            fail(f"{k['name']} differs from its twin at the main-path "
                 f"shapes (max abs err {k['max_abs_err']})")
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k["ops"])
        k["bound_ms_with_gathers"], _ = bound(k["bytes_with_gathers"],
                                              k["ops"])
        k["library_ms"] = None   # no single PyTorch call computes it
        k["kernel_ms"] = k["ms"]
        out.append(k)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="R-MAT scale of the main-path run")
    ap.add_argument("--check-scale", type=int, default=14,
                    help="R-MAT scale of the card-vs-CPU run")
    args = ap.parse_args()

    # The run uses one card: show torch only that one, so the device count
    # on the last line is the count the run used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = \
        "0" if visible is None else visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from cuvite_tpu_torch.kernels import _build
        from cuvite_tpu_torch.io.generate import generate_rmat
    except ImportError as err:
        fail(f"cuvite_tpu_torch is not beside this script ({err})")
    dev = torch.device("cuda")

    print("[1] card")
    print(f"  {smi_line()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build_s = _build.build()
    print(f"  kernels built in {build_s:.2f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    print("[2] row_argmax kernel against its twin, every bucket width")
    check_rows(dev)
    print("[3] heavy_bincount kernel against its twin")
    check_heavy(dev)
    torch.cuda.synchronize()

    print(f"[4] R-MAT {args.check_scale}: card against CPU")
    check_card_vs_cpu(args.check_scale)

    print(f"[5] main path: louvain_phases on R-MAT {args.scale}")
    t0 = time.perf_counter()
    g = generate_rmat(args.scale)
    print(f"  generated {g.num_vertices} vertices, {g.num_edges} directed "
          f"edges, max degree {int(g.degrees().max())} in "
          f"{time.perf_counter() - t0:.2f} s")
    launches = run_main_path(g, args.scale)

    print(f"[6] kernels at the R-MAT {args.scale} phase-0 shapes")
    kernels = time_kernels(g, launches)
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.4f} ms (twin {k['plain_ms']:.4f} "
              f"ms, bound {k['bound_ms']:.4f} ms by {k['bound_by']})")
        for p in k.get("per_width", []):
            print(f"    width {p['width']:5d}: {p['real_rows']} of "
                  f"{p['rows']} rows real, {p['real_slots']} slots, "
                  f"{p['ms']:.4f} ms, bound {p['bound_ms']:.4f} ms")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
