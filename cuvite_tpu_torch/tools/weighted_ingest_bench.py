"""Weighted edge list to CSR at benchmark scale (port of the reference's
``tools/weighted_ingest_bench.py``).

Generates a weighted R-MAT edge list with the native generator
(``native.rmat_edges``; the reference's weight formula), builds it with
``Graph.from_edges(..., weights=w, symmetrize=True)`` and reports which
builder the port's own dispatch chose (``w32``, the int32-index-payload
radix of ``native.build_csr_w``, or ``generic``, read from the native
call counts), ``nv``, ``ne``, the weight dtype, the generation and build
seconds and the process's peak resident set (``VmHWM``).  The build
runs on the host; the CSR is then placed on the device
(``utils.upload.to_device``, ended by a synchronize) and that upload is
timed too.

    python -m cuvite_tpu_torch.tools.weighted_ingest_bench [scale] [ef]
    python -m cuvite_tpu_torch.tools.weighted_ingest_bench 12 --device cpu \\
        --log ingest.log

Defaults: scale 25, edge factor 16.  ``--log FILE`` appends the line to
FILE; nothing is written otherwise.  The last line printed is one JSON
object of every figure.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from cuvite_tpu_torch.tools import device_or_exit
from cuvite_tpu_torch.utils.trace import rss_high_water_mb


def weighted_rmat(scale: int, ef: int):
    """(nv, src, dst, w): R-MAT ``scale`` with ``ef * 2^scale`` edges
    (seed 1, Graph500 a/b/c) and deterministic synthetic weights (the
    R-MAT family is unweighted; the weights exercise the weighted
    coalesce)."""
    from cuvite_tpu_torch import native

    nv = 1 << scale
    src, dst = native.rmat_edges(scale, ef * nv, 1, 0.57, 0.19, 0.19)
    w = ((src ^ dst) % 97).astype(np.float64) / 13.0 + 0.5
    return nv, src, dst, w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuvite_tpu_torch.tools.weighted_ingest_bench",
        description="weighted R-MAT edge list -> CSR ingest")
    ap.add_argument("scale", nargs="?", type=int, default=25)
    ap.add_argument("edge_factor", nargs="?", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="where the CSR is placed: the CUDA card by "
                         "default (no card: exit 2), or 'cpu'")
    ap.add_argument("--log", default=None, metavar="FILE",
                    help="append the result line to FILE")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)
    from cuvite_tpu_torch import native
    from cuvite_tpu_torch.core.graph import Graph
    from cuvite_tpu_torch.utils.upload import finish_uploads, to_device

    scale, ef = args.scale, args.edge_factor
    t0 = time.perf_counter()
    nv, src, dst, w = weighted_rmat(scale, ef)
    gen_s = time.perf_counter() - t0
    gen_hwm = int(rss_high_water_mb())

    native.zero_call_counts()
    t1 = time.perf_counter()
    g = Graph.from_edges(nv, src, dst, weights=w, symmetrize=True)
    build_s = time.perf_counter() - t1
    calls = native.call_counts()
    path = "w32" if calls["build_csr_w"] else "generic"

    t2 = time.perf_counter()
    placed = [to_device(a, device=dev) for a in (g.offsets, g.tails,
                                                 g.weights)]
    finish_uploads(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    upload_s = time.perf_counter() - t2
    del placed
    line = (f"weighted scale-{scale} ef={ef}: gen {gen_s:.0f}s "
            f"(hwm {gen_hwm} MB), from_edges {build_s:.0f}s "
            f"path={path}, "
            f"nv={g.num_vertices} ne={g.num_edges} "
            f"wdtype={g.weights.dtype} "
            f"total_hwm={int(rss_high_water_mb())} MB")
    print(line)
    if args.log:
        with open(args.log, "a") as f:
            f.write(line + "\n")
    print(json.dumps({
        "scale": scale, "edge_factor": ef, "path": path,
        "nv": int(g.num_vertices), "ne": int(g.num_edges),
        "wdtype": str(g.weights.dtype), "gen_s": gen_s,
        "build_s": build_s, "upload_s": upload_s,
        "device": (torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu"),
        "gen_hwm_mib": gen_hwm, "total_hwm_mib": int(rss_high_water_mb()),
        "native_calls": {k: v for k, v in calls.items() if v}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
