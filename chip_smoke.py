#!/usr/bin/env python3
"""Chip smoke test: cuvite_tpu_torch's main paths on one CUDA card.

    python3 chip_smoke.py [--scale 20] [--check-scale 14]
                          [--rgg-nv 4194304] [--rgg-check-nv 65536]
                          [--fused-check-scale 12] [--fused-shrink 4096]
                          [--schedule-scale 20] [--native-rmat-scale 18]
    python3 chip_smoke.py --only-multiprocess    # phases 1, 30, 35's
                                                 # colored run, 36's 2x2
                                                 # run, 33, 34 (and 36's
                                                 # batch and 38's ladder
                                                 # over the cards)

Run from the root of a checkout on a machine with an NVIDIA H100.  It
imports nothing of JAX or of cuvite_tpu, catches no failure, and exits
non-zero (printing no result) on any mismatch, on a machine without CUDA,
or without the cuvite_tpu_torch package beside it.  Phases:

1. card: the card's name and power limit; build the CUDA kernels (one
   nvcc per source, in parallel) and the native host runtime (g++) and
   print both build seconds, the library's OpenMP threads and
   os.cpu_count();
2. the row-argmax kernel against its plain twin at every DEFAULT_BUCKETS
   width (8 ... 8192): integer and dyadic weights, zero-weight and padding
   slots, ties, all-padding and no-candidate rows, each with and without
   the per-row degrees (rows shorter than their class); rows whose real
   slots all fall in one or two communities; a tie at gain zero between
   two candidates, which the smaller id wins -- outputs bit-equal;
3. the heavy kernel against its twin on seeded hubs of degree 9,000 ...
   65,536 over 2^20 communities, on hubs whose edges all reach one or two
   communities, on a hub of 2^18 edges (64 chunks) and on a tie at gain
   zero -- bit-equal, twice in a row, the scratch left clean;
4. louvain_phases on R-MAT --check-scale on the card and on the CPU (the
   twins): identical labels, phases and iterations, Q to 1e-9;
5. the main path: louvain_phases on R-MAT --scale on the card, with the
   kernels' launch counts set to 0 just before and read just after (the
   native host runtime's call counts set to 0 before the graph's
   generation); per phase nv, ne, iterations, Q and seconds, and the
   plan and coarsen seconds over the phases; fails if a kernel never
   launched, if build_csr_unit, plan_scan, bucket_fill or coarsen_csr
   was never called, or if the reported Q is more than 1e-6 from the
   host f64 modularity of the returned labels;
6. the row and heavy kernels timed with CUDA events at the phase-0 shapes
   of that graph (the row kernel also width by width), at the identity
   assignment and at the converged phase-0 assignment, beside their twins
   and bounds from the real rows and edges; fails if a padding row reaches
   the row kernel (real rows must equal launched rows in every class);
7. the seg_coalesce pipeline against its twin at nv_pad 64, 1024 and
   4096, dyadic and RGG-like float weights, duplicates, heavy self-loop
   runs, zero-weight rows, gapped ids and padding rows, each coalesced slab
   bit-equal to the twin's and to the sort engine's; a slab whose real
   rows all share one src at nv_pad 4096, 16384 and 32768 (a block's
   dense row in shared memory, in 1, 2 and 4 dst tiles); four tenants
   whose buckets hold ~800 to ~3,300 rows; a 300-row run of weight 0,
   three tenants of 16,461 rows, a pure-padding slab and an empty one; then the whole coalesce, one slab and a batch, under
   torch.cuda.set_sync_debug_mode("error") (no host sync);
8. louvain_phases(engine="sort") on RGG --rgg-check-nv on the card and on
   the CPU: identical labels, phases and iterations, Q to 1e-9, and at
   least one dense coarsening;
9. the sort path: louvain_phases(engine="sort") on RGG --rgg-nv, with the
   kernels' launch counts set to 0 just before and read just after; per
   phase nv, ne, iterations, Q, seconds, coalesce engine and coarsen
   seconds; fails if seg_coalesce never launched, if the reported Q is
   more than 1e-6 from the host f64 modularity of the labels, or if a
   dense coarsening's rows differ from the sort engine's on the same
   relabeled slab (src, dst, count exact; weights at most one f32 ulp);
   then one phase-0 sort sweep timed on the device stream;
10. the whole seg_coalesce timed at the first dense coarsening of that
   run, bit-equal to its twin, beside the twin, the sort engine on the
   same slab and its bound (the real rows read, the coalesced slab
   written: no key grid), with the bytes it allocates; then both engines
   on the run's narrowest sort coarsening, the class above the dense
   engine's cap, admitted with CUVITE_SEG_COALESCE_MAX_NV;
11. louvain_phases(engine="fused") on R-MAT --fused-check-scale and RGG
   --rgg-check-nv, on the card and on the CPU, with FUSED_SHRINK_EDGES
   lowered to --fused-shrink so one-phase calls and device coarsenings,
   dense ones included, run: identical labels, phases and iterations, Q
   to 1e-9; fails if seg_coalesce never launched on the card;
12. the fused path: louvain_phases(engine="fused") on RGG --rgg-nv and
   R-MAT --scale with the default FUSED_SHRINK_EDGES and the launch counts
   set to 0 just before; per phase nv, ne, iterations, Q, seconds and the
   engine of the device coarsening after it; its wall time beside the
   sort and bucketed engines' on the same graph in this call; fails if
   the reported Q is more than 1e-6 from the host f64 modularity;
13. early termination (et_mode 1-4), coloring=8 and vertex_ordering=8 on
   R-MAT --check-scale, on the card and on the CPU: identical labels,
   phases and iterations, Q to 1e-9; the card's colors equal the CPU's
   with no conflicting edge;
14. et_mode=3 and coloring=8 on R-MAT --schedule-scale with the launch
   counts set to 0 just before each; per run the color and class-plan
   seconds, the sweeps and the convergence rows' summary; fails if the
   row or heavy kernel never launched, or Q is more than 1e-6 from the
   host f64 modularity; then the coloring run's class plans, rebuilt,
   each swept by bucketed_step on the card and by the twins on the CPU
   from the same assignment (the run's first iteration, then one with
   vertex ordering's frozen tables): target and counter0 bit-equal on
   every plan;
15. the batched forms against their twins, bit-equal: the row kernel at
   widths 8 ... 8192 over three folded tenants (seeded, hot-key and
   zero-gain-tie rows, three constants) in one launch per width, the
   heavy kernel over two tenants' hubs (the 2^18-edge hub among them) in
   one launch, twice, scratch clean, and the batched seg_coalesce over
   four tenants (gapped ids, float weights, one pure padding) in one
   launch, bit-equal to the twin, each tenant's rows equal to the sort
   engine's;
16. louvain_many on the reference's job set (two R-MAT 8, two synth
   2048), both engines, card against CPU and each tenant against its own
   B=1 run on the card; louvain_phases (bucketed and fused) on the
   synthesized powerlaw-test graph inside the powerlaw-test/default
   golden envelope, F-score included;
17. serving batches at full size, both engines: B=64 of synth 4096
   (class (4096, 16384)), B=64 of synth 65536 (class (4096, 65536)),
   B=16 of synth 2^20 (class (65536, 2^20)); wall, jobs/s, phases,
   sweeps, engines, launches, peak memory, every tenant's Q within 1e-6
   of the host f64 modularity; the batched seg_coalesce bit-equal to its
   twin at the first coarsening of the B=64 synth 4096 and synth 65536
   batches; the batched row kernel and the whole seg_coalesce timed at
   the B=64 synth 65536 batch's shapes beside twins, bounds and the sort
   engine; both engines on the first (sort) coarsening of B=16 synth
   2^20, the batch above DENSE_BATCH_MAX_SLOTS;
18. device re-binning on the per-graph bucketed driver: R-MAT
   --check-scale and RGG --rgg-check-nv card against CPU and against
   CUVITE_DEVICE_REBIN=0; each one's phase-1 re-binned plan equal to the
   host plan and swept twice on kernels and twins, targets equal, counter0
   bit-equal on R-MAT's integer weights and within the f32 reordering
   bound on RGG's distance weights (the reading printed); RGG --rgg-nv
   (phase 9's graph, kept for phases 18 and 37) with re-binning on and
   off, rebin seconds against the host plan seconds they replace.
19. sub-row packing: 16 synth 1024 tenants, and the seam pair (hub
   communities at ids 4095 and 4096 of one row), packed two to a row of
   class (8192, 32768) and run by cluster_packed on both engines: every
   phase's community ids inside their fences, each tenant's labels equal
   to the CPU run and to its B=1 run on the card;
20. the serving queue: `serve demo --jobs 64 --edges 4096 --b-max 64
   --json` through the CLI's main(argv) on both engines, each tenant's Q,
   communities, phases and iterations equal to louvain_many on the same
   64 jobs (phase 17's batch), and the library LouvainServer's labels
   equal to them bit for bit; jobs/s, waits, pack and exec seconds,
   launches and peak memory; then an overload setting chosen to force
   merges, not the reference's mix: its 90:10 pools (72 synth 1024 : 8
   R-MAT 13 edge factor 2) offered at 2,000 jobs/s (the reference's mix:
   20) with b_max 4, linger 20 ms and a 500 ms SLO on the bucketed engine,
   through run_mixed_open_loop with merge_packing off and on: fails
   unless the merged arm packs a merged batch; every job's labels equal
   across the arms and to its B=1 run;
21. the daemon as a subprocess on the card (`--b-max 16 --fault-plan
   device:transient:n=1`), pipelined and then serial (`--pipeline off`):
   64 synth 4096 jobs over a unix socket, each result's labels equal to
   the direct run, `stats`, then SIGTERM: exit 0, conservation ok, at
   least one retry; overlap_frac, the kernel build and warm-up seconds
   before the readiness line, and the served jobs' launches from the
   `stats` reply (fails if the row kernel or seg_coalesce never ran).
22. the bench on the card through its command line, in subprocesses
   (``python -m cuvite_tpu_torch.workloads bench``): R-MAT BENCH_SCALE
   (18; phase 5 times --scale) alone on the card with 2 timed runs (Q,
   phases and iterations equal to an in-process run of the same graph,
   the first timed run's launches, counted in the child, equal to that
   run's, and its native plan and coarsen calls made with the guard
   held: no build, library load or first kernel-form launch inside it);
   then three concurrent children: B=64 with phase 17's 64 synth 4096
   jobs on both batched engines (a timed pass's launches equal to phase
   17's), and the serving bench at 200 jobs/s (jobs conserved);
   each record valid, with a checked guard, platform cuda and phase 1's
   card and power limit (run_mixed_serve_bench on phase 20's 90:10 pools
   runs once, in phase 38's serve_load mix); then the guard on the
   card: run_bench with its first timed run pointed at an emptied build
   directory must raise BenchCompileGuardError;
23. the command line, as three concurrent children: ``-n 65536 -e 10
   --json --trace-out --metrics-out -s -o`` on the card and with --device
   cpu (JSON equal but for seconds and teps, labels identical, traces
   valid, the metrics file's keys the reference's, g.bin equal to the
   generated graph, Q the host f64 modularity of the labels) and ``serve
   demo --trace-out`` (a valid trace with pack and execute spans); then
   louvain_phases on phase 22's R-MAT BENCH_SCALE graph with a flight
   recorder under torch.cuda.set_sync_debug_mode("warn"): labels equal to
   phase 22's in-process run and no more synchronizing operations than
   without the tracer.
24. streaming, card against CPU: StreamSession on R-MAT --check-scale
   with two churn batches (1% of the pairs each) and a spill batch that
   doubles the slab class: the slab (src, dst, w, ne, ne_pad, 2m,
   fingerprint) bit-equal card vs CPU after every apply_delta, and the
   cold, labels and plp re-clusters identical;
25. streaming at full width on R-MAT --scale, the launch counts set to 0
   just before: from_graph, a cold re-cluster, apply_delta of a 1% churn
   batch under torch.cuda.set_sync_debug_mode("warn") (fails unless it
   makes exactly one host read), a labels re-cluster (fails if its Q
   falls below the cold run's golden envelope), then a plp re-cluster on
   a fresh session with the same delta; walls, frontier_frac, Q, peak
   allocated bytes;
26. ``python -m cuvite_tpu_torch.workloads bench --churn-frac 0.01
   --scale`` BENCH_SCALE (18; phase 25 streams --scale in process) in a
   child on the card: a valid record with a checked guard, phase 1's
   card and power limit, and its stream block;
27. the daemon's ``delta`` verb on the card (``--stream-budget-mb 0.25``,
   one synth 4096 session): an upload, a labels re-cluster equal to an
   in-process session's, a second tenant that evicts the first, a delta
   to the evicted tenant refused, a re-upload; SIGTERM: exit 0, pool
   conservation with 3 admitted and 3 evicted.
28. the row kernel's size form (``row_argmax_sized``, the sparse
   exchange's) against its twin at every DEFAULT_BUCKETS width, with and
   without the row degrees: dyadic weights, padding slots, no-candidate
   rows (sentinel best and size) and a zero-gain tie won by the smaller
   id with its own size -- bit-equal, best_size included; phase 5's
   launches (the non-size forms; 229 row / 14 heavy at R-MAT 20) with no
   size-form launch; then the size form timed at the sparse phase-0
   shapes of R-MAT --scale on 4 shards of one card, every class of every
   shard a sweep, at the identity and the converged assignment,
   bit-equal to its twin there, beside the twin and its bound; and the
   non-size row kernel and the heavy kernel at the replicated phase-0
   shapes of the same mesh (rows and hubs by padded-global id against
   the gathered tables), every class and the hubs of every shard, at
   the identity and the converged assignment, bit-equal to their twins;
29. louvain_phases on R-MAT --check-scale, 4 shards on one card, both
   exchanges: labels, phases and iterations identical to the same mesh
   on the CPU and to one shard on the card, Q to 1e-9;
30. full width: R-MAT --scale on 4 shards of one card under the sparse
   and the replicated exchange, the launch counts set to 0 just before
   each and read just
   after: per phase nv, ne, iterations, Q, seconds and the exchange
   (ghosts per shard, block, budget, the bytes a shard sends a sweep);
   fails if Q is more than 1e-6 from the host f64 modularity, if the
   labels differ from one shard's, or if the sparse run never launched
   the size form; every shard sat on one H100, so no NVLink transfer is
   measured;
31. a per-peer budget of 1 on R-MAT --check-scale, 4 shards on the
   card: the runner's sweeps overflow, the driver re-runs the
   phase with a grown budget, and the labels equal one shard's.
32. the native host runtime against its numpy paths on this host,
   bit-equal, each with both times: R-MAT --native-rmat-scale
   generation; at the R-MAT BENCH_SCALE (18) shapes from_edges (the unit
   builder), weighted degrees, edge-balanced parts, the phase-0 plan
   (plan_scan + bucket_fill) and one coarsening onto phase 22's final
   communities (phase 5 runs the native paths at --scale); at
   the R-MAT --native-rmat-scale shapes the generic and w32 weighted
   builders and a 32-bit Vite write, header and read.
33. one rank per card over torch.distributed: min(visible cards, 4) NCCL
   ranks (a file:// store in a temporary directory; one rank holding all
   4 shards on a one-card host) each generate R-MAT --scale and run it on
   4 shards under the replicated and then the sparse exchange, the
   launch counts zeroed just before each run and read just after; per
   rank the seconds it took to join the group, the wall, the stage
   walls, the launches and the bytes it handed to the collectives (over
   the run and a sweep); fails unless every rank's labels, iterations
   and Q equal phase 30's one-process run of the same exchange and the
   launches summed over the ranks equal its; then each rank times the
   replicated exchange's all-gather of the f64 degree tables and the
   sparse exchange's ghost-pull all_to_all at the phase-0 shapes (CUDA
   events; across cards, the NVLink figure);
34. per-rank ingest: R-MAT --scale written as a 32-bit Vite file in a
   temporary directory; each rank of the same world loads it with
   DistVite, reading only its shards' edge ranges (bytes read printed;
   fewer than the file's on two or more ranks), and runs coloring=8 over
   the sparse exchange (colors from multi_hash_coloring_dist) stopped
   after phase 0 (max_phases=1), then resumed from a checkpoint
   directory the ranks share (rank 0 writes): labels, iterations and Q
   equal to phase 35's one-process colored sparse run, and the two runs'
   launches summed over the ranks equal to its (phase 33 holds the plain
   sparse run over the ranks);
35. (run before 33-34) ET, the color schedules and checkpoints on 4
   shards of one card: et_mode 1-4, coloring=8 and vertex_ordering=8 on
   R-MAT MESH_CHECK_SCALE (12) under both exchanges, card against CPU
   and one shard (the non-size row kernel on the replicated runs, the
   size form on the sparse ones); a checkpointed coloring=8 sparse run
   (max_phases=1, then resume) equal to the uninterrupted one; R-MAT
   CLASS_SWEEP_SCALE's (18) coloring=8 classes, class 0 emptied on shard
   1, each class step of two iterations (refreshed, then frozen tables)
   and the Q pass card against CPU, targets, counter0, overflow and Q
   bit-equal, under both exchanges, with the card steps' launches; R-MAT
   --scale at full width with coloring=8 sparse: per phase the stages,
   the wall beside phase 14's one-shard run, the launches, labels equal
   to phase 14's, Q within 1e-6 of the host f64 modularity.
36. (run after 35, before 33-34) the two-level exchange and the batch
   axis: R-MAT --check-scale on 2x2 and 4x1 hybrid meshes of 4 shards
   on the card, labels, phases, iterations and Q bits equal to the same
   mesh on the CPU, the flat sparse mesh and one shard, the size form
   alone launched; et_mode=3, a checkpoint resume and a budget of 1
   (the runner overflows, the driver retries up to the group window) on
   2x2; the CLI's --mesh 2x2 --json --diag-prefix (its exchange block
   and one line a shard and phase); R-MAT --scale on 2x2 at full width
   as phase 30 (walls, stages, ghosts a group, block, budget, group
   table bytes, launches), equal to phase 30's sparse run and phase 5;
   B=64 synth 65536 on two blocks of the card (make_batch_mesh), both
   engines, every tenant equal to mesh=None and to its block's own
   batch, walls, jobs/s and launches side by side; with two or more
   cards a child with every offered card (up to four) visible runs the
   same batch with mesh="auto" against card 0 alone.  Phase 33's world
   also runs the 2x2 mesh against phase 36's run, and each rank times
   the ICI all-gather and the DCN ghost-pull all_to_all.
37. (run after 36, before 33-34) the last runtime modules: R-MAT
   CONVERT_SCALE (18) written as a SNAP list and converted
   (``workloads.convert``; seconds and MB/s of text), then louvain_phases(engine="pallas") and
   engine="bucketed" on the converted file -- labels, phases, sweeps and
   Q bits equal, Q within 1e-6 of the host f64 Q, the coverage and the
   traversed edges by width printed, fails unless the row and heavy
   kernels launched; R-MAT --check-scale as Matrix Market and METIS, each
   converted at two chunk sizes (byte-equal, the graph's CSR) and run
   with engine="pallas" on the card and the CPU (equal); the sort path on
   RGG --rgg-nv (phase 9's graph) under CUVITE_SEG_COALESCE=msd and
   =hash, labels, phases, sweeps and Q bits equal to phase 9's run, no
   seg_coalesce launch, the hash engine's collisions (each retried on the
   msd tail) and one host read a coalescing; at that run's first
   coarsening both engines bit-equal to the sort engine's rows, the msd
   one under set_sync_debug_mode("error"), the hash one with exactly one
   host read, and the three engines timed; the B=64 synth 65536 batch
   (phase 36's jobs) under msd on both engines, every tenant equal to the
   default run.
38. (run after 37, before 33-34) the six drivers of
   cuvite_tpu_torch.tools in one child process on the card (each
   module's main(argv), a call a verb; the spawned daemon and
   exchange_bench's two configurations in processes of their own):
   serve_load sweep, ab, pipeab and daemon on synth 4096 at b_max 16 (the
   saturation rate, the ab and pipeab verdicts with both arms' pack,
   device and overlap seconds, the daemon's SLO row at 64 jobs/s and its
   clean SIGTERM drain) and mix on phase 20's 90:10 pools at 2,000
   jobs/s (its verdict; the merged arm must merge) -- every record valid,
   with a checked guard, on phase 1's card; exchange_latency on 4 shards of the card and on a
   2x2 mesh (launch latencies, the crossover bracket against
   AUTO_SPARSE_MIN_VERTICES, the ladder from 256 KB a shard);
   exchange_bench at R-MAT 18 on 4 shards (both arms, equal labels, the
   sparse/replicated ratio); step_bench and trace_step at R-MAT 18 (step
   and CUDA-event ms; the top five device kernels, which must include the
   row kernel); weighted_ingest_bench at scale 18 (the builder and its
   seconds).  Fails if a call returns non-zero -- but an A/B verb (ab,
   pipeab, mix) may return 1 beside a verdict whose acceptance does not
   hold: its exit status must be its verdict's, which is printed either
   way, and a false verdict is a measurement, not a failure -- or unless
   serve_load counted row and seg_coalesce launches and step_bench row
   launches.  With two or more cards, --only-multiprocess ends with
   exchange_latency --world min(cards, 4), one NCCL rank a card.
39. (run after 38, before 33-34) the static analysis of the port:
   ``python -m cuvite_tpu_torch.analysis --format json`` over the port's
   tree against its baseline, twice: cold from an emptied cache in a
   child, then warm from its cache through the same command line's main
   in this process; fails unless both exit 0 and the warm findings equal
   the cold ones; the findings by rule and both walls printed.
40. (run after 39, before 33-34) the dynamic analysis tiers in one child
   on cuda:0: concheck's scenarios (the clean ones without a finding,
   the known-bug fixtures convicted), the width audit's --smoke (meta
   entries at the R-MAT 28 shard shape, the boundary probes, the
   zero-device-bytes spy), the compile and op audit against the cuda
   section of its manifest (builds, loads and kernel forms, B002 on new
   weights, host reads, uploads and launches a sweep, each entry's
   launches joining the kernels line), and the mesh audit over shards
   of cuda:0; fails on any finding; every finding, verdict and wall
   printed.
   All four kernels (the size form as its own entry) printed as one JSON
   line, with their launches on every path (the bench's, the stream and
   the mesh paths' among them) and their batched forms' times.

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
F64_OPS_PER_S = 34e12       # H100 SXM float64 outside the tensor cores
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
    elif a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
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
    padding rows.  Returns (tensors, constant, row degrees)."""
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
        deg[r] = width
    self_loop = (rng.integers(0, 2, nv) * 0.5).astype(np.float32)
    verts[-4:] = nv
    t = [torch.from_numpy(a).to(dev) for a in
         (dst, w, verts, comm, comm_deg, vdeg, self_loop)]
    return (t, float(np.float32(1.0 / 123457.0)),
            torch.from_numpy(deg.astype(np.int32)).to(dev))


def hot_row_case(width: int, seed: int, dev):
    """Rows whose real slots all fall in one community (even rows) or two
    (odd rows), the converged sweep's hot keys: neighbours are vertices
    [0, 2^16) with comm = id mod 1024, row r is vertex 2^16 + r.  Degrees
    are random in (width/2, width], a quarter of the rows sit in their hot
    community.  Returns (tensors, constant, row degrees)."""
    import torch

    rng = np.random.default_rng(seed)
    nb, pool = 1 << 16, 1024
    n_rows = max(64, min(4096, (1 << 21) // width))
    nv = nb + n_rows
    comm = np.concatenate([np.arange(nb) % pool,
                           rng.integers(0, pool, n_rows)]).astype(np.int32)
    a = rng.integers(0, pool, n_rows)
    b = rng.integers(0, pool, n_rows)
    comm[nb::4] = a[::4]
    two = (np.arange(n_rows) % 2 == 1)[:, None]
    pick = np.where(two & (rng.random((n_rows, width)) < 0.5), b[:, None],
                    a[:, None])
    dst = pick + pool * rng.integers(0, nb // pool, (n_rows, width))
    verts = (nb + np.arange(n_rows)).astype(np.int32)
    deg = rng.integers(width // 2 + 1, width + 1, n_rows)
    slot = np.arange(width)[None, :]
    dst = np.where(slot < deg[:, None], dst, verts[:, None]).astype(np.int32)
    w = (rng.integers(0, 5, (n_rows, width)) * 0.25).astype(np.float32)
    w[slot >= deg[:, None]] = 0.0
    comm_deg = rng.integers(1, 4 * width, nv).astype(np.float32)
    vdeg = rng.integers(1, 32, nv).astype(np.float32)
    self_loop = (rng.integers(0, 2, nv) * 0.5).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in
         (dst, w, verts, comm, comm_deg, vdeg, self_loop)]
    return (t, float(np.float32(1.0 / 7919.0)),
            torch.from_numpy(deg.astype(np.int32)).to(dev))


def tie_row_case(width: int, dev):
    """One row whose best two candidates tie at gain exactly zero: no edge
    into the current community (eix = 0), zero-weight edges into
    communities 5 and 3 (listed first) whose degree equals ax, so
    2*(0 - 0) - ((2*vdeg)*0)*c = 0 for both; community 9 is negative.  The
    smaller id, 3, must win.  Zero is where a bit-pattern order of gains
    (-0.0 below +0.0) would part from cv::better."""
    import torch

    nv = 16
    comm = np.arange(nv, dtype=np.int32)
    comm_deg = np.full(nv, 6.0, np.float32)
    comm_deg[9] = 100.0
    comm_deg[15] = 10.0                      # the row's vertex 15
    vdeg = np.full(nv, 4.0, np.float32)      # ax = 10 - 4 = 6 = ay
    dst = np.full((1, width), 15, np.int32)  # padding: the row's own vertex
    n = min(width, 6)
    dst[0, :n] = [5, 3, 9, 5, 3, 9][:n]
    w = np.zeros((1, width), np.float32)
    t = [torch.from_numpy(x).to(dev) for x in
         (dst, w, np.array([15], np.int32), comm, comm_deg, vdeg,
          np.zeros(nv, np.float32))]
    return t, float(np.float32(1.0 / 64.0))


def check_same(what: str, got, ref) -> None:
    for name, g, r in zip(("best_c", "best_gain", "counter0"), got, ref):
        if not bits_equal(g, r):
            fail(f"{what}: {name} differs from the twin (max abs err "
                 f"{max_abs_err(got, ref)})")


def check_rows(dev) -> None:
    from cuvite_tpu_torch.kernels.row_argmax import (
        row_argmax,
        row_argmax_plain,
    )
    from cuvite_tpu_torch.louvain.bucketed import DEFAULT_BUCKETS

    for width in DEFAULT_BUCKETS:
        args, const, deg = row_case(width, width, dev)
        got = row_argmax(*args, const)
        ref = row_argmax_plain(*args, const)
        check_same(f"row_argmax width {width}", got, ref)
        n_none = int((got[0].cpu() == 2**31 - 1).sum())
        if n_none < 4:
            fail(f"row_argmax width {width}: the no-candidate rows found "
                 "a candidate")
        # Stopped at each row's degree: equal to the full-width twin too.
        got_d = row_argmax(*args, const, deg)
        check_same(f"row_argmax width {width} with degrees", got_d,
                   row_argmax_plain(*args, const, deg))
        check_same(f"row_argmax width {width} with degrees vs full rows",
                   got_d, ref)
        hargs, hconst, hdeg = hot_row_case(width, width + 1, dev)
        for d in (None, hdeg):
            check_same(f"row_argmax width {width} hot-key rows "
                       f"(degrees {d is not None})",
                       row_argmax(*hargs, hconst, d),
                       row_argmax_plain(*hargs, hconst, d))
        targs, tconst = tie_row_case(width, dev)
        tie = row_argmax(*targs, tconst)
        check_same(f"row_argmax width {width} zero-gain tie", tie,
                   row_argmax_plain(*targs, tconst))
        if int(tie[0][0]) != 3 or float(tie[1][0]) != 0.0:
            fail(f"row_argmax width {width} zero-gain tie: got "
                 f"{int(tie[0][0])} at {float(tie[1][0])}, want 3 at 0")
        print(f"  row_argmax width {width:5d}: {args[0].shape[0]} rows "
              f"bit-equal to the twin ({n_none} without a candidate), with "
              f"and without degrees; {hargs[0].shape[0]} hot-key rows; "
              "zero-gain tie to the smaller id")


# ---------------------------------------------------------------------------
# Phase 3: the heavy kernel.


def hub_tensors(src, dst, w, comm, comm_deg, vdeg, self_loop, dev):
    import torch

    from cuvite_tpu_torch.kernels.heavy_bincount import build_heavy_layout

    lay = build_heavy_layout(src, dst, w, nv_local=len(comm)).to(dev)
    tabs = [torch.from_numpy(a).to(dev)
            for a in (comm, comm_deg, vdeg, self_loop)]
    return lay, tabs


def heavy_case(seed: int, dev):
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
    lay, tabs = hub_tensors(src, dst, w, comm, comm_deg, vdeg, self_loop,
                            dev)
    return lay, tabs, float(np.float32(1.0 / 987653.0))


def hot_heavy_case(seed: int, dev):
    """Hubs whose edges all reach one community (even hubs) or two (odd
    hubs); hub 2's one community is its own (no candidate), and hub 0 has
    2^18 edges (64 chunks).  Neighbours are vertices [0, 2^20) with comm =
    id mod 4096."""
    rng = np.random.default_rng(seed)
    nb, pool, n_hubs = 1 << 20, 4096, 16
    nv = nb + n_hubs
    comm = np.concatenate([np.arange(nb) % pool,
                           rng.integers(0, pool, n_hubs)]).astype(np.int32)
    deg = rng.integers(8193, 40000, n_hubs)
    deg[0] = 1 << 18
    hubs = nb + np.arange(n_hubs)
    src = np.repeat(hubs, deg)
    a = rng.integers(0, pool, n_hubs)
    b = rng.integers(0, pool, n_hubs)
    comm[hubs[2]] = a[2]
    hub = np.repeat(np.arange(n_hubs), deg)
    odd = (hub % 2 == 1) & (rng.random(len(src)) < 0.5)
    dst = np.where(odd, b[hub], a[hub]) + pool * rng.integers(
        0, nb // pool, len(src))
    w = rng.integers(0, 4, len(src)).astype(np.float32)
    comm_deg = rng.integers(1, 1 << 20, nv).astype(np.float32)
    vdeg = np.zeros(nv, dtype=np.float32)
    vdeg[hubs] = deg
    self_loop = np.zeros(nv, dtype=np.float32)
    lay, tabs = hub_tensors(src, dst, w, comm, comm_deg, vdeg, self_loop,
                            dev)
    return lay, tabs, float(np.float32(1.0 / 3000017.0))


def big_hub_case(seed: int, dev):
    """A hub of 2^18 edges (64 chunks) over skewed communities, beside two
    hubs of 8193 and 3 * 4096 edges (chunk boundaries at the edges)."""
    rng = np.random.default_rng(seed)
    n_comm = 1 << 20
    deg = np.array([1 << 18, 8193, 3 * 4096])
    nv = n_comm + len(deg)
    comm = (n_comm * rng.random(nv) ** 2).astype(np.int32)
    hubs = n_comm + np.arange(len(deg))
    src = np.repeat(hubs, deg)
    dst = rng.integers(0, n_comm, len(src))
    w = rng.integers(0, 8, len(src)).astype(np.float32)
    comm_deg = np.zeros(n_comm, dtype=np.float32)
    np.add.at(comm_deg, comm, rng.integers(1, 100, nv).astype(np.float32))
    vdeg = np.zeros(nv, dtype=np.float32)
    vdeg[hubs] = deg
    self_loop = np.zeros(nv, dtype=np.float32)
    self_loop[hubs] = 1.0
    lay, tabs = hub_tensors(src, dst, w, comm, comm_deg, vdeg, self_loop,
                            dev)
    return lay, tabs, float(np.float32(1.0 / 1234567.0))


def tie_hub_case(dev):
    """tie_row_case for a hub of 12,000 edges (three chunks): zero-weight
    edges into communities 5 (first), 3 and 9; 3 and 5 tie at gain 0."""
    nv = 16
    comm = np.arange(nv, dtype=np.int32)
    comm_deg = np.full(nv, 6.0, np.float32)
    comm_deg[9] = 100.0
    comm_deg[15] = 10.0
    vdeg = np.full(nv, 4.0, np.float32)
    dst = np.tile(np.array([5, 3, 9]), 4000)
    src = np.full(len(dst), 15)
    w = np.zeros(len(dst), np.float32)
    lay, tabs = hub_tensors(src, dst, w, comm, comm_deg, vdeg,
                            np.zeros(nv, np.float32), dev)
    return lay, tabs, float(np.float32(1.0 / 64.0))


def check_heavy(dev) -> None:
    from cuvite_tpu_torch.kernels.heavy_bincount import (
        heavy_argmax,
        heavy_argmax_plain,
    )

    cases = [("seeded hubs", *heavy_case(11, dev)),
             ("hot-key hubs", *hot_heavy_case(12, dev)),
             ("2^18-edge hub", *big_hub_case(13, dev)),
             ("zero-gain tie", *tie_hub_case(dev))]
    for what, lay, tabs, const in cases:
        got = heavy_argmax(lay, *tabs, const)
        check_same(f"heavy_argmax {what}", got,
                   heavy_argmax_plain(lay, *tabs, const))
        if not lay.scratch.is_clean():
            fail(f"heavy_argmax {what}: the scratch was left dirty")
        again = heavy_argmax(lay, *tabs, const)
        check_same(f"heavy_argmax {what}, second launch", again, got)
        bc = got[0].cpu()
        if what == "seeded hubs" and (int(bc[0]) != 2**31 - 1
                                      or int(bc[1]) == 2**31 - 1):
            fail("heavy_argmax: the no-candidate / zero-weight hubs are "
                 "wrong")
        if what == "hot-key hubs" and int(bc[2]) != 2**31 - 1:
            fail("heavy_argmax: the hub inside its one community found a "
                 "candidate")
        if what == "zero-gain tie" and (int(bc[0]) != 3
                                        or float(got[1][0]) != 0.0):
            fail(f"heavy_argmax zero-gain tie: got {int(bc[0])} at "
                 f"{float(got[1][0])}, want 3 at 0")
        print(f"  heavy_argmax {what}: {lay.num_hubs} hubs, "
              f"{lay.dst.numel()} edges, {lay.num_chunks} chunks, "
              "bit-equal to the twin, twice; scratch left clean")


# ---------------------------------------------------------------------------
# Phases 4-6.


def kernel_counts() -> dict:
    """Launches of each kernel."""
    from cuvite_tpu_torch.kernels import launch_counts

    return launch_counts()


def zero_kernel_counts() -> None:
    from cuvite_tpu_torch.kernels import zero_launch_counts

    zero_launch_counts()


def check_same_run(what: str, rg, rc) -> None:
    if not np.array_equal(rg.communities, rc.communities):
        fail(f"{what}: card and CPU labels differ")
    its = ([p.iterations for p in rg.phases],
           [p.iterations for p in rc.phases])
    if its[0] != its[1]:
        fail(f"{what}: phases/iterations differ: {its}")
    if abs(rg.modularity - rc.modularity) > 1e-9:
        fail(f"{what}: Q {rg.modularity} vs {rc.modularity}")



def check_card_vs_cpu(scale: int) -> None:
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rmat

    g = generate_rmat(scale)
    rg = louvain_phases(g, device="cuda")
    rc = louvain_phases(g, device="cpu")
    check_same_run(f"R-MAT {scale}", rg, rc)
    print(f"  R-MAT {scale}: {len(rg.phases)} phases, "
          f"{rg.total_iterations} iterations, Q {rg.modularity:.9f} on card "
          "and CPU, labels identical")


def run_main_path(g, scale: int) -> tuple:
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.evaluate.modularity import modularity

    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t0 = time.perf_counter()
    res = louvain_phases(g)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = kernel_counts()
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
    for name in ("row_argmax", "heavy_bincount"):
        if launches[name] == 0:
            fail(f"{name} never launched on the main path")
    q_host = modularity(g, res.communities)
    if abs(q_host - res.modularity) > 1e-6:
        fail(f"reported Q {res.modularity} vs host f64 {q_host}")
    print(f"  reported Q {res.modularity:.9f}, host f64 Q {q_host:.9f}")
    return launches, sweeps, total_s, res


# Bounds count the bytes the function must move on this run's data: each
# input read once, each output written once.  Padding is not work, and
# neither is the kernels' own scratch (the heavy chunk table, hub tables,
# the vertex records): per real slot or heavy edge 8 B of dst and w; per
# real row ``ROW_BYTES`` (its id, int32 degree, vdeg and self_loop, three
# 4-byte outputs), per hub ``HUB_BYTES`` (the same with an int64 edge
# offset for the degree); and the comm and comm_deg entries of the real
# vertices once, but no more entries than the slots or heavy edges that
# gather them (a fold's or a hub launch's untouched table is not work).
# Those tables fit in L2, so the gathers add no bytes here;
# ``bytes_with_gathers`` adds 4 B per slot or edge for a comm gather that
# misses L2.  Operations are counted as 8 f32 operations
# per real slot or heavy edge, an upper bound: one compare and one add per
# slot, and at most one 7-operation gain (plus its compare) per distinct
# community.
ROW_BYTES = 4 + 4 + 8 + 12
HUB_BYTES = 4 + 8 + 8 + 12


def bound(n_bytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bucket_work(plan, deg: np.ndarray, nv: int) -> list:
    """(width, launched rows, real rows, real slots) of each bucket."""
    out = []
    for verts, dst, _, _ in plan.buckets:
        v = verts.cpu().numpy()
        v = v[v < nv]
        out.append((dst.shape[1], dst.shape[0], len(v), int(deg[v].sum())))
    return out


def time_kernels(g, launches: dict, sweeps: int) -> list:
    """Kernel vs twin at the phase-0 shapes of ``g``, at the identity
    assignment and at the converged phase-0 assignment, with bounds from
    this graph's bytes and operations.  The row kernel's ``ms`` is one
    sweep's worth (every bucket class once)."""
    import torch

    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.kernels.heavy_bincount import (
        heavy_argmax,
        heavy_argmax_plain,
    )
    from cuvite_tpu_torch.kernels.row_argmax import (
        row_argmax,
        row_argmax_plain,
        vertex_table,
    )
    from cuvite_tpu_torch.louvain.driver import PhaseRunner
    from cuvite_tpu_torch.ops.segment import segment_sum

    run = PhaseRunner(DistGraph.build(g), "cuda")
    plan, vdeg = run.plan, run.vdeg
    nv = run.nv_total
    const = run.constant.c32
    # comm and comm_deg: at most one read per slot or heavy edge, of the
    # real vertices only.
    table_nv = g.num_vertices
    deg = np.zeros(nv, dtype=np.int64)
    deg[: g.num_vertices] = g.degrees()
    work = bucket_work(plan, deg, nv)
    for width, n_rows, real_rows, _ in work:
        print(f"  class {width:5d}: {real_rows} real rows, {n_rows} "
              "launched")
        if n_rows != real_rows:
            fail(f"class {width}: {n_rows - real_rows} padding rows reach "
                 "the row kernel")
    lay = plan.heavy
    if lay is None:
        fail("the phase-0 graph has no hub: the heavy kernel is untimed")

    _, _, iters = run.run(1.0e-6)   # phase 0 as louvain_phases runs it
    assignments = {"identity": run.comm0, "converged": run.labels_dev}
    print(f"  converged phase-0 assignment after {iters} sweeps: "
          f"{int(torch.unique(run.labels_dev).numel())} communities")
    t = {}
    row_err = hub_err = 0.0
    for label, comm in assignments.items():
        comm_deg = segment_sum(vdeg.double(), comm, nv).float()
        tables = (comm, comm_deg, vdeg, plan.self_loop)
        # The kernel's vertex records, built once per sweep by the sweep
        # (bucketed_step): part of the row kernel's ``ms``, and timed on
        # their own as well.
        vinfo = vertex_table(*tables)
        t[f"vinfo_{label}"] = time_ms(lambda: vertex_table(*tables), 20)

        def rows(fn, buckets=plan.buckets, tables=tables, vinfo=vinfo):
            extra = (vinfo,) if fn is row_argmax else ()
            return [fn(d, w, v, *tables, const, dg, *extra)
                    for v, d, w, dg in buckets]

        def hub(fn, tables=tables):
            return fn(lay, *tables, const)

        # One whole sweep (kernels and the torch ops around them) on the
        # device stream: with the sweep count, an upper bound on the
        # run's device-busy time.
        t[f"sweep_{label}"] = time_ms(lambda: run.step(comm), 10)
        row_err = max(row_err, max(max_abs_err(a, b) for a, b in
                                   zip(rows(row_argmax),
                                       rows(row_argmax_plain))))
        hub_err = max(hub_err, max_abs_err(hub(heavy_argmax),
                                           hub(heavy_argmax_plain)))
        t[f"row_{label}"] = time_ms(
            lambda: rows(row_argmax, vinfo=vertex_table(*tables)), 20)
        t[f"row_launches_{label}"] = time_ms(lambda: rows(row_argmax), 20)
        t[f"row_plain_{label}"] = time_ms(lambda: rows(row_argmax_plain), 3)
        t[f"hub_{label}"] = time_ms(lambda: hub(heavy_argmax), 20)
        t[f"hub_plain_{label}"] = time_ms(lambda: hub(heavy_argmax_plain), 3)
        t[f"width_{label}"] = [time_ms(lambda b=b: rows(row_argmax, [b]), 20)
                               for b in plan.buckets]
        print(f"  {label}: one phase-0 sweep {t[f'sweep_{label}']:.4f} ms "
              f"on the device stream; row {t[f'row_{label}']:.4f} ms "
              f"(class launches {t[f'row_launches_{label}']:.4f} ms, "
              f"vertex_table {t[f'vinfo_{label}']:.4f} ms), heavy "
              f"{t[f'hub_{label}']:.4f} ms")

    per_width = []
    for k, (width, n_rows, real_rows, slots) in enumerate(work):
        b_ms, _ = bound(slots * 8 + real_rows * ROW_BYTES, 8 * slots)
        per_width.append({
            "width": width, "rows": n_rows, "real_rows": real_rows,
            "real_slots": slots, "ms": t["width_identity"][k],
            "ms_converged": t["width_converged"][k], "bound_ms": b_ms})
    slots = sum(w[3] for w in work)
    real_rows = sum(w[2] for w in work)
    row_bytes = slots * 8 + real_rows * ROW_BYTES + 2 * 4 * min(slots,
                                                                 table_nv)
    per_sweep = launches["row_argmax"] / max(sweeps, 1)
    row = {
        "name": "row_argmax", "route": "cuda",
        "source": "cuvite_tpu_torch/kernels/csrc/row_argmax.cu",
        "replaces": "cuvite_tpu/kernels/row_argmax.py:166",
        "tpu_function": "cuvite_tpu/kernels/row_argmax.py:row_argmax_pallas",
        "launches": launches["row_argmax"], "sweeps": sweeps,
        "launches_per_sweep": per_sweep, "max_abs_err": row_err,
        "ms_unit": f"one phase-0 sweep: vertex_table and {len(work)} "
                   "class launches (per_width: the launches alone)",
        "ms": t["row_identity"], "ms_converged": t["row_converged"],
        "launches_ms": t["row_launches_identity"],
        "launches_ms_converged": t["row_launches_converged"],
        "ms_per_launch": t["row_launches_identity"] / len(work),
        "plain_ms": t["row_plain_identity"],
        "plain_ms_converged": t["row_plain_converged"],
        "vertex_table_ms": t["vinfo_identity"],
        "vertex_table_ms_converged": t["vinfo_converged"],
        "bytes": row_bytes, "bytes_with_gathers": row_bytes + 4 * slots,
        "ops": 8 * slots, "real_rows": real_rows, "real_slots": slots,
        "launched_slots": sum(d.numel() for _, d, _, _ in plan.buckets),
        "per_width": per_width,
    }
    e = lay.dst.numel()
    hub_bytes = e * 8 + lay.num_hubs * HUB_BYTES + 2 * 4 * min(e, table_nv)
    hub = {
        "name": "heavy_bincount", "route": "cuda",
        "source": "cuvite_tpu_torch/kernels/csrc/heavy_bincount.cu",
        "replaces": "cuvite_tpu/kernels/heavy_bincount.py:200",
        "tpu_function":
            "cuvite_tpu/kernels/heavy_bincount.py:heavy_argmax_pallas",
        "launches": launches["heavy_bincount"], "sweeps": sweeps,
        "launches_per_sweep": launches["heavy_bincount"] / max(sweeps, 1),
        "max_abs_err": hub_err, "ms_unit": "one launch",
        "ms": t["hub_identity"], "ms_converged": t["hub_converged"],
        "ms_per_launch": t["hub_identity"],
        "plain_ms": t["hub_plain_identity"],
        "plain_ms_converged": t["hub_plain_converged"],
        "bytes": hub_bytes, "bytes_with_gathers": hub_bytes + 4 * e,
        "ops": 8 * e, "hubs": lay.num_hubs, "edges": e,
        "chunks": lay.num_chunks, "table_bytes": 8 * lay.table_size,
    }
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
    for label in assignments:
        out[0][f"sweep_ms_{label}"] = t[f"sweep_{label}"]
    return out


# ---------------------------------------------------------------------------
# Phases 7-10: the seg_coalesce kernel and the sort path.


def coalesce_case(nv_pad: int, ne_pad: int, seed: int, gapped: bool,
                  weights: str, dev):
    """A relabeled slab: real rows in a prefix, padding (src == nv_pad,
    dst == 0, w == 0) after; the first eighth of the real rows are
    self-loops (heavy self-loop runs), 37 real rows weigh 0.  ``gapped``:
    ids from a sparse subset.  ``weights``: 'dyadic' (multiples of 1/8) or
    'float' (RGG-like distances in (0, 0.01))."""
    import torch

    rng = np.random.default_rng(seed)
    n_real = ne_pad - ne_pad // 5
    pool = (rng.choice(nv_pad, size=max(nv_pad // 11, 2), replace=False)
            if gapped else np.arange(nv_pad))
    src = np.full(ne_pad, nv_pad, np.int32)
    dst = np.zeros(ne_pad, np.int32)
    w = np.zeros(ne_pad, np.float32)
    src[:n_real] = rng.choice(pool, size=n_real)
    dst[:n_real] = rng.choice(pool, size=n_real)
    src[: n_real // 8] = dst[: n_real // 8]
    if weights == "dyadic":
        w[:n_real] = rng.integers(1, 64, n_real) / 8.0
    else:
        w[:n_real] = rng.uniform(1e-4, 1e-2, n_real)
    w[n_real // 2: n_real // 2 + 37] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (src, dst, w)]


def hot_src_case(nv_pad: int, ne_pad: int, seed: int, dev):
    """A relabeled slab whose real rows all leave one src (11), the late
    phase where one community absorbs most vertices: a third of them its
    self-loop run, the rest to 40 ids spread over [0, nv_pad); dyadic
    weights, zeros among them; padding after, every row shuffled.  Every
    real row falls in one bucket: the pipeline's dense row in shared
    memory, tiled past 8192 dst slots."""
    import torch

    rng = np.random.default_rng(seed)
    n_real = ne_pad - ne_pad // 7
    src = np.full(ne_pad, nv_pad, np.int32)
    dst = np.zeros(ne_pad, np.int32)
    w = np.zeros(ne_pad, np.float32)
    src[:n_real] = 11
    dst[:n_real] = rng.choice(nv_pad, 40, replace=False)[
        rng.integers(0, 40, n_real)]
    dst[: n_real // 3] = 11
    w[:n_real] = rng.integers(0, 16, n_real) / 4.0
    perm = rng.permutation(ne_pad)
    return [torch.from_numpy(a[perm]).to(dev) for a in (src, dst, w)]


def rows_equal(a, b) -> bool:
    """(src, dst, w, n) of two coalesced slabs, bit for bit."""
    return a[3] == b[3] and all(bits_equal(x, y) for x, y in zip(a[:3], b[:3]))


def batch_rows_equal(a, b) -> bool:
    """(src, dst, w [B, ne], n [B]) of two coalesced batches, bit for
    bit."""
    return all(bits_equal(x, y) for x, y in zip(a, b))


def coalesce_err(got, ref) -> float:
    """Largest |pipeline - twin| over (src, dst, w, n) of two batches."""
    return max((float((g.double() - r.double()).abs().max())
                if g.numel() else 0.0) for g, r in zip(got, ref))


def check_pipeline(what: str, args, nv_pad: int, grid: int) -> tuple:
    """seg_coalesce on [B, ne] card tensors against its twin on the same
    tensors, bit for bit, the launch count up by one.  Returns the
    pipeline's rows."""
    import torch

    from cuvite_tpu_torch.kernels.seg_coalesce import (
        seg_coalesce,
        seg_coalesce_plain,
    )

    n = seg_coalesce.launches
    got = seg_coalesce(*args, nv_pad=nv_pad, grid=grid)
    torch.cuda.synchronize()
    if seg_coalesce.launches != n + 1:
        fail(f"seg_coalesce {what}: launch count did not go up by one")
    ref = seg_coalesce_plain(*args, nv_pad=nv_pad, grid=grid)
    if not batch_rows_equal(got, ref):
        fail(f"seg_coalesce {what}: rows differ from the twin "
             f"(max abs err {coalesce_err(got, ref)})")
    del ref
    torch.cuda.empty_cache()
    return got


def check_coalesce(dev) -> None:
    import torch

    from cuvite_tpu_torch.ops.segment import (
        coalesced_runs,
        coalesced_runs_batched,
    )

    for nv_pad in (64, 1024, 4096):
        for weights in ("dyadic", "float"):
            args = coalesce_case(nv_pad, 1 << 16, nv_pad, nv_pad == 1024,
                                 weights, dev)
            got = check_pipeline(f"nv_pad {nv_pad} {weights}",
                                 [a[None] for a in args], nv_pad, nv_pad)
            ref = coalesced_runs(*args, nv_pad=nv_pad, engine="sort")
            if not rows_equal((got[0][0], got[1][0], got[2][0],
                               int(got[3][0])), ref):
                fail(f"seg_coalesce nv_pad {nv_pad} {weights}: rows "
                     "differ from the sort engine's")
            print(f"  seg_coalesce nv_pad {nv_pad:5d} {weights:6s}: "
                  f"{args[0].numel()} rows -> {ref[3]} runs, bit-equal to "
                  "the twin and to the sort engine")
    for nv_pad, ne in ((4096, 1 << 15), (16384, 1 << 16), (32768, 1 << 16)):
        args = [a[None] for a in hot_src_case(nv_pad, ne, nv_pad, dev)]
        got = check_pipeline(f"one-src slab at nv_pad {nv_pad}", args,
                             nv_pad, nv_pad)
        print(f"  seg_coalesce one-src slab, nv_pad {nv_pad:5d}: {ne} rows "
              f"-> {int(got[3][0])} runs in one bucket (dst tiles of 8192: "
              f"{max(nv_pad // 8192, 1)}), bit-equal to the twin")
    zero = coalesce_case(1024, 4096, 9, False, "dyadic", dev)
    zero[0][:300], zero[1][:300], zero[2][:300] = 7, 8, 0.0
    medium = [coalesce_case(512, 16384, 80 + i, False, "dyadic", dev)
              for i in range(4)]
    for i, (src, _, _) in enumerate(medium):
        src[src < 512] %= 4 * (i + 1)   # buckets of ~800 to ~3300 rows
    edge = {"a 300-row run of weight 0": ([a[None] for a in zero], 1024),
            "four tenants of 4 to 16 buckets":
                ([torch.stack(a) for a in zip(*medium)], 512),
            "three tenants of 16,461 rows":
                ([torch.stack(a) for a in zip(*[coalesce_case(
                    1024, 16461, 60 + i, i == 1, "dyadic", dev)
                    for i in range(3)])], 1024),
            "a pure-padding slab":
                ([torch.full((1, 8192), 512, dtype=torch.int32, device=dev),
                  torch.zeros((1, 8192), dtype=torch.int32, device=dev),
                  torch.zeros((1, 8192), device=dev)], 512),
            "an empty slab":
                ([torch.zeros((2, 0), dtype=torch.int32, device=dev),
                  torch.zeros((2, 0), dtype=torch.int32, device=dev),
                  torch.zeros((2, 0), device=dev)], 64)}
    for what, (args, nv_pad) in edge.items():
        got = check_pipeline(what, args, nv_pad, nv_pad)
        print(f"  seg_coalesce {what}: rows {got[3].tolist()}, bit-equal "
              "to the twin")
    one = [a[None] for a in hot_src_case(4096, 1 << 15, 3, dev)]
    many = [torch.stack(a) for a in zip(*[coalesce_case(
        512, 8192, 70 + i, i == 1, "dyadic", dev) for i in range(4)])]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        coalesced_runs_batched(*one, nv_pad=4096, engine="dense")
        coalesced_runs_batched(*many, nv_pad=512, engine="dense", grid=512)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  the whole coalesce, one slab and a batch of 4, under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync")


def check_sort_card_vs_cpu(nv: int) -> None:
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rgg

    g = generate_rgg(nv)
    rg = louvain_phases(g, device="cuda", engine="sort")
    rc = louvain_phases(g, device="cpu", engine="sort")
    check_same_run(f"RGG {nv} sort engine", rg, rc)
    engines = [p.coalesce for p in rg.phases]
    if "dense" not in engines:
        fail(f"RGG {nv} sort engine: no dense coarsening ({engines})")
    print(f"  RGG {nv}: {g.num_edges} directed edges, {len(rg.phases)} "
          f"phases, iterations {[p.iterations for p in rg.phases]}, Q "
          f"{rg.modularity:.9f} on card and "
          f"CPU, labels identical; coarsenings {engines}")


def run_sort_path(g, nv: int) -> tuple:
    """The sort path on the card; returns (the launch counts, the dense
    coarsenings' relabeled slabs and results, the narrowest sort
    coarsening's, the seconds, the result)."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.evaluate.modularity import modularity
    from cuvite_tpu_torch.ops import segment as seg

    # Observe, without changing, every coalesce of the run: keep the
    # relabeled slab and the result of each dense one, and the slab of the
    # narrowest sort coarsening (the class above the dense engine's cap).
    captured, above = [], []
    coalesced_runs = seg.coalesced_runs

    def observed(src, ckey, w, *, nv_pad, engine="sort"):
        out = coalesced_runs(src, ckey, w, nv_pad=nv_pad, engine=engine)
        if engine == "dense":
            captured.append(((src, ckey, w), nv_pad, out))
        elif not above or nv_pad < above[0][1]:
            above[:] = [((src, ckey, w), nv_pad, out)]
        return out

    seg.coalesced_runs = observed
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        t0 = time.perf_counter()
        res = louvain_phases(g, engine="sort")
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = kernel_counts()
    finally:
        seg.coalesced_runs = coalesced_runs
    for p in res.phases:
        st = " ".join(f"{k} {v:.3f}" for k, v in p.stages.items())
        print(f"  phase {p.phase}: nv {p.num_vertices} ne {p.num_edges} "
              f"iterations {p.iterations} Q {p.modularity:.9f} seconds "
              f"{p.seconds:.3f} coalesce {p.coalesce} (host stages, s: "
              f"{st})")
    print(f"  RGG {nv}: total {total_s:.3f} s, {res.total_iterations} "
          f"sweeps, max_memory_allocated {torch.cuda.max_memory_allocated()}"
          f" B, launches {launches}")
    if launches["seg_coalesce"] == 0:
        fail(f"seg_coalesce never launched on the RGG {nv} sort path "
             f"(coarsenings {[p.coalesce for p in res.phases]})")
    q_host = modularity(g, res.communities)
    if abs(q_host - res.modularity) > 1e-6:
        fail(f"RGG {nv}: reported Q {res.modularity} vs host f64 {q_host}")
    print(f"  reported Q {res.modularity:.9f}, host f64 Q {q_host:.9f}")
    for k, (args, nv_pad, got) in enumerate(captured):
        ref = coalesced_runs(*args, nv_pad=nv_pad, engine="sort")
        if got[3] != ref[3] or not (bits_equal(got[0], ref[0])
                                    and bits_equal(got[1], ref[1])):
            fail(f"dense coarsening {k} (nv_pad {nv_pad}): rows differ "
                 "from the sort engine's")
        n = got[3]
        a = got[2][:n].cpu().view(torch.int32).long()
        b = ref[2][:n].cpu().view(torch.int32).long()
        ulps = (a - b).abs()
        if n and int(ulps.max()) > 1:
            fail(f"dense coarsening {k}: a weight differs by "
                 f"{int(ulps.max())} f32 ulps from the sort engine's")
        print(f"  dense coarsening {k}: nv_pad {nv_pad}, "
              f"{args[0].numel()} slab rows -> {n} rows, equal to the sort "
              f"engine's; {int((ulps > 0).sum())} weights one ulp apart")
    return launches, captured, above, total_s, res


def time_sort_sweep(g) -> float:
    """Milliseconds of one phase-0 sort-engine sweep (identity assignment)
    on the device stream: with the sweep count, an upper bound on the
    phase's device-busy time."""
    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.louvain.driver import PhaseRunner

    run = PhaseRunner(DistGraph.build(g), "cuda", "sort")
    return time_ms(lambda: run.step(run.comm0), 10)


def coalesce_bound(src, grid: int) -> tuple:
    """The least time of one coalesce of [B, ne] slabs: 12 B read per real
    row (src, dst, w) and 12 B per output slot plus the [B] int64 counts
    written once, one f64 add per real row.  No key grid: the function's
    output is the coalesced slab.  Returns (ms, bound_by, bytes, rows)."""
    rows = int((src < grid).sum())
    n_bytes = rows * 12 + src.numel() * 12 + src.shape[0] * 8
    return (*bound(n_bytes, rows, F64_OPS_PER_S), n_bytes, rows)


def peak_bytes(fn) -> int:
    """Device memory one call allocates beyond what was live before it
    (outputs and scratch)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def time_coalesce(launches: int, captured: list) -> dict:
    """The whole coalesce at the relabeled slab of the sort path's first
    dense coarsening: the pipeline against its twin (bit for bit) and the
    sort engine on the same slab, with the recounted bound."""
    from cuvite_tpu_torch.kernels.seg_coalesce import (
        seg_coalesce,
        seg_coalesce_plain,
    )
    from cuvite_tpu_torch.ops.segment import coalesced_runs_batched

    (src, dst, w), nv_pad, _ = captured[0]
    one = (src[None], dst[None], w[None])
    got = check_pipeline("at the sort-path slab", one, nv_pad, nv_pad)
    err = coalesce_err(got, seg_coalesce_plain(*one, nv_pad=nv_pad,
                                               grid=nv_pad))
    b_ms, b_by, n_bytes, rows = coalesce_bound(one[0], nv_pad)
    return {
        "name": "seg_coalesce", "route": "cuda",
        "source": "cuvite_tpu_torch/kernels/csrc/seg_coalesce.cu",
        "replaces": "cuvite_tpu/kernels/seg_coalesce.py:202",
        "tpu_function":
            "cuvite_tpu/kernels/seg_coalesce.py:seg_coalesce_pallas "
            "with emit_coalesced (:272)",
        "launches": launches, "max_abs_err": err,
        "ms": time_ms(lambda: seg_coalesce(*one, nv_pad=nv_pad,
                                           grid=nv_pad), 20),
        "plain_ms": time_ms(
            lambda: seg_coalesce_plain(*one, nv_pad=nv_pad, grid=nv_pad), 20),
        "sort_engine_ms": time_ms(
            lambda: coalesced_runs_batched(*one, nv_pad=nv_pad,
                                           engine="sort"), 20),
        "library_ms": None,
        "library": "none: no single PyTorch call computes the coalesced slab",
        "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "ops": rows,
        "alloc_bytes": peak_bytes(
            lambda: seg_coalesce(*one, nv_pad=nv_pad, grid=nv_pad)),
        "nv_pad": nv_pad, "slab_rows": src.numel(), "real_rows": rows,
    }


def time_engines_above_cap(what: str, args, nv_pad: int, grid: int,
                           env_max_nv: bool) -> dict:
    """Both engines on a coarsening the routing sends to the sort: the
    whole dense coalesce (admitted with CUVITE_SEG_COALESCE_MAX_NV when
    ``env_max_nv``) and the sort engine, on the same [B, ne] slab.  The
    dense rows must equal the sort engine's (src, dst, n exact, weights at
    most one f32 ulp apart)."""
    import torch

    from cuvite_tpu_torch.kernels.seg_coalesce import (
        FLAT_NV_MAX,
        batched_coalesce_engine,
        coalesce_engine,
    )
    from cuvite_tpu_torch.ops.segment import coalesced_runs_batched

    b = args[0].shape[0]
    out = {"what": what, "tenants": b, "nv_pad": nv_pad, "grid": grid,
           "slab_rows": args[0].numel(),
           "routed": batched_coalesce_engine(nv_pad, b, grid)}
    sort = lambda: coalesced_runs_batched(*args, nv_pad=nv_pad,  # noqa: E731
                                          engine="sort", grid=grid)
    out["sort_ms"] = time_ms(sort, 10)
    if grid > FLAT_NV_MAX:
        out["dense_ms"] = None
        out["dense"] = f"grid {grid} over FLAT_NV_MAX = {FLAT_NV_MAX}"
        return out
    old = os.environ.get("CUVITE_SEG_COALESCE_MAX_NV")
    if env_max_nv:
        os.environ["CUVITE_SEG_COALESCE_MAX_NV"] = str(nv_pad)
    try:
        if env_max_nv and coalesce_engine(nv_pad) != "dense":
            fail(f"{what}: CUVITE_SEG_COALESCE_MAX_NV={nv_pad} did not "
                 "admit the class")
        dense = lambda: coalesced_runs_batched(  # noqa: E731
            *args, nv_pad=nv_pad, engine="dense", grid=grid)
        got, ref = dense(), sort()
        out["dense_ms"] = time_ms(dense, 10)
        out["dense_alloc_bytes"] = peak_bytes(dense)
    finally:
        if old is None:
            os.environ.pop("CUVITE_SEG_COALESCE_MAX_NV", None)
        else:
            os.environ["CUVITE_SEG_COALESCE_MAX_NV"] = old
    out["sort_alloc_bytes"] = peak_bytes(sort)
    if not (bits_equal(got[0], ref[0]) and bits_equal(got[1], ref[1])
            and bits_equal(got[3], ref[3])):
        fail(f"{what}: the dense rows differ from the sort engine's")
    ulps = (got[2].cpu().view(torch.int32).long()
            - ref[2].cpu().view(torch.int32).long()).abs()
    if ulps.numel() and int(ulps.max()) > 1:
        fail(f"{what}: a dense weight is {int(ulps.max())} f32 ulps from "
             "the sort engine's")
    out["weights_one_ulp_apart"] = int((ulps > 0).sum())
    out["real_rows"] = int((args[0] < grid).sum())
    return out


# ---------------------------------------------------------------------------
# Phases 11-14: the fused engine and the ET and color schedules.


def check_fused_card_vs_cpu(graphs: dict, shrink: int) -> dict:
    """Phase 11; returns the card runs' launch counts."""
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.louvain import driver

    default = driver.FUSED_SHRINK_EDGES
    driver.FUSED_SHRINK_EDGES = shrink
    total = dict.fromkeys(kernel_counts(), 0)
    try:
        for name, g in graphs.items():
            zero_kernel_counts()
            rg = louvain_phases(g, device="cuda", engine="fused")
            for k, n in kernel_counts().items():
                total[k] += n
            rc = louvain_phases(g, device="cpu", engine="fused")
            check_same_run(f"{name} fused", rg, rc)
            print(f"  {name}: {g.num_edges} directed edges, "
                  f"{len(rg.phases)} phases, iterations "
                  f"{[p.iterations for p in rg.phases]}, Q "
                  f"{rg.modularity:.9f} on card and CPU, labels identical; "
                  f"coarsenings {[p.coalesce for p in rg.phases]}")
    finally:
        driver.FUSED_SHRINK_EDGES = default
    print(f"  card launches {total}")
    if total["seg_coalesce"] == 0:
        fail("seg_coalesce never launched on the fused path")
    return total


def run_fused_path(g, name: str, other_s: dict) -> dict:
    """Phase 12 on one graph: the fused run, then whichever of the sort
    and bucketed engines did not run on ``g`` earlier in this call
    (``other_s`` holds those that did, in seconds).  Returns the fused
    run's launch counts."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.evaluate.modularity import modularity

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t0 = time.perf_counter()
    res = louvain_phases(g, engine="fused")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = kernel_counts()
    for p in res.phases:
        st = " ".join(f"{k} {v:.3f}" for k, v in p.stages.items())
        print(f"  phase {p.phase}: nv {p.num_vertices} ne {p.num_edges} "
              f"iterations {p.iterations} Q {p.modularity:.9f} seconds "
              f"{p.seconds:.3f} device coarsening after it: {p.coalesce} "
              f"(host stages, s: {st})")
    q_host = modularity(g, res.communities)
    if abs(q_host - res.modularity) > 1e-6:
        fail(f"{name} fused: reported Q {res.modularity} vs host f64 "
             f"{q_host}")
    times = dict(other_s)
    for engine in ("sort", "bucketed"):
        if engine not in times:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            louvain_phases(g, engine=engine)
            torch.cuda.synchronize()
            times[engine] = time.perf_counter() - t1
    print(f"  {name}: fused {total_s:.3f} s, {res.total_iterations} sweeps, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
          f"launches {launches}; "
          + ", ".join(f"{k} engine {v:.3f} s" for k, v in times.items())
          + " in this call")
    print(f"  reported Q {res.modularity:.9f}, host f64 Q {q_host:.9f}")
    return launches


def check_schedules_card_vs_cpu(scale: int) -> None:
    """Phase 13."""
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.louvain.coloring import (
        count_conflicts,
        multi_hash_coloring,
    )

    g = generate_rmat(scale)
    for kw in ([dict(et_mode=m) for m in (1, 2, 3, 4)]
               + [dict(coloring=8), dict(vertex_ordering=8)]):
        rg = louvain_phases(g, device="cuda", **kw)
        rc = louvain_phases(g, device="cpu", **kw)
        check_same_run(f"R-MAT {scale} {kw}", rg, rc)
        print(f"  {kw}: {len(rg.phases)} phases, iterations "
              f"{[p.iterations for p in rg.phases]}, Q "
              f"{rg.modularity:.9f} on card and CPU, labels identical")
    src, dst = g.sources().astype(np.int32), g.tails.astype(np.int32)
    cg, ng = multi_hash_coloring(src, dst, g.num_vertices, n_hash=4,
                                 device="cuda")
    cc, nc = multi_hash_coloring(src, dst, g.num_vertices, n_hash=4,
                                 device="cpu")
    if ng != nc or not np.array_equal(cg, cc):
        fail(f"R-MAT {scale}: card and CPU colors differ")
    bad = count_conflicts(src, dst, g.num_vertices, cg)
    if bad:
        fail(f"R-MAT {scale}: {bad} edges join two vertices of one color")
    print(f"  colors (4 hashes): {ng} slots, {int((cg >= 0).sum())} of "
          f"{g.num_vertices} vertices colored, equal on card and CPU, "
          "0 conflicting edges")


def run_schedule_paths(g, scale: int, results: dict | None = None) -> dict:
    """Phase 14; returns each run's launch counts.  ``results``: filled
    with each run's (LouvainResult, wall s) by name."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.evaluate.modularity import modularity
    from cuvite_tpu_torch.obs.convergence import convergence_summary

    out = {}
    for kw in (dict(et_mode=3), dict(coloring=8)):
        name = " ".join(f"{k}={v}" for k, v in kw.items())
        torch.cuda.synchronize()
        zero_kernel_counts()
        t0 = time.perf_counter()
        res = louvain_phases(g, **kw)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = kernel_counts()
        st0 = res.phases[0].stages
        plans = "class plans" if "color" in st0 else "one plan"
        iterate = sum(p.stages.get("iterate", 0.0) for p in res.phases)
        print(f"  {name}: total {total_s:.3f} s, {res.total_iterations} "
              f"sweeps, phases {len(res.phases)}, Q {res.modularity:.9f}; "
              f"phase 0: color {st0.get('color', 0.0):.3f} s, plan "
              f"{st0['plan']:.3f} s ({plans}), iterate "
              f"{st0['iterate']:.3f} s; every phase's sweeps "
              f"{iterate:.3f} s; launches {launches}")
        for c in convergence_summary(res.convergence):
            print(f"    convergence {c}")
        if launches["row_argmax"] == 0 or launches["heavy_bincount"] == 0:
            fail(f"R-MAT {scale} {name}: the row or heavy kernel never "
                 f"launched ({launches})")
        q_host = modularity(g, res.communities)
        if abs(q_host - res.modularity) > 1e-6:
            fail(f"R-MAT {scale} {name}: reported Q {res.modularity} vs "
                 f"host f64 {q_host}")
        out[f"{name} R-MAT {scale}"] = launches
        if results is not None:
            results[name] = (res, total_s)
    return out


def check_class_sweeps(g, scale: int, n: int = 8) -> None:
    """Phase 14's kernels at the shapes its coloring run sends them: the
    run's class plans, rebuilt from the same coloring, each swept by
    ``bucketed_step`` on the card and by the twins on the CPU from the
    same assignment.  Two iterations: the run's first (from the identity,
    community tables refreshed per class) and one with vertex ordering's
    tables frozen at the iteration start.  Target and counter0 must be
    bit-equal on every plan."""
    import torch

    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.louvain.bucketed import (
        DevicePlan,
        bucketed_step,
        build_class_plans,
    )
    from cuvite_tpu_torch.louvain.driver import _color_classes

    t0 = time.perf_counter()
    dg = DistGraph.build(g)
    nv = dg.nv_pad
    cls, n_classes = _color_classes(g, dg, n, "cuda", False)
    plans = build_class_plans(dg.src, dg.dst, dg.w, cls, n_classes,
                              nv_local=nv)
    vdeg = torch.from_numpy(dg.padded_weighted_degrees()).float()
    vdeg_d = vdeg.cuda()
    const = 1.0 / dg.graph.total_edge_weight_twice()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    work = torch.arange(nv, dtype=torch.int32)
    hub_plans = 0
    for it, frozen in ((0, False), (1, True)):
        info = work.clone() if frozen else None
        moved = 0
        for c, plan in enumerate(plans):
            ref = bucketed_step(DevicePlan.upload(plan, "cpu"), work, vdeg,
                                const, nv_total=nv, info_comm=info)
            got = bucketed_step(
                DevicePlan.upload(plan, "cuda"), work.cuda(), vdeg_d, const,
                nv_total=nv, info_comm=None if info is None else info.cuda())
            if not (torch.equal(got.target.cpu(), ref.target)
                    and torch.equal(got.counter0.cpu(), ref.counter0)):
                fail(f"R-MAT {scale} class {c} of {n_classes}, iteration "
                     f"{it}: the kernels' sweep differs from the twins'")
            moved += int(ref.n_moved)
            hub_plans += int(it == 0 and plan.has_heavy)
            work = ref.target
        print(f"  class sweep {it} ({'frozen' if frozen else 'refreshed'} "
              f"tables): {n_classes} class plans, {moved} moves, target and "
              "counter0 bit-equal on card and CPU")
    print(f"  {hub_plans} of {n_classes} class plans hold hubs; plans "
          f"rebuilt in {build_s:.3f} s, checks "
          f"{time.perf_counter() - t0 - build_s:.3f} s")
    if hub_plans == 0:
        fail(f"R-MAT {scale}: no class plan holds a hub, so the heavy "
             "kernel went unchecked at class-plan shapes")


# ---------------------------------------------------------------------------
# Phases 15-18: the batched engine (louvain_many) and device re-binning.


def fold_rows(cases, dev):
    """Fold single-tenant row cases (built on the CPU) into one batch:
    tenant t's vertex v becomes t * nv_pad + v, nv_pad the power of two
    above every case's table.  Padding rows are dropped (a device plan
    holds none).  Returns (tensors, [T] f32 constants, row degrees)."""
    import torch

    nvp = 1 << (max(len(c[0][3]) for c in cases) - 1).bit_length()
    parts = [[] for _ in range(7)]
    degs, consts = [], []
    for t, (args, const, deg) in enumerate(cases):
        dst, w, verts, comm, comm_deg, vdeg, sl = (a.numpy() for a in args)
        keep = verts < len(comm)
        off = t * nvp
        own = np.arange(len(comm), nvp, dtype=np.int64)
        parts[0].append(dst[keep] + off)
        parts[1].append(w[keep])
        parts[2].append(verts[keep] + off)
        parts[3].append(np.concatenate([comm, own]) + off)
        for k, tab in ((4, comm_deg), (5, vdeg), (6, sl)):
            parts[k].append(np.concatenate(
                [tab, np.zeros(nvp - len(tab), np.float32)]))
        degs.append(np.full(int(keep.sum()), dst.shape[1]) if deg is None
                    else deg.numpy()[keep])
        consts.append(const)
    dtypes = (np.int32, np.float32, np.int32, np.int32, np.float32,
              np.float32, np.float32)
    t = [torch.from_numpy(np.concatenate(p).astype(d)).to(dev)
         for p, d in zip(parts, dtypes)]
    return (t, torch.tensor(consts, dtype=torch.float32, device=dev),
            torch.from_numpy(np.concatenate(degs).astype(np.int32)).to(dev))


def fold_hubs(cases, dev):
    """Fold single-tenant hub cases (built on the CPU) into one layout.
    Returns (layout, tables, [T] f32 constants, nv_pad, real vertices: the
    cases' own table lengths, the fold's padding not counted)."""
    import torch

    from cuvite_tpu_torch.kernels.heavy_bincount import build_heavy_layout

    nvp = 1 << (max(len(c[1][0]) for c in cases) - 1).bit_length()
    src, dst, w, tabs, consts = [], [], [], [[], [], [], []], []
    for t, (lay, tb, const) in enumerate(cases):
        off = t * nvp
        counts = (lay.offsets[1:] - lay.offsets[:-1]).numpy()
        src.append(np.repeat(lay.verts.numpy().astype(np.int64), counts)
                   + off)
        dst.append(lay.dst.numpy().astype(np.int64) + off)
        w.append(lay.w.numpy())
        comm, comm_deg, vdeg, sl = (a.numpy() for a in tb)
        tabs[0].append(np.concatenate(
            [comm, np.arange(len(comm), nvp)]) + off)
        for k, tab in ((1, comm_deg), (2, vdeg), (3, sl)):
            tabs[k].append(np.concatenate(
                [tab, np.zeros(nvp - len(tab), np.float32)]))
        consts.append(const)
    lay = build_heavy_layout(np.concatenate(src), np.concatenate(dst),
                             np.concatenate(w),
                             nv_local=len(cases) * nvp).to(dev)
    t = [torch.from_numpy(np.concatenate(p).astype(d)).to(dev)
         for p, d in zip(tabs, (np.int32, np.float32, np.float32,
                                np.float32))]
    real = sum(len(tb[0]) for _, tb, _ in cases)
    return (lay, t, torch.tensor(consts, dtype=torch.float32, device=dev),
            nvp, real)


def check_batched_kernels(dev) -> dict:
    """Phase 15: each batched form against its twin on the card, bit for
    bit.  Returns the batched heavy launch's timing."""
    import torch

    from cuvite_tpu_torch.kernels.heavy_bincount import (
        heavy_argmax,
        heavy_argmax_plain,
    )
    from cuvite_tpu_torch.kernels.row_argmax import (
        row_argmax,
        row_argmax_plain,
    )
    from cuvite_tpu_torch.ops.segment import coalesced_runs

    cpu = torch.device("cpu")
    for width in (8, 16, 32, 64, 256, 384, 1024, 4096, 8192):
        tie = tie_row_case(width, cpu)
        cases = [row_case(width, width, cpu),
                 hot_row_case(width, width + 1, cpu), (*tie, None)]
        args, consts, deg = fold_rows(cases, dev)
        got = row_argmax(*args, consts, deg)
        check_same(f"batched row_argmax width {width}", got,
                   row_argmax_plain(*args, consts, deg))
        nvp = args[3].numel() // 3
        if (int(got[0][-1]) != 2 * nvp + 3
                or float(got[1][-1]) != 0.0):
            fail(f"batched row_argmax width {width}: the tie tenant's row "
                 f"moved to {int(got[0][-1])} at {float(got[1][-1])}")
    print("  row_argmax: rows of 3 tenants (seeded, hot-key, zero-gain "
          "tie; constants 1/123457, 1/7919, 1/64) in one launch per "
          "width, 8 ... 8192, bit-equal to the twin")
    lay, tabs, consts, nvp, real_nv = fold_hubs(
        [hot_heavy_case(12, cpu), tie_hub_case(cpu)], dev)
    got = heavy_argmax(lay, *tabs, consts)
    ref = heavy_argmax_plain(lay, *tabs, consts)
    check_same("batched heavy_argmax", got, ref)
    if not lay.scratch.is_clean():
        fail("batched heavy_argmax: the scratch was left dirty")
    check_same("batched heavy_argmax, second launch",
               heavy_argmax(lay, *tabs, consts), got)
    if int(got[0][-1]) != nvp + 3 or float(got[1][-1]) != 0.0:
        fail("batched heavy_argmax: the tie tenant's hub is wrong")
    e = lay.dst.numel()
    # comm and comm_deg: at most one read per edge, and only of the
    # tenants' real vertices (no edge points into the fold's padding).
    hub_bytes = e * 8 + lay.num_hubs * HUB_BYTES + 2 * 4 * min(e, real_nv)
    b_ms, b_by = bound(hub_bytes, 8 * e)
    heavy = {"ms": time_ms(lambda: heavy_argmax(lay, *tabs, consts), 20),
             "plain_ms": time_ms(
                 lambda: heavy_argmax_plain(lay, *tabs, consts), 3),
             "bound_ms": b_ms, "bound_by": b_by, "bytes": hub_bytes,
             "hubs": lay.num_hubs, "edges": e, "tenants": 2,
             "real_vertices": real_nv,
             "shape": "phase 15: hot-key hubs (2^18-edge hub included) "
                      "and a zero-gain tie hub, two tenants"}
    print(f"  heavy_argmax: {lay.num_hubs} hubs of 2 tenants, {e} edges, "
          f"one launch, bit-equal to the twin twice, scratch clean; "
          f"{heavy['ms']:.4f} ms (twin {heavy['plain_ms']:.4f} ms, bound "
          f"{b_ms:.4f} ms)")
    rows = [coalesce_case(1024, 1 << 14, 1024 + i, i == 1,
                          "float" if i == 2 else "dyadic", cpu)
            for i in range(3)]
    rows.append([torch.full((1 << 14,), 1024, dtype=torch.int32),
                 torch.zeros(1 << 14, dtype=torch.int32),
                 torch.zeros(1 << 14)])
    src, dst, w = (torch.stack(a).to(dev) for a in zip(*rows))
    s2, d2, w2, n2 = check_pipeline("batched, 4 tenants", (src, dst, w),
                                    1024, 1024)
    for i in range(4):
        ref = coalesced_runs(src[i], dst[i], w[i], nv_pad=1024)
        if not rows_equal((s2[i], d2[i], w2[i], int(n2[i])), ref):
            fail(f"batched seg_coalesce tenant {i}: rows differ from the "
                 "sort engine's")
    if int(n2[3]) != 0:
        fail("batched seg_coalesce: the padding tenant emitted rows")
    print(f"  seg_coalesce: 4 tenants (gapped ids, float weights, one pure "
          f"padding) in one launch, bit-equal to the twin, rows "
          f"{n2.tolist()} equal to the sort engine's per tenant")
    return heavy


def serving_jobs(kind: str) -> list:
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    edges, count = {"serving 4096": (4096, 64),
                    "serving 65536": (65536, 64),
                    "serving 2^20": (1 << 20, 16)}[kind]
    return [synthesize_graph(edges, seed=many_seed(1, k))
            for k in range(count)]


def check_many_card_vs_cpu(g_golden, truth_path) -> dict:
    """Phase 16; returns the card runs' launch counts."""
    from cuvite_tpu_torch import louvain_many, louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.workloads.golden import measure_run, verify
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    gs = [generate_rmat(8, edge_factor=8, seed=s) for s in (1, 2)]
    gs += [synthesize_graph(2048, seed=many_seed(7, k)) for k in (0, 1)]
    out = {}
    for engine in ("fused", "bucketed"):
        zero_kernel_counts()
        rg = louvain_many(gs, engine=engine)
        out[f"louvain_many {engine}, job set of 4"] = kernel_counts()
        rc = louvain_many(gs, engine=engine, device="cpu")
        if rg.phase_engines != rc.phase_engines:
            fail(f"louvain_many {engine}: phase engines differ "
                 f"{rg.phase_engines} vs {rc.phase_engines}")
        for k, (g, a, b) in enumerate(zip(gs, rg.results, rc.results)):
            check_same_run(f"louvain_many {engine} tenant {k}", a, b)
            solo = louvain_many([g], engine=engine).results[0]
            if not (np.array_equal(solo.communities, a.communities)
                    and solo.modularity == a.modularity):
                fail(f"louvain_many {engine} tenant {k}: differs from its "
                     "B=1 run on the card")
        print(f"  {engine}: phases {rg.phase_engines}, coalesce "
              f"{rg.coalesce}, per tenant phases "
              f"{[len(r.phases) for r in rg.results]} and Q "
              f"{[round(r.modularity, 9) for r in rg.results]}: labels equal"
              f" to the CPU run and to each tenant's B=1 run; launches "
              f"{out[f'louvain_many {engine}, job set of 4']}")
    for engine in ("bucketed", "fused"):
        res = louvain_phases(g_golden, engine=engine)
        m = measure_run(res.communities, res, truth_path=truth_path,
                        provenance="synthesized")
        ok, problems = verify("powerlaw-test", "default", m)
        if not ok:
            fail(f"powerlaw-test/default envelope, {engine}: {problems}")
        print(f"  powerlaw-test/default ({engine}, on the card): Q "
              f"{m['modularity']:.6f}, {m['phases']} phases, "
              f"{m['communities']} communities, F-score {m['f_score']:.6f}:"
              " inside the envelope")
    return out


def run_serving(kind: str, gs: list) -> dict:
    """Phase 17 on one job set, both engines.  Returns each run's launch
    counts, and the bucketed run's first batched coarsening (its relabeled
    slab, nv_pad, grid and engine) for timing."""
    import torch

    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.evaluate.modularity import modularity
    from cuvite_tpu_torch.ops import segment as seg

    captured = []
    batched = seg.coalesced_runs_batched

    def observed(src, ckey, w, *, nv_pad, engine="sort", grid=None):
        if not captured:
            captured.append((src, ckey, w, nv_pad, grid, engine))
        return batched(src, ckey, w, nv_pad=nv_pad, engine=engine, grid=grid)

    out = {}
    for engine in ("bucketed", "fused"):
        seg.coalesced_runs_batched = observed
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_kernel_counts()
            t0 = time.perf_counter()
            br = louvain_many(gs, engine=engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_counts()
        finally:
            seg.coalesced_runs_batched = batched
        bad = [k for k, (g, r) in enumerate(zip(gs, br.results))
               if abs(modularity(g, r.communities) - r.modularity) > 1e-6]
        if bad:
            fail(f"{kind} {engine}: tenants {bad[:8]} report a Q more than "
                 "1e-6 from the host f64 modularity of their labels")
        qs = [r.modularity for r in br.results]
        out[f"{kind} {engine}"] = launches
        print(f"  {kind} {engine}: B={br.n_jobs} class {br.slab_class}, "
              f"wall {wall:.3f} s (pack {br.pack_s:.3f} s), "
              f"{br.n_jobs / wall:.1f} jobs/s, {br.n_phases} phases, "
              f"sweeps {br.sweeps} ({sum(br.sweeps)}), engines "
              f"{br.phase_engines}, coarse class {br.coarse_class}, coalesce"
              f" {br.coalesce}, launches {launches}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} B, Q min/median/max "
              f"{min(qs):.6f}/{float(np.median(qs)):.6f}/{max(qs):.6f}, "
              "every Q within 1e-6 of the host f64 modularity")
    return out, captured


def time_batched_rows(gs) -> dict:
    """The row kernel's batched form at a serving batch's phase-0 plan,
    identity assignment: one sweep's class launches (every tenant in one
    launch per class) beside the twin and the bound."""
    import torch

    from cuvite_tpu_torch.core.batch import (
        batch_bucket_plans,
        batch_slabs,
        fold_slab,
    )
    from cuvite_tpu_torch.kernels.row_argmax import (
        row_argmax,
        row_argmax_plain,
        vertex_table,
    )
    from cuvite_tpu_torch.louvain.batched import _constants
    from cuvite_tpu_torch.louvain.bucketed import DevicePlan
    from cuvite_tpu_torch.ops.segment import segment_sum

    batch = batch_slabs(gs)
    plan = DevicePlan.upload(batch_bucket_plans(batch).fold(), "cuda")
    nv = batch.b_pad * batch.nv_pad
    consts = _constants(batch.tw2, "cuda").c32
    src, _, w = fold_slab(*(torch.from_numpy(a).cuda() for a in
                            (batch.src, batch.dst, batch.w)),
                          nv_pad=batch.nv_pad)
    vdeg = torch.zeros(nv + 1, dtype=torch.float64, device="cuda")
    vdeg.index_add_(0, src.long(), w.double())
    vdeg = vdeg[:nv].float()
    comm = torch.arange(nv, dtype=torch.int32, device="cuda")
    comm_deg = segment_sum(vdeg.double(), comm, nv).float()
    tables = (comm, comm_deg, vdeg, plan.self_loop)

    def rows(fn):
        extra = (vertex_table(*tables),) if fn is row_argmax else ()
        return [fn(d, w, v, *tables, consts, dg, *extra)
                for v, d, w, dg in plan.buckets]

    err = max(max_abs_err(a, b) for a, b in zip(rows(row_argmax),
                                                rows(row_argmax_plain)))
    if err != 0.0:
        fail(f"batched row_argmax differs from its twin at the serving "
             f"plan (max abs err {err})")
    slots = int(sum(int(dg.sum()) for _, _, _, dg in plan.buckets))
    n_rows = sum(v.numel() for v, _, _, _ in plan.buckets)
    ms = time_ms(lambda: rows(row_argmax), 20)
    # comm and comm_deg: at most one read per slot, and only of the
    # tenants' real vertices (no slot points into a tenant's padding).
    real_nv = int(batch.nv_real.sum())
    row_bytes = slots * 8 + n_rows * ROW_BYTES + 2 * 4 * min(slots, real_nv)
    b_ms, b_by = bound(row_bytes, 8 * slots)
    return {"ms": ms, "ms_per_launch": ms / len(plan.buckets),
            "launches_per_sweep": len(plan.buckets),
            "plain_ms": time_ms(lambda: rows(row_argmax_plain), 3),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": row_bytes,
            "rows": n_rows, "real_slots": slots, "tenants": batch.n_jobs,
            "real_vertices": real_nv,
            "shape": f"phase 0 of B={batch.n_jobs} class "
                     f"{batch.slab_class}, identity assignment, one sweep "
                     "of every class (vertex_table included)"}


def time_batched_coalesce(captured, what: str) -> dict:
    """seg_coalesce's batched form at a serving batch's first dense
    coarsening: the whole coalesce against its twin (bit for bit), the
    sort engine on the same slab, and the recounted bound."""
    from cuvite_tpu_torch.kernels.seg_coalesce import (
        seg_coalesce,
        seg_coalesce_plain,
    )
    from cuvite_tpu_torch.ops.segment import coalesced_runs_batched

    src, dst, w, nv_pad, grid, engine = captured[0]
    if engine != "dense":
        fail(f"{what}: the first coarsening took {engine!r}, not 'dense'")
    check_pipeline(f"at {what}", (src, dst, w), nv_pad, grid)
    b_ms, b_by, n_bytes, rows = coalesce_bound(src, grid)
    return {"ms": time_ms(lambda: seg_coalesce(
                src, dst, w, nv_pad=nv_pad, grid=grid), 20),
            "plain_ms": time_ms(lambda: seg_coalesce_plain(
                src, dst, w, nv_pad=nv_pad, grid=grid), 5),
            "sort_engine_ms": time_ms(lambda: coalesced_runs_batched(
                src, dst, w, nv_pad=nv_pad, engine="sort", grid=grid), 20),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "alloc_bytes": peak_bytes(lambda: seg_coalesce(
                src, dst, w, nv_pad=nv_pad, grid=grid)),
            "tenants": src.shape[0], "grid": grid, "nv_pad": nv_pad,
            "slab_rows": src.numel(), "real_rows": rows, "max_abs_err": 0.0,
            "shape": f"{what}: the first dense batched coarsening, the "
                     "whole coalesce"}


def check_rebin_card_vs_cpu(graphs: dict) -> dict:
    """Phase 18, first half: per-graph bucketed runs with device
    re-binning, card against CPU and against CUVITE_DEVICE_REBIN=0, and on
    each graph's phase-1 plan built on the card the kernels' sweeps
    against the twins' (:func:`check_rebinned_sweeps`).  ``graphs``:
    name -> (graph, whether its weights are integers).  Returns the card
    runs' launch counts."""
    from cuvite_tpu_torch import louvain_phases

    out = {}
    for name, (g, integer) in graphs.items():
        zero_kernel_counts()
        rg = louvain_phases(g, device="cuda")
        out[f"bucketed with device re-binning, {name}"] = kernel_counts()
        rc = louvain_phases(g, device="cpu")
        check_same_run(f"{name} re-binned", rg, rc)
        os.environ["CUVITE_DEVICE_REBIN"] = "0"
        try:
            roff = louvain_phases(g, device="cuda")
        finally:
            del os.environ["CUVITE_DEVICE_REBIN"]
        check_same_run(f"{name} re-binned vs CUVITE_DEVICE_REBIN=0", rg,
                       roff)
        if not rg.rebinned_phases or roff.rebinned_phases:
            fail(f"{name}: re-binned phases {rg.rebinned_phases}, with "
                 f"CUVITE_DEVICE_REBIN=0 {roff.rebinned_phases}")
        print(f"  {name}: {len(rg.phases)} phases, iterations "
              f"{[p.iterations for p in rg.phases]}, phases "
              f"{rg.rebinned_phases} re-binned on the card; labels equal on "
              "card, CPU and CUVITE_DEVICE_REBIN=0")
        check_rebinned_sweeps(g, name, integer)
    return out


def check_rebinned_sweeps(g, name: str, integer: bool) -> None:
    """The phase-1 graph of ``g``: its plan built on the card equals the
    host plan, and two bucketed sweeps on it run on the kernels (card)
    and on the twins (CPU) from the same assignments.

    Targets must be equal.  counter0: on integer weights (the exactness
    domain) bit-equal; otherwise the kernels sum a row's weights in
    another order than the twins (table atomics, shuffle trees, hub
    chunks), and two f32 sums of the same n addends in any two orders
    differ by at most 2 (n - 1) 2^-24 sum|w| (the recursive-summation
    bound, twice), which is the tolerance, per vertex, with n its degree.
    The reading (targets differing, counter0 values differing, the
    largest difference and its share of the tolerance) is printed."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.coarsen.rebin import device_plan
    from cuvite_tpu_torch.coarsen.rebuild import (
        coarsen_graph,
        renumber_communities,
    )
    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.louvain.bucketed import (
        BucketPlan,
        DevicePlan,
        bucketed_step,
    )
    from cuvite_tpu_torch.ops.segment import TenantConstants

    res1 = louvain_phases(g, device="cuda", max_phases=1)
    dense, nc = renumber_communities(res1.communities)
    cg = coarsen_graph(g, dense, nc)
    dg = DistGraph.build(cg)
    nv = dg.nv_pad
    got_plan = device_plan(*dg.device_slab("cuda"), nv_local=nv)
    want = DevicePlan.upload(BucketPlan.build(dg.src, dg.dst, dg.w,
                                              nv_local=nv), "cpu")
    for gb, wb in zip(got_plan.buckets, want.buckets):
        if not all(bits_equal(x, y) for x, y in zip(gb, wb)):
            fail(f"{name}: the re-binned plan differs from the host's")
    real = dg.src < nv
    src = dg.src[real].astype(np.int64)
    deg = np.bincount(src, minlength=nv)
    absw = np.bincount(src, weights=np.abs(dg.w[real].astype(np.float64)),
                       minlength=nv)
    tol = torch.from_numpy(2.0 * np.maximum(deg - 1, 0) * 2.0 ** -24 * absw)
    vdeg = torch.from_numpy(dg.padded_weighted_degrees()).float()
    const = 1.0 / cg.total_edge_weight_twice()
    cpu_c = TenantConstants.of(const, "cpu")
    card_c = TenantConstants.of(const, "cuda")
    work = torch.arange(nv, dtype=torch.int32)
    for it in range(2):
        ref = bucketed_step(want, work, vdeg, cpu_c, nv_total=nv)
        got = bucketed_step(got_plan, work.cuda(), vdeg.cuda(), card_c,
                            nv_total=nv)
        n_target = int((got.target.cpu() != ref.target).sum())
        diff = (got.counter0.cpu().double() - ref.counter0.double()).abs()
        n_c0 = int((diff > 0).sum())
        share = float((diff / tol.clamp(min=1e-300)).max()) if n_c0 else 0.0
        print(f"    {name} re-binned plan, sweep {it}: {n_target} targets "
              f"differ of {nv}; counter0 differs at {n_c0} vertices, max "
              f"|diff| {float(diff.max()):.9g}, largest share of the "
              f"tolerance {share:.6g}; moves {int(ref.n_moved[0])} / "
              f"{int(got.n_moved[0])}")
        if n_target:
            fail(f"{name}: {n_target} targets of the kernels' sweep of the "
                 "re-binned plan differ from the twins'")
        if (n_c0 if integer else share > 1.0):
            fail(f"{name}: counter0 of the kernels' sweep of the re-binned "
                 "plan differs from the twins' beyond "
                 + ("0 (integer weights)" if integer else
                    "the reordering bound"))
        work = ref.target
    print(f"  {name} phase-1 graph ({cg.num_vertices} vertices, "
          f"{cg.num_edges} edges): the card's re-binned plan equals the "
          f"host plan ({len(want.buckets)} classes); two sweeps on the "
          "kernels give the twins' targets, counter0 "
          + ("bit-equal" if integer else "within the reordering bound"))


def run_rebin_full(g, name: str) -> dict:
    """Phase 18, second half: the bucketed engine at full size with device
    re-binning on, then off; the re-binned phases' rebin seconds against
    the same phases' host plan seconds."""
    import torch

    from cuvite_tpu_torch import louvain_phases

    runs = {}
    for label, env in (("on", None), ("off", "0")):
        if env is not None:
            os.environ["CUVITE_DEVICE_REBIN"] = env
        try:
            torch.cuda.synchronize()
            zero_kernel_counts()
            t0 = time.perf_counter()
            res = louvain_phases(g)
            torch.cuda.synchronize()
            runs[label] = (res, time.perf_counter() - t0, kernel_counts())
        finally:
            os.environ.pop("CUVITE_DEVICE_REBIN", None)
    on, off = runs["on"][0], runs["off"][0]
    check_same_run(f"{name} re-binning on vs off", on, off)
    rb = [p for p in on.phases if "rebin" in p.stages]
    rebin_s = sum(p.stages["rebin"] for p in rb)
    host_s = sum(off.phases[p.phase].stages["plan"] for p in rb)
    for p in on.phases:
        print(f"  phase {p.phase}: nv {p.num_vertices} ne {p.num_edges} "
              f"iterations {p.iterations} plan {p.stages['plan']:.4f} s"
              + (f" (rebin {p.stages['rebin']:.4f} s; host plan with "
                 "CUVITE_DEVICE_REBIN=0 "
                 f"{off.phases[p.phase].stages['plan']:.4f} s)"
                 if "rebin" in p.stages else " (host plan)"))
    print(f"  {name}: {len(on.phases)} phases, re-binned phases "
          f"{on.rebinned_phases}: rebin {rebin_s:.4f} s against "
          f"{host_s:.4f} s of host plans in the same phases; wall "
          f"{runs['on'][1]:.3f} s on, {runs['off'][1]:.3f} s off; labels "
          "equal")
    return {f"bucketed {name}, re-binning on": runs["on"][2]}


# ---------------------------------------------------------------------------
# Phases 19-21: sub-row packing and the serving layer.

SMALL_CLASS = (4096, 16384)
ROW_CLASS = (8192, 32768)


def hub_graph(nv: int, hub: int, seed: int):
    """A ring plus a hub at vertex ``hub`` (the reference's seam case,
    tests/test_subrow.py:115-128)."""
    from cuvite_tpu_torch import Graph

    rng = np.random.default_rng(seed)
    spokes = rng.choice(nv - 1, size=nv // 8, replace=False)
    spokes = np.where(spokes >= hub, spokes + 1, spokes) % nv
    src = np.concatenate([np.arange(nv), np.full(spokes.size, hub),
                          rng.integers(0, nv, 64)])
    dst = np.concatenate([(np.arange(nv) + 1) % nv, spokes,
                          rng.integers(0, nv, 64)])
    keep = src != dst
    return Graph.from_edges(nv, src[keep], dst[keep])


def check_subrow() -> dict:
    """Phase 19: merged batches on the card against the CPU and B=1, with
    every phase's community ids checked against their fences."""
    import torch

    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.core.batch import (
        batch_pad,
        slab_class_of,
        subrow_layout_for,
    )
    from cuvite_tpu_torch.louvain import batched
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    layout = subrow_layout_for(SMALL_CLASS, ROW_CLASS)
    cases = {
        "synth 1024 x 16": [synthesize_graph(1024, seed=many_seed(3, k))
                            for k in range(16)],
        "seam hubs at ids 4095 and 4096": [hub_graph(4096, 4095, 1),
                                           hub_graph(4096, 0, 2)],
    }
    fences = []
    tail = batched._phase_tail

    def fenced_tail(slab, past, *a, **kw):
        # past holds each sub-row's labels in its own ids: a community
        # id from across a seam would fall outside [0, nv_sub).
        real = slab.real_mask
        lo = int(torch.where(real, past, 0).min())
        hi = int(torch.where(real, past, 0).max())
        fences.append((lo, hi, slab.nv_pad))
        return tail(slab, past, *a, **kw)

    out = {}
    for name, gs in cases.items():
        if {slab_class_of(g) for g in gs} != {SMALL_CLASS}:
            fail(f"phase 19 {name}: tenants not of class {SMALL_CLASS}")
        for engine in ("bucketed", "fused"):
            fences.clear()
            batched._phase_tail = fenced_tail
            try:
                zero_kernel_counts()
                t0 = time.perf_counter()
                br = batched.cluster_packed(gs, layout, engine=engine)
                wall = time.perf_counter() - t0
                launches = kernel_counts()
            finally:
                batched._phase_tail = tail
            bad = [f for f in fences if f[0] < 0 or f[1] >= f[2]]
            if bad or not fences:
                fail(f"phase 19 {name} {engine}: community ids outside "
                     f"their fences {bad}")
            rc = batched.cluster_packed(gs, layout, engine=engine,
                                        device="cpu")
            for k, (g, a, b) in enumerate(zip(gs, br.results, rc.results)):
                check_same_run(f"merged {name} {engine} tenant {k}", a, b)
                solo = louvain_many([g], engine=engine).results[0]
                if not (np.array_equal(solo.communities, a.communities)
                        and solo.modularity == a.modularity):
                    fail(f"merged {name} {engine} tenant {k}: differs from "
                         "its B=1 run on the card")
            if (br.b_pad, br.n_sub, br.slab_class) != (
                    batch_pad(-(-len(gs) // 2)), 2, ROW_CLASS):
                fail(f"merged {name}: geometry {br.b_pad}, {br.n_sub}, "
                     f"{br.slab_class}")
            key = f"merged {name}, {engine}"
            out[key] = launches
            print(f"  {key}: {br.b_pad} rows of {br.slab_class}, n_sub "
                  f"{br.n_sub}, phases {br.phase_engines}, coarse class "
                  f"{br.coarse_class}, wall {wall:.3f} s, {len(fences)} "
                  f"phase ends with every id inside its fence, launches "
                  f"{launches}: labels equal to the CPU run and to each "
                  "tenant's B=1 run")
    return out


def run_cli_demo(engine: str, direct) -> dict:
    """Phase 20, first half: ``serve demo`` through ``main(argv)``."""
    import contextlib
    import io

    import torch

    from cuvite_tpu_torch.serve import __main__ as cli

    def warm_then_reset(server):
        # The CLI's warm-up batch is not the served path: the peak starts
        # after it, as the launch counts do (the CLI zeroes them).
        out = real_warm(server)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return out

    buf = io.StringIO()
    real_warm = cli._warm
    cli._warm = warm_then_reset
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["demo", "--jobs", "64", "--edges", "4096",
                           "--b-max", "64", "--json", "--engine", engine])
    finally:
        cli._warm = real_warm
    launches = kernel_counts()
    if rc:
        fail(f"serve demo ({engine}) exited {rc}")
    if launches["seg_coalesce"] == 0 or (engine == "bucketed"
                                         and launches["row_argmax"] == 0):
        fail(f"serve demo ({engine}): a kernel of the path never launched "
             f"{launches}")
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    rows, summary = lines[:-1], lines[-1]["summary"]
    if len(rows) != 64 or summary["jobs_done"] != 64:
        fail(f"serve demo ({engine}): {len(rows)} results, {summary}")
    for row in rows:
        k = int(row["job"].split("-")[1])
        ref = direct.results[k]
        want = (round(ref.modularity, 6), ref.num_communities,
                len(ref.phases), ref.total_iterations)
        got = (row["q"], row["communities"], row["phases"],
               row["iterations"])
        if got != want:
            fail(f"serve demo ({engine}) {row['job']}: {got} against "
                 f"louvain_many's {want}")
    print(f"  serve demo --engine {engine}: {summary['batches']} batch, "
          f"wall {summary['wall_s']} s, {summary['wall_jobs_per_s']} jobs/s "
          f"(busy {summary['jobs_per_s']} jobs/s), wait p50/p95 "
          f"{summary['wait_p50_ms']}/{summary['wait_p95_ms']} ms, pack "
          f"{summary['pack_s']} s, exec {summary['device_s']} s, launches "
          f"{launches}, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; every tenant's Q, "
          "communities, phases and iterations equal louvain_many's")
    return launches


def check_queue_labels(gs, engine: str, direct) -> None:
    """The same 64 jobs through the library API: labels bit for bit."""
    from cuvite_tpu_torch.serve import LouvainServer, ServeConfig

    srv = LouvainServer(ServeConfig(b_max=64, linger_s=0.0, engine=engine))
    ids = [srv.submit(g, tenant=f"t{k % 4}") for k, g in enumerate(gs)]
    done = dict(srv.drain())
    for k, jid in enumerate(ids):
        a, b = done[jid], direct.results[k]
        if not (np.array_equal(a.communities, b.communities)
                and a.modularity == b.modularity):
            fail(f"LouvainServer ({engine}) job {k}: labels differ from "
                 "louvain_many's")
    if not srv.conservation()["ok"]:
        fail(f"LouvainServer ({engine}): {srv.conservation()}")


def run_mix(merge: bool, smalls, bigs) -> tuple:
    """Phase 20, second half: one arm of an overload setting chosen to
    force merges -- the reference's 90:10 pools (``tools/serve_load.py``)
    offered at 2,000 jobs/s with b_max 4 on the bucketed engine, not the
    reference's mix (20 jobs/s on its default engine)."""
    from cuvite_tpu_torch.serve import (
        AdmissionConfig,
        LouvainServer,
        ServeConfig,
    )
    from cuvite_tpu_torch.serve.loadgen import run_mixed_open_loop

    srv = LouvainServer(ServeConfig(
        b_max=4, linger_s=0.02, engine="bucketed", merge_packing=merge,
        admission=AdmissionConfig(wait_slo_s=0.5)))
    zero_kernel_counts()
    rep = run_mixed_open_loop(srv, smalls, bigs, rate=2000.0,
                              max_wall_s=300.0)
    launches = kernel_counts()
    r = rep.report
    if not r.conservation["ok"] or r.done + r.rejected != r.offered:
        fail(f"mix (merge {merge}): {r.conservation}, done {r.done}")
    per = rep.per_class
    print(f"  90:10 pools at 2000 jobs/s (overload), merge_packing "
          f"{'on' if merge else 'off'}: "
          f"{r.done} done, {r.rejected} rejected in {r.wall_s:.3f} s, "
          f"goodput "
          f"{r.goodput_jobs_per_s:.1f} jobs/s, merged_batches "
          f"{rep.merged_batches}, batches {r.stats['batches']}, pack_util "
          f"{rep.pack_util}, subrow_util {rep.subrow_util}, wait p95 small "
          f"{per['small']['wait_p95_s'] * 1e3:.3f} ms / big "
          f"{per['big']['wait_p95_s'] * 1e3:.3f} ms, pack "
          f"{r.stats['pack_s']} s, exec {r.stats['device_s']} s, launches "
          f"{launches}")
    return rep, launches


def check_mix() -> dict:
    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.core.batch import slab_class_of
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    smalls = [synthesize_graph(1024, seed=many_seed(1, k))
              for k in range(72)]
    bigs = [generate_rmat(13, edge_factor=2, seed=1000 + k)
            for k in range(8)]
    if (slab_class_of(smalls[0]), slab_class_of(bigs[0])) != (SMALL_CLASS,
                                                              ROW_CLASS):
        fail("phase 20 mix: pools not of classes (4096, 16384) and "
             "(8192, 32768)")
    out, labels = {}, {}
    for merge in (False, True):
        rep, out[f"serve 90:10 overload, merge {'on' if merge else 'off'}"] = \
            run_mix(merge, smalls, bigs)
        labels[merge] = dict(rep.report.results)
        if merge and rep.merged_batches < 1:
            fail("mix: the merged arm packed no merged batch")
    from cuvite_tpu_torch.serve.loadgen import mix_schedule

    # Job ids follow the arrival order of both arms ("job-<k>"); a job
    # admission rejected in one arm is held against B=1 in the other.
    order = [g for _, g in mix_schedule(smalls, bigs)]
    for k, g in enumerate(order):
        jid = f"job-{k}"
        got = [labels[m][jid] for m in (False, True) if jid in labels[m]]
        if not got:
            continue
        solo = louvain_many([g], engine="bucketed").results[0]
        for r in got:
            if not (np.array_equal(r.communities, solo.communities)
                    and r.modularity == solo.modularity):
                fail(f"mix {jid}: labels differ across arms or from B=1")
    both = labels[False].keys() & labels[True].keys()
    print(f"  every served job's labels and Q equal to its B=1 run on the "
          f"card, so identical across the arms ({len(both)} jobs served "
          "by both)")
    return out


def run_daemon(direct, pipeline: str) -> dict:
    """Phase 21: the daemon as a subprocess on the card, pipelined or
    serial (``--pipeline on|off``).  Returns the launches of the served
    jobs, from the daemon's ``stats`` reply (the CLI zeroes its counts
    after the warm-up batch, before the readiness line)."""
    import signal
    import socket
    import tempfile

    from cuvite_tpu_torch.workloads.synth import many_seed

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(dir=os.path.join(root, "build", "chip_smoke"))
    sock = os.path.join(tmp, "serve.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cuvite_tpu_torch.serve", "daemon",
         "--socket", sock, "--b-max", "16", "--fault-plan",
         "device:transient:n=1", "--pipeline", pipeline],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=root)
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        if not line:
            fail(f"daemon died before its readiness line: "
                 f"{proc.stderr.read()[-2000:]}")
        ready = json.loads(line)["ready"]
        print(f"  daemon ready after {time.perf_counter() - t0:.2f} s "
              f"(process start included): device {ready['device']}, kernel "
              f"build {ready['build_s']} s and warm-up batch "
              f"{ready['warm_s']} s before the readiness line, pipelined "
              f"{ready['pipelined']}")
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.connect(sock)
        conn.settimeout(300.0)
        lines = conn.makefile("r", encoding="utf-8")
        msgs = []

        def call(req):
            conn.sendall((json.dumps(req) + "\n").encode())
            while True:
                msg = json.loads(lines.readline())
                if "ok" in msg:
                    return msg
                msgs.append(msg)

        t1 = time.perf_counter()
        for k in range(64):
            ack = call({"op": "submit", "id": f"s{k}", "labels": True,
                        "tenant": f"t{k % 4}",
                        "synth": {"edges": 4096, "seed": many_seed(1, k)}})
            if not ack["ok"]:
                fail(f"daemon refused job {k}: {ack}")
        while sum("result" in m for m in msgs) < 64:
            msgs.append(json.loads(lines.readline()))
        served = time.perf_counter() - t1
        stats = call({"op": "stats"})
        proc.send_signal(signal.SIGTERM)
        while "serve_summary" not in msgs[-1]:
            line = lines.readline()
            if not line:
                break
            msgs.append(json.loads(line))
        conn.close()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if rc != 0:
        fail(f"daemon exited {rc}: {proc.stderr.read()[-2000:]}")
    summary = msgs[-1].get("serve_summary") if msgs else None
    if not summary or not summary["conservation"]["ok"] \
            or summary["retries"] < 1 or summary["jobs_done"] != 64:
        fail(f"daemon summary: {summary}")
    for m in msgs:
        if "result" in m:
            k = int(m["result"]["job_id"][1:])
            if m["result"]["labels"] != direct.results[k].communities.tolist():
                fail(f"daemon job s{k}: labels differ from the direct run")
    st, launches = stats["stats"], stats["kernels"]
    if launches["row_argmax"] == 0 or launches["seg_coalesce"] == 0:
        fail(f"daemon --pipeline {pipeline}: a kernel of the path never "
             f"launched {launches}")
    print(f"  --pipeline {pipeline}: 64 synth 4096 jobs served in "
          f"{served:.3f} s "
          f"({64 / served:.1f} jobs/s, submits and result lines included): "
          f"batches {st['batches']}, wait p50/p95 {st['wait_p50_ms']}/"
          f"{st['wait_p95_ms']} ms, pack {st['pack_s']} s, exec "
          f"{st['device_s']} s, overlap_frac {summary['overlap_frac']}, "
          f"retries {summary['retries']}, launches {launches}; SIGTERM: "
          f"exit 0, conservation {summary['conservation']}; every result "
          "equal to the direct run")
    return launches


# ---------------------------------------------------------------------------
# Phases 22-23: the bench harness, the command line and the flight
# recorder.

CLI_METRICS_KEYS = {"graph", "nv", "ne", "modularity", "communities",
                    "iterations", "phases", "seconds", "teps", "stages",
                    "rss_mb", "convergence", "compile_events",
                    "hbm_peak_by_buffer", "hbm_snapshots"}


def smi_card(line: str) -> tuple:
    """(name, power limit in W) of an ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` line."""
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return name, float(limit.split()[0])


def bench_start(argv: list) -> tuple:
    """Start ``python -m cuvite_tpu_torch.workloads bench ARGV`` in a child
    on the card; returns (the child, its start time)."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cuvite_tpu_torch.workloads", "bench",
         *argv], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, time.perf_counter()


def bench_finish(what: str, started: tuple, card: tuple) -> tuple:
    """Wait for a :func:`bench_start` child.  Fails unless it exits 0 with
    exactly one JSON line: a valid record with a checked guard, platform
    cuda, phase 1's card and non-negative stage seconds.  Returns
    (record, stderr, wall s)."""
    from cuvite_tpu_torch.workloads.bench import validate_record

    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{what}: bench did not end in 900 s")
    wall = time.perf_counter() - t0
    if proc.returncode:
        fail(f"{what}: bench exited {proc.returncode}: {stderr[-3000:]}")
    lines = stdout.strip().splitlines()
    if len(lines) != 1:
        fail(f"{what}: bench printed {len(lines)} lines on stdout")
    rec = json.loads(lines[0])
    problems = validate_record(rec)
    if problems:
        fail(f"{what}: invalid record {problems}")
    if rec["compile_guard"] != {"checked": True, "new_compiles": 0}:
        fail(f"{what}: guard {rec['compile_guard']}")
    if (rec["platform"], rec["device"], rec["power_limit_w"]) != \
            ("cuda", *card):
        fail(f"{what}: record on {rec['platform']} {rec['device']} "
             f"{rec['power_limit_w']} W, not phase 1's card {card}")
    if any(v < 0 for v in rec["stages"].values()):
        fail(f"{what}: negative stage seconds {rec['stages']}")
    print_record(what, rec, wall)
    return rec, stderr, wall


def bench_child(what: str, argv: list, card: tuple) -> tuple:
    """One bench child, alone on the card (:func:`bench_finish`)."""
    return bench_finish(what, bench_start(argv), card)


def print_record(what: str, rec: dict, wall: float) -> None:
    print(f"  {what}:")
    print(f"    {rec['metric']} {rec['value']} {rec['unit']} "
          f"(vs_baseline {rec['vs_baseline']})")
    print(f"    wall {wall:.3f} s (the whole command or call, set-up and "
          "warm-up included)")
    print(f"    peak_alloc_bytes {rec['peak_alloc_bytes']}")
    print(f"    spread {rec.get('spread')} over runs "
          f"{rec.get('teps_runs')}")
    for blk in ("batch", "serve", "mix"):
        if blk in rec:
            print(f"    {blk} {json.dumps(rec[blk])}")
    print(f"    stages {json.dumps(rec['stages'])}")
    print(f"    card {rec['device']}, {rec['power_limit_w']} W")


def stderr_json(what: str, err: str, prefix: str):
    for line in err.splitlines():
        if line.startswith(prefix):
            return json.loads(line[len(prefix):])
    fail(f"{what}: no '{prefix}' line on the child's stderr")


def check_guard_trip(scale: int) -> None:
    """Phase 22, the guard on the card: ``run_bench`` in this process,
    its first timed run pointed at a freshly emptied build directory, so
    that it must build and load the kernel libraries again."""
    import tempfile
    from pathlib import Path

    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.kernels import _build
    from cuvite_tpu_torch.workloads.bench import (
        BenchCompileGuardError,
        run_bench,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    empty = Path(tempfile.mkdtemp(dir=os.path.join(root, "build",
                                                   "chip_smoke")))
    g = generate_rmat(scale)
    calls = []
    saved_dir, saved_libs = _build.BUILD_DIR, dict(_build._LIBS)

    def factory():
        calls.append(1)
        if len(calls) == 2:
            _build.BUILD_DIR = empty
            _build._LIBS.clear()
        return g

    try:
        run_bench(factory, repeats=1, t_start=time.perf_counter())
    except BenchCompileGuardError as e:
        print(f"  guard tripped on R-MAT {scale} with an emptied build "
              f"directory: {e}; events {e.compile_log}")
        if not any(line.startswith("load ") for line in e.compile_log):
            fail(f"guard trip without a library load: {e.compile_log}")
    else:
        fail("the bench emitted a record although its first timed run "
             "built and loaded the kernels")
    finally:
        _build.BUILD_DIR = saved_dir
        _build._LIBS.clear()
        _build._LIBS.update(saved_libs)


# R-MAT scale of phase 22's bench and phase 23's traced runs: phase 5 times
# the main path at --scale already, so the bench's command line, guard and
# record run a depth below it, held against an in-process run of the same
# graph.
BENCH_SCALE = 18


def run_bench_reference(scale: int) -> tuple:
    """Phase 22's reference: ``louvain_phases`` on R-MAT ``scale`` in this
    process, launch counts zeroed just before.  Returns (graph, result,
    launches)."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rmat

    g = generate_rmat(scale)
    torch.cuda.synchronize()
    zero_kernel_counts()
    t0 = time.perf_counter()
    res = louvain_phases(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    print(f"  R-MAT {scale} in this process: {wall:.3f} s, {len(res.phases)} "
          f"phases, {res.total_iterations} sweeps, Q {res.modularity:.9f}, "
          f"launches {launches}")
    return g, res, launches


def run_bench_phase(card: tuple, scale: int, paths: dict) -> tuple:
    """Phase 22.  The R-MAT bench runs alone on the card at ``scale``; the
    two ``--batch`` benches and the serve bench, which check launches,
    guards and records but no time, then run as three concurrent children
    (their walls and rates share the card and the host).  Returns (the
    launch counts of the bench paths, the in-process reference run)."""
    out = {}
    t0 = time.perf_counter()
    g, ref, main_launches = run_bench_reference(scale)
    what = f"bench R-MAT {scale}"
    rec, err, _ = bench_child(what, ["--graph", "rmat", "--scale",
                                     str(scale), "--repeats", "2"], card)
    got = (rec["modularity"], rec["phases"], rec["iterations"])
    want = (round(ref.modularity, 6), len(ref.phases),
            ref.total_iterations)
    if got != want:
        fail(f"{what}: Q, phases, iterations {got}, in-process run {want}")
    cats = {"tables", "plans"} | ({"slab"} if rec.get("rebin_device")
                                  else set())
    if not cats <= set(rec["hbm_peak_by_buffer"]):
        fail(f"{what}: memory ledger {rec['hbm_peak_by_buffer']} lacks "
             f"{cats}")
    run1 = stderr_json(what, err, "# launches run 1: ")
    if run1 != main_launches:
        fail(f"{what}: timed run 1 launched {run1}, the in-process run "
             f"{main_launches}")
    calls = stderr_json(what, err, "# native calls run 1: ")
    if not all(calls[k] for k in ("plan_scan", "bucket_fill",
                                  "coarsen_csr")):
        fail(f"{what}: timed run 1 made the native calls {calls}")
    print(f"  {what}: timed run 1's native calls {calls}, under the "
          "guard")
    print(f"  {what}: Q, phases and iterations {got} as the in-process "
          f"run; timed run 1 launched {run1}, as it did; ledger peaks "
          f"{rec['hbm_peak_by_buffer']}")
    out[f"bench R-MAT {scale}, timed run 1"] = run1
    print(f"  the R-MAT {scale} bench and its reference took "
          f"{time.perf_counter() - t0:.1f} s")

    # --batch-jobs 64: the job set is phase 17's batch itself, so the
    # bucket geometry the bench pins over its jobs is that batch's own,
    # and a pass's launches must equal phase 17's.
    t0 = time.perf_counter()
    batch = {}
    for engine in ("bucketed", "fused"):
        what = (f"bench --batch 64 --batch-jobs 64 --batch-edges 4096 "
                f"--batch-engine {engine}")
        batch[engine] = (what, bench_start(
            ["--batch", "64", "--batch-jobs", "64", "--batch-edges", "4096",
             "--batch-engine", engine]))
    serve_what = "bench --serve-rate 200 --batch-edges 1024 --serve-b-max 8"
    serve = bench_start(["--serve-rate", "200", "--batch-edges", "1024",
                         "--serve-b-max", "8", "--batch-jobs", "64"])
    print("  three bench children run concurrently (their walls and rates "
          "share the card and the host):")
    for engine, (what, started) in batch.items():
        rec, err, _ = bench_finish(what, started, card)
        (pass1,) = stderr_json(what, err, "# launches pass 1, by batch: ")
        want = paths[f"serving 4096 {engine}"]
        if pass1 != want or pass1["seg_coalesce"] == 0:
            fail(f"{what}: timed pass 1 launched {pass1}, phase 17 {want}")
        print(f"  {what}: timed pass 1 launched {pass1}, as phase 17")
        out[f"bench --batch 64 synth 4096 {engine}, timed pass 1"] = pass1
    rec, _, _ = bench_finish(serve_what, serve, card)
    c = rec["serve"]["conservation"]
    if not (c["ok"] and c["done"] + c["failed"] + c["shed"] + c["pending"]
            + c["inflight"] == c["submitted"]):
        fail(f"{serve_what}: conservation {c}")
    print(f"  {serve_what}: conservation {c}")
    print(f"  the three concurrent bench children took "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    check_guard_trip(14)
    print(f"  the guard trip took {time.perf_counter() - t0:.1f} s")
    return out, (g, ref)


def cli_child(argv: list, cwd: str, timeout: int = 900) -> str:
    return cli_finish(cli_start(argv, cwd), timeout)


def cli_start(argv: list, cwd: str) -> tuple:
    """Start ``python ARGV`` in ``cwd`` with the repo on the path; returns
    (argv, the child, its start time)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen([sys.executable, *argv], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return argv, proc, time.perf_counter()


def cli_finish(started: tuple, timeout: int = 900) -> str:
    """Wait for a :func:`cli_start` child; fails unless it exits 0 within
    ``timeout`` s.  Returns its stdout."""
    argv, proc, _ = started
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{' '.join(argv[:3])}: did not end in {timeout} s")
    if proc.returncode:
        fail(f"{' '.join(argv[:3])}: exit {proc.returncode}: "
             f"{stderr[-3000:]}")
    return stdout


def count_syncs(fn) -> tuple:
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``; returns
    (its result, the synchronizing operations it warned of)."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return res, sum("synchroniz" in str(w.message) for w in caught)


def run_cli_phase(scale: int, g_rmat, main_res) -> None:
    """Phase 23: the CLI on the card and with --device cpu and ``serve demo
    --trace-out`` as three concurrent children, then R-MAT ``scale``
    (``g_rmat``, phase 22's graph) with and without a flight recorder
    against ``main_res``, phase 22's in-process run of it."""
    import tempfile

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.evaluate.modularity import modularity
    from cuvite_tpu_torch.io.generate import generate_rgg
    from cuvite_tpu_torch.io.vite import read_vite
    from cuvite_tpu_torch.obs import (
        FlightRecorder,
        read_trace,
        spans_of,
        validate_trace,
    )
    from cuvite_tpu_torch.utils.trace import Tracer

    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(dir=os.path.join(root, "build", "chip_smoke"))
    t0 = time.perf_counter()
    started = {}
    for where in ("card", "cpu"):
        d = os.path.join(work, where)
        os.makedirs(d)
        started[where] = (d, cli_start(
            ["-m", "cuvite_tpu_torch.cli", "-n", "65536", "-e", "10",
             "--json", "--quiet", "-o", "--trace-out", "t.jsonl",
             "--metrics-out", "m.json", "-s", "g.bin"]
            + (["--device", "cpu"] if where == "cpu" else []), d))
    sd = os.path.join(work, "serve")
    os.makedirs(sd)
    demo = cli_start(["-m", "cuvite_tpu_torch.serve", "demo", "--jobs",
                      "64", "--edges", "4096", "--trace-out", "s.jsonl"], sd)
    runs = {}
    for where, (d, child) in started.items():
        line = cli_finish(child).strip().splitlines()[-1]
        runs[where] = (json.loads(line), d, time.perf_counter() - child[2])
    cli_finish(demo)
    print(f"  the CLI on the card, with --device cpu and serve demo ran as "
          f"three concurrent children: {time.perf_counter() - t0:.1f} s")
    (js, d, wall), (cjs, cd, cwall) = runs["card"], runs["cpu"]
    drop = ("seconds", "teps")
    if {k: v for k, v in js.items() if k not in drop} != \
            {k: v for k, v in cjs.items() if k not in drop}:
        fail(f"cli -n 65536 -e 10: card {js} and CPU {cjs} differ")
    labels = np.loadtxt(os.path.join(d, "rgg65536.communities"),
                        dtype=np.int64)
    if not np.array_equal(labels, np.loadtxt(
            os.path.join(cd, "rgg65536.communities"), dtype=np.int64)):
        fail("cli -n 65536 -e 10: card and CPU labels differ")
    for where_dir in (d, cd):
        problems = validate_trace(read_trace(os.path.join(where_dir,
                                                          "t.jsonl")))
        if problems:
            fail(f"cli trace: {problems[:5]}")
        with open(os.path.join(where_dir, "m.json")) as f:
            m = json.load(f)
        if set(m) != CLI_METRICS_KEYS:
            fail(f"cli metrics keys {sorted(m)}")
    g = generate_rgg(65536, random_edge_percent=10)
    back = read_vite(os.path.join(d, "g.bin"), bits64=False)
    for name in ("offsets", "tails", "weights"):
        if not np.array_equal(getattr(back, name), getattr(g, name)):
            fail(f"cli -s g.bin: {name} differ from the generated graph")
    q = modularity(g, labels)
    if abs(q - js["modularity"]) > 1e-6:
        fail(f"cli Q {js['modularity']} vs host f64 {q}")
    with open(os.path.join(d, "m.json")) as f:
        m = json.load(f)
    print(f"  cli -n 65536 -e 10 on the card ({wall:.2f} s) and with "
          f"--device cpu ({cwall:.2f} s): {js['ne']} directed edges, "
          f"{js['phases']} phases, {js['iterations']} iterations, Q "
          f"{js['modularity']:.9f} (host f64 of the labels {q:.9f}); "
          f"JSON lines equal but seconds and teps (card {js['seconds']:.3f}"
          f" s, CPU {cjs['seconds']:.3f} s), labels identical, traces "
          f"valid, g.bin equal to the generated graph; card compile events "
          f"{m['compile_events']}, memory peaks {m['hbm_peak_by_buffer']}")

    recs = read_trace(os.path.join(sd, "s.jsonl"))
    problems = validate_trace(recs)
    names = {s["name"] for s in spans_of(recs)}
    if problems or not {"pack", "execute"} <= names:
        fail(f"serve demo trace: {problems[:5]}, spans {names}")
    print(f"  serve demo --trace-out: {len(recs)} records, valid, spans "
          f"{sorted(names)}")

    res_plain, n_plain = count_syncs(lambda: louvain_phases(g_rmat))

    def traced():
        with FlightRecorder() as rec:
            return louvain_phases(g_rmat, tracer=Tracer(recorder=rec)), rec

    (res_traced, rec), n_traced = count_syncs(traced)
    for what, res in (("without", res_plain), ("with", res_traced)):
        if not np.array_equal(res.communities, main_res.communities):
            fail(f"R-MAT {scale} {what} a tracer: labels differ from "
                 "phase 22's in-process run")
    if n_traced > n_plain:
        fail(f"R-MAT {scale}: {n_traced} synchronizing operations with a "
             f"tracer, {n_plain} without")
    problems = validate_trace(rec.records)
    if problems:
        fail(f"R-MAT {scale} trace: {problems[:5]}")
    print(f"  R-MAT {scale} with a flight recorder: labels equal to phase "
          f"22's in-process run; {n_traced} synchronizing operations warned of, {n_plain} "
          f"without a tracer; {len(rec.records)} trace records, memory "
          f"peaks {rec.ledger.peak_by_buffer}")

# ---------------------------------------------------------------------------
# Phases 24-27: streaming.


def stream_batch(g, arrs):
    from cuvite_tpu_torch.stream import DeltaBatch

    return DeltaBatch.from_edits(g.num_vertices, **arrs)


def spill_batch(g, sess, seed: int):
    """Fresh inserts (dyadic weights 1..8) overflowing ``sess``'s padding
    headroom by ~128 rows: the batch that grows its class."""
    from cuvite_tpu_torch.stream import DeltaBatch

    rng = np.random.default_rng(seed)
    n = (sess.ne_pad - sess.ne) // 2 + 64
    u = rng.integers(0, g.num_vertices, 2 * n)
    v = rng.integers(0, g.num_vertices, 2 * n)
    keep = u != v
    u, v = u[keep][:n], v[keep][:n]
    return DeltaBatch.from_edits(
        g.num_vertices, ins_src=u, ins_dst=v,
        ins_w=rng.integers(1, 9, len(u)).astype(np.float64))


def check_stream_card_vs_cpu(scale: int) -> dict:
    """Phase 24.  Returns the card session's launches."""
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.stream import StreamSession
    from cuvite_tpu_torch.workloads.synth import churn_batches

    g = generate_rmat(scale)
    b0, b1 = churn_batches(g, frac=0.01, seed=1, batches=2)
    zero_kernel_counts()
    card = StreamSession.from_graph(g, device="cuda")
    cpu = StreamSession.from_graph(g, device="cpu")
    check_same_run(f"stream R-MAT {scale} cold", card.recluster(warm="cold"),
                   cpu.recluster(warm="cold"))

    def same_slab(what):
        if (card.ne, card.ne_pad, card.tw2, card.fingerprint) != \
                (cpu.ne, cpu.ne_pad, cpu.tw2, cpu.fingerprint):
            fail(f"{what}: card (ne, ne_pad, 2m, fingerprint) "
                 f"{(card.ne, card.ne_pad, card.tw2, card.fingerprint)}, "
                 f"CPU {(cpu.ne, cpu.ne_pad, cpu.tw2, cpu.fingerprint)}")
        for f in ("src", "dst", "w"):
            if not bits_equal(getattr(card, f).cpu(), getattr(cpu, f)):
                fail(f"{what}: the card's slab {f} differs from the CPU's")

    infos = []
    for k, arrs in enumerate((b0, b1)):
        batch = stream_batch(g, arrs)
        ic, ip = card.apply_delta(batch), cpu.apply_delta(batch)
        ic.pop("wall_s"), ip.pop("wall_s")
        if ic != ip:
            fail(f"stream R-MAT {scale} batch {k}: card {ic}, CPU {ip}")
        same_slab(f"stream R-MAT {scale} batch {k}")
        infos.append(ic)
    ne_pad = card.ne_pad
    spill = spill_batch(g, card, 5)
    card.apply_delta(spill)
    cpu.apply_delta(spill)
    if card.ne_pad != 2 * ne_pad:
        fail(f"stream R-MAT {scale}: the spill batch left the class at "
             f"{card.ne_pad} rows (from {ne_pad})")
    same_slab(f"stream R-MAT {scale} spill")
    for arm in ("labels", "plp"):
        check_same_run(f"stream R-MAT {scale} {arm}",
                       card.recluster(warm=arm), cpu.recluster(warm=arm))
    launches = kernel_counts()
    print(f"  R-MAT {scale}, two churn batches {infos} and a spill of "
          f"{spill.n_ins} insert rows ({ne_pad} -> {card.ne_pad} rows): "
          f"slab bit-equal card vs CPU after each apply_delta; cold, "
          f"labels and plp re-clusters identical; launches {launches}")
    return launches


def run_stream_full(g, scale: int) -> dict:
    """Phase 25.  Returns the stream path's launches."""
    import warnings

    import torch

    from cuvite_tpu_torch.stream import StreamSession
    from cuvite_tpu_torch.workloads.golden import (
        check_envelope,
        envelope_from_measurement,
    )
    from cuvite_tpu_torch.workloads.synth import churn_batches

    batch = stream_batch(g, churn_batches(g, frac=0.01, seed=1)[0])

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    sess, up_s = timed(lambda: StreamSession.from_graph(g))
    cold, cold_s = timed(lambda: sess.recluster(warm="cold"))
    # No synchronize inside the window: apply_delta ends in its one host
    # read, after its last device work, so the host clock covers it.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            info = sess.apply_delta(batch)
            apply_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    warm, warm_s = timed(lambda: sess.recluster(warm="labels"))
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    fresh, fresh_up_s = timed(lambda: StreamSession.from_graph(g))
    fresh.apply_delta(batch)
    plp, plp_s = timed(lambda: fresh.recluster(warm="plp"))
    del fresh
    if len(sites) != 1:
        fail(f"stream R-MAT {scale}: apply_delta made {len(sites)} host "
             f"reads (at {sites}), not 1")
    env = envelope_from_measurement({
        "modularity": cold.modularity, "phases": len(cold.phases),
        "communities": cold.num_communities})
    # The envelope guards the warm (labels) arm against degradation, so
    # its Q check is one-sided; the plp arm is a seed the reference
    # offers for comparison, and its reading is printed.
    for what, res in (("labels", warm), ("plp", plp)):
        problems = check_envelope(env, {
            "modularity": res.modularity, "phases": len(res.phases),
            "communities": res.num_communities})
        if what == "labels" and res.modularity < env["q"][0]:
            fail(f"stream R-MAT {scale}: the labels arm's Q "
                 f"{res.modularity} left the cold run's envelope "
                 f"{env['q']}")
        print(f"  {what} arm against the cold run's envelope {env}: "
              f"{problems or 'inside'}")
    print(f"  R-MAT {scale}: {g.num_edges} directed edges in a slab of "
          f"{sess.ne_pad} rows ({sess.hbm_bytes()} B resident); "
          f"from_graph {up_s:.3f} s; cold re-cluster {cold_s:.3f} s "
          f"({len(cold.phases)} phases, {cold.total_iterations} sweeps, Q "
          f"{cold.modularity:.9f}); apply_delta {apply_s:.4f} s "
          f"({info['n_ins']} insert and {info['n_del']} delete rows, "
          f"{info['n_del_hit']} hits, frontier_frac "
          f"{info['frontier_frac']}, {len(sites)} host read at {sites}); "
          f"labels re-cluster {warm_s:.3f} s ({len(warm.phases)} phases, "
          f"{warm.total_iterations} sweeps, Q {warm.modularity:.9f}); "
          f"peak allocated {peak} B; launches {launches}")
    print(f"  a fresh session (from_graph {fresh_up_s:.3f} s) with the "
          f"same delta, plp re-cluster {plp_s:.3f} s ({len(plp.phases)} "
          f"phases, {plp.total_iterations} sweeps, Q {plp.modularity:.9f})")
    return launches


def run_stream_bench(card: tuple, scale: int) -> dict:
    """Phase 26, at BENCH_SCALE: phase 25 streams R-MAT --scale in this
    process.  Returns the timed arms' launches."""
    what = f"bench --churn-frac 0.01 --scale {scale}"
    rec, err, _ = bench_child(what, ["--churn-frac", "0.01", "--scale",
                                     str(scale)], card)
    print(f"    stream {json.dumps(rec['stream'])}")
    print(f"    Q {rec['modularity']}, {rec['phases']} phases, "
          f"{rec['iterations']} iterations")
    return stderr_json(what, err, "# launches run 1: ")


def run_stream_daemon() -> dict:
    """Phase 27: the daemon's ``delta`` verb on the card, under a budget
    that holds one synth 4096 session.  Returns the daemon's launches."""
    import signal
    import socket
    import tempfile

    from cuvite_tpu_torch.stream import StreamSession
    from cuvite_tpu_torch.workloads.synth import synthesize_graph

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(dir=os.path.join(root, "build", "chip_smoke"))
    sock = os.path.join(tmp, "stream.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cuvite_tpu_torch.serve", "daemon",
         "--socket", sock, "--stream-budget-mb", "0.25"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=root)
    t0 = {"synth": {"edges": 4096, "seed": 3}}
    t1 = {"synth": {"edges": 4096, "seed": 4}}
    script = [
        dict(t0, op="delta", tenant="t0", ins=[[0, 5, 2.0]],
             recluster=True),
        {"op": "delta", "tenant": "t0", "ins": [[1, 6, 4.0]],
         "del": [[0, 5]], "recluster": True, "warm": "labels",
         "labels": True},
        dict(t1, op="delta", tenant="t1", ins=[[2, 7]], recluster=True),
        {"op": "delta", "tenant": "t0", "ins": [[3, 7]]},
        dict(t0, op="delta", tenant="t0", recluster=True, warm="plp"),
        {"op": "stats"},
    ]
    try:
        line = proc.stdout.readline()
        if not line:
            fail(f"stream daemon died before its readiness line: "
                 f"{proc.stderr.read()[-2000:]}")
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.connect(sock)
        conn.settimeout(300.0)
        lines = conn.makefile("r", encoding="utf-8")
        t_s = time.perf_counter()
        replies = []
        for req in script:
            conn.sendall((json.dumps(req) + "\n").encode())
            replies.append(json.loads(lines.readline()))
        served = time.perf_counter() - t_s
        proc.send_signal(signal.SIGTERM)
        summary = json.loads(lines.readline())["serve_summary"]
        conn.close()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if rc != 0:
        fail(f"stream daemon exited {rc}: {proc.stderr.read()[-2000:]}")
    if [r["ok"] for r in replies] != [True, True, True, False, True, True] \
            or replies[3].get("resident") is not False:
        fail(f"stream daemon replies {replies}")
    # The same edits on an in-process session on the card.
    g = synthesize_graph(4096, seed=3)
    sess = StreamSession.from_graph(g)
    sess.apply_delta(stream_batch(g, dict(ins_src=[0], ins_dst=[5],
                                          ins_w=[2.0])))
    sess.recluster(warm="cold")
    sess.apply_delta(stream_batch(g, dict(
        ins_src=[1], ins_dst=[6], ins_w=[4.0], del_src=[0], del_dst=[5])))
    direct = sess.recluster(warm="labels")
    if replies[1]["recluster"]["labels"] != direct.communities.tolist():
        fail("stream daemon: the labels arm's labels differ from an "
             "in-process session's")
    pool = summary.get("stream", {})
    cons = pool.get("conservation", {})
    if not cons.get("ok") or (pool["admitted"], pool["evicted"],
                              pool["resident"]) != (3, 3, 0):
        fail(f"stream daemon: pool {pool}")
    launches = replies[-1]["kernels"]
    print(f"  5 deltas in {served:.3f} s (two tenants, budget "
          f"{pool['budget_bytes']} B, one session {sess.hbm_bytes()} B): "
          f"replies ok "
          f"{[r['ok'] for r in replies[:5]]}, t0 evicted by t1 and "
          f"uploaded again; the labels arm's labels equal an in-process "
          f"session's; SIGTERM: exit 0, pool {pool}; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phases 28-31: the sharded engine on a mesh of shards on one card.

# The vertex shards of phases 28-31, all on the one card.
MESH_SHARDS = 4
# The R-MAT 20 bucketed path's launches before the size form existed
# (PR 8's and PR 9's smoke runs): the non-size row and heavy kernels.
MAIN_PATH_LAUNCHES_20 = {"row_argmax": 229, "heavy_bincount": 14}
# Bytes of one real row of the size form: verts and degree, vdeg,
# self_loop and cdeg_v, four 4-byte outputs.
SIZED_ROW_BYTES = 4 + 4 + 12 + 16


def sized_row_case(width: int, seed: int, dev):
    """Rows of the size form over 3,000 owned vertices and 1,000 ghosts,
    each with a community from a pool of ~width/2 ids and that
    community's degree and size (a quarter of them singletons): row
    degrees random in [1, width], padding slots past them (the row's own
    vertex, weight 0), dyadic weights; rows 0-3 reach only their own
    community (no candidate); the last row is a zero-gain tie between
    communities 5 and 3 (zero-weight edges, degree equal to ax), which 3
    must win with its own size.  Returns (tensors, constant, degrees)."""
    import torch

    rng = np.random.default_rng(seed)
    nv, n_ext = 3000, 4000
    n_rows = max(64, min(2048, (1 << 20) // width))
    pool = max(width // 2, 16)
    comm = rng.integers(16, pool + 16, n_ext).astype(np.int32)
    cdeg_tab = (rng.integers(1, 256, pool + 16) / 8.0).astype(np.float32)
    size_tab = np.where(rng.random(pool + 16) < 0.25, 1,
                        rng.integers(2, 99, pool + 16)).astype(np.int32)
    verts = rng.choice(nv, n_rows, replace=False).astype(np.int32)
    deg = rng.integers(1, width + 1, n_rows)
    dst = rng.integers(0, n_ext, (n_rows, width)).astype(np.int32)
    w = (rng.integers(0, 32, (n_rows, width)) / 16.0).astype(np.float32)
    # The tie row: vertex t in community 15 (degree 10, vdeg 4: ax = 6),
    # zero-weight edges to ghosts 3000-3005 in communities 5, 3, 9.
    t = verts[-1]
    comm[t] = 15
    comm[3000:3006] = [5, 3, 9, 5, 3, 9]
    cdeg_tab[[3, 5, 9, 15]] = [6.0, 6.0, 100.0, 10.0]
    size_tab[[3, 5]] = [7, 1]
    deg[-1] = 6
    dst[-1, :6] = np.arange(3000, 3006)
    w[-1] = 0.0
    # No-candidate rows, among the pool's communities (ids >= 16).
    same = np.nonzero(comm == comm[verts[0]])[0]
    for r in range(4):
        comm[verts[r]] = comm[verts[0]]
        dst[r] = rng.choice(same, width)
        deg[r] = width
    vdeg = (rng.integers(1, 64, nv) / 4.0).astype(np.float32)
    vdeg[t] = 4.0
    sl = (rng.integers(0, 3, nv) / 2.0).astype(np.float32)
    sl[t] = 0.0
    slot = np.arange(width)[None, :]
    dst = np.where(slot < deg[:, None], dst, verts[:, None]).astype(np.int32)
    w[slot >= deg[:, None]] = 0.0
    cdeg_ext, csize_ext = cdeg_tab[comm], size_tab[comm]
    arrs = (dst, w, verts, comm, cdeg_ext, csize_ext,
            np.ascontiguousarray(cdeg_ext[:nv]), vdeg, sl)
    return ([torch.from_numpy(a).to(dev) for a in arrs],
            float(np.float32(1.0 / 64.0)),
            torch.from_numpy(deg.astype(np.int32)).to(dev))


def check_sized_rows(dev, main_launches: dict, scale: int) -> None:
    """Phase 28's checks: the size form against its twin at every width,
    and the non-size form's main-path launches unchanged."""
    from cuvite_tpu_torch.kernels.row_argmax import (
        row_argmax_sized,
        row_argmax_sized_plain,
    )
    from cuvite_tpu_torch.louvain.bucketed import DEFAULT_BUCKETS

    names = ("best_c", "best_gain", "counter0", "best_size")
    for width in DEFAULT_BUCKETS:
        args, const, deg = sized_row_case(width, 28 + width, dev)
        cpu = [a.cpu() for a in args]
        for d in (None, deg):
            got = row_argmax_sized(*args, const, d)
            ref = row_argmax_sized_plain(*cpu, const,
                                         None if d is None else d.cpu())
            for name, g, r in zip(names, got, ref):
                if not bits_equal(g, r):
                    fail(f"row_argmax_sized width {width} (degrees "
                         f"{d is not None}): {name} differs from the twin")
        if (got[0][:4].cpu() != 2**31 - 1).any() or \
                (got[3][:4].cpu() != 2**31 - 1).any():
            fail(f"row_argmax_sized width {width}: a no-candidate row "
                 "found a candidate or a size")
        if (int(got[0][-1]), float(got[1][-1]), int(got[3][-1])) != \
                (3, 0.0, 7):
            fail(f"row_argmax_sized width {width} zero-gain tie: got "
                 f"{int(got[0][-1])} at {float(got[1][-1])} size "
                 f"{int(got[3][-1])}, want 3 at 0 size 7")
        print(f"  row_argmax_sized width {width:5d}: {args[0].shape[0]} "
              "rows bit-equal to the twin with and without degrees, "
              "best_size included; no-candidate rows sentinel; zero-gain "
              "tie to 3 with its size")
    print(f"  the non-size form on the R-MAT {scale} main path (phase 5): "
          f"{main_launches}")
    if main_launches.get("row_argmax_sized"):
        fail("the size form launched on the single-shard main path")
    if scale == 20 and any(main_launches[k] != v
                           for k, v in MAIN_PATH_LAUNCHES_20.items()):
        fail(f"R-MAT 20 main-path launches {main_launches} changed from "
             f"{MAIN_PATH_LAUNCHES_20}")


def time_sized_rows(g, nshards: int) -> dict:
    """The size form at the phase-0 shapes of the sparse mesh path of
    ``g`` on one card: one sweep's launches over every class of every
    shard (with the records they read), at the identity assignment and
    at the converged phase-0 assignment, beside the twin and the bound."""
    import torch

    from cuvite_tpu_torch.comm.exchange import sparse_env
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.kernels.row_argmax import (
        attached_vertex_table,
        row_argmax_sized,
        row_argmax_sized_plain,
        slot_table,
    )
    from cuvite_tpu_torch.louvain.driver import MeshPhaseRunner

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    run = MeshPhaseRunner(DistGraph.build(g, nshards),
                          make_mesh(devices=[dev] * nshards),
                          exchange="sparse")
    mp = run.plan
    print(f"  phase-0 sparse plan of {nshards} shards built and placed in "
          f"{time.perf_counter() - t0:.2f} s")
    _, _, iters = run.run(1.0e-6)
    slots = real_rows = 0
    for p in mp.plans:
        for verts, _, _, row_deg in p.buckets:
            real_rows += verts.numel()
            slots += int(row_deg.sum())
    out = {"launches_per_sweep": sum(len(p.buckets) for p in mp.plans),
           "real_rows": real_rows, "real_slots": slots}
    err = 0.0
    c = run.constant
    for label, comms in (("identity", run.comm0),
                         ("converged", run.labels_dev)):
        envs = sparse_env(comms, run.vdeg, mp.send_idx, mp.ghost_sel,
                          mp.mesh, budget=mp.budget)
        cases = []
        for s, (p, e) in enumerate(zip(mp.plans, envs)):
            tabs = (e.comm_ext, e.cdeg_ext, e.csize_ext, e.cdeg_v,
                    run.vdeg[s], mp.self_loops[s])
            cases.append((p, tabs))

        def sweep(fn, cases=cases):
            outs = []
            for p, tabs in cases:
                extra = ()
                if fn is row_argmax_sized:
                    extra = (attached_vertex_table(
                        tabs[0][:tabs[4].numel()], tabs[3], tabs[4],
                        tabs[5]), slot_table(*tabs[:3]))
                outs += [fn(d, w, v, *tabs, c, dg, *extra)
                         for v, d, w, dg in p.buckets]
            return outs

        got = sweep(row_argmax_sized)
        ref = sweep(row_argmax_sized_plain)
        for a, b in zip(got, ref):
            for x, y in zip(a, b):
                if not bits_equal(x, y):
                    fail(f"row_argmax_sized at the sparse phase-0 shapes "
                         f"({label}) differs from its twin")
                err = max(err, max_abs_err([x], [y]))
        out[f"ms_{label}"] = time_ms(lambda: sweep(row_argmax_sized), 10)
        out[f"plain_ms_{label}"] = time_ms(
            lambda: sweep(row_argmax_sized_plain), 3)
    n_tab = sum(min(slots, run.dg.nv_pad + gc) for gc in run.ghost_counts)
    out["bytes"] = slots * 8 + real_rows * SIZED_ROW_BYTES + 12 * min(
        slots, n_tab)
    out["ops"] = 8 * slots
    out["bound_ms"], out["bound_by"] = bound(out["bytes"], out["ops"])
    out["max_abs_err"] = err
    out["converged_after_sweeps"] = iters
    return out


def check_replicated_rows(g, nshards: int) -> None:
    """The non-size row kernel and the heavy kernel at the phase-0 shapes
    of the replicated mesh path of ``g`` on one card: every class and the
    hubs of every shard, rows and hubs by padded-global id against the
    gathered tables, at the identity and at the converged phase-0
    assignment, bit-equal to their twins."""
    import torch

    from cuvite_tpu_torch.comm.collectives import all_gather, psum
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.kernels.heavy_bincount import (
        heavy_argmax,
        heavy_argmax_plain,
    )
    from cuvite_tpu_torch.kernels.row_argmax import (
        row_argmax,
        row_argmax_plain,
    )
    from cuvite_tpu_torch.louvain.driver import MeshPhaseRunner
    from cuvite_tpu_torch.ops import segment as seg

    dev = torch.device("cuda", 0)
    run = MeshPhaseRunner(DistGraph.build(g, nshards),
                          make_mesh(devices=[dev] * nshards),
                          exchange="replicated")
    mp = run.plan
    run.run(1.0e-6)
    c = run.constant
    names = ("best_c", "best_gain", "counter0")
    rows = hubs = launches = 0
    for label, comms in (("identity", run.comm0),
                         ("converged", run.labels_dev)):
        comm_full = all_gather(comms, mp.mesh)
        deg = psum([seg.segment_sum(v.double(), cm, mp.nv_total)
                    for cm, v in zip(comms, run.vdeg)], mp.mesh)
        for s, p in enumerate(mp.plans):
            tabs = (comm_full[s], deg[s].float(), mp.vdeg_full[s],
                    mp.sl_full[s])
            pairs = [(f"row_argmax width {dst.shape[1]}",
                      row_argmax(dst, w, verts, *tabs, c, d),
                      row_argmax_plain(dst, w, verts, *tabs, c, d))
                     for verts, dst, w, d in p.buckets]
            if label == "identity":
                rows += sum(b[0].numel() for b in p.buckets)
            if p.heavy is not None:
                pairs.append(("heavy_argmax",
                              heavy_argmax(p.heavy, *tabs, c),
                              heavy_argmax_plain(p.heavy, *tabs, c)))
                hubs += p.heavy.num_hubs if label == "identity" else 0
            launches += len(pairs)
            for what, got, ref in pairs:
                for name, x, y in zip(names, got, ref):
                    if not bits_equal(x, y):
                        fail(f"{what} at the replicated phase-0 shapes, "
                             f"shard {s} ({label}): {name} differs from "
                             "the twin")
    print(f"  row_argmax and heavy_argmax at the replicated {nshards}-shard "
          f"phase-0 shapes: {rows} rows and {hubs} hubs by padded-global "
          f"id, {launches} launches at the identity and the converged "
          "assignment, bit-equal to their twins")


class ExchangeLog:
    """A tracer stand-in that keeps the driver's per-phase ``exchange``
    events (mode, shards, budget, plan stats) and ignores the rest."""

    def __init__(self):
        from cuvite_tpu_torch.utils.trace import NullTracer

        self._null = NullTracer()
        self.events = []

    def event(self, name, **attrs):
        if name == "exchange":
            self.events.append(attrs)

    def __getattr__(self, name):
        return getattr(self._null, name)


def check_mesh_card_vs_cpu(scale: int, nshards: int) -> dict:
    """Phase 29: the mesh on one card against the same mesh on the CPU
    and against one shard on the card."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.io.generate import generate_rmat

    g = generate_rmat(scale)
    one = louvain_phases(g, device="cuda")
    paths = {}
    for exchange in ("replicated", "sparse"):
        zero_kernel_counts()
        t0 = time.perf_counter()
        rg = louvain_phases(g, mesh=make_mesh(
            devices=[torch.device("cuda", 0)] * nshards), exchange=exchange)
        card_s = time.perf_counter() - t0
        paths[f"mesh {nshards} shards R-MAT {scale} {exchange}, card vs "
              "CPU"] = kernel_counts()
        t0 = time.perf_counter()
        rc = louvain_phases(g, nshards=nshards, device="cpu",
                            exchange=exchange)
        cpu_s = time.perf_counter() - t0
        check_same_run(f"R-MAT {scale} {nshards} shards {exchange}", rg, rc)
        check_same_run(f"R-MAT {scale} {nshards} shards {exchange} vs one "
                       "shard", rg, one)
        print(f"  R-MAT {scale}, {nshards} shards on one card, {exchange}: "
              f"{len(rg.phases)} phases, {rg.total_iterations} sweeps, Q "
              f"{rg.modularity:.9f}; equal to the CPU mesh and to one "
              f"shard ({card_s:.2f} s card, {cpu_s:.2f} s CPU)")
    return paths


def run_mesh_full(g, scale: int, nshards: int, exchange: str,
                  main_res, shape=None) -> tuple:
    """Phase 30 (and phase 36's two-level run, ``shape`` = (dcn, ici)):
    one full-width mesh run on one card, launch counts zeroed just before
    and read just after.  Returns (launches, wall s, the LouvainResult)."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_hybrid_mesh, make_mesh
    from cuvite_tpu_torch.evaluate.modularity import modularity

    devs = [torch.device("cuda", 0)] * nshards
    mesh = (make_mesh(devices=devs) if shape is None
            else make_hybrid_mesh(*shape, devices=devs))
    log = ExchangeLog()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t0 = time.perf_counter()
    res = louvain_phases(g, mesh=mesh, exchange=exchange, tracer=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    for p, ev in zip(res.phases, log.events):
        st = " ".join(f"{k} {v:.3f}" for k, v in p.stages.items())
        plan = ev["plan"] or {}
        budget = ev["budget"] or 0
        # fwd key/deg/size and the reply's two, per peer plan shard
        route = 5 * plan.get("nshards", nshards) * budget * 4
        print(f"  phase {p.phase}: nv {p.num_vertices} ne {p.num_edges} "
              f"iterations {p.iterations} Q {p.modularity:.9f} seconds "
              f"{p.seconds:.3f} ({st}); exchange {ev['mode']}"
              + (f", ghosts per plan shard {plan['ghosts_per_shard']}, "
                 f"block {plan['block']}, ghost_pad {plan['ghost_pad']}, "
                 f"budget {budget}, bytes a sweep per shard: ghost pull "
                 f"{plan['ghost_bytes']} + owner route {route}"
                 + (f", group tables {plan['table_bytes_per_device']} B"
                    if "table_bytes_per_device" in plan else "")
                 if plan else ""))
    print(f"  R-MAT {scale}, {nshards} shards on one card, {exchange}"
          f"{'' if shape is None else ' %dx%d' % shape}: "
          f"{wall:.3f} s, {res.total_iterations} sweeps, launches "
          f"{launches}, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B, exchange_stats "
          f"{res.exchange_stats}")
    q_host = modularity(g, res.communities)
    if abs(q_host - res.modularity) > 1e-6:
        fail(f"{exchange} mesh: reported Q {res.modularity} vs host f64 "
             f"{q_host}")
    if main_res is not None and not np.array_equal(res.communities,
                                                   main_res.communities):
        fail(f"{exchange} mesh: labels differ from one shard's (phase 5)")
    sized = exchange in ("sparse", "twolevel")
    if launches["row_argmax_sized" if sized else "row_argmax"] == 0:
        fail(f"{exchange} mesh: the row kernel's form never launched")
    if sized and launches["row_argmax"]:
        fail(f"{exchange} mesh: the non-size row kernel launched")
    return launches, wall, res


def check_budget_retry(scale: int, nshards: int) -> dict:
    """Phase 31: a per-peer budget of 1 on the card overflows, the phase
    is re-run with a grown budget, and the labels are one shard's."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.louvain.driver import MeshPhaseRunner

    g = generate_rmat(scale)
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * nshards)
    r = MeshPhaseRunner(DistGraph.build(g, nshards), mesh,
                        exchange="sparse", budget=1)
    comm, seen = r.comm0, 0
    for _ in range(4):
        res = r.step(comm)
        seen += bool(res.overflow)
        comm = res.targets
    if not seen:
        fail("budget 1 never overflowed")
    log = ExchangeLog()
    zero_kernel_counts()
    rt = louvain_phases(g, mesh=mesh, exchange="sparse", exchange_budget=1,
                        tracer=log)
    launches = kernel_counts()
    budgets = [e["budget"] for e in log.events]
    one = louvain_phases(g, device="cuda")
    check_same_run(f"R-MAT {scale} budget 1 vs one shard", rt, one)
    if budgets[0] <= 1:
        fail(f"budget 1: the phase was not re-run with a larger budget "
             f"({budgets})")
    print(f"  R-MAT {scale}, {nshards} shards, exchange_budget 1: "
          f"{seen} of 4 sweeps overflowed in the runner; the driver's "
          f"budgets by phase {budgets}; labels, phases and sweeps equal to "
          "one shard's")
    return {f"mesh budget-1 retry R-MAT {scale}": launches}


# ---------------------------------------------------------------------------
# Phase 35: early termination, the color schedules and checkpoints on a
# mesh.

# Phase 34's colored DistVite runs and phase 35's full-width sparse run.
COLOR_RUN = "coloring=8 sparse"
# R-MAT scales of phase 35's card-against-CPU checks: the mesh schedules
# (the CPU's four-shard runs of every mode dominate there) and the class
# sweeps (the CPU twins of a whole coloring iteration dominate; phase 14
# sweeps the same class plans at --scale on one shard).
MESH_CHECK_SCALE = 12
CLASS_SWEEP_SCALE = 18
MESH_SCHEDULES = ([{"et_mode": m} for m in (1, 2, 3, 4)]
                  + [{"coloring": 8}, {"vertex_ordering": 8}])


def _kw_name(kw: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in kw.items())


def check_mesh_schedules(scale: int, nshards: int) -> dict:
    """Phase 35, first part: every mesh option on R-MAT --check-scale,
    both exchanges, card against CPU and against one shard on the card;
    then a checkpointed colored run resumed on the card."""
    import tempfile

    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.io.generate import generate_rmat

    g = generate_rmat(scale)
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * nshards)
    paths = {}
    for kw in MESH_SCHEDULES:
        name = _kw_name(kw)
        one = louvain_phases(g, device="cuda", **kw)
        line = []
        for exchange in ("replicated", "sparse"):
            zero_kernel_counts()
            t0 = time.perf_counter()
            rg = louvain_phases(g, mesh=mesh, exchange=exchange, **kw)
            card_s = time.perf_counter() - t0
            launches = kernel_counts()
            rc = louvain_phases(g, nshards=nshards, device="cpu",
                                exchange=exchange, **kw)
            what = f"R-MAT {scale} {nshards} shards {exchange} {name}"
            check_same_run(what, rg, rc)
            check_same_run(f"{what} vs one shard", rg, one)
            form, other = (("row_argmax_sized", "row_argmax")
                           if exchange == "sparse"
                           else ("row_argmax", "row_argmax_sized"))
            if launches[form] == 0 or launches[other]:
                fail(f"{what}: launches {launches}")
            paths[f"mesh {nshards} shards R-MAT {scale} {name} {exchange}, "
                  "card vs CPU"] = launches
            line.append(f"{exchange} {card_s:.2f} s, {launches[form]} "
                        f"{form}")
        print(f"  {name}: {len(one.phases)} phases, iterations "
              f"{[p.iterations for p in one.phases]}, Q "
              f"{one.modularity:.9f}; card = CPU = one shard under both "
              f"exchanges ({'; '.join(line)})")
    kw = {"coloring": 8, "exchange": "sparse"}
    full = louvain_phases(g, mesh=mesh, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        part = louvain_phases(g, mesh=mesh, checkpoint_dir=tmp, max_phases=1,
                              **kw)
        res = louvain_phases(g, mesh=mesh, checkpoint_dir=tmp, resume=True,
                             **kw)
    if len(part.phases) != 1 or len(full.phases) < 2:
        fail(f"R-MAT {scale} checkpoint: {len(part.phases)} and "
             f"{len(full.phases)} phases")
    check_same_run(f"R-MAT {scale} {nshards} shards coloring=8 sparse, "
                   "resumed vs uninterrupted", res, full)
    print(f"  coloring=8 sparse stopped after phase 0 (max_phases=1) and "
          f"resumed from its checkpoint: {len(res.phases)} phases, labels, "
          "iterations and Q equal to the uninterrupted run")
    return paths


def check_mesh_class_sweeps(g, scale: int, nshards: int,
                            n: int = 8) -> dict:
    """Phase 35: one coloring iteration's class plans on a mesh of
    ``nshards`` shards of one card against the same plans on the CPU, both
    exchanges: the classes of R-MAT --scale's coloring (``n`` hashes' worth),
    shard 1's vertices of class 0 moved to the last class so that class 0
    has no row there.  Two iterations from the identity (refreshed tables,
    then vertex ordering's frozen ones): each class step's targets,
    counter0 and overflow and the iteration's Q pass bit-equal, card
    against CPU.  Returns the card steps' launches by exchange."""
    import torch

    from cuvite_tpu_torch.comm.exchange import ExchangePlan
    from cuvite_tpu_torch.comm.mesh import make_mesh, shard_1d
    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.louvain.bucketed import (
        MeshPlan,
        build_mesh_class_plans,
        sharded_bucketed_modularity,
        sharded_bucketed_step,
    )
    from cuvite_tpu_torch.louvain.driver import _color_classes

    t0 = time.perf_counter()
    dg = DistGraph.build(g, nshards)
    nv = dg.nv_pad
    cls, n_classes = _color_classes(g, dg, n, "cuda", False)
    sub = cls[nv:2 * nv]
    sub[sub == 0] = n_classes - 1
    const = 1.0 / dg.graph.total_edge_weight_twice()
    vdeg_np = dg.padded_weighted_degrees().astype(np.float32)
    paths = {}
    print(f"  {n_classes} classes; class 0 emptied on shard 1; colored "
          f"and laid out in {time.perf_counter() - t0:.2f} s")
    for exchange in ("replicated", "sparse"):
        t0 = time.perf_counter()
        xplan = ExchangePlan.build(dg) if exchange == "sparse" else None
        host = build_mesh_class_plans(dg, cls, n_classes,
                                      exchange_plan=xplan)
        plan_s = time.perf_counter() - t0
        meshes = {}
        for dev in ("cuda", "cpu"):
            mesh = make_mesh(devices=[torch.device(dev)] * nshards)
            vdeg = shard_1d(mesh, vdeg_np)
            mps = []
            for plans in host:
                mps.append(MeshPlan.upload(
                    plans, mesh, nv, vdeg, exchange=exchange, xplan=xplan,
                    budget=min(max(128, nv // 4), nv),
                    shared=mps[0] if mps else None))
            meshes[dev] = (mesh, vdeg, mps)
        empty = meshes["cpu"][2][0].plans[1]
        if empty.buckets or empty.heavy is not None:
            fail("class 0 still has rows on shard 1")
        hubs = sum(int(mp.heavy_edges[i][0].numel() > 0
                       if exchange == "sparse"
                       else mp.plans[i].heavy is not None)
                   for mp in meshes["cpu"][2] for i in range(nshards))
        works = {d: shard_1d(meshes[d][0],
                             np.arange(nshards * nv, dtype=np.int32))
                 for d in meshes}
        launches = {}
        card_s = cpu_s = 0.0
        for it, frozen in ((0, False), (1, True)):
            info = dict(works) if frozen else {d: None for d in works}
            mods = {}
            for d in meshes:
                mesh, vdeg, mps = meshes[d]
                mods[d] = [float(x) for x in sharded_bucketed_modularity(
                    mps, works[d], vdeg, const)]
            if mods["cuda"] != mods["cpu"]:
                fail(f"{exchange} class sweep {it}: Q pass {mods}")
            moved = 0
            for c in range(n_classes):
                out = {}
                for d in meshes:
                    mesh, vdeg, mps = meshes[d]
                    if d == "cuda":
                        torch.cuda.synchronize()
                        zero_kernel_counts()
                    t1 = time.perf_counter()
                    out[d] = sharded_bucketed_step(
                        mps[c], works[d], vdeg, const, info_comms=info[d])
                    if d == "cuda":
                        torch.cuda.synchronize()
                        card_s += time.perf_counter() - t1
                        for k, v in kernel_counts().items():
                            launches[k] = launches.get(k, 0) + v
                    else:
                        cpu_s += time.perf_counter() - t1
                rg, rc = out["cuda"], out["cpu"]
                for a, b, what in ((rg.targets, rc.targets, "targets"),
                                   (rg.counter0, rc.counter0, "counter0")):
                    if not all(torch.equal(x.cpu(), y)
                               for x, y in zip(a, b)):
                        fail(f"{exchange} class {c} of {n_classes}, "
                             f"iteration {it}: {what} differ card vs CPU")
                if bool(rg.overflow) != bool(rc.overflow) or \
                        int(rg.n_moved) != int(rc.n_moved):
                    fail(f"{exchange} class {c}, iteration {it}: overflow "
                         "or moves differ card vs CPU")
                moved += int(rc.n_moved)
                works = {"cuda": rg.targets, "cpu": rc.targets}
            print(f"  {exchange} class sweep {it} "
                  f"({'frozen' if frozen else 'refreshed'} tables): "
                  f"{n_classes} class steps, {moved} moves, Q "
                  f"{mods['cpu'][0]:.9f}; targets, counter0, overflow and "
                  "Q bit-equal on card and CPU")
        form = "row_argmax_sized" if exchange == "sparse" else "row_argmax"
        if launches.get(form, 0) == 0 or (
                exchange == "replicated" and hubs
                and launches.get("heavy_bincount", 0) == 0):
            fail(f"{exchange} class sweeps: launches {launches}")
        print(f"  {exchange}: plans built in {plan_s:.2f} s, {hubs} "
              f"(class, shard) plans with hubs; the {2 * n_classes} class "
              f"steps {card_s:.3f} s on the card (synchronized per step), "
              f"{cpu_s:.3f} s on the twins; launches {launches}")
        paths[f"mesh {nshards} shards class sweeps R-MAT {scale} "
              f"{exchange}, card vs CPU"] = launches
    return paths


def run_mesh_schedule_full(g, scale: int, nshards: int, kw: dict,
                           one=None) -> tuple:
    """Phase 35: a schedule at full width on ``nshards`` shards of one
    card, launch counts zeroed just before and read just after; per
    phase the stages; fails unless Q is within 1e-6 of the host f64
    modularity and (given ``one``) the labels equal one shard's.  Returns
    (launches, wall s, LouvainResult)."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.evaluate.modularity import modularity

    mesh = make_mesh(devices=[torch.device("cuda", 0)] * nshards)
    name = _kw_name(kw)
    torch.cuda.synchronize()
    zero_kernel_counts()
    t0 = time.perf_counter()
    res = louvain_phases(g, mesh=mesh, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    for p in res.phases:
        st = " ".join(f"{k} {v:.3f}" for k, v in p.stages.items())
        print(f"    phase {p.phase}: nv {p.num_vertices} ne {p.num_edges} "
              f"iterations {p.iterations} Q {p.modularity:.9f} seconds "
              f"{p.seconds:.3f} ({st})")
    print(f"  {name} on {nshards} shards of one card, R-MAT {scale}: "
          f"{wall:.3f} s, {res.total_iterations} sweeps, {len(res.phases)} "
          f"phases, Q {res.modularity:.9f}; launches {launches}")
    q_host = modularity(g, res.communities)
    if abs(q_host - res.modularity) > 1e-6:
        fail(f"{name} mesh: reported Q {res.modularity} vs host f64 "
             f"{q_host}")
    if one is not None and not np.array_equal(res.communities,
                                              one.communities):
        fail(f"{name} mesh: labels differ from one shard's (phase 14)")
    form = ("row_argmax_sized" if kw.get("exchange") == "sparse"
            else "row_argmax")
    if launches[form] == 0:
        fail(f"{name} mesh: {form} never launched")
    return launches, wall, res


# ---------------------------------------------------------------------------
# Phase 32: the native host runtime against its numpy paths.


def _np_same(a, b) -> bool:
    """Equal dtypes, shapes and bits."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _timed(fn) -> tuple:
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _graphs_equal(a, b) -> bool:
    return all(_np_same(getattr(a, n), getattr(b, n))
               for n in ("offsets", "tails", "weights"))


def _plans_equal(a, b) -> bool:
    if len(a.buckets) != len(b.buckets) or a.has_heavy != b.has_heavy:
        return False
    for x, y in zip(a.buckets, b.buckets):
        if x.width != y.width or not all(
                _np_same(getattr(x, f), getattr(y, f))
                for f in ("verts", "dst", "w")):
            return False
    return all(_np_same(getattr(a, f), getattr(b, f))
               for f in ("heavy_src", "heavy_dst", "heavy_w", "self_loop",
                         "deg"))


def check_native(scale: int, rmat_scale: int, main_res) -> dict:
    """Phase 32: each routine of the native host runtime on this host
    against its numpy path (``CUVITE_NO_NATIVE=1``) on the same inputs,
    bit-equal, with both times; the call counts prove which path ran.
    ``main_res`` is a run of R-MAT ``scale`` (phase 22's, at
    BENCH_SCALE: phase 5 runs the native paths at --scale already)."""
    from cuvite_tpu_torch import native
    from cuvite_tpu_torch.coarsen.rebuild import (
        coarsen_graph,
        renumber_communities,
    )
    from cuvite_tpu_torch.core.distgraph import DistGraph, balanced_parts
    from cuvite_tpu_torch.core.graph import Graph
    from cuvite_tpu_torch.io.generate import rmat_edges_numpy
    from cuvite_tpu_torch.io.vite import read_vite, write_vite
    from cuvite_tpu_torch.louvain.bucketed import BucketPlan

    rows = {}

    def both(name, routines, fn, same=None):
        native.zero_call_counts()
        got, nat_s = _timed(fn)
        calls = native.call_counts()
        if not all(calls[r] for r in routines):
            fail(f"native {name}: {routines} not called ({calls})")
        os.environ["CUVITE_NO_NATIVE"] = "1"
        try:
            want, np_s = _timed(fn)
        finally:
            del os.environ["CUVITE_NO_NATIVE"]
        if native.call_counts() != calls:
            fail(f"native {name}: called with CUVITE_NO_NATIVE=1")
        if not (same or _graphs_equal)(got, want):
            fail(f"native {name}: differs from its numpy path")
        rows[name] = {"native_s": nat_s, "numpy_s": np_s}
        print(f"  {name}: native {nat_s:.3f} s, numpy {np_s:.3f} s "
              f"({np_s / max(nat_s, 1e-9):.2f}x), bit-equal")
        return got

    ne = 16 << rmat_scale

    def rmat():
        if native.available():
            return native.rmat_edges(rmat_scale, ne, 1, 0.57, 0.19, 0.19)
        return rmat_edges_numpy(rmat_scale, ne, 1, 0.57, 0.19, 0.19)

    src, dst = both(f"R-MAT {rmat_scale} edges ({ne})", ["rmat_edges"],
                    rmat, lambda a, b: all(map(_np_same, a, b)))

    nv = 1 << scale
    s20, d20 = native.rmat_edges(scale, 16 << scale, 1, 0.57, 0.19, 0.19)
    keep = s20 != d20
    s20, d20 = s20[keep].astype(np.int32), d20[keep].astype(np.int32)
    g = both(f"from_edges R-MAT {scale} ({len(s20)} edges, unit)",
             ["build_csr_unit"], lambda: Graph.from_edges(nv, s20, d20))
    del s20, d20, keep
    both(f"weighted_degrees R-MAT {scale}", ["weighted_degrees"],
         g.weighted_degrees, _np_same)
    both(f"balanced_parts R-MAT {scale}, 4 parts", ["balanced_parts"],
         lambda: (native.balanced_parts(g.offsets, 4)
                  if native.available() else balanced_parts(g, 4)),
         _np_same)
    dg = DistGraph.build(g)
    both(f"phase-0 plan R-MAT {scale}", ["plan_scan", "bucket_fill"],
         lambda: BucketPlan.build(dg.src, dg.dst, dg.w, nv_local=dg.nv_pad),
         _plans_equal)
    del dg
    dense, nc = renumber_communities(main_res.communities)
    both(f"coarsen R-MAT {scale} onto phase 22's {nc} communities",
         ["coarsen_csr"], lambda: coarsen_graph(g, dense, nc))
    del g

    n = 1 << rmat_scale
    w = np.random.default_rng(1).integers(1, 64, size=len(src)) / 16.0
    both(f"from_edges R-MAT {rmat_scale} weighted (generic builder)",
         ["build_csr"], lambda: Graph.from_edges(n, src, dst, weights=w))
    g18 = both(f"build_csr_w R-MAT {rmat_scale} weighted",
               ["build_csr_w"],
               lambda: Graph.from_arrays(*native.build_csr_w(n, src, dst, w))
               if native.available() else
               Graph.from_edges(n, src, dst, weights=w))
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    paths = [os.path.join(work, f"native-{k}.vite") for k in ("a", "b")]

    def write():
        path = paths[0] if native.available() else paths[1]
        write_vite(path, g18, bits64=False)
        with open(path, "rb") as f:
            return f.read()

    both(f"write_vite R-MAT {rmat_scale} (32-bit)", ["vite_write"], write,
         lambda a, b: a == b)
    both(f"read_vite R-MAT {rmat_scale} (32-bit)", ["vite_edges"],
         lambda: read_vite(paths[0], bits64=False))
    if native.vite_header(paths[0], False) != (n, g18.num_edges):
        fail("native vite_header differs from the graph's nv, ne")
    for p in paths:
        os.unlink(p)
    print("  vite_header: (nv, ne) of the file written")
    return rows


# ---------------------------------------------------------------------------
# Phases 33-34: one rank per card over torch.distributed (NCCL).

MAX_WORLD = 4
WORLD_TIMEOUT_S = 900


# ---------------------------------------------------------------------------
# Phase 36: the two-level exchange on a hybrid mesh and the batch axis.

TWOLEVEL_RUN = "twolevel 2x2"
HYBRID = (2, 2)


def check_twolevel_card_vs_cpu(scale: int, nshards: int, work: str
                               ) -> dict:
    """Phase 36 at R-MAT --check-scale on 4 shards of the card: the 2x2
    and 4x1 hybrid meshes against the flat sparse mesh, the CPU and one
    shard; ET mode 3, a checkpoint resume and a budget of 1 on 2x2; the
    CLI's --mesh 2x2 --json --diag-prefix.  Returns the runs' launches."""
    import tempfile

    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_hybrid_mesh, make_mesh
    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.louvain.driver import MeshPhaseRunner

    g = generate_rmat(scale)
    devs = [torch.device("cuda", 0)] * nshards
    one = louvain_phases(g, device="cuda")
    flat = louvain_phases(g, mesh=make_mesh(devices=devs), exchange="sparse")
    check_same_run(f"R-MAT {scale} flat sparse vs one shard", flat, one)
    paths, runs = {}, {}
    for shape in (HYBRID, (4, 1)):
        name = "%dx%d" % shape
        zero_kernel_counts()
        t0 = time.perf_counter()
        rg = louvain_phases(g, mesh=make_hybrid_mesh(*shape, devices=devs))
        card_s = time.perf_counter() - t0
        launches = kernel_counts()
        t0 = time.perf_counter()
        rc = louvain_phases(g, mesh_shape=shape, device="cpu")
        cpu_s = time.perf_counter() - t0
        check_same_run(f"R-MAT {scale} {name} card vs CPU", rg, rc)
        for other, r in (("flat sparse", flat), ("one shard", one)):
            check_same_run(f"R-MAT {scale} {name} vs {other}", rg, r)
        if rg.modularity != flat.modularity or \
                rc.modularity != flat.modularity:
            fail(f"R-MAT {scale} {name}: Q bits differ from the flat sparse "
                 "run's")
        mode = rg.exchange_stats["mode"]
        if mode != ("twolevel" if shape[1] > 1 else "sparse"):
            fail(f"R-MAT {scale} {name}: exchange {mode}")
        if launches["row_argmax_sized"] == 0 or launches["row_argmax"]:
            fail(f"R-MAT {scale} {name}: launches {launches}")
        paths[f"mesh {name} R-MAT {scale}, card vs CPU"] = launches
        runs[name] = rg
        print(f"  R-MAT {scale}, {name} on one card: {len(rg.phases)} "
              f"phases, {rg.total_iterations} sweeps, Q {rg.modularity!r}, "
              f"exchange {rg.exchange_stats}; equal to the CPU, the flat "
              f"sparse mesh and one shard ({card_s:.2f} s card, "
              f"{cpu_s:.2f} s CPU); launches {launches}")
    hyb = make_hybrid_mesh(*HYBRID, devices=devs)
    zero_kernel_counts()
    et = louvain_phases(g, mesh=hyb, et_mode=3)
    paths[f"mesh 2x2 R-MAT {scale} et_mode=3"] = kernel_counts()
    for other, kw in (("flat sparse", {"mesh": make_mesh(devices=devs),
                                       "exchange": "sparse"}),
                      ("CPU 2x2", {"mesh_shape": HYBRID, "device": "cpu"})):
        check_same_run(f"R-MAT {scale} 2x2 et_mode=3 vs {other}", et,
                       louvain_phases(g, et_mode=3, **kw))
    with tempfile.TemporaryDirectory() as ck:
        part = louvain_phases(g, mesh=hyb, max_phases=1, checkpoint_dir=ck)
        resumed = louvain_phases(g, mesh=hyb, checkpoint_dir=ck,
                                 resume=True)
    if len(part.phases) != 1:
        fail(f"2x2 checkpointed run ran {len(part.phases)} phases")
    check_same_run(f"R-MAT {scale} 2x2 resumed vs uninterrupted", resumed,
                   runs["2x2"])
    r = MeshPhaseRunner(DistGraph.build(g, nshards), hyb,
                        exchange="twolevel", budget=1)
    comm, seen = r.comm0, 0
    for _ in range(4):
        res = r.step(comm)
        seen += bool(res.overflow)
        comm = res.targets
    if not seen:
        fail("2x2 budget 1 never overflowed")
    log = ExchangeLog()
    zero_kernel_counts()
    rt = louvain_phases(g, mesh=hyb, exchange_budget=1, tracer=log)
    paths[f"mesh 2x2 budget-1 retry R-MAT {scale}"] = kernel_counts()
    budgets = [e["budget"] for e in log.events]
    check_same_run(f"R-MAT {scale} 2x2 budget 1 vs one shard", rt, one)
    if not 1 < budgets[0] <= r.budget_cap:
        fail(f"2x2 budget 1: budgets {budgets}, group window "
             f"{r.budget_cap}")
    print(f"  2x2: et_mode=3 equal to the flat sparse and CPU runs; a "
          f"max_phases=1 run resumed from its checkpoint equal to the "
          f"uninterrupted run; budget 1: {seen} of 4 runner sweeps "
          f"overflowed, the driver's budgets by phase {budgets} (group "
          f"window {r.budget_cap}), labels equal to one shard's")
    prefix = os.path.join(work, "diag2x2", "rmat")
    out = cli_child(["-m", "cuvite_tpu_torch.cli", "--rmat", str(scale),
                     "--mesh", "2x2", "--device", "cuda:0", "--json",
                     "--quiet", "--diag-prefix", prefix], work)
    rec = json.loads(out.strip().splitlines()[-1])
    want = {k: runs["2x2"].exchange_stats[k] for k in (
        "mode", "dcn", "ici", "table_bytes_per_device", "ghost_bytes")}
    if rec.get("exchange") != want:
        fail(f"CLI --mesh 2x2: exchange block {rec.get('exchange')} vs "
             f"{want}")
    if (rec["communities"], rec["iterations"]) != (
            runs["2x2"].num_communities, runs["2x2"].total_iterations):
        fail(f"CLI --mesh 2x2: {rec} vs the library's 2x2 run")
    n_lines = len(runs["2x2"].convergence)
    for sh in range(nshards):
        with open(f"{prefix}.{sh}") as f:
            lines = f.read().splitlines()
        if len(lines) != n_lines or not lines[0].startswith(
                "phase 0: owned="):
            fail(f"--diag-prefix shard {sh}: {lines[:2]} ({len(lines)} "
                 f"lines, want {n_lines})")
    with open(f"{prefix}.0") as f:
        first = f.readline().strip()
    print(f"  CLI --mesh 2x2 --json: exchange {rec['exchange']}; one line "
          f"a shard and phase, {prefix}.0 begins: {first}")
    return paths


def check_batch_mesh(gs, kind: str) -> dict:
    """Phase 36's batch axis: ``kind``'s jobs on two blocks of the card
    (``make_batch_mesh(64, devices=[cuda:0] * 2)``), both engines, against
    the same batch with ``mesh=None`` and each block against its own
    B/2 batch: labels and Q equal; walls, jobs/s and launches side by
    side."""
    import torch

    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.louvain.batched import make_batch_mesh

    dev = torch.device("cuda", 0)
    mesh = make_batch_mesh(len(gs), devices=[dev] * 2)
    if mesh is None or mesh.size != 2:
        fail(f"make_batch_mesh({len(gs)}, 2 devices) gave {mesh}")
    half = len(gs) // 2
    paths = {}
    for engine in ("bucketed", "fused"):
        out = {}
        for name, kw, jobs in (("one block", {"mesh": None}, gs),
                               ("two blocks", {"mesh": mesh}, gs),
                               ("block 0 alone", {"mesh": None}, gs[:half]),
                               ("block 1 alone", {"mesh": None},
                                gs[half:])):
            torch.cuda.synchronize()
            zero_kernel_counts()
            t0 = time.perf_counter()
            br = louvain_many(jobs, engine=engine, **kw)
            torch.cuda.synchronize()
            out[name] = (br, time.perf_counter() - t0, kernel_counts())
        one, two = out["one block"][0], out["two blocks"][0]
        halves = out["block 0 alone"][0].results + \
            out["block 1 alone"][0].results
        for k, (a, b, c) in enumerate(zip(two.results, one.results,
                                          halves)):
            for other, r in (("mesh=None", b), ("its block alone", c)):
                if not np.array_equal(a.communities, r.communities) or \
                        a.modularity != r.modularity:
                    fail(f"{kind} {engine} two blocks: tenant {k} differs "
                         f"from {other}")
        paths[f"{kind} {engine}, two blocks of the card"] = \
            out["two blocks"][2]
        print(f"  {kind} {engine}: "
              + "; ".join(f"{name} wall {wall:.3f} s "
                          f"({br.n_jobs / wall:.1f} jobs/s), engines "
                          f"{br.phase_engines}, launches {la}"
                          for name, (br, wall, la) in out.items())
              + "; every tenant of the two blocks equal to mesh=None and "
              "to its block's own batch")
    return paths


def batch_worker(spec_json: str) -> int:
    """``chip_smoke.py --batch-worker SPEC``: with every offered card
    visible, the spec's serving batch on card 0 alone and with
    mesh="auto" (one block a card), both engines, each run once to load
    and once timed; prints one JSON record."""
    spec = json.loads(spec_json)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.louvain.batched import make_batch_mesh

    gs = serving_jobs(spec["kind"])
    n = torch.cuda.device_count()
    mesh = make_batch_mesh(len(gs))
    rec = {"cards": n, "blocks": mesh.size if mesh else 1, "runs": {}}

    def sync():
        for i in range(n):
            torch.cuda.synchronize(i)

    for engine in ("bucketed", "fused"):
        res = {}
        for name, kw in (("card 0", {"mesh": None}),
                         ("auto", {"mesh": "auto"})):
            louvain_many(gs, engine=engine, **kw)
            sync()
            zero_kernel_counts()
            t0 = time.perf_counter()
            br = louvain_many(gs, engine=engine, **kw)
            sync()
            wall = time.perf_counter() - t0
            res[name] = br
            rec["runs"][f"{engine} {name}"] = {
                "wall_s": wall, "jobs_per_s": br.n_jobs / wall,
                "pack_s": br.pack_s, "launches": kernel_counts()}
        rec["runs"][f"{engine} equal"] = all(
            np.array_equal(a.communities, b.communities)
            and a.modularity == b.modularity
            for a, b in zip(res["auto"].results, res["card 0"].results))
    print(json.dumps(rec))
    return 0


def run_batch_auto(cards: list, kind: str) -> dict:
    """Phase 36 on a host of several cards: :func:`batch_worker` in a
    child that sees up to four of them."""
    root = os.path.dirname(os.path.abspath(__file__))
    use = cards[:MAX_WORLD]
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES=",".join(use))
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--batch-worker", json.dumps({"kind": kind})],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    if out.returncode:
        fail(f"batch worker exit {out.returncode}: {out.stderr[-3000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    if rec["blocks"] != len(use):
        fail(f"mesh='auto' over {len(use)} cards made {rec['blocks']} "
             "blocks")
    paths = {}
    for engine in ("bucketed", "fused"):
        if not rec["runs"][f"{engine} equal"]:
            fail(f"{kind} {engine}: mesh='auto' over {len(use)} cards "
                 "differs from card 0 alone")
        a, b = rec["runs"][f"{engine} auto"], rec["runs"][f"{engine} card 0"]
        paths[f"{kind} {engine}, mesh='auto' over {len(use)} cards"] = \
            a["launches"]
        print(f"  {kind} {engine}, mesh='auto' over {len(use)} cards: "
              f"{a['wall_s']:.3f} s, {a['jobs_per_s']:.1f} jobs/s (pack "
              f"{a['pack_s']:.3f} s) vs card 0 alone {b['wall_s']:.3f} s, "
              f"{b['jobs_per_s']:.1f} jobs/s (pack {b['pack_s']:.3f} s); "
              f"launches {a['launches']} vs {b['launches']}; labels equal")
    return paths


def time_hybrid_collectives(nshards: int, nv_pad: int, block: int) -> dict:
    """On a rank of phase 33: the two-level exchange's two collectives on
    the 2x2 mesh at R-MAT --scale's phase-0 shapes, timed with CUDA
    events on this rank's card (20 calls after 3): the ICI group's tiled
    all-gather of each shard's [nv_pad] community vector, and the DCN
    column's ghost-pull all_to_all of [dcn, B, 3] int32 blocks at group
    scale.  Bytes sent are the rank's own payload to process groups
    (none for a view whose shards are all on this rank)."""
    import torch

    from cuvite_tpu_torch.comm.collectives import (
        all_gather,
        all_to_all,
        sent_bytes,
        zero_sent_bytes,
    )
    from cuvite_tpu_torch.comm.mesh import make_hybrid_mesh

    dcn, ici = HYBRID
    mesh = make_hybrid_mesh(dcn, ici)
    dev = mesh.devices[0]
    cases = {
        "ICI all_gather of the community vector": (
            all_gather, mesh.ici_views,
            lambda: torch.ones(nv_pad, dtype=torch.int32, device=dev)),
        "DCN all_to_all ghost pull": (
            all_to_all, mesh.dcn_views,
            lambda: torch.ones(dcn, block, 3, dtype=torch.int32,
                               device=dev)),
    }
    out = {}
    for name, (fn, views, make) in cases.items():
        xs = [[make() for _ in pos] for _, pos in views]

        def call():
            for (view, _), x in zip(views, xs):
                fn(x, view)

        for _ in range(3):
            call()
        torch.cuda.synchronize(dev)
        zero_sent_bytes()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(20):
            call()
        t1.record()
        torch.cuda.synchronize(dev)
        out[name] = {"ms": t0.elapsed_time(t1) / 20,
                     "sent_bytes": sent_bytes() // 20,
                     "views": [list(view.shard_ids) for view, _ in views],
                     "group": [view.group is not None for view, _ in views]}
    return out


def world_cards(visible) -> list:
    """The cards this host offers, as CUDA_VISIBLE_DEVICES entries: the
    caller's list, else every index nvidia-smi reports."""
    if visible is not None:
        return [c for c in visible.split(",") if c]
    out = subprocess.run(["nvidia-smi", "--query-gpu=index",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def time_collectives(nshards: int, nv_pad: int, block: int) -> dict:
    """On a rank of phase 33: the two collectives that move most of a
    sweep's bytes, at R-MAT --scale's phase-0 shapes, timed with CUDA
    events on this rank's card (20 calls after 3): the all-gather under
    the replicated exchange's psum of each shard's f64 degree table over
    every community ([S * nv_pad] f64 a shard), and the sparse exchange's
    ghost pull (an all_to_all of [S, B, 3] int32 blocks a shard).  Bytes
    sent are the rank's own payload; received, what lands on its card."""
    import torch

    from cuvite_tpu_torch.comm.collectives import (
        all_gather,
        all_to_all,
        sent_bytes,
        zero_sent_bytes,
    )
    from cuvite_tpu_torch.comm.mesh import make_mesh

    mesh = make_mesh(nshards)
    dev, L = mesh.devices[0], len(mesh.devices)
    cases = {
        "all_gather f64 degree tables": (all_gather, [
            torch.ones(nshards * nv_pad, dtype=torch.float64, device=dev)
            for _ in range(L)], nshards),
        "all_to_all ghost pull": (all_to_all, [
            torch.ones(nshards, block, 3, dtype=torch.int32, device=dev)
            for _ in range(L)], 1),
    }
    out = {}
    for name, (fn, xs, fan_in) in cases.items():
        for _ in range(3):
            fn(xs, mesh)
        torch.cuda.synchronize(dev)
        zero_sent_bytes()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(20):
            fn(xs, mesh)
        t1.record()
        torch.cuda.synchronize(dev)
        ms = t0.elapsed_time(t1) / 20
        sent = sent_bytes() // 20
        # An all-gather lands every shard's block on each rank; an
        # all_to_all lands as much as the rank sent.
        recv = sent * (nshards // L if fan_in > 1 else 1)
        out[name] = {"ms": ms, "sent_bytes": sent, "recv_bytes": recv,
                     "recv_gb_per_s": recv / ms / 1e6}
    return out


def rank_worker(spec_json: str) -> int:
    """One NCCL rank of phases 33-34 (``chip_smoke.py --rank-worker
    SPEC``, started by :func:`run_world`): join the world, load R-MAT
    --scale (generated, or read per rank with DistVite), run
    louvain_phases on its shards once per exchange with the launch counts
    zeroed just before and read just after, and write its labels and a
    JSON record to the spec's directory."""
    spec = json.loads(spec_json)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from cuvite_tpu_torch.comm import multihost

    t0 = time.perf_counter()
    multihost.initialize(timeout=WORLD_TIMEOUT_S)
    init_s = time.perf_counter() - t0
    with multihost.fail_together():
        from cuvite_tpu_torch import louvain_phases
        from cuvite_tpu_torch.comm.collectives import (
            sent_bytes,
            zero_sent_bytes,
        )
        from cuvite_tpu_torch.io.dist_ingest import DistVite
        from cuvite_tpu_torch.io.generate import generate_rmat

        r = multihost.rank()
        rec = {"rank": r, "world": multihost.world_size(), "init_s": init_s,
               "device": str(multihost.local_device()),
               "card": torch.cuda.get_device_name(), "runs": {}}
        t0 = time.perf_counter()
        if spec["path"]:
            g = DistVite.load(spec["path"], spec["nshards"], bits64=False)
            rec["bytes_read"] = g.bytes_read
            rec["file_bytes"] = os.path.getsize(spec["path"])
            rec["held"] = [s for s, sh in enumerate(g.shards)
                           if sh.src is not None]
        else:
            g = generate_rmat(spec["scale"])
        rec["load_s"] = time.perf_counter() - t0
        for i, (name, kw) in enumerate(spec["runs"]):
            kw = dict(kw)
            if "checkpoint_dir" in kw:   # shared by the ranks
                kw["checkpoint_dir"] = os.path.join(spec["out"],
                                                    kw["checkpoint_dir"])
            log = ExchangeLog()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_sent_bytes()
            zero_kernel_counts()
            t0 = time.perf_counter()
            res = louvain_phases(g, nshards=spec["nshards"], tracer=log,
                                 **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            np.save(os.path.join(spec["out"], f"run{i}-rank{r}.npy"),
                    res.communities)
            rec["runs"][name] = {
                "wall_s": wall, "launches": kernel_counts(),
                "sent_bytes": sent_bytes(),
                "iterations": [p.iterations for p in res.phases],
                "sweeps": res.total_iterations,
                "q": res.modularity.hex(),
                "stages": [p.stages for p in res.phases],
                "exchange": log.events,
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if spec.get("collectives"):
            rec["collectives"] = time_collectives(spec["nshards"],
                                                  *spec["collectives"])
        if spec.get("hybrid_collectives"):
            rec["hybrid_collectives"] = time_hybrid_collectives(
                spec["nshards"], *spec["hybrid_collectives"])
        with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
            json.dump(rec, f)
        multihost.shutdown()
    return 0


def run_world(what: str, cards: list, spec: dict) -> list:
    """Start one rank per card of ``cards`` on ``spec`` (a ``file://``
    store in a temporary directory, NCCL and gloo on the loopback
    interface); fails unless every rank exits 0.  Returns the ranks'
    records."""
    import tempfile

    import torch

    from cuvite_tpu_torch.comm.multihost import launch

    torch.cuda.empty_cache()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=",".join(cards))
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("OMP_NUM_THREADS",
                   str(max((os.cpu_count() or 1) // len(cards), 1)))
    with tempfile.TemporaryDirectory() as tmp:
        spec = dict(spec, out=tmp)
        t0 = time.perf_counter()
        outs = launch([sys.executable, os.path.abspath(__file__),
                       "--rank-worker", json.dumps(spec)], len(cards),
                      f"file://{os.path.join(tmp, 'store')}", env=env,
                      timeout=WORLD_TIMEOUT_S, grace=60.0)
        wall = time.perf_counter() - t0
        for r, (rc, out, err) in enumerate(outs):
            if rc != 0:
                print(f"  rank {r} of {what} exited {rc}:\n{out[-2000:]}\n"
                      f"{err[-6000:]}", file=sys.stderr)
                fail(f"{what}: rank {r} exited {rc}")
        recs = []
        for r in range(len(cards)):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                rec = json.load(f)
            rec["labels"] = {name: np.load(os.path.join(
                tmp, f"run{i}-rank{r}.npy"))
                for i, (name, _) in enumerate(spec["runs"])}
            recs.append(rec)
    print(f"  {what}: world of {len(cards)} on cards {cards} "
          f"({recs[0]['card']}), {wall:.1f} s with process start and load")
    return recs


def print_inits(recs: list) -> None:
    print("  joining the group (multihost.initialize, the NCCL "
          "communicator and its peer links included): "
          + ", ".join(f"rank {rec['rank']} {rec['init_s']:.2f} s"
                      for rec in recs))


def check_world(what: str, recs: list, one_process: dict,
                nshards: int) -> dict:
    """Each rank's labels, iterations and Q bits against the one-process
    run of the same exchange (phase 30), the launches summed over the
    ranks against its launches; prints per rank the stage walls, the
    launches and the bytes it handed to the collectives (counted in
    ``comm/collectives.py``), over the run and a sweep.  Returns the
    summed launches by exchange."""
    summed = {}
    for ex, (res, launches, wall1) in one_process.items():
        if ex not in recs[0]["runs"]:
            continue
        total = {}
        for rec in recs:
            run = rec["runs"][ex]
            if not np.array_equal(rec["labels"][ex], res.communities):
                fail(f"{what} {ex}: rank {rec['rank']}'s labels differ from "
                     "the one-process mesh's")
            if run["iterations"] != [p.iterations for p in res.phases]:
                fail(f"{what} {ex}: rank {rec['rank']} iterations "
                     f"{run['iterations']} vs one process "
                     f"{[p.iterations for p in res.phases]}")
            q = float.fromhex(run["q"])
            if abs(q - res.modularity) > 1e-9:
                fail(f"{what} {ex}: rank {rec['rank']} Q {q} vs one "
                     f"process {res.modularity}")
            for k, v in run["launches"].items():
                total[k] = total.get(k, 0) + v
            local = nshards // rec["world"]
            sweeps = max(run["sweeps"], 1)
            stages = {k: sum(st.get(k, 0.0) for st in run["stages"])
                      for k in ("plan", "upload", "iterate", "evaluate",
                                "coarsen")}
            print(f"  {what} {ex} rank {rec['rank']} ({rec['device']}, "
                  f"{local} shards): wall {run['wall_s']:.3f} s; stages "
                  + " ".join(f"{k} {v:.3f}" for k, v in stages.items())
                  + f"; phase-0 stages "
                  + " ".join(f"{k} {v:.3f}"
                             for k, v in run["stages"][0].items())
                  + f"; launches {run['launches']}; bytes sent "
                  f"{run['sent_bytes']} over {sweeps} sweeps, "
                  f"{run['sent_bytes'] / sweeps:.0f} a sweep; peak "
                  f"{run['max_memory_allocated']} B")
        want = {k: v for k, v in (launches or total).items() if v}
        if {k: v for k, v in total.items() if v} != want:
            fail(f"{what} {ex}: launches over the ranks {total} vs one "
                 f"process {launches}")
        print(f"  {what} {ex}: labels, iterations and Q equal the "
              f"one-process mesh's on every rank; launches over the ranks "
              f"{total} (one process: {launches}); walls "
              f"{[round(rec['runs'][ex]['wall_s'], 3) for rec in recs]} s "
              f"(one process {wall1:.3f} s)")
        summed[ex] = total
    return summed


def run_multiprocess(g, scale: int, nshards: int, cards: list,
                     one_process: dict) -> dict:
    """Phases 33-34 on the world of min(len(cards), MAX_WORLD) ranks, held
    against phase 30's one-process runs.  Returns the summed launches by
    path."""
    import tempfile

    from cuvite_tpu_torch.core.types import next_pow2
    from cuvite_tpu_torch.io.vite import write_vite

    world = min(len(cards), MAX_WORLD)
    paths = {}
    print(f"[33] R-MAT {scale} on {nshards} shards, one NCCL rank per card "
          f"(world {world}), replicated and sparse")
    t0 = time.perf_counter()
    # The sparse exchange's phase-0 block on this graph (phase 30).
    block = one_process["sparse"][0].exchange_stats["block"]
    nv_pad = next_pow2(-(-g.num_vertices // nshards))
    runs = [[ex, {"exchange": ex}] for ex in ("replicated", "sparse")]
    hybrid = None
    if TWOLEVEL_RUN in one_process:
        # Phase 36's one-process 2x2 run is the reference of this one.
        runs.append([TWOLEVEL_RUN, {"mesh_shape": list(HYBRID)}])
        hybrid = [nv_pad, one_process[TWOLEVEL_RUN][0].exchange_stats[
            "block"]]
    recs = run_world(f"R-MAT {scale}", cards[:world], {
        "scale": scale, "nshards": nshards, "path": None, "runs": runs,
        "collectives": [nv_pad, block], "hybrid_collectives": hybrid})
    for ex, tot in check_world(f"R-MAT {scale}", recs, one_process,
                               nshards).items():
        paths[f"world {world}, {nshards} shards R-MAT {scale} {ex}"] = tot
    print_inits(recs)
    for rec in recs:
        for name, c in rec["collectives"].items():
            print(f"  rank {rec['rank']} {name} (nv_pad {nv_pad}, block "
                  f"{block}): {c['ms']:.4f} ms, sent {c['sent_bytes']} B, "
                  f"received {c['recv_bytes']} B, "
                  f"{c['recv_gb_per_s']:.1f} GB/s received")
        for name, c in (rec.get("hybrid_collectives") or {}).items():
            print(f"  rank {rec['rank']} 2x2 {name} (nv_pad {nv_pad}, "
                  f"group block {hybrid[1]}): {c['ms']:.4f} ms, sent "
                  f"{c['sent_bytes']} B a call, views {c['views']}, over a "
                  f"process group {c['group']}")
    print(f"  phase 33 took {time.perf_counter() - t0:.1f} s")

    print(f"[34] per-rank ingest: R-MAT {scale} read by DistVite, world "
          f"{world}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"rmat{scale}.vite")
        t1 = time.perf_counter()
        write_vite(path, g, bits64=False)
        print(f"  wrote {os.path.getsize(path)} B (32-bit Vite) in "
              f"{time.perf_counter() - t1:.2f} s")
        # Phase 33 holds the plain sparse run over the ranks already; the
        # colored run here takes the same sparse exchange over DistVite,
        # stopped after phase 0 and resumed: the two runs together do the
        # uninterrupted run's work, and their summed launches must be its.
        color = {"exchange": "sparse", "coloring": 8}
        recs = run_world(f"DistVite R-MAT {scale}", cards[:world], {
            "scale": scale, "nshards": nshards, "path": path,
            "runs": [[COLOR_RUN + ", checkpointed",
                      dict(color, max_phases=1, checkpoint_dir="ck")],
                     [COLOR_RUN + ", resumed",
                      dict(color, resume=True, checkpoint_dir="ck")]]})
    per = nshards // world
    for rec in recs:
        r = rec["rank"]
        if rec["held"] != list(range(r * per, (r + 1) * per)):
            fail(f"DistVite rank {r} holds shards {rec['held']}")
        if world > 1 and rec["bytes_read"] >= rec["file_bytes"]:
            fail(f"DistVite rank {r} read {rec['bytes_read']} B of a "
                 f"{rec['file_bytes']} B file")
        print(f"  rank {r}: shards {rec['held']}, read {rec['bytes_read']} "
              f"B of {rec['file_bytes']} B in {rec['load_s']:.2f} s")
    print_inits(recs)
    for rec in recs:
        part = rec["runs"][COLOR_RUN + ", checkpointed"]
        if len(part["iterations"]) != 1:
            fail(f"DistVite rank {rec['rank']}: the checkpointed run ran "
                 f"{len(part['iterations'])} phases, not 1")
    res, launches, wall = one_process[COLOR_RUN]
    tot = check_world(f"DistVite R-MAT {scale}", recs, {
        COLOR_RUN + ", resumed": (res, None, wall)}, nshards)
    both = {}
    for rec in recs:
        for name in (COLOR_RUN + ", checkpointed", COLOR_RUN + ", resumed"):
            for k, v in rec["runs"][name]["launches"].items():
                both[k] = both.get(k, 0) + v
    if {k: v for k, v in both.items() if v} != \
            {k: v for k, v in launches.items() if v}:
        fail(f"DistVite R-MAT {scale} {COLOR_RUN}: the checkpointed and "
             f"resumed runs launched {both} over the ranks, the "
             f"uninterrupted one-process run {launches}")
    print(f"  DistVite R-MAT {scale} {COLOR_RUN}: checkpointed + resumed "
          f"launched {both} over the ranks, as the uninterrupted "
          f"one-process run (phase 35)")
    tot[COLOR_RUN + ", checkpointed + resumed"] = both
    for name, t in tot.items():
        paths[f"world {world} DistVite, {nshards} shards R-MAT {scale} "
              f"{name}"] = t
    print(f"  phase 34 took {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# Phase 37: the last runtime modules -- the converters, engine='pallas' and
# its coverage, the msd and hash coalesce engines.


def write_snap(path: str, g) -> None:
    """``g``'s undirected edges as a SNAP list: ``u<TAB>v`` a line, each
    pair once (u <= v), the way SNAP publishes its graphs."""
    src = g.sources().astype(np.int64)
    dst = g.tails.astype(np.int64)
    keep = src <= dst
    pairs = np.stack([src[keep], dst[keep]], 1)
    with open(path, "wb") as f:
        f.write(b"# Undirected graph: R-MAT (Graph500 a=0.57, b=c=0.19)\n")
        for lo in range(0, len(pairs), 1 << 20):
            f.write(("\n".join(f"{a}\t{b}" for a, b in
                               pairs[lo:lo + (1 << 20)].tolist())
                     + "\n").encode())


def write_mtx(path: str, g) -> None:
    """``g`` as a symmetric Matrix Market pattern: the lower triangle,
    1-based."""
    src = g.sources().astype(np.int64)
    dst = g.tails.astype(np.int64)
    keep = src >= dst
    n = g.num_vertices
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern symmetric\n")
        f.write(f"{n} {n} {int(keep.sum())}\n")
        f.write("\n".join(f"{a + 1} {b + 1}" for a, b in
                          zip(src[keep].tolist(), dst[keep].tolist())))
        f.write("\n")


def write_metis(path: str, g) -> None:
    """``g`` as a METIS graph: one 1-based adjacency line a vertex (both
    directions listed)."""
    nself = int((g.sources() == g.tails).sum())
    tails = (g.tails.astype(np.int64) + 1).tolist()
    off = g.offsets.tolist()
    with open(path, "w") as f:
        f.write(f"{g.num_vertices} {(g.num_edges - nself) // 2}\n")
        for v in range(g.num_vertices):
            f.write(" ".join(map(str, tails[off[v]:off[v + 1]])) + "\n")


def convert_timed(path: str, out: str, **kw) -> tuple:
    from cuvite_tpu_torch.workloads.convert import convert

    t0 = time.perf_counter()
    stats = convert(path, out, **kw)
    return stats, time.perf_counter() - t0


# R-MAT scale of phase 37's SNAP conversion and its pallas and bucketed
# runs: 18, not --scale's 20, whose conversion and runs took ~66 s of
# the smoke's 1200 s limit on an H100 host.
CONVERT_SCALE = 18


def run_converted(g_rmat, scale: int, work: str) -> dict:
    """Phase 37 (1): R-MAT ``scale`` written as a SNAP list, converted, and
    run with engine='pallas' against engine='bucketed' on the file."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.evaluate.modularity import modularity
    from cuvite_tpu_torch.io.vite import read_vite

    snap = os.path.join(work, f"rmat{scale}.txt")
    vite = os.path.join(work, f"rmat{scale}.vite")
    t0 = time.perf_counter()
    write_snap(snap, g_rmat)
    mb = os.path.getsize(snap) / 1e6
    print(f"  SNAP list of R-MAT {scale}: {mb:.1f} MB written in "
          f"{time.perf_counter() - t0:.2f} s")
    stats, conv_s = convert_timed(snap, vite, bits64=False)
    print(f"  converted in {conv_s:.3f} s ({mb / conv_s:.2f} MB/s of text): "
          f"{stats.num_vertices} vertices (relabeled {stats.relabeled}), "
          f"{stats.num_edges} directed edges, {stats.self_loops} self-loops")
    os.remove(snap)
    t0 = time.perf_counter()
    g = read_vite(vite, bits64=False)
    print(f"  read back in {time.perf_counter() - t0:.3f} s")
    os.remove(vite)
    if g.num_edges != g_rmat.num_edges:
        fail(f"the converted R-MAT {scale} has {g.num_edges} edges, the "
             f"graph {g_rmat.num_edges}")
    runs, out = {}, {}
    for engine in ("pallas", "bucketed"):
        torch.cuda.synchronize()
        zero_kernel_counts()
        t0 = time.perf_counter()
        res = louvain_phases(g, engine=engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        runs[engine] = (res, wall, launches)
        out[f"{engine} R-MAT {scale} converted from SNAP"] = launches
    pal, pal_s, pal_l = runs["pallas"]
    buck, buck_s, _ = runs["bucketed"]
    check_same_run(f"converted R-MAT {scale} pallas vs bucketed", pal, buck)
    if pal.modularity != buck.modularity:
        fail(f"converted R-MAT {scale}: pallas Q {pal.modularity} vs "
             f"bucketed {buck.modularity}")
    q_host = modularity(g, pal.communities)
    if abs(q_host - pal.modularity) > 1e-6:
        fail(f"converted R-MAT {scale}: reported Q {pal.modularity} vs host "
             f"f64 {q_host}")
    for name in ("row_argmax", "heavy_bincount"):
        if pal_l[name] == 0:
            fail(f"{name} never launched on the pallas run")
    if (pal.pallas_coverage, pal.pallas_width_hits) != \
            (buck.pallas_coverage, buck.pallas_width_hits):
        fail("the pallas and bucketed runs' coverage differ")
    hits = " ".join(f"{'hubs' if w == 0 else w}:{n}"
                    for w, n in sorted(pal.pallas_width_hits.items()))
    print(f"  engine='pallas' {pal_s:.3f} s, 'bucketed' {buck_s:.3f} s: "
          f"{len(pal.phases)} phases, {pal.total_iterations} sweeps, Q "
          f"{pal.modularity:.9f} (host f64 {q_host:.9f}), labels and Q bits "
          f"equal; pallas_coverage {pal.pallas_coverage}, traversed edges "
          f"by width {hits}; launches {pal_l}")
    return out


def check_converted_formats(scale: int, work: str) -> dict:
    """Phase 37 (2): R-MAT --check-scale as Matrix Market and METIS, each
    converted at two chunk sizes (byte-equal) and run with
    engine='pallas' on the card and on the CPU (equal)."""
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.io.vite import read_vite

    g0 = generate_rmat(scale)
    out = {}
    for fmt, writer, name in (("mtx", write_mtx, "g.mtx"),
                              ("metis", write_metis, "g.graph")):
        path = os.path.join(work, name)
        writer(path, g0)
        files = []
        for chunk in (1 << 22, 4096):
            vite = os.path.join(work, f"g.{fmt}.{chunk}.vite")
            stats, sec = convert_timed(path, vite, chunk_edges=chunk)
            files.append(open(vite, "rb").read())
            print(f"  {fmt}: {stats.num_vertices} vertices, "
                  f"{stats.num_edges} directed edges, chunk {chunk}: "
                  f"{sec:.3f} s")
        if files[0] != files[1]:
            fail(f"{fmt}: the two chunk sizes wrote different files")
        g = read_vite(vite, bits64=False)
        if not (np.array_equal(g.offsets, g0.offsets)
                and np.array_equal(g.tails, g0.tails)):
            fail(f"{fmt}: the converted CSR differs from the graph's")
        zero_kernel_counts()
        rg = louvain_phases(g, engine="pallas")
        out[f"pallas R-MAT {scale} converted from {fmt}"] = kernel_counts()
        rc = louvain_phases(g, engine="pallas", device="cpu")
        check_same_run(f"{fmt} R-MAT {scale} pallas", rg, rc)
        print(f"  {fmt}: byte-equal across chunk sizes, the CSR of the "
              f"graph; pallas card = CPU ({len(rg.phases)} phases, "
              f"{rg.total_iterations} sweeps, Q {rg.modularity:.9f}, "
              f"coverage {rg.pallas_coverage})")
        os.remove(path)
        for chunk in (1 << 22, 4096):
            os.remove(os.path.join(work, f"g.{fmt}.{chunk}.vite"))
    return out


def run_coalesce_engines(g_rgg, nv: int, sort_res) -> dict:
    """Phase 37 (3): the sort path on RGG --rgg-nv under
    CUVITE_SEG_COALESCE=msd and =hash, against phase 9's run; then both
    engines and the default at the run's first coarsening: rows, host
    reads, device time."""
    import torch

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.kernels import seg_coalesce as sc
    from cuvite_tpu_torch.ops import segment as seg

    first = []
    coalesced_runs = seg.coalesced_runs

    def observed(src, ckey, w, *, nv_pad, engine="sort"):
        if not first:
            first.append((src, ckey, w, nv_pad))
        return coalesced_runs(src, ckey, w, nv_pad=nv_pad, engine=engine)

    def coalesce_s(res):
        return sum(p.stages.get("coalesce", 0.0) for p in res.phases)

    out = {}
    print(f"  default engines (phase 9): coalesce "
          f"{coalesce_s(sort_res):.4f} s over "
          f"{[p.coalesce for p in sort_res.phases]}")
    for mode in ("msd", "hash"):
        os.environ["CUVITE_SEG_COALESCE"] = mode
        seg.coalesced_runs = observed
        try:
            sc.zero_hash_stats()
            torch.cuda.synchronize()
            zero_kernel_counts()
            t0 = time.perf_counter()
            res = louvain_phases(g_rgg, engine="sort")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_counts()
            stats = dict(sc.HASH_STATS)
        finally:
            seg.coalesced_runs = coalesced_runs
            del os.environ["CUVITE_SEG_COALESCE"]
        check_same_run(f"RGG {nv} sort, CUVITE_SEG_COALESCE={mode}, vs "
                       "phase 9", res, sort_res)
        if res.modularity != sort_res.modularity:
            fail(f"RGG {nv} {mode}: Q {res.modularity} vs phase 9's "
                 f"{sort_res.modularity}")
        engines = [p.coalesce for p in res.phases]
        if {e for e in engines if e is not None} != {mode}:
            fail(f"RGG {nv} {mode}: coarsenings ran {engines}")
        if launches["seg_coalesce"]:
            fail(f"RGG {nv} {mode}: seg_coalesce launched "
                 f"{launches['seg_coalesce']} times")
        n_co = sum(e is not None for e in engines)
        out[f"sort RGG {nv} CUVITE_SEG_COALESCE={mode}"] = launches
        extra = ""
        if mode == "hash":
            if stats["coalescings"] != n_co or stats["host_reads"] != n_co:
                fail(f"RGG {nv} hash: {stats} over {n_co} coarsenings")
            extra = (f"; {stats['collisions']} of {n_co} coalescings "
                     "collided and were retried on the msd tail")
        print(f"  {mode}: {wall:.3f} s, coalesce {coalesce_s(res):.4f} s "
              f"over {engines}, labels, phases, sweeps and Q bits equal to "
              f"phase 9's, launches {launches}{extra}")
    src, ckey, w, nv_pad = first[0]
    args = (src[None], ckey[None], w[None])
    real = int((src < nv_pad).sum())
    ref = seg.coalesced_runs_batched(*args, nv_pad=nv_pad, engine="sort")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        msd = seg.coalesced_runs_batched(*args, nv_pad=nv_pad, engine="msd")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sc.zero_hash_stats()
    hsh, hash_syncs = count_syncs(lambda: seg.coalesced_runs_batched(
        *args, nv_pad=nv_pad, engine="hash"))
    for name, got in (("msd", msd), ("hash", hsh)):
        if not all(bits_equal(a, b) for a, b in zip(got, ref)):
            fail(f"RGG {nv} first coarsening: the {name} rows differ from "
                 "the sort engine's")
    if hash_syncs != 1:
        fail(f"the hash coalesce made {hash_syncs} host reads, not 1")
    k = sc.hash_slots(nv_pad, src.numel())
    times = {e: time_ms(lambda e=e: seg.coalesced_runs_batched(
        *args, nv_pad=nv_pad, engine=e), 5) for e in ("sort", "msd", "hash")}
    print(f"  RGG {nv} first coarsening (nv_pad {nv_pad}, {src.numel()} "
          f"slab rows, {real} real, {int(ref[3][0])} coalesced): msd and "
          f"hash rows bit-equal to the sort engine's; host reads: msd 0 "
          f"(ran under set_sync_debug_mode('error')), hash {hash_syncs} "
          f"(K = {k} slots a src, collisions {sc.HASH_STATS['collisions']});"
          f" device ms: sort {times['sort']:.4f}, msd {times['msd']:.4f}, "
          f"hash {times['hash']:.4f} (its host read inside)")
    return out


def check_batch_msd(gs: list, kind: str) -> dict:
    """Phase 37 (4): the B=64 batch under CUVITE_SEG_COALESCE=msd, both
    engines: every tenant's labels equal the default run's."""
    import torch

    from cuvite_tpu_torch import louvain_many

    out = {}
    for engine in ("fused", "bucketed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base = louvain_many(gs, engine=engine)
        torch.cuda.synchronize()
        base_s = time.perf_counter() - t0
        os.environ["CUVITE_SEG_COALESCE"] = "msd"
        try:
            torch.cuda.synchronize()
            zero_kernel_counts()
            t0 = time.perf_counter()
            br = louvain_many(gs, engine=engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_counts()
        finally:
            del os.environ["CUVITE_SEG_COALESCE"]
        for k, (a, b) in enumerate(zip(br.results, base.results)):
            if not np.array_equal(a.communities, b.communities) or \
                    a.total_iterations != b.total_iterations:
                fail(f"{kind} {engine} msd: tenant {k} differs from the "
                     "default run")
        if set(br.coalesce) - {"msd"} or launches["seg_coalesce"]:
            fail(f"{kind} {engine} msd: coalesce {br.coalesce}, launches "
                 f"{launches}")
        out[f"{kind} {engine}, CUVITE_SEG_COALESCE=msd"] = launches
        print(f"  {kind} {engine} under msd: {wall:.3f} s (default "
              f"{base_s:.3f} s), coalesce {br.coalesce} (default "
              f"{base.coalesce}), every tenant's labels and sweeps equal "
              f"the default run's; launches {launches}")
    return out


# ---------------------------------------------------------------------------
# Phase 38: the drivers (cuvite_tpu_torch/tools), in one child process.

TOOL_TIMEOUT_S = 600
TOOL_SCALE = 18      # R-MAT scale of step_bench, trace_step and the ingest
DAEMON_RATE = 64     # jobs/s: about half of the synth 4096 saturation
SERVE_BASE = ["--edges", "4096", "--b-max", "16", "--jobs", "128",
              "--start-rate", "50", "--max-rounds", "8"]


def verdict_of(stdout: str) -> dict | None:
    """The ``{"verdict": ...}`` an A/B verb prints last, or None."""
    lines = [s for s in stdout.splitlines() if s.startswith("{")]
    return json.loads(lines[-1]).get("verdict") if lines else None


def verdict_rc_ok(call: dict, rc, stdout: str) -> bool:
    """Whether an A/B verb's exit status is the one its verdict gives: 0
    when the acceptance holds, 1 when it does not (a measurement, not a
    failure)."""
    v = verdict_of(stdout) if call.get("verdict") else None
    return v is not None and (rc or 0) == (0 if v["acceptance"] else 1)


def tool_worker(spec_json: str) -> int:
    """``--tool-worker SPEC``: the drivers' calls in this one process,
    ``cuvite_tpu_torch.tools.<name>.main(argv)`` for each (``SPEC``: a
    JSON list of {"name", "argv", "env", "verdict"}, ``env`` set around
    its call), each call's stdout and stderr captured; stops at the
    first call that does not return 0, an A/B verb (``verdict``) whose
    exit status is its verdict's excepted.  Prints one JSON list of
    {name, argv, rc, stdout, stderr, wall} as its last line."""
    import contextlib
    import importlib
    import io

    results = []
    for call in json.loads(spec_json):
        mod = importlib.import_module(
            f"cuvite_tpu_torch.tools.{call['name']}")
        env = call.get("env") or {}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = mod.main(call["argv"])
            except SystemExit as exc:
                rc = exc.code
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        results.append({"name": call["name"], "argv": call["argv"],
                        "rc": rc or 0, "stdout": out.getvalue(),
                        "stderr": err.getvalue(),
                        "wall": time.perf_counter() - t0})
        if rc and not verdict_rc_ok(call, rc, out.getvalue()):
            break
    print(json.dumps(results))
    return 0


def tool_child(calls: list, env: dict | None = None,
               timeout: int = TOOL_TIMEOUT_S) -> list:
    """The drivers' ``calls`` ([name, argv, env, verdict]) in one child on
    the card (``tool_worker``), each ``cuvite_tpu_torch.tools.<name>
    .main(argv)``; fails unless the child ends within ``timeout`` and
    every call returns 0 -- an A/B verb (``verdict``) may return 1 beside
    a verdict whose acceptance does not hold, which is printed and is not
    a failure.  Returns, per call, (the JSON objects of its stdout, its
    stdout, its stderr, wall s)."""
    root = os.path.dirname(os.path.abspath(__file__))
    spec = [{"name": n, "argv": a, "env": e or {}, "verdict": v}
            for n, a, e, v in calls]
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tool-worker",
             json.dumps(spec)], cwd=root, capture_output=True, text=True,
            timeout=timeout, env=dict(os.environ, **(env or {})))
    except subprocess.TimeoutExpired:
        fail(f"the drivers' child: no exit within {timeout} s")
    if out.returncode or not out.stdout.strip():
        fail(f"the drivers' child exited {out.returncode}:\n"
             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    got = []
    for call, r in zip(spec, json.loads(out.stdout.strip().splitlines()[-1])):
        if r["rc"] and not verdict_rc_ok(call, r["rc"], r["stdout"]):
            fail(f"tools.{r['name']} {' '.join(r['argv'])} returned "
                 f"{r['rc']}:\n{r['stdout'][-3000:]}\n{r['stderr'][-3000:]}")
        objs = [json.loads(s) for s in r["stdout"].splitlines()
                if s.startswith("{")]
        got.append((objs, r["stdout"], r["stderr"], r["wall"]))
    if len(got) != len(calls):
        fail(f"the drivers' child ran {len(got)} of {len(calls)} calls")
    return got


def tool_launches(err: str) -> dict:
    """The ``# launches: {...}`` line a serve_load verb writes to
    stderr."""
    for line in err.splitlines():
        if line.startswith("# launches: "):
            return json.loads(line[len("# launches: "):])
    fail("serve_load wrote no launch counts")


def check_records(what: str, objs: list, card: tuple) -> list:
    """The bench records among a verb's lines: each valid, on phase 1's
    card."""
    from cuvite_tpu_torch.workloads.bench import validate_record

    recs = [o for o in objs if "metric" in o]
    if not recs:
        fail(f"{what}: no record")
    for rec in recs:
        problems = validate_record(rec)
        if problems:
            fail(f"{what}: invalid record {problems}")
        if rec["compile_guard"] != {"checked": True, "new_compiles": 0}:
            fail(f"{what}: guard {rec['compile_guard']}")
        if (rec["platform"], rec["device"], rec["power_limit_w"]) != \
                ("cuda", *card):
            fail(f"{what}: record on {rec['platform']} {rec['device']} "
                 f"{rec['power_limit_w']} W, not phase 1's card {card}")
    return recs


def tool_calls() -> list:
    """Phase 38's calls, in order: serve_load sweep, ab and pipeab (512
    jobs an arm, the reference's ab default) on synth 4096 at b_max 16
    (128 jobs a sweep round from 50 jobs/s: a round's goodput counts its
    drain tail, 0.05-0.17 s on an H100's host, so a first round at 100
    jobs/s can fall under 0.9x its rate and end the verb with "even 100
    jobs/s overloads" while the queue sustains 160; from 50 the tail
    must pass 0.28 s for that; the sweep's saturation, the best round's
    goodput, still sits near the queue's capacity and ab's 2x and
    pipeab's 1.5x overload it; on an H100's host ab at
    1,024 jobs took 17 s against 9 s at 512 and missed the SLO all the
    same: the job count does not decide its verdict), mix on phase 20's 90:10 pools (2,000 jobs/s,
    b_max 4, bucketed) and daemon at DAEMON_RATE;
    exchange_latency on 4 shards of one card, flat and 2x2;
    exchange_bench at R-MAT 18 on 4 shards; step_bench, trace_step and
    weighted_ingest_bench at TOOL_SCALE."""
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke", "trace")
    scale = {"AB_SCALE": str(TOOL_SCALE)}
    return [
        ("serve_load", ["sweep", *SERVE_BASE], None, False),
        ("serve_load", ["ab", *SERVE_BASE, "--growth", "1.6",
                        "--ab-jobs", "512"], None, True),
        ("serve_load", ["pipeab", *SERVE_BASE, "--growth", "1.6",
                        "--ab-jobs", "512"], None, True),
        ("serve_load", ["mix", "--engine", "bucketed", "--rate", "2000",
                        "--b-max", "4"], None, True),
        ("serve_load", ["daemon", "--edges", "4096", "--b-max", "16",
                        "--jobs", "64", "--rate", str(DAEMON_RATE),
                        "--ready-timeout", "180", "--drain-timeout", "120"],
         None, False),
        ("exchange_latency", ["--devices", str(MESH_SHARDS), "--max-log2",
                              "22", "--json"], None, False),
        ("exchange_latency", ["--mesh", "2x2", "--max-log2", "22",
                              "--json"], None, False),
        ("exchange_bench", [],
         {"AB_SCALES": "18", "AB_SHARDS": str(MESH_SHARDS),
          "AB_CHILD_TIMEOUT": "240"}, False),
        ("step_bench", [], scale, False),
        ("trace_step", [], dict(scale, TRACE_DIR=work), False),
        ("weighted_ingest_bench", [str(TOOL_SCALE)], None, False),
    ]


def report_ab(verb: str, got, card: tuple, arm: str) -> tuple:
    """An A/B verb's two records, each valid on phase 1's card, printed
    with its head line and verdict; returns (the records, the launches)."""
    objs, _, err, wall = got
    recs = check_records(f"serve_load {verb}", objs, card)
    launches = tool_launches(err)
    print(f"  serve_load {verb}: {len(recs)} valid records, {wall:.1f} s; "
          f"{json.dumps(objs[-4])}; verdict "
          f"{json.dumps(objs[-1]['verdict'])}; launches {launches}")
    for rec in recs:
        s = rec["serve"]
        print(f"    {arm} {s[arm]}: offered {s['arrival_jobs_per_s']} "
              f"jobs/s, goodput {s['goodput_jobs_per_s']}, wait p95 "
              f"{s['wait_p95_ms']} ms, rejected {s['rejected']}, pack "
              f"{s['pack_s']} s, device {s['device_s']} s, overlap_frac "
              f"{s['overlap_frac']}, wall {s['wall_s']} s")
    return recs, launches


def report_serve(card: tuple, sweep, ab, pipeab, mix, daemon) -> dict:
    paths = {}
    objs, _, err, wall = sweep
    launches = tool_launches(err)
    print(f"  serve_load sweep (synth 4096, b_max 16, 128 jobs a round "
          f"from 50 jobs/s, x1.6): saturation "
          f"{objs[-1]['saturation_jobs_per_s']} jobs/s at wait p95 "
          f"{objs[-1]['wait_p95_ms']} ms (SLO {objs[-1]['slo_ms']} ms), "
          f"{len(objs) - 1} rounds, {wall:.1f} s; launches {launches}")
    for r in objs[:-1]:
        print(f"    {json.dumps(r)}")
    if launches["seg_coalesce"] == 0 or launches["row_argmax"] == 0:
        fail(f"serve_load sweep: a kernel of the serving path never "
             f"launched {launches}")
    paths["tools serve_load sweep, synth 4096 b_max 16"] = launches
    _, paths["tools serve_load ab, synth 4096 b_max 16"] = report_ab(
        "ab", ab, card, "admission")
    recs, paths["tools serve_load pipeab, synth 4096 b_max 16"] = report_ab(
        "pipeab", pipeab, card, "pipelined")
    ser, pip = (r["serve"] for r in recs)
    print(f"    pipelined arm's device_s {pip['device_s']} s against the "
          f"serial arm's {ser['device_s']} s "
          f"({pip['device_s'] - ser['device_s']:+.4f} s), with "
          f"{pip['overlap_frac'] * pip['device_s']:.4f} s of pack inside "
          "its execute windows; pack_s "
          f"{pip['pack_s']} s against {ser['pack_s']} s")
    objs, _, err, wall = mix
    recs = check_records("serve_load mix", objs, card)
    launches = tool_launches(err)
    paths["tools serve_load mix, 90:10 pools at 2000 jobs/s"] = launches
    print(f"  serve_load mix (72 synth 1024 : 8 R-MAT 13 ef 2, 2000 jobs/s, "
          f"b_max 4, bucketed): {wall:.1f} s; verdict "
          f"{json.dumps(objs[-1]['verdict'])}; launches {launches}")
    if recs[-1]["mix"]["merged_batches"] < 1:
        fail("serve_load mix: the merged arm packed no merged batch")
    objs, _, err, wall = daemon
    row, launches = objs[-1], tool_launches(err)
    print(f"  serve_load daemon at {DAEMON_RATE} jobs/s: {json.dumps(row)}; "
          f"{wall:.1f} s with the daemon's start; launches {launches}")
    if not (row["clean_drain"] and row["daemon_rc"] == 0
            and row["conservation"]["ok"] and row["done"] == 64):
        fail(f"serve_load daemon: {row}")
    if launches["seg_coalesce"] == 0:
        fail(f"serve_load daemon: seg_coalesce never launched {launches}")
    paths[f"tools serve_load daemon, 64 synth 4096 at {DAEMON_RATE} "
          "jobs/s"] = launches
    return paths


def table_rows(stdout: str) -> tuple:
    """(the ladder rows, the transport model rows) an exchange_latency
    run prints, each [n, times...]; the model follows its
    ``# modeled`` line."""
    rows, model, into = [], [], None
    for line in stdout.splitlines():
        if line.startswith("# modeled"):
            into = model
        parts = line.split()
        if line.startswith("  ") and parts and parts[0].isdigit():
            (rows if into is None else into).append(
                [int(parts[0])] + [float(x) for x in parts[1:]])
    return rows, model


def print_ladder(stdout: str, names: str) -> None:
    rows, model = table_rows(stdout)
    print(f"    n/shard (f32): {names} (min wall s, synchronized)")
    for r in rows:
        if r[0] >= 1 << 16 or r[0] == 128:
            print(f"    {r[0]:>8} ({r[0] * 4 / 1e6:7.3f} MB): "
                  + " ".join(f"{t:.3e}" for t in r[1:]))
    if model:
        print("    modeled sweep transport, nv_total: replicated s, sparse s")
        for r in model:
            if r[0] >= 1 << 18:
                print(f"    {r[0]:>10}: {r[1]:.3e} {r[2]:.3e}")


def print_latency(what: str, v: dict, wall: float) -> None:
    print(f"  exchange_latency {what} ({wall:.1f} s): launch latency "
          + ", ".join(f"{k} {t * 1e6:.1f} us"
                      for k, t in v["launch_latency_s"].items())
          + (f"; crossover bracket nv {v['crossover_bracket_nv']}"
             if "crossover_bracket_nv" in v else
             f"; modeled sweep {v['modeled_iteration_s']}")
          + f"; {v['note']}")


def report_exchange(flat, mesh, bench) -> dict:
    from cuvite_tpu_torch.louvain.driver import AUTO_SPARSE_MIN_VERTICES

    print(f"  AUTO_SPARSE_MIN_VERTICES {AUTO_SPARSE_MIN_VERTICES}")
    print_latency(f"{MESH_SHARDS} shards of one card", flat[0][-1], flat[3])
    print_ladder(flat[1], "all_gather psum all_to_all")
    print_latency("--mesh 2x2", mesh[0][-1], mesh[3])
    print_ladder(mesh[1], "ag(ici) psum(ici) ag(global) a2a(dcn)")
    objs, out, _, wall = bench
    got = objs[-1]
    arms = {r["exchange"]: r for r in got["rows"]}
    if set(arms) != {"replicated", "sparse"} or "18" not in \
            got["sparse_over_replicated"]:
        fail(f"exchange_bench: missing an arm {out[-2000:]}")
    if arms["sparse"]["labels"] != arms["replicated"]["labels"]:
        fail("exchange_bench: the arms' labels differ")
    if arms["sparse"]["launches"]["row_argmax_sized"] == 0:
        fail("exchange_bench: the sparse arm never launched the size form")
    for ex, r in arms.items():
        print(f"  exchange_bench R-MAT 18, {MESH_SHARDS} shards of one card, "
              f"{ex}: wall {r['wall_s']:.3f} s (timed run), Q "
              f"{r['modularity']:.6f}, {r['iterations']} sweeps, peak RSS "
              f"{r['rss_hwm_mib']} MiB, max_memory_allocated "
              f"{r['peak_alloc_bytes']} B, launches {r['launches']}")
    print(f"  exchange_bench sparse/replicated at R-MAT 18: "
          f"{got['sparse_over_replicated']['18']:.3f}x ({wall:.1f} s "
          "with both children)")
    return {f"tools exchange_bench R-MAT 18 {MESH_SHARDS} shards {ex}":
            r["launches"] for ex, r in arms.items()}


def report_step(step, trace, ingest) -> dict:
    s, wall = step[0][-1], step[3]
    if not s["device_ms"] or s["launches"]["row_argmax"] == 0:
        fail(f"step_bench: no device time or no row launch {s}")
    print(f"  step_bench R-MAT {TOOL_SCALE} ({wall:.1f} s): plan+upload "
          f"{s['plan_upload_s']:.3f} s, first call {s['first_call_s']:.3f} "
          f"s, scalar round trip {s['rtt_ms']:.4f} ms, step+fetch "
          f"{s['step_fetch_ms']:.4f} ms, device (CUDA events) "
          f"{s['device_ms']:.4f} ms a sweep, {s['medges_per_s']:.1f} M "
          f"edges/s; launches over 5 sweeps {s['launches']}")
    t, wall = trace[0][-1], trace[3]
    print(f"  trace_step R-MAT {TOOL_SCALE} ({wall:.1f} s): device self "
          f"time over {t['steps']} sweeps {t['self_s'] * 1e3:.3f} ms; top "
          "five:")
    for r in t["top"][:5]:
        print(f"    {r['self_ms']:9.4f} ms {r['count']:5d}x  "
              f"{r['name'][:100]}")
    if t["rows_on"] != "device" or not any(
            "row_argmax" in r["name"] for r in t["top"]):
        fail("trace_step: the row kernel is not among the top device rows")
    w, wall = ingest[0][-1], ingest[3]
    print(f"  weighted_ingest_bench scale {TOOL_SCALE} ({wall:.1f} s): path "
          f"{w['path']}, nv {w['nv']}, ne {w['ne']}, {w['wdtype']}, gen "
          f"{w['gen_s']:.3f} s, build {w['build_s']:.3f} s, upload "
          f"{w['upload_s']:.3f} s, peak RSS {w['total_hwm_mib']} MiB")
    return {f"tools step_bench R-MAT {TOOL_SCALE} (5 sweeps)": s["launches"],
            f"tools trace_step R-MAT {TOOL_SCALE} (3 sweeps)": t["launches"]}


def run_tools(card: tuple) -> dict:
    """Phase 38: the six drivers in one child, then each one's numbers
    and checks."""
    t0 = time.perf_counter()
    got = tool_child(tool_calls())
    print(f"  the drivers' child took {time.perf_counter() - t0:.1f} s (the "
          "daemon and exchange_bench's two configurations in processes of "
          "their own)")
    paths = report_serve(card, *got[0:5])
    paths.update(report_exchange(*got[5:8]))
    paths.update(report_step(*got[8:11]))
    return paths


def run_tool_world(cards: list) -> None:
    """``exchange_latency --world min(cards, 4)``: one NCCL rank a card,
    the cards' links."""
    world = min(len(cards), MAX_WORLD)
    (objs, out, _, wall), = tool_child(
        [("exchange_latency", ["--world", str(world), "--max-log2", "22",
                               "--json"], None, False)],
        env={"CUDA_VISIBLE_DEVICES": ",".join(cards[:world]),
             "NCCL_SOCKET_IFNAME": "lo", "GLOO_SOCKET_IFNAME": "lo"},
        timeout=700)
    print_latency(f"--world {world}", objs[-1], wall)
    print_ladder(out, "all_gather psum all_to_all")


# ---------------------------------------------------------------------------
# Phase 39: the static analysis of the port (cuvite_tpu_torch.analysis).

ANALYSIS_TIMEOUT_S = 300


def run_analysis() -> None:
    """Phase 39: ``python -m cuvite_tpu_torch.analysis --format json`` over
    the port's tree (its default paths and baseline), cold from an emptied
    cache in a child process, then warm from that cache through the same
    command line's ``main`` in this process (a child costs ~10 s to start
    on the card's host).  Fails unless both exit 0 and the warm findings
    equal the cold ones; prints every finding by rule (the baselined ones
    included) and both walls."""
    import collections
    import contextlib
    import io

    from cuvite_tpu_torch.analysis import apply_baseline, load_baseline
    from cuvite_tpu_torch.analysis import run_paths
    from cuvite_tpu_torch.analysis.__main__ import (
        DEFAULT_BASELINE,
        DEFAULT_PATHS,
        main as analysis_main,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(root, "build", "chip_smoke",
                         "graftlint_cache.json")
    if os.path.exists(cache):
        os.remove(cache)
    argv = ["--format", "json", "--cache", cache]
    docs = {}
    for what in ("cold", "warm"):
        t0 = time.perf_counter()
        if what == "cold":
            out = subprocess.run(
                [sys.executable, "-m", "cuvite_tpu_torch.analysis", *argv],
                cwd=root, capture_output=True, text=True,
                timeout=ANALYSIS_TIMEOUT_S)
            rc, stdout = out.returncode, out.stdout
            where = "a child, its start included"
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = analysis_main(argv)
            stdout = buf.getvalue()
            where = "in this process"
        wall = time.perf_counter() - t0
        if rc:
            fail(f"analysis ({what}) exited {rc}: {stdout[-3000:]}")
        docs[what] = json.loads(stdout)
        print(f"  {what} ({where}): exit 0 in {wall:.2f} s, "
              f"{len(docs[what]['findings'])} new findings, "
              f"{docs[what]['baselined']} baselined, "
              f"{docs[what]['stale_baseline']} stale baseline entries, "
              f"gate {docs[what]['gate']}")
    if docs["warm"] != docs["cold"]:
        fail("analysis: the warm run's findings differ from the cold run's")
    findings = run_paths([os.path.join(root, p) for p in DEFAULT_PATHS],
                         cache=cache)
    new, old = apply_baseline(findings, load_baseline(
        os.path.join(root, DEFAULT_BASELINE)))
    for name, fs in (("every finding", findings), ("baselined", old),
                     ("new", new)):
        by_rule = collections.Counter(f.rule for f in fs)
        print(f"  {name} by rule: {dict(sorted(by_rule.items()))}")
    if new:
        fail(f"analysis: {len(new)} findings beyond the baseline in this "
             "process, none in its command line")
    print("  warm findings equal the cold ones")


# Phase 40: the dynamic analysis tiers on the card, in one child.

AUDIT_TIMEOUT_S = 300
# Schedules a concheck scenario walks here (tier-1 walks 200 on the CPU;
# the known-bug fixtures convict within a few).
AUDIT_CONCHECK_BUDGET = 8


def audit_worker() -> int:
    """``--audit-worker``: phase 40's four audits in this one process on
    ``cuda:0``; prints one JSON object as its last line: each audit's
    findings (as dicts), its wall, and the per-entry facts."""
    import contextlib
    import io

    from cuvite_tpu_torch.analysis import concheck
    from cuvite_tpu_torch.analysis.meshcheck import run_mesh_audit
    from cuvite_tpu_torch.analysis.widthaudit import run_width_audit
    from cuvite_tpu_torch.tools import compile_audit, width_audit

    dev = "cuda:0"
    doc = {}
    t0 = time.perf_counter()
    rows = []
    inventory = concheck.serve_inventory()
    for name, (factory, expect) in concheck.builtin_scenarios().items():
        scen = factory()
        scen.inventory = inventory
        rep = concheck.explore(scen, budget=AUDIT_CONCHECK_BUDGET, seed=0,
                               stop_on_failure=(expect == "detect"))
        ok = rep.clean if expect == "clean" else not rep.clean
        rows.append(dict(rep.summary(), expect=expect, ok=ok))
    doc["concheck"] = {"wall": time.perf_counter() - t0, "rows": rows}

    t0 = time.perf_counter()
    found, reports = run_width_audit(list(width_audit.SMOKE_ENTRIES),
                                     workloads=list(
                                         width_audit.SMOKE_WORKLOADS),
                                     device=dev)
    doc["width"] = {"wall": time.perf_counter() - t0,
                    "findings": [f.to_dict() for f in found],
                    "spy": reports["spy"],
                    "entries": {k: v for k, v in reports.items()
                                if k not in ("spy", "probes")},
                    "probes": reports.get("probes", {})}

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        results = compile_audit.run_audit(device=dev)
    doc["compile"] = {"wall": time.perf_counter() - t0,
                      "entries": [r.to_dict() for r in results]}

    t0 = time.perf_counter()
    found, reports = run_mesh_audit(device=dev)
    doc["mesh"] = {"wall": time.perf_counter() - t0,
                   "findings": [f.to_dict() for f in found],
                   "entries": {n: {t: {"sweeps": r.sweeps,
                                       "collectives_a_sweep": len(r.seq),
                                       "ledger": r.categories}
                                   for t, r in by.items()}
                               for n, by in reports.items()}}
    print(json.dumps(doc, default=str))
    return 0


def run_audits() -> dict:
    """Phase 40: concheck's self-check (clean scenarios without findings,
    the known-bug fixtures convicted), ``width_audit --smoke`` with the
    zero-device-bytes spy on ``cuda:0``, the compile and op audit on the
    card (the manifest's ``cuda`` budgets, B002 on new content, host
    reads and launches a sweep) and the mesh audit over shards of
    ``cuda:0``, in one child; fails on any finding or unexpected verdict.
    Returns the compile audit's launches by entry, for the kernels line."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--audit-worker"],
            cwd=root, capture_output=True, text=True,
            timeout=AUDIT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"the audits' child: no exit within {AUDIT_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    if out.returncode or not out.stdout.strip():
        fail(f"the audits' child exited {out.returncode}:\n"
             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    bad = []
    cc = doc["concheck"]
    print(f"  concheck: {cc['wall']:.2f} s, {AUDIT_CONCHECK_BUDGET} "
          "schedules a scenario")
    for r in cc["rows"]:
        print(f"    {r['scenario']}: expect {r['expect']}, "
              f"{r['schedules']} schedules ({r['distinct_interleavings']} "
              f"distinct), {r['failing_schedules']} failing, {r['races']} "
              f"races, replay {r['replay'][:1]} "
              f"[{'ok' if r['ok'] else 'FAIL'}]")
        if not r["ok"]:
            bad.append(f"concheck {r['scenario']} (expect {r['expect']})")
    wd = doc["width"]
    print(f"  width audit (--smoke, meta on cuda:0): {wd['wall']:.2f} s, "
          f"spy {wd['spy']}")
    for wname, per in sorted(wd["entries"].items()):
        for name, rep in sorted(per.items()):
            print(f"    {wname} {name}: {rep['mode']} nv={rep['nv']} "
                  f"ne={rep['ne']} sorts={rep['sorts']}")
    print(f"    probes: {wd['probes']}")
    cp = doc["compile"]
    print(f"  compile and op audit on cuda:0: {cp['wall']:.2f} s")
    launches = {}
    for e in cp["entries"]:
        print(f"    {e['entry']}: first run {e['observed']}, content "
              f"change {e['recompiled']}, {e['sweeps']} sweeps, reads "
              f"{e['reads']}, launches a sweep {e['launches_per_sweep']}")
        launches[f"audit {e['entry']}"] = e["launches"]
    ms = doc["mesh"]
    print(f"  mesh audit over shards of cuda:0: {ms['wall']:.2f} s")
    for name, by in ms["entries"].items():
        print(f"    {name}: " + ", ".join(
            f"{t} {r['sweeps']} sweeps {r['collectives_a_sweep']} "
            "collectives a sweep" for t, r in sorted(by.items())))
    findings = wd["findings"] + ms["findings"] + [
        f for e in cp["entries"] for f in e["findings"]]
    for f in findings:
        print(f"    {f['rule']} {f['path']}: {f['message'][:300]}")
    if findings:
        bad.append(f"{len(findings)} audit findings "
                   f"({sorted({f['rule'] for f in findings})})")
    print(f"  phase 40 child: {wall:.1f} s, its start included")
    if bad:
        fail(f"phase 40: {'; '.join(bad)}")
    return launches


def run_multiprocess_only(args, cards: list) -> int:
    """``--only-multiprocess``: phase 30's, 35's colored and 36's 2x2
    one-process runs as the reference, then phases 33-34, then on a host
    of several cards phase 36's ``mesh="auto"`` batch."""
    import torch

    from cuvite_tpu_torch.io.generate import generate_rmat

    S = MESH_SHARDS
    g = generate_rmat(args.scale)
    print(f"[30] R-MAT {args.scale} on {S} shards of one card, the "
          "one-process reference")
    one_process = {}
    for ex in ("replicated", "sparse"):
        launches, wall, res = run_mesh_full(g, args.scale, S, ex, None)
        one_process[ex] = (res, launches, wall)
    print(f"[35] R-MAT {args.scale} {COLOR_RUN} on {S} shards of one card, "
          "the one-process reference of phase 34's colored runs")
    launches, wall, res = run_mesh_schedule_full(
        g, args.scale, S, {"coloring": 8, "exchange": "sparse"})
    one_process[COLOR_RUN] = (res, launches, wall)
    print(f"[36] R-MAT {args.scale} on a 2x2 hybrid mesh of one card, the "
          "one-process reference of phase 33's two-level run")
    launches, wall, res = run_mesh_full(g, args.scale, S, "twolevel", None,
                                        shape=HYBRID)
    one_process[TWOLEVEL_RUN] = (res, launches, wall)
    run_multiprocess(g, args.scale, S, cards, one_process)
    if len(cards) >= 2:
        print("[36] the batch axis over the cards: mesh='auto'")
        run_batch_auto(cards, "serving 65536")
        print(f"[38] the collective ladder as {min(len(cards), MAX_WORLD)} "
              "NCCL ranks, one a card")
        run_tool_world(cards)
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="R-MAT scale of the bucketed main-path run")
    ap.add_argument("--check-scale", type=int, default=14,
                    help="R-MAT scale of the card-vs-CPU run")
    ap.add_argument("--rgg-nv", type=int, default=1 << 22,
                    help="RGG vertices of the sort-path run")
    ap.add_argument("--rgg-check-nv", type=int, default=1 << 16,
                    help="RGG vertices of the sort- and fused-engine "
                         "card-vs-CPU runs")
    ap.add_argument("--fused-check-scale", type=int, default=12,
                    help="R-MAT scale of the fused-engine card-vs-CPU run")
    ap.add_argument("--fused-shrink", type=int, default=1 << 12,
                    help="FUSED_SHRINK_EDGES of the fused card-vs-CPU runs")
    ap.add_argument("--schedule-scale", type=int, default=20,
                    help="R-MAT scale of the ET and coloring runs")
    ap.add_argument("--native-rmat-scale", type=int, default=18,
                    help="R-MAT scale of phase 32's generation and "
                         "weighted-builder and Vite checks")
    ap.add_argument("--only-multiprocess", action="store_true",
                    help="run phases 1, 30, 35's colored sparse run, 36's "
                         "2x2 run, 33 and 34, and with several cards "
                         "36's mesh='auto' batch, only (the one-rank-per-"
                         "card world spans min(visible cards, 4))")
    ap.add_argument("--rank-worker", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--batch-worker", metavar="SPEC",
                    help=argparse.SUPPRESS)
    ap.add_argument("--tool-worker", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--audit-worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_worker:
        return rank_worker(args.rank_worker)
    if args.batch_worker:
        return batch_worker(args.batch_worker)
    if args.tool_worker:
        return tool_worker(args.tool_worker)
    if args.audit_worker:
        return audit_worker()

    # The run uses one card: show torch only that one, so the device count
    # on the last line is the count the run used.  Phases 33-34 start their
    # ranks on the cards the caller offered.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = \
        "0" if visible is None else visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from cuvite_tpu_torch.kernels import _build
        from cuvite_tpu_torch.io.generate import generate_rgg, generate_rmat
    except ImportError as err:
        fail(f"cuvite_tpu_torch is not beside this script ({err})")
    dev = torch.device("cuda")
    cards = world_cards(visible)

    print("[1] card")
    print(f"  {smi_line()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build_s = _build.build()
    print(f"  kernels built with nvcc in {build_s:.2f} s")
    from cuvite_tpu_torch import native

    gxx_s = native.build()
    print(f"  native host runtime built with g++ in {gxx_s:.2f} s; "
          f"cv_openmp_threads {native.openmp_threads()}, os.cpu_count() "
          f"{os.cpu_count()}")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    if args.only_multiprocess:
        return run_multiprocess_only(args, cards)

    print("[2] row_argmax kernel against its twin, every bucket width")
    check_rows(dev)
    print("[3] heavy_bincount kernel against its twin")
    check_heavy(dev)
    torch.cuda.synchronize()

    print(f"[4] R-MAT {args.check_scale}: card against CPU")
    check_card_vs_cpu(args.check_scale)

    print(f"[5] main path: louvain_phases on R-MAT {args.scale}")
    native.zero_call_counts()
    t0 = time.perf_counter()
    g = generate_rmat(args.scale)
    print(f"  generated {g.num_vertices} vertices, {g.num_edges} directed "
          f"edges, max degree {int(g.degrees().max())} in "
          f"{time.perf_counter() - t0:.2f} s")
    launches, sweeps, bucketed_s, main_res = run_main_path(g, args.scale)
    calls = native.call_counts()
    print(f"  native calls, generation included: {calls}")
    for name in ("build_csr_unit", "plan_scan", "bucket_fill",
                 "coarsen_csr"):
        if calls[name] == 0:
            fail(f"native {name} never called on the main path")

    print(f"[6] kernels at the R-MAT {args.scale} phase-0 shapes")
    kernels = time_kernels(g, launches, sweeps)
    g_rmat = g

    print("[7] seg_coalesce kernel against its twin and the sort engine")
    check_coalesce(dev)
    torch.cuda.synchronize()

    print(f"[8] RGG {args.rgg_check_nv}: sort engine, card against CPU")
    check_sort_card_vs_cpu(args.rgg_check_nv)

    print(f"[9] sort path: louvain_phases(engine='sort') on RGG "
          f"{args.rgg_nv}")
    t0 = time.perf_counter()
    g = generate_rgg(args.rgg_nv)
    print(f"  generated {g.num_vertices} vertices, {g.num_edges} directed "
          f"edges in {time.perf_counter() - t0:.2f} s")
    sort_launches, captured, above, sort_s, sort_res = run_sort_path(
        g, args.rgg_nv)
    print(f"  one phase-0 sort sweep: {time_sort_sweep(g):.4f} ms on the "
          "device stream")
    g_rgg = g

    print("[10] seg_coalesce at the first dense coarsening of the sort path")
    kernels.append(time_coalesce(sort_launches["seg_coalesce"], captured))
    if not above:
        fail(f"RGG {args.rgg_nv}: the sort path ran no sort coarsening")
    (a_src, a_dst, a_w), a_nv, _ = above[0]
    above_caps = [time_engines_above_cap(
        f"RGG {args.rgg_nv} sort path, its narrowest sort coarsening",
        (a_src[None], a_dst[None], a_w[None]), a_nv, a_nv, True)]
    del above
    for k in kernels:
        conv = (f", converged {k['ms_converged']:.4f} ms (twin "
                f"{k['plain_ms_converged']:.4f} ms)"
                if "ms_converged" in k else "")
        print(f"  {k['name']}: {k['ms']:.4f} ms (twin {k['plain_ms']:.4f} "
              f"ms){conv}, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']}, library {k['library_ms']}")
        for p in k.get("per_width", []):
            print(f"    width {p['width']:5d}: {p['real_rows']} of "
                  f"{p['rows']} rows real, {p['real_slots']} slots, "
                  f"{p['ms']:.4f} ms, converged {p['ms_converged']:.4f} "
                  f"ms, bound {p['bound_ms']:.4f} ms")
    c = kernels[-1]
    print(f"    seg_coalesce at nv_pad {c['nv_pad']}, {c['real_rows']} real "
          f"rows: the whole coalesce {c['ms']:.4f} ms, the sort engine "
          f"{c['sort_engine_ms']:.4f} ms, {c['alloc_bytes']} B allocated")
    print(f"    both engines above the cap: {above_caps[0]}")
    if c["max_abs_err"] != 0.0:
        fail(f"seg_coalesce differs from its twin at the sort-path slab "
             f"(max abs err {c['max_abs_err']})")
    paths = {f"bucketed R-MAT {args.scale}": launches,
             f"sort RGG {args.rgg_nv}": sort_launches}
    del captured

    print(f"[11] fused engine, card against CPU, FUSED_SHRINK_EDGES "
          f"{args.fused_shrink}")
    t11 = time.perf_counter()
    paths[f"fused R-MAT {args.fused_check_scale} and RGG "
          f"{args.rgg_check_nv}, shrink {args.fused_shrink}"] = \
        check_fused_card_vs_cpu(
            {f"R-MAT {args.fused_check_scale}":
                generate_rmat(args.fused_check_scale),
             f"RGG {args.rgg_check_nv}": generate_rgg(args.rgg_check_nv)},
            args.fused_shrink)

    print("[12] fused path at full size")
    paths[f"fused RGG {args.rgg_nv}"] = run_fused_path(
        g_rgg, f"RGG {args.rgg_nv}", {"sort": sort_s})
    paths[f"fused R-MAT {args.scale}"] = run_fused_path(
        g_rmat, f"R-MAT {args.scale}", {"bucketed": bucketed_s})

    print(f"[13] R-MAT {args.check_scale}: ET and color schedules, card "
          "against CPU")
    check_schedules_card_vs_cpu(args.check_scale)

    print(f"[14] ET and coloring on R-MAT {args.schedule_scale}")
    if args.schedule_scale != args.scale:
        g_rmat = generate_rmat(args.schedule_scale)
    sched = {}
    paths.update(run_schedule_paths(g_rmat, args.schedule_scale, sched))
    if args.schedule_scale != args.scale:
        sched = {}       # phase 35 compares at --scale
    check_class_sweeps(g_rmat, args.schedule_scale)
    del g_rmat
    print(f"  phases 11-14 took {time.perf_counter() - t11:.1f} s")

    t15 = time.perf_counter()
    print("[15] batched kernels against their twins on the card")
    from cuvite_tpu_torch.kernels.heavy_bincount import heavy_argmax

    n_heavy = heavy_argmax.launches
    batched_heavy = check_batched_kernels(dev)
    batched_heavy["launches_phase15"] = heavy_argmax.launches - n_heavy
    torch.cuda.synchronize()

    print("[16] louvain_many: card against CPU; the golden envelope")
    from cuvite_tpu_torch.io.vite import read_vite
    from cuvite_tpu_torch.workloads.synth import synthesize

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    pl = os.path.join(work, "powerlaw-test.vite")
    truth = synthesize(pl, 40_000, seed=7)["truth_path"]
    paths.update(check_many_card_vs_cpu(read_vite(pl, bits64=False),
                                        truth))

    print("[17] serving batches at full size, both engines")
    batched_rows = batched_coal = None
    for kind in ("serving 4096", "serving 65536", "serving 2^20"):
        t0 = time.perf_counter()
        gs = serving_jobs(kind)
        print(f"  {kind}: {len(gs)} graphs generated in "
              f"{time.perf_counter() - t0:.2f} s, {gs[0].num_vertices} "
              f"vertices and {gs[0].num_edges} directed edges in the first")
        launches, captured = run_serving(kind, gs)
        paths.update(launches)
        bucketed = launches[f"{kind} bucketed"]
        if bucketed["row_argmax"] == 0:
            fail(f"{kind}: the row kernel never launched")
        if kind != "serving 2^20" and bucketed["seg_coalesce"] == 0:
            fail(f"{kind}: seg_coalesce never launched")
        if kind == "serving 4096":
            check_pipeline(f"at {kind}", captured[0][:3], *captured[0][3:5])
        if kind == "serving 65536":
            batched_rows = time_batched_rows(gs)
            batched_coal = time_batched_coalesce(captured, kind)
            for name, d in (("row_argmax", batched_rows),
                            ("seg_coalesce", batched_coal)):
                print(f"  {name} batched at {d['shape']}: {d['ms']:.4f} ms"
                      f" (twin {d['plain_ms']:.4f} ms, bound "
                      f"{d['bound_ms']:.4f} ms by {d['bound_by']})")
            print(f"    the sort engine on that slab "
                  f"{batched_coal['sort_engine_ms']:.4f} ms; the pipeline "
                  f"allocates {batched_coal['alloc_bytes']} B")
        if kind == "serving 2^20":
            above_caps.append(time_engines_above_cap(
                f"{kind}, its first (sort) coarsening", captured[0][:3],
                *captured[0][3:5], False))
            print(f"  both engines above the cap: {above_caps[-1]}")
        del gs, captured
    batched_rows["launches"] = paths["serving 65536 bucketed"]["row_argmax"]
    batched_coal["launches"] = \
        paths["serving 65536 bucketed"]["seg_coalesce"]

    print("[18] device re-binning on the per-graph bucketed driver")
    paths.update(check_rebin_card_vs_cpu(
        {f"RGG {args.rgg_check_nv}": (generate_rgg(args.rgg_check_nv),
                                      False),
         f"R-MAT {args.check_scale}": (generate_rmat(args.check_scale),
                                       True)}))
    paths.update(run_rebin_full(g_rgg, f"RGG {args.rgg_nv}"))
    print(f"  phases 15-18 took {time.perf_counter() - t15:.1f} s")

    t19 = time.perf_counter()
    print("[19] sub-row packing: merged batches, card against CPU and B=1")
    paths.update(check_subrow())

    print("[20] the serving queue through the CLI, at full width")
    from cuvite_tpu_torch import louvain_many

    gs = serving_jobs("serving 4096")
    direct = {}
    for engine in ("bucketed", "fused"):
        direct[engine] = louvain_many(gs, engine=engine)
        paths[f"serve demo B=64 synth 4096, {engine}"] = run_cli_demo(
            engine, direct[engine])
        check_queue_labels(gs, engine, direct[engine])
    print("  LouvainServer on the same 64 jobs, both engines: labels equal "
          "louvain_many's bit for bit")
    paths.update(check_mix())

    print("[21] the daemon on the card, pipelined and serial, with a "
          "transient fault")
    for pipeline, name in (("on", "pipelined"), ("off", "serial")):
        paths[f"daemon {name}, 64 synth 4096, b_max 16"] = run_daemon(
            direct["bucketed"], pipeline)
    print(f"  phases 19-21 took {time.perf_counter() - t19:.1f} s")

    t22 = time.perf_counter()
    card = smi_card(smi_line())
    print(f"[22] the bench on the card, through its command line (R-MAT "
          f"{BENCH_SCALE})")
    bench_paths, (g_bench, bench_res) = run_bench_phase(card, BENCH_SCALE,
                                                        paths)
    paths.update(bench_paths)
    print(f"  phase 22 took {time.perf_counter() - t22:.1f} s")
    t23 = time.perf_counter()
    print("[23] the command line and the flight recorder on the card")
    run_cli_phase(BENCH_SCALE, g_bench, bench_res)
    del g_bench
    print(f"  phase 23 took {time.perf_counter() - t23:.1f} s")
    print(f"  phases 22-23 took {time.perf_counter() - t22:.1f} s")
    g_rmat = generate_rmat(args.scale)

    t24 = time.perf_counter()
    print(f"[24] streaming: R-MAT {args.check_scale} card against CPU")
    paths[f"stream R-MAT {args.check_scale}, card vs CPU"] = \
        check_stream_card_vs_cpu(args.check_scale)
    print(f"[25] streaming at full width: R-MAT {args.scale}")
    paths[f"stream R-MAT {args.scale}"] = run_stream_full(g_rmat,
                                                          args.scale)
    print("[26] the churn bench on the card, through its command line")
    paths[f"bench --churn-frac 0.01 --scale {BENCH_SCALE}, timed arms"] = \
        run_stream_bench(card, BENCH_SCALE)
    print("[27] the daemon's delta verb on the card")
    paths["daemon delta verb"] = run_stream_daemon()
    print(f"  phases 24-27 took {time.perf_counter() - t24:.1f} s")

    S = MESH_SHARDS
    print("[28] the row kernel's size form against its twin, every width")
    t28 = time.perf_counter()
    check_sized_rows(dev, paths[f"bucketed R-MAT {args.scale}"], args.scale)
    sized = time_sized_rows(g_rmat, S)
    print(f"  size form at the sparse {S}-shard phase-0 shapes: "
          f"{sized['launches_per_sweep']} launches a sweep, "
          f"{sized['real_rows']} rows, {sized['real_slots']} slots; "
          f"identity {sized['ms_identity']:.4f} ms (twin "
          f"{sized['plain_ms_identity']:.4f} ms), converged "
          f"{sized['ms_converged']:.4f} ms (twin "
          f"{sized['plain_ms_converged']:.4f} ms), bound "
          f"{sized['bound_ms']:.4f} ms by {sized['bound_by']}")
    check_replicated_rows(g_rmat, S)
    print(f"  phase 28 took {time.perf_counter() - t28:.1f} s")

    print(f"[29] R-MAT {args.check_scale} on {S} shards of one card: card "
          "against CPU and one shard")
    t29 = time.perf_counter()
    paths.update(check_mesh_card_vs_cpu(args.check_scale, S))
    print(f"  phase 29 took {time.perf_counter() - t29:.1f} s")

    print(f"[30] full width: R-MAT {args.scale} on {S} shards of one card, "
          "sparse and replicated")
    t30 = time.perf_counter()
    mesh_launches, mesh_s, mesh_res = run_mesh_full(
        g_rmat, args.scale, S, "sparse", main_res)
    paths[f"mesh {S} shards R-MAT {args.scale} sparse"] = mesh_launches
    rep_launches, rep_s, rep_res = run_mesh_full(
        g_rmat, args.scale, S, "replicated", main_res)
    paths[f"mesh {S} shards R-MAT {args.scale} replicated"] = rep_launches
    one_process = {"sparse": (mesh_res, mesh_launches, mesh_s),
                   "replicated": (rep_res, rep_launches, rep_s)}
    print(f"  R-MAT {args.scale} walls: one shard {bucketed_s:.3f} s "
          f"(phase 5), {S} shards sparse {mesh_s:.3f} s, {S} shards "
          f"replicated {rep_s:.3f} s")
    print(f"  phase 30 took {time.perf_counter() - t30:.1f} s")

    print(f"[31] a per-peer budget of 1 on the card: R-MAT "
          f"{args.check_scale}, {S} shards")
    t31 = time.perf_counter()
    paths.update(check_budget_retry(args.check_scale, S))
    print(f"  phase 31 took {time.perf_counter() - t31:.1f} s")

    kernels.append({
        "name": "row_argmax_sized", "route": "cuda",
        "source": "cuvite_tpu_torch/kernels/csrc/row_argmax.cu",
        "replaces": "cuvite_tpu/kernels/row_argmax.py:166",
        "tpu_function": "cuvite_tpu/kernels/row_argmax.py:"
                        "row_argmax_pallas(szT=...)",
        "launches": mesh_launches["row_argmax_sized"],
        "max_abs_err": sized["max_abs_err"],
        "ms_unit": f"one sparse phase-0 sweep of {S} shards on one card: "
                   "the records and every class launch",
        "ms": sized["ms_identity"], "ms_converged": sized["ms_converged"],
        "plain_ms": sized["plain_ms_identity"],
        "plain_ms_converged": sized["plain_ms_converged"],
        "bound_ms": sized["bound_ms"], "bound_by": sized["bound_by"],
        "bytes": sized["bytes"], "ops": sized["ops"],
        "real_rows": sized["real_rows"], "real_slots": sized["real_slots"],
        "launches_per_sweep": sized["launches_per_sweep"],
        "library_ms": None})

    print(f"[32] the native host runtime against its numpy paths")
    t32 = time.perf_counter()
    check_native(BENCH_SCALE, args.native_rmat_scale, bench_res)
    del bench_res
    print(f"  phase 32 took {time.perf_counter() - t32:.1f} s")

    t35 = time.perf_counter()
    print(f"[35] ET, the color schedules and checkpoints on {S} shards of "
          "one card (before phases 33-34, which hold their colored runs "
          "against it)")
    paths.update(check_mesh_schedules(MESH_CHECK_SCALE, S))
    print(f"  R-MAT {MESH_CHECK_SCALE} runs took "
          f"{time.perf_counter() - t35:.1f} s")
    t1 = time.perf_counter()
    paths.update(check_mesh_class_sweeps(generate_rmat(CLASS_SWEEP_SCALE),
                                         CLASS_SWEEP_SCALE, S))
    print(f"  R-MAT {CLASS_SWEEP_SCALE} class sweeps took "
          f"{time.perf_counter() - t1:.1f} s")
    walls = []
    # At full width the colored sparse run only: phases 33-34 hold theirs
    # against it; et_mode=3 runs card against CPU at MESH_CHECK_SCALE
    # above and phase 30 runs the replicated exchange at full width.
    for kw in ({"coloring": 8, "exchange": "sparse"},):
        one_name = _kw_name({k: v for k, v in kw.items()
                             if k != "exchange"})
        one, one_s = sched.get(one_name, (None, None))
        launches, wall, res = run_mesh_schedule_full(g_rmat, args.scale, S,
                                                     kw, one)
        paths[f"mesh {S} shards R-MAT {args.scale} {_kw_name(kw)}"] = \
            launches
        walls.append(f"{_kw_name(kw)} {wall:.3f} s on {S} shards"
                     + (f" vs {one_s:.3f} s on one shard (phase 14)"
                        if one_s is not None else ""))
        if kw.get("coloring"):
            one_process[COLOR_RUN] = (res, launches, wall)
    print(f"  R-MAT {args.scale} walls: {'; '.join(walls)}")
    print(f"  phase 35 took {time.perf_counter() - t35:.1f} s")

    t36 = time.perf_counter()
    print(f"[36] the two-level exchange on a {HYBRID[0]}x{HYBRID[1]} hybrid "
          f"mesh of one card, and the batch axis (before phases 33-34, "
          "which hold their two-level run against it)")
    paths.update(check_twolevel_card_vs_cpu(args.check_scale, S, work))
    print(f"  R-MAT {args.check_scale} runs took "
          f"{time.perf_counter() - t36:.1f} s")
    tl_launches, tl_s, tl_res = run_mesh_full(
        g_rmat, args.scale, S, "twolevel", main_res, shape=HYBRID)
    paths[f"mesh 2x2 R-MAT {args.scale} twolevel"] = tl_launches
    one_process[TWOLEVEL_RUN] = (tl_res, tl_launches, tl_s)
    check_same_run(f"R-MAT {args.scale} 2x2 vs the flat sparse mesh "
                   "(phase 30)", tl_res, mesh_res)
    if tl_res.modularity != mesh_res.modularity:
        fail(f"R-MAT {args.scale} 2x2: Q bits differ from phase 30's sparse "
             "run")
    print(f"  R-MAT {args.scale} walls in this call: 2x2 two-level "
          f"{tl_s:.3f} s, {S} shards flat sparse {mesh_s:.3f} s and "
          f"replicated {rep_s:.3f} s (phase 30), one shard "
          f"{bucketed_s:.3f} s (phase 5)")
    gs = serving_jobs("serving 65536")
    paths.update(check_batch_mesh(gs, "serving 65536"))
    if len(cards) >= 2:
        paths.update(run_batch_auto(cards, "serving 65536"))
    else:
        print("  one card on this host: no mesh='auto' run over cards")
    print(f"  phase 36 took {time.perf_counter() - t36:.1f} s")

    t37 = time.perf_counter()
    print(f"[37] the last runtime modules: the converters, "
          f"engine='pallas' and its coverage, the msd and hash coalesce "
          f"engines")
    paths.update(run_converted(generate_rmat(CONVERT_SCALE), CONVERT_SCALE,
                               work))
    paths.update(check_converted_formats(args.check_scale, work))
    paths.update(run_coalesce_engines(g_rgg, args.rgg_nv, sort_res))
    del g_rgg, sort_res
    paths.update(check_batch_msd(gs, "serving 65536"))
    del gs
    print(f"  phase 37 took {time.perf_counter() - t37:.1f} s")

    t38 = time.perf_counter()
    print("[38] the drivers (cuvite_tpu_torch.tools) on the card, in one "
          "child process")
    paths.update(run_tools(card))
    print(f"  phase 38 took {time.perf_counter() - t38:.1f} s")

    t39 = time.perf_counter()
    print("[39] the static analysis of the port, cold and then warm from "
          "its cache")
    run_analysis()
    print(f"  phase 39 took {time.perf_counter() - t39:.1f} s")

    t40 = time.perf_counter()
    print("[40] the dynamic analysis tiers on the card, in one child: "
          "concheck, the width, compile and mesh audits")
    paths.update(run_audits())
    print(f"  phase 40 took {time.perf_counter() - t40:.1f} s")

    paths.update(run_multiprocess(g_rmat, args.scale, S, cards,
                                  one_process))
    del g_rmat

    kernels[0]["batched"] = batched_rows
    kernels[1]["batched"] = batched_heavy
    kernels[2]["batched"] = batched_coal
    kernels[2]["above_caps"] = above_caps
    for k in kernels:
        k["launches_by_path"] = {p: n.get(k["name"], 0)
                                 for p, n in paths.items()}
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
