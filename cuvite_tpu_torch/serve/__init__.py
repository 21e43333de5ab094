"""cuvite_tpu_torch.serve: the multi-tenant serving layer on one CUDA card
(port of ``cuvite_tpu/serve/``).

A slab-class serving queue in front of the batched driver
(``louvain/batched.py``): jobs bin by their pow2 slab class with
per-tenant fairness sub-queues, pack into batches of up to ``b_max`` with
a linger deadline (or, with ``merge_packing``, as fenced sub-rows of a
larger served class), run as one batch on the card and unpack into
per-tenant ``LouvainResult``s.  Around it: SLO-projected admission
control with ``retry_after_s`` rejections and the measured-service b_max
autotuner (``admission.py``), deadline shedding, deterministic fault
injection with bounded retry (``faults.py``), a socket daemon with a
graceful SIGTERM drain (``daemon.py``), the two-stage pipelined
dispatcher (``pipeline.py``), and an open-loop load generator
(``loadgen.py``).  Every deadline runs on the injectable clock
(``clock.py``); every lock, event and thread comes from ``sync.py``.

    python -m cuvite_tpu_torch.serve demo --jobs 64 --b-max 64
    python -m cuvite_tpu_torch.serve cluster-many a.vite b.vite ...
    python -m cuvite_tpu_torch.serve daemon --socket /tmp/cuvite.sock

Streaming: ``StreamPool`` keeps per-tenant resident slabs
(``stream.StreamSession``) under a device byte budget, behind the
daemon's ``delta`` verb (``daemon --stream-budget-mb``).

The serve benches are ``workloads/bench.py`` (``run_serve_bench``,
``run_mixed_serve_bench``), and ``--trace-out`` writes the flight
recorder's trace.  Not ported yet: the concurrency checker's cooperative
scheduler (``ROADMAP.md`` queue A item A9 step 4: ``concheck`` and its
``Scheduler``).
"""

from cuvite_tpu_torch.serve.admission import (
    AdmissionConfig,
    AdmissionController,
    AdmissionReject,
    AutotuneConfig,
    BmaxAutotuner,
)
from cuvite_tpu_torch.serve.daemon import ServeDaemon
from cuvite_tpu_torch.serve.faults import FaultPlan, InjectedFault
from cuvite_tpu_torch.serve.pipeline import PipelinedDispatcher
from cuvite_tpu_torch.serve.queue import (
    Job,
    LouvainServer,
    PackedBatch,
    ServeConfig,
    ServeStats,
    StreamPool,
)

__all__ = [
    "AdmissionConfig", "AdmissionController", "AdmissionReject",
    "AutotuneConfig", "BmaxAutotuner", "FaultPlan", "InjectedFault",
    "Job", "LouvainServer", "PackedBatch", "PipelinedDispatcher",
    "ServeConfig", "ServeDaemon", "ServeStats", "StreamPool",
]
