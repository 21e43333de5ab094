"""cuvite_tpu_torch: the Louvain community detection of ``cuvite_tpu``,
ported to PyTorch with hand-written CUDA kernels for one NVIDIA H100.

It runs ``louvain_phases`` single-GPU end to end on three engines.  The
default ``bucketed`` engine sweeps degree-bucketed plans on the row-argmax
and heavy-bincount kernels (``kernels/csrc``), with host plans and host
coarsening between phases; the host stages and the ingest under them run
in the native host runtime (``native/``, C++ that g++ builds at first
use; ``CUVITE_NO_NATIVE=1`` runs their numpy versions).  The ``sort`` engine keeps the edge slab on the
card, sweeps it with a packed-key sort, and coarsens it there, on the
``seg_coalesce`` kernel once a phase's class is at most 4096 vertices.  The
``fused`` engine uploads the slab once, runs relabel-only phases on it,
coarsens it on the card while it is big and composes the labels there.
Early termination (``et_mode``), the coloring and vertex-ordering
schedules (class-restricted sweeps on the bucketed kernels) and phase
checkpoints (``checkpoint_dir``/``resume``, files the reference package
reads too) are options of ``louvain_phases``.  Entry points run on the
card unless the caller passes ``device="cpu"``, which runs the kernels'
plain PyTorch versions.  Coarse phases of the bucketed engine build their
plans on the card (device re-binning).  ``louvain_many`` clusters a batch
of same-class graphs at once (``louvain/batched.py``), every tenant
folded into one id space so that each kernel launch covers the batch;
``cluster_packed`` runs small graphs packed two or more to a row of a
larger class (sub-row packing).  ``cuvite_tpu_torch.serve`` is the serving
layer on top (``LouvainServer``, admission, faults, the pipelined
dispatcher and the socket daemon; ``python -m cuvite_tpu_torch.serve
demo|cluster-many|daemon``, with ``--device cpu`` for the CPU).
The flight recorder (``obs/``) rides on the drivers' ``tracer=``, and
``python -m cuvite_tpu_torch.workloads bench`` prints the reference's
bench record (``workloads/bench.py``); its ``fetch`` and ``convert`` verbs
bring datasets in (``workloads/registry.py``, ``workloads/convert.py``).
``engine="pallas"``, the reference's kernel engine, runs the bucketed
engine, and every bucketed run reports its kernel coverage;
``CUVITE_SEG_COALESCE=msd|hash`` selects the reference's big-class
coalesce engines.  ``stream/`` re-clusters graphs
that change between requests (the daemon's ``delta`` verb).
``louvain_phases(graph, nshards=S)`` (or ``mesh=comm.mesh.make_mesh(...)``)
runs S vertex shards from one process, on S cards or several shards to a
card, under the replicated or the sparse ghost exchange (``comm/``); the
sparse one runs the row kernel's size form.  After
``comm.multihost.initialize`` (``--distributed`` in the CLI, or torchrun)
the same call runs one rank per card over ``torch.distributed``, each
rank sweeping its own shards; ``io.dist_ingest.DistVite`` has each rank
read only its shards' edges.  ``mesh_shape=(dcn, ici)`` runs the
two-level exchange on a hybrid mesh, ET and the color schedules run on a
mesh, and ``louvain_many`` shards a batch's rows over the visible cards
(``mesh="auto"``).  Not ported yet: the concurrency checker's scheduler.

The package imports torch, numpy and scipy only; it never imports JAX
or ``cuvite_tpu``.  ``cuvite_tpu_torch.analysis`` (the static analysis of
this tree, ``python -m cuvite_tpu_torch.analysis``) imports the standard
library only.
"""

import importlib

__all__ = ["Graph", "LouvainResult", "louvain_many", "louvain_phases"]

# The public names load on first use (PEP 562), so that a subpackage that
# needs no torch -- the static analysis, ``cuvite_tpu_torch.analysis`` --
# imports none through this file.
_LAZY = {
    "Graph": "cuvite_tpu_torch.core.graph",
    "LouvainResult": "cuvite_tpu_torch.louvain.driver",
    "louvain_many": "cuvite_tpu_torch.louvain.driver",
    "louvain_phases": "cuvite_tpu_torch.louvain.driver",
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(
            f"module 'cuvite_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name]), name)
    globals()[name] = value
    return value
