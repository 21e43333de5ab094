"""cuvite_tpu_torch: the Louvain community detection of ``cuvite_tpu``,
ported to PyTorch with hand-written CUDA kernels for one NVIDIA H100.

It runs ``louvain_phases`` single-GPU end to end on two engines.  The
default ``bucketed`` engine sweeps degree-bucketed plans on the row-argmax
and heavy-bincount kernels (``kernels/csrc``), with host plans and host
coarsening between phases.  The ``sort`` engine keeps the edge slab on the
card, sweeps it with a packed-key sort, and coarsens it there, on the
``seg_coalesce`` kernel once a phase's class is at most 4096 vertices.
Entry points run on the card unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions.  Not ported yet:
multi-GPU, the ``szT`` size channel, the fused engine, early termination
(ET), coloring, device re-binning, checkpointing, the RGG ``-e`` extra
edges, serving and streaming.

The package imports torch and numpy only; it never imports JAX or
``cuvite_tpu``.
"""

from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.louvain.driver import LouvainResult, louvain_phases

__all__ = ["Graph", "LouvainResult", "louvain_phases"]
