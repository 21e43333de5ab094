"""cuvite_tpu_torch: the Louvain community detection of ``cuvite_tpu``,
ported to PyTorch with hand-written CUDA kernels for one NVIDIA H100.

It runs ``louvain_phases`` single-GPU end to end: the degree-bucketed
sweep on the row-argmax and heavy-bincount kernels (``kernels/csrc``),
host plans and host coarsening between phases.  Entry points run on the
card unless the caller passes ``device="cpu"``, which runs the kernels'
plain PyTorch versions.  Not ported yet: multi-GPU, the ``szT`` size
channel, early termination (ET), coloring, device coarsening and
re-binning, checkpointing, serving and streaming.

The package imports torch and numpy only; it never imports JAX or
``cuvite_tpu``.
"""

from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.louvain.driver import LouvainResult, louvain_phases

__all__ = ["Graph", "LouvainResult", "louvain_phases"]
