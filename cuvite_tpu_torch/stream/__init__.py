"""Streaming on one CUDA card: delta ingestion and warm-start incremental
re-clustering for live graphs (port of ``cuvite_tpu/stream/``).

``DeltaBatch`` canonicalizes edge insert/delete batches;
``apply_delta_slab`` is the one function that edits a resident slab;
``StreamSession`` owns a tenant's slab on the card and re-clusters it
warm, seeded from the previous labels and the delta frontier.
"""

from cuvite_tpu_torch.stream.delta import (
    DELTA_PAD_MIN,
    DeltaBatch,
    apply_delta_slab,
    delta_frontier,
    plp_prepass,
)
from cuvite_tpu_torch.stream.session import WARM_MODES, StreamSession

__all__ = [
    "DELTA_PAD_MIN",
    "DeltaBatch",
    "StreamSession",
    "WARM_MODES",
    "apply_delta_slab",
    "delta_frontier",
    "plp_prepass",
]
