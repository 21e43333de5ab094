"""Per-phase reported modularity (port of ``cuvite_tpu/louvain/precise.py``,
host path).

The phase-end assignment is already on the host, so the reported value is
the f64 numpy oracle over the phase's graph.  The reference's device
double-single pass serves its sort engine, which the port does not have.
"""

from __future__ import annotations

import numpy as np

from cuvite_tpu_torch.evaluate.modularity import modularity


def phase_modularity(dg, comm_pad: np.ndarray) -> float:
    """Modularity of ``comm_pad`` (padded-space labels) on ``dg.graph``."""
    return modularity(dg.graph, np.asarray(comm_pad)[dg.old_to_pad])
