"""Where an entry point of the port runs."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without CUDA that raises instead of
    running on the CPU.  Pass ``"cpu"`` to run the plain twins."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cuvite_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)
