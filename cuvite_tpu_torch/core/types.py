"""Scalar type policy (port of ``cuvite_tpu/core/types.py``).

The host graph keeps the ``Policy`` dtypes (int32 ids and float32 weights by
default, int64/float64 for ``--bits64`` files).  The device path always runs
int32 ids and float32 weights: the kernels take nothing else, and the
in-loop modularity is accumulated in float64 on the card instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Driver safety nets (reference main.cpp:486-494).
TERMINATION_PHASE_COUNT = 200
MAX_TOTAL_ITERATIONS = 10_000


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtype policy for the host graph arrays."""

    vertex_dtype: np.dtype = np.dtype(np.int32)
    weight_dtype: np.dtype = np.dtype(np.float32)


def default_policy() -> Policy:
    return Policy()


def wide_policy() -> Policy:
    """64-bit ids + weights: the ``USE_32_BIT_GRAPH``-off configuration."""
    return Policy(vertex_dtype=np.dtype(np.int64),
                  weight_dtype=np.dtype(np.float64))


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())
