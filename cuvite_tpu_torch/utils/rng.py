"""Counter-based integer RNG (port of ``cuvite_tpu/utils/rng.py:149-183``).

SplitMix64 over uint64 counters, so every draw is a pure function of its
index and the R-MAT generator is bit-identical to the reference's.
"""

from __future__ import annotations

import numpy as np

_SM_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_SM_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_C2 = np.uint64(0x94D049BB133111EB)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized SplitMix64 finalizer over a uint64 array (wrapping)."""
    with np.errstate(over="ignore"):  # modular arithmetic is the point
        x = (np.asarray(x, dtype=np.uint64) + _SM_GOLDEN)
        x ^= x >> np.uint64(30)
        x *= _SM_C1
        x ^= x >> np.uint64(27)
        x *= _SM_C2
        x ^= x >> np.uint64(31)
    return x


def u01(x: np.ndarray) -> np.ndarray:
    """uint64 -> float64 uniform in [0, 1) with 53 random bits."""
    return (np.asarray(x, dtype=np.uint64) >> np.uint64(11)).astype(
        np.float64) * (1.0 / 9007199254740992.0)


def scramble_ids(x: np.ndarray, bits: int, seed: int) -> np.ndarray:
    """Deterministic bijection on [0, 2^bits): two rounds of (odd multiply
    mod 2^bits, xor own high half).  Breaks the R-MAT id/degree
    correlation in place of a materialized random permutation."""
    mask = np.uint64(0xFFFFFFFFFFFFFFFF if bits >= 64 else (1 << bits) - 1)
    s = np.uint64(seed)
    odd1 = splitmix64(s ^ np.uint64(0xA5A5A5A5)) | np.uint64(1)
    odd2 = splitmix64(s ^ np.uint64(0x5A5A5A5A)) | np.uint64(1)
    h = np.uint64(max(bits // 2, 1))
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = (x * odd1) & mask
        x = x ^ (x >> h)
        x = (x * odd2) & mask
        x = x ^ (x >> h)
    return x & mask
