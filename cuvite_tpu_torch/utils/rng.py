"""Host random streams (port of ``cuvite_tpu/utils/rng.py``).

- The Park-Miller MINSTD stream of the reference application (port of
  ``utils/rng.py:27-112``): x[i] = 16807 * x[i-1] mod (2^31 - 1), seeded
  through a one-word C++11 ``std::seed_seq``, jumped in closed form so a
  slice of the one global stream needs no communication.  The RGG
  generator draws its points from it, bit-identical to the reference.
- ``minstd0_uniform_real`` (port of ``utils/rng.py:114-146``): the
  reference application's far-edge weight, a ``uniform_real_distribution``
  draw from a freshly seeded ``minstd_rand0``, as libstdc++ computes it.
- Counter-based SplitMix64 (port of ``utils/rng.py:149-183``): every draw
  is a pure function of its index, so the R-MAT generator is bit-identical
  to the reference's.
"""

from __future__ import annotations

import numpy as np

MLCG = 2147483647  # 2^31 - 1
ALCG = 16807       # 7^5


def seed_seq_generate(seeds: list[int], n: int) -> list[int]:
    """C++11 ``std::seed_seq::generate`` ([rand.util.seedseq]) for 32-bit
    words."""
    m32 = 0xFFFFFFFF
    if n == 0:
        return []
    b = [0x8B8B8B8B] * n
    s = len(seeds)
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 \
        else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x: int) -> int:
        return (x ^ (x >> 27)) & m32

    for k in range(m):
        r1 = (1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) \
            & m32
        if k == 0:
            r2 = (r1 + s) & m32
        elif k <= s:
            r2 = (r1 + (k % n) + seeds[k - 1]) & m32
        else:
            r2 = (r1 + (k % n)) & m32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & m32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & m32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((b[k % n] + b[(k + p) % n]
                                + b[(k - 1) % n]) & m32)) & m32
        r4 = (r3 - (k % n)) & m32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def reseeder(initseed: int) -> int:
    """One ``seed_seq`` word from the user seed (the stream's x0)."""
    return seed_seq_generate([initseed & 0xFFFFFFFF], 1)[0]


def lcg_jump(x0: int, k: int) -> int:
    """x_k given x_0: x0 * a^k mod M, the closed form of the reference's
    parallel-prefix matrix power (the increment is 0)."""
    return (x0 * pow(ALCG, k, MLCG)) % MLCG


def lcg_stream(seed: int, total: int, lo: int = 0,
               hi: int | None = None) -> np.ndarray:
    """Slice [lo, hi) of the global stream for ``seed`` as float64
    uniforms, x / M.  Element 0 is x0 itself, unreduced: a 32-bit x0 >= M
    gives a uniform above 1.0, as in the reference application."""
    hi = total if hi is None else hi
    n = hi - lo
    if n <= 0:
        return np.empty(0, dtype=np.float64)
    # x_{base+j} = x_base * a^j mod M; both factors are < 2^31, so the
    # products fit int64 exactly.  Walk base points in blocks of `block`.
    block = 1024
    a_pows = np.empty(block, dtype=np.int64)
    a_pows[0] = 1
    for j in range(1, block):
        a_pows[j] = (a_pows[j - 1] * ALCG) % MLCG
    a_block = pow(ALCG, block, MLCG)
    out = np.empty(n, dtype=np.int64)
    x0 = reseeder(seed)
    x = lcg_jump(x0, lo)
    for b0 in range(0, n, block):
        blk = min(block, n - b0)
        out[b0:b0 + blk] = (x * a_pows[:blk]) % MLCG
        x = (x * a_block) % MLCG
    if lo == 0:
        out[0] = x0
    return out.astype(np.float64) * (1.0 / float(MLCG))


def minstd0_uniform_real(seed32: np.ndarray, lo: float,
                         hi: float) -> np.ndarray:
    """libstdc++'s ``uniform_real_distribution<double>(lo, hi)`` drawn from
    a ``minstd_rand0`` seeded with each element of ``seed32`` (truncated to
    32 bits): engine state x0 = seed mod M (0 -> 1), two draws
    d = 16807 x mod M, ``generate_canonical<double, 53>`` with k = 2 and
    r = M - 1 giving ((d1 - 1) + (d2 - 1) r) / r^2, then
    (hi - lo) * canon + lo."""
    x = (np.asarray(seed32, dtype=np.uint64) & np.uint64(0xFFFFFFFF)) \
        % np.uint64(MLCG)
    x = np.where(x == 0, np.uint64(1), x).astype(np.int64)
    d1 = (x * ALCG) % MLCG
    d2 = (d1 * ALCG) % MLCG
    r = np.float64(MLCG - 1)
    canon = ((d1 - 1).astype(np.float64)
             + (d2 - 1).astype(np.float64) * r) / (r * r)
    return (hi - lo) * canon + lo


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
