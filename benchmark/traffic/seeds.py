"""Seeds of the graphs of a run's pool, drawn from the run's seed by a
SplitMix64 hash, so that no two graphs of one run, and no two runs' graphs,
share a stream."""

from __future__ import annotations

_GOLDEN = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1
_POOL = 0x09 << 56


def splitmix64(x: int) -> int:
    x = (x + _GOLDEN) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def graph_seed(seed: int, index: int) -> int:
    """Seed of graph ``index`` of the pool drawn from ``seed`` (62 bits)."""
    base = (seed * _GOLDEN + _POOL) & _MASK64
    return splitmix64((base + index) & _MASK64) & ((1 << 62) - 1)
