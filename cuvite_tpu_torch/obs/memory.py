"""Device-memory ledger, host RSS and the card's allocator snapshot (port
of ``cuvite_tpu/obs/memory.py``).

Every logical buffer a driver places on the device (the slab, the
per-vertex tables, the bucket plans) is recorded by category with its
byte count, snapshotted at phase boundaries, and the per-category peak
survives the run (the bench record's ``hbm_peak_by_buffer``).  Byte counts
are logical sizes, ``numel * element_size`` of each tensor: what the
driver asked for, not what the caching allocator reserved.  Reading them
touches metadata only, never the device.  :func:`save_memory_profile` is
the allocator-truth complement.

Stdlib only: tensors are recognised by duck type.
"""

from __future__ import annotations

import dataclasses
import json
import os


def _leaves(objs):
    """The tensors and array-likes inside ``objs``: dataclasses, lists,
    tuples and dicts are walked; None and scalars are dropped."""
    for a in objs:
        if a is None or isinstance(a, (bool, int, float, str)):
            continue
        if hasattr(a, "element_size") or hasattr(a, "nbytes"):
            yield a
        elif dataclasses.is_dataclass(a) and not isinstance(a, type):
            yield from _leaves(getattr(a, f.name)
                               for f in dataclasses.fields(a))
        elif isinstance(a, (list, tuple)):
            yield from _leaves(a)
        elif isinstance(a, dict):
            yield from _leaves(a.values())


def per_device_nbytes(a) -> int:
    """The bytes one device holds for ``a``: ``numel * element_size`` of a
    tensor (the port places every buffer on one device, so the global and
    per-device books agree), ``nbytes`` of anything else."""
    if hasattr(a, "element_size"):
        return int(a.numel()) * int(a.element_size())
    return int(getattr(a, "nbytes", 0) or 0)


class DeviceMemoryLedger:
    """Per-category device-buffer byte accounting.

    ``begin_phase()`` clears the live set (a new phase replaces the
    previous phase's buffers); ``track(category, *buffers)`` adds the
    bytes of every tensor or array-like in ``buffers`` (containers and
    dataclasses are walked, None and scalars ignored);
    ``snapshot(phase)`` returns the live totals and folds them into the
    running per-category peaks (``peak_by_buffer``).  The reference's
    two books -- logical global bytes and per-device bytes -- are both
    kept, and agree on one device.
    """

    CATEGORIES = ("slab", "tables", "plans", "exchange",
                  "exchange_grouped", "scratch")

    def __init__(self):
        self.live: dict = {}
        self.live_per_device: dict = {}
        self.peak_by_buffer: dict = {}
        self.peak_per_device: dict = {}
        self.snapshots: list = []

    def begin_phase(self) -> None:
        self.live = {}
        self.live_per_device = {}

    def track(self, category: str, *buffers) -> None:
        n = 0
        for a in _leaves(buffers):
            n += per_device_nbytes(a)
        self.track_nbytes(category, n)

    def track_nbytes(self, category: str, nbytes: int) -> None:
        if nbytes:
            self.live[category] = self.live.get(category, 0) + int(nbytes)
            self.live_per_device[category] = \
                self.live_per_device.get(category, 0) + int(nbytes)

    def snapshot(self, phase=None) -> dict:
        from cuvite_tpu_torch.utils.trace import rss_high_water_mb

        by_buffer = dict(self.live)
        per_device = dict(self.live_per_device)
        for k, v in by_buffer.items():
            if v > self.peak_by_buffer.get(k, 0):
                self.peak_by_buffer[k] = v
        for k, v in per_device.items():
            if v > self.peak_per_device.get(k, 0):
                self.peak_per_device[k] = v
        snap = {
            "phase": phase,
            "by_buffer": by_buffer,
            "per_device": per_device,
            "total": sum(by_buffer.values()),
            "rss_mb": round(rss_high_water_mb(), 1),
        }
        self.snapshots.append(snap)
        return snap


def save_memory_profile(profile_dir: str | None, tag: str) -> str | None:
    """Write the card's allocator view (``torch.cuda.memory_stats()``) as
    JSON to ``<profile_dir>/memory.<tag>.json`` and return the path: the
    counterpart of the reference's ``jax.profiler`` device-memory
    profile.  None without a ``profile_dir``, and when the process has
    not used a CUDA device (a CPU run)."""
    if not profile_dir:
        return None
    import torch

    if not torch.cuda.is_initialized():
        return None
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"memory.{tag}.json")
    stats = {"device": torch.cuda.get_device_name(),
             "memory_stats": torch.cuda.memory_stats()}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(stats, f, indent=1, sort_keys=True)
        f.write("\n")
    return path
