"""Phase checkpoints for the multi-phase driver (port of
``cuvite_tpu/utils/checkpoint.py:29-142``, numpy only).

After every gaining phase the driver may save the inter-phase state --
the composed labels of the original vertices, the current coarse graph
and its counters -- as one ``phase_NNNN.npz`` in a checkpoint directory,
written to a temporary file and renamed, so a killed run resumes from its
last complete phase.  The files hold the reference's keys, so a
checkpoint written by either package resumes in the other.  They are
loaded with ``allow_pickle=False``.
"""

from __future__ import annotations

import dataclasses
import os
import zipfile
import zlib

import numpy as np

from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.core.types import Policy


@dataclasses.dataclass
class PhaseCheckpoint:
    phase: int               # next phase index to run
    comm_all: np.ndarray     # composed labels of the ORIGINAL vertices
    graph: Graph             # current coarse graph
    prev_mod: float
    tot_iters: int
    mod_hist: np.ndarray     # per completed phase
    iter_hist: np.ndarray
    nv_hist: np.ndarray      # vertices/edges of each completed phase's graph
    ne_hist: np.ndarray
    orig_ne: int = -1        # edge count of the ORIGINAL graph
    fingerprint: int = -1    # content fingerprint of the ORIGINAL graph


def graph_fingerprint(graph: Graph) -> int:
    """CRC chain of the CSR offsets and tails and the f64 total weight,
    with the vertex count (the reference's, bit for bit): graphs that share
    (nv, ne), like R-MATs of one scale and two seeds, differ here, so a
    resume cannot compose labels for the wrong graph."""
    h = zlib.crc32(np.ascontiguousarray(graph.offsets).view(np.uint8))
    h = zlib.crc32(np.ascontiguousarray(graph.tails).view(np.uint8), h)
    tw = float(np.sum(graph.weights, dtype=np.float64))
    h = zlib.crc32(np.float64(tw).tobytes(), h)
    return (h << 16) ^ (graph.num_vertices & 0xFFFF)


def _phase_num(name: str) -> int | None:
    """N of 'phase_<N>.npz' (any digit count; None if malformed)."""
    stem = name[len("phase_"):-len(".npz")]
    return int(stem) if stem.isdigit() else None


def _path(ckpt_dir: str, phase: int) -> str:
    return os.path.join(ckpt_dir, f"phase_{phase:04d}.npz")


def save_phase(ckpt_dir: str, ck: PhaseCheckpoint) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, ck.phase)
    tmp = path + ".tmp"
    g = ck.graph
    with open(tmp, "wb") as f:
        np.savez(
            f,
            phase=np.int64(ck.phase),
            comm_all=ck.comm_all,
            offsets=g.offsets,
            tails=g.tails,
            weights=g.weights,
            vertex_dtype=np.str_(np.dtype(g.policy.vertex_dtype).name),
            weight_dtype=np.str_(np.dtype(g.policy.weight_dtype).name),
            # The reference's accumulator dtype: its default and wide
            # policies pair it with the weight dtype.  The port sums in
            # f64 and keeps no such field.
            accum_dtype=np.str_(np.dtype(g.policy.weight_dtype).name),
            prev_mod=np.float64(ck.prev_mod),
            tot_iters=np.int64(ck.tot_iters),
            mod_hist=np.asarray(ck.mod_hist, dtype=np.float64),
            iter_hist=np.asarray(ck.iter_hist, dtype=np.int64),
            nv_hist=np.asarray(ck.nv_hist, dtype=np.int64),
            ne_hist=np.asarray(ck.ne_hist, dtype=np.int64),
            orig_ne=np.int64(ck.orig_ne),
            fingerprint=np.int64(ck.fingerprint),
        )
    os.replace(tmp, path)
    # Runs advance monotonically, so a higher-numbered file is left from an
    # earlier run in this directory; a later resume must not pick it.
    for name in os.listdir(ckpt_dir):
        if name.startswith("phase_") and name.endswith(".npz"):
            num = _phase_num(name)
            if num is not None and num > ck.phase:
                os.remove(os.path.join(ckpt_dir, name))
    return path


def load_latest(ckpt_dir: str) -> PhaseCheckpoint | None:
    """The highest-numbered complete checkpoint, or None.  A truncated or
    corrupt file falls back to the one before it."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = sorted(
        (n for n in os.listdir(ckpt_dir)
         if n.startswith("phase_") and n.endswith(".npz")
         and _phase_num(n) is not None),
        key=_phase_num,
    )
    for name in reversed(names):
        path = os.path.join(ckpt_dir, name)
        try:
            with np.load(path, allow_pickle=False) as z:
                policy = Policy(
                    vertex_dtype=np.dtype(str(z["vertex_dtype"])),
                    weight_dtype=np.dtype(str(z["weight_dtype"])),
                )
                graph = Graph(offsets=z["offsets"], tails=z["tails"],
                              weights=z["weights"], policy=policy)
                return PhaseCheckpoint(
                    phase=int(z["phase"]),
                    comm_all=np.asarray(z["comm_all"]),
                    graph=graph,
                    prev_mod=float(z["prev_mod"]),
                    tot_iters=int(z["tot_iters"]),
                    mod_hist=np.asarray(z["mod_hist"]),
                    iter_hist=np.asarray(z["iter_hist"]),
                    nv_hist=np.asarray(z["nv_hist"]),
                    ne_hist=np.asarray(z["ne_hist"]),
                    orig_ne=int(z["orig_ne"]),
                    fingerprint=(int(z["fingerprint"])
                                 if "fingerprint" in z else -1),
                )
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            continue
    return None
