"""The native host runtime of the port (the counterpart of
``cuvite_tpu/native/__init__.py``), bound through ctypes.

``csrc/cuvite_native.cpp`` (C++17 with OpenMP) speeds up the host layer
under the device path: the CSR builders of ``Graph.from_edges``, the fused
relabel-and-coalesce of ``coarsen_graph``, the streamed plan build of
``BucketPlan.build`` (``plan_scan`` + ``bucket_fill``), R-MAT generation,
the Vite reader and writer, weighted degrees and edge-balanced parts.
Every routine is bit-identical to the numpy path it replaces, which stays
in the calling module as the plain version (``tests/test_torch_native.py``
holds each pair equal, and both to the reference package).

Build.  The first call of any routine compiles the source with ``g++``
(:data:`GXX_FLAGS`) into ``build/cuvite_tpu_torch/`` beside the CUDA
kernels, named by a digest of the source, the flags and the host CPU, and
loads it; later calls and processes reuse the file.  The compiler writes a
temporary file that is renamed into place, so processes building at once
never load a half-written library.  ``-ffp-contract=off`` keeps GCC from
fusing a multiply and an add into an FMA, which could move a bit away
from numpy.  Each build and each first load is reported through
``kernels/_build.HOOKS`` as ``kind`` ``"build"`` / ``"load"`` with
``module`` ``"cuvite_native"``, so the compile watcher and the bench guard
see them.  Importing this module compiles nothing.

The reference drops to numpy when its build fails or its library is
stale; the port does not.  A failed build raises with g++'s output, as a
failed nvcc build does, and only ``CUVITE_NO_NATIVE=1`` (any value but
empty or ``0``) turns the library off.  The dispatch conditions are the
reference's: at least :data:`MIN_NATIVE_EDGES` elements, and the shape
declines of each call site (mixed id dtypes or a slab that is not
CSR-sorted with its padding at the tail for the plan, ``nv > 2^32`` for
the generic CSR builder).

:func:`call_counts` reads how many times each routine ran since
:func:`zero_call_counts`, as ``kernels.launch_counts`` does for the CUDA
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

from cuvite_tpu_torch.kernels import _build

SOURCE = Path(__file__).resolve().with_name("csrc") / "cuvite_native.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
             "-fPIC", "-shared", "-std=c++17")
GXX_TIMEOUT_S = 300
MODULE = "cuvite_native"

# Minimum element count for routing through the library; below it the
# ctypes and copy overhead outweighs the win.  Shared by every dispatch
# site (from_edges, coarsen_graph, BucketPlan.build, the Vite I/O).
MIN_NATIVE_EDGES = 1 << 16

# Calls of each routine since the counts were last zeroed.
ROUTINES = ("build_csr", "build_csr_unit", "build_csr_w", "rmat_edges",
            "vite_header", "vite_edges", "vite_write", "balanced_parts",
            "coarsen_csr", "weighted_degrees", "plan_scan", "bucket_fill")
_CALLS = dict.fromkeys(ROUTINES, 0)

_LIB: ctypes.CDLL | None = None


def available() -> bool:
    """False only under ``CUVITE_NO_NATIVE`` (set, and neither empty nor
    ``0``); the library itself is built at the first call."""
    return os.environ.get("CUVITE_NO_NATIVE", "") in ("", "0")


def call_counts() -> dict:
    return dict(_CALLS)


def zero_call_counts() -> None:
    for name in _CALLS:
        _CALLS[name] = 0


def _cpu_tag() -> bytes:
    """What ``-march=native`` depends on: the model and feature flags of
    the host CPU, so a library built on another host is never loaded."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines[:2])
    except OSError:
        return os.uname().machine.encode()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_tag())
    return _build.BUILD_DIR / f"{MODULE}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the library unless it is built.  Returns the seconds
    spent; raises with g++'s output if the compile fails."""
    with _build._LOCK:
        out = library_path()
        if out.exists():
            return 0.0
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(
                "g++ not found on PATH: the native host runtime cannot be "
                "built (CUVITE_NO_NATIVE=1 runs the numpy paths)")
        t0 = time.perf_counter()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(
                [gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=GXX_TIMEOUT_S)
            if proc.returncode:
                raise RuntimeError(
                    f"native host runtime build failed (g++ exit "
                    f"{proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
        dur = time.perf_counter() - t0
        _build._notify(MODULE, dur, "build")
        return dur


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    if _LIB is None:
        with _build._LOCK:
            if _LIB is None:
                build()
                t0 = time.perf_counter()
                lib = ctypes.CDLL(str(library_path()))
                _bind(lib)
                _build._notify(MODULE, time.perf_counter() - t0, "load")
                _LIB = lib
    return _LIB


def _lib(routine: str) -> ctypes.CDLL:
    """:func:`load`, counting one call of ``routine``."""
    lib = load()
    _CALLS[routine] += 1
    return lib


def openmp_threads() -> int:
    """``omp_get_max_threads()`` inside the library."""
    return int(load().cv_openmp_threads())


def _bind(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    f64 = ctypes.c_double
    cint = ctypes.c_int
    vp = ctypes.c_void_p
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    sig = {
        "cv_build_csr": ([i64, i64, p_i64, p_i64, p_f64, cint, p_i64,
                          p_i64, p_f64], i64),
        "cv_build_csr_unit": ([i64, i64, p_i32, p_i32, cint, p_i64, p_i32,
                               p_f32], i64),
        "cv_build_csr_w32": ([i64, i64, vp, vp, p_f64, cint, cint, p_i64,
                              p_i32, p_f32], i64),
        "cv_rmat": ([cint, i64, u64, f64, f64, f64, p_i64, p_i64], None),
        "cv_vite_header": ([ctypes.c_char_p, cint, ctypes.POINTER(i64),
                            ctypes.POINTER(i64)], cint),
        "cv_vite_edges": ([ctypes.c_char_p, cint, i64, i64, i64, p_i64,
                           p_f64], cint),
        "cv_vite_write": ([ctypes.c_char_p, cint, i64, i64, p_i64, p_i64,
                           p_f64], cint),
        "cv_balanced_parts": ([i64, p_i64, i64, p_i64], None),
        "cv_openmp_threads": ([], cint),
        "cv_plan_scan": ([i64, i64, i64, vp, vp, vp, cint, cint, p_f64,
                          ctypes.POINTER(cint)], cint),
        "cv_bucket_fill": ([i64, i64, vp, vp, cint, cint, p_i64, p_i64,
                            p_u8, cint, p_i64, p_i64, ctypes.POINTER(vp),
                            ctypes.POINTER(vp), ctypes.POINTER(vp), cint,
                            i64, vp, vp, vp], cint),
        "cv_coarsen": ([i64, i64, p_i64, vp, vp, cint, cint, p_i32, p_i64,
                        p_i32, p_f32, cint], i64),
        "cv_weighted_degrees": ([i64, p_i64, vp, cint, p_f64], None),
    }
    for fn, (argtypes, restype) in sig.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype


def _vp(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def build_csr(num_vertices: int, src: np.ndarray, dst: np.ndarray,
              weights: np.ndarray, symmetrize: bool = True):
    """Edge list -> coalesced CSR, identical to the numpy path of
    ``Graph.from_edges``.  Returns (offsets, tails [i64], weights [f64])."""
    lib = _lib("build_csr")
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    cap = max(2 * len(src) if symmetrize else len(src), 1)
    offsets = np.empty(num_vertices + 1, dtype=np.int64)
    tails = np.empty(cap, dtype=np.int64)
    wout = np.empty(cap, dtype=np.float64)
    n = lib.cv_build_csr(num_vertices, len(src), src, dst, w,
                         int(symmetrize), offsets, tails, wout)
    if n < 0:
        raise ValueError("edge endpoint out of range")
    return offsets, tails[:n].copy(), wout[:n].copy()


def build_csr_unit(num_vertices: int, src: np.ndarray, dst: np.ndarray,
                   symmetrize: bool = True):
    """Unit-weight edge list -> coalesced CSR with int32 ids and f32
    duplicate counts as weights; no f64 array exists at any point.  Equal
    to :func:`build_csr` with all-one weights after the f32 cast.
    Requires num_vertices <= 2^31."""
    lib = _lib("build_csr_unit")
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    cap = max(2 * len(src) if symmetrize else len(src), 1)
    offsets = np.empty(num_vertices + 1, dtype=np.int64)
    tails = np.empty(cap, dtype=np.int32)
    wout = np.empty(cap, dtype=np.float32)
    n = lib.cv_build_csr_unit(num_vertices, len(src), src, dst,
                              int(symmetrize), offsets, tails, wout)
    if n < 0:
        raise ValueError("edge endpoint out of range")
    return offsets, tails[:n].copy(), wout[:n].copy()


def build_csr_w(num_vertices: int, src: np.ndarray, dst: np.ndarray,
                w: np.ndarray, symmetrize: bool = True):
    """Weighted edge list -> coalesced CSR with int32 tails and f32
    weights, sorting an int32 edge-index payload and gathering the f64
    weights only at the coalesce (~24 B/slot against the generic path's
    32).  Equal to :func:`build_csr` after the f32 cast.  Requires
    num_vertices <= 2^31 and an expanded edge count below 2^31."""
    src = np.ascontiguousarray(src)
    dst = np.ascontiguousarray(dst)
    if src.dtype != dst.dtype or src.dtype not in (np.int32, np.int64):
        src = np.ascontiguousarray(src, dtype=np.int64)
        dst = np.ascontiguousarray(dst, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    cap = max(2 * len(src) if symmetrize else len(src), 1)
    # Check before allocating: near 2^31 edges the outputs are ~16 GB.
    if num_vertices > (1 << 31):
        raise ValueError(
            f"build_csr_w: num_vertices={num_vertices} exceeds the int32 "
            f"tail id space (2^31); use the generic build_csr path")
    if cap >= (1 << 31):
        raise ValueError(
            f"build_csr_w: expanded edge count {cap} exceeds the int32 "
            f"index payload (2^31); use the generic build_csr path")
    lib = _lib("build_csr_w")
    offsets = np.empty(num_vertices + 1, dtype=np.int64)
    tails = np.empty(cap, dtype=np.int32)
    wout = np.empty(cap, dtype=np.float32)
    n = lib.cv_build_csr_w32(num_vertices, len(src), _vp(src), _vp(dst),
                             w, int(src.dtype == np.int64),
                             int(symmetrize), offsets, tails, wout)
    if n < 0:
        raise ValueError("build_csr_w: edge endpoint out of range")
    return offsets, tails[:n].copy(), wout[:n].copy()


def rmat_edges(scale: int, ne: int, seed: int, a: float, b: float, c: float):
    """Counter-based R-MAT edge list, equal to
    ``io.generate.rmat_edges_numpy``."""
    lib = _lib("rmat_edges")
    src = np.empty(ne, dtype=np.int64)
    dst = np.empty(ne, dtype=np.int64)
    lib.cv_rmat(scale, ne, seed, a, b, c, src, dst)
    return src, dst


def vite_header(path: str, bits64: bool):
    """(nv, ne) of a Vite file."""
    lib = _lib("vite_header")
    nv = ctypes.c_int64()
    ne = ctypes.c_int64()
    rc = lib.cv_vite_header(os.fsencode(path), int(bits64),
                            ctypes.byref(nv), ctypes.byref(ne))
    if rc != 0:
        raise ValueError(f"{path}: cannot read Vite header (rc={rc})")
    return int(nv.value), int(ne.value)


def vite_edges(path: str, bits64: bool, nv: int, e0: int, e1: int):
    """Edge records [e0, e1) as (tails [i64], weights [f64]): one
    sequential read and a parallel deinterleave.  The caller reads and
    checks the offsets."""
    lib = _lib("vite_edges")
    tails = np.empty(max(e1 - e0, 1), dtype=np.int64)
    weights = np.empty(max(e1 - e0, 1), dtype=np.float64)
    rc = lib.cv_vite_edges(os.fsencode(path), int(bits64), nv, e0, e1,
                           tails, weights)
    if rc != 0:
        raise ValueError(f"{path}: edge read failed (rc={rc})")
    return tails[: e1 - e0], weights[: e1 - e0]


def vite_write(path: str, bits64: bool, offsets: np.ndarray,
               tails: np.ndarray, weights: np.ndarray) -> None:
    lib = _lib("vite_write")
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    tails = np.ascontiguousarray(tails, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    rc = lib.cv_vite_write(os.fsencode(path), int(bits64), len(offsets) - 1,
                           len(tails), offsets, tails, weights)
    if rc != 0:
        raise ValueError(f"{path}: write failed (rc={rc})")


def balanced_parts(offsets: np.ndarray, nparts: int) -> np.ndarray:
    """Edge-balanced contiguous vertex ranges, equal to
    ``core.distgraph.balanced_parts``."""
    lib = _lib("balanced_parts")
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    parts = np.empty(nparts + 1, dtype=np.int64)
    lib.cv_balanced_parts(len(offsets) - 1, offsets, nparts, parts)
    return parts


def _mem_available_bytes():
    """Effective available memory: the least of Linux MemAvailable and
    the headroom under every cgroup memory limit of this process (a
    container's limit binds long before the host's MemAvailable does).
    None when neither is readable."""
    avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                    break
    except (OSError, ValueError, IndexError):
        pass
    # cgroup v2 (memory.max), then v1 (memory.limit_in_bytes): limit less
    # current usage, skipped when unlimited.  In a nested cgroup without a
    # cgroup namespace the process's own limit lives under its path in
    # /proc/self/cgroup, so every ancestor of that path is probed.
    v2_paths = ["/sys/fs/cgroup/memory.max"]
    v1_paths = ["/sys/fs/cgroup/memory/memory.limit_in_bytes"]
    try:
        with open("/proc/self/cgroup") as f:
            for line in f:
                hid, ctrl, path = line.rstrip("\n").split(":", 2)
                path = path.strip("/")
                parts = path.split("/") if path else []
                sub = ["/".join(parts[:i])
                       for i in range(len(parts), 0, -1)]
                if hid == "0" and not ctrl:  # v2 unified
                    v2_paths[:0] = [
                        f"/sys/fs/cgroup/{s}/memory.max" for s in sub]
                elif "memory" in ctrl.split(","):
                    v1_paths[:0] = [
                        f"/sys/fs/cgroup/memory/{s}/memory.limit_in_bytes"
                        for s in sub]
    except (OSError, ValueError):
        pass
    probes = [(p, p[: -len("memory.max")] + "memory.current")
              for p in v2_paths]
    probes += [(p, p[: -len("memory.limit_in_bytes")]
                + "memory.usage_in_bytes") for p in v1_paths]
    for lim_path, cur_path in probes:
        try:
            with open(lim_path) as f:
                raw = f.read().strip()
            if raw == "max":
                continue
            limit = int(raw)
            if limit >= (1 << 60):  # v1 "unlimited" sentinel
                continue
            with open(cur_path) as f:
                used = int(f.read().strip())
            head = max(limit - used, 0)
            avail = head if avail is None else min(avail, head)
        except (OSError, ValueError):
            continue
    return avail


def coarsen_csr(offsets: np.ndarray, tails: np.ndarray, weights: np.ndarray,
                labels: np.ndarray, nc: int):
    """Fused relabel + coalesce of a CSR graph into its community graph.
    Returns (offsets [i64], tails [i32], weights [f32]); requires
    nc <= 2^31.  Equal to relabel + ``Graph.from_edges(symmetrize=False)``
    under the f32 weight policy.

    For nc > 2^22 (below it the dense path always wins) the LSD radix
    path's 32 B/slot transient is used unless it exceeds half the
    available memory, where the 12 B/slot counting-and-dense path is
    forced; both give the same bits.  ``CUVITE_COARSEN_FORCE=dense|radix``
    overrides the choice."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    tails = np.ascontiguousarray(tails)
    if tails.dtype not in (np.int32, np.int64):
        raise ValueError(f"coarsen_csr: tails must be int32 or int64, "
                         f"got {tails.dtype}")
    weights = np.ascontiguousarray(weights)
    if weights.dtype not in (np.float32, np.float64):
        weights = weights.astype(np.float32)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    force_dense = 0
    if nc > (1 << 22):
        knob = os.environ.get("CUVITE_COARSEN_FORCE", "")
        if knob == "dense":
            force_dense = 1
        elif knob != "radix":
            avail = _mem_available_bytes()
            if avail is not None and 32 * len(tails) > avail // 2:
                force_dense = 1
    lib = _lib("coarsen_csr")
    cap = max(len(tails), 1)
    offsets_out = np.empty(nc + 1, dtype=np.int64)
    tails_out = np.empty(cap, dtype=np.int32)
    wout = np.empty(cap, dtype=np.float32)
    n = lib.cv_coarsen(len(offsets) - 1, nc, offsets, _vp(tails),
                       _vp(weights), int(tails.dtype == np.int64),
                       int(weights.dtype == np.float64), labels,
                       offsets_out, tails_out, wout, force_dense)
    if n < 0:
        raise ValueError("cv_coarsen: label out of range or nc > 2^31")
    return offsets_out, tails_out[:n].copy(), wout[:n].copy()


def weighted_degrees(offsets: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Per-vertex f64 weighted degree off the CSR, summed in slab order:
    equal to ``np.bincount(sources, weights=w.astype(f64))``."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    weights = np.ascontiguousarray(weights)
    if weights.dtype not in (np.float32, np.float64):
        weights = weights.astype(np.float64)
    lib = _lib("weighted_degrees")
    out = np.empty(len(offsets) - 1, dtype=np.float64)
    lib.cv_weighted_degrees(len(offsets) - 1, offsets, _vp(weights),
                            int(weights.dtype == np.float64), out)
    return out


def plan_scan(src, dst, w, nv: int, base: int):
    """One pass over an edge slab: (self_loop [f64 nv], sorted, unit,
    tail_padding_ok).  src and dst share an int32 or int64 dtype; w is
    float32 or float64."""
    lib = _lib("plan_scan")
    self_loop = np.zeros(nv, dtype=np.float64)
    flags = ctypes.c_int(0)
    rc = lib.cv_plan_scan(
        len(src), nv, base, _vp(src), _vp(dst), _vp(w),
        int(src.dtype == np.int64), int(w.dtype == np.float64),
        self_loop, ctypes.byref(flags))
    if rc != 0:
        raise ValueError(f"cv_plan_scan failed (rc={rc})")
    f = flags.value
    return self_loop, bool(f & 1), bool(f & 2), bool(f & 4)


def bucket_fill(dst, w, nv: int, base: int, row_start, deg, cls,
                widths_kept, nb_pad, verts_list, dmat_list, wmat_list,
                unit: bool, heavy_pad: int, hsrc, hdst, hw) -> None:
    """Stream the CSR-ordered slab into the bucket matrices and the heavy
    triples, which the caller allocated with their padding filled in."""
    lib = _lib("bucket_fill")
    n = max(len(widths_kept), 1)

    def ptrs(arrs):
        return (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs],
                                     *([0] * (n - len(arrs))))

    rc = lib.cv_bucket_fill(
        nv, base, _vp(dst), _vp(w),
        int(dst.dtype == np.int64), int(w.dtype == np.float64),
        row_start, deg, cls, len(widths_kept),
        np.ascontiguousarray(widths_kept, dtype=np.int64),
        np.ascontiguousarray(nb_pad, dtype=np.int64),
        ptrs(verts_list), ptrs(dmat_list), ptrs(wmat_list),
        int(unit), heavy_pad, _vp(hsrc), _vp(hdst), _vp(hw))
    if rc != 0:
        raise ValueError(f"cv_bucket_fill failed (rc={rc})")
