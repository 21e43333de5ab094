"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ctypes.  The
libraries go to ``build/cuvite_tpu_torch/`` at the root of the checkout,
named by a hash of every source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  Nothing is compiled at import:
the first launch builds what it needs, and :func:`build` compiles every
missing library at once, one ``nvcc`` process per source.

``-fmad=false`` forbids fused multiply-adds: the gain must round each
product and difference on its own, as the reference does.

Subscribers in :data:`HOOKS` see every nvcc run and every first load of
a library in the process (``obs/compile_watch.py`` turns them into the
flight recorder's ``compile`` events and the bench's guard).  The native
host runtime (``cuvite_tpu_torch/native``) builds with g++ into the same
directory and reports through the same hooks.

CUDA loads each kernel body at its first launch (lazy module loading),
which no hook sees.  So every wrapper records the form it launched --
:func:`note_form`: the kernel, the ``__global__`` body or set of bodies
that the launch runs, and the card -- and :data:`FORMS` counts each form's
launches in the process; the bench guard refuses a timed window that
launches a form for the first time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuvite_tpu_torch"
SOURCES = ("row_argmax", "heavy_bincount", "seg_coalesce")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

# Loaded library handles, by source name: the package's only global state.
_LIBS: dict[str, ctypes.CDLL] = {}
# Serializes builds and loads: the serving daemon's threads may all reach
# a kernel first, and each library must be built and loaded once.
_LOCK = threading.RLock()
# nvcc's output (ptxas register and shared-memory report) per built source.
BUILD_LOG: dict[str, str] = {}
# Callables given {"module": source name, "dur_s": seconds, "kind":
# "build" | "load"} for every nvcc run and every first library load.  They
# are called under _LOCK, so they must not call back into this module.
HOOKS: list = []
# Launches of each kernel form in the process: {(kernel, body, card): n}.
FORMS: dict = {}


def _notify(module: str, dur_s: float, kind: str) -> None:
    for fn in list(HOOKS):
        fn({"module": module, "dur_s": dur_s, "kind": kind})


def note_form(kernel: str, body: str, device) -> None:
    """Count one launch of ``kernel``'s form ``body`` on ``device``."""
    key = (kernel, body, str(device))
    FORMS[key] = FORMS.get(key, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda): the CUDA kernels cannot be "
                           "built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build(names=SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, all nvcc
    processes at once.  Returns the seconds spent; raises with nvcc's
    output if any source fails."""
    with _LOCK:
        return _build(names)


def _build(names) -> float:
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in names
            if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for name, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            BUILD_LOG[name] = log
            if proc.returncode:
                errors.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                              f"{log}")
            else:
                os.replace(tmp, out)
                _notify(name, time.perf_counter() - t0, "build")
    finally:
        for _name, _out, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str, signature) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.
    ``signature`` maps each C function to ``(argtypes, restype)``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(library_path(name)))
            _notify(name, time.perf_counter() - t0, "load")
            for fn, (argtypes, restype) in signature.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
