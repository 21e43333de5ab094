"""Host-to-device upload of phase-static host arrays (port of
``cuvite_tpu/utils/upload.py:37-127``).

Every site that places a host plan, slab or table on the device goes
through :func:`to_device`:

- a tensor already on the device passes through, cast only when its dtype
  differs;
- on a CUDA device a numpy source is staged in pinned memory and copied
  with ``non_blocking=True`` on the device's current stream, so the host
  does not wait for the copy.  A caller that times the upload, or hands
  the host arrays to another stream, calls :func:`finish_uploads` before
  it reads the clock;
- on the CPU ``torch.from_numpy`` aliases the numpy buffer: no byte is
  copied when the dtype already matches.  The numpy array and its
  ``.base`` chain are then frozen (``writeable=False``), as the
  reference freezes them, so that a later host write through them raises
  instead of changing the tensor under the sweep.  Freezing does not stop
  a torch in-place write to the tensor: every call site passes arrays
  that no torch op writes in place, or a copy.  A sibling view taken
  before the call is not frozen (numpy cannot reach it).

``aligned_empty``/``aligned_zeros``/``aligned_full``/``aligned_copy``
allocate 64-byte aligned numpy buffers, as the reference's O(E) plan
builders do.  The reference needs the alignment for XLA:CPU's zero-copy
import; torch aliases any buffer, so here it only keeps the plan
matrices on cache-line boundaries for the native fill and the pinned
copy.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

ALIGN = 64

_NUMPY_OF = {torch.int32: np.int32, torch.int64: np.int64,
             torch.float32: np.float32, torch.float64: np.float64,
             torch.uint8: np.uint8, torch.int8: np.int8,
             torch.int16: np.int16, torch.bool: np.bool_}


def aligned_empty(shape, dtype) -> np.ndarray:
    """``np.empty`` whose data pointer is ALIGN-byte aligned."""
    shape = (shape,) if np.isscalar(shape) else tuple(shape)
    dt = np.dtype(dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    buf = np.empty(nbytes + ALIGN, dtype=np.uint8)
    off = (-buf.ctypes.data) % ALIGN
    return buf[off:off + nbytes].view(dt).reshape(shape)


def aligned_zeros(shape, dtype) -> np.ndarray:
    out = aligned_empty(shape, dtype)
    out[...] = 0
    return out


def aligned_full(shape, fill, dtype) -> np.ndarray:
    out = aligned_empty(shape, dtype)
    out[...] = fill
    return out


def aligned_copy(a: np.ndarray) -> np.ndarray:
    """A C-contiguous ALIGN-aligned copy of ``a``."""
    out = aligned_empty(a.shape, a.dtype)
    np.copyto(out, a)
    return out


def _same_device(t: torch.Tensor, dev: torch.device) -> bool:
    if t.device.type != dev.type:
        return False
    if dev.type != "cuda" or dev.index is None:
        return True
    return t.device.index == dev.index


def _from_numpy(x: np.ndarray) -> torch.Tensor:
    """``torch.from_numpy`` without torch's warning about a frozen array
    (an array uploaded before, which the tensor only reads)."""
    if x.flags.writeable:
        return torch.from_numpy(x)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(x)


def to_device(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` (a numpy array, a tensor or anything ``np.asarray`` takes) as
    a tensor of ``dtype`` on ``device`` (None: the card, raising without
    one), with the copies removed where legal (module note).  On the CPU
    the numpy source and its ``.base`` chain are frozen when the result
    aliases them."""
    from cuvite_tpu_torch.core.device import resolve_device

    if isinstance(x, torch.Tensor):
        if device is not None and not _same_device(
                x, torch.device(device)):
            return x.to(device, dtype)
        if dtype is not None and x.dtype != dtype:
            return x.to(dtype)
        return x
    dev = resolve_device(device)
    x = np.asarray(x)
    npdt = _NUMPY_OF.get(dtype) if dtype is not None else None
    if npdt is not None:
        x = x.astype(npdt, copy=False)
    if not x.flags.c_contiguous:
        x = np.ascontiguousarray(x)
    if dev.type == "cpu":
        t = _from_numpy(x)
        b = x
        while isinstance(b, np.ndarray):
            b.flags.writeable = False
            b = b.base
    elif x.size:
        t = _from_numpy(x).pin_memory().to(dev, non_blocking=True)
    else:
        t = _from_numpy(x).to(dev)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t


def finish_uploads(device) -> None:
    """Wait for the uploads :func:`to_device` enqueued on ``device``'s
    current stream (nothing to wait for on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
