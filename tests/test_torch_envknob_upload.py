"""cuvite_tpu_torch's ``utils/envknob.env_int`` and ``utils/upload`` held
against the JAX package's on the CPU.

``env_int`` gives the reference's value and the reference's warning count
on the same raw values; the aligned allocators are 64-byte aligned;
``to_device`` on the CPU aliases its numpy source and freezes it and its
base chain, passes a tensor through and casts a dtype.
"""

import warnings

import numpy as np
import pytest
import torch

from cuvite_tpu.utils.envknob import env_int as ref_env_int
from cuvite_tpu_torch.utils import upload
from cuvite_tpu_torch.utils.envknob import env_int

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KNOB = "CUVITE_TEST_ENV_INT_KNOB"

RAW = [None, "", "0x10", "0b11", "17", "abc", "3.5", "0", "-4", "100",
       "101", "0x65", " 7"]


def _read(fn, raw, monkeypatch, **kw):
    if raw is None:
        monkeypatch.delenv(KNOB, raising=False)
    else:
        monkeypatch.setenv(KNOB, raw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        v = fn(KNOB, 42, **kw)
    return v, len(caught)


@pytest.mark.parametrize("raw", RAW)
@pytest.mark.parametrize("bounds", [dict(), dict(maximum=100),
                                    dict(minimum=0, maximum=100)],
                         ids=["default", "max100", "min0max100"])
def test_env_int_matches_reference(raw, bounds, monkeypatch):
    mine = _read(env_int, raw, monkeypatch, **bounds)
    ref = _read(ref_env_int, raw, monkeypatch, **bounds)
    assert mine == ref


def test_env_int_warning_names_the_knob(monkeypatch):
    monkeypatch.setenv(KNOB, "many")
    with pytest.warns(UserWarning, match=KNOB):
        assert env_int(KNOB, 5) == 5


@pytest.mark.parametrize("shape", [1, 7, (3, 5), (64, 33), (0,)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.uint8])
def test_aligned_allocators(shape, dtype):
    fill = 3
    for a in (upload.aligned_empty(shape, dtype),
              upload.aligned_zeros(shape, dtype),
              upload.aligned_full(shape, fill, dtype)):
        # An empty array has no data to align.
        assert a.size == 0 or a.ctypes.data % upload.ALIGN == 0
        assert a.flags.c_contiguous and a.dtype == np.dtype(dtype)
        assert a.shape == ((shape,) if np.isscalar(shape) else shape)
    assert not upload.aligned_zeros(shape, dtype).any()
    assert (upload.aligned_full(shape, fill, dtype) == fill).all()
    src = np.arange(np.prod(shape), dtype=dtype).reshape(shape)
    cp = upload.aligned_copy(src)
    assert cp.size == 0 or cp.ctypes.data % upload.ALIGN == 0
    assert np.array_equal(cp, src)


def test_to_device_aliases_and_freezes_on_cpu():
    a = upload.aligned_zeros((4, 8), np.int32)
    view = a[1:3]
    t = upload.to_device(view, torch.int32, "cpu")
    assert t.device.type == "cpu" and t.dtype == torch.int32
    assert t.data_ptr() == view.ctypes.data   # no copy
    # The source and its base chain (the aligned buffer beneath) are
    # frozen; ``a``, a sibling view taken before the call, numpy cannot
    # reach (the module note says so).
    with pytest.raises(ValueError, match="read-only"):
        view[0, 0] = 1
    b = view.base
    while isinstance(b, np.ndarray):
        with pytest.raises(ValueError, match="read-only"):
            b.flat[0] = 1
        b = b.base
    assert a.flags.writeable
    # A frozen source uploads again without a copy or a warning.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t2 = upload.to_device(view, torch.int32, "cpu")
    assert t2.data_ptr() == t.data_ptr()


def test_to_device_casts_copies_and_passes_tensors_through():
    src = np.arange(10, dtype=np.int64)
    t = upload.to_device(src, torch.int32, "cpu")
    assert t.dtype == torch.int32 and t.tolist() == list(range(10))
    assert src.flags.writeable   # the cast made a copy; the source is free
    f = upload.to_device(np.arange(6, dtype=np.float64)[::2], None, "cpu")
    assert f.dtype == torch.float64 and f.tolist() == [0.0, 2.0, 4.0]
    x = torch.arange(5, dtype=torch.int32)
    assert upload.to_device(x, device="cpu") is x
    assert upload.to_device(x, torch.int32, "cpu") is x
    y = upload.to_device(x, torch.int64, "cpu")
    assert y.dtype == torch.int64 and y.tolist() == x.tolist()
    upload.finish_uploads("cpu")   # nothing in flight on the CPU


def test_to_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        upload.to_device(np.zeros(3, np.int32))
