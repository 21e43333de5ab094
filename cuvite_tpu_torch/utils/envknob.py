"""The integer environment knobs' one parser (port of
``cuvite_tpu/utils/envknob.py:38-57``).

``env_int`` reads ``int(raw, 0)`` (0x/0b prefixes accepted) and, when the
value is malformed or out of range, warns and keeps the default: a
mistyped knob must never quietly run the default while the operator
believes it changed.  The knobs that read it: ``CUVITE_SEG_COALESCE_MAX_NV``
and ``CUVITE_HASH_SLOTS`` (``kernels/seg_coalesce.py``) and
``CUVITE_REBIN_MAX_ELEMS`` (``coarsen/rebin.py``).

Not ported: the reference's ``request_host_devices``, which sets an XLA
flag for virtual CPU devices; the port makes CPU meshes from device lists
(``comm/mesh.make_mesh(devices=...)``).  ``comm/multihost.py``'s
``_env_int`` has another contract (None when unset, no default) and stays
its own.
"""

from __future__ import annotations

import os
import warnings


def env_int(name: str, default: int, *, minimum: int = 1,
            maximum: int | None = None) -> int:
    """``int(os.environ[name], 0)`` within [minimum, maximum], or
    ``default`` when unset or empty, and with a warning when malformed or
    out of range."""
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        v = int(raw, 0)
    except ValueError:
        v = None
    if v is None or v < minimum or (maximum is not None and v > maximum):
        bound = f" <= {maximum}" if maximum is not None else ""
        warnings.warn(
            f"malformed {name}={raw!r} (want an integer >= {minimum}"
            f"{bound}); using the default {default}", stacklevel=2)
        return default
    return v
