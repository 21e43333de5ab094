"""Dataset provenance (port of ``cuvite_tpu/workloads/registry.py:340``,
``load_provenance`` only).

Every graph file the workloads write sits next to a
``<file>.provenance.json`` saying where it came from; the bench reads it
for ``--file``.  The dataset catalogue, ``fetch`` and ``convert`` are not
ported yet (``ROADMAP.md`` queue A item 9).
"""

from __future__ import annotations

import json
import os


def load_provenance(vite_path: str) -> dict | None:
    """The provenance record beside ``vite_path``, or None without one."""
    path = vite_path + ".provenance.json"
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)
