"""Fixtures of the benchmark's own tests: the cells cut to a size the CPU
runs in a second, and the card's presence, decided inside a fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import spec  # noqa: E402

CELLS = ("graph500-s20.default", "lfr-n5000-b64.closed", "graph500-s20.fused")


def tiny(name: str) -> spec.Cell:
    """Cell ``name`` with its inputs cut to CPU size: Graph500 SCALE 10,
    or a pool of 8 LFR graphs of 300 vertices in batches of 4."""
    cell = spec.find_cell(name)
    if cell.config["generator"] == "graph500":
        cell.config["scale"] = 10
    else:
        cell.config.update(vertices=300, batch=4)
        cell.traffic.update(pool_graphs=8, check_graphs=3)
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
