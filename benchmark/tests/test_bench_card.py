"""On the card: one short run of each cell through the command, as the
checker runs it (``python -m pytest -m cuda benchmark/tests``)."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import spec
from benchmark.tests.conftest import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", (0, 1))
def test_a_short_run_of_each_cell_is_correct(card, name, traced):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2**31 + 101), "--seconds", "3", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    cell = spec.find_cell(name)
    want = cell.per_layer if traced else cell.end_to_end
    if not traced:
        assert set(r["metrics"]) == {m["name"] for m in want}
    else:
        assert r["device"]["busy_s"] > 0 and r["breakdown"]["device_ops"]
        assert set(r["metrics"]) <= {m["name"] for m in want}
        for k, v in r["metrics"].items():
            if k.endswith("_pct") and "roofline" in k:
                assert 0 < v["value"] <= 100
