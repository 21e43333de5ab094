"""The port's width tiers (``cuvite_tpu_torch/analysis/widthcheck.py``,
R026-R028; ``widthaudit.py`` and ``tools/width_audit.py``, W001-W003),
held against the reference's (``cuvite_tpu/analysis/widthcheck.py``,
``widthaudit.py``).

- ``sym_eval``/``sym_render`` give the reference's values and text on the
  same expression trees; ``MAX_WORKLOAD`` equals the reference's and the
  port's ``registry.max_workload()``;
- R026-R028 fire on known-bad fixtures in torch idiom (int32 arange past
  2^31, an untied int32 pack, an int32 cumsum or an int32 cast of one
  over an edge-slab extent) and stay silent on their fixed forms and on
  the port's tree against its baseline; both packing sites of
  ``ops/segment.py`` read as tied to their guards;
- the W002 laws both packages declare are equal; the audit is green on
  the tree, and sabotage trips W001, W002 and W003.
"""

import json
import os
import subprocess
import sys

import pytest

from cuvite_tpu.analysis import widthcheck as ref_wc
from cuvite_tpu_torch.analysis import widthaudit as wa
from cuvite_tpu_torch.analysis import widthcheck as wc
from cuvite_tpu_torch.analysis.callgraph import run_project_sources, \
    summarize
from cuvite_tpu_torch.analysis.engine import SourceFile

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "cuvite_tpu_torch/"
WIDTH = ("R026", "R027", "R028")


def _width(src: str, rel: str = PKG + "ops/fake.py") -> list:
    return [(f.rule, f.line) for f in run_project_sources({rel: src})
            if f.rule in WIDTH]


# ---------------------------------------------------------------------------
# The interval model against the reference's


EXPRS = [
    ["n", 7],
    ["s", "ne_pad"],
    ["+", ["s", "nv_pad"], ["n", -1]],
    ["*", ["s", "ne_pad"], ["s", "nv_pad"]],
    ["<<", ["s", "nv_pad"], ["s", "kbits"]],
    [">>", ["*", ["s", "nv_pad"], ["s", "nv_pad"]], ["s", "kbits"]],
    ["min", ["s", "nv_pad"], ["+", ["<<", ["n", 1], ["n", 31]],
                              ["n", -1]]],
    ["max", ["s", "ne_pad"], ["s", "two_m"]],
    ["bits", ["+", ["s", "nv_pad"], ["n", -1]]],
    ["+", ["<<", ["s", "nv_pad"], ["bits", ["s", "nv_pad"]]],
     ["s", "nv_pad"]],
    ["*", ["s", "B"], ["s", "unknown"]],
    None,
]


@pytest.mark.parametrize("expr", EXPRS, ids=[str(i) for i in
                                             range(len(EXPRS))])
def test_sym_eval_and_render_equal_the_reference(expr):
    env = dict(wc.MAX_WORKLOAD)
    assert wc.sym_eval(expr, env) == ref_wc.sym_eval(expr, env)
    assert wc.sym_render(expr) == ref_wc.sym_render(expr)
    assert wc.sym_symbols(expr) == ref_wc.sym_symbols(expr)


def test_max_workload_is_the_registrys_and_the_references():
    from cuvite_tpu_torch.workloads import registry

    assert wc.MAX_WORKLOAD == registry.max_workload()
    assert wc.MAX_WORKLOAD == ref_wc.MAX_WORKLOAD


# ---------------------------------------------------------------------------
# R026-R028 on torch fixtures


BAD = [
    ("R026", """
import torch

def f(ne_pad, nv_pad):
    return torch.arange(ne_pad * nv_pad, dtype=torch.int32)
"""),
    ("R026", """
import torch

def f(src, nv_pad):
    return (src.to(torch.int32) * nv_pad).int()
"""),
    ("R027", """
import torch

def f(src, ckey, kbits):
    return (src.to(torch.int32) << kbits) | ckey.to(torch.int32)
"""),
    ("R027", """
import torch

def f(src, ckey):
    return (src.long() << 40) | ckey.long()
"""),
    ("R028", """
import torch

def f(src):
    return torch.cumsum(src != 0, 0).int()
"""),
    ("R028", """
import torch

def f(starts):
    return torch.cumsum(starts, 0, dtype=torch.int32)
"""),
    ("R028", """
import torch

def f(w):
    return (w > 0).sum().to(torch.int32)
"""),
]

GOOD = [
    # int64 accumulation: torch widens cumsum/sum of an int tensor
    """
import torch

def f(src):
    return torch.cumsum(src != 0, 0) - 1
""",
    """
import torch

def f(w):
    return (w > 0).sum()
""",
    # the SLAB_NE_MAX raise-guard refines ne_pad
    """
import torch
SLAB_NE_MAX = 1 << 30

def f(starts, ne_pad):
    if ne_pad > SLAB_NE_MAX:
        raise ValueError("slab")
    return torch.cumsum(starts, 0, dtype=torch.int32)
""",
    # ... and so does a helper opening with that guard on its parameter
    """
import torch
SLAB_NE_MAX = 1 << 30

def _check(ne, what):
    if ne > SLAB_NE_MAX:
        raise ValueError(what)

def f(w_s, starts):
    _check(w_s.shape[0], "f")
    return torch.cumsum(starts, 0, dtype=torch.int32)
""",
    # a pack tied to its routing guard (the msd shape)
    """
import torch

def f(src, ckey, w, nv_pad):
    kbits = max(nv_pad - 1, 1).bit_length()
    sbits = max(nv_pad, 1).bit_length()
    if kbits + sbits <= 31:
        return g(src, ckey, w)
    low = (src & ((1 << (31 - kbits)) - 1)).to(torch.int32)
    return (low << kbits) | ckey.to(torch.int32)
""",
    # an int64 pack that provably fits 63 bits
    """
import torch

def f(src, ckey, kbits):
    kbits = 28
    return (src.long() << kbits) | ckey.long()
""",
    # the width-ok inventory
    """
import torch

def f(src, ckey, kbits):
    return (src.to(torch.int32) << kbits) | ckey.to(torch.int32)  # graftlint: width-ok=ids below 2^15 here
""",
]


@pytest.mark.parametrize("rule,src", BAD, ids=[f"{r}-{i}" for i, (r, _)
                                               in enumerate(BAD)])
def test_width_rules_fire_on_torch_fixtures(rule, src):
    got = _width(src)
    assert [r for r, _ in got] == [rule], got


@pytest.mark.parametrize("src", GOOD, ids=[str(i) for i in range(len(GOOD))])
def test_width_rules_silent_on_fixed_forms(src):
    assert _width(src) == []


def test_width_rules_skip_files_off_the_device_path():
    assert _width(BAD[0][1], rel=PKG + "serve/fake.py") == []


def test_segment_packing_sites_are_tied_to_their_guards():
    rel = PKG + "ops/segment.py"
    with open(os.path.join(REPO, rel)) as fh:
        summ = summarize(SourceFile(fh.read(), path=rel, rel=rel))
    packs = {s["fn"]: s for s in summ["width"]["sites"]
             if s["kind"] == "pack"}
    assert packs["sort_edges_by_vertex_comm"]["tied"]
    assert packs["sort_edges_by_vertex_comm"]["wide"]
    assert packs["sort_edges_msd"]["tied"]
    assert packs["sort_edges_msd"]["int32"]


def test_the_ports_tree_is_silent_against_its_baseline():
    from cuvite_tpu_torch.analysis import apply_baseline, load_baseline, \
        run_paths

    findings = [f for f in run_paths([os.path.join(REPO, "cuvite_tpu_torch")])
                if f.rule in WIDTH]
    new, _old = apply_baseline(findings, load_baseline(os.path.join(
        REPO, "cuvite_tpu_torch", "analysis", "baseline.json")))
    assert not new, [f.format() for f in new]


def test_width_inventory_lists_the_justified_sites():
    from cuvite_tpu_torch.tools.width_audit import _inventory

    inv = _inventory()
    where = {(e["rel"].rsplit("/", 1)[-1], e["kind"]) for e in inv}
    assert ("batch.py", "arith") in where
    assert ("seg_coalesce.py", "pack") in where
    assert ("bucketed.py", "pack") in where
    assert all(e["reason"] for e in inv)


def test_fold_slab_refuses_a_batch_past_int32_ids():
    import torch

    from cuvite_tpu_torch.core.batch import FOLD_ID_MAX, fold_slab

    src = torch.zeros((2, 4), dtype=torch.int32)
    w = torch.zeros((2, 4))
    fold_slab(src, src, w, nv_pad=FOLD_ID_MAX // 2)
    with pytest.raises(ValueError, match="FOLD_ID_MAX"):
        fold_slab(src, src, w, nv_pad=FOLD_ID_MAX // 2 + 1)


# ---------------------------------------------------------------------------
# The width audit


def test_shared_laws_equal_the_references():
    from cuvite_tpu.analysis.widthaudit import code_laws as ref_laws

    ref, port = ref_laws(), wa.code_laws()
    for key in ("slab_ne_max", "coalesce_max_nv", "flat_nv_max",
                "index_bits", "pack_bits"):
        assert port[key] == ref[key], key
    assert "ds32_min" in ref and "ds32_min" not in port
    assert "ds32_min" in wa.DROPPED_LAWS
    assert wa.audit_workloads() == json.load(open(os.path.join(
        REPO, "tools", "width_budget.json")))["workloads"]


def test_width_audit_green_on_the_tree():
    findings, reports = wa.run_width_audit(device="cpu")
    assert not findings, [f.format() for f in findings]
    rm = reports["rmat_s28"]
    assert rm["solo_sort_step"]["mode"] == "meta"
    assert rm["solo_sort_step"]["ne"] == 1 << 30
    assert rm["solo_fused_phase"]["mode"] == "reduced"
    assert rm["solo_fused_phase"]["scale"] == 1 << 16
    assert rm["batched_execute"]["mode"] == "fixed"
    assert set(rm) == set(wa.ENTRIES)
    assert reports["spy"]["delta_bytes"] == 0
    p = reports["probes"]
    assert p["pack31_one_past"] == [("int32", 1, 1024), ("int32", 1, 1024)]
    assert p["slab_one_past"] == p["flat_one_past"] == "raised"


def _sabotaged(monkeypatch, name, run, mode="meta"):
    monkeypatch.setitem(wa.ENTRIES, name, (mode, run, False, None))
    return wa.run_width_audit([name], workloads=["rmat_s28"],
                              probes=False, device="cpu")


def test_w001_convicts_an_int32_index_past_its_extent(monkeypatch):
    import torch

    def meta_run(nv, ne, device):
        torch.cumsum(torch.empty(ne * 4, dtype=torch.bool, device="meta"),
                     0, dtype=torch.int32)

    findings, _ = _sabotaged(monkeypatch, "bad_cumsum", meta_run)
    assert [f.rule for f in findings] == ["W001"], findings

    def reduced_run(nv, ne, device):
        torch.arange(ne * 2 ** 3, dtype=torch.int32, device=device)

    findings, rep = _sabotaged(monkeypatch, "bad_arange", reduced_run,
                               mode="reduced")
    assert [f.rule for f in findings] == ["W001"], findings
    assert "projected" in findings[0].message


def test_w002_convicts_one_int32_key_past_the_pack(monkeypatch):
    """A slab entry at a shape past the 31-bit pack that still sorts the
    slab by one int32 key: the fallback was not selected."""
    import torch

    def one_key(nv, ne, device):
        torch.sort(torch.empty(ne, dtype=torch.int32, device="meta"))

    monkeypatch.setitem(wa.ENTRIES, "one_key",
                        ("meta", one_key, True, None))
    findings, _ = wa.run_width_audit(["one_key"], workloads=["rmat_s28"],
                                     probes=False, device="cpu")
    assert [f.rule for f in findings] == ["W002"], findings


def test_w002_convicts_a_removed_raise_guard(monkeypatch):
    from cuvite_tpu_torch.ops import segment

    monkeypatch.setattr(segment, "_check_slab", lambda ne, what: None)
    findings, facts = wa.boundary_probes(wa.code_laws())
    assert any(f.rule == "W002" and "slab_ne_max" in f.path
               for f in findings), findings


def test_w002_convicts_a_lifted_dense_ceiling(monkeypatch):
    from cuvite_tpu_torch.kernels import seg_coalesce

    monkeypatch.setattr(seg_coalesce, "_max_nv", lambda: 1 << 20)
    findings, _ = wa.boundary_probes(wa.code_laws())
    assert {f.path for f in findings} == {"<width:coalesce_max_nv>"}


def test_w003_fails_closed(monkeypatch, tmp_path):
    def crash(nv, ne, device):
        raise RuntimeError("boom")

    findings, _ = _sabotaged(monkeypatch, "crash", crash)
    assert [f.rule for f in findings] == ["W003"]
    doc = json.loads(open(wa.DEFAULT_BUDGET).read())
    doc["laws"]["slab_ne_max"] = 1 << 31
    bad = tmp_path / "b.json"
    bad.write_text(json.dumps(doc))
    findings, _ = wa.run_width_audit(["solo_sort_step"],
                                     workloads=["rmat_s28"], probes=False,
                                     budget_path=str(bad))
    assert any(f.rule == "W003" and "slab_ne_max" in f.message
               for f in findings)
    findings, _ = wa.run_width_audit(["solo_sort_step"],
                                     workloads=["rmat_s28"], probes=False,
                                     budget_path=str(tmp_path / "none"))
    assert [f.rule for f in findings] == ["W003"]

    def concretize(nv, ne, device):
        import torch

        torch.zeros(4)          # a tensor off meta inside a meta entry

    findings, _ = _sabotaged(monkeypatch, "concrete", concretize)
    assert [f.rule for f in findings] == ["W003"]


def test_width_audit_main_smoke_and_budget(tmp_path, capsys):
    from cuvite_tpu_torch.tools import width_audit

    out = tmp_path / "r.json"
    assert width_audit.main(["--smoke", "--device", "cpu", "--out",
                             str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["device"] == "cpu"
    budget = tmp_path / "w.json"
    assert width_audit.main(["--write-budget", "--budget",
                             str(budget)]) == 0
    assert json.loads(budget.read_text()) == json.load(open(wa.DEFAULT_BUDGET))


def test_width_audit_cli_inventory_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "cuvite_tpu_torch.tools.width_audit",
         "--inventory"], capture_output=True, text=True, cwd=REPO,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "justified site(s)" in out.stdout
