"""The port's compile and op audit (``cuvite_tpu_torch/analysis/op_audit.py``,
``tools/compile_audit.py``: B001-B003, J001-J003) and its mesh audit
(``analysis/meshcheck.py``, ``tools/mesh_audit.py``: M000-M003), the
counterparts of the reference's ``jaxpr_audit``/``compile_audit`` and
``meshcheck``/``mesh_audit``.

- both audits are green on the tree on the CPU; the compile audit sees
  one host read a sweep (``phase_loop``'s), none inside a sweep;
- the collective recorder is off unless asked, and records scopes;
- M002's labels on the audit graph (unit weights) equal the JAX
  reference's on the same graph;
- sabotage trips B001, B002, B003, J001, J002, J003, M000, M001, M002 and
  M003; a missing manifest entry or an unlisted category fails closed.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cuvite_tpu_torch.analysis import meshcheck as mc
from cuvite_tpu_torch.analysis import op_audit
from cuvite_tpu_torch.comm import collectives
from cuvite_tpu_torch.kernels import _build
from cuvite_tpu_torch.tools import compile_audit

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# The compile and op audit


def test_compile_audit_green_on_the_tree():
    results = compile_audit.run_audit(device="cpu")
    assert [r.entry for r in results] == list(compile_audit.ENTRY_NAMES)
    problems = [f.format() for r in results for f in r.findings]
    assert not problems, "\n".join(problems)
    for r in results:
        assert r.sweeps > 0, r.entry
        assert r.reads["sweep"] == 0, r.entry
        # phase_loop's one read a sweep (its .tolist(), counted on the CPU)
        assert r.reads["loop"] == r.sweeps, (r.entry, r.reads, r.sweeps)
        assert not r.observed and not r.recompiled, r.entry


def test_the_manifest_has_both_platforms():
    doc = json.load(open(compile_audit.MANIFEST))
    for plat in ("cpu", "cuda"):
        sec = doc["platforms"][plat]
        assert set(sec["entries"]) == set(compile_audit.ENTRY_NAMES), plat
    cuda = doc["platforms"]["cuda"]["entries"]
    assert any(m.startswith("form ") for e in cuda.values()
               for m in e["modules"])


def _tiny_step(seed=0):
    """One call of a sweep root (``louvain_step_local``) on a tiny slab."""
    from cuvite_tpu_torch.louvain.step import louvain_step_local

    g = np.random.default_rng(seed)
    ne, nv = 64, 16
    src = torch.from_numpy(np.sort(g.integers(0, nv, ne)).astype(np.int32))
    dst = torch.from_numpy(g.integers(0, nv, ne).astype(np.int32))
    w = torch.from_numpy(g.uniform(0.5, 2, ne).astype(np.float32))
    comm = torch.arange(nv, dtype=torch.int32)
    vdeg = torch.ones(nv)
    return louvain_step_local(src, dst, w, comm, vdeg, 1.0 / 128)


def _entry(allow64=("*",), **kw):
    m = {"modules": [], "content_independent": True, "max_compiles": 2,
         "reads_per_sweep": 1, "uploads_per_sweep": 0}
    m.update(kw)
    if allow64 == ("*",):
        res = op_audit.audit_entry("probe", lambda s: _tiny_step(s), m)
        m["allow64"] = res.allow64
    else:
        m["allow64"] = list(allow64)
    return m


def test_b001_missing_entry_and_unlisted_build_fail_closed():
    res = op_audit.audit_entry("ghost", lambda s: None, None)
    assert [f.rule for f in res.findings] == ["B001"]

    def builds(seed):
        _build._notify("new_kernel", 0.1, "build")

    res = op_audit.audit_entry("b", builds, _entry())
    rules = [f.rule for f in res.findings]
    assert "B001" in rules and res.observed == ["build new_kernel"]


def test_b002_content_reaching_a_build_key():
    def content_keyed(seed):
        if seed == 2:                 # the second run's weights
            _build._notify(f"row_argmax_w{seed}", 0.1, "build")

    res = op_audit.audit_entry("b2", content_keyed,
                               _entry(modules=["row_argmax"]))
    assert [f.rule for f in res.findings] == ["B002"]


def test_b003_over_budget():
    def many(seed):
        if seed == 1:
            for i in range(3):
                _build._notify(f"row_argmax_{i}", 0.1, "load")

    res = op_audit.audit_entry("b3", many, _entry(modules=["row_argmax"],
                                                  max_compiles=2))
    assert [f.rule for f in res.findings] == ["B003"]


def test_j001_an_unsanctioned_64bit_op_in_a_sweep():
    res = op_audit.audit_entry("j1", lambda s: _tiny_step(s),
                               _entry(allow64=()))
    rules = {f.rule for f in res.findings}
    assert rules == {"J001"}, res.findings
    assert any("sort:int64" in f.snippet for f in res.findings)
    clean = op_audit.audit_entry("j1", lambda s: _tiny_step(s), _entry())
    assert clean.ok, clean.findings


def test_j002_and_j003_inside_a_sweep(monkeypatch):
    from cuvite_tpu_torch.ops import segment

    real = segment.modularity_terms

    def reading(*a, **k):
        q = real(*a, **k)
        float(q.sum())                       # a host read in the sweep
        torch.tensor([1.0])                  # host data made in the sweep
        return q

    monkeypatch.setattr(segment, "modularity_terms", reading)
    res = op_audit.audit_entry("j2", lambda s: _tiny_step(s), _entry())
    assert {f.rule for f in res.findings} == {"J002", "J003"}, res.findings


def test_j002_over_the_loop_budget():
    from cuvite_tpu_torch.analysis.op_audit import tiny_graphs
    from cuvite_tpu_torch.louvain.driver import louvain_phases

    def run(seed):
        louvain_phases(tiny_graphs(b=1, content_seed=seed)[0],
                       engine="sort", max_phases=1, device="cpu")

    res = op_audit.audit_entry("loop", run, _entry(
        allow64=("*",), reads_per_sweep=0))
    assert "J002" in {f.rule for f in res.findings}


# ---------------------------------------------------------------------------
# The collective recorder


def test_the_collective_recorder_is_off_and_records_scopes():
    from cuvite_tpu_torch.comm.mesh import make_hybrid_mesh

    assert collectives._LOG is None
    mesh = make_hybrid_mesh(2, 2, devices=["cpu"] * 4)
    xs = [torch.ones(3, dtype=torch.int32) * i for i in range(4)]
    log = []
    prior = collectives.record_to(log)
    try:
        collectives.psum(xs, mesh)
        for view, pos in mesh.ici_views:
            collectives.all_gather([xs[p] for p in pos], view)
    finally:
        collectives.record_to(prior)
    assert collectives._LOG is None
    assert [(c["op"], c["scope"], c["size"]) for c in log] == [
        ("psum", "v", 4), ("all_gather", "ici", 2), ("all_gather", "ici", 2)]
    assert log[1]["out_bytes"] == 6 * 4 and log[1]["shapes"] == [(3,), (3,)]
    assert mc.shard0_sequence(log) == (("psum", "v", "int32"),
                                       ("all_gather", "ici", "int32"))


# ---------------------------------------------------------------------------
# The mesh audit


def test_mesh_audit_green_on_the_tree():
    findings, reports = mc.run_mesh_audit(device="cpu")
    assert not findings, [f.format() for f in findings]
    assert set(reports) == set(mc.ENTRIES)
    for name, by in reports.items():
        assert set(by) == {"8x1", "4x2", "2x4"}, name
    rep = reports["bucketed_twolevel"]["2x4"]
    assert rep.axes == {"dcn": 2, "ici": 4}
    assert ("all_gather", "ici", "int32") in rep.seq
    assert reports["bucketed_sparse"]["8x1"].categories["exchange"]
    assert not reports["batched_fused"]["8x1"].m003


def test_mesh_labels_equal_the_jax_references_on_unit_weights():
    """M002's graph with unit weights: the port's labels at every shape
    equal the JAX reference's one-device labels on the same CSR."""
    from cuvite_tpu.core.graph import Graph as JGraph
    from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.core.graph import Graph
    from cuvite_tpu_torch.louvain.driver import louvain_phases

    g = mc.audit_graph()
    unit = Graph.from_arrays(g.offsets, g.tails,
                             np.ones_like(g.weights))
    jg = JGraph.from_edges(unit.num_vertices,
                           np.repeat(np.arange(unit.num_vertices),
                                     np.diff(unit.offsets)), unit.tails)
    ref = jax_louvain(jg, engine="bucketed", max_phases=1)
    for s in (8, 4, 2):
        res = louvain_phases(unit, mesh=make_mesh(devices=["cpu"] * s),
                             engine="bucketed", exchange="sparse",
                             max_phases=1, device="cpu")
        np.testing.assert_array_equal(res.communities,
                                      np.asarray(ref.communities))


def _report(tag, seqs=None, labels=((np.zeros(3), 0.5),), cats=None,
            axes=None, n=2):
    rep = mc.ShapeReport(tag, n)
    rep.labels = list(labels)
    seqs = seqs or [()]
    rep.seq = seqs[0]
    rep.intrinsic = mc.check_sweeps("sab", tag, seqs)
    rep.categories = cats or {}
    rep.axes = axes or {"v": n}
    return rep


def test_m001_conditional_psum_and_shape_fork():
    """A step that issues a psum only when a data-dependent condition
    holds: its sweeps' sequences differ (the conditional-psum sabotage);
    and a sequence that changes with the mesh shape."""
    from cuvite_tpu_torch.comm.mesh import make_mesh

    def entry(shape, dev):
        mesh = make_mesh(devices=[dev] * shape[0])
        with mc.recorded_collectives() as (log, marks):
            for k in range(4):
                _tiny_step(k)                       # a sweep root
                xs = [torch.tensor(float(k))] * shape[0]
                total = collectives.psum(xs, mesh)[0]
                if float(total) > 4.0:              # data-dependent
                    collectives.psum(xs, mesh)
        seqs = mc.sweep_sequences(log, marks)
        return _report(f"{shape[0]}x{shape[1]}", seqs=seqs)

    findings, _ = mc.run_mesh_audit(shapes=((4, 1),), entries={"c": entry})
    assert [f.rule for f in findings] == ["M001"], findings
    assert "data-dependent" in findings[0].message

    def forked(shape, dev):
        seq = (("psum", "v", "float64"),) * (2 if shape[0] == 8 else 1)
        return _report(f"{shape[0]}x{shape[1]}", seqs=[seq])

    findings, _ = mc.run_mesh_audit(entries={"f": forked})
    assert [f.rule for f in findings] == ["M001"]
    assert "forked" in findings[0].message


def test_m002_labels_that_move_with_the_shape():
    def entry(shape, dev):
        return _report(f"{shape[0]}x{shape[1]}",
                       labels=[(np.arange(3) % shape[0], 0.5)])

    findings, _ = mc.run_mesh_audit(entries={"l": entry})
    assert {f.rule for f in findings} == {"M002"}
    with pytest.raises(AssertionError, match="M002"):
        mc.assert_mesh_neutral(lambda c: [(np.arange(3) % c, 0.1)], [2, 3])
    mc.assert_mesh_neutral(lambda c: [(np.arange(3), 0.1)], [2, 3])


def test_m003_replicated_table_widened_table_and_unlisted_category():
    big = 1 << 20

    def entry(shape, dev):
        n = shape[0] * shape[1]
        return _report(f"{shape[0]}x{shape[1]}", n=n, cats={
            # a per-vertex table every shard holds whole
            "tables": {"global": big, "per_device": big},
            # an ici table widened to the whole mesh
            "exchange_tables": {"global": big, "per_device": big},
            "mystery": {"global": big, "per_device": big // n}},
            axes={"dcn": shape[0], "ici": shape[1]})

    findings, _ = mc.run_mesh_audit(shapes=((4, 2),), entries={"r": entry})
    msgs = sorted((f.rule, f.snippet) for f in findings)
    assert msgs == [("M003", "exchange_tables"), ("M003", "mystery"),
                    ("M003", "tables")], msgs


def test_m000_crash_and_unreadable_budget(tmp_path):
    def crash(shape, dev):
        raise RuntimeError("boom")

    findings, _ = mc.run_mesh_audit(shapes=((2, 1),),
                                    entries={"x": crash},
                                    budget_path=str(tmp_path / "none"))
    assert sorted(f.path for f in findings) == ["<mesh:manifest>",
                                                "<mesh:x>"]
    assert {f.rule for f in findings} == {"M000"}


def test_the_floor_is_the_ports_own():
    """The sharded law's floor comes from the port's own bytes: every
    graded category of the solo entries fits its law with no floor at
    all, and the floor is below the smallest of them (it admits the
    per-shard scalars only)."""
    budget = mc.load_budget(mc.DEFAULT_BUDGET)["categories"]
    _f, reports = mc.run_mesh_audit(
        ["bucketed_replicated", "bucketed_sparse", "bucketed_twolevel"],
        device="cpu")
    smallest = None
    for by in reports.values():
        for rep in by.values():
            for cat, row in rep.categories.items():
                if not row["global"]:
                    continue
                div = rep.devices if budget[cat]["law"] == "sharded" \
                    else rep.axes.get("dcn", 1)
                assert row["per_device"] <= row["global"] / div \
                    * mc.SHARDED_TOL, (rep.tag, cat, row)
                smallest = min(smallest or row["global"], row["global"])
    assert mc.SHARDED_FLOOR_BYTES < smallest, smallest


def test_mesh_audit_cli_smoke_subprocess(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "cuvite_tpu_torch.tools.mesh_audit",
         "--smoke", "--device", "cpu", "--out", str(tmp_path / "m.json")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads((tmp_path / "m.json").read_text())
    assert doc["ok"] and doc["shapes"] == ["4x2", "2x4"]


def test_compile_audit_main_json(capsys):
    assert compile_audit.main(["--device", "cpu", "--entries",
                               "solo_fused_sort", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    e = doc["entries"][0]
    assert doc["ok"] and e["entry"] == "solo_fused_sort"
    assert e["reads"]["loop"] == e["sweeps"]
