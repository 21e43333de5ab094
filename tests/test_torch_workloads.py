"""cuvite_tpu_torch's workload modules held against the JAX package's: the
synthesizer's graphs and files byte for byte, the ground-truth comparison
to 1e-12, the golden registry and its envelope checks, and the port's
``louvain_phases`` (bucketed and fused) inside the reference's
``powerlaw-test/default`` envelope, F-score included."""

import filecmp
import os

import numpy as np
import pytest

from cuvite_tpu.evaluate import compare as jcompare
from cuvite_tpu.workloads import golden as jgolden
from cuvite_tpu.workloads import synth as jsynth
from cuvite_tpu_torch import louvain_phases
from cuvite_tpu_torch.evaluate import compare as pcompare
from cuvite_tpu_torch.io.vite import read_vite
from cuvite_tpu_torch.workloads import golden as pgolden
from cuvite_tpu_torch.workloads import synth as psynth

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_workloads.py's golden workload.
SYNTH_EDGES = 40_000
SYNTH_SEED = 7


@pytest.mark.parametrize("edges,seed,bits64", [
    (SYNTH_EDGES, SYNTH_SEED, False), (5000, 3, True)])
def test_synth_files_byte_identical(tmp_path, edges, seed, bits64):
    pj = jsynth.synthesize(str(tmp_path / "j.vite"), edges, seed=seed,
                           bits64=bits64)
    pp = psynth.synthesize(str(tmp_path / "p.vite"), edges, seed=seed,
                           bits64=bits64)
    assert filecmp.cmp(tmp_path / "j.vite", tmp_path / "p.vite",
                       shallow=False)
    assert filecmp.cmp(pj["truth_path"], pp["truth_path"], shallow=False)
    assert pj["sha256"] == pp["sha256"]
    for k in ("spec", "num_communities_planted", "degree_draw_total",
              "source"):
        assert pj[k] == pp[k]
    rj, rp = dict(pj["result"]), dict(pp["result"])
    rj.pop("out_path"), rp.pop("out_path")
    assert rj == rp
    assert os.path.exists(str(tmp_path / "p.vite") + ".provenance.json")


def test_synthesize_graph_and_many_identical(tmp_path):
    for edges in (4096, 65536):
        for k in (0, 1):
            assert psynth.many_seed(1, k) == jsynth.many_seed(1, k)
            gj = jsynth.synthesize_graph(edges, seed=jsynth.many_seed(1, k))
            gp = psynth.synthesize_graph(edges, seed=psynth.many_seed(1, k))
            assert np.array_equal(gj.offsets, gp.offsets)
            assert np.array_equal(gj.tails, gp.tails)
            assert np.array_equal(gj.weights, gp.weights)
    sj = jsynth.synthesize_many(str(tmp_path / "j"), 2, 3000, seed=4)
    sp = psynth.synthesize_many(str(tmp_path / "p"), 2, 3000, seed=4)
    for a, b in zip(sj["graphs"], sp["graphs"]):
        assert a["seed"] == b["seed"] and a["sha256"] == b["sha256"]
        assert filecmp.cmp(a["path"], b["path"], shallow=False)
    with pytest.raises(ValueError):
        psynth.synthesize_graph(2)
    with pytest.raises(ValueError, match="profile"):
        psynth.synthesize_graph(4096, profile="lfr")


def test_compare_communities_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    for n, k1, k2 in ((1, 1, 1), (500, 7, 30), (20_000, 400, 90)):
        truth = rng.integers(0, k1, n)
        out = rng.integers(0, k2, n)
        a = pcompare.compare_communities(truth, out)
        b = jcompare.compare_communities(truth, out)
        for f in ("n_vertices", "n_truth_comms", "n_output_comms",
                  "true_positive", "false_negative", "false_positive"):
            assert getattr(a, f) == getattr(b, f)
        for f in ("precision", "recall", "f_score", "gini_truth",
                  "gini_output"):
            assert abs(getattr(a, f) - getattr(b, f)) <= 1e-12
        assert a.report() == b.report()
    sizes = rng.integers(1, 50, 40)
    assert abs(pcompare.gini_coefficient(sizes)
               - jcompare.gini_coefficient(sizes)) <= 1e-12
    pcompare.write_communities(str(tmp_path / "p.txt"), out)
    jcompare.write_communities(str(tmp_path / "j.txt"), out)
    assert filecmp.cmp(tmp_path / "p.txt", tmp_path / "j.txt",
                       shallow=False)
    lines = np.stack([np.arange(1, n + 1), truth + 1], axis=1)
    np.savetxt(tmp_path / "t.truth", lines, fmt="%d")
    truth_path = str(tmp_path / "t.truth")
    assert np.array_equal(pcompare.load_ground_truth(truth_path),
                          jcompare.load_ground_truth(truth_path))


def test_golden_registry_is_the_references():
    assert filecmp.cmp(pgolden.DEFAULT_GOLDEN_PATH,
                       jgolden.DEFAULT_GOLDEN_PATH, shallow=False)
    assert pgolden.load_golden() == jgolden.load_golden()
    assert pgolden.golden_key("a", "b") == jgolden.golden_key("a", "b")


def test_golden_envelope_catches_regression(tmp_path):
    """tests/test_workloads.py's regressions, caught the same way."""
    measured = {"modularity": 0.69, "phases": 2, "communities": 23,
                "f_score": 0.92}
    entry = pgolden.envelope_from_measurement(measured)
    assert entry == jgolden.envelope_from_measurement(measured)
    assert pgolden.check_envelope(entry, measured) == []
    for bad, word in ((dict(measured, modularity=0.60), "Q="),
                      (dict(measured, communities=230), "communities"),
                      (dict(measured, f_score=0.5), "f_score"),
                      (dict(measured, phases=9), "phases")):
        got = pgolden.check_envelope(entry, bad)
        assert got == jgolden.check_envelope(entry, bad)
        assert any(word in p for p in got)
    better = dict(measured, f_score=0.99)
    assert pgolden.check_envelope(entry, better) == []
    ok, problems = pgolden.verify("no-such-dataset", "default", measured,
                                  path=str(tmp_path / "empty.json"))
    assert not ok and "no golden entry" in problems[0]
    path = str(tmp_path / "g.json")
    assert pgolden.verify("d", "c", measured, path=path, update=True)[0]
    assert pgolden.verify("d", "c", measured, path=path) == (True, [])


@pytest.fixture(scope="module")
def synth_workload(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth") / "pl.vite")
    return out, psynth.synthesize(out, edges=SYNTH_EDGES, seed=SYNTH_SEED)


@pytest.mark.parametrize("engine", ["bucketed", "fused"])
def test_powerlaw_golden_envelope(engine, synth_workload):
    """The port's louvain_phases on the synthesized power-law graph lies
    in the checked-in powerlaw-test/default envelope, F-score included
    (tests/test_workloads.py::test_synth_golden_envelope_verify)."""
    out, payload = synth_workload
    g = read_vite(out, bits64=False)
    res = louvain_phases(g, device="cpu", engine=engine)
    measured = pgolden.measure_run(res.communities, res,
                                   truth_path=payload["truth_path"],
                                   provenance="synthesized")
    ok, problems = pgolden.verify("powerlaw-test", "default", measured)
    assert ok, problems
    assert measured["f_score"] > 0.85
