"""cuvite_tpu_torch's streaming held against the JAX package on the CPU:
the same numpy edits go into both.

- ``DeltaBatch``: canonical arrays, ``padded()`` and ``digest()`` equal
  the reference's, out-of-order and duplicate edits included.
- ``apply_delta_slab`` (insert-only, delete-only, mixed with absent
  deletes and duplicate inserts): the slab, ne2, del_w and n_del_hit
  bit-equal to the reference's, and the slab bit-equal to a rebuild of
  the edited edge list; a spill grows the class as ``grow_slab`` does
  there; ``delta_frontier`` and ``plp_prepass`` equal.
- ``StreamSession`` on the reference's planted-community graph and its
  churn: every re-cluster arm gives the reference's communities, phase
  iterations and Q (to 1e-6); the warm arms lie in the golden envelope of
  a cold re-run; a no-op delta keeps the labels bit for bit; a stale warm
  start is refused with the reference's fingerprints.
- The churn stream, its npz and the ``synth --churn`` command; the
  ``StreamPool`` driven by one script on both packages; the daemon's
  ``delta`` verb (the CLI with ``--device cpu``) against the reference
  daemon.

Base weights are small integers and churn weights dyadic (1..8), the
exactness domain where the port's f64-then-round sums equal the
reference's f32 sums.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuvite_tpu.serve as jserve
from cuvite_tpu.coarsen.device import device_weighted_degrees as jax_vdeg
from cuvite_tpu.coarsen.device import grow_slab as jax_grow_slab
from cuvite_tpu.core.distgraph import DistGraph as JDistGraph
from cuvite_tpu.core.graph import Graph as JGraph
from cuvite_tpu.serve.queue import StreamPool as JStreamPool
from cuvite_tpu.stream import DeltaBatch as JDeltaBatch
from cuvite_tpu.stream import StreamSession as JStreamSession
from cuvite_tpu.stream import apply_delta_slab as jax_apply
from cuvite_tpu.stream import delta_frontier as jax_frontier
from cuvite_tpu.stream import plp_prepass as jax_plp
from cuvite_tpu.utils.checkpoint import graph_fingerprint as jax_fp
from cuvite_tpu.workloads.synth import churn_batches as jax_churn
from cuvite_tpu.workloads.synth import synthesize_graph as jax_synth
from cuvite_tpu.workloads.synth import write_churn as jax_write_churn
from cuvite_tpu_torch.coarsen.device import device_weighted_degrees, \
    grow_slab
from cuvite_tpu_torch.core.graph import Graph
from cuvite_tpu_torch.serve.queue import StreamPool
from cuvite_tpu_torch.stream import (
    DeltaBatch,
    StreamSession,
    apply_delta_slab,
    delta_frontier,
    plp_prepass,
)
from cuvite_tpu_torch.stream.session import canonical_slab
from cuvite_tpu_torch.utils.checkpoint import graph_fingerprint
from cuvite_tpu_torch.workloads.golden import (
    check_envelope,
    envelope_from_measurement,
)
from cuvite_tpu_torch.workloads.synth import churn_batches, load_churn, \
    write_churn

from test_torch_serve_daemon import DaemonClient, stub_runner

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NV = 300


@pytest.fixture(autouse=True)
def _free_jax_executables():
    """The reference compiles a program per slab class; free them after
    each test, so a test worker does not accumulate their memory maps."""
    yield
    jax.clear_caches()


def _draw_edges(seed: int, n: int, nv: int = NV) -> dict:
    """tests/test_stream.py's base graph: undirected pair -> summed
    weight, integer weights."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, 2 * n)
    dst = rng.integers(0, nv, 2 * n)
    w = rng.integers(1, 8, 2 * n).astype(np.float64)
    edges: dict = {}
    for u, v, ww in zip(src, dst, w):
        if u == v:
            continue
        k = (min(u, v), max(u, v))
        edges[k] = edges.get(k, 0.0) + ww
        if len(edges) >= n:
            break
    return edges


def _jgraph(edges: dict, nv: int = NV) -> JGraph:
    ks = sorted(edges)
    return JGraph.from_edges(
        nv, np.array([k[0] for k in ks], dtype=np.int64),
        np.array([k[1] for k in ks], dtype=np.int64),
        np.array([edges[k] for k in ks], dtype=np.float64))


def _port(jg) -> Graph:
    return Graph.from_arrays(jg.offsets, jg.tails, jg.weights)


def _oracle_apply(edges: dict, *, dels=(), ins=()) -> dict:
    """The host twin of a delta: retire deleted pairs, then add inserted
    pairs by weight sum (absent deletes tolerated)."""
    out = dict(edges)
    for u, v in dels:
        out.pop((min(u, v), max(u, v)), None)
    for u, v, ww in ins:
        k = (min(u, v), max(u, v))
        out[k] = out.get(k, 0.0) + ww
    return out


def _jslab(jg, min_ne_pad: int = 16384):
    dg = JDistGraph.build(jg, 1, min_nv_pad=4096, min_ne_pad=min_ne_pad)
    sh = dg.shards[0]
    return (dg.nv_pad, dg.ne_pad, sh.n_real_edges,
            np.asarray(sh.src).astype(np.int32),
            np.asarray(sh.dst).astype(np.int32),
            np.asarray(sh.w).astype(np.float32))


@pytest.fixture(scope="module")
def base_edges() -> dict:
    return _draw_edges(7, 1200)


# ---------------------------------------------------------------------------
# DeltaBatch

EDITS = {
    # out of order, one pair inserted three times (twice mirrored), a
    # self-loop, deletes repeated in both directions
    "duplicates": dict(ins_src=[5, 3, 1, 5, 9], ins_dst=[3, 5, 2, 3, 9],
                       ins_w=[1.0, 2.0, 3.0, 4.0, 0.5],
                       del_src=[2, 1, 7, 4], del_dst=[1, 2, 7, 4]),
    "unit_weights": dict(ins_src=[10, 0, 299], ins_dst=[20, 299, 0]),
    "deletes_only": dict(del_src=[8, 6, 8], del_dst=[6, 8, 6]),
    "empty": {},
}


@pytest.mark.parametrize("case", sorted(EDITS))
def test_delta_batch_canonical_and_digest(case):
    mine = DeltaBatch.from_edits(NV, **EDITS[case])
    ref = JDeltaBatch.from_edits(NV, **EDITS[case])
    for f in ("ins_src", "ins_dst", "ins_w", "del_src", "del_dst"):
        a, b = getattr(mine, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (mine.n_ins, mine.n_del) == (ref.n_ins, ref.n_del)
    assert mine.digest() == ref.digest()
    for a, b in zip(mine.padded(), ref.padded()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("bad", [
    dict(ins_src=[0, 1], ins_dst=[1]),
    dict(ins_src=[0], ins_dst=[NV]),
    dict(del_src=[-1], del_dst=[0]),
    dict(ins_src=[0], ins_dst=[1], ins_w=[1.0, 2.0]),
    dict(ins_src=[0], ins_dst=[1], ins_w=[-1.0]),
])
def test_delta_batch_refuses_like_reference(bad):
    with pytest.raises(ValueError) as mine:
        DeltaBatch.from_edits(NV, **bad)
    with pytest.raises(ValueError) as ref:
        JDeltaBatch.from_edits(NV, **bad)
    assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# apply_delta_slab against the reference and the rebuild


def _case_edits(case: str, edges: dict):
    """(insert triples, delete pairs) of one apply case."""
    rng = np.random.default_rng({"insert": 11, "delete": 13,
                                 "mixed": 17}[case])
    keys = sorted(edges)
    ins, dels = [], []
    if case in ("insert", "mixed"):
        iu, iv = rng.integers(0, NV, 40), rng.integers(0, NV, 40)
        iw = rng.integers(1, 8, 40).astype(np.float64)
        ins = [(int(u), int(v), float(w)) for u, v, w in zip(iu, iv, iw)
               if u != v]
    if case in ("delete", "mixed"):
        dels = [keys[i] for i in rng.choice(len(keys), 30, replace=False)]
    if case == "mixed":
        # an absent delete, and inserts that land on a resident pair and
        # on each other
        dels.append(next((u, v) for u in range(NV) for v in range(u + 1, NV)
                         if (u, v) not in edges and (u, v) not in dels))
        ins += [(keys[3][0], keys[3][1], 2.0), (keys[3][1], keys[3][0], 1.0),
                (1, 2, 4.0), (1, 2, 4.0)]
    return ins, dels


def _batch(cls, ins, dels):
    return cls.from_edits(
        NV, ins_src=[e[0] for e in ins], ins_dst=[e[1] for e in ins],
        ins_w=[e[2] for e in ins], del_src=[e[0] for e in dels],
        del_dst=[e[1] for e in dels])


def test_canonical_slab_matches_reference(base_edges):
    jg = _jgraph(base_edges)
    nv_pad, ne_pad, src, dst, w = canonical_slab(_port(jg))
    jnv_pad, jne_pad, ne, jsrc, jdst, jw = _jslab(jg)
    assert (nv_pad, ne_pad, ne) == (jnv_pad, jne_pad, jg.num_edges)
    for a, b in ((src, jsrc), (dst, jdst), (w, jw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", ["insert", "delete", "mixed"])
def test_apply_delta_slab_matches_reference_and_rebuild(case, base_edges):
    jg = _jgraph(base_edges)
    nv_pad, ne_pad, ne, src, dst, w = _jslab(jg)
    ins, dels = _case_edits(case, base_edges)
    mine_b, ref_b = _batch(DeltaBatch, ins, dels), _batch(JDeltaBatch, ins,
                                                          dels)
    ops = mine_b.padded()[:5]
    ref = jax.device_get(jax_apply(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
        *[jnp.asarray(a) for a in ref_b.padded()[:5]], jnp.int32(ne),
        nv_pad=nv_pad))
    got = apply_delta_slab(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
        *[torch.from_numpy(a) for a in ops], ne, nv_pad=nv_pad)
    for a, b in zip(got[:3], ref[:3]):
        a = a.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ne2, del_w, n_hit = (x.item() for x in got[3:])
    assert (ne2, n_hit) == (int(ref[3]), int(ref[5]))
    assert del_w == float(ref[4])
    if case != "insert":
        assert n_hit > 0 and del_w > 0
    if case == "mixed":
        assert n_hit == 2 * (len(dels) - 1)   # the absent delete misses
    # The rebuild: the edited edge list through Graph.from_edges.
    after = _oracle_apply(base_edges, dels=dels, ins=ins)
    _, ne_pad2, rsrc, rdst, rw = canonical_slab(_port(_jgraph(after)))
    assert ne_pad2 == ne_pad and ne2 == int(np.sum(rsrc < nv_pad))
    for a, b in zip(got[:3], (rsrc, rdst, rw)):
        assert np.array_equal(a.numpy(), b)


def test_spill_grows_class_like_reference():
    """A batch overflowing the headroom of a 4096-row class: grow_slab
    and the session's spill give the reference's class and slab."""
    edges = _draw_edges(23, 2040)
    assert 4000 < 2 * len(edges) <= 4096
    jg = _jgraph(edges)
    nv_pad, ne_pad, ne, src, dst, w = _jslab(jg, min_ne_pad=4096)
    assert ne_pad == 4096
    ref = jax.device_get(jax_grow_slab(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), nv_pad=nv_pad,
        new_nv_pad=2 * nv_pad, new_ne_pad=8192))
    got = grow_slab(torch.from_numpy(src), torch.from_numpy(dst),
                    torch.from_numpy(w), nv_pad=nv_pad,
                    new_nv_pad=2 * nv_pad, new_ne_pad=8192)
    for a, b in zip(got, ref):
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="grows classes"):
        grow_slab(*got, nv_pad=2 * nv_pad, new_nv_pad=nv_pad,
                  new_ne_pad=8192)

    rng = np.random.default_rng(29)
    fresh = {}
    while len(fresh) < 60:
        u, v = (int(x) for x in rng.integers(0, NV, 2))
        k = (min(u, v), max(u, v))
        if u != v and k not in edges:
            fresh[k] = float(rng.integers(1, 8))
    ins = [(k[0], k[1], wv) for k, wv in fresh.items()]
    g = _port(jg)
    sessions = {
        "mine": StreamSession(
            nv=NV, nv_pad=nv_pad, ne_pad=ne_pad, ne=ne,
            src=torch.from_numpy(src), dst=torch.from_numpy(dst),
            w=torch.from_numpy(w), tw2=g.total_edge_weight_twice(),
            policy=g.policy, fingerprint=graph_fingerprint(g)),
        "ref": JStreamSession(
            nv=NV, nv_pad=nv_pad, ne_pad=ne_pad, ne=ne,
            src=jnp.asarray(src), dst=jnp.asarray(dst), w=jnp.asarray(w),
            tw2=jg.total_edge_weight_twice(), policy=jg.policy,
            fingerprint=jax_fp(jg))}
    infos = {k: s.apply_delta(_batch(DeltaBatch if k == "mine"
                                     else JDeltaBatch, ins, []))
             for k, s in sessions.items()}
    mine, ref = sessions["mine"], sessions["ref"]
    assert mine.ne_pad == ref.ne_pad == 8192 and mine.ne == ref.ne
    for f in ("src", "dst", "w"):
        assert np.array_equal(getattr(mine, f).numpy(),
                              np.asarray(getattr(ref, f)))
    assert {k: v for k, v in infos["mine"].items() if k != "wall_s"} == \
        {k: v for k, v in infos["ref"].items() if k != "wall_s"}
    assert mine.fingerprint == ref.fingerprint and mine.tw2 == ref.tw2
    assert mine.hbm_bytes() == ref.hbm_bytes()


def test_frontier_and_plp_match_reference(base_edges):
    jg = _jgraph(base_edges)
    nv_pad, _, ne, src, dst, w = _jslab(jg)
    ins, dels = _case_edits("mixed", base_edges)
    ops = _batch(DeltaBatch, ins, dels).padded()[:5]
    t = [torch.from_numpy(a) for a in ops]
    s2, d2, _w2, *_ = apply_delta_slab(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
        *t, ne, nv_pad=nv_pad)
    fr, n_fr = delta_frontier(s2, d2, t[0], t[1], t[3], t[4], nv_pad=nv_pad)
    jfr, jn = jax.device_get(jax_frontier(
        jnp.asarray(s2.numpy()), jnp.asarray(d2.numpy()),
        *[jnp.asarray(ops[i]) for i in (0, 1, 3, 4)], nv_pad=nv_pad))
    assert np.array_equal(fr.numpy(), jfr) and int(n_fr) == int(jn)
    assert 0 < int(jn) < NV

    vdeg = device_weighted_degrees(torch.from_numpy(src),
                                   torch.from_numpy(w), nv_pad=nv_pad)
    jv = jax_vdeg(jnp.asarray(src), jnp.asarray(w), nv_pad=nv_pad)
    assert np.array_equal(vdeg.numpy(), np.asarray(jv))
    for iters in (1, 3):
        got = plp_prepass(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(w), vdeg, nv_pad=nv_pad,
                          iters=iters)
        ref = np.asarray(jax_plp(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(w), jv, nv_pad=nv_pad,
                                 iters=iters))
        assert np.array_equal(got.numpy(), ref)
        assert (got.numpy()[:NV] != np.arange(NV)).any()


# ---------------------------------------------------------------------------
# StreamSession: every arm against the reference


def _summary(res) -> dict:
    return {"communities": np.asarray(res.communities).tolist(),
            "q": float(res.modularity),
            "phase_iterations": [p.iterations for p in res.phases],
            "phase_nv": [p.num_vertices for p in res.phases],
            "total_iterations": int(res.total_iterations)}


def _run_script(pkg: str) -> dict:
    """One session through cold, a delta, both warm arms, a second
    delta, a no-op delta, and a cold re-run on a second session."""
    jg = jax_synth(6000, seed=3, mu=0.12)
    b0, b1 = jax_churn(jg, frac=0.01, seed=5, batches=2)
    if pkg == "mine":
        g, cls = _port(jg), DeltaBatch

        def session():
            return StreamSession.from_graph(g, device="cpu")
    else:
        g, cls = jg, JDeltaBatch

        def session():
            return JStreamSession.from_graph(g)

    def batch(arrs):
        return cls.from_edits(g.num_vertices, **arrs)

    def info(d):
        return {k: v for k, v in d.items() if k != "wall_s"}

    out = {}
    s = session()
    out["cold"] = _summary(s.recluster(warm="cold"))
    out["delta0"] = info(s.apply_delta(batch(b0)))
    out["labels"] = _summary(s.recluster(warm="labels"))
    out["plp"] = _summary(s.recluster(warm="plp"))
    out["delta1"] = info(s.apply_delta(batch(b1)))
    out["labels1"] = _summary(s.recluster(warm="labels"))
    out["noop"] = info(s.apply_delta(cls.from_edits(g.num_vertices)))
    out["labels_noop"] = _summary(s.recluster(warm="labels"))
    out["state"] = (s.ne, s.ne_pad, s.tw2, s.fingerprint, s.hbm_bytes())
    c = session()
    c.apply_delta(batch(b0))
    out["cold_rerun"] = _summary(c.recluster(warm="cold"))
    return out


@pytest.fixture(scope="module")
def scripts() -> dict:
    return {pkg: _run_script(pkg) for pkg in ("mine", "ref")}


@pytest.mark.parametrize("step", ["cold", "labels", "plp", "labels1",
                                  "labels_noop", "cold_rerun"])
def test_recluster_matches_reference(scripts, step):
    mine, ref = scripts["mine"][step], scripts["ref"][step]
    assert mine["communities"] == ref["communities"]
    assert mine["phase_iterations"] == ref["phase_iterations"]
    assert mine["phase_nv"] == ref["phase_nv"]
    assert mine["total_iterations"] == ref["total_iterations"]
    assert abs(mine["q"] - ref["q"]) <= 1e-6


@pytest.mark.parametrize("step", ["delta0", "delta1", "noop", "state"])
def test_session_deltas_match_reference(scripts, step):
    assert scripts["mine"][step] == scripts["ref"][step]


def test_noop_delta_keeps_labels(scripts):
    mine = scripts["mine"]
    assert mine["noop"]["n_ins"] == mine["noop"]["n_del"] == 0
    assert mine["noop"]["frontier_frac"] == 0.0
    assert mine["labels_noop"]["communities"] == \
        mine["labels1"]["communities"]


@pytest.mark.parametrize("arm", ["labels", "plp"])
def test_warm_within_golden_envelope_of_cold_rerun(scripts, arm):
    """The envelope guards against degradation; a warm start that lands
    in a better optimum (Q above the band) is not one, so the Q check is
    one-sided, as in tests/test_stream.py."""
    cold, res = scripts["mine"]["cold_rerun"], scripts["mine"][arm]
    env = envelope_from_measurement({
        "modularity": cold["q"], "phases": len(cold["phase_iterations"]),
        "communities": max(cold["communities"]) + 1})
    problems = check_envelope(env, {
        "modularity": res["q"], "phases": len(res["phase_iterations"]),
        "communities": max(res["communities"]) + 1})
    problems = [p for p in problems
                if not (p.startswith("Q=") and res["q"] >= cold["q"])]
    assert not problems, problems


def test_stale_warm_start_refused_with_reference_fingerprints(base_edges):
    jg = _jgraph(base_edges)
    msgs = {}
    for pkg in ("mine", "ref"):
        if pkg == "mine":
            s, cls = StreamSession.from_graph(_port(jg), device="cpu"), \
                DeltaBatch
        else:
            s, cls = JStreamSession.from_graph(jg), JDeltaBatch
        with pytest.raises(ValueError, match="needs resident labels"):
            s.recluster(warm="labels")
        res = s.recluster(warm="cold")
        fp_before = s.fingerprint
        s.apply_delta(cls.from_edits(NV, ins_src=[1], ins_dst=[2],
                                     ins_w=[1.0]))
        with pytest.raises(ValueError, match="stale warm-start refused") \
                as exc:
            s.recluster(warm="labels",
                        warm_labels=np.asarray(res.communities),
                        warm_fingerprint=0xDEAD)
        ok = s.recluster(warm="labels",
                         warm_labels=np.asarray(res.communities),
                         warm_fingerprint=fp_before)
        msgs[pkg] = (str(exc.value), fp_before, s.fingerprint,
                     np.asarray(ok.communities).tolist())
    assert msgs["mine"] == msgs["ref"]


def test_from_graph_runs_on_the_card_by_default(monkeypatch, base_edges):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamSession.from_graph(_port(_jgraph(base_edges)))
    with pytest.raises(ValueError, match="unknown warm-start arm"):
        StreamSession.from_graph(_port(_jgraph(base_edges)),
                                 device="cpu").recluster(warm="hot")


# ---------------------------------------------------------------------------
# The churn stream and its files


@pytest.fixture(scope="module")
def churn_graph():
    return jax_synth(2000, seed=3)


@pytest.mark.parametrize("frac,seed,batches", [(0.05, 9, 2), (0.01, 1, 1),
                                               (0.2, 4, 3)])
def test_churn_batches_match_reference(churn_graph, frac, seed, batches):
    mine = churn_batches(_port(churn_graph), frac=frac, seed=seed,
                         batches=batches)
    ref = jax_churn(churn_graph, frac=frac, seed=seed, batches=batches)
    assert len(mine) == len(ref) == batches
    for bm, br in zip(mine, ref):
        assert sorted(bm) == sorted(br)
        for k in br:
            assert bm[k].dtype == br[k].dtype and \
                np.array_equal(bm[k], br[k]), k


def test_write_churn_same_npz_as_reference(tmp_path, churn_graph,
                                           monkeypatch):
    # The npz's zip entries carry the write time: freeze it.
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    mine = write_churn(str(tmp_path / "p"), _port(churn_graph), frac=0.05,
                       seed=9, batches=2)
    ref = jax_write_churn(str(tmp_path / "j"), churn_graph, frac=0.05,
                          seed=9, batches=2)
    assert mine["sha256"] == ref["sha256"]
    assert (tmp_path / "p.churn.npz").read_bytes() == \
        (tmp_path / "j.churn.npz").read_bytes()
    for p in (mine, ref):
        p.pop("base"), p.pop("created")
    assert mine == ref
    on_disk = json.loads((tmp_path / "p.churn.provenance.json").read_text())
    assert on_disk["churn_seed"] == 9 and on_disk["batches"] == 2
    loaded = load_churn(str(tmp_path / "p"))
    for bl, bf in zip(loaded, jax_churn(churn_graph, frac=0.05, seed=9,
                                        batches=2)):
        for k in bf:
            assert np.array_equal(bl[k], bf[k]), k


def test_synth_churn_cli_matches_reference_cli(tmp_path, capsys,
                                               monkeypatch):
    from cuvite_tpu.workloads.__main__ import main as jmain
    from cuvite_tpu_torch.workloads.__main__ import main

    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    lines = {}
    for name, fn in (("p", main), ("j", jmain)):
        out = str(tmp_path / f"{name}.vite")
        assert fn(["synth", "--edges", "4000", "--out", out, "--churn",
                   "0.05", "--churn-batches", "2", "--churn-seed",
                   "3"]) == 0
        lines[name] = json.loads(capsys.readouterr().out)
    p, j = lines["p"], lines["j"]
    assert p["churn"]["sha256"] == j["churn"]["sha256"]
    assert p["churn"]["npz"] == str(tmp_path / "p.vite.churn.npz")
    assert (p["sha256"], p["churn"]["frac"], p["churn"]["batches"]) == \
        (j["sha256"], 0.05, 2)
    assert (tmp_path / "p.vite.churn.npz").read_bytes() == \
        (tmp_path / "j.vite.churn.npz").read_bytes()


# ---------------------------------------------------------------------------
# StreamPool: one script on both packages


class _Recorder:
    def __init__(self):
        self.events = []

    def event(self, name, **attrs):
        self.events.append((name, attrs))


class _StubSess:
    def __init__(self, graph, tracer=None):
        self.nbytes = 1000
        self.dropped = 0

    def hbm_bytes(self):
        return self.nbytes

    def drop(self):
        self.dropped += 1


def _pool_script(cls) -> tuple:
    rec, made = _Recorder(), []

    def factory(graph, tracer=None):
        made.append(_StubSess(graph, tracer))
        return made[-1]

    pool = cls(2500, rec, factory=factory)
    states = []

    def note(*extra):
        states.append((pool.to_dict(), pool.conservation(), *extra))

    for t in "abc":
        pool.admit(t, None)
        note()
    note(pool.get("a") is None, pool.get("b") is made[1])
    pool.admit("d", None)                # evicts c, not the touched b
    note(pool.get("c") is None)
    made[1].nbytes = 2000                # b's slab class grew (spill)
    pool.reledger("b")
    pool.reledger("ghost")
    note()
    pool.admit("b", None)                # replace
    note(pool.evict("b"), pool.evict("b"))
    big = cls(500, rec, factory=factory)
    big.admit("big", None)               # larger than the budget, alone
    note(big.conservation(), big.get("big") is made[-1])
    pool.clear()
    note([s.dropped for s in made])
    return rec.events, states


def test_stream_pool_script_matches_reference():
    mine_events, mine_states = _pool_script(StreamPool)
    ref_events, ref_states = _pool_script(JStreamPool)
    assert mine_events == ref_events
    assert mine_states == ref_states
    assert [e for e, _ in mine_events].count("evict") == 5
    for d, cons, *_ in mine_states:
        assert cons["ok"]
        assert cons["admitted"] == cons["resident"] + cons["evicted"]


def test_stream_budget_refused():
    from cuvite_tpu_torch.serve import ServeConfig

    with pytest.raises(ValueError, match="stream_budget_bytes"):
        ServeConfig(stream_budget_bytes=0)
    with pytest.raises(ValueError, match="stream budget"):
        StreamPool(0)


# ---------------------------------------------------------------------------
# The daemon's `delta` verb: the port's CLI (--device cpu) against the
# reference daemon

BUDGET_MB = 0.25    # one session of the (4096, 16384) class: 204,800 B

DELTA_SCRIPT = [
    {"op": "delta", "tenant": "t0", "ins": [[0, 1]]},
    {"op": "delta", "tenant": "t0", "synth": {"edges": 2048, "seed": 3},
     "ins": [[0, 5], [1, 6, 2.0]], "del": [[0, 1]], "recluster": True},
    {"op": "delta", "tenant": "t0", "ins": [[2, 7, 3.0]],
     "del": [[4, 9]], "recluster": True, "warm": "labels",
     "labels": True},
    {"op": "delta", "tenant": "t0", "recluster": True, "warm": "plp"},
    {"op": "delta", "tenant": "t1", "synth": {"edges": 1024, "seed": 4},
     "ins": [[0, 2]], "recluster": True, "warm": "labels"},
    {"op": "delta", "tenant": "t0", "ins": [[3, 7]]},
    {"op": "delta", "ins": [[3, 7]]},
    {"op": "delta", "tenant": "t1", "ins": [[9999, 1]]},
    {"op": "stats"},
]


def _reference_replies(path) -> tuple:
    srv = jserve.LouvainServer(
        jserve.ServeConfig(b_max=2, linger_s=0.005, engine="fused",
                           stream_budget_bytes=int(BUDGET_MB * (1 << 20))),
        runner=stub_runner)
    d = jserve.ServeDaemon(srv, sock_path=str(path), poll_s=0.005)
    d.start()
    c = DaemonClient(str(path))
    try:
        replies = [c.call(r) for r in DELTA_SCRIPT]
        assert c.call({"op": "drain"})["ok"]
        summary = c.until_summary()[-1]["serve_summary"]
    finally:
        c.close()
    d.serve_forever(timeout=60.0)
    return replies, summary


def test_daemon_delta_verb_matches_reference(tmp_path):
    sock = str(tmp_path / "p.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cuvite_tpu_torch.serve", "daemon",
         "--socket", sock, "--b-max", "2", "--linger-ms", "5",
         "--engine", "fused", "--device", "cpu", "--stream-budget-mb",
         str(BUDGET_MB)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO)
    try:
        assert json.loads(proc.stdout.readline())["ready"]["device"] == \
            "cpu"
        c = DaemonClient(sock)
        try:
            replies = [c.call(r) for r in DELTA_SCRIPT]
            proc.send_signal(signal.SIGTERM)
            summary = c.until_summary()[-1]["serve_summary"]
        finally:
            c.close()
        assert proc.wait(timeout=120) == 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    ref, ref_summary = _reference_replies(tmp_path / "j.sock")
    # The stats reply adds the kernels' launch counts beyond the
    # reference's (all zero on the CPU).
    assert replies[-1].pop("kernels") == dict.fromkeys(
        ("row_argmax", "heavy_bincount", "seg_coalesce",
         "row_argmax_sized"), 0)
    assert replies == ref
    assert summary["stream"] == ref_summary["stream"]
    assert [r["ok"] for r in replies] == [False, True, True, True, True,
                                          False, False, False, True]
    assert replies[1]["recluster"]["warm"] == "cold"
    assert replies[2]["recluster"]["warm"] == "labels"
    assert replies[5]["resident"] is False          # evicted by t1
    assert summary["stream"] == {
        "resident": 0, "admitted": 2, "evicted": 2,
        "bytes_resident": 0, "budget_bytes": 262144,
        "conservation": {"admitted": 2, "evicted": 2, "resident": 0,
                         "bytes_resident": 0, "ok": True}}
