"""The msd and hash coalesce engines of cuvite_tpu_torch held against the
JAX package's on the CPU.

The reference's chokepoint slabs at the packing boundary (nv_pad 2^15, the
widest 31-bit pack, and 2^16, the first past it) coalesce through both
engines bit-equal -- (src, ckey, w, n) -- to the reference's same engine,
to the port's sort engine and to the f64 oracle on dyadic weights.  The
slot counts and each dst's slot equal the reference's; a forced collision
takes the msd retry, a collision-free slab the emission; whole sort-engine
runs under ``CUVITE_SEG_COALESCE=msd`` and ``=hash`` give the reference's
labels and iterations, and a batch under msd gives each tenant its B=1
labels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuvite_tpu.kernels import seg_coalesce as ref_sc
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu.ops.segment import coalesced_runs as ref_coalesced_runs
from cuvite_tpu_torch import Graph, louvain_many, louvain_phases
from cuvite_tpu_torch.kernels import seg_coalesce as sc
from cuvite_tpu_torch.ops import segment as seg

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _free_jax_executables():
    yield
    jax.clear_caches()


def chokepoint_slab(nv_pad, ne_pad, seed):
    """The reference's ``tests/test_rebin.py::_chokepoint_slab``: a
    seventh of the rows padding, runs at both ends of the id space, and
    dyadic weights (every f32 partial sum exact)."""
    rng = np.random.default_rng(seed)
    n_real = ne_pad - ne_pad // 7
    src = np.full(ne_pad, nv_pad, np.int32)
    dst = np.zeros(ne_pad, np.int32)
    w = np.zeros(ne_pad, np.float32)
    src[:n_real] = rng.integers(0, nv_pad, n_real)
    dst[:n_real] = rng.integers(0, nv_pad, n_real)
    src[:4] = [nv_pad - 1, nv_pad - 1, 0, 0]
    dst[:4] = [nv_pad - 1, nv_pad - 1, nv_pad - 1, 0]
    w[:n_real] = rng.integers(1, 64, n_real) / 8.0
    return src, dst, w


def collision_free_slab(nv_pad, ne_pad, k, seed):
    """Rows whose distinct dst of each src all hash to distinct slots of
    ``k``, with duplicate rows and dyadic weights: the hash engine's
    emission path, not its retry."""
    src, dst, w = chokepoint_slab(nv_pad, ne_pad, seed)
    real = src < nv_pad
    slot = sc.hash_slot_of(torch.from_numpy(dst), k).numpy()
    keep = np.zeros(ne_pad, bool)
    seen = {}
    for i in np.nonzero(real)[0]:
        key = (int(src[i]), int(slot[i]))
        if seen.setdefault(key, int(dst[i])) == int(dst[i]):
            keep[i] = True
    src = np.where(keep | ~real, src, nv_pad).astype(np.int32)
    dst = np.where(keep, dst, 0).astype(np.int32)
    w = np.where(keep, w, 0.0).astype(np.float32)
    dup = np.nonzero(keep)[0][: ne_pad // 8]   # duplicate rows: runs
    src[-len(dup):], dst[-len(dup):], w[-len(dup):] = \
        src[dup], dst[dup], w[dup]
    return src, dst, w


def oracle(src, ckey, w, nv_pad):
    """Sorted distinct real (src, ckey) pairs, weights summed in f64."""
    real = src < nv_pad
    keys = src[real].astype(np.int64) * (nv_pad + 1) + ckey[real]
    order = np.argsort(keys, kind="stable")
    ks, ws = keys[order], w[real][order].astype(np.float64)
    uniq, start = np.unique(ks, return_index=True)
    sums = np.add.reduceat(ws, start) if len(ws) else ws
    return ((uniq // (nv_pad + 1)).astype(np.int32),
            (uniq % (nv_pad + 1)).astype(np.int32), sums.astype(np.float32))


def port_rows(src, dst, w, nv_pad, engine):
    out = seg.coalesced_runs(torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(w), nv_pad=nv_pad,
                             engine=engine)
    return tuple(t.numpy() for t in out[:3]) + (out[3],)


def ref_rows(src, dst, w, nv_pad, engine):
    out = jax.device_get(ref_coalesced_runs(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), nv_pad=nv_pad,
        engine=engine))
    return tuple(np.asarray(x) for x in out[:3]) + (int(out[3]),)


def assert_rows_equal(got, ref):
    for g, r, name in zip(got[:3], ref[:3], ("src", "ckey", "w")):
        assert g.dtype == r.dtype, name
        assert np.array_equal(g.view(np.int32), r.view(np.int32)), name
    assert got[3] == ref[3]


@pytest.mark.parametrize("engine", ["msd", "hash"])
@pytest.mark.parametrize("nv_pad", [1 << 15, 1 << 16],
                         ids=["widest-legal-pack", "first-ineligible"])
def test_chokepoint_slabs_match_reference_sort_and_oracle(engine, nv_pad):
    src, dst, w = chokepoint_slab(nv_pad, 8192, seed=nv_pad)
    got = port_rows(src, dst, w, nv_pad, engine)
    assert_rows_equal(got, ref_rows(src, dst, w, nv_pad, engine))
    assert_rows_equal(got, port_rows(src, dst, w, nv_pad, "sort"))
    s_o, c_o, w_o = oracle(src, dst, w, nv_pad)
    n = got[3]
    assert n == len(s_o)
    assert np.array_equal(got[0][:n], s_o)
    assert np.array_equal(got[1][:n], c_o)
    assert np.array_equal(got[2][:n], w_o)
    assert (got[0][n:] == nv_pad).all() and not got[2][n:].any()


def test_msd_sort_is_two_stable_int32_passes(monkeypatch):
    """Past the 31-bit pack the msd sort makes exactly two stable sorts
    of int32 keys, and gives the packed sort's order (payload order
    within a run included)."""
    nv_pad = 1 << 16
    src, dst, w = (torch.from_numpy(a) for a in
                   chokepoint_slab(nv_pad, 4096, seed=11))
    w = torch.arange(4096, dtype=torch.float32)   # slab order as payload
    calls = []
    real_sort = torch.sort

    def spy(x, *a, **kw):
        calls.append((x.dtype, kw.get("stable")))
        return real_sort(x, *a, **kw)

    monkeypatch.setattr(torch, "sort", spy)
    got = seg.sort_edges_msd(src, dst, w, nv_pad=nv_pad)
    assert calls == [(torch.int32, True), (torch.int32, True)]
    monkeypatch.setattr(torch, "sort", real_sort)
    ref = seg.sort_edges_by_vertex_comm(src, dst, w, src_bound=nv_pad + 1,
                                        key_bound=nv_pad)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    # At the widest legal pack it is the packed sort (one pass).
    calls.clear()
    monkeypatch.setattr(torch, "sort", spy)
    seg.sort_edges_msd(src.clamp(max=1 << 15), dst.clamp(max=(1 << 15) - 1),
                       w, nv_pad=1 << 15)
    assert len(calls) == 1


@pytest.mark.parametrize("knob", [None, "0", "1", "3", "64", "4096",
                                  "9999", "junk"])
def test_hash_slots_match_reference(knob, monkeypatch):
    if knob is None:
        monkeypatch.delenv("CUVITE_HASH_SLOTS", raising=False)
    else:
        monkeypatch.setenv("CUVITE_HASH_SLOTS", knob)
    with pytest.warns(UserWarning) if knob in ("9999", "junk") else \
            _no_warning():
        for nv_pad in (1, 64, 4096, 1 << 15, 1 << 16, 1 << 20, 1 << 24):
            for ne_pad in (16, 8192, 1 << 20, 1 << 26):
                assert sc.hash_slots(nv_pad, ne_pad) == \
                    ref_sc.hash_slots(nv_pad, ne_pad), (nv_pad, ne_pad)


class _no_warning:
    def __enter__(self):
        import warnings

        self._c = warnings.catch_warnings()
        self._c.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        self._c.__exit__(*exc)


@pytest.mark.parametrize("k", [1, 2, 16, 64, 1024])
def test_hash_slot_of_every_dst_matches_reference(k):
    nv_pad = 1 << 16
    src, dst, w = chokepoint_slab(nv_pad, 8192, seed=k)
    dst = np.concatenate([dst, np.arange(nv_pad, dtype=np.int32),
                          np.array([(1 << 31) - 1], np.int32)])
    if k == 1:
        ref = np.zeros(len(dst), np.int64)
    else:
        log2k = (k - 1).bit_length()
        ref = np.asarray(jnp.asarray(dst).astype(jnp.uint32)
                         * jnp.uint32(ref_sc._HASH_MULT)
                         >> (32 - log2k)).astype(np.int64)
    assert np.array_equal(sc.hash_slot_of(torch.from_numpy(dst), k).numpy(),
                          ref)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_hash_tables_match_reference(k):
    nv_pad = 1 << 12
    src, dst, w = chokepoint_slab(nv_pad, 8192, seed=3)
    got = sc.hash_accumulate(torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(w), nv_pad=nv_pad, k=k)
    ref = jax.device_get(ref_sc.hash_accumulate(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), nv_pad=nv_pad,
        k=k))
    assert np.array_equal(got[0].float().numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_forced_collision_takes_the_msd_retry(monkeypatch):
    nv_pad = 1 << 16
    src, dst, w = chokepoint_slab(nv_pad, 4096, seed=5)
    monkeypatch.setenv("CUVITE_HASH_SLOTS", "1")
    sc.zero_hash_stats()
    got = port_rows(src, dst, w, nv_pad, "hash")
    assert sc.HASH_STATS == {"coalescings": 1, "collisions": 1,
                             "host_reads": 1}
    assert_rows_equal(got, ref_rows(src, dst, w, nv_pad, "hash"))
    assert_rows_equal(got, port_rows(src, dst, w, nv_pad, "sort"))


@pytest.mark.parametrize("nv_pad", [1 << 12, 1 << 16])
def test_collision_free_slab_takes_the_emission(nv_pad, monkeypatch):
    monkeypatch.delenv("CUVITE_HASH_SLOTS", raising=False)
    ne_pad = 8192
    k = sc.hash_slots(nv_pad, ne_pad)
    src, dst, w = collision_free_slab(nv_pad, ne_pad, k, seed=9)
    sc.zero_hash_stats()
    got = port_rows(src, dst, w, nv_pad, "hash")
    assert sc.HASH_STATS == {"coalescings": 1, "collisions": 0,
                             "host_reads": 1}
    assert_rows_equal(got, ref_rows(src, dst, w, nv_pad, "hash"))
    assert_rows_equal(got, port_rows(src, dst, w, nv_pad, "sort"))
    assert got[3] < int((src < nv_pad).sum())   # duplicates coalesced


def test_batches_send_hash_to_msd(monkeypatch):
    monkeypatch.setenv("CUVITE_SEG_COALESCE", "hash")
    assert sc.coalesce_engine(1 << 16) == "hash"
    assert sc.batched_coalesce_engine(1 << 16, 8, 1 << 10) == "msd"
    assert sc.batched_coalesce_engine(64, 2, 64) == "msd"
    monkeypatch.setenv("CUVITE_SEG_COALESCE", "msd")
    assert sc.batched_coalesce_engine(64, 2, 64) == "msd"
    src, dst, w = (torch.from_numpy(a)[None].repeat(2, 1)
                   for a in chokepoint_slab(1 << 10, 512, seed=1))
    with pytest.raises(ValueError, match="one\\s+slab"):
        seg.coalesced_runs_batched(src, dst, w, nv_pad=1 << 10,
                                   engine="hash")


def test_batched_msd_matches_batched_sort():
    nv_pad, b = 1 << 16, 3
    slabs = [chokepoint_slab(nv_pad, 2048, seed=s) for s in range(b)]
    src, dst, w = (torch.from_numpy(np.stack(x)) for x in zip(*slabs))
    got = seg.coalesced_runs_batched(src, dst, w, nv_pad=nv_pad,
                                     engine="msd")
    ref = seg.coalesced_runs_batched(src, dst, w, nv_pad=nv_pad)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# ---------------------------------------------------------------------------
# Whole sort-engine runs under each engine, against the reference's.


def _port_graph(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


@pytest.fixture(scope="module")
def rgg4096_unit():
    """RGG -n 4096 with unit weights (the exactness domain)."""
    from cuvite_tpu.core.graph import Graph as JGraph
    from cuvite_tpu.io.generate import generate_rgg as jax_rgg

    g = jax_rgg(4096)
    return JGraph(offsets=g.offsets, tails=g.tails,
                  weights=np.ones_like(g.weights))


@pytest.mark.parametrize("mode", ["msd", "hash"])
@pytest.mark.parametrize("name", ["karate", "rgg4096_unit"])
def test_sort_engine_runs_match_reference(name, mode, request, monkeypatch):
    jg = request.getfixturevalue(name)
    monkeypatch.setenv("CUVITE_SEG_COALESCE", mode)
    jr = jax_louvain(jg, engine="sort")
    sc.zero_hash_stats()
    tr = louvain_phases(_port_graph(jg), engine="sort", device="cpu")
    assert np.array_equal(tr.communities, jr.communities)
    assert [p.iterations for p in tr.phases] == \
        [p.iterations for p in jr.phases]
    assert tr.total_iterations == jr.total_iterations
    assert abs(tr.modularity - jr.modularity) <= 1e-9
    engines = [p.coalesce for p in tr.phases]
    assert engines[:-1] and set(engines[:-1]) == {mode}
    n_coarsen = sum(e is not None for e in engines)
    if mode == "hash":
        assert sc.HASH_STATS["coalescings"] == n_coarsen
        assert sc.HASH_STATS["host_reads"] == n_coarsen
    else:
        assert sc.HASH_STATS["coalescings"] == 0


def test_batch_under_msd_matches_each_b1_run(monkeypatch):
    from cuvite_tpu_torch.workloads.synth import synthesize_graph

    monkeypatch.setenv("CUVITE_SEG_COALESCE", "msd")
    gs = [synthesize_graph(1024, seed=s) for s in range(8)]
    br = louvain_many(gs, device="cpu")
    assert "msd" in br.coalesce and set(br.coalesce) <= {"msd"}
    for g, r in zip(gs, br.results):
        one = louvain_many([g], device="cpu").results[0]
        assert np.array_equal(r.communities, one.communities)
        assert r.total_iterations == one.total_iterations
