"""cuvite_tpu_torch's segmented coalesce held against the JAX package on
the CPU: the ``seg_coalesce`` twin (its dense accumulate step and its
compaction) against the Pallas kernel (interpret mode), the reference's
``coalesce_slab`` and the JAX sort engine, the port's packed sort against
the JAX one at the packed-key edges, and the guards and the engine policy.
The CUDA pipeline itself is held against the twin on a card, in
tests/test_torch_cuda.py.

Slab weights are dyadic (multiples of 1/8): every run sum is exact in f32,
so the port's f64 sums rounded once equal the reference's f32 sums, and
equality is exact everywhere.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cuvite_tpu.kernels.seg_coalesce import coalesce_slab as jax_coalesce_slab
from cuvite_tpu.kernels.seg_coalesce import emit_coalesced as jax_emit
from cuvite_tpu.kernels.seg_coalesce import seg_coalesce_pallas
from cuvite_tpu.ops import segment as jseg
from cuvite_tpu_torch.kernels import seg_coalesce as sc
from cuvite_tpu_torch.ops import segment as seg
from test_torch_cuda import coalesce_case, hot_src_slab

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _torch(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _one(*arrs):
    """One slab as a batch of one, [1, ne] tensors."""
    return tuple(t[None] for t in _torch(*arrs))


def _first(out):
    """Tenant 0 of a batched emission, as (src, dst, w, n)."""
    return out[0][0], out[1][0], out[2][0], int(out[3][0])


def _assert_same_rows(port, ref):
    """(src, dst, w, n) of the port against the reference's: the same n
    and bit-equal [ne_pad] arrays (prefix and padding)."""
    assert int(port[3]) == int(ref[3])
    for name, mine, theirs in zip(("src", "dst", "w"), port[:3], ref[:3]):
        mine, theirs = mine.numpy(), np.asarray(theirs)
        assert mine.dtype == theirs.dtype, name
        assert np.array_equal(mine, theirs), name


@pytest.mark.parametrize("nv_pad,ne_pad,gapped", [
    (1024, 16384, True), (4096, 16384, False)])
def test_twin_and_emit_match_pallas_and_jax_sort(nv_pad, ne_pad, gapped):
    src, dst, w = coalesce_case(nv_pad, ne_pad, nv_pad + ne_pad,
                                gapped=gapped)
    jacc, jcnt = seg_coalesce_pallas(*_jax(src, dst, w), nv_pad=nv_pad,
                                     interpret=True)
    acc, cnt = sc.dense_accumulate_plain(*_one(src, dst, w), grid=nv_pad)
    assert acc.dtype == torch.float64 and cnt.dtype == torch.int32
    assert np.array_equal(cnt[0].numpy(), np.asarray(jcnt))
    assert np.array_equal(acc[0].float().numpy(), np.asarray(jacc))
    ref = jax_emit(jacc, jcnt, ne_pad=ne_pad, src_dtype=jnp.int32,
                   dst_dtype=jnp.int32)
    emitted = _first(sc.emit_coalesced(acc, cnt, ne_pad=ne_pad,
                                       nv_pad=nv_pad))
    _assert_same_rows(emitted, ref)
    _assert_same_rows(_first(sc.seg_coalesce_plain(
        *_one(src, dst, w), nv_pad=nv_pad, grid=nv_pad)), ref)
    ref_sort = jseg.coalesced_runs(*_jax(src, dst, w), nv_pad=nv_pad,
                                   engine="sort")
    _assert_same_rows(emitted, ref_sort)
    for engine in ("dense", "sort"):
        _assert_same_rows(seg.coalesced_runs(*_torch(src, dst, w),
                                             nv_pad=nv_pad, engine=engine),
                          ref_sort)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
@pytest.mark.parametrize("case", ["one_src", "no_real_row"])
def test_twin_matches_reference_coalesce_slab(case, engine):
    """The twin against the reference's whole dense coalesce
    (``coalesce_slab``, Pallas in interpret mode or its XLA twin), tenant
    by tenant: a slab whose rows all share one src, and a batch whose
    second tenant has no real row."""
    nv_pad, ne_pad = 256, 4096
    slabs = [hot_src_slab(nv_pad, ne_pad, 3, all_hot=True)]
    if case == "no_real_row":
        slabs.append((np.full(ne_pad, nv_pad, np.int32),
                      np.zeros(ne_pad, np.int32),
                      np.zeros(ne_pad, np.float32)))
    batch = _torch(*(np.stack(a) for a in zip(*slabs)))
    got = sc.seg_coalesce_plain(*batch, nv_pad=nv_pad, grid=nv_pad)
    for b, slab in enumerate(slabs):
        ref = jax_coalesce_slab(*_jax(*slab), nv_pad=nv_pad, engine=engine,
                                interpret=True)
        mine = (got[0][b], got[1][b], got[2][b], int(got[3][b]))
        _assert_same_rows(mine, ref)
    assert int(got[3][0]) > 0
    if case == "no_real_row":
        assert int(got[3][1]) == 0 and (got[0][1] == nv_pad).all()


def test_zero_weight_runs_emitted_by_presence():
    """A real zero-weight edge is a run (presence, not weight) in both
    engines: dropping it would change the coarse offsets."""
    nv_pad, ne_pad = 1024, 16384
    src = np.full(ne_pad, nv_pad, np.int32)
    dst = np.zeros(ne_pad, np.int32)
    w = np.zeros(ne_pad, np.float32)
    src[:3] = [5, 7, 9]
    dst[:3] = [6, 8, 10]
    w[:3] = [1.0, 0.0, 2.0]   # the (7, 8) run weighs exactly 0
    for engine in ("sort", "dense"):
        src_c, dst_c, w_c, n = seg.coalesced_runs(
            *_torch(src, dst, w), nv_pad=nv_pad, engine=engine)
        assert n == 3, engine
        assert src_c[:3].tolist() == [5, 7, 9] and w_c[1] == 0.0, engine
        assert (src_c[3:] == nv_pad).all() and (w_c[3:] == 0).all()


def _packed_edge_case(bound, seed):
    """Ids at both ends of [0, bound), and a few duplicate pairs with
    dyadic weights; other weights random floats (single-row runs)."""
    rng = np.random.default_rng(seed)
    n = 4096
    src = rng.integers(0, bound, n).astype(np.int32)
    ckey = rng.integers(0, bound, n).astype(np.int32)
    src[:4] = [bound - 1, bound - 1, 0, 0]
    ckey[:4] = [bound - 1, 0, bound - 1, 0]
    w = rng.random(n).astype(np.float32)
    src[4:64] = src[:60] % 3
    ckey[4:64] = ckey[:60] % 3
    w[:64] = rng.integers(0, 16, 64) / 4.0
    return src, ckey, w


@pytest.mark.parametrize("nv_pad", [1 << 15, 1 << 16],
                         ids=["31-bit", "33-bit"])
def test_sort_matches_jax_at_packed_key_edges(nv_pad):
    """The port packs (src << kbits) | key into int64 at every width;
    the reference packs int32 up to 31 bits (nv_pad 2^15: the widest)
    and sorts lexicographically past it (nv_pad 2^16).  Both orders and
    both coalesced results agree."""
    src, ckey, w = _packed_edge_case(nv_pad, nv_pad)
    for mine, ref in zip(
            seg.sort_edges_by_vertex_comm(*_torch(src, ckey, w),
                                          src_bound=nv_pad + 1,
                                          key_bound=nv_pad),
            jseg.sort_edges_by_vertex_comm(*_jax(src, ckey, w),
                                           src_bound=nv_pad + 1,
                                           key_bound=nv_pad)):
        assert np.array_equal(mine.numpy(), np.asarray(ref))
    _assert_same_rows(
        seg.coalesced_runs(*_torch(src, ckey, w), nv_pad=nv_pad),
        jseg.coalesced_runs(*_jax(src, ckey, w), nv_pad=nv_pad,
                            engine="sort"))


def test_flat_nv_max_and_pow2_guards():
    src, dst, w = _one(*coalesce_case(64, 256, 0))
    with pytest.raises(ValueError, match="FLAT_NV_MAX"):
        sc.seg_coalesce(src, dst, w, nv_pad=64, grid=sc.FLAT_NV_MAX * 2)
    with pytest.raises(ValueError, match="power of two"):
        sc.seg_coalesce(src, dst, w, nv_pad=64, grid=96)
    with pytest.raises(ValueError, match=r"contiguous \[B, ne\]"):
        sc.seg_coalesce(src.long(), dst, w, nv_pad=64, grid=64)
    with pytest.raises(ValueError, match=r"contiguous \[B, ne\]"):
        sc.seg_coalesce(src[0], dst[0], w[0], nv_pad=64, grid=64)
    with pytest.raises(ValueError, match="shapes"):
        sc.seg_coalesce(src[:, :10], dst[:, :10], w, nv_pad=64, grid=64)


def test_slab_ne_max_guard(monkeypatch):
    src, dst, w = _torch(*coalesce_case(64, 256, 0))
    monkeypatch.setattr(seg, "SLAB_NE_MAX", 128)
    for engine in ("sort", "dense"):
        with pytest.raises(ValueError, match="SLAB_NE_MAX"):
            seg.coalesced_runs(src, dst, w, nv_pad=64, engine=engine)
    with pytest.raises(ValueError, match="SLAB_NE_MAX"):
        seg.run_totals(w, torch.ones(256, dtype=torch.bool))
    # The msd and hash engines keep the same guard, and run below it.
    for engine in ("msd", "hash"):
        with pytest.raises(ValueError, match="SLAB_NE_MAX"):
            seg.coalesced_runs(src, dst, w, nv_pad=64, engine=engine)
        got = seg.coalesced_runs(src[:64], dst[:64], w[:64], nv_pad=64,
                                 engine=engine)
        ref = seg.coalesced_runs(src[:64], dst[:64], w[:64], nv_pad=64)
        assert got[3] == ref[3]
        for g, r in zip(got[:3], ref[:3]):
            assert torch.equal(g, r)


def test_cpu_tensors_run_the_twin_without_a_launch():
    src, dst, w = _one(*coalesce_case(256, 4096, 5))
    before = sc.seg_coalesce.launches
    got = sc.seg_coalesce(src, dst, w, nv_pad=256, grid=256)
    ref = sc.seg_coalesce_plain(src, dst, w, nv_pad=256, grid=256)
    assert sc.seg_coalesce.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_coalesce_engine_policy(monkeypatch):
    monkeypatch.delenv("CUVITE_SEG_COALESCE", raising=False)
    monkeypatch.delenv("CUVITE_SEG_COALESCE_MAX_NV", raising=False)
    assert sc.coalesce_engine(1) == sc.coalesce_engine(4096) == "dense"
    assert sc.coalesce_engine(8192) == "sort"
    monkeypatch.setenv("CUVITE_SEG_COALESCE", "sort")
    assert sc.coalesce_engine(64) == "sort"
    monkeypatch.setenv("CUVITE_SEG_COALESCE", "dense")
    assert sc.coalesce_engine(64) == "dense"
    monkeypatch.setenv("CUVITE_SEG_COALESCE_MAX_NV", "8192")
    assert sc.coalesce_engine(8192) == "dense"
    assert sc.coalesce_engine(16384) == "sort"
    # A malformed or out-of-range cap warns and keeps the default, as the
    # reference's env_int does.
    for bad in ("65536", "0", "many"):
        monkeypatch.setenv("CUVITE_SEG_COALESCE_MAX_NV", bad)
        with pytest.warns(UserWarning, match="MAX_NV"):
            assert sc.coalesce_engine(4096) == "dense"
        with pytest.warns(UserWarning, match="MAX_NV"):
            assert sc.coalesce_engine(8192) == "sort"
    monkeypatch.delenv("CUVITE_SEG_COALESCE_MAX_NV")
    # The reference's words: its dense names take the port's dense
    # policy, msd and hash their engines; an unknown word warns and keeps
    # the default.
    for mode, small, big in (("msd", "msd", "msd"), ("hash", "hash", "hash"),
                             ("pallas", "dense", "sort"),
                             ("xla", "dense", "sort"),
                             ("1", "dense", "sort"), ("true", "dense", "sort"),
                             ("0", "sort", "sort"), ("false", "sort", "sort")):
        monkeypatch.setenv("CUVITE_SEG_COALESCE", mode)
        assert (sc.coalesce_engine(64), sc.coalesce_engine(8192)) == \
            (small, big), mode
    for bad in ("radix", "dense2"):
        monkeypatch.setenv("CUVITE_SEG_COALESCE", bad)
        with pytest.warns(UserWarning, match="CUVITE_SEG_COALESCE"):
            assert sc.coalesce_engine(64) == "dense"
        with pytest.warns(UserWarning, match="CUVITE_SEG_COALESCE"):
            assert sc.coalesce_engine(8192) == "sort"
