"""cuvite_tpu_torch's segmented coalesce held against the JAX package on
the CPU: the ``seg_coalesce`` twin and its compaction against the Pallas
kernel (interpret mode) and the JAX sort engine, the port's packed sort
against the JAX one at the packed-key edges, and the guards and the engine
policy.  The CUDA kernel itself is held against the twin on a card, in
tests/test_torch_cuda.py.

Slab weights are dyadic (multiples of 1/8): every run sum is exact in f32,
so the port's f64 sums rounded once equal the reference's f32 sums, and
equality is exact everywhere.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cuvite_tpu.kernels.seg_coalesce import emit_coalesced as jax_emit
from cuvite_tpu.kernels.seg_coalesce import seg_coalesce_pallas
from cuvite_tpu.ops import segment as jseg
from cuvite_tpu_torch.kernels import seg_coalesce as sc
from cuvite_tpu_torch.ops import segment as seg
from test_torch_cuda import coalesce_case


def _jax(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _torch(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


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
    acc, cnt = sc.seg_coalesce_plain(*_torch(src, dst, w), nv_pad=nv_pad)
    assert acc.dtype == torch.float64 and cnt.dtype == torch.int32
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
    assert np.array_equal(acc.float().numpy(), np.asarray(jacc))
    ref = jax_emit(jacc, jcnt, ne_pad=ne_pad, src_dtype=jnp.int32,
                   dst_dtype=jnp.int32)
    _assert_same_rows(sc.emit_coalesced(acc, cnt, ne_pad=ne_pad), ref)
    ref_sort = jseg.coalesced_runs(*_jax(src, dst, w), nv_pad=nv_pad,
                                   engine="sort")
    _assert_same_rows(sc.emit_coalesced(acc, cnt, ne_pad=ne_pad), ref_sort)
    for engine in ("dense", "sort"):
        _assert_same_rows(seg.coalesced_runs(*_torch(src, dst, w),
                                             nv_pad=nv_pad, engine=engine),
                          ref_sort)


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
    src, dst, w = _torch(*coalesce_case(64, 256, 0))
    with pytest.raises(ValueError, match="FLAT_NV_MAX"):
        sc.seg_coalesce(src, dst, w, nv_pad=sc.FLAT_NV_MAX * 2)
    with pytest.raises(ValueError, match="power of two"):
        sc.seg_coalesce(src, dst, w, nv_pad=96)
    with pytest.raises(ValueError, match="contiguous 1-d"):
        sc.seg_coalesce(src.long(), dst, w, nv_pad=64)
    with pytest.raises(ValueError, match="shapes"):
        sc.seg_coalesce(src[:10], dst[:10], w, nv_pad=64)


def test_slab_ne_max_guard(monkeypatch):
    src, dst, w = _torch(*coalesce_case(64, 256, 0))
    monkeypatch.setattr(seg, "SLAB_NE_MAX", 128)
    for engine in ("sort", "dense"):
        with pytest.raises(ValueError, match="SLAB_NE_MAX"):
            seg.coalesced_runs(src, dst, w, nv_pad=64, engine=engine)
    with pytest.raises(ValueError, match="SLAB_NE_MAX"):
        seg.run_totals(w, torch.ones(256, dtype=torch.bool))
    with pytest.raises(ValueError, match="not ported"):
        seg.coalesced_runs(src[:64], dst[:64], w[:64], nv_pad=64,
                           engine="msd")


def test_cpu_tensors_run_the_twin_without_a_launch():
    src, dst, w = _torch(*coalesce_case(256, 4096, 5))
    before = sc.seg_coalesce.launches
    got = sc.seg_coalesce(src, dst, w, nv_pad=256)
    ref = sc.seg_coalesce_plain(src, dst, w, nv_pad=256)
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
    for bad in ("65536", "0", "many"):
        monkeypatch.setenv("CUVITE_SEG_COALESCE_MAX_NV", bad)
        with pytest.raises(ValueError, match="MAX_NV"):
            sc.coalesce_engine(64)
    monkeypatch.delenv("CUVITE_SEG_COALESCE_MAX_NV")
    for bad in ("msd", "hash", "pallas"):
        monkeypatch.setenv("CUVITE_SEG_COALESCE", bad)
        with pytest.raises(ValueError, match="not ported"):
            sc.coalesce_engine(64)
