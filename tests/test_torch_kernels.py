"""cuvite_tpu_torch kernels: the plain PyTorch twins held against the JAX
package's Pallas kernels (interpret mode) and XLA row paths.  The CUDA
kernels themselves are held against these twins on a card, in
tests/test_torch_cuda.py.

Inputs come from numpy seeds and go to both packages.  Weights are
multiples of 1/16 (or small integers): every float sum is exact in any
order there, so equality is exact everywhere.  constant=0.3 is not dyadic
and pins the gain's operand order.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cuvite_tpu.kernels.heavy_bincount import heavy_argmax_pallas
from cuvite_tpu.kernels.row_argmax import row_argmax_pallas
from cuvite_tpu.louvain.bucketed import _row_argmax_sorted
from cuvite_tpu_torch.kernels.heavy_bincount import (
    HEAVY_CHUNK,
    build_heavy_layout,
    heavy_argmax,
)
from cuvite_tpu_torch.kernels.row_argmax import (
    SENTINEL,
    row_argmax,
    row_argmax_plain,
)
from test_torch_cuda import bucket_case as _bucket_case
from test_torch_cuda import hot_rows as _hot_rows
from test_torch_cuda import layout_from_dense as _layout_from_dense
from test_torch_cuda import vertex_tables as _tables
from test_torch_cuda import zero_tie as _zero_tie

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pallas_rows(cmat, wmat, curr, vdeg, sl, comm_deg, constant):
    ay = comm_deg[cmat]
    ax = comm_deg[curr] - vdeg
    out = row_argmax_pallas(
        jnp.asarray(np.ascontiguousarray(cmat.T)),
        jnp.asarray(np.ascontiguousarray(wmat.T)),
        jnp.asarray(np.ascontiguousarray(ay.T)),
        jnp.asarray(curr), jnp.asarray(vdeg), jnp.asarray(sl),
        jnp.asarray(ax), jnp.asarray(constant),
        sentinel=SENTINEL, tile_n=128, interpret=True)
    return [np.asarray(x) for x in out]


def _port_rows(cmat, wmat, curr, vdeg, sl, comm_deg, constant, deg=None):
    verts, comm, vd, slt = _tables(curr, vdeg, sl, len(comm_deg))
    out = row_argmax(torch.from_numpy(cmat), torch.from_numpy(wmat), verts,
                     comm, torch.from_numpy(comm_deg), vd, slt,
                     float(constant),
                     None if deg is None else torch.from_numpy(deg))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("width", [8, 32, 64, 256])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("constant", [None, np.float32(0.3)])
def test_row_twin_matches_pallas(width, seed, constant):
    n_rows, nv = 256, 500
    cmat, wmat, curr, vdeg, sl, comm_deg, dyadic = _bucket_case(
        n_rows, width, nv, seed)
    constant = dyadic if constant is None else constant
    ref = _pallas_rows(cmat, wmat, curr, vdeg, sl, comm_deg, constant)
    got = _port_rows(cmat, wmat, curr, vdeg, sl, comm_deg, constant)
    for name, r, g in zip(("best_c", "best_gain", "counter0"), ref, got):
        assert np.array_equal(r, g), name


def test_row_twin_matches_xla_sorted_wide():
    """Width 4096 lies above the reference's PALLAS_MAX_WIDTH; there the
    reference's rows take the XLA sorted path."""
    n_rows, width, nv = 32, 4096, 3000
    cmat, wmat, curr, vdeg, sl, comm_deg, _ = _bucket_case(
        n_rows, width, nv, 7)
    constant = np.float32(0.3)
    ay = comm_deg[cmat]
    ax = comm_deg[curr] - vdeg
    ref = _row_argmax_sorted(
        jnp.asarray(cmat), jnp.asarray(wmat), jnp.asarray(ay), None,
        jnp.asarray(curr), jnp.asarray(vdeg), jnp.asarray(sl),
        jnp.asarray(ax), jnp.asarray(constant), SENTINEL, id_bound=nv)
    got = _port_rows(cmat, wmat, curr, vdeg, sl, comm_deg, constant)
    assert np.array_equal(np.asarray(ref.best_c), got[0])
    assert np.array_equal(np.asarray(ref.best_gain), got[1])
    assert np.array_equal(np.asarray(ref.counter0), got[2])


def test_row_twin_no_candidates_and_padding_rows():
    """Rows whose every slot sits in the current community return the
    sentinel and -inf; padding rows (verts >= len(comm)) are computed
    against the last vertex, like the reference's clamped gather."""
    n_rows, width, nv = 128, 8, 50
    rng = np.random.default_rng(1)
    curr = rng.integers(0, nv, size=n_rows).astype(np.int32)
    cmat = np.repeat(curr[:, None], width, axis=1)
    wmat = np.ones((n_rows, width), dtype=np.float32)
    vdeg = np.ones(n_rows, dtype=np.float32)
    sl = np.zeros(n_rows, dtype=np.float32)
    comm_deg = np.ones(nv, dtype=np.float32)
    ref = _pallas_rows(cmat, wmat, curr, vdeg, sl, comm_deg,
                       np.float32(0.01))
    got = _port_rows(cmat, wmat, curr, vdeg, sl, comm_deg, np.float32(0.01))
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)
    assert np.all(got[0] == SENTINEL) and np.all(np.isneginf(got[1]))

    verts, comm, vd, slt = _tables(curr, vdeg, sl, nv)
    pad = torch.full((4,), comm.numel(), dtype=torch.int32)
    last = torch.full((4,), comm.numel() - 1, dtype=torch.int32)
    dst = torch.from_numpy(cmat[:4].copy())
    w = torch.from_numpy(wmat[:4].copy())
    a = row_argmax_plain(dst, w, pad, comm, torch.from_numpy(comm_deg), vd,
                         slt, 0.01)
    b = row_argmax_plain(dst, w, last, comm, torch.from_numpy(comm_deg), vd,
                         slt, 0.01)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("width", [8, 32, 64, 256])
@pytest.mark.parametrize("kind", ["random", "hot"])
def test_row_twin_with_degree_matches_pallas(width, kind):
    """Given the per-row degree, the twin gives what it gives on the full
    rows (padding slots past the degree: the row's own community, weight
    0), and both equal the Pallas kernel -- on random rows and on rows
    inside one or two communities.  Some rows have degree 0."""
    n_rows, nv = 128, 300
    if kind == "random":
        cmat, wmat, curr, vdeg, sl, comm_deg, _ = _bucket_case(
            n_rows, width, nv, width)
        rng = np.random.default_rng(width)
        deg = rng.integers(0, width + 1, n_rows).astype(np.int32)
        pad = np.arange(width)[None, :] >= deg[:, None]
    else:
        cmat, wmat, curr, vdeg, sl, comm_deg, pad, deg = _hot_rows(
            n_rows, width, width + 1, n_comm=nv)
    cmat = np.where(pad, curr[:, None], cmat).astype(np.int32)
    wmat = np.where(pad, 0.0, wmat).astype(np.float32)
    constant = np.float32(0.3)
    ref = _pallas_rows(cmat, wmat, curr, vdeg, sl, comm_deg, constant)
    full = _port_rows(cmat, wmat, curr, vdeg, sl, comm_deg, constant)
    short = _port_rows(cmat, wmat, curr, vdeg, sl, comm_deg, constant, deg)
    for name, r, f, d in zip(("best_c", "best_gain", "counter0"), ref, full,
                             short):
        assert np.array_equal(r, f) and np.array_equal(r, d), name


@pytest.mark.parametrize("width", [8, 64])
def test_row_twin_zero_gain_tie_matches_pallas(width):
    """Two candidates tie at gain exactly 0: the smaller id wins."""
    tie = _zero_tie(width)
    # 128 copies of the row: the Pallas kernel tiles rows by 128.
    cmat, wmat, curr, vdeg, sl = (np.repeat(a, 128, axis=0) for a in tie[:5])
    comm_deg = tie[5]
    constant = np.float32(1.0 / 64.0)
    ref = _pallas_rows(cmat, wmat, curr, vdeg, sl, comm_deg, constant)
    got = _port_rows(cmat, wmat, curr, vdeg, sl, comm_deg, constant)
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)
    assert np.all(got[0] == 3) and np.all(got[1] == 0.0)


def _pallas_heavy(cmat, wmat, curr, vdeg, sl, comm_deg_pad, constant,
                  c_tile, d_chunk):
    ax = comm_deg_pad[curr] - vdeg
    out = heavy_argmax_pallas(
        jnp.asarray(np.ascontiguousarray(cmat.T)),
        jnp.asarray(np.ascontiguousarray(wmat.T)),
        jnp.asarray(comm_deg_pad),
        jnp.asarray(curr), jnp.asarray(vdeg), jnp.asarray(sl),
        jnp.asarray(ax), jnp.asarray(constant),
        c_tile=c_tile, d_chunk=d_chunk, interpret=True)
    return [np.asarray(x) for x in out]


def _port_heavy(cmat, wmat, curr, vdeg, sl, comm_deg_pad, constant):
    n_comm = len(comm_deg_pad)
    lay = _layout_from_dense(cmat, wmat, n_comm)
    _, comm, vd, slt = _tables(curr, vdeg, sl, n_comm)
    out = heavy_argmax(lay, comm, torch.from_numpy(comm_deg_pad), vd, slt,
                       float(constant))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("constant", [None, np.float32(0.3)])
def test_heavy_twin_matches_pallas(seed, constant):
    n_rows, width, nv = 64, 512, 500
    nv_ceil, c_tile, d_chunk = 512, 128, 128
    cmat, wmat, curr, vdeg, sl, comm_deg, dyadic = _bucket_case(
        n_rows, width, nv, seed)
    constant = dyadic if constant is None else constant
    cdp = np.zeros(nv_ceil, dtype=np.float32)
    cdp[:nv] = comm_deg
    ref = _pallas_heavy(cmat, wmat, curr, vdeg, sl, cdp, constant, c_tile,
                        d_chunk)
    got = _port_heavy(cmat, wmat, curr, vdeg, sl, cdp, constant)
    for name, r, g in zip(("best_c", "best_gain", "counter0"), ref, got):
        assert np.array_equal(r, g), name


def test_heavy_twin_zero_weight_candidates():
    """A community reached only by w=0 edges is a candidate, and can win."""
    n_rows, width, nv = 16, 128, 120
    nv_ceil, c_tile, d_chunk = 128, 128, 128
    rng = np.random.default_rng(9)
    cmat = rng.integers(0, nv, size=(n_rows, width)).astype(np.int32)
    wmat = (rng.integers(0, 4, size=(n_rows, width)) / 16.0).astype(
        np.float32)
    curr = rng.integers(0, nv, size=n_rows).astype(np.int32)
    vdeg = np.maximum(wmat.sum(axis=1), 0.25).astype(np.float32)
    sl = np.zeros(n_rows, dtype=np.float32)
    cdp = np.zeros(nv_ceil, dtype=np.float32)
    cdp[:nv] = (rng.integers(1, 64, size=nv) / 8.0).astype(np.float32)
    const = np.float32(1.0 / 16.0)
    ref = _pallas_heavy(cmat, wmat, curr, vdeg, sl, cdp, const, c_tile,
                        d_chunk)
    got = _port_heavy(cmat, wmat, curr, vdeg, sl, cdp, const)
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)

    # One hub, curr=0, no edge into it: community 1 via w=0 (tiny degree,
    # positive gain) beats community 2 via w=0.5 (huge degree).
    one = np.full((1, 128), nv_ceil, dtype=np.int32)
    onew = np.zeros((1, 128), dtype=np.float32)
    one[0, 0], onew[0, 0] = 1, 0.0
    one[0, 1], onew[0, 1] = 2, 0.5
    cd1 = np.ones(nv_ceil, dtype=np.float32)
    cd1[1], cd1[2] = 0.125, 40.0
    args = (one, onew, np.array([0], np.int32), np.array([0.5], np.float32),
            np.array([0.0], np.float32), cd1, np.float32(1 / 16))
    ref = _pallas_heavy(*args, c_tile, d_chunk)
    got = _port_heavy(*args)
    assert int(got[0][0]) == 1
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)


def test_heavy_twin_padding_and_no_candidates():
    n_rows, width = 8, 256
    nv, nv_ceil, c_tile, d_chunk = 100, 128, 128, 128
    rng = np.random.default_rng(2)
    curr = rng.integers(0, nv, size=n_rows).astype(np.int32)
    cmat = np.full((n_rows, width), nv_ceil, dtype=np.int32)
    wmat = np.zeros((n_rows, width), dtype=np.float32)
    cmat[:, : width // 2] = curr[:, None]
    wmat[:, : width // 2] = 0.5
    vdeg = np.ones(n_rows, dtype=np.float32)
    sl = np.zeros(n_rows, dtype=np.float32)
    cdp = np.ones(nv_ceil, dtype=np.float32)
    ref = _pallas_heavy(cmat, wmat, curr, vdeg, sl, cdp, np.float32(0.01),
                        c_tile, d_chunk)
    got = _port_heavy(cmat, wmat, curr, vdeg, sl, cdp, np.float32(0.01))
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)
    assert np.all(got[0] == SENTINEL) and np.all(np.isneginf(got[1]))
    assert np.all(got[2] == 0.5 * (width // 2))


def test_build_heavy_layout_contract():
    nv_local = 64
    hs = np.array([3, 3, 3, 3, 7, 7, 64, 64], np.int64)
    hd = np.array([10, 11, 12, 13, 20, 21, 0, 0], np.int64)
    hw = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 0, 0], np.float32)
    lay = build_heavy_layout(hs, hd, hw, nv_local=nv_local)
    assert lay.verts.tolist() == [3, 7]
    assert lay.offsets.tolist() == [0, 4, 6]
    assert lay.dst.tolist() == [10, 11, 12, 13, 20, 21]
    assert lay.w.tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    # next_pow2(2 * degree) table slots per hub.
    assert lay.table_offsets.tolist() == [0, 8, 12]
    assert lay.table_size == 12
    # One chunk per hub at these degrees.
    assert lay.chunk_offsets.tolist() == [0, 4, 6]
    assert lay.chunk_hub.tolist() == [0, 1]
    assert lay.hub_chunks.tolist() == [0, 1, 2]
    assert lay.max_chunk == 4 and lay.scratch is None
    empty = np.full(8, nv_local, np.int64)
    assert build_heavy_layout(empty, hd, hw, nv_local=nv_local) is None


def _chunk_table_ok(lay, degrees):
    """The chunk table's contract against the hub degrees."""
    off = lay.offsets.numpy()
    coff = lay.chunk_offsets.numpy()
    chub = lay.chunk_hub.numpy()
    hch = lay.hub_chunks.numpy()
    lens = np.diff(coff)
    assert np.array_equal(np.diff(off), degrees)
    assert coff[0] == 0 and coff[-1] == off[-1] and np.all(lens >= 1)
    assert lens.max() <= HEAVY_CHUNK and lay.max_chunk == lens.max()
    assert lay.num_chunks == len(chub) == len(coff) - 1 == hch[-1]
    for h, d in enumerate(degrees):
        ks = np.arange(hch[h], hch[h + 1])
        assert len(ks) == -(-d // HEAVY_CHUNK)
        assert np.all(chub[ks] == h) and np.all(np.diff(chub) >= 0)
        # The hub's chunks tile its edge range exactly, none outside it.
        assert coff[ks[0]] == off[h] and coff[ks[-1] + 1] == off[h + 1]
        assert np.all(lens[ks[:-1]] == HEAVY_CHUNK)


@pytest.mark.parametrize("degrees", [[8193], [4096, 8192, 3 * 4096],
                                     [1 << 18], [1, 4095, 4097, 8193, 5]])
def test_heavy_layout_chunk_table(degrees):
    degrees = np.array(degrees)
    n_hubs = len(degrees)
    nv_local = 100
    # Hubs listed out of order, with padding triples (src == nv_local).
    hubs = np.array([7, 3, 50, 9, 60])[:n_hubs]
    src = np.concatenate([np.repeat(hubs, degrees),
                          np.full(8, nv_local)])
    rng = np.random.default_rng(len(src))
    dst = rng.integers(0, nv_local, len(src))
    w = rng.integers(0, 4, len(src)).astype(np.float32)
    lay = build_heavy_layout(src, dst, w, nv_local=nv_local)
    order = np.argsort(hubs, kind="stable")
    assert lay.verts.tolist() == sorted(hubs.tolist())
    _chunk_table_ok(lay, degrees[order])
    # Within-hub edge order is kept.
    for k, h in enumerate(order):
        first = int(np.sum(degrees[:h]))
        a, b = int(lay.offsets[k]), int(lay.offsets[k + 1])
        assert np.array_equal(lay.dst.numpy()[a:b],
                              dst[first:first + degrees[h]])
    on_cpu = lay.to("cpu")
    assert on_cpu.scratch is None and on_cpu.num_chunks == lay.num_chunks


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "width"])
def test_row_argmax_rejects_bad_inputs(bad):
    cmat, wmat, curr, vdeg, sl, comm_deg, c = _bucket_case(4, 8, 20, 0)
    verts, comm, vd, slt = _tables(curr, vdeg, sl, 20)
    dst, w = torch.from_numpy(cmat), torch.from_numpy(wmat)
    cd = torch.from_numpy(comm_deg)
    if bad == "dtype":
        dst = dst.long()
    elif bad == "shape":
        w = w[:, :4].contiguous()
    elif bad == "device":
        cd = cd.to("meta")
    else:
        dst = torch.zeros((4, 8200), dtype=torch.int32)
        w = torch.zeros((4, 8200))
    with pytest.raises(ValueError):
        row_argmax(dst, w, verts, comm, cd, vd, slt, float(c))
