"""cuvite_tpu_torch's hand-written CUDA kernels against their plain PyTorch
twins, on a card.  Every test here needs a CUDA device and skips without
one; the file imports neither JAX nor cuvite_tpu, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The row and hub cases below are shared with tests/test_torch_kernels.py,
the slab case with tests/test_torch_seg_coalesce.py.
"""

import numpy as np
import pytest
import torch

from cuvite_tpu_torch.kernels.heavy_bincount import (
    HEAVY_CHUNK,
    build_heavy_layout,
    heavy_argmax,
    heavy_argmax_plain,
)
from cuvite_tpu_torch.kernels.row_argmax import row_argmax, row_argmax_plain
from cuvite_tpu_torch.kernels.seg_coalesce import (
    seg_coalesce,
    seg_coalesce_plain,
)


def bucket_case(n_rows, width, nv, seed):
    """The rows of tests/test_kernels.py::_bucket_case: communities in
    [0, nv), weights multiples of 1/16 (exact float sums in any order)."""
    rng = np.random.default_rng(seed)
    cmat = rng.integers(0, nv, size=(n_rows, width)).astype(np.int32)
    wmat = (rng.integers(1, 32, size=(n_rows, width)) / 16.0).astype(
        np.float32)
    curr = rng.integers(0, nv, size=n_rows).astype(np.int32)
    cmat[: n_rows // 2, 0] = curr[: n_rows // 2]
    vdeg = (rng.integers(1, 64, size=n_rows) / 4.0).astype(np.float32)
    sl = np.where(cmat[:, 0] == curr, wmat[:, 0] / 2.0, 0.0).astype(
        np.float32)
    comm_deg = (rng.integers(1, 256, size=nv) / 8.0).astype(np.float32)
    return cmat, wmat, curr, vdeg, sl, comm_deg, np.float32(1.0 / 64.0)


def vertex_tables(curr, vdeg, sl, n_comm):
    """Per-vertex tables for the port's gather-inside signature: vertices
    [0, n_comm) are the neighbours, each its own community; row r is vertex
    n_comm + r, in community curr[r], with vdeg[r] and self-loop sl[r].
    Then comm[dst] == cmat and the per-row curr/vdeg/sl are those given.
    Returns (verts, comm, vdeg, self_loop) tensors."""
    n_rows = len(curr)
    comm = np.concatenate([np.arange(n_comm), curr]).astype(np.int32)
    vd = np.concatenate([np.zeros(n_comm), vdeg]).astype(np.float32)
    slt = np.concatenate([np.zeros(n_comm), sl]).astype(np.float32)
    verts = (n_comm + np.arange(n_rows)).astype(np.int32)
    return (torch.from_numpy(verts), torch.from_numpy(comm),
            torch.from_numpy(vd), torch.from_numpy(slt))


def layout_from_dense(cmat, wmat, n_comm):
    """Hub layout of dense hub rows: row r is hub vertex n_comm + r, and
    its slots with cmat < n_comm are its edges (the rest is padding)."""
    n_rows, width = cmat.shape
    hub = np.repeat(n_comm + np.arange(n_rows), width)
    real = cmat.reshape(-1) < n_comm
    n_total = n_comm + n_rows
    return build_heavy_layout(np.where(real, hub, n_total),
                              cmat.reshape(-1), wmat.reshape(-1),
                              nv_local=n_total)


def hot_rows(n_rows, width, seed, n_comm=64):
    """Rows whose slots all fall in one community (even rows) or two (odd
    rows) of [0, n_comm), row degrees in (width/2, width] and padding past
    them (community = the row's own, weight 0); a quarter of the rows sit
    in their hot community.  Shaped like bucket_case's outputs plus the
    row degrees."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_comm, n_rows)
    b = rng.integers(0, n_comm, n_rows)
    two = (np.arange(n_rows) % 2 == 1)[:, None]
    cmat = np.where(two & (rng.random((n_rows, width)) < 0.5), b[:, None],
                    a[:, None]).astype(np.int32)
    curr = rng.integers(0, n_comm, n_rows).astype(np.int32)
    curr[::4] = a[::4]
    deg = rng.integers(width // 2 + 1, width + 1, n_rows).astype(np.int32)
    pad = np.arange(width)[None, :] >= deg[:, None]
    wmat = (rng.integers(0, 8, (n_rows, width)) / 4.0).astype(np.float32)
    wmat[pad] = 0.0
    vdeg = (rng.integers(1, 64, n_rows) / 4.0).astype(np.float32)
    sl = np.zeros(n_rows, np.float32)
    comm_deg = (rng.integers(1, 4096, n_comm) / 8.0).astype(np.float32)
    return cmat, wmat, curr, vdeg, sl, comm_deg, pad, deg


def zero_tie(width):
    """One row (or hub) whose two best candidates tie at gain exactly 0:
    zero-weight edges into communities 5 (first) and 3, whose degree 6
    equals ax = comm_deg[curr] - vdeg = 10 - 4, and into 9 (degree 100,
    negative gain); nothing into the current community 15.  3 must win.
    Returns bucket_case-shaped arrays over 16 communities."""
    cmat = np.full((1, width), 15, np.int32)
    cmat[0, :6] = [5, 3, 9, 5, 3, 9]
    wmat = np.zeros((1, width), np.float32)
    comm_deg = np.full(16, 6.0, np.float32)
    comm_deg[9], comm_deg[15] = 100.0, 10.0
    return (cmat, wmat, np.array([15], np.int32),
            np.array([4.0], np.float32), np.zeros(1, np.float32), comm_deg)


def coalesce_case(nv_pad, ne_pad, seed, gapped=False, weights="dyadic"):
    """A relabeled slab shaped like tests/test_seg_coalesce.py::_slab:
    real rows in a prefix, padding (src == nv_pad, dst == 0, w == 0)
    after; the first eighth of the real rows are self-loops (heavy
    self-loop runs), 37 real rows weigh 0.  ``gapped``: ids from a sparse
    subset of the space.  ``weights``: 'dyadic' (multiples of 1/8, every
    run sum exact in f32) or 'float' (distances in (0, 0.01), as RGG
    weights are).  Returns numpy (src, dst, w)."""
    rng = np.random.default_rng(seed)
    n_real = ne_pad - ne_pad // 5
    pool = (rng.choice(nv_pad, size=max(nv_pad // 11, 2), replace=False)
            if gapped else np.arange(nv_pad))
    src = np.full(ne_pad, nv_pad, np.int32)
    dst = np.zeros(ne_pad, np.int32)
    w = np.zeros(ne_pad, np.float32)
    src[:n_real] = rng.choice(pool, size=n_real)
    dst[:n_real] = rng.choice(pool, size=n_real)
    src[: n_real // 8] = dst[: n_real // 8]
    if weights == "dyadic":
        w[:n_real] = rng.integers(1, 64, n_real) / 8.0
    else:
        w[:n_real] = rng.uniform(1e-4, 1e-2, n_real)
    w[n_real // 2: n_real // 2 + 37] = 0.0
    return src, dst, w


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16, 32, 64, 384, 2048, 8192])
def test_row_kernel_matches_twin_on_card(cuda_device, width):
    n_rows = 64 if width >= 2048 else 512
    cmat, wmat, curr, vdeg, sl, comm_deg, _ = bucket_case(
        n_rows, width, 700, width)
    verts, comm, vd, slt = vertex_tables(curr, vdeg, sl, 700)
    args = [torch.from_numpy(cmat), torch.from_numpy(wmat), verts, comm,
            torch.from_numpy(comm_deg), vd, slt]
    ref = row_argmax_plain(*args, 0.3)
    got = row_argmax(*[a.to(cuda_device) for a in args], 0.3)
    torch.cuda.synchronize()
    for r, g in zip(ref, got):
        assert torch.equal(r, g.cpu())


def _rows_on_card(cmat, wmat, curr, vdeg, sl, comm_deg, constant, deg,
                  dev):
    """Kernel on the card and twin on the CPU, both given ``deg``."""
    n_comm = len(comm_deg)
    verts, comm, vd, slt = vertex_tables(curr, vdeg, sl, n_comm)
    args = [torch.from_numpy(cmat), torch.from_numpy(wmat), verts, comm,
            torch.from_numpy(comm_deg), vd, slt]
    d = None if deg is None else torch.from_numpy(deg)
    ref = row_argmax_plain(*args, constant, d)
    got = row_argmax(*[a.to(dev) for a in args], constant,
                     None if d is None else d.to(dev))
    torch.cuda.synchronize()
    return [g.cpu() for g in got], ref


@pytest.mark.cuda
@pytest.mark.parametrize("width", [16, 64, 512, 768, 8192])
def test_row_kernel_hot_key_and_short_rows_on_card(cuda_device, width):
    """Rows inside one or two communities, shorter than their class: with
    the per-row degree, without it (the full width, padding included), and
    the twin without it -- all bit-equal."""
    n_rows = 32 if width >= 768 else 256
    cmat, wmat, curr, vdeg, sl, comm_deg, pad, deg = hot_rows(
        n_rows, width, width)
    cmat = np.where(pad, 64 + np.arange(n_rows)[:, None], cmat).astype(
        np.int32)   # padding slots: the row's own vertex
    full, ref = _rows_on_card(cmat, wmat, curr, vdeg, sl, comm_deg, 0.3,
                              None, cuda_device)
    short, ref_d = _rows_on_card(cmat, wmat, curr, vdeg, sl, comm_deg, 0.3,
                                 deg, cuda_device)
    for a, b, c, d in zip(full, ref, short, ref_d):
        assert torch.equal(a, b) and torch.equal(c, d) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 64, 1536])
def test_row_kernel_zero_gain_tie_on_card(cuda_device, width):
    cmat, wmat, curr, vdeg, sl, comm_deg = zero_tie(width)
    got, ref = _rows_on_card(cmat, wmat, curr, vdeg, sl, comm_deg,
                             1.0 / 64.0, None, cuda_device)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int(got[0][0]) == 3 and float(got[1][0]) == 0.0


def _hubs_on_card(cmat, wmat, curr, vdeg, sl, comm_deg, constant, dev):
    """Heavy kernel twice in a row on the card, twin on the CPU; the
    scratch must be clean after each launch."""
    n_comm = len(comm_deg)
    lay = layout_from_dense(cmat, wmat, n_comm)
    _, comm, vd, slt = vertex_tables(curr, vdeg, sl, n_comm)
    cd = torch.from_numpy(comm_deg)
    ref = heavy_argmax_plain(lay, comm, cd, vd, slt, constant)
    dlay = lay.to(dev)
    tabs = [t.to(dev) for t in (comm, cd, vd, slt)]
    for _ in range(2):
        got = heavy_argmax(dlay, *tabs, constant)
        torch.cuda.synchronize()
        for r, g in zip(ref, got):
            assert torch.equal(r, g.cpu())
        assert dlay.scratch.is_clean()
    return [g.cpu() for g in got]


@pytest.mark.cuda
def test_heavy_kernel_hot_key_hubs_on_card(cuda_device):
    """Hubs inside one or two communities, over several chunks each."""
    cmat, wmat, curr, vdeg, sl, comm_deg, pad, _ = hot_rows(
        8, 3 * HEAVY_CHUNK + 5, 7)
    cmat = np.where(pad, len(comm_deg), cmat).astype(np.int32)
    _hubs_on_card(cmat, wmat, curr, vdeg, sl, comm_deg, 0.3, cuda_device)


@pytest.mark.cuda
def test_heavy_kernel_multi_chunk_hub_on_card(cuda_device):
    """A hub of 2^18 edges (64 chunks) beside hubs of 8193 and 4096*3."""
    rng = np.random.default_rng(3)
    width, n_comm = 1 << 18, 5000
    cmat = rng.integers(0, n_comm, (3, width)).astype(np.int32)
    cmat[1, 8193:] = n_comm
    cmat[2, 3 * HEAVY_CHUNK:] = n_comm
    wmat = (rng.integers(0, 16, (3, width)) / 16.0).astype(np.float32)
    comm_deg = (rng.integers(1, 1 << 12, n_comm) / 8.0).astype(np.float32)
    _hubs_on_card(cmat, wmat, np.array([0, 1, 2], np.int32),
                  np.array([300.0, 20.0, 12.0], np.float32),
                  np.array([1.0, 0.0, 0.5], np.float32), comm_deg, 0.3,
                  cuda_device)


@pytest.mark.cuda
def test_heavy_kernel_zero_gain_tie_on_card(cuda_device):
    cmat, wmat, curr, vdeg, sl, comm_deg = zero_tie(12000)
    cmat[0, :] = np.tile(np.array([5, 3, 9], np.int32), 4000)
    got = _hubs_on_card(cmat, wmat, curr, vdeg, sl, comm_deg, 1.0 / 64.0,
                        cuda_device)
    assert int(got[0][0]) == 3 and float(got[1][0]) == 0.0


@pytest.mark.cuda
def test_heavy_kernel_matches_twin_on_card(cuda_device):
    cmat, wmat, curr, vdeg, sl, comm_deg, _ = bucket_case(8, 12000, 3000, 4)
    lay = layout_from_dense(cmat, wmat, 3000)
    _, comm, vd, slt = vertex_tables(curr, vdeg, sl, 3000)
    cd = torch.from_numpy(comm_deg)
    ref = heavy_argmax_plain(lay, comm, cd, vd, slt, 0.3)
    got = heavy_argmax(lay.to(cuda_device), comm.to(cuda_device),
                       cd.to(cuda_device), vd.to(cuda_device),
                       slt.to(cuda_device), 0.3)
    torch.cuda.synchronize()
    for r, g in zip(ref, got):
        assert torch.equal(r, g.cpu())


@pytest.mark.cuda
def test_louvain_on_card_matches_cpu(cuda_device):
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rmat

    g = generate_rmat(12)
    rg = louvain_phases(g, device=cuda_device)
    rc = louvain_phases(g, device="cpu")
    assert np.array_equal(rg.communities, rc.communities)
    assert rg.total_iterations == rc.total_iterations
    assert abs(rg.modularity - rc.modularity) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("nv_pad", [64, 1024, 4096])
@pytest.mark.parametrize("weights", ["dyadic", "float"])
def test_seg_coalesce_kernel_matches_twin_on_card(cuda_device, nv_pad,
                                                  weights):
    """The kernel sums each slot in f64 with atomics: the run sums of
    these slabs are exact in f64, so acc and cnt are bit-equal to the
    twin's sequential sums, float weights included."""
    arrs = [torch.from_numpy(a) for a in
            coalesce_case(nv_pad, 16384, nv_pad, gapped=nv_pad == 1024,
                          weights=weights)]
    ref = seg_coalesce_plain(*arrs, nv_pad=nv_pad)
    got = seg_coalesce(*[a.to(cuda_device) for a in arrs], nv_pad=nv_pad)
    torch.cuda.synchronize()
    for r, g in zip(ref, got):
        assert torch.equal(r, g.cpu())


@pytest.mark.cuda
def test_sort_engine_on_card_matches_cpu(cuda_device):
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rgg

    g = generate_rgg(16384)
    rg = louvain_phases(g, device=cuda_device, engine="sort")
    rc = louvain_phases(g, device="cpu", engine="sort")
    assert np.array_equal(rg.communities, rc.communities)
    assert [p.iterations for p in rg.phases] == \
        [p.iterations for p in rc.phases]
    assert abs(rg.modularity - rc.modularity) <= 1e-9
    assert "dense" in [p.coalesce for p in rg.phases]
