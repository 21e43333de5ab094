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
from cuvite_tpu_torch.kernels.row_argmax import (
    row_argmax,
    row_argmax_plain,
    row_argmax_sized,
    row_argmax_sized_plain,
)
from cuvite_tpu_torch.kernels.seg_coalesce import (
    seg_coalesce,
    seg_coalesce_plain,
)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread while a module's tests run.  Under pytest-xdist
    each worker is its own process with its own torch, and torch's
    default of one OpenMP thread per core in each of six workers on eight
    cores makes them spin against each other: the port's CPU test files
    ran several times slower so.  The thread count is restored after the
    module; results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def sized_case(n_rows, width, seed, nv=600, n_ghost=300, n_comm=None):
    """Rows of the row kernel's size form (the sparse exchange's record
    tables): ``nv`` owned vertices and ``n_ghost`` ghosts; every one of
    them carries a community in [0, n_comm) and that community's degree
    and size (a quarter of the communities are singletons), so rows hold
    duplicates and the guard's size-1 case.  Row r is owned vertex r,
    its degree random in [1, width] with padding slots past it (the row's
    own vertex, weight 0); rows 0-3 reach only their own community (no
    candidate).  Weights are multiples of 1/16, the constant dyadic.
    Returns (dst, w, verts, comm_ext, cdeg_ext, csize_ext, cdeg_v, vdeg,
    self_loop, deg) as numpy and the constant."""
    rng = np.random.default_rng(seed)
    n_ext = nv + n_ghost
    n_comm = n_comm or max(width // 2, 8)
    comm_ext = rng.integers(0, n_comm, n_ext).astype(np.int32)
    cdeg_tab = (rng.integers(1, 256, n_comm) / 8.0).astype(np.float32)
    size_tab = np.where(rng.random(n_comm) < 0.25, 1,
                        rng.integers(2, 50, n_comm)).astype(np.int32)
    cdeg_ext, csize_ext = cdeg_tab[comm_ext], size_tab[comm_ext]
    verts = np.arange(n_rows, dtype=np.int32)
    deg = rng.integers(1, width + 1, n_rows).astype(np.int32)
    dst = rng.integers(0, n_ext, (n_rows, width)).astype(np.int32)
    same = np.nonzero(comm_ext == comm_ext[0])[0]
    for r in range(min(4, n_rows)):
        comm_ext[r] = comm_ext[0]
        dst[r] = rng.choice(same, width)
        deg[r] = width
    cdeg_ext, csize_ext = cdeg_tab[comm_ext], size_tab[comm_ext]
    slot = np.arange(width)[None, :]
    dst = np.where(slot < deg[:, None], dst, verts[:, None]).astype(np.int32)
    w = (rng.integers(0, 32, (n_rows, width)) / 16.0).astype(np.float32)
    w[slot >= deg[:, None]] = 0.0
    vdeg = (rng.integers(1, 64, nv) / 4.0).astype(np.float32)
    sl = (rng.integers(0, 3, nv) / 2.0).astype(np.float32)
    return ((dst, w, verts, comm_ext, cdeg_ext, csize_ext,
             np.ascontiguousarray(cdeg_ext[:nv]), vdeg, sl, deg),
            np.float32(1.0 / 64.0))


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


def hot_src_slab(nv_pad, ne_pad, seed, n_dst=40, all_hot=False):
    """A relabeled slab where one src (11) holds two thirds of the real
    rows (``all_hot``: all of them) -- the late phase where one community
    absorbs most vertices -- a third of them its self-loop run, the rest
    to ``n_dst`` ids spread over [0, nv_pad); the other real rows random;
    dyadic weights, zeros among them; padding after, then every row
    shuffled.  Returns numpy (src, dst, w)."""
    rng = np.random.default_rng(seed)
    n_real = ne_pad - ne_pad // 7
    n_hot = n_real if all_hot else 2 * n_real // 3
    src = np.full(ne_pad, nv_pad, np.int32)
    dst = np.zeros(ne_pad, np.int32)
    w = np.zeros(ne_pad, np.float32)
    src[:n_real] = rng.integers(0, nv_pad, n_real)
    dst[:n_real] = rng.integers(0, nv_pad, n_real)
    src[:n_hot] = 11
    dst[:n_hot] = rng.choice(nv_pad, n_dst, replace=False)[
        rng.integers(0, n_dst, n_hot)]
    dst[: n_hot // 3] = 11
    w[:n_real] = rng.integers(0, 16, n_real) / 4.0
    perm = rng.permutation(ne_pad)
    return src[perm], dst[perm], w[perm]


def folded_case(n_tenants, nv_pad, n_rows, width, seed):
    """A folded batch's tables (tenant b's vertex v at b * nv_pad + v):
    rows of every tenant whose slots stay in their tenant, the first
    quarter of them hot (all slots in the row's own community or one
    other), and a per-tenant constant tensor, none of them dyadic but the
    last tenant's, whose rows tie at gain zero.  Returns (dst, w, verts,
    comm, comm_deg, vdeg, self_loop, constants) tensors."""
    rng = np.random.default_rng(seed)
    nv = n_tenants * nv_pad
    tenant_of = np.repeat(np.arange(n_tenants), nv_pad)
    comm = (rng.integers(0, nv_pad, nv) + tenant_of * nv_pad).astype(
        np.int32)
    comm_deg = (rng.integers(1, 256, nv) / 8.0).astype(np.float32)
    vdeg = (rng.integers(1, 64, nv) / 4.0).astype(np.float32)
    sl = np.where(rng.random(nv) < 0.2, 0.5, 0.0).astype(np.float32)
    verts = rng.integers(0, nv, n_rows).astype(np.int32)
    base = (verts // nv_pad * nv_pad)[:, None]
    dst = (base + rng.integers(0, nv_pad, (n_rows, width))).astype(np.int32)
    hot = n_rows // 4
    pick = rng.integers(0, 2, (hot, width)).astype(bool)
    dst[:hot] = np.where(pick, verts[:hot, None], dst[:hot, :1])
    w = (rng.integers(1, 32, (n_rows, width)) / 16.0).astype(np.float32)
    consts = np.array([0.3, 1 / 3000, 0.7, 0.0][:n_tenants]
                      + [1 / 997] * max(n_tenants - 4, 0), np.float32)
    return [torch.from_numpy(a) for a in
            (dst, w, verts, comm, comm_deg, vdeg, sl, consts)]


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
@pytest.mark.parametrize("width", [8, 16, 32, 64, 256, 384, 2048, 8192])
def test_row_kernel_size_form_matches_twin_on_card(cuda_device, width):
    """The size form against its twin, with and without the row degrees:
    targets, gains, counter0 and best_size bit-equal; the no-candidate
    rows return the sentinel size."""
    n_rows = 32 if width >= 2048 else 256
    arrs, c = sized_case(n_rows, width, width)
    t = [torch.from_numpy(a) for a in arrs[:9]]
    deg = torch.from_numpy(arrs[9])
    n = row_argmax_sized.launches
    for d in (None, deg):
        ref = row_argmax_sized_plain(*t, float(c), d)
        got = row_argmax_sized(*[a.to(cuda_device) for a in t], float(c),
                               None if d is None else d.to(cuda_device))
        torch.cuda.synchronize()
        for r, g in zip(ref, got):
            g = g.cpu()
            if g.dtype == torch.float32:
                g, r = g.view(torch.int32), r.view(torch.int32)
            assert torch.equal(r, g)
        assert (got[3][:4].cpu() == 2**31 - 1).all()
    assert row_argmax_sized.launches == n + 2


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["replicated", "sparse"])
def test_mesh_on_one_card_matches_cpu(cuda_device, exchange):
    """Four shards on one card against four on the CPU and one shard on
    the card: identical labels and sweeps; the sparse run launches the
    size form."""
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.io.generate import generate_rmat

    g = generate_rmat(11)
    n = row_argmax_sized.launches
    rg = louvain_phases(g, mesh=make_mesh(devices=[cuda_device] * 4),
                        exchange=exchange)
    rc = louvain_phases(g, nshards=4, device="cpu", exchange=exchange)
    r1 = louvain_phases(g, device=cuda_device)
    for r in (rc, r1):
        assert np.array_equal(rg.communities, r.communities)
        assert [p.iterations for p in rg.phases] == \
            [p.iterations for p in r.phases]
        assert abs(rg.modularity - r.modularity) <= 1e-9
    assert (row_argmax_sized.launches > n) == (exchange == "sparse")


@pytest.fixture
def cards():
    """Every visible card; skips with fewer than two."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_card(cards):
    """With card 0 current, every wrapper launches on the card its tensors
    are on (the last one) and agrees with its twin there: the row kernel
    in both forms, the heavy kernel and seg_coalesce."""
    dev = cards[-1]
    torch.cuda.set_device(cards[0])
    cmat, wmat, curr, vdeg, sl, comm_deg, _ = bucket_case(512, 384, 700, 7)
    got, ref = _rows_on_card(cmat, wmat, curr, vdeg, sl, comm_deg, 0.3, None,
                             dev)
    for r, g in zip(ref, got):
        assert torch.equal(r, g)
    arrs, c = sized_case(256, 2048, 11)
    t = [torch.from_numpy(a) for a in arrs[:9]]
    ref = row_argmax_sized_plain(*t, float(c))
    got = row_argmax_sized(*[a.to(dev) for a in t], float(c))
    for r, g in zip(ref, got):
        assert torch.equal(r, g.cpu())
    cmat, wmat, curr, vdeg, sl, comm_deg, _ = bucket_case(8, 12000, 3000, 4)
    lay = layout_from_dense(cmat, wmat, 3000)
    _, comm, vd, slt = vertex_tables(curr, vdeg, sl, 3000)
    cd = torch.from_numpy(comm_deg)
    ref = heavy_argmax_plain(lay, comm, cd, vd, slt, 0.3)
    got = heavy_argmax(lay.to(dev), comm.to(dev), cd.to(dev), vd.to(dev),
                       slt.to(dev), 0.3)
    for r, g in zip(ref, got):
        assert torch.equal(r, g.cpu())
    slab = [torch.from_numpy(a)[None] for a in
            coalesce_case(1024, 16384, 1024, gapped=True, weights="dyadic")]
    coalesce_on_card(dev, slab, nv_pad=1024, grid=1024)
    torch.cuda.synchronize(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["replicated", "sparse"])
def test_mesh_across_cards_matches_one_card(cards, exchange):
    """One shard per card (``make_mesh(n)``, up to four cards) against the
    same shards all on card 0 and against one shard: identical labels and
    sweeps."""
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.io.generate import generate_rmat

    n = min(len(cards), 4)
    g = generate_rmat(12)
    mesh = make_mesh(n)
    assert list(mesh.devices) == cards[:n]
    rm = louvain_phases(g, mesh=mesh, exchange=exchange)
    r0 = louvain_phases(g, mesh=make_mesh(devices=[cards[0]] * n),
                        exchange=exchange)
    r1 = louvain_phases(g, device=cards[0])
    for r in (r0, r1):
        assert np.array_equal(rm.communities, r.communities)
        assert [p.iterations for p in rm.phases] == \
            [p.iterations for p in r.phases]
        assert abs(rm.modularity - r.modularity) <= 1e-9


def _class_mesh_graph():
    """A 9,000-vertex graph with one hub of degree 8,400 (above the widest
    bucket) and random color classes over 4 shards, one of them with no
    vertex of class 3 on shard 1."""
    from cuvite_tpu_torch import Graph
    from cuvite_tpu_torch.core.distgraph import DistGraph

    rng = np.random.default_rng(3)
    nv = 9000
    src = np.concatenate([np.zeros(8400, np.int64),
                          rng.integers(1, nv, 12000)])
    dst = np.concatenate([rng.choice(np.arange(1, nv), 8400, replace=False),
                          rng.integers(1, nv, 12000)])
    dg = DistGraph.build(Graph.from_edges(nv, src, dst), 4)
    cls = rng.integers(0, 4, dg.total_padded_vertices).astype(np.int32)
    cls[dg.nv_pad:2 * dg.nv_pad][cls[dg.nv_pad:2 * dg.nv_pad] == 3] = 2
    return dg, cls


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["replicated", "sparse"])
def test_mesh_class_sweep_on_card_matches_cpu(cuda_device, exchange):
    """Four shards on one card against four on the CPU: two iterations of
    the color schedule's class sweep (refreshed tables, then vertex
    ordering's frozen ones), targets bit-equal and Q, moves and overflow
    equal, with a class empty on one shard and the hub on the heavy
    kernel (replicated) or the sorted path (sparse); then ET mode 3 and
    coloring 8 through louvain_phases, card against CPU and one shard."""
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.louvain.driver import MeshPhaseRunner

    dg, cls = _class_mesh_graph()
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        mesh = make_mesh(devices=[dev] * 4)
        out = []
        for ordering in (False, True):
            r = MeshPhaseRunner(dg, mesh, exchange=exchange,
                                classes=(cls, 4), ordering=ordering)
            comms = r.comm0
            for _ in range(2):
                t, q, moved, ovf = r.class_sweep(comms)
                out.append((torch.cat([x.cpu() for x in t]), float(q),
                            int(moved), bool(ovf)))
                comms = t
        runs[dev.type] = out
    for (tg, qg, mg, og), (tc, qc, mc, oc) in zip(runs["cuda"], runs["cpu"]):
        assert torch.equal(tg, tc)
        assert (qg, mg, og) == (qc, mc, oc) and mg > 0
    n = row_argmax_sized.launches
    g = generate_rmat(11)
    for kw in ({"et_mode": 3}, {"coloring": 8}):
        rg = louvain_phases(g, mesh=make_mesh(devices=[cuda_device] * 4),
                            exchange=exchange, **kw)
        for r in (louvain_phases(g, nshards=4, device="cpu",
                                 exchange=exchange, **kw),
                  louvain_phases(g, device=cuda_device, **kw)):
            assert np.array_equal(rg.communities, r.communities)
            assert [p.iterations for p in rg.phases] == \
                [p.iterations for p in r.phases]
    assert (row_argmax_sized.launches > n) == (exchange == "sparse")


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["replicated", "sparse"])
def test_mesh_schedules_across_cards_match_one_card(cards, exchange):
    """One shard per card (up to four) with ET mode 3, coloring 8 and
    vertex ordering 8 against one shard: identical labels and sweeps."""
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.io.generate import generate_rmat

    n = min(len(cards), 4)
    g = generate_rmat(12)
    for kw in ({"et_mode": 3}, {"coloring": 8}, {"vertex_ordering": 8}):
        rm = louvain_phases(g, mesh=make_mesh(n), exchange=exchange, **kw)
        r1 = louvain_phases(g, device=cards[0], **kw)
        assert np.array_equal(rm.communities, r1.communities), kw
        assert [p.iterations for p in rm.phases] == \
            [p.iterations for p in r1.phases]


@pytest.mark.cuda
def test_twolevel_on_one_card_matches_cpu(cuda_device):
    """A 2x2 hybrid mesh on one card against the same mesh on the CPU,
    the flat sparse mesh on the card and one shard: identical labels,
    sweeps and Q bits; the size form launches, the plain row form not."""
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_hybrid_mesh, make_mesh
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.kernels.row_argmax import row_argmax

    g = generate_rmat(11)
    n, n_plain = row_argmax_sized.launches, row_argmax.launches
    rg = louvain_phases(g, mesh=make_hybrid_mesh(
        2, 2, devices=[cuda_device] * 4))
    assert row_argmax_sized.launches > n
    assert row_argmax.launches == n_plain
    assert rg.exchange_stats["mode"] == "twolevel"
    rc = louvain_phases(g, mesh_shape=(2, 2), device="cpu")
    flat = louvain_phases(g, mesh=make_mesh(devices=[cuda_device] * 4),
                          exchange="sparse")
    r1 = louvain_phases(g, device=cuda_device)
    for r in (rc, flat, r1):
        assert np.array_equal(rg.communities, r.communities)
        assert [p.iterations for p in rg.phases] == \
            [p.iterations for p in r.phases]
    assert rg.modularity == rc.modularity == flat.modularity


@pytest.mark.cuda
def test_twolevel_across_cards_matches_one_card(cards):
    """A 2x2 hybrid mesh over the cards (shard s on card s % n, up to
    four) against the same mesh on card 0: identical labels and Q bits."""
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_hybrid_mesh
    from cuvite_tpu_torch.io.generate import generate_rmat

    n = min(len(cards), 4)
    g = generate_rmat(12)
    spread = [cards[s % n] for s in range(4)]
    rm = louvain_phases(g, mesh=make_hybrid_mesh(2, 2, devices=spread))
    r0 = louvain_phases(g, mesh=make_hybrid_mesh(2, 2,
                                                 devices=[cards[0]] * 4))
    assert np.array_equal(rm.communities, r0.communities)
    assert rm.modularity == r0.modularity


@pytest.mark.cuda
def test_batch_mesh_across_cards_matches_one(cards):
    """A batch of 8 synth graphs sharded over 2 cards and over 4 (where
    there are) against the same batch on card 0, both engines: every
    tenant's labels and Q equal."""
    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.louvain.batched import make_batch_mesh
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    gs = [synthesize_graph(2048, seed=many_seed(9, k)) for k in range(8)]
    for engine in ("fused", "bucketed"):
        one = louvain_many(gs, engine=engine, device=cards[0], mesh=None)
        for nd in (2, 4):
            if nd > len(cards):
                continue
            mesh = make_batch_mesh(8, devices=cards[:nd])
            assert mesh.size == nd
            br = louvain_many(gs, engine=engine, mesh=mesh)
            for a, b in zip(br.results, one.results):
                assert np.array_equal(a.communities, b.communities)
                assert a.modularity == b.modularity


NCCL_RANK = r"""
import json, sys
import numpy as np
from cuvite_tpu_torch.comm import multihost
spec = json.loads(sys.argv[1])
multihost.initialize(timeout=300)
with multihost.fail_together():
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rmat
    res = louvain_phases(generate_rmat(12), nshards=spec["nshards"],
                         exchange=spec["exchange"])
    np.save(f"{spec['out']}/rank{multihost.rank()}.npy", res.communities)
    print(json.dumps({"iters": [p.iterations for p in res.phases],
                      "q": res.modularity.hex(),
                      "device": str(multihost.local_device())}))
    multihost.shutdown()
"""


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["replicated", "sparse"])
def test_nccl_world_matches_one_process(cards, exchange, tmp_path):
    """One NCCL rank per card (up to four, a ``file://`` store) on twice
    as many shards: every rank sits on its own card and returns the
    labels, iterations and Q bits of the one-process mesh on card 0."""
    import json
    import os
    import sys

    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.comm.multihost import launch
    from cuvite_tpu_torch.io.generate import generate_rmat

    n = min(len(cards), 4)
    spec = {"nshards": 2 * n, "exchange": exchange, "out": str(tmp_path)}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = vis.split(",")[:n] if vis else [str(i) for i in range(n)]
    env = dict(os.environ, PYTHONPATH=repo, CUDA_VISIBLE_DEVICES=",".join(ids))
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    outs = launch([sys.executable, "-c", NCCL_RANK, json.dumps(spec)], n,
                  f"file://{tmp_path / 'store'}", env=env, timeout=300)
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r} exited {rc}:\n{out}\n{err[-3000:]}"
    want = louvain_phases(generate_rmat(12),
                          mesh=make_mesh(devices=[cards[0]] * (2 * n)),
                          exchange=exchange)
    for r, (_, out, _) in enumerate(outs):
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["device"] == f"cuda:{r}"
        assert np.array_equal(np.load(tmp_path / f"rank{r}.npy"),
                              want.communities)
        assert rec["iters"] == [p.iterations for p in want.phases]
        assert rec["q"] == want.modularity.hex()


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


def assert_rows_equal(got, ref):
    """Two coalesced batches (src, dst, w [B, ne], n [B]), bit for bit."""
    for g, r in zip(got, ref):
        g = g.cpu()
        assert g.dtype == r.dtype and g.shape == r.shape
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r)


def coalesce_on_card(device, arrs, *, nv_pad, grid):
    """seg_coalesce on the card and its twin on the CPU from the same
    [B, ne] arrays; the launch count must go up by one."""
    ref = seg_coalesce_plain(*arrs, nv_pad=nv_pad, grid=grid)
    n = seg_coalesce.launches
    got = seg_coalesce(*[a.to(device) for a in arrs], nv_pad=nv_pad,
                       grid=grid)
    torch.cuda.synchronize()
    assert seg_coalesce.launches == n + 1
    assert_rows_equal(got, ref)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("nv_pad", [64, 1024, 4096])
@pytest.mark.parametrize("weights", ["dyadic", "float"])
def test_seg_coalesce_kernel_matches_twin_on_card(cuda_device, nv_pad,
                                                  weights):
    """The pipeline sums each run in f64 (warp sums and shared-memory
    atomics): the run sums of these slabs are exact in f64, so the
    coalesced rows are bit-equal to the twin's, float weights
    included."""
    arrs = [torch.from_numpy(a)[None] for a in
            coalesce_case(nv_pad, 16384, nv_pad, gapped=nv_pad == 1024,
                          weights=weights)]
    coalesce_on_card(cuda_device, arrs, nv_pad=nv_pad, grid=nv_pad)


def _zero_weight_slab():
    src = np.full(4096, 1024, np.int32)
    dst = np.zeros(4096, np.int32)
    w = np.zeros(4096, np.float32)
    src[:3], dst[:3], w[:3] = [5, 7, 9], [6, 8, 10], [1.0, 0.0, 2.0]
    src[3:300], dst[3:300] = 7, 8   # a 298-row run of weight 0 (dense)
    return src, dst, w


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_src", "medium_buckets", "zero_weight",
                                  "pure_padding", "empty_slab", "odd_ne"])
def test_seg_coalesce_edge_cases_on_card(cuda_device, case):
    """Bucket shapes the pipeline treats apart: every real row in one src
    (a large block's dense row in shared memory), four tenants whose
    buckets hold a few hundred to a few thousand rows (small blocks), zero-
    weight runs (emitted by presence), a slab with no real row, a slab
    with no row at all, and three tenants of 16,461 rows (not a multiple
    of any block size)."""
    if case == "one_src":
        slabs, nv_pad = [hot_src_slab(4096, 32768, 1, all_hot=True)], 4096
    elif case == "medium_buckets":
        slabs, nv_pad = [], 512
        for i in range(4):
            src, dst, w = coalesce_case(nv_pad, 16384, 80 + i)
            src[src < nv_pad] %= 4 * (i + 1)  # 4..16 buckets of the rows
            slabs.append((src, dst, w))
    elif case == "zero_weight":
        slabs, nv_pad = [_zero_weight_slab()], 1024
    elif case == "pure_padding":
        slabs, nv_pad = [(np.full(8192, 512, np.int32),
                          np.zeros(8192, np.int32),
                          np.zeros(8192, np.float32))], 512
    elif case == "empty_slab":
        slabs, nv_pad = [(np.zeros(0, np.int32), np.zeros(0, np.int32),
                          np.zeros(0, np.float32))] * 2, 64
    else:
        nv_pad = 1024
        slabs = [coalesce_case(nv_pad, 16384 + 77, 60 + i, gapped=i == 1)
                 for i in range(3)]
    arrs = [torch.from_numpy(np.stack(a)) for a in zip(*slabs)]
    got = coalesce_on_card(cuda_device, arrs, nv_pad=nv_pad, grid=nv_pad)
    n = got[3].tolist()
    if case == "zero_weight":
        assert n == [3] and float(got[2][0, 1]) == 0.0
    elif case in ("pure_padding", "empty_slab"):
        assert n == [0] * len(slabs)
    else:
        assert min(n) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nv_pad", [16384, 32768])
def test_seg_coalesce_dst_tiles_on_card(cuda_device, nv_pad, monkeypatch):
    """Classes wider than one shared-memory tile of dst slots, admitted
    by CUVITE_SEG_COALESCE_MAX_NV: the dense buckets re-read their rows
    tile by tile; the rows equal the twin's and the sort engine's."""
    from cuvite_tpu_torch.kernels.seg_coalesce import coalesce_engine
    from cuvite_tpu_torch.ops.segment import coalesced_runs

    monkeypatch.setenv("CUVITE_SEG_COALESCE_MAX_NV", str(nv_pad))
    assert coalesce_engine(nv_pad) == "dense"
    arrs = [torch.from_numpy(a) for a in hot_src_slab(nv_pad, 65536, 2)]
    ref = seg_coalesce_plain(*[a[None] for a in arrs], nv_pad=nv_pad,
                             grid=nv_pad)
    n = seg_coalesce.launches
    dev = [a.to(cuda_device) for a in arrs]
    got = coalesced_runs(*dev, nv_pad=nv_pad, engine="dense")
    assert seg_coalesce.launches == n + 1
    assert_rows_equal([t[None] for t in got[:3]] + [torch.tensor([got[3]])],
                      ref)
    srt = coalesced_runs(*dev, nv_pad=nv_pad, engine="sort")
    assert got[3] == srt[3]
    for g, r in zip(got[:3], srt[:3]):
        assert torch.equal(g, r)
    del ref
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_seg_coalesce_makes_no_host_sync_on_card(cuda_device):
    """The whole coalesce, one slab and a batch, under
    torch.cuda.set_sync_debug_mode("error"): any call that waits on the
    card raises."""
    from cuvite_tpu_torch.ops.segment import coalesced_runs_batched

    one = [torch.from_numpy(a)[None].to(cuda_device)
           for a in hot_src_slab(4096, 32768, 3)]
    many = [torch.from_numpy(np.stack(a)).to(cuda_device) for a in
            zip(*[coalesce_case(512, 8192, 70 + i) for i in range(4)])]
    n = seg_coalesce.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [coalesced_runs_batched(*one, nv_pad=4096, engine="dense"),
                coalesced_runs_batched(*many, nv_pad=512, engine="dense",
                                       grid=512)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert seg_coalesce.launches == n + 2
    assert_rows_equal(outs[0], seg_coalesce_plain(
        *[a.cpu() for a in one], nv_pad=4096, grid=4096))
    assert_rows_equal(outs[1], seg_coalesce_plain(
        *[a.cpu() for a in many], nv_pad=512, grid=512))


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


# Zachary's karate club (34 vertices, 78 edges), the graph tests/conftest.py
# builds with networkx, written out: the card machine has no networkx.
KARATE = {0: (1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 17, 19, 21, 31),
          1: (2, 3, 7, 13, 17, 19, 21, 30), 2: (3, 7, 8, 9, 13, 27, 28, 32),
          3: (7, 12, 13), 4: (6, 10), 5: (6, 10, 16), 6: (16,),
          8: (30, 32, 33), 9: (33,), 13: (33,), 14: (32, 33), 15: (32, 33),
          18: (32, 33), 19: (33,), 20: (32, 33), 22: (32, 33),
          23: (25, 27, 29, 32, 33), 24: (25, 27, 31), 25: (31,),
          26: (29, 33), 27: (33,), 28: (31, 33), 29: (32, 33), 30: (32, 33),
          31: (32, 33), 32: (33,)}


def karate_graph():
    from cuvite_tpu_torch import Graph

    e = np.array([(u, v) for u, vs in KARATE.items() for v in vs])
    return Graph.from_edges(34, e[:, 0], e[:, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["karate", "rmat10"])
def test_fused_engine_on_card_matches_cpu(cuda_device, name, monkeypatch):
    """With FUSED_SHRINK_EDGES lowered, R-MAT 10 runs one-phase calls with
    device coarsenings between them, dense ones on seg_coalesce."""
    import cuvite_tpu_torch.louvain.driver as driver
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rmat

    g = karate_graph() if name == "karate" else generate_rmat(10)
    monkeypatch.setattr(driver, "FUSED_SHRINK_EDGES", 256)
    rg = louvain_phases(g, device=cuda_device, engine="fused")
    rc = louvain_phases(g, device="cpu", engine="fused")
    assert np.array_equal(rg.communities, rc.communities)
    assert [p.iterations for p in rg.phases] == \
        [p.iterations for p in rc.phases]
    assert abs(rg.modularity - rc.modularity) <= 1e-9
    if name == "karate":
        assert rg.num_communities == 4
    else:
        assert "dense" in [p.coalesce for p in rg.phases]


@pytest.mark.cuda
def test_class_sweep_with_frozen_info_on_card_matches_cpu(cuda_device):
    """One vertex-ordering sweep per class plan -- community tables from
    a frozen assignment, communities from a drifted one -- on the row and
    heavy kernels and on their twins; one class holds a hub of degree
    8400."""
    from cuvite_tpu_torch import Graph
    from cuvite_tpu_torch.core.distgraph import DistGraph
    from cuvite_tpu_torch.kernels.heavy_bincount import heavy_argmax
    from cuvite_tpu_torch.louvain.bucketed import (
        DevicePlan,
        bucketed_step,
        build_class_plans,
    )

    rng = np.random.default_rng(0)
    nv = 9000
    src = np.concatenate([np.zeros(8400, np.int64),
                          rng.integers(1, nv, 12000)])
    dst = np.concatenate([rng.choice(np.arange(1, nv), 8400, replace=False),
                          rng.integers(1, nv, 12000)])
    dg = DistGraph.build(Graph.from_edges(nv, src, dst))
    nvp = dg.nv_pad
    cls = rng.integers(0, 4, nvp).astype(np.int32)
    info = torch.from_numpy(rng.integers(0, 600, nvp).astype(np.int32))
    comm = torch.where(torch.from_numpy(rng.random(nvp) < 0.3),
                       torch.from_numpy(rng.integers(0, 600, nvp).astype(
                           np.int32)), info)
    vdeg = torch.from_numpy(dg.padded_weighted_degrees())
    const = 1.0 / dg.graph.total_edge_weight_twice()
    launches = heavy_argmax.launches
    for plan in build_class_plans(dg.src, dg.dst, dg.w, cls, 4,
                                  nv_local=nvp):
        ref = bucketed_step(DevicePlan.upload(plan, "cpu"), comm, vdeg,
                            const, nv_total=nvp, info_comm=info)
        got = bucketed_step(DevicePlan.upload(plan, cuda_device),
                            comm.to(cuda_device), vdeg.to(cuda_device),
                            const, nv_total=nvp,
                            info_comm=info.to(cuda_device))
        assert torch.equal(got.target.cpu(), ref.target)
        assert torch.equal(got.counter0.cpu(), ref.counter0)
        assert int(got.n_moved) == int(ref.n_moved) > 0
    assert heavy_argmax.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 32, 64, 512, 4096])
def test_batched_row_kernel_matches_twin_on_card(cuda_device, width):
    """One launch over the rows of four tenants, each row with its own
    tenant's constant: bit-equal to the twin."""
    *args, consts = folded_case(4, 1024, 64 if width >= 512 else 400,
                                width, width)
    ref = row_argmax_plain(*args, consts)
    n = row_argmax.launches
    got = row_argmax(*[a.to(cuda_device) for a in args],
                     consts.to(cuda_device))
    torch.cuda.synchronize()
    assert row_argmax.launches == n + 1
    for r, g in zip(ref, got):
        assert torch.equal(r, g.cpu())


@pytest.mark.cuda
def test_batched_heavy_kernel_matches_twin_on_card(cuda_device):
    """The hubs of two tenants in one chunk table and one launch, each
    with its tenant's constant, twice: bit-equal, scratch left clean."""
    *tabs, consts = folded_case(4, 16384, 1, 8, 3)[2:]
    tabs = tabs[1:]
    rng = np.random.default_rng(4)
    nvp = 16384
    hs = np.concatenate([np.full(9000, 11), np.full(20000, 2 * nvp + 5)])
    hd = np.concatenate([rng.integers(0, nvp, 9000),
                         2 * nvp + rng.integers(0, 40, 20000)])
    hw = (rng.integers(1, 32, len(hs)) / 16.0).astype(np.float32)
    lay = build_heavy_layout(hs, hd, hw, nv_local=4 * nvp)
    ref = heavy_argmax_plain(lay, *tabs, consts)
    lay_d = lay.to(cuda_device)
    for _ in range(2):
        got = heavy_argmax(lay_d, *[t.to(cuda_device) for t in tabs],
                           consts.to(cuda_device))
        torch.cuda.synchronize()
        for r, g in zip(ref, got):
            assert torch.equal(r, g.cpu())
        assert lay_d.scratch.is_clean()


@pytest.mark.cuda
def test_batched_seg_coalesce_matches_twin_on_card(cuda_device):
    """Four tenants, one of them pure padding, gapped ids and float
    weights, in one launch: each tenant's coalesced rows bit-equal to the
    twin's, in its own prefix."""
    rows = []
    for i, gapped in enumerate((False, True, False)):
        rows.append(coalesce_case(512, 8192, 40 + i, gapped=gapped,
                                  weights="float" if i == 2 else "dyadic"))
    rows.append((np.full(8192, 512, np.int32), np.zeros(8192, np.int32),
                 np.zeros(8192, np.float32)))
    arrs = [torch.from_numpy(np.stack(a)) for a in zip(*rows)]
    got = coalesce_on_card(cuda_device, arrs, nv_pad=512, grid=512)
    assert int(got[3][3]) == 0 and min(got[3][:3].tolist()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["fused", "bucketed"])
def test_louvain_many_on_card_matches_cpu(cuda_device, engine):
    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    gs = [generate_rmat(8, edge_factor=8, seed=s) for s in (1, 2)]
    gs += [synthesize_graph(2048, seed=many_seed(7, k)) for k in (0, 1)]
    rg = louvain_many(gs, engine=engine, device=cuda_device)
    rc = louvain_many(gs, engine=engine, device="cpu")
    assert rg.phase_engines == rc.phase_engines
    for g, a, b in zip(gs, rg.results, rc.results):
        assert np.array_equal(a.communities, b.communities)
        assert a.total_iterations == b.total_iterations
        assert abs(a.modularity - b.modularity) <= 1e-12
        solo = louvain_many([g], engine=engine, device=cuda_device)
        assert np.array_equal(solo.results[0].communities, a.communities)


@pytest.mark.cuda
@pytest.mark.parametrize("side_stream", [False, True])
def test_phase0_plan_on_card_equals_host_plans(cuda_device, side_stream):
    """The bucketed engine's phase-0 plan, built on the card at pack time
    (on the upload's side stream too), equals the tenants' host plans
    folded and uploaded, tensor for tensor."""
    from cuvite_tpu_torch.core.batch import batch_bucket_plans, batch_slabs
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.louvain.batched import execute_many, pack_many
    from cuvite_tpu_torch.louvain.bucketed import DevicePlan
    from cuvite_tpu_torch.utils.trace import Tracer
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    gs = [generate_rmat(8, edge_factor=8, seed=s) for s in (1, 2)]
    gs += [synthesize_graph(2048, seed=many_seed(7, 0))]
    tr = Tracer()
    pm = pack_many(gs, engine="bucketed", mesh=None, device=cuda_device,
                   tracer=tr, side_stream=side_stream)
    assert tr.counters["batch_device_plans"] == tr.counters["batch_plans"]
    if pm.prep.ready is not None:
        pm.prep.ready.synchronize()
    got = pm.prep.plan
    want = DevicePlan.upload(batch_bucket_plans(batch_slabs(gs)).fold(),
                             cuda_device)
    assert got.heavy is None and want.heavy is None
    assert (got.widths, got.bucket_edges) == (want.widths, want.bucket_edges)
    assert len(got.buckets) == len(want.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        for x, y in zip(gb, wb):
            assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in ((got.self_loop, want.self_loop), (got.perm, want.perm)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    rc = execute_many(pm)
    ref = pack_many(gs, engine="bucketed", device="cpu")
    for a, b in zip(rc.results, execute_many(ref).results):
        assert np.array_equal(a.communities, b.communities)
        assert a.total_iterations == b.total_iterations
        assert abs(a.modularity - b.modularity) <= 1e-12


@pytest.mark.cuda
def test_kernel_build_and_load_once_under_threads(cuda_device, monkeypatch):
    """Eight threads reaching an unbuilt, unloaded kernel at once: one
    nvcc and one load, every thread gets the same library."""
    import threading

    from cuvite_tpu_torch.kernels import _build
    from cuvite_tpu_torch.kernels import seg_coalesce as sc

    _build.library_path("seg_coalesce").unlink(missing_ok=True)
    _build._LIBS.pop("seg_coalesce", None)
    popens, loads = [], []
    real_popen, real_cdll = _build.subprocess.Popen, _build.ctypes.CDLL
    monkeypatch.setattr(_build.subprocess, "Popen",
                        lambda *a, **k: popens.append(a) or
                        real_popen(*a, **k))
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda p: loads.append(p) or real_cdll(p))
    barrier = threading.Barrier(8)
    libs, errors = [], []

    def reach():
        try:
            barrier.wait()
            libs.append(_build.library("seg_coalesce", sc._SIGNATURE))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=reach) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    assert len(popens) == 1 and len(loads) == 1
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)


@pytest.mark.cuda
def test_pipelined_dispatcher_on_card_matches_cpu(cuda_device):
    """The pipelined dispatcher on the card: batches packed and uploaded on
    the packer thread (pinned memory, the side stream, an event), executed
    on the executor thread; every tenant equals its CPU B=1 run."""
    from cuvite_tpu_torch import louvain_many
    from cuvite_tpu_torch.louvain.batched import execute_many, pack_many
    from cuvite_tpu_torch.serve import (
        LouvainServer,
        PipelinedDispatcher,
        ServeConfig,
    )
    from cuvite_tpu_torch.workloads.synth import many_seed, synthesize_graph

    gs = [synthesize_graph(4096, seed=many_seed(1, k)) for k in range(12)]
    assert pack_many(gs[:2], engine="bucketed",
                     device=cuda_device).prep.ready is None
    pm = pack_many(gs[:2], engine="bucketed", device=cuda_device,
                   side_stream=True)
    assert isinstance(pm.prep.ready, torch.cuda.Event)
    assert pm.prep.slab.src.is_cuda and pm.prep.ready.query()
    first = execute_many(pm).results
    again = execute_many(pm).results
    srv = LouvainServer(ServeConfig(b_max=4, linger_s=0.0,
                                    engine="bucketed"))
    pipe = PipelinedDispatcher(srv, poll_s=0.001)
    assert srv.side_stream_upload
    pipe.start()
    ids = [pipe.submit(g) for g in gs]
    pipe.request_drain()
    assert pipe.wait_done(timeout=600)
    got = dict(pipe.results)
    assert srv.conservation()["ok"] and srv.stats.pipeline_depth == 2
    assert 0.0 <= srv.stats.overlap_frac <= 1.0
    for k, (jid, g) in enumerate(zip(ids, gs)):
        solo = louvain_many([g], engine="bucketed", device="cpu").results[0]
        assert np.array_equal(got[jid].communities, solo.communities)
        assert abs(got[jid].modularity - solo.modularity) <= 1e-12
        if k < 2:
            assert np.array_equal(first[k].communities, solo.communities)
            assert np.array_equal(again[k].communities, solo.communities)


@pytest.mark.cuda
def test_bench_record_on_card(cuda_device):
    """The per-graph bench on the card at R-MAT 12: a valid record with a
    checked guard (the warm-up built and loaded every library the timed
    runs launch), the card's name and its peak allocation, and the Q,
    phases and iterations of the CPU run; a tracer leaves the labels as
    they are."""
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.obs import FlightRecorder
    from cuvite_tpu_torch.utils.trace import Tracer
    from cuvite_tpu_torch.workloads.bench import run_bench, validate_record

    g = generate_rmat(12)
    rec = run_bench(g, repeats=2, budget_s=600, device=cuda_device,
                    graph_label="rmat12", scale=12)
    assert validate_record(rec) == []
    assert rec["compile_guard"] == {"checked": True, "new_compiles": 0}
    assert rec["platform"] == "cuda"
    assert rec["device"] == torch.cuda.get_device_name(cuda_device)
    assert rec["peak_alloc_bytes"] > 0
    assert {"slab", "tables", "plans"} & set(rec["hbm_peak_by_buffer"])
    cpu = louvain_phases(g, device="cpu")
    assert (rec["phases"], rec["iterations"]) == \
        (len(cpu.phases), cpu.total_iterations)
    assert abs(rec["modularity"] - round(cpu.modularity, 6)) <= 1e-6
    with FlightRecorder() as fr:
        traced = louvain_phases(g, device=cuda_device,
                                tracer=Tracer(recorder=fr))
    assert np.array_equal(traced.communities, cpu.communities)


_FIRST_FORM_IN_TIMED_RUN = r"""
import numpy as np
from cuvite_tpu_torch import Graph
from cuvite_tpu_torch.kernels import _build, heavy_bincount, row_argmax, \
    seg_coalesce
from cuvite_tpu_torch.workloads.bench import BenchCompileGuardError, \
    run_bench

# Every library built and loaded up front: only CUDA's lazy loading of a
# kernel body at its first launch is left to happen in the timed run.
for mod, name in ((row_argmax, "row_argmax"),
                  (heavy_bincount, "heavy_bincount"),
                  (seg_coalesce, "seg_coalesce")):
    _build.library(name, mod._SIGNATURE)
n = 1 << 14
s = np.arange(n)
ring = Graph.from_edges(n, s, (s + 1) % n)      # rows of degree 2 only
hub = Graph.from_edges(n, np.concatenate([s, np.zeros(n - 1, np.int64)]),
                       np.concatenate([(s + 1) % n, s[1:]]))  # + a hub
graphs = [ring, hub]
try:
    run_bench(lambda: graphs.pop(0), repeats=1, budget_s=600)
except BenchCompileGuardError as e:
    print("\n".join(e.compile_log))
else:
    print("NO TRIP")
"""


@pytest.mark.cuda
def test_guard_trips_on_a_form_first_launched_in_the_timed_run_card(
        cuda_device):
    """C1: a fresh process whose bench warm-up runs a ring (no hub) and
    whose first timed run gets a hub of degree 16,383: the heavy kernel's
    body is first launched, so first loaded by CUDA, inside the timed
    window, and the guard refuses the record -- with no build or library
    load in the window to give it away."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FIRST_FORM_IN_TIMED_RUN],
                         cwd=repo, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    log = out.stdout.strip().splitlines()
    assert "first launch heavy_bincount passes on cuda:0" in log, log
    assert all(line.startswith("first launch ") for line in log), log


@pytest.mark.cuda
def test_stream_delta_on_card_matches_cpu(cuda_device):
    """apply_delta_slab, delta_frontier and grow_slab on the card, bit-equal
    to the CPU for an R-MAT 12 slab and one churn batch."""
    from cuvite_tpu_torch.coarsen.device import grow_slab
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.stream import (
        DeltaBatch,
        apply_delta_slab,
        delta_frontier,
    )
    from cuvite_tpu_torch.stream.session import canonical_slab
    from cuvite_tpu_torch.workloads.synth import churn_batches

    g = generate_rmat(12)
    nv_pad, ne_pad, src, dst, w = canonical_slab(g)
    batch = DeltaBatch.from_edits(g.num_vertices,
                                  **churn_batches(g, frac=0.01)[0])
    outs = []
    for dev in (torch.device("cpu"), cuda_device):
        t = [torch.from_numpy(a).to(dev)
             for a in (src, dst, w, *batch.padded()[:5])]
        res = apply_delta_slab(*t, g.num_edges, nv_pad=nv_pad)
        fr = delta_frontier(res[0], res[1], t[3], t[4], t[6], t[7],
                            nv_pad=nv_pad)
        grown = grow_slab(*res[:3], nv_pad=nv_pad, new_nv_pad=nv_pad,
                          new_ne_pad=2 * ne_pad)
        outs.append([x.cpu() for x in (*res, *fr, *grown)])
    assert outs[0][5].item() == batch.n_del     # every churn delete hits
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_stream_session_on_card_matches_cpu(cuda_device):
    """A session on R-MAT 10: cold, one churn delta, the labels and plp
    arms; the card gives the CPU's labels, delta facts and 2m."""
    from cuvite_tpu_torch.io.generate import generate_rmat
    from cuvite_tpu_torch.stream import DeltaBatch, StreamSession
    from cuvite_tpu_torch.workloads.synth import churn_batches

    g = generate_rmat(10)
    batch = DeltaBatch.from_edits(g.num_vertices,
                                  **churn_batches(g, frac=0.02)[0])
    runs = []
    for dev in ("cpu", cuda_device):
        s = StreamSession.from_graph(g, device=dev)
        cold = s.recluster(warm="cold")
        info = s.apply_delta(batch)
        info.pop("wall_s")
        warm = s.recluster(warm="labels")
        plp = s.recluster(warm="plp")
        runs.append((cold.communities.tolist(), info,
                     warm.communities.tolist(), plp.communities.tolist(),
                     s.tw2, s.fingerprint))
    assert runs[0] == runs[1]


def _big_class_slab(nv_pad, ne_pad, seed):
    """A relabeled slab of a big class: a seventh of the rows padding,
    runs at both ends of the id space, dyadic weights."""
    rng = np.random.default_rng(seed)
    n_real = ne_pad - ne_pad // 7
    src = np.full(ne_pad, nv_pad, np.int32)
    dst = np.zeros(ne_pad, np.int32)
    w = np.zeros(ne_pad, np.float32)
    src[:n_real] = rng.integers(0, nv_pad, n_real)
    dst[:n_real] = rng.integers(0, max(nv_pad // 64, 1), n_real)
    src[:4] = [nv_pad - 1, nv_pad - 1, 0, 0]
    dst[:4] = [nv_pad - 1, nv_pad - 1, nv_pad - 1, 0]
    w[:n_real] = rng.integers(1, 64, n_real) / 8.0
    return src, dst, w


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["msd", "hash"])
@pytest.mark.parametrize("nv_pad", [1 << 16, 1 << 20])
def test_big_class_engines_on_card_match_cpu(cuda_device, engine, nv_pad,
                                             monkeypatch):
    """The msd and hash coalesce on the card give the CPU's rows bit for
    bit and the sort engine's; the hash engine reads one flag on the
    host, the msd engine none.  With one slot a src the hash engine
    collides and retries on the msd tail."""
    from cuvite_tpu_torch.kernels import seg_coalesce as sc
    from cuvite_tpu_torch.ops import segment as seg

    for slots in (None, "1"):
        if slots is None:
            monkeypatch.delenv("CUVITE_HASH_SLOTS", raising=False)
        else:
            monkeypatch.setenv("CUVITE_HASH_SLOTS", slots)
        src, dst, w = (torch.from_numpy(a)[None] for a in
                       _big_class_slab(nv_pad, 1 << 17, nv_pad))
        cpu = seg.coalesced_runs_batched(src, dst, w, nv_pad=nv_pad,
                                         engine=engine)
        sort = seg.coalesced_runs_batched(src, dst, w, nv_pad=nv_pad)
        args = [t.to(cuda_device) for t in (src, dst, w)]
        sc.zero_hash_stats()
        if engine == "msd":
            torch.cuda.set_sync_debug_mode("error")
        try:
            card = seg.coalesced_runs_batched(*args, nv_pad=nv_pad,
                                              engine=engine)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for a, b, c in zip(card, cpu, sort):
            assert torch.equal(a.cpu(), b) and torch.equal(b, c)
        reads = 1 if engine == "hash" else 0
        assert sc.HASH_STATS["host_reads"] == reads
        if slots == "1" and engine == "hash":
            assert sc.HASH_STATS["collisions"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("nshards,exchange", [(1, "auto"), (4, "sparse"),
                                              (4, "replicated")])
def test_pallas_engine_on_card_matches_cpu(cuda_device, nshards, exchange):
    """engine='pallas' on the card: the CPU's labels, sweeps and Q, the
    bucketed run's on the card, and the same coverage."""
    from cuvite_tpu_torch import louvain_phases
    from cuvite_tpu_torch.comm.mesh import make_mesh
    from cuvite_tpu_torch.io.generate import generate_rmat

    g = generate_rmat(12, edge_factor=8, seed=3)
    kw = dict(nshards=nshards, exchange=exchange)
    card_kw = (dict(kw, device=cuda_device) if nshards == 1 else
               dict(kw, mesh=make_mesh(devices=[cuda_device] * nshards)))
    rg = louvain_phases(g, engine="pallas", **card_kw)
    rb = louvain_phases(g, engine="bucketed", **card_kw)
    rc = louvain_phases(g, engine="pallas", device="cpu", **kw)
    for r in (rb, rc):
        assert np.array_equal(rg.communities, r.communities)
        assert [p.iterations for p in rg.phases] == \
            [p.iterations for p in r.phases]
        assert abs(rg.modularity - r.modularity) <= 1e-9
        assert (rg.pallas_coverage, rg.pallas_width_hits) == \
            (r.pallas_coverage, r.pallas_width_hits)
    assert rg.pallas_coverage == 1.0


def _last_json(text: str) -> dict:
    import json

    return json.loads([s for s in text.splitlines()
                       if s.startswith("{")][-1])


@pytest.mark.cuda
def test_step_bench_reports_a_device_time_on_card(cuda_device, monkeypatch,
                                                  capsys):
    """The step driver on the card: CUDA-event device time and the row
    kernel's launches over its timed sweeps."""
    from cuvite_tpu_torch.tools import step_bench

    monkeypatch.setenv("AB_SCALE", "14")
    assert step_bench.main([]) == 0
    row = _last_json(capsys.readouterr().out)
    assert row["device_ms"] > 0 and row["medges_per_s"] > 0
    assert row["device"] == torch.cuda.get_device_name(0)
    assert row["launches"]["row_argmax"] > 0


@pytest.mark.cuda
def test_trace_step_device_rows_name_the_row_kernel(cuda_device,
                                                    monkeypatch, capsys,
                                                    tmp_path):
    """torch.profiler sees the hand kernels: the row kernel is among the
    traced device rows."""
    from cuvite_tpu_torch.tools import trace_step

    monkeypatch.setenv("AB_SCALE", "14")
    monkeypatch.setenv("TRACE_DIR", str(tmp_path))
    assert trace_step.main([]) == 0
    row = _last_json(capsys.readouterr().out)
    assert row["rows_on"] == "device" and row["self_s"] > 0
    assert any("row_argmax" in r["name"] for r in row["top"])
    assert row["launches"]["row_argmax"] > 0
