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
