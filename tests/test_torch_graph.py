"""cuvite_tpu_torch host layer against the JAX package: R-MAT and RGG edges
and CSR arrays, the Park-Miller stream, Vite I/O, the package's
independence from JAX, and the card-by-default device rule."""

import os
import subprocess
import sys

import numpy as np
import pytest

from cuvite_tpu.core.graph import Graph as JGraph
from cuvite_tpu.io.generate import generate_rgg as jax_rgg
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.io.generate import rgg_points as jax_rgg_points
from cuvite_tpu.io.generate import rmat_edges_numpy as jax_rmat_edges
from cuvite_tpu.io.vite import write_vite as jax_write_vite
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.io.generate import (
    generate_rgg,
    generate_rmat,
    rgg_points,
    rmat_edges_numpy,
)
from cuvite_tpu_torch.io.vite import read_vite, write_vite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("scale", [10, 12])
def test_rmat_matches_jax(scale):
    ne = 16 << scale
    for a, b in zip(rmat_edges_numpy(scale, ne, 1, 0.57, 0.19, 0.19),
                    jax_rmat_edges(scale, ne, 1, 0.57, 0.19, 0.19)):
        assert np.array_equal(a, b)
    g, jg = generate_rmat(scale), jax_rmat(scale)
    for name in ("offsets", "tails", "weights"):
        mine, ref = getattr(g, name), getattr(jg, name)
        assert mine.dtype == ref.dtype and np.array_equal(mine, ref), name


@pytest.mark.parametrize("nv", [4096, 16384])
def test_rgg_matches_jax(nv):
    """Points from the Park-Miller stream, edges within rn, distance
    weights: the CSR arrays are the reference's, bit for bit."""
    g, jg = generate_rgg(nv), jax_rgg(nv)
    for name in ("offsets", "tails", "weights"):
        mine, ref = getattr(g, name), getattr(jg, name)
        assert mine.dtype == ref.dtype and np.array_equal(mine, ref), name


def test_rgg_points_and_stream_slices_match_jax():
    """Strips of several shards read their own slices of the one global
    stream (lo > 0: the closed-form jump); seed 7 reseeds."""
    from cuvite_tpu.utils.rng import lcg_stream as jax_lcg
    from cuvite_tpu_torch.utils.rng import lcg_stream

    for nshards, seed in ((1, 1), (4, 1), (3, 7)):
        for a, b in zip(rgg_points(3000, nshards, seed),
                        jax_rgg_points(3000, nshards, seed)):
            assert np.array_equal(a, b)
    assert np.array_equal(lcg_stream(5, 5000, 1234, 4321),
                          jax_lcg(5, 5000, 1234, 4321))
    with pytest.raises(ValueError, match="strip width"):
        generate_rgg(1000, nshards=64)


def test_from_edges_weighted_matches_jax():
    """Duplicate weights summed in f64 and rounded once, self-loops kept
    once, asymmetric input symmetrized."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, 300, 4000)
    dst = rng.integers(0, 300, 4000)
    w = rng.random(4000)
    g = Graph.from_edges(300, src, dst, weights=w)
    jg = JGraph.from_edges(300, src, dst, weights=w)
    for name in ("offsets", "tails", "weights"):
        assert np.array_equal(getattr(g, name), getattr(jg, name)), name
    assert np.array_equal(g.weighted_degrees(), jg.weighted_degrees())


@pytest.mark.parametrize("bits64", [True, False])
def test_write_vite_byte_identical_and_round_trip(tmp_path, bits64):
    jg = jax_rmat(10)
    g = Graph.from_arrays(jg.offsets, jg.tails, jg.weights)
    mine, ref = tmp_path / "mine.bin", tmp_path / "ref.bin"
    write_vite(str(mine), g, bits64=bits64)
    jax_write_vite(str(ref), jg, bits64=bits64)
    assert mine.read_bytes() == ref.read_bytes()
    back = read_vite(str(mine), bits64=bits64)
    assert np.array_equal(back.offsets, g.offsets)
    assert np.array_equal(back.tails, g.tails)
    assert np.array_equal(back.weights, g.weights)
    with pytest.raises(ValueError):
        read_vite(str(mine), bits64=not bits64)


def test_bits64_file_clusters_like_jax(tmp_path):
    """A 64-bit Vite file loads with int64/f64 host arrays; the device path
    runs int32/f32 in both packages, with identical labels."""
    from cuvite_tpu.io.vite import read_vite as jax_read_vite
    from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain

    path = str(tmp_path / "g64.bin")
    jax_write_vite(path, jax_rmat(10), bits64=True)
    g = read_vite(path, bits64=True)
    assert g.tails.dtype == np.int64 and g.weights.dtype == np.float64
    mine = louvain_phases(g, device="cpu")
    ref = jax_louvain(jax_read_vite(path, bits64=True))
    assert np.array_equal(mine.communities, ref.communities)
    assert mine.total_iterations == ref.total_iterations
    assert abs(mine.modularity - ref.modularity) <= 1e-9


def test_package_imports_without_jax():
    """Every module of cuvite_tpu_torch imports with jax and cuvite_tpu
    blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cuvite_tpu'] = None\n"
        "import cuvite_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    cuvite_tpu_torch.__path__, 'cuvite_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None}\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 19


def test_louvain_phases_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = Graph.from_edges(4, np.array([0, 1, 2]), np.array([1, 2, 3]))
    with pytest.raises(RuntimeError, match="CUDA"):
        louvain_phases(g)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from cuvite_tpu_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_cli_runs_on_cpu(tmp_path, capsys):
    from cuvite_tpu_torch import cli

    jg = jax_rmat(9)
    path = tmp_path / "g.bin"
    jax_write_vite(str(path), jg, bits64=False)
    assert cli.main(["--file", str(path), "--device", "cpu",
                     "--output"]) == 0
    out = capsys.readouterr().out
    assert "Final modularity" in out
    labels = np.loadtxt(str(path) + ".communities", dtype=np.int64)
    assert labels.shape == (jg.num_vertices,)


def test_cli_generates_rgg_and_runs_the_sort_engine(capsys):
    from cuvite_tpu_torch import cli

    assert cli.main(["-n", "2048", "--engine", "sort", "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Loaded graph: 2048 vertices" in out
    assert "Final modularity" in out
