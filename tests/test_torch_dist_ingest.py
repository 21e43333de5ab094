"""cuvite_tpu_torch's per-rank ingest (``io/dist_ingest.py``) held against
the JAX package's ``io/dist_ingest.py`` and the port's full ingest on
the CPU (the counterpart of tests/test_dist_ingest.py).

In one process every shard is local, so a DistVite must reproduce the
full-ingest DistGraph array for array and its run the full-ingest run's
labels, with ET and the color schedules too; its coloring
(``multi_hash_coloring_dist``) and checkpoint fingerprint
(``content_fingerprint``) equal the reference's.  A world of 2 gloo ranks
(subprocesses, a ``file://`` store in ``tmp_path``) then reads per rank:
each rank holds edge arrays for its own shards only, and the labels
equal full ingest, a colored run and a checkpoint resume included.
"""

import json
import os
import sys

import numpy as np
import pytest

from cuvite_tpu.io.dist_ingest import DistVite as JDistVite
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.io.vite import read_vite as jax_read_vite
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.comm.multihost import launch
from cuvite_tpu_torch.core.distgraph import DistGraph
from cuvite_tpu_torch.evaluate.modularity import modularity
from cuvite_tpu_torch.io.dist_ingest import DistVite
from cuvite_tpu_torch.io.vite import read_vite, write_vite

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, sys
from cuvite_tpu_torch.comm import multihost
path, nshards, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
multihost.initialize(device="cpu", timeout=60)
with multihost.fail_together():
    from cuvite_tpu_torch.io.dist_ingest import DistVite
    from cuvite_tpu_torch.louvain.driver import louvain_phases
    dv = DistVite.load(path, nshards, bits64=False)
    res = louvain_phases(dv)
    with open(f"{out}/rank{multihost.rank()}.json", "w") as f:
        json.dump({"local": [dv.local_lo, dv.local_hi],
                   "held": [s for s in range(nshards)
                            if dv.shards[s].src is not None],
                   "labels": res.communities.tolist(),
                   "iters": [p.iterations for p in res.phases],
                   "q": res.modularity, "bytes_read": dv.bytes_read}, f)
    multihost.shutdown()
"""


@pytest.fixture(scope="module")
def rmat_bin(tmp_path_factory):
    jg = jax_rmat(10)
    g = Graph.from_arrays(jg.offsets, jg.tails, jg.weights)
    path = str(tmp_path_factory.mktemp("dv") / "rmat10.bin")
    write_vite(path, g, bits64=False)
    return path, g


@pytest.mark.parametrize("balanced", [False, True])
def test_distvite_matches_distgraph_and_jax(rmat_bin, balanced):
    """Partition, padded sizes, id maps, degrees, 2m and every shard's
    slab equal the port's full-ingest DistGraph and the reference's
    DistVite, uniform and edge-balanced."""
    path, g = rmat_bin
    kw = dict(min_nv_pad=512, min_ne_pad=4096)
    dv = DistVite.load(path, 4, bits64=False, balanced=balanced, **kw)
    dg = DistGraph.build(g, 4, balanced=balanced, **kw)
    jdv = JDistVite.load(path, 4, bits64=False, balanced=balanced, **kw)
    assert (dv.local_lo, dv.local_hi) == (0, 4)
    for ref in (dg, jdv):
        assert (dv.nv_pad, dv.ne_pad, dv.nshards) == \
            (ref.nv_pad, ref.ne_pad, ref.nshards)
        for a, b in ((dv.parts, ref.parts), (dv.old_to_pad, ref.old_to_pad),
                     (dv.pad_to_old, ref.pad_to_old),
                     (dv.vertex_mask(), ref.vertex_mask()),
                     (dv.padded_weighted_degrees(),
                      ref.padded_weighted_degrees())):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert dv.graph.total_edge_weight_twice() == \
            ref.graph.total_edge_weight_twice()
        for mine, theirs in zip(dv.shards, ref.shards):
            for f in ("src", "dst", "w"):
                assert np.array_equal(getattr(mine, f), getattr(theirs, f))
            assert (mine.base, mine.bound, mine.n_real_edges) == \
                (theirs.base, theirs.bound, theirs.n_real_edges)
    # The whole file, plus each shard's offset slice read again.
    assert dv.bytes_read == os.path.getsize(path) + (g.num_vertices + 4) * 4


def test_read_vite_vertex_range(rmat_bin):
    """A range read is the reference's local slice; a range outside the
    graph raises."""
    path, g = rmat_bin
    for lo, hi in ((0, 1024), (100, 357), (600, 600)):
        mine = read_vite(path, bits64=False, vertex_range=(lo, hi))
        ref = jax_read_vite(path, bits64=False, vertex_range=(lo, hi))
        for a, b in ((mine.offsets, ref.offsets), (mine.tails, ref.tails),
                     (mine.weights, ref.weights)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="vertex range"):
        read_vite(path, bits64=False, vertex_range=(5, 2000))


def test_distvite_modularity_and_run(rmat_bin):
    """``modularity`` equals the host oracle on the identity and on a run's
    labels; the run equals full ingest on 4 shards (every shard local)."""
    path, g = rmat_bin
    dv = DistVite.load(path, 4, bits64=False)
    ident = np.arange(dv.total_padded_vertices)
    assert dv.modularity(ident) == pytest.approx(
        modularity(g, np.arange(g.num_vertices)), abs=1e-12)
    res = louvain_phases(dv, device="cpu")
    full = louvain_phases(g, nshards=4, device="cpu", exchange="sparse")
    assert np.array_equal(res.communities, full.communities)
    assert [p.iterations for p in res.phases] == \
        [p.iterations for p in full.phases]
    assert res.modularity == pytest.approx(full.modularity, abs=1e-12)
    comm_pad = np.zeros(dv.total_padded_vertices, dtype=np.int64)
    comm_pad[dv.old_to_pad] = res.communities
    assert dv.modularity(comm_pad) == pytest.approx(
        modularity(g, res.communities), abs=1e-12)


def test_distvite_refusals(rmat_bin, tmp_path):
    """The replicated exchange, other engines and another shard count
    raise; so do the CLI's incompatible flags."""
    from cuvite_tpu_torch.cli import main

    path, _ = rmat_bin
    dv = DistVite.load(path, 4, bits64=False)
    with pytest.raises(ValueError, match="sparse"):
        louvain_phases(dv, device="cpu", exchange="replicated")
    with pytest.raises(ValueError, match="bucketed"):
        louvain_phases(dv, device="cpu", engine="sort")
    with pytest.raises(ValueError, match="partition"):
        louvain_phases(dv, device="cpu", nshards=8)
    for argv, msg in (
            (["--rmat", "8", "--shards", "2"], "requires --file"),
            (["--file", path], "--shards >= 2"),
            (["--file", path, "--shards", "2", "--engine", "sort"],
             "bucketed"),
            (["--file", path, "--shards", "2", "-s", str(tmp_path / "x")],
             "write-graph")):
        with pytest.raises(SystemExit, match=msg):
            main([*argv, "--dist-ingest", "--device", "cpu"])


def test_two_ranks_read_only_their_shards(rmat_bin, tmp_path):
    """A world of 2 on 4 shards: rank r reads shards [2r, 2r + 2) alone
    (the others' ``src is None``) and fewer bytes than the file; labels,
    iterations and Q equal full ingest on every rank."""
    path, g = rmat_bin
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    outs = launch([sys.executable, "-c", WORKER, path, "4", str(tmp_path)],
                  2, f"file://{tmp_path / 'store'}", env=env, timeout=120)
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r} exited {rc}:\n{out}\n{err[-3000:]}"
    full = louvain_phases(g, nshards=4, device="cpu", exchange="sparse")
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["local"] == [2 * r, 2 * r + 2]
        assert got["held"] == [2 * r, 2 * r + 1]
        assert got["bytes_read"] < os.path.getsize(path)
        assert np.array_equal(got["labels"], full.communities)
        assert got["iters"] == [p.iterations for p in full.phases]
        assert got["q"] == pytest.approx(full.modularity, abs=1e-12)


@pytest.fixture(scope="module")
def karate_bin(tmp_path_factory):
    nx = pytest.importorskip("networkx")
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int64)
    g = Graph.from_edges(34, e[:, 0], e[:, 1])
    path = str(tmp_path_factory.mktemp("kar") / "karate.bin")
    write_vite(path, g, bits64=False)
    return path, g


@pytest.mark.parametrize("balanced", [False, True])
def test_content_fingerprint_matches_jax(karate_bin, rmat_bin, balanced):
    """DistVite.content_fingerprint equals the reference's on karate at 8
    shards and R-MAT 10 at 4, uniform and edge-balanced, so a checkpoint
    of a per-rank run crosses packages; it covers the partition (another
    shard count or balance gives another value)."""
    seen = set()
    for (path, _), S in ((karate_bin, 8), (rmat_bin, 4)):
        fp = DistVite.load(path, S, bits64=False,
                           balanced=balanced).content_fingerprint()
        assert fp == JDistVite.load(path, S, bits64=False,
                                    balanced=balanced).content_fingerprint()
        seen.add(fp)
    other = DistVite.load(rmat_bin[0], 2, bits64=False, balanced=balanced)
    assert other.content_fingerprint() not in seen


@pytest.mark.parametrize("n_hash", [1, 4])
def test_coloring_dist_matches_full_and_jax(rmat_bin, n_hash):
    """multi_hash_coloring_dist on a DistVite: colors and count equal to
    multi_hash_coloring on the whole edge list and to the reference's
    multi_hash_coloring_dist."""
    from cuvite_tpu.louvain.coloring import \
        multi_hash_coloring_dist as jax_coloring_dist
    from cuvite_tpu_torch.louvain.coloring import (
        multi_hash_coloring,
        multi_hash_coloring_dist,
    )

    path, g = rmat_bin
    got, n = multi_hash_coloring_dist(DistVite.load(path, 4, bits64=False),
                                      n_hash=n_hash, device="cpu")
    full, nf = multi_hash_coloring(g.sources().astype(np.int32),
                                   g.tails.astype(np.int32), g.num_vertices,
                                   n_hash=n_hash, device="cpu")
    ref, nr = jax_coloring_dist(JDistVite.load(path, 4, bits64=False),
                                n_hash=n_hash)
    assert n == nf == nr
    assert np.array_equal(got, full) and np.array_equal(got, ref)


@pytest.mark.parametrize("kw", [{"coloring": 8}, {"vertex_ordering": 8},
                                {"et_mode": 3}])
def test_distvite_schedules_match_full_ingest(rmat_bin, kw):
    """Coloring, vertex ordering and ET on a DistVite (one process, every
    shard local): the labels, iterations and Q of full ingest on the same
    shards under the sparse exchange, and of one shard."""
    path, g = rmat_bin
    res = louvain_phases(DistVite.load(path, 4, bits64=False), device="cpu",
                         **kw)
    for full in (louvain_phases(g, nshards=4, device="cpu",
                                exchange="sparse", **kw),
                 louvain_phases(g, device="cpu", **kw)):
        assert np.array_equal(res.communities, full.communities)
        assert [p.iterations for p in res.phases] == \
            [p.iterations for p in full.phases]
        assert res.modularity == pytest.approx(full.modularity, abs=1e-12)


def test_distvite_checkpoint_resume(rmat_bin, tmp_path):
    """A DistVite run stopped after one phase resumes from the
    checkpoint's coarse graph to the uninterrupted run's labels; the
    checkpoint carries content_fingerprint, so another partition of the
    same file and the full-ingest graph are refused."""
    path, g = rmat_bin
    d = str(tmp_path / "ck")
    dv = DistVite.load(path, 4, bits64=False)
    full = louvain_phases(dv, device="cpu", coloring=8)
    part = louvain_phases(dv, device="cpu", coloring=8, checkpoint_dir=d,
                          max_phases=1)
    assert len(part.phases) == 1 < len(full.phases)
    res = louvain_phases(DistVite.load(path, 4, bits64=False), device="cpu",
                         coloring=8, checkpoint_dir=d, resume=True)
    assert np.array_equal(res.communities, full.communities)
    assert [p.iterations for p in res.phases] == \
        [p.iterations for p in full.phases]
    for other in (DistVite.load(path, 4, bits64=False, balanced=True), g):
        with pytest.raises(ValueError, match="fingerprint"):
            louvain_phases(other, nshards=4, device="cpu", exchange="sparse",
                           checkpoint_dir=d, resume=True)


WORLD_SCHEDULES = r"""
import json, sys
from cuvite_tpu_torch.comm import multihost
path, out = sys.argv[1], sys.argv[2]
multihost.initialize(device="cpu", timeout=60)
with multihost.fail_together():
    from cuvite_tpu_torch.io.dist_ingest import DistVite
    from cuvite_tpu_torch.louvain.driver import louvain_phases
    res = {}
    for name, kw in (("color", {"coloring": 8}),
                     ("part", {"coloring": 8, "max_phases": 1,
                               "checkpoint_dir": out + "/ck"}),
                     ("resume", {"coloring": 8, "resume": True,
                                 "checkpoint_dir": out + "/ck"})):
        dv = DistVite.load(path, 4, bits64=False)
        r = louvain_phases(dv, **kw)
        res[name] = {"labels": r.communities.tolist(),
                     "iters": [p.iterations for p in r.phases]}
    res["fp"] = dv.content_fingerprint()
    with open(f"{out}/rank{multihost.rank()}.json", "w") as f:
        json.dump(res, f)
    multihost.shutdown()
"""


def test_two_ranks_color_and_resume(rmat_bin, tmp_path):
    """A world of 2 on a DistVite of 4 shards: coloring=8 (colors by
    multi_hash_coloring_dist over each rank's own edges), then a run
    stopped after one phase and resumed from the shared checkpoint
    directory, rank 0 alone writing; every rank's labels equal the
    one-process full-ingest run's, and the fingerprint the one-process
    DistVite's."""
    path, g = rmat_bin
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    outs = launch([sys.executable, "-c", WORLD_SCHEDULES, path,
                   str(tmp_path)], 2, f"file://{tmp_path / 'store'}",
                  env=env, timeout=120)
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r} exited {rc}:\n{out}\n{err[-3000:]}"
    want = louvain_phases(g, nshards=4, device="cpu", exchange="sparse",
                          coloring=8)
    fp = DistVite.load(path, 4, bits64=False).content_fingerprint()
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        for name in ("color", "resume"):
            assert np.array_equal(got[name]["labels"], want.communities)
            assert got[name]["iters"] == [p.iterations for p in want.phases]
        assert len(got["part"]["iters"]) == 1
        assert got["fp"] == fp
    names = sorted(os.listdir(tmp_path / "ck"))
    assert names[0] == "phase_0001.npz"
    assert all(n.startswith("phase_") and n.endswith(".npz") for n in names)
