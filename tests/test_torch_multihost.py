"""cuvite_tpu_torch's multi-process mesh (``comm/multihost.py``) on the
CPU: worlds of 2 and 4 gloo ranks, each a subprocess of this test with a
``file://`` store in ``tmp_path`` (no port) and one thread, held against
the port's one-process mesh and the JAX package's one-process mesh of the
same shard count.

Each world reads one Vite file written from the reference's graph and
runs every configuration of its case in one process group: R-MAT 10 and
RGG 4096 on 4 and 8 shards under the replicated and the sparse exchange,
and the sort engine under the replicated one.  Every rank must return
the labels, per-phase iterations and Q bits of the one-process port mesh;
labels and iterations equal the reference's, Q to 1e-9 (both report the
host f64 oracle).  Also: a budget of 1 overflows and is retried on every
rank alike, a rank that raises ends the whole world non-zero within the
timeout, and ``--distributed`` in the CLI has rank 0 alone write the
communities file, equal to the one-process ``--shards S`` run's.  ET,
coloring and a checkpoint resume run in a world too, and ranks that load
different checkpoint states from a directory that is not shared all
raise instead of waiting on each other.  The two-level exchange on a 2x2
hybrid mesh runs in worlds of 2 (each rank one ICI group, the DCN
columns across the ranks) and 4 (both axes across the ranks), and in a
world of 2 on 4x2 (two whole groups a rank), with ET, the budget retry
and a checkpoint resume, every rank equal to the one-process hybrid
run.
"""

import json
import os
import sys
import time

import jax
import numpy as np
import pytest

from cuvite_tpu.io.generate import generate_rgg as jax_rgg
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.comm.multihost import launch
from cuvite_tpu_torch.io.vite import write_vite

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120.0

# One rank: join the gloo world named by the launcher's environment, run
# each configuration of the spec, write the results to out/rank<r>.json.
WORKER = r"""
import json, sys
from cuvite_tpu_torch.comm import multihost
spec = json.loads(sys.argv[1])
multihost.initialize(device="cpu", timeout=60)
with multihost.fail_together():
    from cuvite_tpu_torch.io.vite import read_vite
    from cuvite_tpu_torch.louvain.driver import louvain_phases
    r = multihost.rank()
    if spec.get("fail_rank") == r:
        raise RuntimeError(f"rank {r} fails on purpose")
    g = read_vite(spec["file"], bits64=False)
    out = []
    for kw in spec["runs"]:
        res = louvain_phases(g, verbose=spec.get("verbose", False), **kw)
        print("run done", flush=True)
        out.append({"labels": res.communities.tolist(),
                    "iters": [p.iterations for p in res.phases],
                    "q": res.modularity.hex(),
                    "mode": (res.exchange_stats or {}).get("mode")})
    with open(f"{spec['out']}/rank{r}.json", "w") as f:
        json.dump(out, f)
    multihost.shutdown()
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def _world(tmp_path, nprocs, spec, argv=None):
    """Run one world; returns [(rc, stdout, stderr)] per rank and the
    wall seconds."""
    t0 = time.monotonic()
    outs = launch(argv or [sys.executable, "-c", WORKER, json.dumps(spec)],
                  nprocs, f"file://{tmp_path / 'store'}", env=_env(),
                  timeout=TIMEOUT, cwd=str(tmp_path))
    return outs, time.monotonic() - t0


def _ok(outs):
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r} exited {rc}:\n{out}\n{err[-3000:]}"


def _port_graph(jg):
    return Graph.from_arrays(jg.offsets, jg.tails, jg.weights)


@pytest.fixture(scope="module", autouse=True)
def _free_jax_programs():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """The reference's graphs and their 32-bit Vite files (int32 ids and
    f32 weights, the dtypes of the in-process graphs)."""
    d = tmp_path_factory.mktemp("graphs")
    out = {}
    for name, jg in (("rmat10", jax_rmat(10)), ("rgg4096", jax_rgg(4096))):
        path = str(d / f"{name}.bin")
        write_vite(path, _port_graph(jg), bits64=False)
        out[name] = (jg, path)
    return out


# Each world: its rank count and the configurations it runs.
_CONFIGS = [dict(nshards=4, exchange="replicated"),
            dict(nshards=4, exchange="sparse"),
            dict(nshards=8, exchange="replicated"),
            dict(nshards=8, exchange="sparse"),
            dict(nshards=4, exchange="replicated", engine="sort")]


@pytest.mark.parametrize("name", ["rmat10", "rgg4096"])
def test_worlds_match_one_process_and_jax(graphs, name, tmp_path):
    """Worlds of 2 and 4 ranks, every configuration: each rank's labels,
    iterations and Q bits equal the one-process port mesh's; labels and
    iterations equal the JAX one-process mesh's, Q to 1e-9."""
    jg, path = graphs[name]
    g = _port_graph(jg)
    want = []
    for kw in _CONFIGS:
        mine = louvain_phases(g, device="cpu", **kw)
        ref = jax_louvain(jg, **kw)
        assert np.array_equal(mine.communities, ref.communities), kw
        assert [p.iterations for p in mine.phases] == \
            [p.iterations for p in ref.phases], kw
        assert abs(mine.modularity - ref.modularity) <= 1e-9, kw
        want.append(mine)
    for nprocs in (2, 4):
        d = tmp_path / f"w{nprocs}"
        d.mkdir()
        outs, wall = _world(d, nprocs, {"file": path, "out": str(d),
                                        "runs": _CONFIGS})
        _ok(outs)
        assert wall < TIMEOUT
        for r in range(nprocs):
            got = json.loads((d / f"rank{r}.json").read_text())
            for kw, res, mine in zip(_CONFIGS, got, want):
                assert np.array_equal(res["labels"], mine.communities), \
                    (nprocs, r, kw)
                assert res["iters"] == [p.iterations for p in mine.phases]
                assert res["q"] == mine.modularity.hex()
                assert res["mode"] == mine.exchange_stats["mode"]


def test_budget_overflow_retries_on_every_rank(graphs, tmp_path):
    """A sparse budget of 1 overflows: every rank retries the same sweeps
    with the same grown budgets and ends with the unbudgeted labels."""
    jg, path = graphs["rmat10"]
    g = _port_graph(jg)
    kw = dict(nshards=4, exchange="sparse", exchange_budget=1)
    want = louvain_phases(g, device="cpu", nshards=4, exchange="sparse")
    outs, _ = _world(tmp_path, 2, {"file": path, "out": str(tmp_path),
                                   "runs": [kw], "verbose": True})
    _ok(outs)
    retries = [[ln for ln in out.splitlines() if "budget overflow" in ln]
               for _, out, _ in outs]
    assert retries[0] and retries[0] == retries[1]
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())[0]
        assert np.array_equal(got["labels"], want.communities)
        assert got["q"] == want.modularity.hex()


def test_a_failing_rank_ends_the_world(graphs, tmp_path):
    """Rank 1 raises before its first collective while rank 0 waits in
    one: both exit 1 on their own, well inside the timeout."""
    _, path = graphs["rmat10"]
    outs, wall = _world(tmp_path, 2, {
        "file": path, "out": str(tmp_path), "fail_rank": 1,
        "runs": [dict(nshards=4, exchange="sparse")]})
    assert [rc for rc, _, _ in outs] == [1, 1], outs
    assert "fails on purpose" in outs[1][2]
    assert "rank 0 failed" in outs[0][2]
    assert wall < TIMEOUT / 2


@pytest.mark.parametrize("ingest", ["full", "dist"])
def test_cli_distributed_rank0_writes(graphs, ingest, tmp_path):
    """``--distributed --shards 4 -o --json`` in a world of 2: rank 0 alone
    prints and writes; its communities file and summary equal the
    one-process ``--shards 4`` run's (``--dist-ingest``: each rank read
    only its shards)."""
    from cuvite_tpu_torch.cli import main

    _, path = graphs["rmat10"]
    flags = ["--shards", "4", "--device", "cpu", "-o", "--json"]
    if ingest == "dist":
        flags += ["--dist-ingest"]
    one = tmp_path / "one"
    many = tmp_path / "many"
    for d in (one, many):
        d.mkdir()
        os.link(path, d / "g.bin")
    assert main(["--file", str(one / "g.bin"), "--quiet", *flags]) == 0
    outs, _ = _world(many, 2, None, argv=[
        sys.executable, "-m", "cuvite_tpu_torch.cli", "--distributed",
        "--file", str(many / "g.bin"), *flags])
    _ok(outs)
    assert outs[1][1] == ""          # rank 1 prints nothing
    rec = json.loads(outs[0][1].strip().splitlines()[-1])
    assert rec["graph"] == str(many / "g.bin")
    want = np.loadtxt(one / "g.bin.communities", dtype=np.int64)
    got = np.loadtxt(many / "g.bin.communities", dtype=np.int64)
    assert np.array_equal(got, want)
    assert sorted(p.name for p in many.iterdir()
                  if p.name.endswith(".communities")) == \
        ["g.bin.communities"]


HOST_RANK = r"""
import json
import numpy as np
from cuvite_tpu_torch.comm import multihost
from cuvite_tpu_torch.comm.mesh import make_mesh
multihost.initialize(device="cpu", timeout=60)
with multihost.fail_together():
    r = multihost.rank()
    from cuvite_tpu_torch import Graph, louvain_phases
    g = Graph.from_edges(4, np.array([0, 1]), np.array([1, 2]))
    refused = []
    for call in (lambda: make_mesh(3), lambda: make_mesh(2, devices=["cpu"]),
                 lambda: louvain_phases(g)):
        try:
            call()
        except ValueError as e:
            refused.append(str(e))
    mesh = make_mesh(4)
    print(json.dumps({
        "range": multihost.local_shard_range(5),
        "mesh": [mesh.size, list(mesh.shard_ids), str(mesh.devices[0])],
        "sum": multihost.allreduce_sum_host(0.5 + r),
        "max": multihost.allreduce_max_host(np.array([r, 10 - r])).tolist(),
        "varlen": [a.tolist() for a in multihost.allgather_varlen(
            np.arange(r + 1, dtype=np.int64) * 3)],
        "global": multihost.gather_global(
            np.full(2, r, dtype=np.int32)).tolist(),
        "refused": refused}))
    # The mesh holds the group: drop it before the group goes, or the
    # group object outlives it into interpreter exit, where its
    # destruction aborts the rank (status -6) now and then.
    del mesh
    multihost.shutdown()
"""


def test_host_collectives_and_mesh_view(tmp_path, monkeypatch):
    """A world of 2: each rank's shard range and mesh view, the host
    collectives in rank order, and the refusals of a shard count the
    world does not divide (one shard included) and of devices= under a
    group.  Outside a
    group, a distributed run without a world size or rank raises."""
    outs, _ = _world(tmp_path, 2, None,
                     argv=[sys.executable, "-c", HOST_RANK])
    _ok(outs)
    got = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]
    for r, rec in enumerate(got):
        assert rec["range"] == [[0, 3], [3, 5]][r]
        assert rec["mesh"] == [4, [2 * r, 2 * r + 1], "cpu"]
        assert rec["sum"] == 2.0 and rec["max"] == [1, 10]
        assert rec["varlen"] == [[0], [0, 3]]
        assert rec["global"] == [0, 0, 1, 1]
        assert "multiple of the world size" in rec["refused"][0]
        assert "own device" in rec["refused"][1]
        assert "not 1" in rec["refused"][2]
    from cuvite_tpu_torch.cli import main
    from cuvite_tpu_torch.comm import multihost

    for var in ("CUVITE_NUM_PROCESSES", "CUVITE_PROCESS_ID", "WORLD_SIZE",
                "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not multihost.is_distributed()
    with pytest.raises(RuntimeError, match="not initialized"):
        multihost.local_device()
    with pytest.raises(RuntimeError, match="world size or rank"):
        main(["--rmat", "8", "--distributed", "--device", "cpu"])


def test_world_schedules_and_checkpoints(graphs, tmp_path):
    """A world of 2 on R-MAT 10, 4 shards: et_mode 3 under the replicated
    exchange, coloring 8 under the sparse one, and coloring 8 stopped
    after one phase, then resumed from the shared checkpoint directory
    (rank 0 alone writes); every rank's labels, iterations and Q bits
    equal the one-process mesh's, and the resumed run the uninterrupted
    one's."""
    jg, path = graphs["rmat10"]
    g = _port_graph(jg)
    ck = str(tmp_path / "ck")
    runs = [dict(nshards=4, exchange="replicated", et_mode=3),
            dict(nshards=4, exchange="sparse", coloring=8),
            dict(nshards=4, exchange="sparse", coloring=8, max_phases=1,
                 checkpoint_dir=ck),
            dict(nshards=4, exchange="sparse", coloring=8, resume=True,
                 checkpoint_dir=ck)]
    want = [louvain_phases(g, device="cpu", **kw) for kw in runs[:2]]
    outs, wall = _world(tmp_path, 2, {"file": path, "out": str(tmp_path),
                                      "runs": runs})
    _ok(outs)
    assert wall < TIMEOUT
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        for res, mine in zip(got[:2] + got[3:], want + want[1:]):
            assert np.array_equal(res["labels"], mine.communities)
            assert res["iters"] == [p.iterations for p in mine.phases]
            assert res["q"] == mine.modularity.hex()
        assert len(got[2]["iters"]) == 1


@pytest.mark.parametrize("nprocs,shape", [(2, (2, 2)), (4, (2, 2)),
                                          (2, (4, 2))])
def test_world_twolevel_matches_one_process(graphs, nprocs, shape,
                                            tmp_path):
    """The two-level exchange in a world (sub-groups over the ranks of
    each ICI group and DCN column that spans several): every rank's
    labels, iterations and Q bits equal the one-process hybrid run's,
    under ET mode 3 and a budget of 1 (retried alike on every rank) too,
    and a run stopped after one phase and resumed from the shared
    checkpoint directory equals the uninterrupted one."""
    jg, path = graphs["rmat10"]
    g = _port_graph(jg)
    ck = str(tmp_path / "ck")
    runs = [dict(mesh_shape=list(shape)),
            dict(mesh_shape=list(shape), et_mode=3),
            dict(mesh_shape=list(shape), exchange_budget=1),
            dict(mesh_shape=list(shape), max_phases=1, checkpoint_dir=ck),
            dict(mesh_shape=list(shape), resume=True, checkpoint_dir=ck)]
    want = [louvain_phases(g, device="cpu", **kw) for kw in runs[:3]]
    outs, wall = _world(tmp_path, nprocs, {"file": path,
                                           "out": str(tmp_path),
                                           "runs": runs})
    _ok(outs)
    assert wall < TIMEOUT
    for r in range(nprocs):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        for res, mine in zip(got[:3] + got[4:], want + want[:1]):
            assert np.array_equal(res["labels"], mine.communities)
            assert res["iters"] == [p.iterations for p in mine.phases]
            assert res["q"] == mine.modularity.hex()
            assert res["mode"] == "twolevel"
        assert len(got[3]["iters"]) == 1


MISMATCH_RANK = r"""
import sys
import numpy as np
from cuvite_tpu_torch.comm import multihost
multihost.initialize(device="cpu", timeout=60)
with multihost.fail_together():
    from cuvite_tpu_torch.io.vite import read_vite
    from cuvite_tpu_torch.louvain.driver import louvain_phases
    g = read_vite(sys.argv[1], bits64=False)
    louvain_phases(g, nshards=4, checkpoint_dir=sys.argv[2 + multihost.rank()],
                   resume=True)
    multihost.shutdown()
"""


def test_ranks_that_load_different_checkpoints_raise(graphs, tmp_path):
    """Rank 0 resumes from a directory holding a checkpoint, rank 1 from
    an empty one (a directory that is not shared): the all-gather of
    [phase, fingerprint] refuses on both ranks, both exit 1 with the
    message, and neither waits for the other."""
    jg, path = graphs["rmat10"]
    ck0, ck1 = tmp_path / "ck0", tmp_path / "ck1"
    ck1.mkdir()
    louvain_phases(_port_graph(jg), device="cpu", nshards=4, max_phases=1,
                   checkpoint_dir=str(ck0))
    outs, wall = _world(tmp_path, 2, None, argv=[
        sys.executable, "-c", MISMATCH_RANK, path, str(ck0), str(ck1)])
    assert [rc for rc, _, _ in outs] == [1, 1], outs
    for _, _, err in outs:
        assert "shared storage" in err
    assert wall < TIMEOUT / 2
