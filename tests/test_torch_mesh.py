"""cuvite_tpu_torch on a vertex mesh, held against the JAX package's mesh
path on the CPU: the mesh and its collectives, the multi-shard DistGraph
and stacked plans array for array, one sharded bucketed sweep under both
exchanges and one sharded sort sweep against the reference's shard_map'd
steps (with a hub on the heavy kernel's twin and on the sorted path),
whole runs against the port's one shard and the reference at the same
shard count, the mesh options that run (ET, coloring, ordering and
checkpoints) and those refused, and the command line.

JAX runs on the conftest's 8 virtual CPU devices, the port on
make_mesh(devices=["cpu"] * S).  Every graph has integer weights (the
exactness domain of the float sums); Q is compared to 1e-6 against the
reference's f32 in-loop value and to 1e-9 where both report the host f64
oracle.
"""

import json

import jax
import numpy as np
import pytest
import torch

from cuvite_tpu.comm.exchange import ExchangePlan as JExchangePlan
from cuvite_tpu.comm.mesh import make_mesh as jax_mesh
from cuvite_tpu.core.distgraph import DistGraph as JDistGraph
from cuvite_tpu.core.graph import Graph as JGraph
from cuvite_tpu.io.generate import generate_rgg as jax_rgg
from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain import bucketed as jb
from cuvite_tpu.louvain.driver import PhaseRunner as JPhaseRunner
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.comm.collectives import all_gather, all_to_all, psum
from cuvite_tpu_torch.comm.exchange import ExchangePlan
from cuvite_tpu_torch.comm.mesh import Mesh, make_mesh, shard_1d
from cuvite_tpu_torch.core.distgraph import DistGraph
from cuvite_tpu_torch.louvain.bucketed import (
    MeshPlan,
    build_stacked_plans,
    sharded_bucketed_step,
)
from cuvite_tpu_torch.louvain.driver import MeshPhaseRunner

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _port_graph(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def rmat9():
    return jax_rmat(9, edge_factor=8, seed=2)


@pytest.fixture(scope="module")
def rmat10():
    return jax_rmat(10)


@pytest.fixture(scope="module")
def hub_graph():
    """One vertex of degree 8400, above the widest bucket (8192)."""
    rng = np.random.default_rng(0)
    nv = 9000
    hub_dst = rng.choice(np.arange(1, nv), size=8400, replace=False)
    src = np.concatenate([np.zeros(8400, np.int64),
                          rng.integers(1, nv, 12000)])
    dst = np.concatenate([hub_dst, rng.integers(1, nv, 12000)])
    return JGraph.from_edges(nv, src, dst)


@pytest.fixture(scope="module")
def karate():
    nx = pytest.importorskip("networkx")
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int64)
    return JGraph.from_edges(34, e[:, 0], e[:, 1])


def test_make_mesh_and_shard_1d():
    """Without devices, a mesh needs as many visible cards as shards (the
    CPU-only sandbox has none); devices given place shards anywhere,
    repeats allowed."""
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match="visible"):
        make_mesh(visible + 1)
    m = make_mesh(devices=["cpu"] * 4)
    assert isinstance(m, Mesh) and m.size == 4 and m.axis_name == "v"
    assert make_mesh(4, devices=["cpu"] * 4) == m
    with pytest.raises(ValueError, match="devices were given"):
        make_mesh(3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="empty"):
        make_mesh(devices=[])
    blocks = shard_1d(m, np.arange(8, dtype=np.int32))
    assert [b.tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="equal blocks"):
        shard_1d(m, np.arange(6))


def test_collectives():
    """all_gather tiles in shard order, psum sums in shard order,
    all_to_all transposes [S, ...] blocks."""
    m = _cpu_mesh(3)
    xs = [torch.tensor([s, 10 + s], dtype=torch.int32) for s in range(3)]
    assert all(g.tolist() == [0, 10, 1, 11, 2, 12]
               for g in all_gather(xs, m))
    tot = psum([torch.tensor(0.5, dtype=torch.float64)] * 3, m)
    assert all(t.dtype == torch.float64 and float(t) == 1.5 for t in tot)
    blocks = [torch.arange(6).view(3, 2) + 100 * s for s in range(3)]
    ys = all_to_all(blocks, m)
    for t in range(3):
        for s in range(3):
            assert ys[t][s].tolist() == blocks[s][t].tolist()


@pytest.mark.parametrize("nshards", [2, 4, 8])
@pytest.mark.parametrize("balanced", [False, True])
def test_distgraph_matches_jax(rmat9, nshards, balanced):
    """The multi-shard build array for array: partition, padded sizes, id
    maps, every shard's slab, degrees, mask and the stacked edges."""
    jdg = JDistGraph.build(rmat9, nshards, balanced=balanced)
    dg = DistGraph.build(_port_graph(rmat9), nshards, balanced=balanced)
    assert (dg.nshards, dg.nv_pad, dg.ne_pad) == \
        (jdg.nshards, jdg.nv_pad, jdg.ne_pad)
    assert dg.total_padded_vertices == jdg.total_padded_vertices
    for mine, ref in ((dg.parts, jdg.parts), (dg.old_to_pad, jdg.old_to_pad),
                      (dg.pad_to_old, jdg.pad_to_old),
                      (dg.padded_weighted_degrees(),
                       jdg.padded_weighted_degrees()),
                      (dg.vertex_mask(), jdg.vertex_mask()),
                      *zip(dg.stacked_edges(), jdg.stacked_edges())):
        assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
    for sh, jsh in zip(dg.shards, jdg.shards):
        assert (sh.base, sh.bound, sh.n_real_edges) == \
            (jsh.base, jsh.bound, jsh.n_real_edges)
        for f in ("src", "dst", "w"):
            assert np.array_equal(getattr(sh, f), getattr(jsh, f))
    assert dg.owner_of_padded(dg.nv_pad) == 1


def test_distgraph_floors_match_jax(rmat9):
    """min_nv_pad / min_ne_pad floors and pad_pow2=False, as the
    reference builds them."""
    g = _port_graph(rmat9)
    for kw in ({"min_nv_pad": 1024, "min_ne_pad": 1 << 14},
               {"pad_pow2": False}):
        jdg = JDistGraph.build(rmat9, 3, **kw)
        dg = DistGraph.build(g, 3, **kw)
        assert (dg.nv_pad, dg.ne_pad) == (jdg.nv_pad, jdg.ne_pad)
        for a, b in zip(dg.stacked_edges(), jdg.stacked_edges()):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("exchange", ["replicated", "sparse"])
@pytest.mark.parametrize("nshards", [2, 4])
def test_stacked_plans_match_jax(rmat9, exchange, nshards):
    """Each shard's plan equals its block of the reference's stacked plan
    array for array (the block's tail past the plan's rows is the
    reference's common-shape padding), both exchanges."""
    jdg = JDistGraph.build(rmat9, nshards)
    dg = DistGraph.build(_port_graph(rmat9), nshards)
    jxp = xp = None
    if exchange == "sparse":
        jxp, xp = JExchangePlan.build(jdg), ExchangePlan.build(dg)
    ref = jb.build_stacked_plans(jdg, exchange_plan=jxp)
    plans = build_stacked_plans(dg, exchange_plan=xp)
    nvl = dg.nv_pad
    widths = sorted({b.width for p in plans for b in p.buckets})
    assert widths == [b[1].shape[1] for b in ref.buckets]
    for (rv, rd, rw), width in zip(ref.buckets, widths):
        nb = len(rv) // nshards
        for r, p in enumerate(plans):
            blk = slice(r * nb, (r + 1) * nb)
            b = {x.width: x for x in p.buckets}.get(width)
            n = 0 if b is None else len(b.verts)
            if b is not None:
                assert np.array_equal(b.verts, rv[blk][:n])
                assert np.array_equal(b.dst, rd[blk][:n])
                assert np.array_equal(b.w.astype(np.float32), rw[blk][:n])
            assert (rv[blk][n:] == nvl).all()
    hn = len(ref.heavy[0]) // nshards
    for r, p in enumerate(plans):
        for mine, stacked in zip((p.heavy_src, p.heavy_dst, p.heavy_w),
                                 ref.heavy):
            assert np.array_equal(mine, stacked[r * hn:][:len(mine)])
    assert np.array_equal(np.concatenate([p.self_loop for p in plans]),
                          ref.self_loop)


def _counter0_oracle(dg, comm):
    """Weight of each padded vertex's edges into its own community, f64."""
    out = np.zeros(dg.total_padded_vertices)
    for s, sh in enumerate(dg.shards):
        real = sh.src < dg.nv_pad
        src = sh.src[real].astype(np.int64) + s * dg.nv_pad
        dst = sh.dst[real].astype(np.int64)
        same = comm[src] == comm[dst]
        out += np.bincount(src[same], weights=sh.w[real][same],
                           minlength=len(out))
    return out


def _mesh_plan(dg, mesh, exchange, budget=0):
    xp = ExchangePlan.build(dg) if exchange == "sparse" else None
    vd = shard_1d(mesh, dg.padded_weighted_degrees().astype(np.float32))
    return MeshPlan.upload(build_stacked_plans(dg, exchange_plan=xp), mesh,
                           dg.nv_pad, vd, exchange=exchange, xplan=xp,
                           budget=budget), vd


@pytest.mark.parametrize("graph,nshards,exchange", [
    ("rmat10", 2, "replicated"), ("rmat10", 4, "sparse"),
    ("rmat10", 2, "sparse"), ("rmat10", 4, "replicated"),
    ("hub_graph", 2, "replicated"), ("hub_graph", 2, "sparse")])
def test_sharded_bucketed_sweeps_match_jax(graph, nshards, exchange,
                                           request):
    """Three sweeps of the port's sharded bucketed step against the
    reference's make_sharded_bucketed_step from the same assignments:
    targets and n_moved identical, no overflow, Q to 1e-6, counter0 equal
    to the f64 oracle.  The hub graph puts its hub on the heavy kernel's
    twin (replicated) and on the sorted path with sizes (sparse)."""
    jg = request.getfixturevalue(graph)
    jdg = JDistGraph.build(jg, nshards)
    jr = JPhaseRunner(jdg, mesh=jax_mesh(nshards), engine="bucketed",
                      exchange=exchange)
    dg = DistGraph.build(_port_graph(jg), nshards)
    mesh = _cpu_mesh(nshards)
    mp, vd = _mesh_plan(dg, mesh, exchange, jr.budget or 0)
    c = 1.0 / dg.graph.total_edge_weight_twice()
    comm, comms = jr.comm0, shard_1d(mesh, np.asarray(jr.comm0))
    for _ in range(3):
        t, q, moved, ovf = jr._step(None, None, None, comm, jr.vdeg,
                                    jr.constant)
        res = sharded_bucketed_step(mp, comms, vd, c)
        assert np.array_equal(np.asarray(t), torch.cat(res.targets).numpy())
        assert int(moved) == int(res.n_moved)
        assert not bool(ovf) and not bool(res.overflow)
        assert abs(float(q) - float(res.modularity)) <= 1e-6
        c0 = _counter0_oracle(dg, np.asarray(comm).astype(np.int64))
        assert np.array_equal(torch.cat(res.counter0).double().numpy(), c0)
        comm, comms = t, res.targets


@pytest.mark.parametrize("nshards", [2, 4])
def test_sharded_sort_sweeps_match_jax(rmat10, nshards):
    """The sort engine's sharded step against the reference's
    make_sharded_step: targets and n_moved identical, Q to 1e-6."""
    jr = JPhaseRunner(JDistGraph.build(rmat10, nshards),
                      mesh=jax_mesh(nshards), engine="sort",
                      exchange="replicated")
    dg = DistGraph.build(_port_graph(rmat10), nshards)
    r = MeshPhaseRunner(dg, _cpu_mesh(nshards), engine="sort")
    comm, comms = jr.comm0, r.comm0
    for _ in range(3):
        t, q, moved, _ = jr._step(jr.src, jr.dst, jr.w, comm, jr.vdeg,
                                  jr.constant)
        res = r.step(comms)
        assert np.array_equal(np.asarray(t), torch.cat(res.targets).numpy())
        assert int(moved) == int(res.n_moved)
        assert abs(float(q) - float(res.modularity)) <= 1e-6
        comm, comms = t, res.targets


@pytest.mark.parametrize("graph", ["karate", "rmat10", "rgg4096"])
@pytest.mark.parametrize("exchange", ["replicated", "sparse"])
def test_whole_runs_match_one_shard_and_jax(graph, exchange, request):
    """louvain_phases on 2 and 4 shards: labels, phases and iterations
    identical to the port's one shard and Q to 1e-9; and to the reference
    at 4 shards (karate, R-MAT 10) or 2 (RGG 4096), same exchange."""
    jg = (jax_rgg(4096) if graph == "rgg4096"
          else request.getfixturevalue(graph))
    g = _port_graph(jg)
    r1 = louvain_phases(g, device="cpu")

    def same(a, b, tol):
        assert np.array_equal(a.communities, b.communities)
        assert [p.iterations for p in a.phases] == \
            [p.iterations for p in b.phases]
        assert abs(a.modularity - b.modularity) <= tol

    for S in (2, 4):
        rn = louvain_phases(g, nshards=S, device="cpu", exchange=exchange)
        same(rn, r1, 1e-9)
        assert rn.exchange_stats["mode"] == exchange
    S = 2 if graph == "rgg4096" else 4
    rn = louvain_phases(g, nshards=S, device="cpu", exchange=exchange,
                        balanced=True)
    same(rn, r1, 1e-9)
    same(rn, jax_louvain(jg, nshards=S, exchange=exchange, balanced=True),
         1e-9)


def test_size_form_inside_sharded_step_matches_sort(rmat10, monkeypatch):
    """tests/test_pallas_spmd.py:40 on the port: on 8 shards the sparse
    sweep sends every bucket through the row kernel's size form (a spy
    sees its calls, and no non-size call), the replicated one through
    the non-size form, and both give the labels of the mesh's sort
    engine."""
    from cuvite_tpu_torch.louvain import bucketed as pb

    calls = {"sized": 0, "plain": 0}
    sized, plain = pb.row_argmax_sized, pb.row_argmax

    def spy(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(pb, "row_argmax_sized", spy("sized", sized))
    monkeypatch.setattr(pb, "row_argmax", spy("plain", plain))
    g = _port_graph(rmat10)
    ref = louvain_phases(g, nshards=8, device="cpu", engine="sort")
    spa = louvain_phases(g, nshards=8, device="cpu", exchange="sparse")
    assert calls["sized"] > 0 and calls["plain"] == 0
    rep = louvain_phases(g, nshards=8, device="cpu", exchange="replicated")
    assert calls["plain"] == calls["sized"]
    for r in (spa, rep):
        assert np.array_equal(r.communities, ref.communities)
        assert r.modularity == ref.modularity


def test_mesh_refusals_and_fallbacks(rmat9, tmp_path):
    """ET, coloring, vertex ordering and checkpoints run on a mesh and give
    one shard's labels (ROADMAP.md A7.1); the two-level exchange and a
    mesh/nshards conflict raise.  engine='fused' warns and runs bucketed;
    engine='sort' with exchange='sparse' warns and runs the replicated
    exchange."""
    g = _port_graph(rmat9)
    for kw in ({"et_mode": 3}, {"coloring": 8}, {"vertex_ordering": 8},
               {"checkpoint_dir": str(tmp_path / "ck")}):
        one = louvain_phases(g, device="cpu", **{
            k: v for k, v in kw.items() if k != "checkpoint_dir"})
        mesh_run = louvain_phases(g, nshards=2, device="cpu", **kw)
        assert np.array_equal(mesh_run.communities, one.communities), kw
        assert [p.iterations for p in mesh_run.phases] == \
            [p.iterations for p in one.phases]
    assert (tmp_path / "ck").is_dir()
    with pytest.raises(ValueError, match="two-level"):
        louvain_phases(g, nshards=2, device="cpu", exchange="twolevel")
    with pytest.raises(ValueError, match="conflicts"):
        louvain_phases(g, nshards=3, mesh=_cpu_mesh(2))
    base = louvain_phases(g, nshards=2, device="cpu")
    with pytest.warns(UserWarning, match="fused"):
        fused = louvain_phases(g, nshards=2, device="cpu", engine="fused")
    with pytest.warns(UserWarning, match="sparse"):
        sort = louvain_phases(g, mesh=_cpu_mesh(2), engine="sort",
                              exchange="sparse")
    for r in (fused, sort):
        assert np.array_equal(r.communities, base.communities)
    assert sort.exchange_stats == {"mode": "replicated"}


def test_cli_shards_matches_library(rmat9, tmp_path, capsys):
    """--shards 4 --exchange sparse -b --json equals the library call;
    --dist-stats prints the partition; --mesh 2x2 equals the library's
    two-level run and --diag-prefix writes its files; the multi-process
    flags without what they need, a malformed --mesh and --exchange
    twolevel without --mesh are refused."""
    from cuvite_tpu_torch.cli import main
    from cuvite_tpu_torch.evaluate.modularity import modularity
    from cuvite_tpu_torch.io.vite import write_vite

    g = _port_graph(rmat9)
    path = str(tmp_path / "g.bin")
    write_vite(path, g, bits64=False)
    assert main(["--file", path, "--shards", "4", "--exchange", "sparse",
                 "-b", "--json", "--dist-stats", "--quiet",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Number of shards: 4" in out and "Ghost vertices" in out
    rec = json.loads(out.strip().splitlines()[-1])
    lib = louvain_phases(g, nshards=4, device="cpu", exchange="sparse",
                         balanced=True)
    assert rec["modularity"] == modularity(g, lib.communities)
    assert (rec["communities"], rec["iterations"], rec["phases"]) == \
        (lib.num_communities, lib.total_iterations, len(lib.phases))
    # --mesh 2x2 runs the two-level exchange: its summary equals the
    # library's mesh_shape=(2, 2) run; --diag-prefix writes a file a shard.
    diag = str(tmp_path / "diag" / "d")
    assert main(["--file", path, "--device", "cpu", "--mesh", "2x2",
                 "--json", "--quiet", "--diag-prefix", diag]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lib = louvain_phases(g, mesh_shape=(2, 2), device="cpu")
    assert rec["modularity"] == modularity(g, lib.communities)
    assert (rec["communities"], rec["iterations"], rec["phases"]) == \
        (lib.num_communities, lib.total_iterations, len(lib.phases))
    assert rec["exchange"]["mode"] == "twolevel"
    for s in range(4):
        lines = (tmp_path / "diag" / f"d.{s}").read_text().splitlines()
        assert len(lines) == len(lib.convergence)
        assert lines[0].startswith("phase 0: owned=")
    with pytest.raises(SystemExit, match="DCNxICI"):
        main(["--file", path, "--device", "cpu", "--mesh", "2by2"])
    with pytest.raises(SystemExit, match="--exchange twolevel requires"):
        main(["--file", path, "--device", "cpu", "--exchange",
              "twolevel"])
    with pytest.raises(SystemExit, match="--shards >= 2"):
        main(["--file", path, "--device", "cpu", "--dist-ingest"])
    with pytest.raises(SystemExit, match="need --distributed"):
        main(["--file", path, "--device", "cpu", "--process-id", "0"])
    # -t 1 (and the other schedules) run on the mesh: the summary equals
    # the library's ET run on the same shards.
    assert main(["--file", path, "--device", "cpu", "--shards", "2", "-t",
                 "1", "--json", "--quiet"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lib = louvain_phases(g, nshards=2, device="cpu", et_mode=1)
    assert rec["modularity"] == modularity(g, lib.communities)
    assert (rec["communities"], rec["iterations"], rec["phases"]) == \
        (lib.num_communities, lib.total_iterations, len(lib.phases))


@pytest.fixture(scope="module")
def rmat12_file(tmp_path_factory):
    """R-MAT 12 as a 32-bit Vite file: 1,024 vertices a shard of 4, the
    reference driver's floor of 4096 / 4 padded vertices, so that the
    exchange block's table bytes are one figure in both packages."""
    from cuvite_tpu_torch.io.vite import write_vite

    jg = jax_rmat(12, edge_factor=8, seed=5)
    path = str(tmp_path_factory.mktemp("rmat12") / "g.bin")
    write_vite(path, _port_graph(jg), bits64=False)
    return path


@pytest.mark.parametrize("argv", [["--shards", "4", "--exchange", "sparse"],
                                  ["--mesh", "2x2"]])
def test_cli_exchange_block_and_diag_match_jax(rmat12_file, argv, tmp_path,
                                               capsys):
    """The --json line's exchange block equals the reference CLI's on the
    same file, one phase (-p); on the flat 4-shard run the --diag-prefix
    files equal the reference's line for line with the seconds masked
    (the reference's own two-level run cannot write them: its per-shard
    ghost count indexes the plan's per-group list)."""
    import re

    from cuvite_tpu.cli import main as jax_main
    from cuvite_tpu_torch.cli import main

    common = ["--file", rmat12_file, "--json", "--quiet", "-p", *argv]
    flat = argv[0] == "--shards"
    pre = {k: str(tmp_path / k / "d") for k in ("port", "ref")}
    assert main([*common, "--device", "cpu"]
                + (["--diag-prefix", pre["port"]] if flat else [])) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_main(common + (["--diag-prefix", pre["ref"]] if flat
                              else [])) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["exchange"] == want["exchange"]
    assert got["exchange"]["mode"] == ("sparse" if flat else "twolevel")
    assert (got["communities"], got["iterations"]) == \
        (want["communities"], want["iterations"])
    if flat:
        def masked(k, s):
            text = (tmp_path / k / f"d.{s}").read_text()
            return re.sub(r"t=[0-9.]+s", "t=?s", text)

        for s in range(4):
            assert masked("port", s) == masked("ref", s)
