"""cuvite_tpu_torch's format converters, dataset catalogue and ``fetch``
held against the JAX package's on the CPU.

The reference's converter cases (``tests/test_workloads.py``) run on the
port: SNAP, gzipped SNAP, Matrix Market (symmetric and general) and METIS
(weighted and not), 32- and 64-bit, each file byte-equal to the
reference's ``convert`` of the same input and across chunk sizes and
input orders.  The catalogue, scale laws and ``max_workload()`` equal the
reference's field for field.  ``fetch`` never reaches the network here:
``_download`` is made to fail (the offline stand-in, byte-equal to the
reference's) or is given a ``file://`` archive (download, checksum,
extraction and conversion, a pinned digest right and wrong).
"""

import dataclasses
import gzip
import hashlib
import json
import os
import tarfile

import numpy as np
import pytest

import cuvite_tpu.workloads.registry as ref_reg
from cuvite_tpu.workloads.convert import convert as ref_convert
from cuvite_tpu.workloads.convert import edges_to_vite as ref_edges_to_vite
from cuvite_tpu_torch.core.types import default_policy, wide_policy
from cuvite_tpu_torch.io.vite import read_vite, write_vite
from cuvite_tpu_torch.workloads import convert as conv
from cuvite_tpu_torch.workloads import registry as reg

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The reference tests' graph: weighted, gaps in the id space (relabeling
# runs), no duplicate edge.
EDGES = [(1, 4, 0.5), (1, 7, 2.0), (4, 7, 1.5), (7, 13, 1.0),
         (13, 22, 0.25), (4, 22, 3.0), (22, 31, 1.25), (1, 31, 0.75)]
IDS = sorted({v for e in EDGES for v in e[:2]})
REMAP = {v: i for i, v in enumerate(IDS)}


def expected_graph(policy, weights=True):
    from cuvite_tpu_torch import Graph

    src = np.array([REMAP[u] for u, v, w in EDGES])
    dst = np.array([REMAP[v] for u, v, w in EDGES])
    w = np.array([w for u, v, w in EDGES]) if weights else None
    return Graph.from_edges(len(IDS), src, dst, weights=w, policy=policy)


def assert_csr_equal(got, exp):
    assert np.array_equal(got.offsets, exp.offsets)
    assert np.array_equal(got.tails, exp.tails)
    assert np.array_equal(got.weights, exp.weights)


def both(path, tmp_path, **kw):
    """Convert ``path`` with each package; the port's file must be
    byte-equal to the reference's and its stats equal but for the path.
    Returns (port output path, port stats)."""
    mine, ref = str(tmp_path / "mine.vite"), str(tmp_path / "ref.vite")
    stats = conv.convert(str(path), mine, **kw)
    ref_stats = ref_convert(str(path), ref, **kw)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    d, rd = stats.to_dict(), ref_stats.to_dict()
    d.pop("out_path"), rd.pop("out_path")
    assert d == rd
    return mine, stats


def snap_file(tmp_path, name="g.txt", order=None, gz=False):
    edges = EDGES if order is None else [EDGES[i] for i in order]
    lines = ["# SNAP-style comment"]
    lines += [f"{u}\t{v}\t{w}" for u, v, w in edges]
    data = ("\n".join(lines) + "\n").encode()
    path = tmp_path / name
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)
    return path


def mtx_file(tmp_path, symmetric=True, field="real"):
    n = len(IDS)
    rows = [(REMAP[u], REMAP[v], w) for u, v, w in EDGES]
    if not symmetric:
        rows += [(j, i, w) for i, j, w in rows]
    head = f"%%MatrixMarket matrix coordinate {field} " \
        f"{'symmetric' if symmetric else 'general'}"
    lines = [head, "% comment", f"{n} {n} {len(rows)}"]
    for i, j, w in rows:
        a, b = (max(i, j), min(i, j)) if symmetric else (i, j)
        lines.append(f"{a + 1} {b + 1}" + ("" if field == "pattern"
                                           else f" {w}"))
    path = tmp_path / "g.mtx"
    path.write_text("\n".join(lines) + "\n")
    return path


def metis_file(tmp_path, weighted=True, isolated=True):
    n = len(IDS)
    adj = [[] for _ in range(n + (1 if isolated else 0))]
    for u, v, w in EDGES:
        adj[REMAP[u]].append((REMAP[v] + 1, w))
        adj[REMAP[v]].append((REMAP[u] + 1, w))
    head = f"{len(adj)} {len(EDGES)}" + (" 001" if weighted else "")
    lines = ["% comment", head]
    for nbrs in adj:
        lines.append(" ".join(f"{t} {w:g}" if weighted else str(t)
                              for t, w in nbrs))
    path = tmp_path / ("g.graph" if weighted else "g.metis")
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("chunk", [2, 3, 1 << 22])
@pytest.mark.parametrize("bits64", [False, True], ids=["32bit", "64bit"])
def test_snap_matches_reference(tmp_path, bits64, chunk):
    out, stats = both(snap_file(tmp_path), tmp_path, fmt="snap",
                      bits64=bits64, chunk_edges=chunk)
    assert stats.relabeled and stats.num_vertices == len(IDS)
    assert stats.num_edges == 2 * len(EDGES)
    policy = wide_policy() if bits64 else default_policy()
    g = read_vite(out, bits64=bits64)
    assert_csr_equal(g, expected_graph(policy))
    out2 = str(tmp_path / "g2.vite")
    write_vite(out2, g, bits64=bits64)
    assert open(out, "rb").read() == open(out2, "rb").read()


def test_snap_gz_and_input_order_give_the_same_bytes(tmp_path):
    a, _ = both(snap_file(tmp_path), tmp_path / "..", fmt="auto")
    base = open(a, "rb").read()
    perm = np.random.default_rng(0).permutation(len(EDGES))
    for name, path in (("gz", snap_file(tmp_path, "g.txt.gz", gz=True)),
                       ("shuffled", snap_file(tmp_path, "s.txt",
                                              order=perm))):
        d = tmp_path / name
        d.mkdir()
        out, _ = both(path, d, chunk_edges=2)
        assert open(out, "rb").read() == base, name


@pytest.mark.parametrize("chunk", [2, 1 << 22])
@pytest.mark.parametrize("bits64", [False, True], ids=["32bit", "64bit"])
@pytest.mark.parametrize("kind", ["symmetric", "general", "pattern"])
def test_mtx_matches_reference(tmp_path, kind, bits64, chunk):
    path = mtx_file(tmp_path, symmetric=kind != "general",
                    field="pattern" if kind == "pattern" else "real")
    out, stats = both(path, tmp_path, fmt="mtx", bits64=bits64,
                      chunk_edges=chunk)
    assert not stats.relabeled
    assert stats.symmetrized == (kind != "general")
    policy = wide_policy() if bits64 else default_policy()
    assert_csr_equal(read_vite(out, bits64=bits64),
                     expected_graph(policy, weights=kind != "pattern"))


@pytest.mark.parametrize("chunk", [2, 1 << 22])
@pytest.mark.parametrize("bits64", [False, True], ids=["32bit", "64bit"])
@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weighted", "unweighted"])
def test_metis_matches_reference(tmp_path, weighted, bits64, chunk):
    path = metis_file(tmp_path, weighted=weighted, isolated=weighted)
    out, stats = both(path, tmp_path, bits64=bits64, chunk_edges=chunk)
    assert stats.fmt == "metis" and not stats.symmetrized
    n = len(IDS)
    assert stats.num_vertices == n + (1 if weighted else 0)
    g = read_vite(out, bits64=bits64)
    exp = expected_graph(wide_policy() if bits64 else default_policy(),
                         weights=weighted)
    assert np.array_equal(g.offsets[: n + 1], exp.offsets)
    assert np.array_equal(g.tails, exp.tails)
    assert np.array_equal(g.weights, exp.weights)


def test_metis_parse_spans_text_blocks(tmp_path):
    path = metis_file(tmp_path, weighted=False, isolated=False)

    def collect(block_bytes):
        chunks = list(conv.metis_edge_chunks(str(path),
                                             block_bytes=block_bytes))
        return (np.concatenate([c[0] for c in chunks]),
                np.concatenate([c[1] for c in chunks]))

    for a, b in zip(collect(8 << 20), collect(4)):
        assert np.array_equal(a, b)


def test_edges_to_vite_chunking_and_order_match_reference(tmp_path):
    # Distinct undirected pairs: a row's records are ordered by tail, so
    # the input order of two parallel records (say (u, v) and (v, u) once
    # symmetrized) with different weights would show.
    rng = np.random.default_rng(1)
    n = 300
    a, b = rng.integers(0, n, (2, 2000))
    key = np.unique(np.minimum(a, b) * n + np.maximum(a, b))
    src, dst = key // n, key % n
    m = len(key)
    w = rng.integers(1, 9, m) / 4.0
    perm = rng.permutation(m)
    outs = []
    for k, (order, chunk) in enumerate(((np.arange(m), 1 << 22),
                                        (perm, 7))):
        s, d, ww = src[order], dst[order], w[order]
        pieces = [(s[i:i + chunk], d[i:i + chunk], ww[i:i + chunk])
                  for i in range(0, m, chunk)]
        mine = str(tmp_path / f"m{k}.vite")
        ref = str(tmp_path / f"r{k}.vite")
        conv.edges_to_vite(iter(pieces), mine, num_vertices=n,
                           relabel="none", chunk_edges=chunk)
        ref_edges_to_vite(iter(pieces), ref, num_vertices=n,
                          relabel="none", chunk_edges=chunk)
        assert open(mine, "rb").read() == open(ref, "rb").read()
        outs.append(open(mine, "rb").read())
    assert outs[0] == outs[1]


def test_formats_and_refusals_match_reference(tmp_path):
    import cuvite_tpu.workloads.convert as ref_conv

    assert conv.FORMATS == ref_conv.FORMATS
    for name in ("a.txt", "a.txt.gz", "a.mtx", "a.mtx.gz", "a.graph",
                 "a.metis", "a.edges"):
        assert conv.detect_format(name) == ref_conv.detect_format(name)
    bad = tmp_path / "bad.mtx"
    bad.write_text("not a matrix\n")
    for fn in (conv.convert, ref_convert):
        with pytest.raises(ValueError, match="MatrixMarket"):
            fn(str(bad), str(tmp_path / "x.vite"))
        with pytest.raises(ValueError, match="unknown format"):
            fn(str(bad), str(tmp_path / "x.vite"), fmt="csv")
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".spool")]


# ---------------------------------------------------------------------------
# The catalogue and the width envelope.


def test_catalogue_and_scale_laws_match_reference():
    assert sorted(reg.DATASETS) == sorted(ref_reg.DATASETS)
    for name, ds in reg.DATASETS.items():
        assert dataclasses.asdict(ds) == \
            dataclasses.asdict(ref_reg.DATASETS[name])
        ref = ref_reg.DATASETS[name]
        assert (ds.num_edges_directed, ds.width_nv, ds.width_ne) == \
            (ref.num_edges_directed, ref.width_nv, ref.width_ne)
    for k in ("EDGE_FACTOR", "RMAT_SCALE_MAX", "BATCH_MAX",
              "SIZE_ENVELOPE_REL", "DOWNLOAD_TIMEOUT_S"):
        assert getattr(reg, k) == getattr(ref_reg, k), k
    for scale in (1, 10, 20, 28):
        for ef in (8, 16):
            assert reg.rmat_scale_law(scale, ef) == \
                ref_reg.rmat_scale_law(scale, ef)
    for edges in (10, 1000, 1 << 20, 1 << 27):
        assert reg.synth_scale_law(edges) == ref_reg.synth_scale_law(edges)
    assert reg.max_workload() == ref_reg.max_workload()


def test_size_envelope_matches_reference():
    ds = reg.DATASETS["com-orkut"]
    for nv, ne in ((ds.num_vertices, ds.num_edges_directed),
                   (ds.num_vertices // 2, ds.num_edges_directed),
                   (ds.num_vertices, 10)):
        assert reg._check_size_envelope(ds, nv, ne) == \
            ref_reg._check_size_envelope(ref_reg.DATASETS["com-orkut"],
                                         nv, ne)


# ---------------------------------------------------------------------------
# fetch, offline: _download never reaches the network.


def _offline(monkeypatch):
    def no_network(url, dest, timeout=None):
        raise OSError(f"offline: {url} not fetched")

    monkeypatch.setattr(reg, "_download", no_network)
    monkeypatch.setattr(ref_reg, "_download", no_network)


def _fake(monkeypatch, name, **kw):
    fake = dict(name=name, url="http://127.0.0.1:9/nothing.txt.gz",
                fmt="snap", num_vertices=1000, num_edges_undirected=10_000,
                synth_edges=20_000)
    fake.update(kw)
    monkeypatch.setitem(reg.DATASETS, name, reg.Dataset(**fake))
    monkeypatch.setitem(ref_reg.DATASETS, name, ref_reg.Dataset(**fake))


def _norm(payload):
    """A provenance payload without its time and with file names only."""
    out = {k: v for k, v in payload.items() if k != "created"}
    out["result"] = dict(out["result"],
                         out_path=os.path.basename(
                             out["result"]["out_path"]))
    if out.get("truth_path"):
        out["truth_path"] = os.path.basename(out["truth_path"])
    return out


@pytest.mark.parametrize("bits64", [False, True], ids=["32bit", "64bit"])
def test_offline_fetch_matches_reference(tmp_path, monkeypatch, bits64):
    _offline(monkeypatch)
    _fake(monkeypatch, "fake-tiny", bits64=bits64)
    mine = reg.fetch("fake-tiny", str(tmp_path / "mine"))
    ref = ref_reg.fetch("fake-tiny", str(tmp_path / "ref"))
    assert mine["source"] == "offline-synthesized"
    assert mine["stands_in_for"] == "fake-tiny" and "fetch_error" in mine
    assert _norm(mine) == _norm(ref)
    out = tmp_path / "mine" / "fake-tiny.vite"
    assert out.read_bytes() == (tmp_path / "ref" / "fake-tiny.vite"
                                ).read_bytes()
    g = read_vite(str(out), bits64=bits64)
    assert g.num_edges == mine["result"]["num_edges"]
    prov = reg.load_provenance(str(out))
    assert prov["source"] == "offline-synthesized" and "fetch_error" in prov
    # An explicit stand-in size.
    small = reg.fetch("fake-tiny", str(tmp_path / "small"),
                      synth_edges=4000)
    assert small["result"]["num_edges"] < mine["result"]["num_edges"]


def test_no_offline_fallback_raises(tmp_path, monkeypatch):
    _offline(monkeypatch)
    _fake(monkeypatch, "fake-tiny2", num_vertices=10,
          num_edges_undirected=10)
    with pytest.raises(OSError, match="offline"):
        reg.fetch("fake-tiny2", str(tmp_path), offline_fallback=False)
    assert not (tmp_path / "fake-tiny2.vite").exists()
    with pytest.raises(KeyError, match="unknown dataset"):
        reg.fetch("no-such-graph", str(tmp_path))


def _archive(tmp_path, kind):
    """A local archive of the test graph: a gzipped SNAP list, or a
    .tar.gz holding a Matrix Market file beside a smaller decoy."""
    src = tmp_path / "src"
    src.mkdir()
    if kind == "snap":
        return snap_file(src, "g.txt.gz", gz=True), "snap"
    mtx = mtx_file(src)
    (src / "readme.mtx").write_text("%%MatrixMarket decoy\n")
    path = src / "g.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        tf.add(mtx, arcname="g/g.mtx")
        tf.add(src / "readme.mtx", arcname="g/readme.mtx")
    return path, "mtx"


@pytest.mark.parametrize("kind", ["snap", "mtx"])
def test_fetch_file_url_with_pinned_digest(tmp_path, monkeypatch, kind):
    """``urllib`` opens a ``file://`` URL: download, checksum, extraction
    and conversion run with no network.  The port's file and provenance
    equal the reference's."""
    path, fmt = _archive(tmp_path, kind)
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    _fake(monkeypatch, "local", url=path.as_uri(), fmt=fmt,
          num_vertices=len(IDS), num_edges_undirected=len(EDGES),
          sha256=digest)
    mine = reg.fetch("local", str(tmp_path / "mine"))
    ref = ref_reg.fetch("local", str(tmp_path / "ref"))
    assert mine["source"] == "fetched" and mine["sha256"] == digest
    assert mine["sha256_pinned"] is True
    assert _norm(mine) == _norm(ref)
    out = tmp_path / "mine" / "local.vite"
    assert out.read_bytes() == (tmp_path / "ref" / "local.vite").read_bytes()
    assert_csr_equal(read_vite(str(out), bits64=False),
                     expected_graph(default_policy()))
    # The download and the extracted payload are removed by default.
    assert sorted(os.listdir(tmp_path / "mine")) == \
        ["local.vite", "local.vite.provenance.json"]


def test_fetch_wrong_digest_raises_and_leaves_nothing(tmp_path,
                                                      monkeypatch):
    path, _ = _archive(tmp_path, "snap")
    _fake(monkeypatch, "local", url=path.as_uri(),
          num_vertices=len(IDS), num_edges_undirected=len(EDGES),
          sha256="0" * 64)
    dest = tmp_path / "dest"
    with pytest.raises(ValueError, match="sha256 mismatch"):
        reg.fetch("local", str(dest))
    assert os.listdir(dest) == []


def test_fetch_outside_the_size_envelope_raises(tmp_path, monkeypatch):
    path, _ = _archive(tmp_path, "snap")
    _fake(monkeypatch, "local", url=path.as_uri(), num_vertices=100,
          num_edges_undirected=len(EDGES))
    with pytest.raises(ValueError, match="envelope"):
        reg.fetch("local", str(tmp_path / "dest"))


# ---------------------------------------------------------------------------
# The command line's fetch and convert verbs.


def test_cli_fetch_list(capsys):
    from cuvite_tpu.workloads.__main__ import main as ref_main
    from cuvite_tpu_torch.workloads.__main__ import main

    assert main(["fetch", "--list"]) == 0
    mine = capsys.readouterr().out
    assert ref_main(["fetch", "--list"]) == 0
    assert mine == capsys.readouterr().out
    assert "com-orkut" in mine and "friendster" in mine
    with pytest.raises(SystemExit, match="dataset name"):
        main(["fetch"])


def test_cli_fetch_offline(tmp_path, monkeypatch, capsys):
    from cuvite_tpu_torch.workloads.__main__ import main

    _offline(monkeypatch)
    _fake(monkeypatch, "fake-cli")
    assert main(["fetch", "fake-cli", "--dest", str(tmp_path),
                 "--synth-edges", "5000"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["source"] == "offline-synthesized"
    assert os.path.exists(tmp_path / "fake-cli.vite")
    with pytest.raises(OSError, match="offline"):
        main(["fetch", "fake-cli", "--dest", str(tmp_path),
              "--no-offline-fallback"])


def test_cli_convert_matches_reference(tmp_path, capsys):
    from cuvite_tpu.workloads.__main__ import main as ref_main
    from cuvite_tpu_torch.workloads.__main__ import main

    src = snap_file(tmp_path)
    outs = {}
    for who, fn in (("mine", main), ("ref", ref_main)):
        out = str(tmp_path / f"{who}.vite")
        assert fn(["convert", str(src), "--out", out, "--bits64"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        line.pop("out_path")
        prov = json.load(open(out + ".provenance.json"))
        prov["result"].pop("out_path")
        outs[who] = (open(out, "rb").read(), line, prov)
    assert outs["mine"] == outs["ref"]
    assert outs["mine"][1]["bits64"] is True
