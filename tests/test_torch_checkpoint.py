"""cuvite_tpu_torch's phase checkpoints against the JAX package's on the
CPU: the files hold the same keys and the fingerprint the same CRC chain,
so a run checkpointed by either package resumes in the other, to the
labels of an uninterrupted run.
"""

import numpy as np
import pytest

from cuvite_tpu.io.generate import generate_rmat as jax_rmat
from cuvite_tpu.louvain.driver import louvain_phases as jax_louvain
from cuvite_tpu.utils.checkpoint import graph_fingerprint as jax_fingerprint
from cuvite_tpu.utils.checkpoint import load_latest as jax_load_latest
from cuvite_tpu_torch import Graph, louvain_phases
from cuvite_tpu_torch.utils.checkpoint import graph_fingerprint, load_latest

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def rmat10():
    return jax_rmat(10)


def _port_graph(g):
    return Graph.from_arrays(g.offsets, g.tails, g.weights)


@pytest.mark.parametrize("name", ["karate", "two_cliques", "rmat10"])
def test_fingerprint_matches_jax(name, request):
    jg = request.getfixturevalue(name)
    assert graph_fingerprint(_port_graph(jg)) == jax_fingerprint(jg)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(rmat10, tmp_path, writer):
    """Phase 1's checkpoint, written by one package (a run bounded by
    max_phases=1), resumed by the other: the labels, phases and Q of an
    uninterrupted run."""
    g = _port_graph(rmat10)
    full = louvain_phases(g, device="cpu")
    ck = str(tmp_path)
    if writer == "jax":
        jax_louvain(rmat10, max_phases=1, checkpoint_dir=ck)
        res = louvain_phases(g, checkpoint_dir=ck, resume=True, device="cpu")
    else:
        louvain_phases(g, max_phases=1, checkpoint_dir=ck, device="cpu")
        assert load_latest(ck).phase == 1
        res = jax_louvain(rmat10, checkpoint_dir=ck, resume=True)
    assert jax_load_latest(ck).phase == len(full.phases)
    assert np.array_equal(res.communities, full.communities)
    assert [p.iterations for p in res.phases] == \
        [p.iterations for p in full.phases]
    assert abs(res.modularity - full.modularity) <= 1e-9


def test_resume_refuses_another_graph(karate, tmp_path):
    """A checkpoint for the same vertex and edge counts but other content
    (one edge rewired) is refused, not composed."""
    g = _port_graph(karate)
    ck = str(tmp_path)
    louvain_phases(g, max_phases=1, checkpoint_dir=ck, device="cpu")
    tails = g.tails.copy()
    i = int(np.nonzero(tails == 1)[0][0])
    tails[i] = 2 if tails[i + 1] != 2 else 3
    other = Graph.from_arrays(g.offsets, tails, g.weights)
    with pytest.raises(ValueError, match="different graph"):
        louvain_phases(other, checkpoint_dir=ck, resume=True, device="cpu")
    with pytest.raises(ValueError, match="one_phase"):
        louvain_phases(g, one_phase=True, checkpoint_dir=ck, device="cpu")


def test_sort_engine_checkpoints_on_the_host(rmat10, tmp_path):
    """A checkpointed sort run coarsens on the host (the file needs the
    host graph) and resumes to its uninterrupted labels."""
    g = _port_graph(rmat10)
    full = louvain_phases(g, engine="sort", device="cpu")
    ck = str(tmp_path)
    part = louvain_phases(g, engine="sort", max_phases=1, checkpoint_dir=ck,
                          device="cpu")
    assert [p.coalesce for p in part.phases] == [None]
    res = louvain_phases(g, engine="sort", checkpoint_dir=ck, resume=True,
                         device="cpu")
    assert np.array_equal(res.communities, full.communities)
    assert abs(res.modularity - full.modularity) <= 1e-9


def test_cli_checkpoint_and_resume(tmp_path, monkeypatch, capsys):
    """--checkpoint-dir writes a file per gaining phase; --resume picks
    up the last and reports it."""
    from cuvite_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    args = ["--rmat", "10", "--device", "cpu", "--checkpoint-dir", "ck"]
    assert cli.main(args) == 0
    first = capsys.readouterr().out
    last = load_latest(str(tmp_path / "ck"))
    assert last is not None and last.phase >= 2
    assert cli.main(args + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert f"Resumed from ck at phase {last.phase}" in out
    assert first.splitlines()[-1].split("(")[0] == \
        out.splitlines()[-1].split("(")[0]
