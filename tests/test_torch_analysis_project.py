"""The port's project tiers (``cuvite_tpu_torch.analysis``): cross-module
device-path reach (R017/R018), the serve/ lock rules (R019-R021) and the
mesh rules (R023-R025), each the torch counterpart of the reference's
fixtures in ``tests/test_analysis.py`` and ``tests/test_concheck.py``;
the root tables resolved on the port's own tree; the lockset inventory
of the port's serve/ against the reference's.

Fixtures are {rel: source} projects linted through
``run_project_sources`` (what ``run_paths`` does for a tree on disk),
placed at the port's module paths so that the root tables of
``engine.py`` apply to them.
"""

import os

import pytest

from cuvite_tpu_torch.analysis import (
    DEVICE_PATH_ROOTS,
    MESH_ENTRIES,
    run_paths,
    run_project_sources,
    run_source,
)
from cuvite_tpu_torch.analysis.callgraph import Project, summarize
from cuvite_tpu_torch.analysis.engine import SourceFile, iter_py_files
from cuvite_tpu_torch.analysis.meshspec import replicated_inventory
from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "cuvite_tpu_torch/"


def rules_of(findings):
    return {f.rule for f in findings}


def hits_of(findings, rule):
    return [f for f in findings if f.rule == rule]


# ---------------------------------------------------------------------------
# Tier 2: R017 / R018.

R017_DEEP = {
    # device-path root -> mid helper (module 2) -> host read (module 3)
    PKG + "louvain/bucketed.py": """
from cuvite_tpu_torch.fake_mid import mid_helper

def bucketed_step(plan, comm, vdeg, consts):
    return mid_helper(comm)
""",
    PKG + "fake_mid.py": """
from cuvite_tpu_torch.fake_deep import deep_pull

def mid_helper(comm):
    return deep_pull(comm) + 1
""",
    PKG + "fake_deep.py": """
def deep_pull(comm):
    return comm.sum().item()
""",
}


def test_r017_host_read_two_modules_deep():
    hits = hits_of(run_project_sources(R017_DEEP), "R017")
    assert len(hits) == 1, hits
    assert hits[0].path == PKG + "fake_deep.py"
    assert "bucketed.py::bucketed_step" in hits[0].message
    assert hits[0].severity == "high"


def test_r017_negative_without_a_root():
    clean = dict(R017_DEEP)
    clean[PKG + "louvain/bucketed.py"] = clean[
        PKG + "louvain/bucketed.py"].replace("def bucketed_step",
                                             "def host_report")
    assert "R017" not in rules_of(run_project_sources(clean))


def test_r017_defers_to_r001_in_module():
    src = {PKG + "louvain/step.py": """
def louvain_step_local(src, dst, w, comm, vdeg, consts):
    return helper(comm)

def helper(comm):
    return comm.cpu()
"""}
    rules = rules_of(run_project_sources(src))
    assert "R001" in rules and "R017" not in rules


def test_r017_batched_phase_body_sweep_root():
    """The batched engine's shape: the per-sweep closure of
    ``_bucketed_phase_body`` is the root (by qualified name), and the
    host read sits in an imported helper."""
    src = {
        PKG + "louvain/batched.py": """
from cuvite_tpu_torch.fake_body import gains

def _bucketed_phase_body(plan, slab, consts):
    def sweep(comm):
        return gains(comm)
    return sweep

def _phase_loop(sweeps, comms):
    return [s(c) for s, c in zip(sweeps, comms)]
""",
        PKG + "fake_body.py": """
import torch

def gains(comm):
    return torch.nonzero(comm)
""",
    }
    hits = hits_of(run_project_sources(src), "R017")
    assert len(hits) == 1 and hits[0].path == PKG + "fake_body.py", hits
    assert "_bucketed_phase_body.sweep" in hits[0].message


def test_r017_method_homonyms_stay_apart():
    """``self.step`` inside MeshPhaseRunner links MeshPhaseRunner.step,
    not the one-graph runner's ``step`` of the same module."""
    src = {PKG + "louvain/driver.py": """
from cuvite_tpu_torch.fake_pull import pull

class PhaseRunner:
    def step(self, comm):
        return pull(comm)

class MeshPhaseRunner:
    def step(self, comms):
        return comms

    def run(self, comms):
        return self.step(comms)
""", PKG + "fake_pull.py": """
def pull(comm):
    return comm.tolist()
"""}
    summaries = [summarize(SourceFile(t, path=r, rel=r))
                 for r, t in src.items()]
    pred = Project(summaries)._reach(
        Project(summaries).roots("mesh_entry"))
    names = {k[1] for k in pred}
    assert "MeshPhaseRunner.step" in names
    assert "PhaseRunner.step" not in names and "pull" not in names


def test_r017_inline_suppression():
    src = dict(R017_DEEP)
    src[PKG + "fake_deep.py"] = """
def deep_pull(comm):
    return comm.sum().item()  # graftlint: disable=R017 — a stat read
"""
    assert "R017" not in rules_of(run_project_sources(src))


R018_PROJECT = {
    PKG + "coarsen/fake_phase.py": """
from cuvite_tpu_torch.utils.fake_pull import pull_stats

def phase_transition(slab):
    return pull_stats(slab)
""",
    PKG + "utils/fake_pull.py": """
def pull_stats(slab):
    return slab.cpu().numpy()
""",
}


def test_r018_pull_in_helper_reached_from_coarsen():
    hits = hits_of(run_project_sources(R018_PROJECT), "R018")
    assert len(hits) == 1, hits          # one anchor a line
    assert {f.path for f in hits} == {PKG + "utils/fake_pull.py"}
    assert all("fake_phase.py::phase_transition" in f.message for f in hits)


def test_r018_negative_unreached_helper():
    src = {
        PKG + "tools/fake_bench.py": R018_PROJECT[
            PKG + "coarsen/fake_phase.py"],
        PKG + "utils/fake_pull.py": R018_PROJECT[PKG + "utils/fake_pull.py"],
    }
    assert not {"R018", "R010"} & rules_of(run_project_sources(src))


def test_r018_in_scope_modules_stay_r010():
    src = {PKG + "coarsen/fake_self.py": """
def phase_transition(slab):
    return slab.cpu()
"""}
    rules = rules_of(run_project_sources(src))
    assert "R010" in rules and "R018" not in rules


# ---------------------------------------------------------------------------
# Tier 2b/4: R019-R021 on the port's serve/ (the fixtures' torch forms are
# the reference's: serve/ holds no tensors).

R019_SEEDED = """
import threading


class ServeStats:
    def __init__(self):
        self.lock = threading.RLock()
        self.jobs_done = 0
        self.wait_samples = []


class Dispatcher:
    def __init__(self, stats):
        self.stats = stats

    def locked_path(self, wait):
        with self.stats.lock:
            self.stats.jobs_done += 1
            self.stats.wait_samples.append(wait)

    def drain_recheck(self, wait):
        self.stats.jobs_done += 1
        self.stats.wait_samples.append(wait)
"""


def test_r019_seeded_unguarded_mutation():
    hits = hits_of(run_source(R019_SEEDED, rel=PKG + "serve/fake.py"),
                   "R019")
    assert len(hits) == 2, hits
    assert all("self.stats.lock" in f.message for f in hits)


def test_r019_scope_is_serve_only():
    assert "R019" not in rules_of(run_source(R019_SEEDED,
                                             rel=PKG + "louvain/fake.py"))
    assert "R019" not in rules_of(run_source(R019_SEEDED,
                                             rel="cuvite_tpu/serve/fake.py"))


@pytest.mark.parametrize("decl", [
    "    jobs_done: int = 0  # graftlint: guarded-by=self.lock\n",
    # the constructor's annotated assignment (LouvainServer's spelling)
    None,
])
def test_r019_guarded_by_annotation(decl):
    if decl is not None:
        src = ("import threading\n\n\nclass Stats:\n    lock: object = "
               "None\n" + decl + "\n    def racy(self):\n"
               "        self.jobs_done += 1\n")
        lock = "self.lock"
    else:
        src = """
class Server:
    def __init__(self, stats):
        self.stats = stats
        self.failures: list = []   # graftlint: guarded-by=self.stats.lock

    def fail(self, job):
        self.failures.append(job)

    def fail_locked(self, job):
        with self.stats.lock:
            self.failures.append(job)
"""
        lock = "self.stats.lock"
    hits = hits_of(run_source(src, rel=PKG + "serve/fake.py"), "R019")
    assert len(hits) == 1 and lock in hits[0].message, hits


def test_r019_nested_class_and_suppression():
    src = """
import threading


class Outer:
    def __init__(self):
        self.lock = threading.RLock()
        self.count = 0

    def locked(self):
        with self.lock:
            self.count += 1

    def teardown(self):
        self.count = 0  # graftlint: disable=R019 — single-threaded teardown

    class Inner:
        def bump(self):
            self.count += 1
"""
    assert "R019" not in rules_of(run_source(src, rel=PKG + "serve/f.py"))


R020_A = '''
import threading

class A:
    def __init__(self, b: "B"):
        self.lock = threading.Lock()
        self.b = b

    def m(self):
        with self.lock:
            self.b.poke()

    def kick(self):
        with self.lock:
            pass
'''

R020_B = '''
import threading

class B:
    def __init__(self, a: "A"):
        self.lock = threading.Lock()
        self.a = a

    def poke(self):
        with self.lock:
            self.a.kick()
'''


def test_r020_cross_class_cycle_and_scope():
    fs = run_project_sources({PKG + "serve/a.py": R020_A,
                              PKG + "serve/b.py": R020_B})
    hits = hits_of(fs, "R020")
    assert hits and (any("A.lock" in f.message and "B.lock" in f.message
                         for f in hits)
                     or any("re-acquired" in f.message for f in hits)), hits
    fs = run_project_sources({PKG + "louvain/a.py": R020_A,
                              PKG + "louvain/b.py": R020_B})
    assert "R020" not in rules_of(fs)


def test_r020_nonreentrant_self_deadlock_vs_rlock():
    src = '''
import threading

class S:
    def __init__(self):
        self.lock = threading.Lock()

    def outer(self):
        with self.lock:
            self.inner()

    def inner(self):
        with self.lock:
            pass
'''
    hits = hits_of(run_project_sources({PKG + "serve/s.py": src}), "R020")
    assert hits and "self-deadlock" in hits[0].message
    fs = run_project_sources({PKG + "serve/s.py": src.replace(
        "threading.Lock()", "threading.RLock()")})
    assert "R020" not in rules_of(fs)


def test_r021_check_then_act():
    bad = '''
import threading

class D:
    def __init__(self):
        self.lock = threading.Lock()
        self._routes = {}

    def submit(self, rid, client):
        if rid in self._routes:
            return False
        with self.lock:
            self._routes[rid] = client
        return True
'''
    good = bad.replace('''        if rid in self._routes:
            return False
        with self.lock:
            self._routes[rid] = client''', '''        with self.lock:
            if rid in self._routes:
                return False
            self._routes[rid] = client''')
    assert len(hits_of(run_source(bad, rel=PKG + "serve/x.py"),
                       "R021")) == 1
    assert "R021" not in rules_of(run_source(good, rel=PKG + "serve/x.py"))


def test_lock_rules_hold_on_the_port_serve_package():
    fs = run_paths([os.path.join(REPO, "cuvite_tpu_torch", "serve")])
    assert not [f for f in fs if f.rule in ("R019", "R020", "R021",
                                            "R022", "R016", "R014",
                                            "R015", "R029")], \
        [f.format() for f in fs]


def test_lockset_inventory_against_the_reference():
    """(class, owner, field, locks) over each package's serve/: every
    triple of the reference's is the port's; the port adds exactly the
    five LouvainServer fields the reference annotates on annotated
    constructor assignments (``self.failures: list = []``), which the
    reference's lockset reads no pragma from; all 37 annotated fields of
    serve/queue.py are declared in the port."""
    from cuvite_tpu.analysis.engine import SourceFile as RefSourceFile
    from cuvite_tpu.analysis.lockset import lockset_summary as ref_ls
    from cuvite_tpu_torch.analysis.lockset import lockset_summary

    def inventory(pkg, sf_cls, fn):
        out = {}
        d = os.path.join(REPO, pkg, "serve")
        for name in sorted(os.listdir(d)):
            if name.endswith(".py"):
                p = os.path.join(d, name)
                with open(p) as f:
                    sf = sf_cls(f.read(), path=p, rel=f"{pkg}/serve/{name}")
                for e in fn(sf):
                    out[(name, e["class"], e["owner"], e["field"],
                         tuple(e["locks"]))] = e["declared"]
        return out

    ref = inventory("cuvite_tpu", RefSourceFile, ref_ls)
    port = inventory("cuvite_tpu_torch", SourceFile, lockset_summary)
    assert set(ref) <= set(port)
    extra = sorted(k[3] for k in set(port) - set(ref))
    assert extra == ["_b_max", "_served_classes", "_shapes", "failures",
                     "shed"], extra
    declared = [k for k, v in port.items() if v and k[0] == "queue.py"]
    assert len(declared) == 37, len(declared)


# ---------------------------------------------------------------------------
# Tier 5: R023-R025.  The entry is sharded_bucketed_step (engine.
# MESH_ENTRIES); the mesh comes from make_mesh or make_hybrid_mesh.

MESH_FLAT = """
from cuvite_tpu_torch.comm.mesh import make_mesh

def run(comms):
    mesh = make_mesh(4)
    return (sharded_bucketed_step(comms, mesh),
            sharded_bucketed_modularity(comms, mesh))
"""

MESH_HYBRID = MESH_FLAT.replace("make_mesh(4)", "make_hybrid_mesh(2, 2)")\
    .replace("import make_mesh", "import make_hybrid_mesh")

ENTRY = """
from cuvite_tpu_torch.fake_helper5 import tail_sum, tables

def sharded_bucketed_step(comms, mesh, flag=None):
    return tail_sum(comms, mesh, flag)

def sharded_bucketed_modularity(comms, mesh):
    out = []
    for view, pos in mesh.ici_views:
        out.append(tables([comms[p] for p in pos], view, mesh))
    return out
"""


def _mesh_project(helper, driver=MESH_FLAT, entry=ENTRY):
    return {
        PKG + "fake_driver5.py": driver.replace(
            "sharded_bucketed_", "bucketed.sharded_bucketed_").replace(
            "from cuvite_tpu_torch.comm.mesh",
            "from cuvite_tpu_torch.louvain import bucketed\n"
            "from cuvite_tpu_torch.comm.mesh"),
        PKG + "louvain/bucketed.py": entry,
        PKG + "fake_helper5.py": helper,
    }


HELPER_CLEAN = """
from cuvite_tpu_torch.comm.collectives import all_gather, psum

def tail_sum(xs, mesh, flag):
    return psum(xs, mesh)

def tables(xs, view, mesh):
    return all_gather(xs, view)  # graftlint: replicated-ok=scope=ici; group table
"""


def test_mesh_clean_project_is_clean():
    fs = run_project_sources(_mesh_project(HELPER_CLEAN, MESH_HYBRID))
    assert not {"R023", "R024", "R025"} & rules_of(fs), \
        [f.format() for f in fs]


def test_r023_view_of_a_project_with_no_hybrid_mesh():
    fs = run_project_sources(_mesh_project(HELPER_CLEAN, MESH_FLAT))
    hits = hits_of(fs, "R023")
    assert len(hits) == 1, [f.format() for f in fs]
    assert "'ici'" in hits[0].message
    assert "bucketed.py::sharded_bucketed_modularity" in hits[0].message


def test_r023_hybrid_table_rewidened_to_the_whole_mesh_convicted():
    """The counterpart of the reference's
    test_r023_hybrid_table_rewidened_to_flat_axis_convicted: the group
    table's all-gather given the whole mesh instead of the ICI view its
    caller hands it."""
    sab = HELPER_CLEAN.replace("return all_gather(xs, view)",
                               "return all_gather(xs, mesh)")
    fs = run_project_sources(_mesh_project(sab, MESH_HYBRID))
    hits = hits_of(fs, "R023")
    assert len(hits) == 1, [f.format() for f in fs]
    assert hits[0].path == PKG + "fake_helper5.py"
    assert "('v')" in hits[0].message and "['ici']" in hits[0].message
    assert "bucketed.py::sharded_bucketed_modularity" in hits[0].message


def test_r023_union_of_callers_admits_both_scopes():
    """A helper its callers hand both a view and the whole mesh admits
    both: a collective over the whole mesh is legal there."""
    entry = ENTRY + """
def sharded_step(comms, mesh):
    return tables(comms, mesh, mesh)
"""
    sab = HELPER_CLEAN.replace("return all_gather(xs, view)",
                               "return all_gather(xs, view)\n\n"
                               "def wide(xs, view, mesh):\n"
                               "    return psum(xs, view)")
    fs = run_project_sources(_mesh_project(sab, MESH_HYBRID, entry))
    assert "R023" not in rules_of(fs), [f.format() for f in fs]


def test_r023_no_entry_no_finding_and_suppression():
    sab = HELPER_CLEAN.replace("return all_gather(xs, view)",
                               "return all_gather(xs, mesh)")
    entry = ENTRY.replace("def sharded_bucketed_modularity",
                          "def host_modularity")
    fs = run_project_sources(_mesh_project(sab, MESH_HYBRID, entry))
    assert "R023" not in rules_of(fs)
    quiet = sab.replace("return all_gather(xs, mesh)",
                        "return all_gather(xs, mesh)  # graftlint: "
                        "disable=R023 — a staged gather")
    fs = run_project_sources(_mesh_project(quiet, MESH_HYBRID))
    assert "R023" not in rules_of(fs)


def test_r024_conditional_collective_cross_module():
    bad = HELPER_CLEAN.replace("    return psum(xs, mesh)",
                               "    if flag.any():\n"
                               "        return psum(xs, mesh)\n"
                               "    return xs")
    fs = run_project_sources(_mesh_project(bad, MESH_HYBRID))
    hits = hits_of(fs, "R024")
    assert len(hits) == 1, [f.format() for f in fs]
    assert "flag.any" in hits[0].message
    assert "bucketed.py::sharded_bucketed_step" in hits[0].message
    try_form = HELPER_CLEAN.replace("    return psum(xs, mesh)",
                                    "    try:\n"
                                    "        return psum(xs, mesh)\n"
                                    "    except ValueError:\n"
                                    "        return xs")
    assert "R024" in rules_of(run_project_sources(
        _mesh_project(try_form, MESH_HYBRID)))
    rank = HELPER_CLEAN.replace("    return psum(xs, mesh)",
                                "    if multihost.rank() == 0:\n"
                                "        return psum(xs, mesh)\n"
                                "    return xs")
    assert "R024" in rules_of(run_project_sources(
        _mesh_project(rank, MESH_HYBRID)))


def test_r024_requires_mesh_entry_reach_and_leaves_dist_to_r004():
    bad = HELPER_CLEAN.replace("    return psum(xs, mesh)",
                               "    if flag.any():\n"
                               "        return psum(xs, mesh)\n"
                               "    return xs")
    assert "R024" not in rules_of(run_project_sources(
        {PKG + "fake_solo5.py": bad}))
    host = HELPER_CLEAN.replace(
        "    return psum(xs, mesh)",
        "    if flag.any():\n"
        "        import torch.distributed as dist\n"
        "        dist.all_reduce(xs[0])\n"
        "        return multihost.gather_global(xs)\n"
        "    return xs")
    rules = rules_of(run_project_sources(_mesh_project(host, MESH_HYBRID)))
    assert "R004" in rules and "R024" not in rules


R025_TABLE = """
import torch
from cuvite_tpu_torch.comm.collectives import psum

def sharded_bucketed_step(comms, mesh, nv_total):
    table = torch.zeros(nv_total, dtype=torch.float32)%s
    return psum([table], mesh)
"""


def test_r025_unannotated_nv_total_table():
    src = {PKG + "louvain/bucketed.py": R025_TABLE % ""}
    hits = hits_of(run_project_sources(src), "R025")
    assert len(hits) == 1, hits
    assert "nv_total" in hits[0].message and "replicated-ok" in \
        hits[0].message


def test_r025_annotation_closes_it_and_feeds_the_inventory():
    rel = PKG + "louvain/bucketed.py"
    src = {rel: R025_TABLE
           % "  # graftlint: replicated-ok=scope=ici; frozen table"}
    assert "R025" not in rules_of(run_project_sources(src))
    inv = replicated_inventory([summarize(SourceFile(src[rel], path=rel,
                                                     rel=rel))])
    assert [(d["scope"], d["reason"]) for d in inv] == \
        [("ici", "frozen table")]


def test_r025_positional_broadcast_and_gather_spellings_convict():
    src = {PKG + "louvain/bucketed.py": """
import torch
from cuvite_tpu_torch.comm.collectives import all_gather
from cuvite_tpu_torch.ops import segment as seg

def sharded_bucketed_step(comms, vdegs, mesh, nv_total):
    deg = seg.segment_sum(vdegs[0], comms[0], nv_total)
    rep = torch.broadcast_to(vdegs[0][:1], (nv_total,))
    full = all_gather(comms, mesh)
    return deg, rep, full
"""}
    assert len(hits_of(run_project_sources(src), "R025")) == 3


def test_r025_unreached_table_is_clean():
    src = {PKG + "fake_host25.py": """
import torch

def table_of(nv_total):
    return torch.zeros(nv_total, dtype=torch.int32)
"""}
    assert "R025" not in rules_of(run_project_sources(src))


def test_tier5_rides_the_cache_warm_equals_cold(tmp_path):
    tree = tmp_path / "cuvite_tpu_torch"
    for rel, text in _mesh_project(HELPER_CLEAN, MESH_FLAT).items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    cache = str(tmp_path / "cache.json")
    cold = run_paths([str(tree)], cache=cache)
    warm = run_paths([str(tree)], cache=cache)
    assert cold == warm and "R023" in rules_of(warm)


# ---------------------------------------------------------------------------
# The root tables on the port's own tree.


@pytest.fixture(scope="module")
def port_project():
    summaries = []
    root = os.path.join(REPO, "cuvite_tpu_torch")
    for p in iter_py_files([root]):
        rel = os.path.relpath(p, REPO).replace(os.sep, "/")
        with open(p) as f:
            summaries.append(summarize(SourceFile(f.read(), path=p,
                                                  rel=rel)))
    return Project(summaries)


@pytest.mark.parametrize("table,flag", [(DEVICE_PATH_ROOTS, "entry"),
                                        (MESH_ENTRIES, "mesh_entry")],
                         ids=["device-path-roots", "mesh-entries"])
def test_every_table_entry_resolves_and_reaches(port_project, table, flag):
    """Each entry names a function (or a class of methods) of the port's
    tree, and the reach from each is non-empty beyond the root itself:
    an empty or stale table would let the rules pass vacuously."""
    roots = port_project.roots(flag)
    for mod, name in table:
        mine = [k for k in roots if k[0] == mod
                and (k[1] == name or k[1].startswith(name + "."))]
        assert mine, (mod, name)
        reach = port_project._reach(mine)
        assert len(reach) > len(mine), (mod, name, sorted(reach))
    assert len(port_project._reach(roots)) >= 20


def test_the_port_replication_inventory(port_project):
    """Every O(nv_total) table the mesh entries reach is annotated (the
    gate holds R025), and none keeps the global scope."""
    inv = replicated_inventory(port_project.summaries)
    assert len(inv) >= 9
    assert {d["scope"] for d in inv} <= {"ici", "bench"}
    rels = {d["rel"] for d in inv}
    assert {PKG + "louvain/bucketed.py", PKG + "louvain/step.py",
            PKG + "comm/exchange.py"} <= rels
