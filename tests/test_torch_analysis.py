"""The port's static analysis (``cuvite_tpu_torch.analysis``), tier 1 and
the engine, held against the reference's (``cuvite_tpu.analysis``).

- Parity: the rules that read the same source in both packages (R005,
  R007-R009, R015, R016, R019-R022) run the same fixture, laid out in a
  ``tmp_path`` tree as each package expects, through both packages'
  ``run_paths``; rule ids, lines and counts agree.
- Torch counterparts: each adapted rule trips on a known-bad torch
  fixture and stays silent on a clean one.
- Engine parity: suppressions, the baseline format (one file reads in
  both packages), ``--format json`` and ``sarif`` shapes, the cache.
- The gate: the port's tree passes against its own baseline; a copy with
  one known-bad fixture per rule fails and names every rule.

Every fixture is a source STRING (or a file under ``tmp_path``), never
live code here: the reference's self-lint gate scans ``tests/``.  The
analysis is host-only and imports no torch.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from cuvite_tpu.analysis import engine as ref_engine
from cuvite_tpu.analysis import run_paths as ref_run_paths
from cuvite_tpu.analysis.__main__ import main as ref_main
from cuvite_tpu_torch.analysis import (
    all_rules,
    apply_baseline,
    load_baseline,
    run_paths,
    run_source,
    write_baseline,
)
from cuvite_tpu_torch.analysis import engine
from cuvite_tpu_torch.analysis.__main__ import (
    DEFAULT_BASELINE,
    DEFAULT_PATHS,
    main,
    to_sarif,
)
from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "cuvite_tpu_torch/"


def rules_of(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# (a) Parity: one fixture, both packages.  Each case is (rule, source,
# reference rel, port rel); the tree is written under tmp_path twice.

SERVE_LOOP = """
from cuvite_tpu.core.batch import batch_bucket_plans
from cuvite_tpu.louvain.bucketed import BucketPlan

def dispatch(jobs, nv_pad):
    plans = []
    for job in jobs:
        plans.append(BucketPlan.build(job.src, job.dst, job.w,
                                      nv_local=nv_pad, base=0))
        plans.append(batch_bucket_plans(job.batch))
    return plans

def one_off(job, nv_pad):
    return BucketPlan.build(job.src, job.dst, job.w, nv_local=nv_pad)

def justified(jobs, nv_pad):
    for job in jobs:
        yield BucketPlan.build(job.src, nv_local=nv_pad)  # graftlint: disable=R015 — diagnostic
"""

WALL_CLOCK = """
import time

def due(queue, linger_s, clock=time.monotonic):
    now = time.monotonic()
    stamp = time.time()
    t0 = time.perf_counter()
    out = [j for j in queue if now - j.t_submit >= linger_s]
    return out, stamp, time.perf_counter() - t0, clock()
"""

THREADS = """
import threading
from threading import Event, Thread

def start(daemon):
    daemon.lock = threading.Lock()
    daemon.wake = Event()
    t = Thread(target=daemon.run)
    t.start()
    return t

def annotate(x: threading.RLock) -> None:
    pass

def justified():
    return threading.Barrier(2)  # graftlint: disable=R022 — a harness barrier
"""

MUTATIONS = """
import numpy as np

def freeze(x, out, acc, cur):
    x.flags.writeable = False
    out[:10] = 0
    np.copyto(out, x)
    acc.fill(0)
    cur[3] += 1
    local = np.empty_like(x)
    local[:2] = 0
    return local

def freeze_ref(x_ref, o_ref):
    o_ref[...] = x_ref[...]
"""

SUBPROCS = """
import subprocess
import sys

def bench(cmd, **kw):
    a = subprocess.run([sys.executable] + cmd, capture_output=True)
    b = subprocess.check_output(cmd)
    c = subprocess.run(cmd, timeout=600)
    d = subprocess.run(cmd, **kw)
    return a, b, c, d
"""

SYSCTL = """
import os

if not os.environ.get("NO_SYSCTL"):
    with open("/proc/sys/vm/max_map_count", "w") as f:
        f.write("1048576")
if os.environ.get("RAISE_SYSCTL"):
    with open("/proc/sys/vm/max_map_count", "w") as f:
        f.write("1048576")
with open("/proc/sys/vm/max_map_count") as f:
    cur = int(f.read())

def leak():
    os.putenv("X", "1")
"""

NETWORK = """
import hashlib
import subprocess
import urllib.request

def fetch(url, dest):
    with urllib.request.urlopen(url, timeout=60) as resp:
        data = resp.read()
    subprocess.run(["curl", "-o", dest, url], timeout=60)
    return data

def fetch_checked(url, expected):
    h = hashlib.sha256()
    with urllib.request.urlopen(url, timeout=60) as resp:
        h.update(resp.read())
    return h.hexdigest() == expected
"""

LOCKSET = """
import threading


class Stats:
    jobs_shed: int = 0  # graftlint: guarded-by=self.lock

    def __init__(self):
        self.lock = threading.RLock()
        self.jobs_done = 0
        self.samples = []

    def record(self, wait):
        with self.lock:
            self.jobs_done += 1
            self.samples.append(wait)

    def racy(self, wait):
        self.jobs_done += 1
        self.samples.append(wait)
        self.jobs_shed += 1


class Dispatcher:
    def __init__(self, stats):
        self.stats = stats

    def locked_path(self, wait):
        with self.stats.lock:
            self.stats.jobs_done += 1

    def drain_recheck(self, wait):
        self.stats.jobs_done += 1  # graftlint: disable=R019 — teardown
        self.stats.jobs_done += 1


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
"""

LOCK_A = '''
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

LOCK_B = '''
import threading

class B:
    def __init__(self, a: "A"):
        self.lock = threading.Lock()
        self.a = a

    def poke(self):
        with self.lock:
            self.a.kick()
'''

LOCK_SELF = '''
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

class C:
    def m1(self):
        with self.a_lock:
            with self.b_lock:
                pass

    def m2(self):
        with self.b_lock:
            with self.a_lock:
                pass
'''

# (rule ids, {reference rel: source}, {port rel: source}); the rels differ
# only where the two packages scope a rule to a different place.
PARITY_CASES = [
    (("R005",), {"cuvite_tpu/fake.py": MUTATIONS},
     {PKG + "fake.py": MUTATIONS}),
    (("R007",), {"tools/fake_tool.py": SUBPROCS},
     {PKG + "tools/fake_tool.py": SUBPROCS}),
    (("R007",), {"tools/fake_tool.py": SUBPROCS},
     {"chip_smoke.py": SUBPROCS}),
    (("R008",), {"tests/test_fake.py": SYSCTL},
     {"tests/test_torch_fake.py": SYSCTL}),
    (("R009",), {"cuvite_tpu/workloads/registry.py": NETWORK},
     {PKG + "workloads/registry.py": NETWORK}),
    (("R009",), {"cuvite_tpu/fake_net.py": NETWORK},
     {PKG + "fake_net.py": NETWORK}),
    (("R015",), {"cuvite_tpu/serve/fake.py": SERVE_LOOP},
     {PKG + "serve/fake.py": SERVE_LOOP}),
    (("R015",), {"cuvite_tpu/louvain/batched.py":
                 SERVE_LOOP.replace("def dispatch", "def pack_jobs")},
     {PKG + "louvain/batched.py":
      SERVE_LOOP.replace("def dispatch", "def pack_jobs")}),
    (("R016",), {"cuvite_tpu/serve/fake.py": WALL_CLOCK,
                 "cuvite_tpu/serve/clock.py": WALL_CLOCK},
     {PKG + "serve/fake.py": WALL_CLOCK, PKG + "serve/clock.py": WALL_CLOCK}),
    (("R019", "R021"), {"cuvite_tpu/serve/fake.py": LOCKSET},
     {PKG + "serve/fake.py": LOCKSET}),
    (("R020",), {"cuvite_tpu/serve/a.py": LOCK_A,
                 "cuvite_tpu/serve/b.py": LOCK_B,
                 "cuvite_tpu/serve/s.py": LOCK_SELF},
     {PKG + "serve/a.py": LOCK_A, PKG + "serve/b.py": LOCK_B,
      PKG + "serve/s.py": LOCK_SELF}),
    (("R022",), {"cuvite_tpu/serve/fake.py": THREADS,
                 "cuvite_tpu/serve/sync.py": THREADS},
     {PKG + "serve/fake.py": THREADS, PKG + "serve/sync.py": THREADS}),
]
PARITY_IDS = [f"{'-'.join(c[0])}-{next(iter(c[2]))}" for c in PARITY_CASES]


def _write_tree(root, files: dict) -> list:
    """Write {rel: source} under ``root``; returns the scan roots (each
    top-level entry, so rels resolve against ``root``)."""
    tops = set()
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        tops.add(rel.split("/")[0])
    return [str(root / t) for t in sorted(tops)]


def _sites(findings, ids) -> list:
    """(line, rule, snippet) of the findings of ``ids``: the rels differ
    between the packages, the sites do not."""
    return sorted((f.line, f.rule, f.snippet)
                  for f in findings if f.rule in ids)


@pytest.mark.parametrize("ids,ref_files,port_files", PARITY_CASES,
                         ids=PARITY_IDS)
def test_parity_with_the_reference_rules(tmp_path, ids, ref_files,
                                         port_files):
    ref = ref_run_paths(_write_tree(tmp_path / "ref", ref_files))
    port = run_paths(_write_tree(tmp_path / "port", port_files))
    got, want = _sites(port, ids), _sites(ref, ids)
    assert want, f"the reference found no {ids} on its fixture"
    assert got == want, (got, want)


def test_parity_scopes_differ_where_the_packages_do(tmp_path):
    """The reference's tools/ and tests/ scopes are not the port's: the
    same files at the reference's rels trip nothing in the port."""
    files = {"tools/fake_tool.py": SUBPROCS, "tests/test_fake.py": SYSCTL}
    port = run_paths(_write_tree(tmp_path, files))
    assert not {"R007", "R008"} & rules_of(port)


# ---------------------------------------------------------------------------
# (b) Torch counterparts of the adapted tier-1 rules: (rule, bad, clean,
# rel).  The clean variant stays close to the bad one.

TORCH_CASES = [
    (
        "R001",
        """
import torch

def bucketed_step(plan, comm, vdeg):
    return _helper(comm)

def _helper(comm):
    n = comm.sum().item()
    moved = int(comm.max())
    host = comm.cpu()
    idx = torch.nonzero(comm)
    torch.cuda.synchronize()
    return n, moved, host, idx, comm.tolist(), comm.numpy()
""",
        """
import torch

def bucketed_step(plan, comm, vdeg):
    c32 = float(torch.tensor(0.5, dtype=torch.float32))
    return comm * 2, int(plan.nv), c32

def _host_report(comm):
    # the same host reads, reached from no device-path root
    return comm.sum().item(), comm.cpu(), torch.nonzero(comm)
""",
        PKG + "louvain/bucketed.py",
    ),
    (
        "R003",
        """
import torch

def device_ids(n, x):
    pad = torch.zeros(n, dtype=torch.int64)
    wide = torch.full((n,), 0, dtype=torch.long)
    acc = x.to(torch.float64)
    return pad, wide, acc, torch.double
""",
        """
import numpy as np
import torch

def device_ids(n, x):
    host = np.zeros(n, dtype=np.int64)   # host plan arrays are fine
    idx = x.long()                       # index widening for gather
    q = x.double().sum()  # graftlint: disable=R003 — Q in f64
    return torch.as_tensor(host, dtype=torch.int32), idx, q
""",
        PKG + "louvain/fake_r003.py",
    ),
    (
        "R004",
        """
import torch.distributed as dist
from cuvite_tpu_torch.comm import multihost

def resume(path, arr, group, ranks):
    try:
        multihost.barrier()
    except ValueError:
        pass
    if dist.get_rank() == 0:
        dist.all_reduce(arr)
    if multihost.rank() in ranks:
        group = dist.new_group(ranks)
    if _load(path):
        return multihost.gather_global(arr)
    return group

def _load(path):
    return None
""",
        """
import torch.distributed as dist
from cuvite_tpu_torch.comm import multihost

def resume(distributed, arr, ranks):
    if distributed:                     # replicated plain value
        group = dist.new_group(ranks)   # every rank, one order
    if dist.get_world_size() > 1:       # rank-uniform predicate
        dist.all_reduce(arr)
    if multihost.is_distributed():
        return multihost.gather_global(arr)
    return group
""",
        PKG + "comm/fake_r004.py",
    ),
    (
        "R005",
        """
import torch

def update(x, out, idx, v):
    x.add_(1)
    out.index_put_((idx,), v)
    torch.cumsum(v, 0, out=out)
    x[idx] = v
""",
        """
import torch

def update(x, idx, v):
    y = x.clone()
    y.add_(1)                  # a local copy: ours to mutate
    out = torch.empty_like(v)
    torch.cumsum(v, 0, out=out)
    return y, out
""",
        PKG + "ops/fake_r005.py",
    ),
    (
        "R006",
        """
import torch

def phase_q(e_c, a_c):
    mod = e_c.sum() - a_c.square().sum()
    return mod
""",
        """
import torch

def phase_q(e_c, a_c, comm_deg64):
    mod = e_c.double().sum() - a_c.square().sum(dtype=torch.float64)
    q = comm_deg64.square().sum()
    return mod, q
""",
        PKG + "louvain/fake_r006.py",
    ),
    (
        "R010",
        """
import torch

def phase_transition(src, labels):
    host = src.cpu()
    lab = labels.numpy()
    ids = torch.nonzero(src)
    return host, lab, ids, labels.tolist(), src.to("cpu")
""",
        """
import torch

def phase_transition(src, labels, plan):
    n = src.numel()
    dev = src.to(labels.device)
    final = labels.cpu()  # graftlint: disable=R010 — the final label gather
    return n, dev, final
""",
        PKG + "coarsen/fake_r010.py",
    ),
    (
        "R012",
        """
import time
import torch

def bench(x, fn):
    t0 = time.perf_counter()
    y = torch.matmul(x, x)
    dt = time.perf_counter() - t0
    t1 = time.perf_counter()
    z = x.cuda()
    dz = time.perf_counter() - t1
    return y, dt, z, dz
""",
        """
import time
import torch

def bench(x, fn):
    t0 = time.perf_counter()
    y = torch.matmul(x, x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    t1 = time.perf_counter()
    s = float(torch.matmul(x, x).sum())
    ds = time.perf_counter() - t1
    t2 = time.perf_counter()
    fn(x)                       # an opaque callable: not flagged
    df = time.perf_counter() - t2
    return y, dt, s, ds, df
""",
        PKG + "tools/fake_r012.py",
    ),
    (
        "R013",
        """
import torch

def coalesce(key):
    order = torch.argsort(key)
    vals, idx = torch.sort(key, stable=True)
    return order, vals, idx
""",
        """
import numpy as np
from cuvite_tpu_torch.ops import segment as seg

def coalesce(src, dst, w, nv):
    host = np.sort(np.asarray([3, 1]))   # host arrays: out of scope
    return seg.coalesced_runs(src, dst, w, nv), host
""",
        PKG + "coarsen/fake_r013.py",
    ),
    (
        "R014",
        """
import torch
from cuvite_tpu_torch.utils.upload import to_device

def dispatch(jobs, dev):
    out = []
    for job in jobs:
        out.append(to_device(job.src, dev))
        out.append(job.w.to(dev))
        out.append(torch.as_tensor(job.dst, device=dev))
    return out
""",
        """
import torch
from cuvite_tpu_torch.utils.upload import to_device

def dispatch(jobs, dev, stacked):
    # ONE placement per packed batch, outside the loop
    slab = to_device(stacked, dev)
    for job in jobs:
        job.mask = job.w.to(torch.int32)   # a cast, not an upload
        job.back = job.w.to("cpu")
    return slab
""",
        PKG + "serve/fake_r014.py",
    ),
    (
        "R029",
        """
def hot_patch(sess, i, weight):
    sess.w.index_put_((i,), weight)
    sess.src.copy_(sess.src)
    sess.dst.scatter_(0, i, weight)
    return sess
""",
        """
from cuvite_tpu_torch.stream.delta import apply_delta_slab

def hot_patch(sess, batch):
    return apply_delta_slab(sess.src, sess.dst, sess.w, batch)

def scratch(mask, idx):
    mask.index_fill_(0, idx, True)  # graftlint: disable=R029 — local scratch mask
    return mask
""",
        PKG + "stream/fake_r029.py",
    ),
]
TORCH_IDS = [c[0] for c in TORCH_CASES]


@pytest.mark.parametrize("rule_id,bad,good,rel", TORCH_CASES, ids=TORCH_IDS)
def test_torch_rule_trips_on_its_bad_fixture(rule_id, bad, good, rel):
    findings = run_source(bad, rel=rel)
    assert rule_id in rules_of(findings), findings


@pytest.mark.parametrize("rule_id,bad,good,rel", TORCH_CASES, ids=TORCH_IDS)
def test_torch_rule_silent_on_its_clean_fixture(rule_id, bad, good, rel):
    findings = run_source(good, rel=rel)
    assert rule_id not in rules_of(findings), findings


# Exact site counts of the bad fixtures: each spelling the rule claims is
# one finding (so a rule that trips on one spelling only fails here).
TORCH_COUNTS = {"R001": 7, "R003": 4, "R004": 4, "R005": 4, "R006": 1,
                "R010": 5, "R012": 2, "R013": 2, "R014": 3, "R029": 3}


@pytest.mark.parametrize("rule_id,bad,good,rel", TORCH_CASES, ids=TORCH_IDS)
def test_torch_rule_counts_every_spelling(rule_id, bad, good, rel):
    hits = [f for f in run_source(bad, rel=rel) if f.rule == rule_id]
    assert len(hits) == TORCH_COUNTS[rule_id], [f.format() for f in hits]


@pytest.mark.parametrize("rule_id,rel,outside", [
    ("R001", PKG + "louvain/bucketed.py", PKG + "louvain/fake.py"),
    ("R003", PKG + "louvain/fake_r003.py", PKG + "io/fake_r003.py"),
    ("R010", PKG + "coarsen/fake_r010.py", PKG + "workloads/fake.py"),
    ("R012", PKG + "tools/fake_r012.py", PKG + "louvain/fake.py"),
    ("R013", PKG + "coarsen/fake_r013.py", PKG + "ops/segment.py"),
    ("R014", PKG + "serve/fake_r014.py", PKG + "stream/fake.py"),
    ("R029", PKG + "stream/fake_r029.py", PKG + "stream/delta.py"),
])
def test_torch_rule_scope(rule_id, rel, outside):
    """Each scoped rule is silent on its bad fixture outside its scope
    (R001: ``bucketed_step`` is a root only in louvain/bucketed.py)."""
    bad = dict((c[0], c[1]) for c in TORCH_CASES)[rule_id]
    assert rule_id in rules_of(run_source(bad, rel=rel))
    assert rule_id not in rules_of(run_source(bad, rel=outside))


def test_r001_reaches_through_the_root_table_only():
    """R001 starts from engine.DEVICE_PATH_ROOTS: the same body under a
    name the table lacks is host code."""
    bad = TORCH_CASES[0][1]
    rel = PKG + "louvain/bucketed.py"
    assert "R001" in rules_of(run_source(bad, rel=rel))
    renamed = bad.replace("def bucketed_step", "def host_step")
    assert "R001" not in rules_of(run_source(renamed, rel=rel))
    # a nested root: fused_sweep's sweep closure, by qualified name
    nested = """
def fused_sweep(src, comm0):
    def sweep(comm, _active):
        return comm.sum().item()
    return sweep

def other(src):
    def sweep(comm, _active):
        return comm.sum().item()
    return sweep
"""
    hits = [f for f in run_source(nested, rel=PKG + "louvain/fused.py")
            if f.rule == "R001"]
    assert [f.line for f in hits] == [4], hits


@pytest.mark.parametrize("rel,fires", [
    (PKG + "louvain/batched.py", True), (PKG + "core/batch.py", True),
    (PKG + "louvain/fused.py", False)])
def test_r014_packer_functions_are_in_scope(rel, fires):
    """The packer path (pack_*/prepare_*/unpack_* in the batched driver
    and the slab packer) holds serve/'s one-upload-a-batch contract;
    other loops of those modules and of other modules do not."""
    bad = dict((c[0], c[1]) for c in TORCH_CASES)["R014"]
    packer = bad.replace("def dispatch", "def pack_jobs")
    hits = [f for f in run_source(packer, rel=rel) if f.rule == "R014"]
    assert bool(hits) == fires, hits
    assert "R014" not in rules_of(run_source(bad, rel=rel))


def test_r008_torch_globals_at_module_scope(tmp_path):
    src = """
import torch

torch.set_num_threads(1)
torch.manual_seed(0)

def test_x(monkeypatch):
    torch.manual_seed(1)     # inside a test: its own business
"""
    hits = [f for f in run_source(src, rel="tests/test_torch_fake.py")
            if f.rule == "R008"]
    assert [f.line for f in hits] == [4, 5], hits


def test_dropped_rules_are_listed_with_their_reason(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    registered = {r.id for r in all_rules()}
    assert not {"R002", "R011"} & registered
    for rid, word in (("R002", "no jit"), ("R011", "no Pallas"),
                      ("R014", "jit/vmap half")):
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(rid) and word in ln)
        assert "dropped" in line, line
    assert "not ported yet" not in out
    ported = {"R001", "R003", "R004", "R005", "R006", "R007", "R008",
              "R009", "R010", "R012", "R013", "R014", "R015", "R016",
              "R017", "R018", "R019", "R020", "R021", "R022", "R023",
              "R024", "R025", "R026", "R027", "R028", "R029"}
    assert registered == ported


# ---------------------------------------------------------------------------
# (c) Engine parity: suppressions, baseline, fingerprints, JSON/SARIF,
# the cache.

SUPPRESSIBLE = """
import subprocess

def run(cmd):
    return subprocess.run(cmd)%s
"""


@pytest.mark.parametrize("suffix,rel,fires", [
    ("", PKG + "tools/a.py", True),
    ("  # graftlint: disable=R007", PKG + "tools/a.py", False),
    ("  # graftlint: disable=R001, R007 — reason", PKG + "tools/a.py",
     False),
    ("  # graftlint: disable=all", PKG + "tools/a.py", False),
    ("  # graftlint: disable=R001", PKG + "tools/a.py", True),
])
def test_line_suppression_as_the_reference(suffix, rel, fires):
    src = SUPPRESSIBLE % suffix
    port = "R007" in rules_of(run_source(src, rel=rel))
    ref = "R007" in {f.rule for f in ref_engine.run_source(
        src, rel="tools/a.py")}
    assert port == ref == fires


def test_file_suppression_and_quoted_pragmas():
    top = "# graftlint: disable-file=R007\n" + SUPPRESSIBLE % ""
    assert "R007" not in rules_of(run_source(top, rel=PKG + "tools/a.py"))
    late = SUPPRESSIBLE % "" + "\n" * 30 + "# graftlint: disable-file=R007\n"
    assert "R007" in rules_of(run_source(late, rel=PKG + "tools/a.py"))
    quoted = ('"""Quotes # graftlint: disable-file=R007 in prose."""\n'
              + SUPPRESSIBLE % "")
    assert "R007" in rules_of(run_source(quoted, rel=PKG + "tools/a.py"))


def test_fingerprints_and_baseline_read_in_both_packages(tmp_path):
    """A finding both packages make at one site has one fingerprint, and
    a baseline the port writes is one the reference reads, entry for
    entry (and the reverse): the format is shared."""
    rel = "cuvite_tpu/fake_net.py"
    port = [f for f in run_source(NETWORK, rel=rel) if f.rule == "R009"]
    ref = [f for f in ref_engine.run_source(NETWORK, rel=rel)
           if f.rule == "R009"]
    assert port and [f.fingerprint() for f in port] == \
        [f.fingerprint() for f in ref]
    bl, bl2 = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    write_baseline(bl, port)
    ref_engine.write_baseline(bl2, ref)
    with open(bl) as a, open(bl2) as b:
        assert a.read() == b.read()
    assert load_baseline(bl) == ref_engine.load_baseline(bl)
    new, old = ref_engine.apply_baseline(port, ref_engine.load_baseline(bl))
    assert (new, len(old)) == ([], len(port))
    new, old = apply_baseline(ref, load_baseline(bl2))
    assert (new, len(old)) == ([], len(ref))


def test_baseline_survives_line_drift_and_counts_duplicates(tmp_path):
    src = SUPPRESSIBLE % ""
    rel = PKG + "tools/a.py"
    bl = str(tmp_path / "bl.json")
    write_baseline(bl, run_source(src, rel=rel))
    drifted = "\n\n\n" + src
    new, old = apply_baseline(run_source(drifted, rel=rel),
                              load_baseline(bl))
    assert (new, len(old)) == ([], 1)
    twice = src + "\ndef run2(cmd):\n    return subprocess.run(cmd)\n"
    new, old = apply_baseline(run_source(twice, rel=rel), load_baseline(bl))
    assert len(new) == 1 and len(old) == 1


def test_e000_is_never_baselined(tmp_path):
    tree = tmp_path / "cuvite_tpu_torch" / "tools"
    tree.mkdir(parents=True)
    (tree / "broken.py").write_text("def f(:\n")
    findings = run_paths([str(tmp_path / "cuvite_tpu_torch")])
    assert rules_of(findings) == {"E000"}
    bl = str(tmp_path / "bl.json")
    write_baseline(bl, findings)
    new, _ = apply_baseline(findings, load_baseline(bl))
    assert rules_of(new) == {"E000"}
    assert rules_of(run_paths([str(tmp_path / "missing")])) == {"E000"}


def _shape(x):
    """The key structure of a JSON document, values dropped."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in sorted(x.items())}
    if isinstance(x, list):
        return [_shape(x[0])] if x else []
    return type(x).__name__


@pytest.mark.parametrize("fmt", ["json", "sarif"])
def test_cli_output_shapes_equal_the_reference(tmp_path, capsys, fmt):
    """``--format json`` and ``sarif`` of both CLIs on the same findings
    (the same fixture in each package's tools/ scope): equal shapes, and
    the same rules, lines and snippets."""
    ref_tree = tmp_path / "ref" / "tools"
    ref_tree.mkdir(parents=True)
    (ref_tree / "a.py").write_text(SUBPROCS)
    port_tree = tmp_path / "port" / "cuvite_tpu_torch" / "tools"
    port_tree.mkdir(parents=True)
    (port_tree / "a.py").write_text(SUBPROCS)
    assert ref_main([str(ref_tree), "--format", fmt, "--no-project"]) == 1
    ref = json.loads(capsys.readouterr().out)
    assert main([str(port_tree.parent), "--format", fmt,
                 "--no-project"]) == 1
    port = json.loads(capsys.readouterr().out)
    assert _shape(port) == _shape(ref)
    if fmt == "json":
        pick = [(f["rule"], f["line"], f["snippet"])
                for f in port["findings"]]
        assert pick == [(f["rule"], f["line"], f["snippet"])
                        for f in ref["findings"]]
        assert port["gate"] == ref["gate"]
    else:
        res = port["runs"][0]["results"]
        ref_res = ref["runs"][0]["results"]
        assert [(r["ruleId"], r["level"],
                 r["locations"][0]["physicalLocation"]["region"])
                for r in res] == \
            [(r["ruleId"], r["level"],
              r["locations"][0]["physicalLocation"]["region"])
             for r in ref_res]
        meta = {r["id"] for r in port["runs"][0]["tool"]["driver"]["rules"]}
        assert {"R007", "R017", "R023", "E000"} <= meta


def test_sarif_fingerprint_is_the_reference_hash():
    from cuvite_tpu.analysis.__main__ import to_sarif as ref_to_sarif

    findings = run_source(SUPPRESSIBLE % "", rel=PKG + "tools/a.py")
    ours = to_sarif(findings)["runs"][0]["results"]
    theirs = ref_to_sarif(findings)["runs"][0]["results"]
    assert [r["partialFingerprints"] for r in ours] == \
        [r["partialFingerprints"] for r in theirs]


def test_sarif_excludes_baselined_findings(tmp_path, capsys):
    tree = tmp_path / "cuvite_tpu_torch" / "tools"
    tree.mkdir(parents=True)
    (tree / "a.py").write_text(SUPPRESSIBLE % "")
    bl = str(tmp_path / "bl.json")
    root = str(tree.parent)
    assert main([root, "--baseline", bl, "--write-baseline"]) == 0
    capsys.readouterr()
    (tree / "b.py").write_text(SUPPRESSIBLE % "")
    assert main([root, "--baseline", bl, "--format", "sarif"]) == 1
    run = json.loads(capsys.readouterr().out)["runs"][0]
    assert [r["locations"][0]["physicalLocation"]["artifactLocation"]
            ["uri"] for r in run["results"]] == [PKG + "tools/b.py"]
    assert run["properties"]["baselinedFindings"] == 1


def test_sarif_of_the_project_tiers():
    from cuvite_tpu_torch.analysis import run_project_sources

    findings = [f for f in run_project_sources(PROJECT_BAD)
                if f.rule in ("R017", "R018", "R020", "R023", "R024",
                              "R025")]
    doc = to_sarif(findings)
    results = doc["runs"][0]["results"]
    assert sorted({r["ruleId"] for r in results}) == \
        ["R017", "R018", "R020", "R023", "R024", "R025"]
    assert all(r["level"] == "error" and r["partialFingerprints"]
               for r in results)


def _mini_tree(tmp_path):
    tree = tmp_path / "cuvite_tpu_torch"
    (tree / "tools").mkdir(parents=True)
    (tree / "tools" / "a.py").write_text(SUPPRESSIBLE % "")
    (tree / "serve").mkdir()
    (tree / "serve" / "a.py").write_text(LOCK_A)
    (tree / "serve" / "b.py").write_text(LOCK_B)
    (tree / "b.py").write_text("def ok():\n    return 1\n")
    return tree


def test_cache_hit_is_bit_identical_to_a_cold_run(tmp_path):
    tree = _mini_tree(tmp_path)
    cache = str(tmp_path / "cache.json")
    cold = run_paths([str(tree)])
    warm0 = run_paths([str(tree)], cache=cache)
    warm1 = run_paths([str(tree)], cache=cache)
    assert cold == warm0 == warm1
    assert {"R007", "R020"} <= rules_of(warm1)
    with open(cache) as f:
        data = json.load(f)
    ent = data["entries"][PKG + "serve/a.py"]
    assert ent["summary"]["locks"]["classes"]["A"]["methods"]["m"]
    assert "R020" not in {f["rule"] for f in ent["findings"]}


def test_cache_invalidates_on_edits_and_rules_version(tmp_path,
                                                      monkeypatch):
    from cuvite_tpu_torch.analysis import cache as cache_mod

    tree = _mini_tree(tmp_path)
    cache = str(tmp_path / "cache.json")
    run_paths([str(tree)], cache=cache)
    (tree / "tools" / "a.py").write_text(SUPPRESSIBLE
                                         % "  # graftlint: disable=R007")
    assert "R007" not in rules_of(run_paths([str(tree)], cache=cache))
    with open(cache) as f:
        data = json.load(f)
    data["entries"][PKG + "b.py"]["findings"] = [{
        "rule": "R999", "severity": "high", "path": PKG + "b.py",
        "line": 1, "message": "planted", "snippet": ""}]
    with open(cache, "w") as f:
        json.dump(data, f)
    assert "R999" in rules_of(run_paths([str(tree)], cache=cache))
    monkeypatch.setattr(cache_mod, "rules_version", lambda: "other")
    assert "R999" not in rules_of(run_paths([str(tree)], cache=cache))


def test_cache_corruption_and_narrowed_rules_run_cold(tmp_path):
    tree = _mini_tree(tmp_path)
    cache = tmp_path / "cache.json"
    cache.write_text("{not json")
    cold = run_paths([str(tree)])
    assert run_paths([str(tree)], cache=str(cache)) == cold
    r007 = [r for r in all_rules() if r.id == "R007"]
    before = cache.read_text()
    assert rules_of(run_paths([str(tree)], rules=r007,
                              cache=str(cache))) == {"R007"}
    assert cache.read_text() == before


def test_default_cache_lives_under_build():
    from cuvite_tpu_torch.analysis.cache import DEFAULT_CACHE_REL

    assert DEFAULT_CACHE_REL.split(os.sep)[0] == "build"
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_stale_baseline_and_prune(tmp_path, capsys):
    tree = _mini_tree(tmp_path)
    bl = str(tmp_path / "bl.json")
    assert main([str(tree), "--baseline", bl, "--write-baseline"]) == 0
    capsys.readouterr()
    (tree / "tools" / "a.py").write_text("def ok():\n    return 2\n")
    assert main([str(tree), "--baseline", bl]) == 0
    assert "stale baseline slot" in capsys.readouterr().out
    assert main([str(tree), "--baseline", bl, "--prune-baseline"]) == 0
    assert "pruned 1 stale" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main([str(tree), "--baseline", bl, "--prune-baseline",
              "--no-project"])


def test_relpath_is_anchored_at_the_repo_root(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert engine._relpath(os.path.join(REPO, PKG, "cli.py")) == \
        PKG + "cli.py"
    sub = tmp_path / "deep" / "cuvite_tpu_torch" / "tools"
    sub.mkdir(parents=True)
    (sub / "a.py").write_text(SUPPRESSIBLE % "")
    assert rules_of(run_paths(["deep/cuvite_tpu_torch"])) == {"R007"}
    monkeypatch.chdir("/")
    assert rules_of(run_paths([str(sub / "a.py")])) == {"R007"}


# ---------------------------------------------------------------------------
# (d) The gate over the port's own tree.


@pytest.fixture(scope="module")
def port_findings():
    """One lint of the port's tree through the cache under build/ (a
    warm run re-parses only changed files)."""
    cache = os.path.join(REPO, "build", ".graftlint_cache.json")
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return run_paths(DEFAULT_PATHS, cache=cache)
    finally:
        os.chdir(cwd)


def test_the_port_passes_its_gate(port_findings):
    from cuvite_tpu_torch.analysis.engine import gate_failures

    baseline = load_baseline(os.path.join(REPO, DEFAULT_BASELINE))
    new, old = apply_baseline(port_findings, baseline)
    assert not gate_failures(new, "high"), \
        "\n".join(f.format() for f in gate_failures(new, "high"))
    assert not new, "\n".join(f.format() for f in new)
    assert not engine.stale_baseline_entries(port_findings, baseline)
    # every baselined finding is medium: the gate's rules hold outright
    assert {f.severity for f in old} <= {"medium"}


def test_the_port_tree_covers_every_default_path(port_findings):
    rels = engine.linted_rels([os.path.join(REPO, p)
                               for p in DEFAULT_PATHS])
    assert "chip_smoke.py" in rels and "kernel_ab.py" in rels
    assert PKG + "analysis/engine.py" in rels
    assert "tests/test_torch_analysis.py" in rels
    assert not any(r.startswith("cuvite_tpu/") for r in rels)
    assert not rules_of(port_findings) & {"E000"}


# One known-bad fixture for each project-tier rule, at module paths that
# the tier-1 fixtures above do not use: a device-path root
# (louvain/step.py), a phase-transition module (coarsen/), a mesh entry
# (louvain/loop.py::phase_loop) fed a flat mesh, and serve/ for R020.
# One known-bad fixture of each width rule, in torch idiom (R026 an int32
# arange past 2^31, R027 an untied int32 pack, R028 an int32 cast of a
# cumsum over an edge-slab extent).
WIDTH_BAD = {
    PKG + "ops/fake_width.py": """
import torch

def bad_width(src, nv_pad, ne_pad, kbits):
    a = torch.arange(ne_pad * nv_pad, dtype=torch.int32)
    key = (src.to(torch.int32) << kbits) | src.to(torch.int32)
    runs = torch.cumsum(src != 0, 0).int()
    return a, key, runs
""",
}

PROJECT_BAD = {
    PKG + "louvain/step.py": """
from cuvite_tpu_torch.fake_deep import deep_pull

def louvain_step_local(src, dst, w, comm, vdeg, consts):
    return deep_pull(comm)
""",
    PKG + "fake_deep.py": """
def deep_pull(comm):
    return comm.sum().item()
""",
    PKG + "coarsen/fake_phase.py": """
from cuvite_tpu_torch.utils.fake_pull import pull_stats

def phase_transition(slab):
    return pull_stats(slab)
""",
    PKG + "utils/fake_pull.py": """
def pull_stats(slab):
    return slab.cpu()
""",
    PKG + "louvain/loop.py": """
from cuvite_tpu_torch.fake_mesh_helper import tables

def phase_loop(comms, mesh, flag, nv_total):
    return tables(comms, mesh, flag, nv_total)
""",
    PKG + "fake_mesh_helper.py": """
import torch
from cuvite_tpu_torch.comm.collectives import all_gather, psum

def tables(comms, mesh, flag, nv_total):
    table = torch.zeros(nv_total, dtype=torch.float32)
    if flag.any():
        psum(comms, mesh)
    for view, pos in mesh.ici_views:
        all_gather([comms[p] for p in pos], view)  # graftlint: replicated-ok=scope=ici; group table
    return table
""",
    PKG + "fake_mesh_driver.py": """
from cuvite_tpu_torch.comm.mesh import make_mesh
from cuvite_tpu_torch.louvain import loop

def run(comms, flag):
    mesh = make_mesh(4)
    return loop.phase_loop(comms, mesh, flag, 1 << 20)
""",
    PKG + "serve/fake_a.py": LOCK_A,
    PKG + "serve/fake_b.py": LOCK_B,
}


def test_cli_gate_in_a_child_and_a_bad_copy_fails(tmp_path):
    """``python -m cuvite_tpu_torch.analysis`` exits 0 on the port's tree;
    on a copy of the analysis beside one known-bad fixture per per-file
    rule it exits 1 and names every one of those rules."""
    out = subprocess.run(
        [sys.executable, "-m", "cuvite_tpu_torch.analysis", "--cache",
         str(tmp_path / "c.json")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    assert "gate fail-on=high: ok" in out.stdout
    files = {rel: bad for _rid, bad, _good, rel in TORCH_CASES}
    for i, (ids, _ref, port) in enumerate(PARITY_CASES):
        for rel, text in port.items():
            if rel.endswith("/fake.py"):   # one file a case
                rel = rel.replace("/fake.py", f"/fake_{i}.py")
            files[rel] = text
    assert not set(files) & set(PROJECT_BAD)
    files.update(PROJECT_BAD)
    files.update(WIDTH_BAD)
    roots = _write_tree(tmp_path / "tree", files)
    out = subprocess.run(
        [sys.executable, "-m", "cuvite_tpu_torch.analysis", *roots,
         "--fail-on", "medium"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 1, out.stdout[-3000:]
    named = set(re.findall(r": (R\d{3}) \[", out.stdout))
    want = {c[0] for c in TORCH_CASES} | {i for c in PARITY_CASES
                                          for i in c[0]}
    want |= {"R017", "R018", "R020", "R023", "R024", "R025", "R026",
             "R027", "R028"}
    assert want == {r.id for r in all_rules()}
    assert want <= named, sorted(want - named)


def test_the_analysis_imports_no_jax_and_no_reference():
    pkg = os.path.join(REPO, "cuvite_tpu_torch", "analysis")
    bad = re.compile(r"^\s*(import|from)\s+(jax|cuvite_tpu)(\s|\.|$)", re.M)
    for name in sorted(os.listdir(pkg)):
        if name.endswith(".py"):
            with open(os.path.join(pkg, name)) as f:
                assert not bad.search(f.read()), name
    code = ("import sys; import cuvite_tpu_torch.analysis.__main__; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'torch', 'numpy', 'cuvite_tpu')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_the_scheduler_refusal_names_a9_step_4():
    # A9 step 4 is ported: activated() installs a Scheduler, and the one
    # refusal left is a second scheduler while one is active.
    from cuvite_tpu_torch.serve import sync

    sched = sync.Scheduler(seed=0)
    with sync.activated(sched):
        assert sync.active_scheduler() is sched
        with pytest.raises(RuntimeError, match="already active"):
            with sync.activated(sync.Scheduler(seed=1)):
                pass
    assert sync.active_scheduler() is None
