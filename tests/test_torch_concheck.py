"""The port's cooperative Scheduler (``cuvite_tpu_torch/serve/sync.py``) and
concheck (``cuvite_tpu_torch/analysis/concheck.py``), held against the
reference's (``cuvite_tpu/serve/sync.py``, ``cuvite_tpu/analysis/
concheck.py``).

- the factories return the plain ``threading`` objects outside
  ``activated``;
- the vector-clock cases of ``tests/test_concheck.py`` run on both
  Schedulers with the same seeds: the same verdicts, the same final
  values and the same schedule signatures;
- a ``(strategy, seed)`` replays its schedule;
- the port's daemon explores clean across 200 interleavings (the plain,
  pipelined and delta-vs-drain scenarios), the known-bug fixtures are
  convicted at the reference's budgets and replay;
- the inventory is the port's 37 declared ``guarded-by`` fields plus the
  inferred ones; dynamic results never enter the lint cache.
"""

import os
import subprocess
import sys
import threading

import pytest

from cuvite_tpu.analysis import concheck as ref_concheck
from cuvite_tpu.serve import sync as ref_sync
from cuvite_tpu_torch.analysis import concheck
from cuvite_tpu_torch.serve import sync

from test_torch_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One serve_inventory() parse shared by every dynamic test of the file.
INVENTORY = concheck.serve_inventory()


def scenario(name: str) -> concheck.DaemonScenario:
    s = concheck.builtin_scenarios()[name][0]()
    s.inventory = INVENTORY
    return s


# ---------------------------------------------------------------------------
# The production factories stay plain


def test_factories_outside_activated_are_plain_threading():
    assert sync.active_scheduler() is None
    assert type(sync.Lock()) is type(threading.Lock())
    assert type(sync.RLock()) is type(threading.RLock())
    assert type(sync.Event()) is threading.Event
    assert type(sync.Condition()) is threading.Condition
    t = sync.Thread(target=lambda: None)
    assert type(t) is threading.Thread and t.daemon


def test_factories_inside_activated_are_the_scheduler_twins():
    sched = sync.Scheduler(seed=0)
    with sync.activated(sched):
        assert sync.active_scheduler() is sched
        assert isinstance(sync.Lock(), sync._SchedLock)
        assert isinstance(sync.Event(), sync._SchedEvent)
        assert isinstance(sync.Condition(), sync._SchedCondition)
        assert isinstance(sync.Thread(target=lambda: None),
                          sync._SchedThread)
    assert sync.active_scheduler() is None
    with pytest.raises(ValueError, match="unknown strategy"):
        sync.Scheduler(strategy="bfs")


# ---------------------------------------------------------------------------
# Vector-clock cases on both Schedulers (tests/test_concheck.py:310-372)


def _two_thread_run(pkg, body1, body2, *, seed=0):
    cc, sy = pkg
    det = cc.RaceDetector()
    sched = sy.Scheduler(seed=seed, strategy="random", detector=det)

    class Shared:
        def __init__(self):
            self.lock = sy.Lock()
            self.other_lock = sy.Lock()
            self.ev = sy.Event()
            self.x = 0

    with sy.activated(sched):
        obj = Shared()
        obj.lock.name = "Shared.lock"
        cc.instrument(sched, [obj], [
            {"class": "Shared", "owner": "self", "field": "x",
             "locks": ["self.lock"], "declared": False}])
        sched.spawn(body1, name="w1", args=(obj,))
        sched.spawn(body2, name="w2", args=(obj,))
    sched.run()
    return sched, det, obj


def _locked(obj):
    with obj.lock:
        obj.x += 1


def _unlocked(obj):
    obj.x += 1


def _other_locked(obj):
    with obj.other_lock:
        obj.x += 1


def _producer(obj):
    obj.x = 41
    obj.ev.set()


def _consumer(obj):
    if obj.ev.wait(timeout=10.0):
        obj.x += 1


# (case, body1, body2, want a race in every schedule, want final x)
VC_CASES = [
    ("locked-increments", _locked, _locked, False, 2),
    ("unlocked-write-write", _unlocked, _unlocked, True, None),
    ("event-orders-handoff", _producer, _consumer, False, 42),
    ("mixed-locks", _locked, _other_locked, True, None),
]


@pytest.mark.parametrize("case,b1,b2,race,x", VC_CASES,
                         ids=[c[0] for c in VC_CASES])
def test_vc_cases_give_the_reference_verdicts(case, b1, b2, race, x):
    for seed in range(6):
        got = {}
        for name, pkg in (("ref", (ref_concheck, ref_sync)),
                          ("port", (concheck, sync))):
            sched, det, obj = _two_thread_run(pkg, b1, b2, seed=seed)
            assert not sched.failures, (name, sched.failures)
            got[name] = (bool(det.races), obj.x, sched.signature(),
                         sched.steps)
        assert got["port"] == got["ref"], (case, seed, got)
        assert got["port"][0] is race, (case, seed)
        if x is not None:
            assert got["port"][1] == x


def test_vc_event_clear_resets_the_hb_edge_on_both():
    """After clear(), a wait released by a later set joins only that
    setter's clock: A's write stays unordered with C's read."""
    for name, (cc, sy) in (("ref", (ref_concheck, ref_sync)),
                           ("port", (concheck, sync))):
        det = cc.RaceDetector()
        sched = sy.Scheduler(seed=0, strategy="random", detector=det)

        class Shared:
            def __init__(self):
                self.lock = sy.Lock()
                self.ev = sy.Event()
                self.x = 0

        def a(obj):
            obj.x = 1
            obj.ev.set()

        def b(obj, sched=sched):
            sched.sleep(1.0)
            obj.ev.clear()
            sched.sleep(1.0)
            obj.ev.set()

        def c(obj, sched=sched):
            sched.sleep(3.0)
            if obj.ev.wait(timeout=10.0):
                _ = obj.x

        with sy.activated(sched):
            obj = Shared()
            cc.instrument(sched, [obj], [
                {"class": "Shared", "owner": "self", "field": "x",
                 "locks": [], "declared": False}])
            for fn, tn in ((a, "a"), (b, "b"), (c, "c")):
                sched.spawn(fn, name=tn, args=(obj,))
        sched.run()
        assert det.races, name


def test_deadlock_is_reported_and_aborted_on_both():
    for name, sy in (("ref", ref_sync), ("port", sync)):
        sched = sy.Scheduler(seed=1)
        with sy.activated(sched):
            la, lb = sy.Lock(name="A"), sy.Lock(name="B")
            go = sy.Event()

            def one(x=la, y=lb, go=go):
                with x:
                    go.wait()
                    with y:
                        pass

            def two(x=la, y=lb, go=go):
                with y:
                    go.set()
                    with x:
                        pass

            sched.spawn(one, name="one")
            sched.spawn(two, name="two")
        sched.run()
        kinds = [f["kind"] for f in sched.failures]
        assert "deadlock" in kinds, (name, kinds)


# ---------------------------------------------------------------------------
# Inventory, replay, known bugs, clean scenarios


def test_inventory_is_the_ports_lockset_summary():
    fields = {(e["class"], e["field"]) for e in INVENTORY}
    assert ("ServeDaemon", "_routes") in fields
    assert ("ServeStats", "jobs_done") in fields
    declared = [e for e in INVENTORY if e["declared"]]
    assert len(declared) >= 37, len(declared)
    routes = [e for e in INVENTORY
              if (e["class"], e["field"]) == ("ServeDaemon", "_routes")]
    assert routes and routes[0]["locks"] == ["self.lock"]


def test_routes_race_detected_and_replays():
    rep = concheck.explore(scenario("racy-routes"), budget=32, seed=0,
                           stop_on_failure=True)
    assert not rep.clean, "the resurrected _routes race went undetected"
    race = next(r for r in rep.races()
                if r["field"] == "ServeDaemon._routes")
    for side in ("first", "second"):
        assert any("daemon.py" in fr[0] for fr in race[side]["stack"]), \
            race[side]
    failing = rep.failing[0]
    replay = concheck.run_schedule(scenario("racy-routes"),
                                   seed=failing.seed,
                                   strategy=failing.strategy)
    assert any(r["field"] == "ServeDaemon._routes" for r in replay.races)
    assert replay.signature == failing.signature
    # the shipped daemon is clean on the convicting seed
    clean = concheck.run_schedule(scenario("clean"), seed=failing.seed,
                                  strategy=failing.strategy)
    assert clean.clean, (clean.failures, clean.races)


def test_send_under_lock_is_convicted():
    rep = concheck.explore(scenario("send-under-lock"), budget=16, seed=0,
                           stop_on_failure=True)
    assert not rep.clean
    msg = next(f for f in rep.failures()
               if f["kind"] == "lock-across-send")["message"]
    assert "ServeDaemon.lock" in msg


@pytest.mark.parametrize("name,seed", [("clean", 7),
                                       ("pipeline-clean", 17),
                                       ("delta-vs-drain", 29)])
def test_clean_scenarios_across_200_interleavings(name, seed):
    budget = max(concheck.schedule_budget(), 200)
    rep = concheck.explore(scenario(name), budget=budget, seed=seed)
    assert rep.clean, (rep.failures()[:3], rep.races()[:3])
    assert rep.schedules == budget
    assert rep.distinct >= 200, rep.distinct
    assert not rep.warnings, rep.warnings


@pytest.mark.parametrize("name", ["faulty-clean", "drain-vs-retry",
                                  "pipeline-faulty",
                                  "drain-vs-inflight-pack",
                                  "merge-pack-clean"])
def test_other_clean_scenarios_explore_clean(name):
    scen = scenario(name)
    rep = concheck.explore(scen, budget=24, seed=23)
    assert rep.clean, (rep.failures()[:3], rep.races()[:3])
    if name == "merge-pack-clean":
        assert scen.merged_batches_seen > 0, "no merged batch explored"


def test_drain_races_retry_backoff_in_some_schedule():
    scen = scenario("drain-vs-retry")
    hits = 0
    for i in range(24):
        rep = concheck.run_schedule(scen, seed=900 + i,
                                    strategy=("random", "pct")[i % 2])
        assert rep.clean, (rep.seed, rep.failures, rep.races)
        sleep_at = drain_at = None
        for step, (tname, op, detail) in enumerate(rep.trace):
            if tname == "dispatch" and op == "sleep" and sleep_at is None:
                sleep_at = step
            if tname == "drainer" and op == "set" and "drain_req" in detail:
                drain_at = step
        hits += (sleep_at is not None and drain_at is not None
                 and drain_at > sleep_at)
    assert hits >= 1


def test_drain_lands_inside_an_inflight_pack_in_some_schedule():
    """drain-vs-inflight-pack targets what it claims: some schedule sets
    the drain request between the packer's in-pack sleep and its handoff
    acquisition, and every schedule still delivers exactly once."""
    scen = scenario("drain-vs-inflight-pack")
    hits = 0
    for i in range(24):
        rep = concheck.run_schedule(scen, seed=700 + i,
                                    strategy=("random", "pct")[i % 2])
        assert rep.clean, (rep.seed, rep.failures, rep.races)
        sleep_at = handoff_at = drain_at = None
        for step, (tname, op, detail) in enumerate(rep.trace):
            if tname == "packer" and op == "sleep" and sleep_at is None:
                sleep_at = step
            if tname == "packer" and op == "acquire" \
                    and detail == "Handoff.lock" and sleep_at is not None \
                    and handoff_at is None:
                handoff_at = step
            if tname == "drainer" and op == "set" and "drain_req" in detail:
                drain_at = step
        hits += (None not in (sleep_at, handoff_at, drain_at)
                 and sleep_at < drain_at < handoff_at)
    assert hits >= 1


def test_conservation_check_has_teeth():
    scen = scenario("clean")
    det = concheck.RaceDetector()
    sched = sync.Scheduler(seed=3, strategy="random", detector=det)
    with sync.activated(sched):
        ctx = scen.setup(sched)
    sched.run()
    scen.check(sched, ctx)
    assert not sched.failures
    with ctx["server"].stats.lock:
        ctx["server"].stats.jobs_done += 1
    scen.check(sched, ctx)
    assert any(f["kind"] == "conservation" for f in sched.failures)


def test_the_same_seed_gives_the_same_daemon_schedule():
    a = concheck.run_schedule(scenario("pipeline-clean"), seed=5,
                              strategy="pct")
    b = concheck.run_schedule(scenario("pipeline-clean"), seed=5,
                              strategy="pct")
    assert a.signature == b.signature and a.trace == b.trace
    c = concheck.run_schedule(scenario("pipeline-clean"), seed=6,
                              strategy="pct")
    assert c.signature != a.signature


def test_schedule_budget_knob(monkeypatch):
    monkeypatch.setenv("CUVITE_SCHED_BUDGET", "12")
    assert concheck.schedule_budget() == 12
    monkeypatch.setenv("CUVITE_SCHED_BUDGET", "0")
    with pytest.warns(UserWarning):
        assert concheck.schedule_budget() == concheck.DEFAULT_BUDGET


def test_dynamic_exploration_never_touches_the_cache(tmp_path):
    from cuvite_tpu_torch.analysis.engine import run_paths

    cache = tmp_path / "cache.json"
    src = tmp_path / "m.py"
    src.write_text("x = 1\n")
    run_paths([str(src)], cache=str(cache))
    before = cache.read_bytes()
    concheck.explore(scenario("clean"), budget=2, seed=0)
    assert cache.read_bytes() == before


def test_main_list_replay_and_json(capsys):
    assert concheck.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "racy-routes" in out and "expect=detect" in out
    rep = concheck.explore(scenario("racy-routes"), budget=32, seed=0,
                           stop_on_failure=True)
    f = rep.failing[0]
    assert concheck.main(["--scenario", "racy-routes", "--replay",
                          f"{f.strategy}:{f.seed}"]) == 1
    assert concheck.main(["--scenario", "clean", "--replay",
                          f"{f.strategy}:{f.seed}"]) == 0
    capsys.readouterr()
    assert concheck.main(["--scenario", "send-under-lock", "--budget",
                          "4", "--format", "json"]) == 0
    assert '"ok": true' in capsys.readouterr().out


@pytest.mark.slow
def test_concheck_cli_subprocess_smoke():
    out = subprocess.run(
        [sys.executable, "-m", "cuvite_tpu_torch.analysis.concheck",
         "--budget", "3", "--seed", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "concheck: ok" in out.stdout
