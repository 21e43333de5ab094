"""The synchronization seam of ``serve/`` (port of
``cuvite_tpu/serve/sync.py``): plain threading in production, checkable
under a deterministic cooperative scheduler (``analysis/concheck.py``).

Every lock, event, condition and thread the serving layer creates comes
from the factories below.  Outside an activated :class:`Scheduler` they
return the plain ``threading`` primitives: nothing is wrapped and an
acquire costs nothing extra.  Inside ``with activated(sched): ...`` they
return scheduler-backed twins, and the daemon's threads run under a
cooperative, serialized, seeded schedule:

  * exactly one managed thread runs at a time; control changes hands
    only at schedule points -- lock acquire/release, event
    set/clear/wait/is_set, condition wait/notify, thread start/join,
    sleeps on the injectable clock, and the shared-field accesses the
    concheck instrumentation reports;
  * the next thread is picked by a seeded strategy -- a uniform random
    walk, or PCT-style bounded-preemption priorities (Burckhardt et al.,
    ASPLOS'10) -- so every failing schedule replays from its
    ``(strategy, seed)`` pair alone;
  * time is virtual: ``Scheduler.clock``/``Scheduler.sleep`` plug into
    the serving layer's clock seam (``serve/clock.py``); timed waits park
    a thread until its wake condition or a virtual deadline, and when no
    thread can run the scheduler advances ``now`` to the earliest
    deadline, so a drain with retry backoff sleeps no real second;
  * each managed thread carries a vector clock, with happens-before
    edges from lock release to acquire, event set to an observed wait,
    condition notify to wakeup, and thread start/join: the order the
    race detector (``analysis/concheck.py``) judges accesses by;
  * no runnable thread and no pending timeout is a deadlock: it is
    recorded with every blocked thread's wait reason and stack, and the
    schedule is aborted (threads unwind by a BaseException, so the
    daemon's ``except Exception`` handlers cannot swallow the teardown).

The scheduler hands the baton over with real ``threading`` primitives
(one Event per managed thread and one coordinator Condition); nothing
here reads the wall clock and nothing sleeps.
"""

from __future__ import annotations

import random
import sys
import threading as _threading
import traceback

# The active scheduler.  Factories consult it at CONSTRUCTION time, so
# objects built inside ``with activated(sched)`` are scheduler-backed
# and everything built outside (production) is plain threading.
_ACTIVE: "Scheduler | None" = None


class activated:
    """Context manager installing ``sched`` as the active scheduler for
    primitive construction (and clearing it on exit, exception-safe)."""

    def __init__(self, sched: "Scheduler"):
        self.sched = sched

    def __enter__(self) -> "Scheduler":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a Scheduler is already active")
        _ACTIVE = self.sched
        return self.sched

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None


def active_scheduler() -> "Scheduler | None":
    return _ACTIVE


def Lock(name: str | None = None):
    """A mutex: ``threading.Lock`` in production, a scheduler-backed
    twin under an activated checker."""
    if _ACTIVE is None:
        return _threading.Lock()
    return _SchedLock(_ACTIVE, name=name, reentrant=False)


def RLock(name: str | None = None):
    if _ACTIVE is None:
        return _threading.RLock()
    return _SchedLock(_ACTIVE, name=name, reentrant=True)


def Event(name: str | None = None):
    if _ACTIVE is None:
        return _threading.Event()
    return _SchedEvent(_ACTIVE, name=name)


def Condition(lock=None, name: str | None = None):
    if _ACTIVE is None:
        return _threading.Condition(lock)
    return _SchedCondition(_ACTIVE, lock, name=name)


def Thread(*, target, name: str | None = None, args=(), kwargs=None,
           daemon: bool = True):
    """A thread handle: real ``threading.Thread`` in production, a
    scheduler-managed thread under the checker (``start()`` registers
    it; it runs only when the schedule hands it the baton)."""
    if _ACTIVE is None:
        return _threading.Thread(target=target, name=name, args=args,
                                 kwargs=kwargs or {}, daemon=daemon)
    return _ACTIVE.thread(target=target, name=name, args=args,
                          kwargs=kwargs or {})


class SchedulerAbort(BaseException):
    """Unwinds a managed thread when the schedule is torn down
    (deadlock, step budget, explicit abort).  BaseException on purpose:
    daemon code's ``except Exception`` isolation boundaries must not
    swallow the teardown."""


_NEW, _READY, _RUNNING, _BLOCKED, _DONE = (
    "new", "ready", "running", "blocked", "done")


def _vc_join(dst: dict, src: dict) -> None:
    # In-place join IS the contract: dst is the thread's own vector
    # clock (a dict, not a shared buffer — R005's aliased-array hazard
    # does not apply).
    for k, v in src.items():
        if dst.get(k, 0) < v:
            dst[k] = v  # graftlint: disable=R005


class _SchedThread:
    """One managed thread: a real OS thread gated by a personal baton
    event; carries the vector clock and the held-lock list."""

    def __init__(self, sched: "Scheduler", target, name, args, kwargs):
        self.sched = sched
        self.target = target
        self.args = args
        self.kwargs = kwargs
        self.idx = len(sched.threads)
        self.name = name or f"t{self.idx}"
        self.vc: dict = {self.idx: 1}
        self.state = _NEW
        self.turn = _threading.Event()
        self.locks: list = []          # acquisition order, one per hold
        self.wait_reason: tuple | None = None
        self.deadline: float | None = None
        self.timed_out = False
        self.abort = False
        self.pending_op: tuple = ("start", "")
        self.os_thread = _threading.Thread(
            target=self._run, name=f"sched-{self.name}", daemon=True)
        sched.threads.append(self)

    # threading.Thread API surface the daemon uses --------------------------

    def start(self) -> None:
        if self.state != _NEW:
            raise RuntimeError(f"thread {self.name} started twice")
        self.state = _READY
        self.os_thread.start()

    def is_alive(self) -> bool:
        return self.state not in (_NEW, _DONE)

    def join(self, timeout: float | None = None) -> None:
        self.sched.thread_join(self, timeout)

    def tick(self) -> None:
        self.vc[self.idx] = self.vc.get(self.idx, 0) + 1

    def _run(self) -> None:
        s = self.sched
        s.register_ident(self)
        self.turn.wait()
        self.turn.clear()
        try:
            if not self.abort:
                self.target(*self.args, **self.kwargs)
        except SchedulerAbort:
            pass
        except BaseException as e:  # noqa: BLE001 — schedule failure report
            s.record_failure(
                "thread-exception",
                f"thread {self.name!r} died: {e!r}",
                stack=traceback.format_exc(limit=16))
        finally:
            s.thread_finished(self)


class _SchedLock:
    """Scheduler-backed Lock/RLock.  Mutual exclusion is modeled (only
    one thread runs anyway); the point is the blocking semantics, the
    happens-before edges, and the schedule points."""

    def __init__(self, sched: "Scheduler", *, name: str | None,
                 reentrant: bool):
        self.sched = sched
        self.name = name or f"lock-{sched.next_obj_id()}"
        self.reentrant = reentrant
        self.owner: _SchedThread | None = None
        self.count = 0
        self.vc: dict = {}

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self.sched.lock_acquire(self, blocking=blocking,
                                       timeout=timeout)

    def release(self) -> None:
        self.sched.lock_release(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _SchedEvent:
    def __init__(self, sched: "Scheduler", *, name: str | None):
        self.sched = sched
        self.name = name or f"event-{sched.next_obj_id()}"
        self.flag = False
        self.vc: dict = {}

    def is_set(self) -> bool:
        return self.sched.event_is_set(self)

    def set(self) -> None:
        self.sched.event_set(self)

    def clear(self) -> None:
        self.sched.event_clear(self)

    def wait(self, timeout: float | None = None) -> bool:
        return self.sched.event_wait(self, timeout)


class _SchedCondition:
    """Condition variable over a (scheduler-backed) lock: the pipelined
    dispatcher's handoff slot (``serve/pipeline.py::Handoff``) waits on
    one."""

    def __init__(self, sched: "Scheduler", lock, *, name: str | None):
        self.sched = sched
        self.lock = lock if lock is not None else _SchedLock(
            sched, name=None, reentrant=True)
        self.name = name or f"cond-{sched.next_obj_id()}"
        self.vc: dict = {}
        self.waiting: list = []

    def __enter__(self):
        self.lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.lock.release()

    def wait(self, timeout: float | None = None) -> bool:
        return self.sched.cond_wait(self, timeout)

    def notify(self, n: int = 1) -> None:
        self.sched.cond_notify(self, n)

    def notify_all(self) -> None:
        self.sched.cond_notify(self, len(self.waiting) or 1)


# ---------------------------------------------------------------------------
# Strategies


class RandomWalkStrategy:
    """Uniform seeded choice among runnable threads at every schedule
    point — the breadth workhorse: cheap, unbiased, and every run is a
    distinct sample of the interleaving space."""

    name = "random"

    def __init__(self, seed: int):
        # Seed via a STRING: str seeding is hash-randomization-free, so
        # a failing schedule's seed replays identically across
        # processes (tuples would hash per-process).
        self.rng = random.Random(f"random-walk:{seed}")

    def pick(self, ready: list, step: int):
        return ready[self.rng.randrange(len(ready))]


class PCTStrategy:
    """PCT-style bounded-preemption priorities: each thread gets a
    random priority at registration; the highest-priority runnable
    thread runs until one of ``depth - 1`` pre-sampled change points,
    where the current leader is demoted below everyone.  Finds bugs of
    preemption depth < ``depth`` with known probability — the
    depth-first complement to the random walk."""

    name = "pct"

    def __init__(self, seed: int, depth: int = 3,
                 est_steps: int = 2000):
        self.rng = random.Random(f"pct:{seed}")
        self.depth = depth
        self.change_points = sorted(
            self.rng.randrange(1, est_steps) for _ in range(depth - 1))
        self.prio: dict = {}
        self._next_low = 0.0

    def _priority(self, t) -> float:
        if t.idx not in self.prio:
            self.prio[t.idx] = self.rng.random() + 1.0
        return self.prio[t.idx]

    def pick(self, ready: list, step: int):
        top = max(ready, key=self._priority)
        if self.change_points and step >= self.change_points[0]:
            self.change_points.pop(0)
            self._next_low -= 1.0
            self.prio[top.idx] = self._next_low   # demote below everyone
            top = max(ready, key=self._priority)
        return top


STRATEGIES = {"random": RandomWalkStrategy, "pct": PCTStrategy}


# ---------------------------------------------------------------------------
# The scheduler


class Scheduler:
    """Deterministic cooperative scheduler (see module docstring).

    ``detector`` is duck-typed (analysis/concheck.py's RaceDetector):
    ``record(key, kind, thread, held_lock_names, declared)`` is called
    at every annotated shared-field access; serve/ itself never imports
    the analysis package.
    """

    def __init__(self, *, seed: int = 0, strategy: str = "random",
                 max_steps: int = 50000, now: float = 1000.0,
                 detector=None, pct_depth: int = 3):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; "
                             f"use one of {sorted(STRATEGIES)}")
        self.seed = seed
        self.strategy_name = strategy
        self.strategy = (PCTStrategy(seed, depth=pct_depth)
                         if strategy == "pct"
                         else RandomWalkStrategy(seed))
        self.max_steps = max_steps
        self.now = now
        self.detector = detector
        self.threads: list = []
        self.failures: list = []
        self.trace: list = []          # (thread name, op, detail)
        self.steps = 0
        self.running = False
        self.aborting = False
        self._mon = _threading.Condition()
        self._by_ident: dict = {}
        self._obj_ids = 0

    # -- plumbing -----------------------------------------------------------

    def next_obj_id(self) -> int:
        self._obj_ids += 1
        return self._obj_ids

    def register_ident(self, t: _SchedThread) -> None:
        self._by_ident[_threading.get_ident()] = t

    def current(self) -> _SchedThread | None:
        return self._by_ident.get(_threading.get_ident())

    def thread(self, *, target, name=None, args=(), kwargs=None):
        return _SchedThread(self, target, name, args, kwargs or {})

    def spawn(self, target, *, name=None, args=()) -> _SchedThread:
        t = self.thread(target=target, name=name, args=args)
        t.start()
        return t

    # The serve-layer injectable clock/sleep pair.
    def clock(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        t = self.current()
        if t is None or not self.running:
            return                      # unmanaged caller: virtual no-op
        self._yield(t, ("sleep", f"{seconds:.6f}"))
        if seconds > 0:
            self._park(t, ("sleep", None), self.now + seconds)

    def held_lock_names(self) -> list:
        t = self.current()
        if t is None:
            return []
        return [lk.name for lk in t.locks]

    def record_failure(self, kind: str, message: str, *,
                       stack: str | None = None) -> None:
        self.failures.append({
            "kind": kind, "message": message, "step": self.steps,
            "stack": stack,
        })

    def signature(self) -> int:
        """Stable hash of the explored interleaving (choice sequence):
        two runs with the same signature explored the same schedule."""
        import zlib

        payload = "\x1e".join(
            f"{name}\x1f{op}\x1f{detail}" for name, op, detail in self.trace)
        return zlib.crc32(payload.encode())

    # -- thread-side transitions -------------------------------------------

    def _yield(self, t: _SchedThread, op: tuple) -> None:
        """Give the baton back; returns when the strategy re-picks this
        thread.  EVERY schedule point funnels through here."""
        if t.abort:
            raise SchedulerAbort()
        t.pending_op = op
        with self._mon:
            t.state = _READY
            self._mon.notify_all()
        t.turn.wait()
        t.turn.clear()
        if t.abort:
            raise SchedulerAbort()

    def _park(self, t: _SchedThread, reason: tuple,
              deadline: float | None = None) -> bool:
        """Block until another thread (or a virtual timeout) makes this
        thread runnable again and the strategy schedules it; True when
        the wake came from the virtual deadline firing."""
        if t.abort:
            raise SchedulerAbort()
        with self._mon:
            t.state = _BLOCKED
            t.wait_reason = reason
            t.deadline = deadline
            self._mon.notify_all()
        t.turn.wait()
        t.turn.clear()
        t.wait_reason = None
        t.deadline = None
        fired = t.timed_out
        t.timed_out = False
        if t.abort:
            raise SchedulerAbort()
        return fired

    def _wake(self, pred) -> None:
        """Mark blocked threads matching ``pred`` runnable (they still
        run only when scheduled)."""
        for w in self.threads:
            if w.state == _BLOCKED and w.wait_reason is not None \
                    and pred(w):
                w.timed_out = False
                w.state = _READY

    def thread_finished(self, t: _SchedThread) -> None:
        # A thread dying while holding locks would wedge every waiter:
        # force-release (and report — an orderly thread never does this).
        with self._mon:
            for lk in list(t.locks):
                if not self.aborting:
                    self.record_failure(
                        "lock-leak",
                        f"thread {t.name!r} exited holding {lk.name}")
                lk.count = 0
                lk.owner = None
                lk.vc = dict(t.vc)
                self._wake(lambda w, lk=lk: w.wait_reason == ("lock", lk))
            t.locks.clear()
            t.state = _DONE
            self._wake(lambda w: w.wait_reason == ("join", t))
            self._mon.notify_all()

    # -- primitive semantics ------------------------------------------------

    def lock_acquire(self, lk: _SchedLock, *, blocking: bool = True,
                     timeout: float = -1) -> bool:
        t = self.current()
        if t is None or not self.running:
            return True                 # unmanaged caller (post-run asserts)
        self._yield(t, ("acquire", lk.name))
        deadline = (self.now + timeout
                    if blocking and timeout is not None and timeout >= 0
                    else None)
        while True:
            if lk.owner is None or (lk.reentrant and lk.owner is t):
                break
            if not blocking:
                return False
            if deadline is not None and self.now >= deadline:
                return False
            fired = self._park(t, ("lock", lk), deadline)
            if fired and lk.owner is not None \
                    and not (lk.reentrant and lk.owner is t):
                return False            # timed acquire expired (virtual)
        if lk.owner is None:
            lk.owner = t
            _vc_join(t.vc, lk.vc)       # HB: last release -> this acquire
        lk.count += 1
        t.locks.append(lk)
        return True

    def lock_release(self, lk: _SchedLock) -> None:
        t = self.current()
        if t is None or not self.running:
            return
        if lk.owner is not t:
            self.record_failure(
                "bad-release",
                f"thread {t.name!r} released {lk.name} it does not hold")
            return
        lk.count -= 1
        if lk in t.locks:
            t.locks.remove(lk)
        if lk.count == 0:
            lk.vc = dict(t.vc)          # publish for the next acquirer
            t.tick()
            lk.owner = None
            with self._mon:
                self._wake(lambda w: w.wait_reason == ("lock", lk))
        self._yield(t, ("release", lk.name))

    def event_set(self, ev: _SchedEvent) -> None:
        t = self.current()
        if t is None or not self.running:
            ev.flag = True
            return
        ev.flag = True
        _vc_join(ev.vc, t.vc)           # HB: set -> observed wait
        t.tick()
        with self._mon:
            self._wake(lambda w: w.wait_reason == ("event", ev))
        self._yield(t, ("set", ev.name))

    def event_clear(self, ev: _SchedEvent) -> None:
        t = self.current()
        ev.flag = False
        # Reset the event's clock: a wait that returns True after this
        # point was released by a LATER set, and must join only that
        # setter — keeping old setters' clocks would fabricate
        # happens-before edges and mask real races.
        ev.vc = {}
        if t is not None and self.running:
            self._yield(t, ("clear", ev.name))

    def event_is_set(self, ev: _SchedEvent) -> bool:
        t = self.current()
        if t is not None and self.running:
            self._yield(t, ("is_set", ev.name))
            if ev.flag:
                _vc_join(t.vc, ev.vc)   # an observed set is synchronization
        return ev.flag

    def event_wait(self, ev: _SchedEvent, timeout: float | None) -> bool:
        t = self.current()
        if t is None or not self.running:
            return ev.flag
        self._yield(t, ("wait", ev.name))
        deadline = None if timeout is None else self.now + timeout
        while not ev.flag:
            if deadline is not None and self.now >= deadline:
                return False
            fired = self._park(t, ("event", ev), deadline)
            if fired and not ev.flag:
                return False
        _vc_join(t.vc, ev.vc)
        return True

    def cond_wait(self, cond: _SchedCondition, timeout: float | None) -> bool:
        t = self.current()
        if t is None or not self.running:
            return True
        lk = cond.lock
        if lk.owner is not t:
            self.record_failure(
                "bad-wait",
                f"thread {t.name!r} waits on {cond.name} without "
                f"holding {lk.name}")
            return False
        held = lk.count                 # full release, RLock-style
        lk.count = 0
        lk.vc = dict(t.vc)
        t.tick()
        lk.owner = None
        for _ in range(held):
            if lk in t.locks:
                t.locks.remove(lk)
        cond.waiting.append(t)
        with self._mon:
            self._wake(lambda w: w.wait_reason == ("lock", lk))
        deadline = None if timeout is None else self.now + timeout
        notified = not self._park(t, ("cond", cond), deadline)
        if t in cond.waiting:
            cond.waiting.remove(t)
        if notified:
            _vc_join(t.vc, cond.vc)
        # reacquire at the original depth
        self.lock_acquire(lk)
        for _ in range(held - 1):
            lk.count += 1
            t.locks.append(lk)
        return notified

    def cond_notify(self, cond: _SchedCondition, n: int) -> None:
        t = self.current()
        if t is None or not self.running:
            return
        _vc_join(cond.vc, t.vc)
        t.tick()
        woken = cond.waiting[:n]
        del cond.waiting[:n]
        with self._mon:
            self._wake(lambda w: w in woken)
        self._yield(t, ("notify", cond.name))

    def thread_join(self, target: _SchedThread,
                    timeout: float | None) -> None:
        t = self.current()
        if t is None or not self.running:
            return
        self._yield(t, ("join", target.name))
        deadline = None if timeout is None else self.now + timeout
        while target.state != _DONE:
            if deadline is not None and self.now >= deadline:
                return
            fired = self._park(t, ("join", target), deadline)
            if fired and target.state != _DONE:
                return
        _vc_join(t.vc, target.vc)       # HB: child's whole life -> joiner

    # -- annotated shared-field accesses (concheck instrumentation) --------

    def access(self, key: str, kind: str, declared=None) -> None:
        """One annotated access to shared field ``key`` (``kind`` is
        'read' or 'write').  A schedule point AND a race-detector
        sample; no-op from unmanaged threads (construction, post-run
        assertions)."""
        t = self.current()
        if t is None or not self.running:
            return
        self._yield(t, (kind, key))
        if self.detector is not None:
            held = tuple(lk.name for lk in t.locks)
            self.detector.record(key, kind, t, held, declared)

    # -- the coordinator ----------------------------------------------------

    def run(self) -> None:
        """Drive the schedule to completion on the calling (unmanaged)
        thread: repeatedly pick a runnable thread, hand it the baton,
        wait for it to yield/block/finish."""
        self.running = True
        try:
            self._loop()
        finally:
            self.running = False

    def _loop(self) -> None:
        while True:
            abort_these = None
            pick = None
            with self._mon:
                while any(t.state == _RUNNING for t in self.threads):
                    self._mon.wait()
                live = [t for t in self.threads if t.state != _DONE
                        and t.state != _NEW]
                if not live:
                    return
                ready = [t for t in live if t.state == _READY]
                if not ready:
                    timed = [t for t in live
                             if t.state == _BLOCKED
                             and t.deadline is not None]
                    if timed:
                        # Virtual time advances only when nothing else
                        # can run — timeouts fire as late as possible,
                        # maximizing the schedules where real work
                        # preempts them.
                        fire = min(t.deadline for t in timed)
                        self.now = max(self.now, fire)
                        for t in timed:
                            if t.deadline <= self.now:
                                t.timed_out = True
                                t.state = _READY
                        continue
                    self._report_deadlock(live)
                    abort_these = live
                else:
                    self.steps += 1
                    if self.steps > self.max_steps:
                        self.record_failure(
                            "step-budget",
                            f"schedule exceeded {self.max_steps} steps "
                            "(livelock?)")
                        abort_these = live
                    else:
                        pick = self.strategy.pick(ready, self.steps)
                        self.trace.append((pick.name, *pick.pending_op))
                        pick.state = _RUNNING
            # The monitor must be RELEASED here: aborted threads need it
            # to report thread_finished, and the picked thread needs it
            # at its next yield.
            if abort_these is not None:
                self._abort(abort_these)
                continue
            pick.turn.set()

    def _report_deadlock(self, live: list) -> None:
        frames = sys._current_frames()
        detail = []
        for t in live:
            reason = t.wait_reason or ("?", None)
            what = reason[0]
            obj = reason[1]
            objname = getattr(obj, "name", None) or ""
            stack = ""
            fr = frames.get(t.os_thread.ident)
            if fr is not None:
                stack = "".join(traceback.format_stack(fr, limit=8))
            detail.append(f"{t.name}: blocked on {what} {objname}\n{stack}")
        self.record_failure(
            "deadlock",
            "no runnable thread and no pending timeout; blocked: "
            + "; ".join(f"{t.name}<-{(t.wait_reason or ('?',))[0]}"
                        for t in live),
            stack="\n".join(detail))

    def _abort(self, live: list) -> None:
        self.aborting = True
        for t in live:
            t.abort = True
            t.state = _RUNNING          # hand every thread the baton
            t.turn.set()
        # Threads unwind via SchedulerAbort and report DONE; wait for
        # them on the REAL clock bounded (they do no real blocking).
        for t in live:
            t.os_thread.join(timeout=10.0)
            if t.os_thread.is_alive():
                self.record_failure(
                    "abort-timeout",
                    f"thread {t.name!r} did not unwind after abort")
            with self._mon:
                if t.state != _DONE:
                    t.state = _DONE
