"""The synchronization seam of ``serve/`` (port of the production half of
``cuvite_tpu/serve/sync.py:55-115``).

Every lock, event, condition and thread the serving layer creates comes
from the factories below, which return the plain ``threading``
primitives.  The reference also returns scheduler-backed twins inside
``activated(scheduler)``, so that its concurrency checker can run the
daemon under a seeded cooperative schedule; that ``Scheduler`` is not
ported (``ROADMAP.md`` queue A item A9 step 4: ``concheck`` and its
``Scheduler``), so :func:`active_scheduler` is always None and
:class:`activated` refuses.
"""

from __future__ import annotations

import threading as _threading


class activated:
    """The reference's context manager installing a cooperative
    scheduler.  The scheduler is not ported: entering raises."""

    def __init__(self, sched):
        self.sched = sched

    def __enter__(self):
        raise RuntimeError(
            "serve.sync: the cooperative Scheduler of the concurrency "
            "checker is not ported (ROADMAP.md queue A item A9 step 4: "
            "concheck and its Scheduler)")

    def __exit__(self, *exc) -> None:
        return None


def active_scheduler():
    """The active cooperative scheduler: always None (not ported)."""
    return None


def Lock(name: str | None = None):
    """A mutex (``threading.Lock``)."""
    return _threading.Lock()


def RLock(name: str | None = None):
    """A re-entrant mutex (``threading.RLock``)."""
    return _threading.RLock()


def Event(name: str | None = None):
    return _threading.Event()


def Condition(lock=None, name: str | None = None):
    return _threading.Condition(lock)


def Thread(*, target, name: str | None = None, args=(), kwargs=None,
           daemon: bool = True):
    """A thread handle (``threading.Thread``, a daemon by default)."""
    return _threading.Thread(target=target, name=name, args=args,
                             kwargs=kwargs or {}, daemon=daemon)
