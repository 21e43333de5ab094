"""The injectable clock of the serving layer (port of
``cuvite_tpu/serve/clock.py``).

Every deadline in ``serve/`` -- linger, job ``deadline_s`` shedding,
admission ``retry_after_s``, retry backoff -- runs on a clock the caller
can inject: the queue, the daemon and the load generator take ``clock=``
and ``sleep=`` and default to the two functions below, and tests pass a
fake pair that advances virtual time at once.  Busy windows of the
batched driver are measured on the same clock, so admission and the
b_max autotuner can be driven by a fake clock and a stub runner.
"""

from __future__ import annotations

import time


def monotonic() -> float:
    """The default serving clock (seconds, monotonic)."""
    return time.monotonic()


def sleep(seconds: float) -> None:
    """The default serving sleep (retry backoff, poll waits)."""
    if seconds > 0:
        time.sleep(seconds)
