"""Scheduler pacing: re-run immediately on success, exponential backoff
on failure.

The port's copy of kueue_tpu/utils/wait.py. Equivalent of the
reference's pkg/util/wait/backoff.go:30-88 (UntilWithBackoff with
SpeedSignal): schedule() returns KeepGoing when the cycle admitted
something or found no heads, so until_with_backoff re-runs it at once,
and SlowDown otherwise, so it backs off from 1 ms doubling to 100 ms.
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import Callable


class SpeedSignal(Enum):
    KEEP_GOING = 0
    SLOW_DOWN = 1


KeepGoing = SpeedSignal.KEEP_GOING
SlowDown = SpeedSignal.SLOW_DOWN

_BASE_DELAY = 0.001
_MAX_DELAY = 0.100


def until_with_backoff(stop: threading.Event, fn: Callable[[], SpeedSignal],
                       sleep: Callable[[float], None] = None) -> None:
    """Run fn until `stop` is set; pace according to its SpeedSignal."""
    delay = _BASE_DELAY
    while not stop.is_set():
        signal = fn()
        if signal == KeepGoing:
            delay = _BASE_DELAY
            continue
        if sleep is not None:
            sleep(delay)
        else:
            stop.wait(delay)
        delay = min(delay * 2, _MAX_DELAY)
