"""Scheduler pacing signals.

Equivalent of the reference's pkg/util/wait/backoff.go:30-88
(SpeedSignal): schedule() returns KeepGoing when the cycle admitted
something or found no heads, so its caller re-runs it at once, and
SlowDown otherwise, so the caller backs off (the JAX package's
until_with_backoff: 1 ms doubling to 100 ms).
"""

from __future__ import annotations

from enum import Enum


class SpeedSignal(Enum):
    KEEP_GOING = 0
    SLOW_DOWN = 1


KeepGoing = SpeedSignal.KEEP_GOING
SlowDown = SpeedSignal.SLOW_DOWN
