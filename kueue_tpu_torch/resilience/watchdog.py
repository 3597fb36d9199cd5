"""Dispatch watchdog: deadlines for the device round trip.

The port of kueue_tpu/resilience/watchdog.py. Every dispatched cycle
carries a deadline derived from what a device cycle costs here (the
scheduler's estimate: the solver's recent launch-to-sync times) times a
safety factor, clamped to [min_deadline_s, max_deadline_s]. A collect
that misses its deadline raises ``DispatchTimeout`` (a ``DeviceFault``):
the scheduler abandons the in-flight result, drops the device-resident
state (the host mirrors are the truth; the device twin is a cache),
nominates the heads on the CPU and records the fault with the breaker.

The floor ``min_deadline_s`` keeps a sub-millisecond estimate from
turning host pauses into false timeouts; ``max_deadline_s``, the cold
clamp, is the deadline before any sample exists and the bound of the
supervised dispatch.
"""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch.resilience.faultinject import DeviceFault


class DispatchTimeout(DeviceFault):
    """The in-flight collect missed its deadline; the result was
    abandoned (the fetch thread is orphaned — Python cannot cancel a
    blocked device call, only stop waiting for it)."""

    def __init__(self, deadline_s: float, waited_s: float):
        super().__init__(
            f"dispatch collect exceeded its {deadline_s * 1e3:.0f}ms "
            f"deadline (waited {waited_s * 1e3:.0f}ms)")
        self.deadline_s = deadline_s
        self.waited_s = waited_s


class DispatchWatchdog:
    def __init__(self, safety_factor: float = 20.0,
                 min_deadline_s: float = 1.0,
                 max_deadline_s: float = 30.0):
        if safety_factor <= 0 or min_deadline_s <= 0:
            raise ValueError("watchdog factor and floor must be positive")
        self.safety_factor = safety_factor
        self.min_deadline_s = min_deadline_s
        self.max_deadline_s = max_deadline_s

    def deadline_s(self, estimate_s: Optional[float]) -> float:
        """Deadline for one dispatch+collect, given the best available
        estimate of a healthy device cycle's wall seconds (None when no
        sample exists yet — first cycles get the max: a cold cycle may
        legitimately carry a multi-second remote compile)."""
        if estimate_s is None or estimate_s <= 0:
            return self.max_deadline_s
        d = estimate_s * self.safety_factor
        return min(max(d, self.min_deadline_s), self.max_deadline_s)
