"""Deterministic controller runtime: workqueues drained to idle.

The port's copy of kueue_tpu/sim/runtime.py. Replaces controller-runtime's manager (reference: cmd/kueue/main.go:141,
pkg/controller/core/core.go:36). Each Controller owns a rate-unlimited
workqueue of reconcile keys; `Runtime.run_until_idle()` drains every
queue round-robin until no work remains, which makes integration-style
tests deterministic (the reference gets the same effect from gomega
Eventually loops over envtest).

Delayed requeues (`RequeueAfter`) are held in a time-ordered list and
released by `advance()` against the injected clock — the analogue of the
reference's fake-clock-driven requeue-backoff tests
(workload_controller.go:486-552).
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

from kueue_tpu_torch.api.meta import Clock, REAL_CLOCK


@dataclass
class Event:
    object_key: str
    kind: str
    type: str  # "Normal" | "Warning"
    reason: str
    message: str


# Default retained-event window. Million-event scenario runs (the
# sim/scenarios.py traffic suites) would otherwise grow the event list
# without bound; 100k keeps every test-scale run fully retained while
# bounding a storm's memory to the recent window.
DEFAULT_EVENT_CAPACITY = 100_000


class EventRecorder:
    """record.EventRecorder stand-in; events are assertions targets in
    tests.

    Bounded: the retained ``events`` window is a ring of the last
    ``capacity`` events (oldest dropped first), while ``reason_counts``
    and ``total_events`` keep exact lifetime tallies — so a
    million-event scenario run can still assert on eviction/requeue
    *counts* after the early events have rotated out. ``by_reason``
    operates on the retained window only."""

    def __init__(self, capacity: int = DEFAULT_EVENT_CAPACITY):
        if capacity < 1:
            raise ValueError("event recorder capacity must be >= 1")
        from collections import deque
        self.capacity = capacity
        self.events: "deque[Event]" = deque(maxlen=capacity)
        self.reason_counts: dict = {}   # reason -> lifetime count
        self.total_events = 0

    def _record(self, event: Event) -> None:
        self.events.append(event)   # deque(maxlen): oldest falls off
        self.total_events += 1
        self.reason_counts[event.reason] = \
            self.reason_counts.get(event.reason, 0) + 1

    def event(self, obj, etype: str, reason: str, message: str) -> None:
        meta = obj.metadata
        key = f"{meta.namespace}/{meta.name}" if meta.namespace else meta.name
        self._record(Event(key, type(obj).__name__, etype, reason, message))

    def system_event(self, etype: str, reason: str, message: str) -> None:
        """An event about the control plane itself rather than a stored
        object (device faults, breaker trips/recoveries): no object key,
        kind "Scheduler" — chaos tooling and operators read the outage
        timeline from these."""
        self._record(Event("", "Scheduler", etype, reason, message))

    def by_reason(self, reason: str) -> list[Event]:
        """Matching events within the retained window (use
        ``reason_counts`` for exact lifetime tallies)."""
        return [e for e in self.events if e.reason == reason]

    def count_by_reason_prefix(self, prefix: str) -> int:
        """Lifetime count of events whose reason starts with ``prefix``
        (e.g. "EvictedDueTo" sums every eviction reason) — survives ring
        rotation, so scenario SLO gates read amplification from here."""
        return sum(n for r, n in self.reason_counts.items()
                   if r.startswith(prefix))


class Controller:
    """One reconciler + its workqueue. reconcile(key) may return a float
    (requeue-after seconds), True (immediate requeue), or None."""

    def __init__(self, name: str, reconcile: Callable[[str], object]):
        self.name = name
        self._reconcile = reconcile
        from collections import deque
        self._queue: "deque[str]" = deque()  # deque: popleft is O(1)
        self._queued: set[str] = set()

    def enqueue(self, key: str) -> None:
        if key not in self._queued:
            self._queued.add(key)
            self._queue.append(key)

    def has_work(self) -> bool:
        return bool(self._queue)

    def process_one(self) -> object:
        key = self._queue.popleft()
        self._queued.discard(key)
        return key, self._reconcile(key)


class Runtime:
    def __init__(self, clock: Clock = REAL_CLOCK, metrics=None):
        self.clock = clock
        self.controllers: list[Controller] = []
        self._timer_seq = itertools.count()
        self._timers: list = []  # heap of (due, seq, controller, key)
        # Optional metrics Registry: every reconcile's wall seconds land
        # in reconcile_seconds{controller} — the coarse latency signal
        # for the wall_s - cycle_time_total gap the scheduler-only
        # flight recorder can't see.
        self.metrics = metrics

    def add_controller(self, ctrl: Controller) -> Controller:
        self.controllers.append(ctrl)
        return ctrl

    def controller(self, name: str, reconcile: Callable[[str], object]) -> Controller:
        return self.add_controller(Controller(name, reconcile))

    def requeue_after(self, ctrl: Controller, key: str, delay: float) -> None:
        heapq.heappush(self._timers,
                       (self.clock.now() + delay, next(self._timer_seq), ctrl, key))

    def _release_due_timers(self) -> None:
        now = self.clock.now()
        while self._timers and self._timers[0][0] <= now:
            _, _, ctrl, key = heapq.heappop(self._timers)
            ctrl.enqueue(key)

    def run_until_idle(self, max_iterations: int = 10000) -> int:
        """Drain every controller queue in registration order; returns
        the reconcile count. Raises if the system does not settle (a
        reconcile hot-loop).

        Each pass drains a controller's CURRENT queue fully (bounded by
        its length at pass start, so immediate requeues go to the next
        pass) before moving on. Order matters for throughput, not
        correctness: the workload controller registers first, so all of
        an admission wave's workload-event echoes land — deduping into
        ONE ClusterQueue/LocalQueue key each — before the status
        reconcilers run, instead of interleaving and rebuilding each CQ
        status several times per cycle."""
        import time as _time
        processed = 0
        metrics = self.metrics
        self._release_due_timers()
        for _ in range(max_iterations):
            worked = False
            for ctrl in self.controllers:
                for _ in range(len(ctrl._queue)):
                    worked = True
                    if metrics is not None:
                        t0 = _time.perf_counter()
                        key, result = ctrl.process_one()
                        metrics.reconcile_observed(
                            ctrl.name, _time.perf_counter() - t0)
                    else:
                        key, result = ctrl.process_one()
                    processed += 1
                    if result is True:
                        ctrl.enqueue(key)
                    elif isinstance(result, (int, float)) \
                            and result is not False and result > 0:
                        self.requeue_after(ctrl, key, float(result))
            if not worked:
                return processed
        raise RuntimeError("runtime did not settle: reconcile hot-loop suspected")

    def advance(self, dt: float, fake_clock=None) -> int:
        """Advance the fake clock, release due timers, drain to idle.
        With a real clock (no .advance), just releases anything already
        due — wall time moves on its own."""
        clk = fake_clock if fake_clock is not None else self.clock
        if hasattr(clk, "advance"):
            clk.advance(dt)
        self._release_due_timers()
        return self.run_until_idle()

    def next_timer_due(self) -> Optional[float]:
        return self._timers[0][0] if self._timers else None
