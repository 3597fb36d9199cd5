"""Circuit breaker for the solver's device route.

The port of kueue_tpu/resilience/breaker.py.

Fed by watchdog timeouts and dispatch/collect exceptions (the scheduler
calls ``record_fault``), it keeps a wedged or flapping accelerator from
eating every cycle's deadline:

- CLOSED: device route allowed; ``threshold`` CONSECUTIVE faults trip
  it open (one success resets the count — an isolated glitch on a
  healthy device must not accumulate forever).
- OPEN: ``allow_device`` is False — the scheduler pins cycles to the
  CPU fallback under the distinct route name "cpu-breaker". After the
  current backoff elapses the next ``allow_device`` transitions to
  HALF_OPEN and admits exactly one probe cycle.
- HALF_OPEN: the probe ran; ``record_success`` closes the breaker and
  resets the backoff, ``record_fault`` re-opens it with the backoff
  doubled (capped at ``backoff_max_s``), plus jitter so a fleet of
  schedulers sharing one recovering device doesn't probe in lockstep.

Time comes from the caller (the scheduler's injected clock), so tests
drive backoff deterministically with a FakeClock; jitter
comes from a seeded RNG for the same reason.
"""

from __future__ import annotations

import random

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    def __init__(self, threshold: int = 3, backoff_base_s: float = 1.0,
                 backoff_max_s: float = 60.0, jitter: float = 0.1,
                 seed: int = 0):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = threshold
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self._rng = random.Random(seed)
        self.state = CLOSED
        self.consecutive_faults = 0
        self._backoff_s = backoff_base_s
        self._retry_at = 0.0
        # Counters for metrics/artifacts.
        self.trips = 0            # CLOSED/HALF_OPEN -> OPEN transitions
        self.recoveries = 0       # HALF_OPEN -> CLOSED transitions
        self.faults = 0           # every record_fault
        self.blocked_cycles = 0   # allow_device() == False since last trip
        self.last_recovery_cycles = 0  # blocked+probe cycles of last outage

    def allow_device(self, now: float) -> bool:
        """May this cycle take the device route? OPEN past its backoff
        admits one half-open probe; the caller MUST follow the probe
        with record_success or record_fault before asking again."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN and now >= self._retry_at:
            self.state = HALF_OPEN
            return True
        # OPEN within backoff — and HALF_OPEN, where a probe's outcome
        # hasn't been recorded yet (a second concurrent probe would make
        # the outcome unattributable).
        self.blocked_cycles += 1
        return False

    def record_fault(self, now: float) -> bool:
        """A device fault (dispatch/collect exception, watchdog timeout,
        detected corruption). Returns True when this fault TRIPPED the
        breaker (for metrics/events)."""
        self.faults += 1
        if self.state == HALF_OPEN:
            # Failed probe: back off harder before the next one. Counts
            # as a trip (HALF_OPEN -> OPEN).
            self.trips += 1
            self.blocked_cycles += 1  # the probe cycle made no progress
            self._backoff_s = min(self._backoff_s * 2, self.backoff_max_s)
            self._open(now)
            return True
        self.consecutive_faults += 1
        if self.state == CLOSED \
                and self.consecutive_faults >= self.threshold:
            self.trips += 1
            self.blocked_cycles = 0
            self._open(now)
            return True
        return False

    def record_success(self, now: float) -> bool:
        """A device-routed cycle completed without a fault. Returns True
        when this closed a half-open breaker (a recovery)."""
        self.consecutive_faults = 0
        if self.state == HALF_OPEN:
            self.state = CLOSED
            self._backoff_s = self.backoff_base_s
            self.recoveries += 1
            # +1: the probe cycle itself is part of the outage window.
            self.last_recovery_cycles = self.blocked_cycles + 1
            self.blocked_cycles = 0
            return True
        return False

    def status(self) -> dict:
        """The breaker's state and counters. ``retry_at`` is in the
        caller's clock domain."""
        return {
            "state": self.state,
            "consecutive_faults": self.consecutive_faults,
            "threshold": self.threshold,
            "faults": self.faults,
            "trips": self.trips,
            "recoveries": self.recoveries,
            "blocked_cycles": self.blocked_cycles,
            "last_recovery_cycles": self.last_recovery_cycles,
            "backoff_s": self._backoff_s,
            "retry_at": self._retry_at,
        }

    def probe_inconclusive(self, now: float) -> None:
        """The admitted probe cycle never actually round-tripped the
        device (work gates sent everything to the CPU preemptor): it
        proved nothing, so re-arm the probe for the next cycle instead
        of leaving HALF_OPEN waiting for an outcome that never comes."""
        if self.state == HALF_OPEN:
            self.state = OPEN
            self._retry_at = now
            # The consumed probe cycle is still part of the outage
            # window last_recovery_cycles reports.
            self.blocked_cycles += 1

    def _open(self, now: float) -> None:
        self.state = OPEN
        self.consecutive_faults = 0
        delay = self._backoff_s * (1.0 + self.jitter * self._rng.random())
        self._retry_at = now + delay
