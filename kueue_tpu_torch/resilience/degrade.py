"""Graceful load shedding: the cycle-budget degradation ladder.

The port of kueue_tpu/resilience/degrade.py. Containment (watchdog,
breaker, supervised dispatch) bounds the cycle when the DEVICE fails;
this module bounds it when the LOAD exceeds what the configured cycle
budget allows. The scheduler feeds every cycle's wall seconds plus a
backlog-pressure proxy into a small state machine:

    normal --overloaded x escalate_after--> shed --again--> survival
      ^                                       |                |
      +------- healthy x recovery_cycles -----+----------------+

- **normal**: no intervention; one EWMA update and two compares a cycle.
- **shed**: the scheduler caps the cycle's nominate heads at
  ``shed_heads`` (extras re-heap untouched: no status patches) and
  DEFERS preempt planning (deferred preemptors keep their
  reserve-capacity semantics and retry when the ladder recovers).
- **survival**: everything shed does, with the head cap tightened to
  ``survival_heads`` and the cycle pinned to the CPU route
  (``cpu-survival``: the sequential path over the incremental snapshot,
  no device sync).

Overload is detected from the cycle-time EWMA against the budget, with
a raw-cycle plus backlog-growth trigger so a sudden storm escalates
before the EWMA catches up. Hysteresis: the ladder degrades at
``budget x enter_factor`` but only recovers below ``budget x
exit_factor``, and each rung down takes ``recovery_cycles`` consecutive
healthy cycles. ``budget_s == 0``, the default, disables the ladder.

Time comes from the scheduler's measurements, not a clock read here,
so tests drive the ladder with synthetic durations.
"""

from __future__ import annotations

from typing import Optional

NORMAL = "normal"
SHED = "shed"
SURVIVAL = "survival"
STATES = (NORMAL, SHED, SURVIVAL)

# the rungs' numeric codes
STATE_CODES = {NORMAL: 0, SHED: 1, SURVIVAL: 2}

DEFAULT_SHED_HEADS = 256
DEFAULT_SURVIVAL_HEADS = 64
DEFAULT_ENTER_FACTOR = 1.0
DEFAULT_EXIT_FACTOR = 0.7
DEFAULT_ESCALATE_AFTER = 2
DEFAULT_RECOVERY_CYCLES = 3
DEFAULT_EWMA_ALPHA = 0.3


class DegradationLadder:
    def __init__(self, budget_s: float = 0.0,
                 shed_heads: int = DEFAULT_SHED_HEADS,
                 survival_heads: int = DEFAULT_SURVIVAL_HEADS,
                 enter_factor: float = DEFAULT_ENTER_FACTOR,
                 exit_factor: float = DEFAULT_EXIT_FACTOR,
                 escalate_after: int = DEFAULT_ESCALATE_AFTER,
                 recovery_cycles: int = DEFAULT_RECOVERY_CYCLES,
                 ewma_alpha: float = DEFAULT_EWMA_ALPHA):
        if budget_s < 0:
            raise ValueError("cycle budget must be >= 0 (0 disables)")
        if shed_heads < 1 or survival_heads < 1:
            raise ValueError("shed/survival head caps must be >= 1")
        if not 0 < exit_factor <= enter_factor:
            raise ValueError("need 0 < exit_factor <= enter_factor "
                             "(hysteresis band)")
        if escalate_after < 1 or recovery_cycles < 1:
            raise ValueError("escalate_after and recovery_cycles "
                             "must be >= 1")
        if not 0 < ewma_alpha <= 1:
            raise ValueError("ewma_alpha must be in (0, 1]")
        self.budget_s = budget_s
        self.shed_heads = shed_heads
        self.survival_heads = survival_heads
        self.enter_factor = enter_factor
        self.exit_factor = exit_factor
        self.escalate_after = escalate_after
        self.recovery_cycles = recovery_cycles
        self.ewma_alpha = ewma_alpha
        self.state = NORMAL
        self.ewma_s: Optional[float] = None
        self._over = 0       # consecutive overloaded cycles at this rung
        self._healthy = 0    # consecutive healthy cycles at this rung
        self._last_backlog: Optional[int] = None
        # Counters.
        self.cycles_observed = 0
        self.cycles_shed = 0       # cycles that RAN in shed or survival
        self.escalations = 0       # rung-up transitions
        self.recoveries = 0        # rung-down transitions
        self.idle_cycles = 0       # idle ticks fed while degraded
        self.last_transition: Optional[str] = None  # "a->b"

    @property
    def enabled(self) -> bool:
        return self.budget_s > 0

    def head_cap(self) -> Optional[int]:
        """Max heads this cycle may nominate (None = uncapped)."""
        if self.state == SHED:
            return self.shed_heads
        if self.state == SURVIVAL:
            return self.survival_heads
        return None

    @property
    def defer_preemption(self) -> bool:
        """Shed and survival both skip preempt target selection."""
        return self.state != NORMAL

    @property
    def pin_cpu(self) -> bool:
        """Survival pins the CPU-incremental route."""
        return self.state == SURVIVAL

    @property
    def allow_pipeline(self) -> bool:
        """Speculative pipelining under degradation (the JAX package's
        pipeline; the port has none yet): shed keeps it, survival
        drains it."""
        return self.state != SURVIVAL

    def observe_idle(self) -> bool:
        """An idle scheduler tick (no heads popped). Idle ticks count toward the healthy-cycle streak (there is no
        cycle time to EWMA, and an empty queue means no backlog
        growth); returns True when the ladder rung down."""
        if self.budget_s <= 0 or self.state == NORMAL:
            return False
        self.idle_cycles += 1
        self._over = 0
        self._healthy += 1
        self._last_backlog = 0
        # The storm's EWMA is stale the moment the queue is empty: left
        # in place, the first (healthy) cycles after traffic resumes
        # would inherit it and spuriously re-escalate. No cycle ran, so
        # there is no cycle-time signal — drop the estimate.
        self.ewma_s = None
        if self._healthy >= self.recovery_cycles:
            self._move(NORMAL if self.state == SHED else SHED)
            self.recoveries += 1
            self._healthy = 0
            return True
        return False

    def observe_cycle(self, duration_s: float,
                      backlog: Optional[int] = None) -> bool:
        """Feed one completed cycle's wall seconds and (optionally) the
        cycle's backlog pressure — the caller's cheap proxy for pending
        demand (the scheduler passes heads popped minus admissions).
        Returns True when the ladder changed state; the caller reads the
        new rung from ``self.state``."""
        if self.budget_s <= 0:
            return False
        self.cycles_observed += 1
        if self.state != NORMAL:
            self.cycles_shed += 1
        e = self.ewma_s
        self.ewma_s = (duration_s if e is None
                       else e + self.ewma_alpha * (duration_s - e))
        growing = (backlog is not None and self._last_backlog is not None
                   and backlog > self._last_backlog)
        self._last_backlog = backlog
        # Overload: the smoothed cycle time blew the budget, OR this raw
        # cycle did while demand is still growing (storm onset — don't
        # wait for the EWMA to catch up).
        overloaded = (self.ewma_s > self.budget_s * self.enter_factor
                      or (duration_s > self.budget_s and growing))
        healthy = (self.ewma_s <= self.budget_s * self.exit_factor
                   and not growing)
        if overloaded:
            self._healthy = 0
            self._over += 1
            if self._over >= self.escalate_after and self.state != SURVIVAL:
                self._move(SHED if self.state == NORMAL else SURVIVAL)
                self.escalations += 1
                self._over = 0
                return True
        elif healthy:
            self._over = 0
            self._healthy += 1
            if self._healthy >= self.recovery_cycles and self.state != NORMAL:
                self._move(NORMAL if self.state == SHED else SHED)
                self.recoveries += 1
                self._healthy = 0
                return True
        else:
            # Hysteresis band (between exit and enter): hold the rung,
            # reset both streaks — neither escalation nor recovery may
            # accumulate across a borderline stretch.
            self._over = 0
            self._healthy = 0
        return False

    def _move(self, to: str) -> None:
        self.last_transition = f"{self.state}->{to}"
        self.state = to

    def status(self) -> dict:
        """The ladder's state and counters."""
        return {
            "state": self.state,
            "enabled": self.enabled,
            "budget_ms": round(self.budget_s * 1e3, 3),
            "ewma_ms": (round(self.ewma_s * 1e3, 3)
                        if self.ewma_s is not None else None),
            "shed_heads": self.shed_heads,
            "survival_heads": self.survival_heads,
            "enter_factor": self.enter_factor,
            "exit_factor": self.exit_factor,
            "escalate_after": self.escalate_after,
            "recovery_cycles": self.recovery_cycles,
            "consecutive_overloaded": self._over,
            "consecutive_healthy": self._healthy,
            "last_backlog": self._last_backlog,
            "cycles_observed": self.cycles_observed,
            "cycles_shed": self.cycles_shed,
            "escalations": self.escalations,
            "recoveries": self.recoveries,
            "idle_cycles": self.idle_cycles,
            "allow_pipeline": self.allow_pipeline,
            "last_transition": self.last_transition,
        }
