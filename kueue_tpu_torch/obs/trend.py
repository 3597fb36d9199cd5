"""Aging watch: EWMA-slope trend monitors over monotone resources.

ROADMAP item 5 (long-horizon soak) gates on monotone-resource
invariants — live_handouts returning to zero between cycles, WAL size
bounded by compaction, flat arena occupancy and RSS trends, bounded
requeue amplification, zero mid-traffic compiles after warmup. Today
those exist only as ad-hoc scenario asserts; this module makes them a
live, queryable surface: each monitor samples one resource per cycle
seal, keeps an EWMA of the per-sample slope, and renders a verdict —
so the future soak harness gets its gate surface for free and an
operator can ask ``/debug/aging`` whether a week-old process is
leaking *now*.

Verdict semantics per monitor:

- ``warming`` — fewer than ``warmup`` samples; no judgement yet (a
  fresh process legitimately grows while queues fill).
- ``ok`` — slope EWMA at or below the threshold.
- ``growing`` — slope EWMA above the threshold, but not yet sustained
  for ``window`` consecutive samples (could be a storm filling up).
- ``leaking`` — slope EWMA above threshold for >= ``window``
  consecutive samples: sustained monotone growth, the aging signature.
- ``over-bound`` — the level itself exceeded the monitor's hard bound
  (e.g. WAL records past 2x the compaction interval = a compaction
  stall), regardless of slope.

The slope EWMA (not the raw delta) is what makes the detector robust
to sawtooth resources: a healthy WAL grows then drops at every
checkpoint, so its slope EWMA hovers near zero, while a stalled
compaction holds it at the append rate. Cost: one callable + a few
float ops per monitor per cycle — covered by the ``journey_overhead``
bench row's <=1% budget alongside the ledger hooks.

The port's copy of kueue_tpu/obs/trend.py.
"""

from __future__ import annotations

from typing import Callable, Optional

VERDICT_WARMING = "warming"
VERDICT_OK = "ok"
VERDICT_GROWING = "growing"
VERDICT_LEAKING = "leaking"
VERDICT_OVER_BOUND = "over-bound"

# Verdicts that constitute an aging violation (probe/soak gate).
BAD_VERDICTS = (VERDICT_LEAKING, VERDICT_OVER_BOUND)

DEFAULT_ALPHA = 0.2
DEFAULT_WINDOW = 12
DEFAULT_WARMUP = 8


class TrendMonitor:
    """One resource's trend detector. ``slope_threshold`` is the
    per-sample growth the EWMA may sustain before the monitor calls it
    a leak (None = slope unchecked, bound-only monitor); ``bound`` is
    a hard level ceiling (None = unchecked)."""

    def __init__(self, name: str, slope_threshold: Optional[float],
                 bound: Optional[float] = None,
                 alpha: float = DEFAULT_ALPHA,
                 window: int = DEFAULT_WINDOW,
                 warmup: int = DEFAULT_WARMUP):
        if slope_threshold is None and bound is None:
            raise ValueError(f"monitor {name!r}: need a slope threshold "
                             "or a bound (or both)")
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1]")
        if window < 1 or warmup < 0:
            raise ValueError("window must be >= 1 and warmup >= 0")
        self.name = name
        self.slope_threshold = slope_threshold
        self.bound = bound
        self.alpha = alpha
        self.window = window
        self.warmup = warmup
        self.samples = 0
        self.value: Optional[float] = None
        self.slope_ewma = 0.0
        self.sustained = 0       # consecutive samples above threshold
        self.over_bound = 0      # consecutive samples above the bound
        self.sample_errors = 0   # source raised (guarded by the watch)

    def sample(self, value: float) -> None:
        prev = self.value
        self.value = float(value)
        self.samples += 1
        if prev is not None:
            slope = self.value - prev
            self.slope_ewma += self.alpha * (slope - self.slope_ewma)
        if self.slope_threshold is not None \
                and self.samples > self.warmup \
                and self.slope_ewma > self.slope_threshold:
            self.sustained += 1
        else:
            self.sustained = 0
        if self.bound is not None and self.value > self.bound:
            self.over_bound += 1
        else:
            self.over_bound = 0

    def verdict(self) -> str:
        if self.bound is not None and self.over_bound >= 1:
            return VERDICT_OVER_BOUND
        if self.samples <= self.warmup:
            return VERDICT_WARMING
        if self.slope_threshold is None \
                or self.slope_ewma <= self.slope_threshold:
            return VERDICT_OK
        return (VERDICT_LEAKING if self.sustained >= self.window
                else VERDICT_GROWING)

    def status(self) -> dict:
        return {
            "value": self.value,
            "slope_ewma": round(self.slope_ewma, 6),
            "slope_threshold": self.slope_threshold,
            "bound": self.bound,
            "window": self.window,
            "samples": self.samples,
            "sustained": self.sustained,
            "sample_errors": self.sample_errors,
            "verdict": self.verdict(),
        }


class AgingWatch:
    """A set of trend monitors sampled once per cycle seal. Sources are
    zero-argument callables registered by the manager (cache handout
    counts, WAL stats, arena occupancy, ledger ratios, RSS); a source
    that raises is counted and skipped, never fatal — aging detection
    must not become an aging failure mode."""

    def __init__(self):
        self.monitors: dict = {}        # name -> TrendMonitor
        self._sources: dict = {}        # name -> callable
        self.samples_taken = 0

    def add(self, name: str, source: Callable[[], float],
            slope_threshold: Optional[float],
            bound: Optional[float] = None,
            alpha: float = DEFAULT_ALPHA,
            window: int = DEFAULT_WINDOW,
            warmup: int = DEFAULT_WARMUP) -> TrendMonitor:
        mon = TrendMonitor(name, slope_threshold, bound=bound, alpha=alpha,
                           window=window, warmup=warmup)
        self.monitors[name] = mon
        self._sources[name] = source
        return mon

    def sample(self) -> None:
        """One sampling pass (the scheduler calls this at every cycle
        seal). Hot-path contract: len(monitors) callable invocations
        plus a few float ops each."""
        self.samples_taken += 1
        for name, mon in self.monitors.items():
            try:
                mon.sample(self._sources[name]())
            except Exception:  # noqa: BLE001 — a dead source must not kill cycles
                mon.sample_errors += 1

    def verdicts(self) -> dict:
        return {name: mon.verdict() for name, mon in self.monitors.items()}

    @property
    def failing(self) -> list:
        """Monitors whose verdict is an aging violation, sorted."""
        return sorted(name for name, mon in self.monitors.items()
                      if mon.verdict() in BAD_VERDICTS)

    def gate(self) -> dict:
        """The machine-readable aging verdict every gate consumes —
        soak harness, scenario results and /debug/aging share THIS
        contract instead of re-deriving pass/fail from status():
        ``ok`` is True iff no monitor's verdict is in BAD_VERDICTS,
        ``failing`` lists the violators, ``verdicts`` maps every
        monitor to its current verdict (warming/ok/growing count as
        green — a fresh process is not a leaking one)."""
        failing = self.failing
        return {"ok": not failing, "failing": failing,
                "verdicts": self.verdicts()}

    def status(self) -> dict:
        """The single producer /debug/aging, the probe and tests
        share. Carries the gate() dict verbatim so a status consumer
        and a gate consumer can never disagree."""
        return {
            "samples_taken": self.samples_taken,
            "failing": self.failing,
            "gate": self.gate(),
            "monitors": {name: mon.status()
                         for name, mon in self.monitors.items()},
        }


def rss_kb() -> float:
    """This process's peak resident set in KB (ru_maxrss; a leak grows
    it continually, a healthy run plateaus after warmup). ru_maxrss is
    kilobytes on Linux but BYTES on macOS — normalize, or the KB-scaled
    slope threshold false-positives by 1024x there."""
    import resource
    import sys
    rss = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    return rss / 1024.0 if sys.platform == "darwin" else rss
