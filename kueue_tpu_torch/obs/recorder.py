"""Cycle flight recorder: a queryable black box for the admission loop.

Every scheduler cycle produces a structured ``CycleTrace`` — route mode
(device / device-pipelined / cpu / cpu-forced / cpu-strict /
cpu-breaker / cpu-survival / cpu-warmup / drain), regime,
degradation-ladder rung,
head/admit/evict counts, fault and
breaker annotations, and the cycle's phase spans (snapshot, encode,
route, dispatch, fetch, decode, preempt-plan, apply, requeue, plus
nested sub-spans like ``dispatch.scatter``) — held in a bounded ring
buffer of the last N cycles. The recorder is the single source both
the ``/debug/cycles`` endpoint and the ``cycle_phase_seconds``
histograms are fed from, so their per-cycle sums reconcile by
construction.

Cost contract (mirrors ``resilience.faultinject``): with the recorder
DISABLED, ``begin_cycle`` returns None and every ``span``/``annotate``
call is one attribute load plus an ``is None`` compare; the
``trace_overhead`` bench row pins both the disabled and the enabled
per-cycle cost at <=1% of a fault-free cycle. Span capture itself is a
tuple append — no allocation beyond the tuple, no locking on the hot
path (the scheduler thread is the only writer; readers copy under the
ring lock).

The port's copy of kueue_tpu/obs/recorder.py.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

DEFAULT_CAPACITY = 256


class CycleTrace:
    """One cycle's trace. ``spans`` holds ``(name, start_s, dur_s)``
    tuples with starts relative to the cycle's own t0; a dot in the
    name nests it under its prefix phase (``dispatch.scatter`` is part
    of ``dispatch`` and excluded from per-phase sums to avoid
    double-counting)."""

    __slots__ = ("cycle_id", "t_wall", "t0", "duration_s", "route",
                 "regime", "heads", "admitted", "evictions", "faults",
                 "breaker", "degraded", "tag", "spans", "annotations",
                 "upload_bytes", "fetch_bytes", "dispatches", "collects")

    def __init__(self, cycle_id: int, t_wall: float, t0: float):
        self.cycle_id = cycle_id
        self.t_wall = t_wall          # epoch seconds at cycle start
        self.t0 = t0                  # perf_counter base for span offsets
        self.duration_s = 0.0
        self.route = ""
        self.regime = ""
        self.heads = 0
        self.admitted: Optional[int] = None
        self.evictions = 0
        self.faults = 0
        self.breaker = ""
        self.degraded = ""            # ladder rung the cycle ran under
        self.tag = ""                 # scenario context (traffic phase)
        # Per-cycle host<->device transport (solver counter deltas over
        # the cycle): bytes on the wire and round trips — the steady-
        # state contract is ONE dispatch + ONE collect per device cycle
        # with a decision-sized fetch, and these fields make every
        # violation visible per trace (tools/transport_probe.py).
        self.upload_bytes = 0
        self.fetch_bytes = 0
        self.dispatches = 0
        self.collects = 0
        self.spans: list = []         # (name, start_s, dur_s)
        self.annotations: list = []   # dicts: {"kind", "message", ...}

    def phase_sums(self) -> dict:
        """Per-phase wall seconds, top-level spans only (nested
        ``a.b`` spans are already inside their parent's time)."""
        sums: dict = {}
        for name, _start, dur in self.spans:
            if "." in name:
                continue
            sums[name] = sums.get(name, 0.0) + dur
        return sums

    def to_dict(self) -> dict:
        return {
            "cycle": self.cycle_id,
            "t_wall": self.t_wall,
            "duration_ms": round(self.duration_s * 1e3, 3),
            "route": self.route,
            "regime": self.regime,
            "heads": self.heads,
            "admitted": self.admitted,
            "evictions": self.evictions,
            "faults": self.faults,
            "breaker": self.breaker,
            "degraded": self.degraded,
            "tag": self.tag,
            "upload_bytes": self.upload_bytes,
            "fetch_bytes": self.fetch_bytes,
            "dispatches": self.dispatches,
            "collects": self.collects,
            "spans": [{"name": n, "start_ms": round(s * 1e3, 3),
                       "dur_ms": round(d * 1e3, 3)}
                      for n, s, d in self.spans],
            "annotations": list(self.annotations),
        }


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: list = []      # completed traces, oldest first
        self._current: Optional[CycleTrace] = None
        self.cycles_recorded = 0   # lifetime count (ring is bounded)
        # Scenario-owned context tag stamped onto every trace begun while
        # it is set: scenario runners (sim/scenarios.py) label cycles
        # with the traffic phase ("ramp"/"storm"/"recovery") so SLO
        # evaluation can window the trace stream without guessing from
        # timestamps. Empty outside scenario runs.
        self.tag = ""

    def set_tag(self, tag: str) -> None:
        """Set the phase tag stamped onto subsequent traces ("" clears)."""
        self.tag = tag

    # --- producer side (the scheduler thread) ---

    def begin_cycle(self, cycle_id: int) -> Optional[CycleTrace]:
        """Start a trace (None when disabled — all subsequent span/
        annotate calls become single-compare no-ops). An unfinished
        previous trace (a cycle that died mid-flight) is discarded."""
        if not self.enabled:
            self._current = None
            return None
        tr = CycleTrace(cycle_id, time.time(), time.perf_counter())
        tr.tag = self.tag
        self._current = tr
        return tr

    def span(self, name: str, t0: float, dur_s: float) -> None:
        """Record a phase span; ``t0`` is the span's perf_counter start.
        Hot path: no-op unless a trace is open."""
        tr = self._current
        if tr is None:
            return
        tr.spans.append((name, t0 - tr.t0, dur_s))

    def annotate(self, kind: str, message: str, **fields) -> None:
        """Attach a fault/timeout/breaker annotation to the open trace."""
        tr = self._current
        if tr is None:
            return
        tr.annotations.append({"kind": kind, "message": message, **fields})

    def finish(self, trace: Optional[CycleTrace]) -> None:
        """Seal the trace and append it to the ring."""
        if trace is None:
            return
        trace.duration_s = time.perf_counter() - trace.t0
        if self._current is trace:
            self._current = None
        with self._lock:
            self._ring.append(trace)
            if len(self._ring) > self.capacity:
                del self._ring[: len(self._ring) - self.capacity]
            self.cycles_recorded += 1

    # --- consumer side (endpoints, dumper, tests) ---

    def traces(self, n: int = 0) -> list:
        """The last ``n`` completed traces (all retained when n<=0),
        oldest first."""
        with self._lock:
            out = list(self._ring)
        return out[-n:] if n > 0 else out

    def last(self) -> Optional[CycleTrace]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def slowest(self, k: int) -> list:
        """The k slowest retained cycles, slowest first."""
        with self._lock:
            out = list(self._ring)
        out.sort(key=lambda t: t.duration_s, reverse=True)
        return out[: max(k, 0)]
