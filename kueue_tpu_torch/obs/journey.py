"""Workload journey ledger: end-to-end admission tracing + SLIs.

The north-star metric is time-to-admission at 50k pending x 2k CQs x
32 flavors, yet every other observability surface is cycle-centric
(FlightRecorder/CycleTrace), read-side (the query plane) or aggregate
(per-CQ wait-time histograms). When a workload takes 40 cycles to
admit, none of them can say *where those 40 cycles went* — requeue-
backoff loops, shed-rung deferrals, preempt-victim churn, MultiKueue
plan expiry. This module gives every workload a causally-stamped span
timeline:

    queued -> requeued(cycle, reason) ... -> shed
           -> quota-reserved(cycle) -> admitted
           -> evicted(reason) / preempted(by, reason) -> queued ...
           -> mk-planned(cluster) / mk-executed / mk-expired

(deferred preempt planning appears as requeued spans whose message
names the shedding — see the note above quota_reserved)

fed from the hook points that already exist (the queue manager's
workload delta feed, the scheduler's admit/requeue/shed sites, the
workload controller's eviction paths, MultiKueueController's planned-
mirror lifecycle). Every span is stamped with the **cycle id**, the
cache's structural **generation token**, and the cycle's **route**, so
a journey stays causal against /debug/cycles and the query plane's
staleness coordinate system.

Retention is bounded by construction:

- **Active journeys** live in an LRU of ``capacity`` entries (knob
  ``observability.journeyLedgerCapacity``); a 50k-workload storm
  evicts the oldest-touched journeys instead of growing without bound
  (``lru_evictions`` counts them).
- **Completed journeys fold into SLIs**: at seal (full admission) the
  TTA lands in the per-class ``kueue_journey_tta_seconds{class}``
  histogram AND the existing per-CQ ``kueue_admission_wait_time`` /
  ``kueue_quota_reserved_wait_time`` — this ledger is the ONE emission
  site for those observations (the scheduler/controller delegate when
  a ledger is attached), so ``/debug/journeys`` and ``/metrics`` can
  never disagree, the way the flight recorder reconciled cycle spans with the phase
  histograms.
- **Exemplar retention**: only the ``exemplars`` slowest completed
  journeys plus recent SLO-violating ones are retained in full for
  ``/debug/journeys`` and ``tools/trace_dump.py --journey``.

A **burn-rate evaluator** prices the live SLI stream against
SLOSpec-derived objectives (``perf.checker.journey_objectives``): per
class, an EWMA of the violation indicator (1 when a sealed journey's
TTA exceeds its objective) divided by the error budget fraction —
burn rate 1.0 means violations are arriving exactly at the budgeted
rate, >1 means the budget is burning faster than allowed. Exposed as
``kueue_slo_burn_rate{class}``.

Cost contract (mirrors the flight recorder): with the ledger DISABLED
the scheduler/controller hooks are one attribute load plus an
``is None`` compare (the manager simply wires no ledger); enabled,
each hook is a span append under one lock. The ``journey_overhead``
bench row pins both at <=1% of a cycle.

The port's copy of kueue_tpu/obs/journey.py.
"""

from __future__ import annotations

import heapq
import threading
import time as _time
from collections import OrderedDict, deque
from typing import Optional

DEFAULT_JOURNEY_CAPACITY = 8192
DEFAULT_JOURNEY_EXEMPLARS = 8

# Hard per-journey span bound: a pathological workload requeued for
# thousands of cycles must not grow its timeline without limit. The
# repeat-collapse below (identical consecutive requeue spans merge
# into one span with a repeat count + covered-cycle range) keeps real
# journeys far below this; hitting the cap drops the oldest
# non-arrival span and counts it.
MAX_SPANS_PER_JOURNEY = 512

# Burn-rate evaluator defaults: the error budget is the fraction of
# sealed journeys allowed to miss their class objective (SRE-style);
# the EWMA alpha sets the evaluator's memory (~1/alpha journeys).
DEFAULT_ERROR_BUDGET = 0.05
DEFAULT_BURN_ALPHA = 0.1

# The scenario suite's priority-class label (sim/scenarios.py); plain
# deployments fall back to the workload's priorityClassName.
CLASS_LABEL = "scenario.kueue-tpu/class"
DEFAULT_CLASS = "standard"


_REASON_NAMES: dict = {}


def _reason_name(reason) -> str:
    """Memoized RequeueReason -> name (the enum descriptor lookup is
    measurable on the per-entry hot path)."""
    name = _REASON_NAMES.get(reason)
    if name is None:
        name = getattr(reason, "name", None) or str(reason)
        _REASON_NAMES[reason] = name
    return name


def workload_class(obj) -> str:
    """The SLI class of a workload: the scenario class label when
    present, else the priority class name, else "standard"."""
    labels = getattr(obj.metadata, "labels", None) or {}
    cls = labels.get(CLASS_LABEL)
    if cls:
        return cls
    cls = getattr(obj.spec, "priority_class_name", "") or ""
    return cls or DEFAULT_CLASS


class JourneySpan:
    """One step of a workload's admission journey. ``cycle`` is the
    scheduler attempt id the span was stamped under (0 = outside any
    cycle, e.g. an arrival before the first cycle), ``generation`` the
    cache's structural token at that cycle's start, ``route`` the
    cycle's route when known. ``sig`` is the internal repeat-collapse
    identity (requeue hot path), never serialized."""

    __slots__ = ("kind", "t", "cycle", "generation", "route", "fields",
                 "sig")

    def __init__(self, kind: str, t: float, cycle: int, generation: tuple,
                 route: str, fields: Optional[dict] = None):
        self.kind = kind
        self.t = t
        self.cycle = cycle
        self.generation = generation
        self.route = route
        self.fields = fields
        self.sig = None

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "t": round(self.t, 6),
             "cycle": self.cycle, "generation": list(self.generation),
             "route": self.route}
        if self.fields:
            d.update(self.fields)
        return d


class WorkloadJourney:
    __slots__ = ("key", "cluster_queue", "class_name", "created_t",
                 "spans", "sealed_t", "tta_s", "requeues", "admissions",
                 "dropped_spans")

    def __init__(self, key: str, cluster_queue: str, class_name: str,
                 created_t: float):
        self.key = key
        self.cluster_queue = cluster_queue
        self.class_name = class_name
        self.created_t = created_t
        self.spans: list = []
        self.sealed_t: Optional[float] = None
        self.tta_s: Optional[float] = None
        self.requeues = 0      # requeued/shed/deferred events
        self.admissions = 0    # seals (re-admissions after eviction)
        self.dropped_spans = 0  # spans shed by MAX_SPANS_PER_JOURNEY

    def to_dict(self) -> dict:
        return {
            "workload": self.key,
            "cluster_queue": self.cluster_queue,
            "class": self.class_name,
            "created_t": round(self.created_t, 6),
            "sealed": self.sealed_t is not None,
            "tta_s": (round(self.tta_s, 6)
                      if self.tta_s is not None else None),
            "requeues": self.requeues,
            "admissions": self.admissions,
            "dropped_spans": self.dropped_spans,
            "spans": [s.to_dict() for s in self.spans],
        }

    def timeline_complete(self) -> tuple:
        """(ok, why): the acceptance contract for an admitted journey —
        it starts at an anchor (``queued`` for an arrival; ``evicted``/
        ``preempted`` for a journey that begins at a post-admission
        eviction, whose pre-eviction life sealed and folded into the
        SLIs; any first span marked ``resumed`` for a journey whose
        arrival the LRU capacity bound shed), ends admitted, every
        span carries a cycle id and generation token, and both time
        and cycle ids are monotone (no gaps between arrival and
        admission: every step of the 40 cycles is accounted for by a
        stamped span)."""
        if not self.spans:
            return False, "no spans"
        first = self.spans[0]
        if first.kind not in ("queued", "evicted", "preempted") \
                and not (first.fields or {}).get("resumed"):
            return False, (f"first span is {first.kind!r}, "
                           "not an arrival/eviction/resumed anchor")
        last = self.spans[-1]
        if last.kind not in ("quota-reserved", "admitted"):
            return False, f"last span is {last.kind!r}, not an admission"
        prev_t, prev_c = None, None
        for s in self.spans:
            if not isinstance(s.cycle, int) or not s.generation:
                return False, f"span {s.kind!r} missing cycle/generation"
            if prev_t is not None and s.t < prev_t - 1e-9:
                return False, f"span {s.kind!r} out of time order"
            if prev_c is not None and s.cycle < prev_c:
                return False, f"span {s.kind!r} cycle id went backwards"
            prev_t, prev_c = s.t, s.cycle
        return True, ""


class JourneyLedger:
    """Bounded journey store + the SLI/burn-rate fold. Thread-safe:
    hooks arrive from the scheduler thread, the runtime's reconcilers
    and HTTP readers."""

    def __init__(self, capacity: int = DEFAULT_JOURNEY_CAPACITY,
                 exemplars: int = DEFAULT_JOURNEY_EXEMPLARS,
                 metrics=None, clock=None, generation_source=None,
                 error_budget: float = DEFAULT_ERROR_BUDGET,
                 burn_alpha: float = DEFAULT_BURN_ALPHA):
        if capacity < 1:
            raise ValueError("journey ledger capacity must be >= 1")
        if exemplars < 1:
            raise ValueError("journey exemplars must be >= 1")
        self.capacity = capacity
        self.exemplars = exemplars
        self.metrics = metrics
        self.clock = clock
        # Zero-arg callable returning the live structural generation
        # token (manager wires cache.generation_token): spans recorded
        # BEFORE the first cycle stamps one (arrivals pre-traffic)
        # fetch it lazily so every span carries a token.
        self.generation_source = generation_source
        self.error_budget = error_budget
        self.burn_alpha = burn_alpha
        self._lock = threading.Lock()
        self._active: OrderedDict = OrderedDict()   # key -> journey (LRU)
        self._slow: list = []        # min-heap of (tta, seq, journey)
        self._violations: deque = deque(maxlen=max(4 * exemplars, 32))
        self._seq = 0
        # Cycle context stamped onto every span (begin_cycle/set_route).
        # _cycle_t is read once per cycle and reused by the per-entry
        # hot hooks — a clock read per span would price the requeue
        # flood (spans within one cycle share the cycle's timestamp by
        # construction anyway).
        self._cycle = 0
        self._cycle_t = 0.0
        self._generation: tuple = ()
        self._route = ""
        # Lifetime counters (survive LRU eviction and exemplar folds).
        self.journeys_started = 0
        self.journeys_completed = 0
        self.requeues_total = 0
        self.quota_reservations = 0
        self.lru_evictions = 0
        self.unstamped_spans = 0     # spans recorded before any cycle
        # Burn-rate evaluator state: class -> (objective_s) and
        # class -> violation-indicator EWMA.
        self._objectives: dict = {}
        self._burn_ewma: dict = {}

    # -- wiring ----------------------------------------------------------

    def set_objectives(self, objectives: dict) -> None:
        """class -> target TTA seconds (perf.checker.journey_objectives
        derives these from an SLOSpec). Sealing a journey whose TTA
        exceeds its class objective counts against the error budget and
        retains the journey as a violation exemplar."""
        with self._lock:
            self._objectives = dict(objectives or {})

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else _time.time()

    # -- cycle context (scheduler) --------------------------------------

    def begin_cycle(self, cycle_id: int, generation: tuple) -> None:
        """Stamp the context every span in this cycle carries: the
        scheduler attempt id, the cache's structural generation token
        read at cycle start, and the cycle's timestamp."""
        self._cycle = cycle_id
        self._cycle_t = self._now()
        self._generation = tuple(generation)
        self._route = ""

    def set_route(self, route: str) -> None:
        self._route = route

    def seal_cycle(self) -> None:
        """Cycle end: refresh the derived gauges once per cycle (not
        per span — a requeue flood must not pay a gauge write per
        entry)."""
        m = self.metrics
        if m is not None:
            m.set_requeue_amplification(self.requeues_per_admission)

    @property
    def requeues_per_admission(self) -> float:
        """ROADMAP item 5's soak invariant: requeue-class spans per
        sealed admission. Rises without bound when a backlog churns
        without admitting (requeue pile-up); ~N for a healthy system
        whose entries wait N cycles."""
        return self.requeues_total / max(self.journeys_completed, 1)

    # -- journey mutation ------------------------------------------------

    def _journey(self, key: str, cluster_queue: str = "",
                 class_name: str = "", created_t: Optional[float] = None):
        """The active journey for ``key``, created (and LRU-touched) on
        demand. Caller holds the lock."""
        j = self._active.get(key)
        if j is not None:
            self._active.move_to_end(key)
            if cluster_queue and not j.cluster_queue:
                j.cluster_queue = cluster_queue
            if class_name and j.class_name == DEFAULT_CLASS:
                # A journey re-created mid-life (LRU eviction dropped
                # the arrival) learns its real SLI class from the first
                # hook that carries the workload object — the TTA must
                # fold into the right histogram/objective.
                j.class_name = class_name
            return j
        t = created_t if created_t is not None else self._now()
        j = WorkloadJourney(key, cluster_queue,
                            class_name or DEFAULT_CLASS, t)
        self._active[key] = j
        self.journeys_started += 1
        while len(self._active) > self.capacity:
            self._active.popitem(last=False)
            self.lru_evictions += 1
            if self.metrics is not None:
                self.metrics.journey_lru_evicted()
        return j

    @staticmethod
    def _append_span(j: WorkloadJourney, span: "JourneySpan") -> None:
        spans = j.spans
        if len(spans) >= MAX_SPANS_PER_JOURNEY:
            # Keep the arrival span (index 0) — the timeline's anchor —
            # and shed the oldest step after it.
            del spans[1]
            j.dropped_spans += 1
        if spans and span.t < spans[-1].t:
            # Monotone-by-construction: append order IS the causal
            # order; timestamps are best-effort coordinates (a workload
            # created mid-cycle carries a creation time later than the
            # cycle-start stamp its first requeue reuses) — clamp so
            # the timeline never reads backwards.
            span.t = spans[-1].t
        spans.append(span)

    def _span(self, j: WorkloadJourney, kind: str,
              fields: Optional[dict] = None,
              t: Optional[float] = None) -> None:
        if not j.spans and kind not in ("queued", "evicted", "preempted"):
            # First span of a journey created mid-life: the arrival was
            # dropped (LRU eviction under a storm past the capacity
            # bound). Mark the truncation honestly — timeline_complete
            # accepts a resumed first span as an anchor instead of
            # minting a false "incomplete" verdict for evidence the
            # bounded ledger was DESIGNED to shed.
            fields = dict(fields) if fields else {}
            fields["resumed"] = True
        if not self._generation:
            # Before the first cycle no stamped token exists yet:
            # fetch the live one so pre-traffic arrivals stay causal
            # (cycle 0 = before the first cycle, by construction).
            src = self.generation_source
            if src is not None:
                try:
                    self._generation = tuple(src())
                except Exception:  # noqa: BLE001 — stamping must not kill hooks
                    pass
            if not self._generation:
                self.unstamped_spans += 1
        self._append_span(j, JourneySpan(
            kind, t if t is not None else self._now(),
            self._cycle, self._generation, self._route, fields))

    # -- hooks: queue delta feed (queue.Manager.add_journey_listener) ----

    def note_queue_delta(self, kind: str, key: str, info) -> None:
        """'upsert' = the workload entered (or re-entered) the pending
        set; 'del' = it left. Called under the queue-manager lock —
        this only appends under the ledger's own lock, never calls
        back. Upserts of an already-tracked journey are object
        replacements (status patches) and record nothing; deletes are
        left to the LRU (an admission-driven delete precedes the
        quota-reserved span, so the key alone cannot distinguish a
        cancel from an admit here)."""
        if kind != "upsert" or info is None:
            return
        with self._lock:
            j = self._active.get(key)
            if j is not None:
                self._active.move_to_end(key)
                if j.spans and j.spans[-1].kind in ("evicted",
                                                    "preempted"):
                    # Re-entry to the pending set after an eviction:
                    # the re-admission loop's own arrival marker.
                    self._span(j, "queued", {"cq": j.cluster_queue})
                return
            obj = info.obj
            created = getattr(obj.metadata, "creation_timestamp", None)
            j = self._journey(key, getattr(info, "cluster_queue", "") or "",
                              workload_class(obj),
                              created_t=created)
            # Anchor the arrival at the journey's creation time (the
            # queued-wait clock the TTA is measured from), not the
            # notification wall time.
            self._span(j, "queued", {"cq": j.cluster_queue},
                       t=j.created_t)

    # -- hooks: scheduler ------------------------------------------------

    def requeued(self, info, status: str, reason, msg: str = "") -> None:
        """A cycle considered this entry and re-heaped it (the
        requeue_and_update choke point every non-admitted entry on
        every route passes through). ``status`` is the entry status
        ("" = failed validation/assignment before nomination).

        Hot-path contract: this fires once per non-admitted entry per
        cycle — a requeue flood's dominant hook. Consecutive identical
        requeues (same status/reason/message, the flood shape) COLLAPSE
        into the previous span: ``repeats`` counts them and
        ``last_cycle`` closes the covered range, so a 40-cycle backoff
        loop reads as one span spanning cycles [n, n+40] instead of 40
        allocations — bounded timelines AND an allocation-free flood
        path (the journey_overhead bench pins it)."""
        status = status or "not-nominated"
        reason_name = _reason_name(reason)
        msg = msg[:160] if msg else ""
        sig = (status, reason_name, msg)
        with self._lock:
            active = self._active
            j = active.get(info.key)
            if j is None:
                j = self._journey(info.key, info.cluster_queue or "")
            else:
                active.move_to_end(info.key)
            spans = j.spans
            if spans:
                last = spans[-1]
                if last.sig == sig:
                    f = last.fields
                    f["repeats"] = f.get("repeats", 1) + 1
                    f["last_cycle"] = self._cycle
                    j.requeues += 1
                    self.requeues_total += 1
                    return
            fields = {"status": status, "reason": reason_name}
            if msg:
                fields["msg"] = msg
            self._span(j, "requeued", fields, t=self._cycle_t)
            spans[-1].sig = sig
            j.requeues += 1
            self.requeues_total += 1

    def shed(self, info) -> None:
        """Head re-heaped by the degradation ladder's cap before
        nomination (deferred by shedding, not by fit). Same collapse
        as requeued — a shed storm repeats identically."""
        with self._lock:
            j = self._journey(info.key, info.cluster_queue or "")
            spans = j.spans
            if spans and spans[-1].kind == "shed" \
                    and spans[-1].fields is not None:
                f = spans[-1].fields
                f["repeats"] = f.get("repeats", 1) + 1
                f["last_cycle"] = self._cycle
            else:
                self._span(j, "shed", {"repeats": 1}, t=self._cycle_t)
            j.requeues += 1
            self.requeues_total += 1

    # NOTE: deferred preempt planning (the ladder's shed/survival rung)
    # carries NO separate span kind: the deferred entry still passes
    # through requeue_and_update the same cycle, and its requeued span's
    # message ("Preemption planning deferred (load shedding)") IS the
    # deferral evidence — identical messages collapse, so a long
    # deferral loop reads as one span instead of two-per-cycle
    # interleaved kinds that neither collapse could absorb.

    def quota_reserved(self, wl, cq: str, wait_s: float,
                       admitted: bool) -> None:
        """THE emission site for the reservation-time SLIs (satellite:
        reconcile-by-construction): observes
        kueue_quota_reserved_wait_time (+ admission_wait_time when the
        workload admits in the same write) and stamps the journey, so
        /metrics and /debug/journeys share one producer. ``admitted``
        seals the journey."""
        from kueue_tpu_torch.core import workload as wlpkg
        key = wlpkg.key(wl)
        m = self.metrics
        if m is not None:
            m.quota_reserved(cq, wait_s)
            if admitted:
                m.admitted(cq, wait_s)
        with self._lock:
            j = self._journey(key, cq, workload_class(wl))
            self.quota_reservations += 1
            self._span(j, "quota-reserved", {"cq": cq,
                                             "wait_s": round(wait_s, 6)})
            if admitted:
                self._seal(j, wait_s)

    def admitted_after_checks(self, wl, cq: str, wait_s: float,
                              checks_wait_s: float) -> None:
        """THE emission site for check-gated admissions (the workload
        controller's Admitted flip): observes admission_wait_time +
        admission_checks_wait_time and seals the journey."""
        from kueue_tpu_torch.core import workload as wlpkg
        key = wlpkg.key(wl)
        m = self.metrics
        if m is not None:
            # Observe even with an unknown CQ (empty label — the LQ/CQ
            # was deleted between reservation and the Admitted flip):
            # the reconcile-by-construction invariant is
            # histogram-count == completed-journeys, and a seal without
            # its observation would break exactly the parity this
            # emission site exists to guarantee.
            m.admitted_workload(cq, wait_s)
            m.admission_checks_wait_time.observe(checks_wait_s,
                                                 cluster_queue=cq)
        with self._lock:
            j = self._journey(key, cq, workload_class(wl))
            self._span(j, "admitted",
                       {"cq": cq, "wait_s": round(wait_s, 6),
                        "checks_wait_s": round(checks_wait_s, 6)})
            self._seal(j, wait_s)

    def evicted(self, key: str, cq: str, reason: str) -> None:
        """Eviction re-opens the workload's journey. When the previous
        life already sealed (folded into the SLIs and dropped from the
        active set), this starts a NEW journey anchored at the
        eviction — the re-queue that follows appends its own ``queued``
        span (note_queue_delta), and the next seal counts the
        re-admission."""
        with self._lock:
            j = self._journey(key, cq)
            j.sealed_t = None
            self._span(j, "evicted", {"cq": cq, "reason": reason})

    def preempted(self, key: str, preempting_cq: str, reason: str) -> None:
        """Like evicted(): the victim's journey (or its fresh
        post-admission successor) records who preempted it and why."""
        with self._lock:
            j = self._journey(key)
            j.sealed_t = None
            self._span(j, "preempted", {"by": preempting_cq,
                                        "reason": reason})

    # -- hooks: MultiKueue planned-mirror lifecycle ----------------------

    def mk_event(self, key: str, event: str, cluster: str = "") -> None:
        """event in ("planned", "executed", "expired"): the batched
        cross-cluster placement lifecycle, stamped with the cluster so
        journeys stay causal across the mesh."""
        with self._lock:
            j = self._journey(key)
            fields = {"cluster": cluster} if cluster else None
            self._span(j, f"mk-{event}", fields)

    # -- seal + exemplar fold --------------------------------------------

    def _seal(self, j: WorkloadJourney, tta_s: float) -> None:
        """Full admission: fold the journey into the SLIs, retain it as
        an exemplar if it is among the K slowest or violates its class
        objective, and drop it from the active LRU. Caller holds the
        lock."""
        j.sealed_t = self._now()
        j.tta_s = tta_s
        j.admissions += 1
        self.journeys_completed += 1
        m = self.metrics
        if m is not None:
            m.journey_completed(j.class_name, tta_s)
        # Burn rate: EWMA of the violation indicator vs the budget.
        obj = self._objectives.get(j.class_name)
        if obj is not None:
            hit = 1.0 if tta_s > obj else 0.0
            prev = self._burn_ewma.get(j.class_name, 0.0)
            ewma = prev + self.burn_alpha * (hit - prev)
            self._burn_ewma[j.class_name] = ewma
            if m is not None:
                m.set_slo_burn(j.class_name,
                               ewma / max(self.error_budget, 1e-9))
            if hit:
                self._violations.append(j)
        # K-slowest exemplars (min-heap on TTA).
        self._seq += 1
        entry = (tta_s, self._seq, j)
        if len(self._slow) < self.exemplars:
            heapq.heappush(self._slow, entry)
        elif tta_s > self._slow[0][0]:
            heapq.heapreplace(self._slow, entry)
        self._active.pop(j.key, None)

    # -- consumers (/debug/journeys, probe, tests) -----------------------

    def journey_dict(self, key: str) -> Optional[dict]:
        """Point lookup serialized UNDER the ledger lock: an active
        journey mutates on the scheduler thread (span appends, collapse
        field updates, the span-cap del), so HTTP readers must
        materialize the wire form while holding the lock — handing the
        live object out and serializing it later tears mid-flood."""
        with self._lock:
            j = self._journey_locked(key)
            return j.to_dict() if j is not None else None

    def journey(self, key: str) -> Optional[WorkloadJourney]:
        """Point lookup: the active journey first, else the MOST RECENT
        retained one (a re-admitted workload can have several sealed
        lives among the exemplars — the newest is the one an operator
        is asking about). Accepts a full "ns/name" key or a bare name.
        NOTE: an active journey keeps mutating — use journey_dict()
        from reader threads."""
        with self._lock:
            return self._journey_locked(key)

    def _journey_locked(self, key: str) -> Optional[WorkloadJourney]:
        j = self._active.get(key)
        if j is None and "/" not in key:
            for k, cand in self._active.items():
                if k.split("/", 1)[-1] == key:
                    j = cand
                    break
        if j is not None:
            return j

        def matches(cand):
            return (cand.key == key
                    or cand.key.split("/", 1)[-1] == key)

        best = None
        for _tta, _seq, cand in self._slow:
            if matches(cand) and (best is None
                                  or cand.sealed_t > best.sealed_t):
                best = cand
        for cand in self._violations:
            if matches(cand) and (best is None
                                  or cand.sealed_t > best.sealed_t):
                best = cand
        return best

    def slowest(self, n: int = 0) -> list:
        """The retained slowest completed journeys, slowest first."""
        with self._lock:
            out = [j for _tta, _seq, j in sorted(self._slow, reverse=True)]
        return out[:n] if n > 0 else out

    def violations(self) -> list:
        with self._lock:
            return list(self._violations)

    def burn_rates(self) -> dict:
        with self._lock:
            return self._burn_rates_locked()

    def _burn_rates_locked(self) -> dict:
        return {cls: round(e / max(self.error_budget, 1e-9), 4)
                for cls, e in self._burn_ewma.items()}

    @property
    def retained(self) -> int:
        """Journeys currently held (active + exemplars + violations) —
        the leak detector: zero after close()."""
        with self._lock:
            return len(self._active) + len(self._slow) + len(self._violations)

    def status(self) -> dict:
        """The single producer /debug/journeys, the SIGUSR2 dumper,
        tools/journey_probe.py and tests share."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "exemplars": self.exemplars,
                "active": len(self._active),
                "started": self.journeys_started,
                "completed": self.journeys_completed,
                "quota_reservations": self.quota_reservations,
                "requeues": self.requeues_total,
                "requeues_per_admission": round(
                    self.requeues_per_admission, 4),
                "lru_evictions": self.lru_evictions,
                "unstamped_spans": self.unstamped_spans,
                "violations_retained": len(self._violations),
                "objectives": dict(self._objectives),
                "burn_rates": self._burn_rates_locked(),
                "cycle": self._cycle,
            }

    def close(self) -> None:
        """Shutdown: drop every retained journey (active, exemplars,
        violations) — the ledger's leak contract is zero retained
        journeys after shutdown, mirroring cache.live_handouts."""
        with self._lock:
            self._active.clear()
            self._slow.clear()
            self._violations.clear()
