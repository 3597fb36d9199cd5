"""Operator debug surface: structured status snapshots of the solver
plane (breaker, adaptive router, encode arena, flight recorder), shared
by the ``VisibilityServer``'s ``/debug/*`` endpoints, the SIGUSR2
``Dumper``, and tests — one producer per subsystem so every consumer
shows the same numbers.

The port's copy of kueue_tpu/obs/status.py: pure functions over the
Scheduler, the solver and the Registry; the port has no HTTP server
and no dumper yet, so `DebugEndpoints.handle` is their only caller.
"""

from __future__ import annotations

from typing import Optional


def breaker_status(scheduler) -> dict:
    """Circuit-breaker state for operators:
    the route the breaker currently pins, consecutive faults, and the
    next-probe backoff — plus the outage/recovery counters."""
    b = scheduler.breaker
    st = b.status()
    st["route"] = "device" if st["state"] == "closed" else "cpu-breaker"
    st["next_probe_in_s"] = (
        0.0 if st["state"] == "closed"
        else max(0.0, round(st["retry_at"] - scheduler.clock.now(), 3)))
    st["solver_faults_total"] = scheduler.solver_faults
    st["cpu_breaker_cycles"] = scheduler.cycle_counts.get("cpu-breaker", 0)
    solver = scheduler.solver
    if solver is not None and hasattr(solver, "_supervisor"):
        # Supervised-dispatch worker (resilience/supervisor.py): how
        # many dispatches were handed off / abandoned.
        st["supervised_dispatch"] = solver._supervisor.status()
        st["supervised_timeouts"] = solver.counters.get(
            "supervised_timeouts", 0)
    return st


def degrade_status(scheduler) -> dict:
    """Degradation-ladder state for operators (/debug/degrade): the
    rung, cycle-time EWMA vs budget, hysteresis/recovery knobs, and the
    shed bookkeeping — the SAME producer the flight-recorder
    annotations and the degraded_state gauge are fed from, so every
    consumer shows the same numbers."""
    st = scheduler.ladder.status()
    st["shed_heads_requeued_total"] = scheduler.shed_heads_requeued
    st["preempt_plans_deferred_total"] = scheduler.preempt_plans_deferred
    st["survival_cycles"] = scheduler.cycle_counts.get("cpu-survival", 0)
    return st


def router_status(scheduler) -> dict:
    """Adaptive-router internals: per (engine, regime) progress/secs
    samples with the median rate the next routing decision will use."""
    regimes = {}
    # Materialize before iterating: this runs on the HTTP/dumper thread
    # while the scheduler thread inserts samples — list() is atomic
    # under the GIL, a Python-level loop over the live dict is not.
    for (engine, regime), samples in list(scheduler._route_stats.items()):
        samples = list(samples)
        rates = sorted(a / max(t, 1e-9) for a, t in samples)
        secs = sorted(t for _a, t in samples)
        regimes[f"{engine}/{regime}"] = {
            "samples": [[a, round(t, 6)] for a, t in samples],
            "median_rate_per_s": (round(rates[len(rates) // 2], 3)
                                  if rates else None),
            "median_cycle_s": (round(secs[len(secs) // 2], 6)
                               if secs else None),
        }
    return {
        "routing": scheduler.solver_routing,
        "last_regime": scheduler._last_regime,
        "explore_counts": dict(scheduler._route_explore),
        "cycle_counts": dict(scheduler.cycle_counts),
        "regimes": regimes,
        # last device preempt-plan solve: candidate pool size, prefix
        # scanned / heap pops, fill-back auction rounds, filled back —
        # per program (minimal / fair); {} until a batched preemption
        # cycle has run (solver/PREEMPT.md)
        "preempt_plan": dict(getattr(scheduler, "last_preempt_plan", {})),
    }


def pipeline_status(scheduler) -> dict:
    """Speculative-pipeline state (/debug/pipeline): coverage (how many
    device cycles were overlapped), speculation hit/abort outcomes by
    validation reason, and whether a cycle is in flight right now —
    fed from the same counters the perf artifacts report, so the
    ``pipelined_hit_rate`` story is checkable live."""
    counts = scheduler.cycle_counts
    pipelined = counts.get("device-pipelined", 0)
    device_sync = counts.get("device", 0)
    total = pipelined + device_sync
    return {
        "enabled": scheduler.pipeline_enabled,
        "inflight": scheduler._inflight is not None,
        "depth": scheduler.pipeline_depth,
        "inflight_depth": len(scheduler._inflight_q),
        "cooldown": scheduler._pipeline_cooldown,
        "pipelined_cycles": pipelined,
        "sync_device_cycles": device_sync,
        "pipelined_hit_rate": (round(pipelined / total, 3)
                               if total else None),
        "speculation_hits": scheduler.speculation_hits,
        "speculation_aborts": scheduler.speculation_aborts,
        "abort_reasons": dict(scheduler.speculation_abort_reasons),
        "allow_pipeline_degraded": scheduler.ladder.allow_pipeline,
    }


def warmup_status(scheduler) -> dict:
    """Compile-governor state (/debug/warmup): the warm-state machine,
    the per-bucket ladder with compile provenance (fresh / cache-hit /
    jit-cache), warmup faults, and how many cycles the route gate
    diverted to cpu-warmup — the same producer tools/warm_probe.py and
    the SIGUSR2 dumper print, so every consumer shows the same numbers.
    See solver/COMPILE.md."""
    gov = getattr(scheduler, "warm_gov", None)
    if gov is None:
        return {"attached": False}
    st = gov.status()
    st["attached"] = True
    st["cpu_warmup_cycles"] = scheduler.cycle_counts.get("cpu-warmup", 0)
    return st


def recovery_status(scheduler) -> dict:
    """Crash-restart recovery report (/debug/recovery): what the last
    restore() rebuilt from the durable store — checkpoint/WAL replay
    provenance (incl. torn-tail fallbacks), restored object counts,
    admitted-vs-pending workload split, and the rebuild duration
    (RESILIENCE.md §6). ``restored`` False = this process never
    recovered (a cold start)."""
    rep = getattr(scheduler, "last_recovery", None)  # (no restore() yet)
    out = {"restored": rep is not None}
    if rep is not None:
        out.update(rep)
    # Hot-standby surface (resilience/replica.py + RESILIENCE.md §7):
    # a StandbyReplica wires its status producer onto the scheduler —
    # on the follower it reports role/lag/cursor, and it carries
    # through promotion (role flips to "leader"); promote() stamps its
    # own report alongside. Absent = no replication regime.
    std = getattr(scheduler, "standby_status", None)
    if std is not None:
        out["standby"] = std()
    prom = getattr(scheduler, "last_promotion", None)
    if prom is not None:
        out["promotion"] = prom
    return out


def queryplane_status(scheduler) -> dict:
    """Snapshot-backed query plane state (/debug/queryplane): the
    sealed view's cycle/generation/age, token lag vs the live cache,
    reader borrow/table counters, and whether the plane still holds a
    snapshot handout — the same producer tools/visibility_probe.py and
    tests read, so every consumer shows the same numbers. ``attached``
    False = reads fall back to the live visibility API."""
    plane = getattr(scheduler, "query_plane", None)
    if plane is None:
        return {"attached": False}
    st = plane.status()
    st["attached"] = True
    return st


def journey_status(scheduler) -> dict:
    """Workload journey ledger state (/debug/journeys, without
    exemplars — the endpoint adds those): retention counters, the
    requeue-amplification ratio and per-class burn rates, from the
    SAME producer tools/journey_probe.py and tests read. ``attached``
    False = no ledger wired (observability.journeyEnable off)."""
    led = getattr(scheduler, "journeys", None)
    if led is None:
        return {"attached": False}
    st = led.status()
    st["attached"] = True
    return st


def aging_status(scheduler) -> dict:
    """Aging-watch verdicts (/debug/aging): per-monitor value, slope
    EWMA and verdict over the monotone resources ROADMAP item 5 gates
    on (live handouts, WAL compaction, arena occupancy, requeue
    amplification, mid-traffic compiles, RSS), plus the machine-
    readable ``gate`` dict ({ok, failing, verdicts}) the soak harness
    and scenario results consume — one green/red contract, whether
    read over HTTP or in-process. ``attached`` False = no watch wired
    (bare scheduler)."""
    watch = getattr(scheduler, "aging", None)
    if watch is None:
        return {"attached": False}
    st = watch.status()
    st["attached"] = True
    return st


def shards_status(scheduler) -> dict:
    """Sharded-control-plane layout (/debug/shards): the live shard
    plan (fingerprint, unit->shard bins, load imbalance), rebalance
    count, and per-shard state/epoch/backlog/admission counters — the
    SAME producer tools/shard_probe.py and the SIGUSR2 dumper read, so
    every consumer shows the same numbers (RESILIENCE.md §9). The
    plane wires its status() onto the scheduler it fronts; ``attached``
    False = this process runs a single unsharded manager."""
    prod = getattr(scheduler, "shards_status", None)
    if prod is None:
        return {"attached": False}
    st = prod()
    st["attached"] = True
    return st


def arena_status(solver) -> dict:
    """Encode-arena slot occupancy and churn counters."""
    arena = getattr(solver, "_arena", None)
    if arena is None:
        return {"bound": False}
    free = len(arena.free)
    return {
        "bound": getattr(solver, "_queues", None) is not None,
        "cap": arena.cap,
        "high_water": arena.size,
        "occupied": arena.size - free,
        "free": free,
        "dirty": len(arena.dirty),
        "encoded_rows": arena.encoded_rows,
        "gathers": arena.gathers,
        "full_uploads": arena.full_uploads,
        "row_uploads": arena.row_uploads,
        "device_twin": arena.dev is not None,
    }


class DebugEndpoints:
    """Route table for the VisibilityServer's operator endpoints.

    ``handle(path, params)`` returns a JSON-able payload, None for an
    unknown ``/debug/*`` path (404), and raises ValueError on bad query
    parameters (400). ``metrics_text()`` backs ``/metrics``.
    """

    def __init__(self, scheduler, metrics=None):
        self.scheduler = scheduler
        self.metrics = metrics

    def metrics_text(self) -> Optional[str]:
        return self.metrics.dump() if self.metrics is not None else None

    def handle(self, path: str, params: dict) -> Optional[dict]:
        payload = self._dispatch(path, params)
        if payload is not None:
            # Every /debug payload reports the structural generation
            # token it rendered under: operators
            # correlating a debug dump against query-plane responses
            # need the same staleness coordinate system on both.
            payload.setdefault(
                "generation",
                list(self.scheduler.cache.generation_token()))
        return payload

    def _dispatch(self, path: str, params: dict) -> Optional[dict]:
        if path == "/debug/cycles":
            return self._cycles(params)
        if path == "/debug/breaker":
            return breaker_status(self.scheduler)
        if path == "/debug/degrade":
            return degrade_status(self.scheduler)
        if path == "/debug/router":
            return router_status(self.scheduler)
        if path == "/debug/pipeline":
            return pipeline_status(self.scheduler)
        if path == "/debug/warmup":
            return warmup_status(self.scheduler)
        if path == "/debug/recovery":
            return recovery_status(self.scheduler)
        if path == "/debug/queryplane":
            return queryplane_status(self.scheduler)
        if path == "/debug/journeys":
            return self._journeys(params)
        if path == "/debug/aging":
            return aging_status(self.scheduler)
        if path == "/debug/shards":
            return shards_status(self.scheduler)
        if path == "/debug/arena":
            if self.scheduler.solver is None:
                return {"bound": False}
            return arena_status(self.scheduler.solver)
        return None

    def _journeys(self, params: dict):
        """/debug/journeys: the ledger's status + slowest-exemplar and
        violation timelines (``?n=K`` limits exemplars), or one full
        journey with ``?wl=<ns/name|name>``. Bad ``n`` -> ValueError
        (400); unknown workload (or no ledger) -> None (404) — the
        same DebugEndpoints contract every other route honors."""
        led = getattr(self.scheduler, "journeys", None)
        wl = params.get("wl")
        if wl is not None:
            if led is None:
                return None
            # journey_dict serializes under the ledger lock: an ACTIVE
            # journey mutates on the scheduler thread mid-flood.
            j = led.journey_dict(wl)
            if j is None:
                return None  # 404: unknown workload
            return {"journey": j}
        payload = journey_status(self.scheduler)
        if led is None:
            return payload
        n = int(params.get("n", led.exemplars))   # ValueError -> 400
        if n < 0:
            raise ValueError("n must be >= 0")
        # n=0 means zero exemplars, not "all" (slicing with [:0]/[-0:]
        # would invert the limit).
        payload["slowest"] = [j.to_dict() for j in led.slowest()[:n]]
        viol = led.violations()[-n:] if n > 0 else []
        payload["violations"] = [j.to_dict() for j in viol]
        return payload

    def _cycles(self, params: dict) -> dict:
        rec = self.scheduler.recorder
        slowest = int(params.get("slowest", 0))   # ValueError -> 400
        n = int(params.get("n", 0))
        if slowest < 0 or n < 0:
            raise ValueError("slowest/n must be >= 0")
        traces = rec.slowest(slowest) if slowest else rec.traces(n)
        return {
            "enabled": rec.enabled,
            "capacity": rec.capacity,
            "cycles_recorded": rec.cycles_recorded,
            "order": "slowest-first" if slowest else "oldest-first",
            "cycles": [t.to_dict() for t in traces],
        }
