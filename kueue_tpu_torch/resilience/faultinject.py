"""Seedable fault injection for the solver's device path.

The port of kueue_tpu/resilience/faultinject.py, with the same sites,
actions and seeded schedules (a seed gives the JAX package's schedule).
Named injection sites wrap the places a failing card can hurt the
admission cycle:

- ``device_dispatch``  — the cycle's launches (BatchSolver.dispatch)
- ``device_collect``   — the decisions' fetch (BatchSolver.collect)
- ``arena_scatter``    — the encode arena's changed-row scatter (K7a)
- ``journal_replay``   — the solver's residency journal reconcile
- ``speculation_validate``, ``compile_warmup``, ``store_write``,
  ``apply_commit`` — the JAX package's speculative pipeline, compile
  governor, durable store and crash-restart sites; the port's paths do
  not reach them yet, but they keep their place in SITES so a seeded
  ``scripted()`` schedule is the JAX package's.

Each site can, per a deterministic scripted schedule, RAISE, DELAY (a
wedged call: the watchdog's regime), CORRUPT the payload passing
through it (with the call site's own ``corrupt=`` callable, so every
site scrambles exactly the data that crosses it), or CRASH: simulate
process death by raising ``InjectedCrash``, a ``BaseException`` that no
containment layer absorbs.

Off by default at the cost of one global ``is None`` check per site.

Schedules are deterministic. ``FaultInjector({site: {hit: action}})``
fires ``action`` on the hit-th time the site is reached (0-based);
``FaultInjector.scripted(seed, ...)`` derives such a schedule from a
seeded RNG so randomized chaos runs are exactly reproducible.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

SITE_DISPATCH = "device_dispatch"
SITE_COLLECT = "device_collect"
SITE_SCATTER = "arena_scatter"
SITE_REPLAY = "journal_replay"
# Speculative-pipeline validation (scheduler._process_inflight): a RAISE
# here is a FORCED MIS-SPECULATION — the abort path must fall back to
# the synchronous cycle with no double admission. Last in SITES so
# seeded scripted() schedules for the original four sites are unchanged.
SITE_SPECULATION = "speculation_validate"
# Compile-governor warmup (solver/warmgov.py): fires once per bucket
# warm attempt, OFF the scheduler thread — a fault here must only cost
# that bucket, never a cycle. Appended after SITE_SPECULATION so seeded
# scripted() schedules for the earlier sites are unchanged.
SITE_WARMUP = "compile_warmup"
# Crash-restart sites. Appended last so seeded
# scripted() schedules for the earlier sites are unchanged; scripted()
# defaults them to rate 0 (a crash ends the run — the kill-point sweep
# schedules them explicitly, one seeded (site, hit) per run).
SITE_STORE = "store_write"
SITE_APPLY = "apply_commit"
SITES = (SITE_DISPATCH, SITE_COLLECT, SITE_SCATTER, SITE_REPLAY,
         SITE_SPECULATION, SITE_WARMUP, SITE_STORE, SITE_APPLY)

RAISE = "raise"
DELAY = "delay"
CORRUPT = "corrupt"
# Simulated process death: raises InjectedCrash (a BaseException) that
# no fallback/containment layer may catch — valid at EVERY site.
CRASH = "crash"
ACTIONS = (RAISE, DELAY, CORRUPT, CRASH)


class DeviceFault(RuntimeError):
    """A contained device-path failure: dispatch/collect raised, the
    watchdog timed out, or output validation caught corruption. The
    scheduler feeds these to the circuit breaker; host-side encode bugs
    deliberately do NOT subclass this."""


class InjectedFault(DeviceFault):
    """Raised by a ``raise`` action at an injection site."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at {site} (hit {hit})")
        self.site = site
        self.hit = hit


class InjectedCrash(BaseException):
    """Simulated process death at an injection site. Deliberately a
    BaseException (like KeyboardInterrupt): every ``except Exception``
    containment layer on the way up — solver fallbacks, the breaker
    feed, admission error wrapping — must let it through, because a
    real SIGKILL gives none of them a turn. Only the crash-restart
    harness at the very top of the driving loop catches it, throws the
    manager away, and restores from the durable store."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected crash at {site} (hit {hit})")
        self.site = site
        self.hit = hit


class FaultInjector:
    """A scripted schedule of faults, keyed (site, hit index).

    ``schedule``: {site: {hit_index: action}} where action is ``RAISE``,
    ``CORRUPT``, or ``(DELAY, seconds)``. Hit indices are 0-based per
    site and count every time the site is reached while this injector
    is installed.
    """

    def __init__(self, schedule: Optional[dict] = None):
        self.schedule: dict = {}
        for site, hits in (schedule or {}).items():
            if site not in SITES:
                raise ValueError(f"unknown injection site {site!r}")
            self.schedule[site] = dict(hits)
        self._lock = threading.Lock()
        self.hits: dict = {s: 0 for s in SITES}     # site -> times reached
        self.fired: dict = {s: 0 for s in SITES}    # site -> faults fired
        self.log: list = []                          # (site, hit, action)

    @classmethod
    def scripted(cls, seed: int, horizon: int = 64,
                 rates: Optional[dict] = None,
                 delay_s: float = 0.0) -> "FaultInjector":
        """A reproducible randomized schedule: for each site, each of
        the first ``horizon`` hits independently faults with the site's
        rate (default 0.2). Which action fires is drawn from the
        actions valid at that site (DELAY only where a deadline can
        catch it, CORRUPT only where a payload crosses). Same seed =>
        same schedule, regardless of execution interleaving."""
        rng = random.Random(seed)
        valid = {
            SITE_DISPATCH: (RAISE, (DELAY, delay_s)) if delay_s else (RAISE,),
            SITE_COLLECT: ((RAISE, CORRUPT, (DELAY, delay_s)) if delay_s
                           else (RAISE, CORRUPT)),
            SITE_SCATTER: (RAISE, CORRUPT),
            SITE_REPLAY: (RAISE,),
            SITE_SPECULATION: (RAISE,),  # forced mis-speculation
            # a wedged warmup compile (DELAY) is the governor's own
            # deadline's regime; RAISE is a backend error mid-warm
            SITE_WARMUP: (RAISE, (DELAY, delay_s)) if delay_s else (RAISE,),
            # crash-only sites: a crash ends the run, so scripted
            # schedules default them OFF (rate 0 below) — the kill-point
            # sweep installs explicit {site: {hit: CRASH}} schedules
            SITE_STORE: (CRASH,),
            SITE_APPLY: (CRASH,),
        }
        default_rate = {SITE_STORE: 0.0, SITE_APPLY: 0.0}
        schedule: dict = {}
        for site in SITES:
            rate = (rates or {}).get(site, default_rate.get(site, 0.2))
            hits = {}
            for i in range(horizon):
                if rng.random() < rate:
                    hits[i] = rng.choice(valid[site])
            if hits:
                schedule[site] = hits
        return cls(schedule)

    def _next(self, site: str):
        with self._lock:
            hit = self.hits[site]
            self.hits[site] = hit + 1
            action = self.schedule.get(site, {}).get(hit)
            if action is not None:
                self.fired[site] += 1
                self.log.append((site, hit, action))
            return hit, action

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())


# The one global the disabled path reads; module attribute access is
# the entire per-site cost when no injector is installed.
_active: Optional[FaultInjector] = None

# Scoped arming: co-resident managers — N admission
# shards in one process — each arm their OWN injector under a scope
# name, entered for the duration of that manager's cycle via the
# ``scope(...)`` context manager. Inside a scope, ONLY that scope's
# injector fires (a shard sweep killing shard 2 must not consume shard
# 0's scripted schedule); outside any scope only the module-global
# injector fires — the pre-shard contract, unchanged. The current
# scope is thread-local: shard cycles on different threads never see
# each other's arming.
_scoped: dict = {}
_scope_local = threading.local()


def install(injector: FaultInjector,
            scope: Optional[str] = None) -> FaultInjector:
    global _active
    if scope is not None:
        _scoped[scope] = injector
        return injector
    _active = injector
    return injector


def uninstall(scope: Optional[str] = None) -> None:
    global _active
    if scope is not None:
        _scoped.pop(scope, None)
        return
    _active = None


def active(scope: Optional[str] = None) -> Optional[FaultInjector]:
    if scope is not None:
        return _scoped.get(scope)
    return _active


def current_scope() -> Optional[str]:
    return getattr(_scope_local, "name", None)


class installed:
    """Context manager: install an injector for the block's duration
    (module-global by default, or under ``scope``)."""

    def __init__(self, injector: FaultInjector,
                 scope: Optional[str] = None):
        self.injector = injector
        self.scope = scope

    def __enter__(self) -> FaultInjector:
        return install(self.injector, scope=self.scope)

    def __exit__(self, *exc) -> None:
        uninstall(scope=self.scope)


class scope:
    """Context manager: attribute every ``site()`` hit on this thread
    to ``name``'s scoped injector for the block's duration. With no
    injector armed under ``name`` the sites are inert inside the block
    — the module-global injector does NOT leak in, which is the
    isolation property the shard sweep relies on. Re-entrant nesting
    restores the outer scope on exit."""

    def __init__(self, name: str):
        self.name = name
        self._outer: Optional[str] = None

    def __enter__(self) -> "scope":
        self._outer = getattr(_scope_local, "name", None)
        _scope_local.name = self.name
        return self

    def __exit__(self, *exc) -> None:
        _scope_local.name = self._outer


def site(name: str, payload=None,
         corrupt: Optional[Callable] = None):
    """The injection hook. Returns ``payload`` (possibly corrupted).

    With no injector installed this is a single global load + compare —
    the zero-cost default. With one installed: a RAISE action raises
    InjectedFault, ``(DELAY, s)`` sleeps ``s`` (simulating a wedged
    device call — the watchdog deadline is expected to fire), CORRUPT
    returns ``corrupt(payload)`` (or the payload untouched when the
    call site passed no corruptor — e.g. raise-only sites). Inside a
    ``scope(...)`` block the hit resolves against that scope's
    injector alone; outside, against the module-global one."""
    cur = getattr(_scope_local, "name", None)
    inj = _scoped.get(cur) if cur is not None else _active
    if inj is None:
        return payload
    hit, action = inj._next(name)
    if action is None:
        return payload
    if action == RAISE:
        raise InjectedFault(name, hit)
    if action == CRASH:
        raise InjectedCrash(name, hit)
    if action == CORRUPT:
        return corrupt(payload) if corrupt is not None else payload
    kind, seconds = action
    if kind != DELAY:
        raise ValueError(f"unknown injected action {action!r}")
    time.sleep(seconds)
    return payload
