"""Compile governor: the shape-bucket warm ladder and the Scheduler's
"cpu-warmup" route gate.

The port of kueue_tpu/solver/warmgov.py, with the JAX package's API
(`route_ready`, `request`, `start`, `stop`, `run_sync`, `status`, the
bucket states, the SITE_WARMUP fault site) and its pure ladder functions
copied as they are (`width_ladder`, `rank_ladder`, `parse_shape_rung`,
`preempt_shape_ladder`, `snapshot_cohort_members`). The governor walks
the ladder largest-first on a supervised background thread (or on the
caller's, `run_sync`), each bucket under a deadline: the solver's
`warm_router`, `warm_bucket`, `warm_scatter` (on the largest bucket) and,
with `warm_preempt`, `warm_preempt_bucket` over the preemption shape
ladder. Until a width's bucket is warm the Scheduler routes its cycles
"cpu-warmup" (the CPU path, full reference semantics) and asks the
governor for it (`request`).

Nothing on the card is compiled per shape: the hand-written kernels
build whole, once, when a BatchSolver is made there, and take every
shape as a launch argument. So a solver on the card (whose
`warm_ladder` is False) is warm from `start()`: the gate never
diverts a cycle, no bucket is walked, and `status()` reports where the
kernels came from (`source`), as the JAX governor treats a mesh
(kueue_tpu/solver/warmgov.py:554). On the CPU, which the paired tests
hold against the JAX package, the governor walks the JAX ladder: each
warm runs each program's plain version once at the bucket's shapes on
inert rows and registers the JAX package's program keys, so that the
solver's `mid_traffic_compiles` counts what the JAX package would have
compiled mid-traffic. Departures from the JAX governor:

- Provenance reads the kernel build (solver/_build.py's EVENTS), not
  jax's compilation-cache events: "fresh" if nvcc ran (in the warm, or
  in this process for the card's `source`), "cache-hit" if the
  libraries asked for were found built in `_build/`, else "jit-cache"
  (every bucket of a walk on the CPU, which builds nothing).
- No per-topology cache directory (`cache_dir`, `cache_subdir`,
  `topology_fingerprint`, `_stamp_cache_dir`): there is no persistent
  compilation cache to stamp.
- Containment is narrowed to DeviceFault (an injected fault at
  SITE_WARMUP, a DispatchTimeout of the bucket's deadline): counted and
  retried at the ladder's tail, then skipped. The JAX governor contains
  any Exception, which would send every cycle to "cpu-warmup" forever
  after an nvcc failure or a CUDA error and hide the kernel. Any other
  exception propagates from `run_sync`; from the background walk it is
  kept and raised on the Scheduler's next `route_ready` or `request`.
- The walk's snapshot is released once the warm context is built.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

from kueue_tpu_torch.resilience import faultinject
from kueue_tpu_torch.resilience.faultinject import DeviceFault
from kueue_tpu_torch.resilience.supervisor import SupervisedWorker
from kueue_tpu_torch.resilience.watchdog import DispatchTimeout
from kueue_tpu_torch.solver import _build
from kueue_tpu_torch.solver.encode import _bucket

# governor states (the warmup_state gauge encoding)
GOV_IDLE = "idle"        # never engaged: the route gate is inert
GOV_WARMING = "warming"  # ladder walk in progress
GOV_WARM = "warm"        # every bucket warm
GOV_PARTIAL = "partial"  # walk finished with skipped/failed buckets
WARMUP_STATE_CODES = {GOV_IDLE: 0, GOV_WARMING: 1, GOV_WARM: 2,
                      GOV_PARTIAL: 3}

# per-bucket states
B_PENDING = "pending"
B_WARMING = "warming"
B_WARM = "warm"
B_FAILED = "failed"    # faulted, retry scheduled at the ladder tail
B_SKIPPED = "skipped"  # gave up after max_attempts

DEFAULT_BUCKET_DEADLINE_S = 120.0
DEFAULT_MAX_WIDTH = 2048
DEFAULT_MAX_ATTEMPTS = 2


def build_source(since: Optional[dict] = None) -> str:
    """Where the kernels came from since `since` (a copy of
    _build.EVENTS; None: since the process began): "fresh" if nvcc ran,
    "cache-hit" if the libraries asked for were found built in
    `_build/`, else "jit-cache"."""
    since = since or {"builds": 0, "found": 0}
    if _build.EVENTS["builds"] > since["builds"]:
        return "fresh"
    if _build.EVENTS["found"] > since["found"]:
        return "cache-hit"
    return "jit-cache"


# --- ladder derivation (copied as they are from kueue_tpu/solver/warmgov.py) ---

def width_ladder(num_cqs: int, max_width: int = DEFAULT_MAX_WIDTH) -> list:
    """Geometric batch-width bucket ladder, largest-impact-first: the
    full-backlog bucket plus every drain bucket below it (encode
    buckets by powers of 4 from 8). ``heads()`` pops at most one head
    per CQ, so the full bucket is min(max_width, num_cqs)."""
    full = max(1, min(max_width, num_cqs))
    widths, b = [], 8
    while True:
        widths.append(b)
        if b >= full:
            break
        b *= 4
    widths.reverse()
    return widths


def rank_ladder(cohort_members: dict) -> tuple:
    """Conflict-domain rank buckets from the real topology: ``heads()``
    pops one head per CQ, so a batch's largest conflict domain is the
    largest cohort's CQ count, bucketed the way kernel.max_rank_bound
    buckets (powers of 4 from 8). The whole ladder from 8 through one
    bucket past the bound is warmed — drain-phase cycles can observe
    any smaller domain, and a cohort-less CQ tail can nudge the bound
    up."""
    bound = 8
    while bound < max(cohort_members.values() or [1]):
        bound *= 4
    ranks, r = [], 8
    while r <= bound * 4:
        ranks.append(r)
        r *= 4
    return tuple(ranks)


def parse_shape_rung(key) -> tuple:
    """Normalize one synthesized warm rung to a (B, K) pair. Accepts
    the ``"B{b}xK{k}"`` strings ``sim/adversary.preempt_shape_report``
    emits (``suggested_rungs`` — the ``soak_run --shapes`` feed) or a
    bare ``(B, K)`` tuple."""
    if isinstance(key, str):
        b_part, _, k_part = key.partition("x")
        if not (b_part.startswith("B") and k_part.startswith("K")):
            raise ValueError(f"bad shape rung {key!r} "
                             "(want 'B<n>xK<n>' or a (B, K) pair)")
        return int(b_part[1:]), int(k_part[1:])
    b, k = key
    return int(b), int(k)


def preempt_shape_ladder(cohort_members: dict, width: int,
                         extra=()) -> tuple:
    """Bucketed preemption-batch shapes {B,K,QL,CL,RF,U} the warm walk
    precompiles (encode_problems buckets every dim, so a handful of
    shape dicts cover the common storm geometries):

    - a RECLAIM shape: problems spanning the widest cohort (QL = its
      member bucket) with a candidate axis sized by the members (a few
      victims per CQ -- the K bucket only has to match the power-of-four
      bucket the real pool lands in, K itself is padded), and
    - a WITHIN-CQ shape: single-CQ problems (QL bucket 1) with a small
      pool,

    each at THREE problem-count rungs: B buckets by the number of
    preempt problems in the cycle, NOT the batch width, so the rungs
    descend geometrically from the full-backlog bucket (every head
    preempts) through width/4 (a full storm net of lenders -- the
    flagship reclaim storm encodes ~one problem per borrowing head)
    down to width/16 (a partial storm). CL/RF sit at their bucket
    floors -- chains and request slots bucket from small minimums that
    real topologies rarely exceed. U (the dedup row table) is pinned
    at its floor too, but honestly: U buckets on the cycle's DISTINCT
    victim (usage-row, priority) footprints -- workload content no
    topology-derived ladder can enumerate -- so a heterogeneous storm
    (>= 4 distinct footprints) lands off-ladder by construction. A
    shape outside the ladder (a deeper partial storm, a heterogeneous
    pool, an unusually wide one) costs ONE counted mid-traffic compile
    (mid_traffic_compiles / compile_events_total) that the jit cache
    then holds for the process and the persistent cache across
    restarts; request()'s background backfill is width-keyed and does
    not re-warm preemption shapes. Tuning U rungs from production
    compile_events data is a ROADMAP follow-up.

    ``extra`` closes that loop for the (B, K) plane today: synthesized
    off-ladder rungs — ``soak_run --shapes`` runs the adversarial
    geometry sweep (sim/adversary.preempt_shape_report) and its
    ``suggested_rungs`` are exactly the storm shapes the topology
    ladder above would NOT precompile — are accepted here as
    ``"B{b}xK{k}"`` strings or (B, K) pairs and become first-class
    rungs at the reclaim geometry (QL = the member bucket; CL/RF/U at
    their floors, like every topology rung)."""
    mm = max(cohort_members.values() or [1])
    k_reclaim = _bucket(max(8, 4 * mm))
    shapes = []
    for b in dict.fromkeys(_bucket(max(1, width // d), 1)
                           for d in (1, 4, 16)):
        shapes.append({"B": b, "K": k_reclaim, "QL": _bucket(mm, 1),
                       "CL": 8, "RF": 8, "U": 4})
        shapes.append({"B": b, "K": 8, "QL": 1, "CL": 8, "RF": 8,
                       "U": 4})
    for rung in extra:
        b, k = parse_shape_rung(rung)
        shapes.append({"B": _bucket(b, 1), "K": _bucket(k),
                       "QL": _bucket(mm, 1), "CL": 8, "RF": 8, "U": 4})
    # cohort-less topologies collapse the two geometries (QL bucket 1,
    # K floor 8): dedup so each variant compiles once
    out, seen = [], set()
    for s in shapes:
        key = tuple(sorted(s.items()))
        if key not in seen:
            seen.add(key)
            out.append(s)
    return tuple(out)


def snapshot_cohort_members(snapshot) -> dict:
    """cohort name (or CQ name when cohort-less) -> member CQ count."""
    members: dict = {}
    for name, cq in snapshot.cluster_queues.items():
        key = cq.cohort.name if cq.cohort is not None else name
        members[key] = members.get(key, 0) + 1
    return members


class BucketState:
    """One ladder step's lifecycle + provenance (the /debug/warmup and
    warm_probe row)."""

    __slots__ = ("width", "ranks", "scatter", "state", "source",
                 "attempts", "programs", "compile_s", "error",
                 "fit_warm")

    def __init__(self, width: int, ranks: tuple, scatter: bool = False):
        self.width = width
        self.ranks = tuple(ranks)
        self.scatter = scatter      # this step also warms the arena scatter
        self.state = B_PENDING
        self.source = None          # fresh | cache-hit | jit-cache
        self.attempts = 0
        self.programs = 0
        self.compile_s = 0.0
        self.error = ""
        self.fit_warm = False       # fit-path variants warm (gate opens
                                    # before the longer preempt warms)

    def to_dict(self) -> dict:
        return {"width": self.width, "ranks": list(self.ranks),
                "state": self.state, "source": self.source,
                "attempts": self.attempts, "programs": self.programs,
                "compile_ms": round(self.compile_s * 1e3, 1),
                "error": self.error}


class CompileGovernor:
    """Supervised shape-bucket warmup + the scheduler's warm-state gate.

    Constructed idle (state ``idle``; ``route_ready`` always True so an
    attached-but-unused governor changes nothing). ``start()`` launches
    the background walk; ``run_sync()`` walks the ladder on the calling
    thread (the perf harness's pre-clock warmup). Both share the same
    fault-contained per-bucket machinery.
    """

    def __init__(self, solver, cache, *, metrics=None, recorder=None,
                 bucket_deadline_s: float = DEFAULT_BUCKET_DEADLINE_S,
                 max_width: int = DEFAULT_MAX_WIDTH,
                 deltas_buckets: tuple = (8,),
                 max_attempts: int = DEFAULT_MAX_ATTEMPTS,
                 expected_pending: Optional[int] = None,
                 fair_sharing: bool = False,
                 warm_preempt: bool = True, fs_flags: tuple = (),
                 extra_preempt_rungs: tuple = ()):
        self.solver = solver
        self.cache = cache
        self.metrics = metrics
        self.recorder = recorder
        self.bucket_deadline_s = bucket_deadline_s
        self.max_width = max_width
        self.deltas_buckets = tuple(deltas_buckets)
        self.max_attempts = max_attempts
        self.expected_pending = expected_pending
        # fair_sharing is a STATIC kernel arg: a deployment with fair
        # sharing enabled dispatches genuinely different programs, so
        # the ladder must warm with the same flag (manager wires it
        # from cfg.fair_sharing.enable).
        self.fair_sharing = fair_sharing
        # Preemption/fair-share program variants ride the ladder's
        # largest bucket (warm_preempt): the batched preemption solve is
        # a distinct fused program per preemption-batch shape, and the
        # first preemption-heavy cycle after startup must not be the
        # compile that breaks max_mid_traffic_compiles=0. fs_flags is
        # the static strategy tuple the scheduler will dispatch with
        # (fairpreempt.strategy_flags) -- a mismatched tuple warms a
        # program nobody runs.
        self.warm_preempt = warm_preempt
        # Synthesized (B, K) rungs beyond the topology ladder — the
        # soak_run --shapes feed (see preempt_shape_ladder's ``extra``).
        self.extra_preempt_rungs = tuple(extra_preempt_rungs)
        self.fs_flags = tuple(fs_flags)
        self._preempt_shapes: tuple = ()
        self.state = GOV_IDLE
        self.buckets: dict = {}       # width -> BucketState (ladder order)
        self.warmup_faults = 0        # faulted bucket attempts (total)
        self.programs_warmed = 0
        self.unwarm_routed = 0        # cycles the gate sent to cpu-warmup
        self._warm_widths: frozenset = frozenset()  # atomic hot-path read
        self._ranks: tuple = (8, 32)  # ladder ranks (for late requests)
        self._worker = SupervisedWorker("compile-warmup")
        self._lock = threading.Lock()
        self._requests: collections.deque = collections.deque()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._walked = False
        self._vacuous = False         # card or mesh: nothing to warm
        self._ctx = None              # solver WarmContext, once built
        # an exception the background walk did not contain: raised on
        # the next route_ready/request (the Scheduler's thread)
        self._error: Optional[BaseException] = None

    # --- hot path (scheduler thread) ---

    def route_ready(self, heads: int) -> bool:
        """Gate consulted by the scheduler before committing a cycle to
        the device route: True when the batch-width bucket this head
        count encodes into has warm programs, or the governor was never
        engaged (an idle governor must not change routing), or the
        backend caches its dispatch paths elsewhere (mesh/native:
        vacuously warm, the gate must never divert). Raises what the
        background walk could not contain."""
        if self._error is not None:
            raise self._error
        if self.state == GOV_IDLE or self._vacuous:
            return True
        w = _bucket(max(1, min(heads, self.max_width)))
        return w in self._warm_widths

    def request(self, heads: int) -> None:
        """The scheduler hit an un-warmed bucket mid-traffic (the cycle
        itself routed to the CPU path): enqueue a background warm for
        it. Idempotent per bucket; wakes — or lazily starts — the
        background worker. A bucket already SKIPPED (gave up after
        max_attempts) is not re-queued: that is an operator decision.
        Raises what the background walk could not contain."""
        if self._error is not None:
            raise self._error
        if self._vacuous:
            return
        self.unwarm_routed += 1
        w = _bucket(max(1, min(heads, self.max_width)))
        with self._lock:
            if w in self._warm_widths:
                return
            b = self.buckets.get(w)
            if b is not None and b.state in (B_WARMING, B_SKIPPED):
                return
            if b is None:
                b = BucketState(w, self._ranks)
                self.buckets[w] = b
            if w in self._requests:
                return
            self._requests.append(w)
        self._wake.set()
        self.start()  # no-op while the background thread is alive

    # --- lifecycle ---

    def start(self) -> None:
        """Launch (idempotently) the supervised background warmup
        thread: waits for a non-empty topology, walks the ladder
        largest-first, then parks serving ``request()`` retries.

        The route gate engages IMMEDIATELY (state leaves ``idle`` here,
        not when the walk begins): between start() and the walk seeing
        a topology there must be no window where an un-warmed cycle
        slips onto the device route and pays the compile the governor
        exists to absorb. A solver on the card has nothing to warm: it
        is warm at once, and no thread starts."""
        if not getattr(self.solver, "warm_ladder", True):
            self._set_vacuous()
            return
        with self._lock:
            if self.state == GOV_IDLE:
                self.state = GOV_WARMING
            if self._thread is not None and self._thread.is_alive():
                self._set_gauge()
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="compile-governor")
            self._thread.start()
        self._set_gauge()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._worker.stop()

    def run_sync(self, expected_pending: Optional[int] = None) -> int:
        """Walk the whole ladder on the calling thread (a harness's warm
        before its clock starts). Blocking, but each bucket still runs
        under the supervised per-bucket deadline, so a wedged warm
        abandons that bucket instead of hanging the caller; a walk-level
        DeviceFault degrades to the route gate (counted), and any other
        exception propagates. Returns the number of programs warmed."""
        self._walked = True
        if expected_pending is not None:
            self.expected_pending = expected_pending
        return self._walk_contained()

    # --- the ladder walk ---

    def _has_topology(self) -> bool:
        hm = getattr(self.cache, "hm", None)
        return bool(hm is not None and hm.cluster_queues)

    def _run(self) -> None:
        try:
            self._run_body()
        except BaseException as exc:  # noqa: BLE001 — handed to the caller
            # not contained: the Scheduler's next route_ready/request
            # raises it
            self._error = exc
            with self._lock:
                self.state = GOV_PARTIAL
            self._set_gauge()

    def _run_body(self) -> None:
        while not self._stop.is_set() and not self._has_topology():
            self._stop.wait(0.05)
        if self._stop.is_set():
            return
        if not self._walked:
            self._walked = True
            # The topology gate above releases on the FIRST reconciled
            # CQ, which may be mid-startup (more CQs still landing):
            # re-walk until the structural generation token is stable
            # across a walk, so the ladder, cache fingerprint, and the
            # frozen WarmContext are never built from a partial
            # topology. Structural tokens only move on CQ/flavor
            # changes, so steady state walks exactly once.
            tok = self._gen_token()
            self._walk_contained()
            while not self._stop.is_set():
                new_tok = self._gen_token()
                if new_tok == tok:
                    break
                tok = new_tok
                self._reset_for_rewalk()
                self._walk_contained()
        # Serve mid-traffic requests (un-warmed buckets the route gate
        # diverted) until stopped.
        while not self._stop.is_set():
            self._wake.wait()
            self._wake.clear()
            while not self._stop.is_set():
                with self._lock:
                    w = (self._requests.popleft()
                         if self._requests else None)
                if w is None:
                    break
                b = self.buckets.get(w)
                if b is None or b.state in (B_WARM, B_SKIPPED):
                    continue
                if self._ctx is None:
                    # Walk never built a context (mesh/native backend):
                    # nothing to warm.
                    continue
                if not self._warm_one(b) and b.state == B_FAILED:
                    with self._lock:
                        self._requests.append(w)
                self._finish_state()

    def _gen_token(self):
        fn = getattr(self.cache, "generation_token", None)
        try:
            return fn() if fn is not None else None
        except Exception:  # noqa: BLE001 — a stub cache in a test
            return None

    def _reset_for_rewalk(self) -> None:
        """The topology changed structurally since the last walk: every
        warmed program was keyed on the OLD dims, so the buckets' warm
        state is meaningless — hold the gate and walk the new ladder.
        (Old-dims compiles stay in the jit/persistent caches; only the
        governor's bookkeeping resets.)"""
        with self._lock:
            self.buckets.clear()
            self._requests.clear()
            self._warm_widths = frozenset()
            self._vacuous = False
            self._ctx = None
            self.state = GOV_WARMING
        self._set_gauge()

    def _walk_contained(self) -> int:
        """_walk with walk-level containment of a DeviceFault (a fault
        site in warm_setup's reads): the gate holds the CPU route,
        counted in warmup_faults_total. Any other exception propagates
        (the JAX governor contains every Exception here)."""
        try:
            return self._walk()
        except DeviceFault:
            self.warmup_faults += 1
            if self.metrics is not None:
                self.metrics.warmup_fault()
            with self._lock:
                self.state = GOV_PARTIAL
            self._set_gauge()
            return 0

    def _walk(self) -> int:
        snapshot = self.cache.snapshot()
        try:
            ctx = self.solver.warm_setup(snapshot, self.expected_pending)
            num_cqs = len(snapshot.cluster_queues)
            members = snapshot_cohort_members(snapshot)
        finally:
            release = getattr(self.cache, "release_snapshot", None)
            if release is not None:
                release(snapshot)
        if ctx is None:
            self._set_vacuous()
            return 0
        self._ctx = ctx
        widths = width_ladder(num_cqs, self.max_width)
        ranks = rank_ladder(members)
        if self.warm_preempt:
            self._preempt_shapes = preempt_shape_ladder(
                members, widths[0], extra=self.extra_preempt_rungs)
        with self._lock:
            self._ranks = ranks
            self.state = GOV_WARMING
            for i, w in enumerate(widths):
                b = self.buckets.get(w)
                if b is None:
                    # the scatter programs ride on the first (largest)
                    # step — they are per-arena-capacity, not per-width
                    self.buckets[w] = BucketState(w, ranks,
                                                  scatter=(i == 0))
                elif b.ranks != tuple(ranks) or (i == 0 and not b.scatter):
                    # A request() between start() and here created this
                    # bucket with the placeholder ranks (and no scatter
                    # claim): refresh it against the real ladder, and
                    # re-warm if it already ran — a bucket warmed at the
                    # wrong ranks is not warm (already-compiled subsets
                    # replay from the jit cache, so the re-warm is
                    # cheap).
                    b.ranks = tuple(ranks)
                    b.scatter = b.scatter or (i == 0)
                    b.fit_warm = False  # wrong-rank fit warms don't count
                    if b.state == B_WARM:
                        b.state = B_PENDING
            self._warm_widths = frozenset(
                w for w, st in self.buckets.items()
                if st.state == B_WARM or st.fit_warm)
        self._set_gauge()
        queue = collections.deque(
            self.buckets[w] for w in widths
            if self.buckets[w].state != B_WARM)
        while queue and not self._stop.is_set():
            b = queue.popleft()
            if not self._warm_one(b) and b.state == B_FAILED:
                queue.append(b)  # retry at the ladder tail, then skip
        self._finish_state()
        return self.programs_warmed

    def _set_vacuous(self) -> None:
        """Nothing to warm (the card, a mesh): vacuously warm, the gate
        never diverts (route_ready short-circuits on the flag;
        _warm_widths stays empty, so without it every cycle would
        divert)."""
        with self._lock:
            self._vacuous = True
            self.state = GOV_WARM
        self._set_gauge()

    def _warm_one(self, b: BucketState) -> bool:
        b.state = B_WARMING
        b.attempts += 1
        since = dict(_build.EVENTS)
        t0 = time.perf_counter()
        self._annotate("compile-begin",
                       f"warmup bucket width={b.width} "
                       f"(attempt {b.attempts})",
                       width=b.width, attempt=b.attempts)
        try:
            n = self._worker.run(self._warm_body, b,
                                 deadline_s=self.bucket_deadline_s)
            if (b.scatter and self._preempt_shapes
                    and hasattr(self.solver, "warm_preempt_bucket")):
                # Separate supervised windows, one per (B rung, rank)
                # chunk: the preempt ladder is many compile batches of
                # its own, so pricing it all inside the fit phase's
                # deadline would make the knob's meaning scale with
                # the ladder (a chronically-over-deadline window would
                # retry into the same wall and SKIP, silently never
                # warming preemption). The route gate for this width
                # is already open (fit_warm) — a timeout in any chunk
                # retries the bucket at the ladder tail, replaying
                # completed chunks from the jit cache.
                for shapes, rank, sr in self._preempt_chunks(b.ranks):
                    n += self._worker.run(
                        lambda bb, s=shapes, r=rank, f=sr:
                            self._warm_preempt_chunk(bb, s, r, f),
                        b, deadline_s=self.bucket_deadline_s)
        except DispatchTimeout as exc:
            self._fault(b, exc, timeout=True)
            return False
        except DeviceFault as exc:
            # contained: an injected fault, a device fault of the warm;
            # anything else (an nvcc failure, a CUDA error, a bug)
            # propagates and leaves the bucket warming
            self._fault(b, exc, timeout=False)
            return False
        b.compile_s = time.perf_counter() - t0
        b.source = build_source(since)
        b.programs = n
        b.error = ""
        b.state = B_WARM
        self.programs_warmed += n
        with self._lock:
            self._warm_widths = frozenset(
                w for w, st in self.buckets.items()
                if st.state == B_WARM or st.fit_warm)
        if self.metrics is not None:
            self.metrics.compile_event(str(b.width), b.source, n)
        self._annotate("compile-end",
                       f"bucket width={b.width} warm: {n} program(s) "
                       f"{b.source} in {b.compile_s * 1e3:.0f}ms",
                       width=b.width, programs=n, source=b.source,
                       ms=round(b.compile_s * 1e3, 1))
        return True

    def _warm_body(self, b: BucketState) -> int:
        # Injection site: a DELAY here is a wedged remote compile — the
        # per-bucket deadline abandons the bucket and the ladder
        # continues; a RAISE is a backend error mid-warm. Runs on the
        # supervised worker thread, never the scheduler's.
        faultinject.site(faultinject.SITE_WARMUP)
        ctx = self._ctx
        n = self.solver.warm_router(ctx, b.width)
        n += self.solver.warm_bucket(ctx, b.width, max_ranks=b.ranks,
                                     deltas_buckets=self.deltas_buckets,
                                     fair_sharing=self.fair_sharing)
        if b.scatter:
            n += self.solver.warm_scatter(ctx)
            # The width's FIT-path variants are warm: open the route
            # gate now, before the (much longer) preemption-variant
            # warm that follows in its own supervised window — holding
            # fit-only traffic on cpu-warmup until every preempt shape
            # compiles would multiply the cold-start-to-first-device-
            # route budget (bench cold_start) by the preempt ladder's
            # size. A preemption cycle arriving in this window pays a
            # counted mid-traffic compile, exactly as it would for an
            # off-ladder shape.
            b.fit_warm = True
            with self._lock:
                self._warm_widths = self._warm_widths | {b.width}
        return n

    def _warm_preempt_chunk(self, b: BucketState, shapes: tuple,
                            rank: int, sr: bool) -> int:
        # Preemption variants ride the largest (first) bucket only: a
        # preemption storm nominates against the full backlog, so the
        # full-width bucket is the one whose first mixed cycle must
        # not compile; the shape ladder's descending B rungs cover
        # partial storms, and anything deeper pays one counted
        # mid-traffic compile (request()'s background warm is
        # width-keyed and does not re-warm preemption shapes).
        return self.solver.warm_preempt_bucket(
            self._ctx, b.width, shapes, max_ranks=(rank,),
            deltas_buckets=self.deltas_buckets,
            fair_sharing=self.fair_sharing,
            fs_flags=self.fs_flags, start_rank=sr)

    def _preempt_chunks(self, ranks: tuple) -> list:
        """(shapes, rank, start_rank) work units for the preempt warm,
        one supervised window each: the ladder grouped by B rung (the
        mixed fair variant pairs a within-CQ batch with a cohort-wide
        batch at EQUAL B, so a rung's shapes must warm together),
        split per rank rung and per flavor-resume twin (requeued heads
        after an eviction carry resume state, so mid-storm preempt
        cycles routinely dispatch the start_rank variant). Each chunk
        is a handful of compiles — comparable to one fit-bucket warm —
        so the per-bucket deadline keeps its meaning instead of
        scaling with the whole ladder."""
        by_b: dict = {}
        for s in self._preempt_shapes:
            by_b.setdefault(s["B"], []).append(s)
        return [(tuple(shapes), r, sr)
                for r in dict.fromkeys(ranks)
                for shapes in by_b.values()
                for sr in (False, True)]

    def _fault(self, b: BucketState, exc: BaseException,
               timeout: bool) -> None:
        self.warmup_faults += 1
        b.error = repr(exc)[:200]
        b.state = B_FAILED if b.attempts < self.max_attempts else B_SKIPPED
        if self.metrics is not None:
            self.metrics.warmup_fault()
        self._annotate("compile-fault",
                       f"warmup bucket width={b.width} "
                       f"{'deadline' if timeout else 'fault'}: "
                       f"{exc!r}"[:200],
                       width=b.width, timeout=timeout, state=b.state)

    def _finish_state(self) -> None:
        with self._lock:
            states = {b.state for b in self.buckets.values()}
            self.state = GOV_WARM if states <= {B_WARM} else GOV_PARTIAL
        self._set_gauge()

    # --- surface (metrics / recorder / debug endpoints / dumper) ---

    def _set_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.set_warmup_state(self.state)

    def _annotate(self, kind: str, message: str, **fields) -> None:
        # Attaches to whatever cycle trace is concurrently open (the
        # governor runs off-thread): the trace shows which cycles
        # overlapped a background compile. No open trace = dropped.
        if self.recorder is not None:
            self.recorder.annotate(kind, message, **fields)

    def status(self) -> dict:
        """The governor's operator surface (obs/status.warmup_status)."""
        with self._lock:
            buckets = [b.to_dict() for b in self.buckets.values()]
            warm = sorted(self._warm_widths)
        return {
            "state": self.state,
            "buckets": buckets,
            "warm_widths": warm,
            "programs_warmed": self.programs_warmed,
            "warmup_faults": self.warmup_faults,
            "unwarm_routed_cycles": self.unwarm_routed,
            "source": build_source() if self._vacuous else "",
            "bucket_deadline_s": self.bucket_deadline_s,
            "deltas_buckets": list(self.deltas_buckets),
            "worker": self._worker.status(),
        }
