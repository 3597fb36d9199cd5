"""BatchSolver: the fit-mode admission solve from a snapshot to decisions.

The port of kueue_tpu/solver/service.py's single-chip fit path. Unbound
(`BatchSolver().solve(snapshot, entries)`): encode the cycle, upload the
state and the batch, run the fused cycle (kernel.solve_cycle_fused) on
the solver's device, fetch only the packed decisions, unpack and decode
them into the scheduler's Assignment form, including the
LastTriedFlavorIdx resume state.

Bound to its Cache (`bind_cache`) and queue Manager (`bind_queues`), it
runs the JAX package's production cycle: usage and cohort usage stay on
the device across cycles (ResidentState), reconciled with the cache's
usage journal by a sparse correction prologue (kernel.apply_state_deltas);
the heads' encoded rows live in the encode arena (solver/arena.py),
whose device twin takes only the changed rows each cycle
(kernel.scatter_arena_rows) and from which the cycle gathers its batch
by slot (kernel.solve_cycle_resident_arena). The caller's cycle is the
scheduler's (kueue_tpu_torch.scheduler.Scheduler drives it): heads from
the Manager, `prepare`, `solve_prepared`, then for each admitted head
`cache.assume_workload` and `release_workload`, and
`Manager.requeue_workload` for the rest; a failed assume is reported
with `note_unapplied`. With `fair_sharing` the admit order takes each
head's DRF share (kernel.drf_share).

Preemption (solver/preempt.py, minimal, K9; solver/fairpreempt.py,
fair sharing, K11): `solve_prepared(plan, snapshot, preempt_batch=...,
fair_batch=..., fs_flags=...)` runs the fit cycle and the batches'
solves (kernel.solve_preempt, kernel.solve_fair) against the same usage
from before the cycle and returns their targets beside the decisions;
`solve_preemptions(preempt_batch, fair_batch, fs_flags)` launches K9 and
K11 back to back after the cycle's sync, against the usage the last
dispatch read, with one sync and one fetch for both, which is how the
Scheduler calls them (it builds the problems from the heads the device
did not fit); `solve_preempt(batch)` is its K9-only form.
`estimated_sync_ms()` is the launch-and-sync floor the Scheduler's
preemption work gate weighs; `counters["syncs"]` counts the solver's
syncs.

MultiKueue: when the snapshot carries remote-cluster capacity columns
and a CQ routes through them (encode.encode_cluster_columns), the
columns ride the cycle's upload, the fused cycle scores them
(kernel.score_cluster_columns) and `mk_cluster` is fetched with the
decisions; `last_placements` maps each admitted head the device placed to
its cluster's name.

With a mesh (`BatchSolver(mesh=parallel.mesh.make_mesh())`, the JAX
package's mesh solver, kueue_tpu/solver/service.py:1251-1286) the cycle
is unbound: no usage journal, no resident state, no arena twin; every
dispatch uploads the state and the batch and runs
parallel.mesh.solve_cycle_sharded over the cycle's domain plan
(parallel/domains.py, timed as last_phase_s["plan"], kept in
`last_domain_plan`), and `solve_preemptions` runs K9 through
parallel.mesh.solve_preempt_sharded. Fair-sharing preemption does not
run under a mesh: the Scheduler sends it to the CPU Preemptor, and a
fair batch raises here.

Batched partial admission (`batched_partial_admission`, the JAX
package's kueue_tpu/solver/service.py:1732): the heads the cycle did not
fit that may be partially admitted search their pod counts together, in
lockstep binary searches; each round encodes every active head's probe
and runs Phase A alone on them (kernel.solve_phase_a, which on the card
launches avail and phase_a) against the usage the last dispatch read,
with one sync a round, timed as last_phase_s["partial"].

Device-fault containment (kueue_tpu/resilience's port, driven by the
Scheduler): with `supervise_deadline_s`, the dispatch runs on the
persistent supervised worker thread (resilience/supervisor.py) and a
dispatch past it raises SupervisedTimeout and moves the dispatch epoch,
which an orphaned dispatch checks before each launch
(kernel.launch_guard) and before any write to the arena twin or the
resident state; with `deadline_s`, collect polls the CUDA event
recorded after the cycle's launches and raises DispatchTimeout past
the deadline instead of blocking. The fault sites of
resilience/faultinject.py: the dispatch (SITE_DISPATCH), the decision
outputs at collect (SITE_COLLECT, whose corruption `_validate_fetched`
catches), the arena scatter (SITE_SCATTER, solver/arena.py) and the
journal replay (SITE_REPLAY). On the card the kernels build when the
solver is made, outside any deadline; a build failure raises there.

A light snapshot (`Cache.snapshot(light=True)`) is read-only and shares
the live trees: a topology encode or an establishing state encode off
one takes the solver's own full snapshot and releases it
(kueue_tpu/solver/service.py:916-943, :1062-1065).

The speculative pipeline (the Scheduler's pipelined cycle):
`prepare(snapshot, heads, route=True)` also runs the fit router
(`_route`, kueue_tpu/solver/service.py:1183): Phase A through
kernel.solve_phase_a (avail and phase_a on the card) against the host
mirror of the resident usage, whose bits go into Plan.fit_pred;
Plan.slot_gens holds the arena generations the speculation token
witnesses. `dispatch` returns without waiting, `start_fetch` queues the
decisions' copies into pinned host buffers behind the launches, and
`collect` comes a cycle later: it waits on the copies' event, holds
only its own time against the deadline and adds no sample to the
watchdog's.

The flight recorder (`bind_recorder`, kueue_tpu/solver/service.py:
370-382): every interval the solver times also lands as a span in the
Scheduler's open cycle trace and in the cumulative `phase_s`, under the
JAX package's names where the interval is the JAX one (encode, route,
dispatch with dispatch.scatter nested, fetch, decode) and under a dotted
name nested in its prefix where it is the port's own (dispatch.plan,
fetch.device, preempt-plan.solve, nominate.partial), so that the
traces' phase_sums stay comparable. `last_phase_s` keeps the port's
per-cycle phases (PHASES).

Nothing is compiled per shape here: the kernels are built whole when a
solver is made on the card, and every shape is a launch argument. So
the card is warm from the start, as the JAX package's compile governor
treats a mesh: `warm_setup` returns None there (solver/warmgov.py then
never gates a cycle to "cpu-warmup") and no program variant is keyed
or counted. On the CPU (`warm_ladder`), which the paired tests hold
against the JAX package, the solver keeps the JAX package's
bookkeeping: counters["mid_traffic_compiles"] counts the first
execution in this process of a program variant, keyed as the JAX
package keys it (kind, topology dims, width bucket, rank bucket over
the bucket's rows padding included, flags, delta and preemption
shapes), that no warm registered and no earlier dispatch ran, each
annotated "compile" on the open trace; and the warm API (`warm_setup`,
`warm_router`, `warm_bucket`, `warm_scatter`, `warm_preempt_bucket`)
runs each program's plain version once at a bucket's shapes on inert
padded rows, registers the JAX package's keys and returns its program
counts. A preempt-mode cycle on the synchronous path keys its fit
dispatch without the preemption shapes and its K9/K11 launch
(solve_preemptions) as a program of its own ("preempt-solve"), since
the port launches them apart.

Left out (the JAX package has it): the background fetch pool (the
started fetch needs none).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from kueue_tpu_torch import features
from kueue_tpu_torch.api.corev1 import RESOURCE_PODS
from kueue_tpu_torch.cache.snapshot import Snapshot
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.core.resources import FlavorResource
from kueue_tpu_torch.device import resolve
from kueue_tpu_torch.resilience import faultinject
from kueue_tpu_torch.resilience.faultinject import DeviceFault, InjectedFault
from kueue_tpu_torch.resilience.supervisor import SupervisedWorker
from kueue_tpu_torch.resilience.watchdog import DispatchTimeout
from kueue_tpu_torch.scheduler import flavorassigner as fa
from kueue_tpu_torch.scheduler.podset_reducer import (
    counts_for_index,
    reduction_space,
)
from kueue_tpu_torch.solver import _build, encode, kernel
from kueue_tpu_torch.solver import fairpreempt
from kueue_tpu_torch.solver import preempt as devpreempt
from kueue_tpu_torch.solver.arena import ARENA_FIELDS, WorkloadArena
from kueue_tpu_torch.solver.fairpreempt import fair_args
from kueue_tpu_torch.solver.kernel import (
    DECISION_KEYS,
    MAX_COMPACT_FLAVORS,
    solve_cycle_fused,
    solve_cycle_resident,
    solve_cycle_resident_arena,
    solve_cycle_with_preempt,
    topo_to_device,
)
from kueue_tpu_torch.solver.preempt import preempt_args

# after the scheduler package, whose import reaches solver.encode first
from kueue_tpu_torch.parallel import mesh as meshpkg  # noqa: E402,I001

# The largest device backlog shipped as a delta prologue: a bigger
# correction set re-uploads the mirror wholesale (the JAX package's
# bound, kueue_tpu/solver/service.py:1034).
MAX_BACKLOG = 512

# the dense decision keys the compact wire format replaces
DENSE_DECISION_KEYS = ("admitted", "fit", "chosen", "borrows",
                       "chosen_borrow")

# the phases of one solve, timed per cycle (seconds) in last_phase_s;
# "route" is the router's Phase A against the host mirror (prepare with
# route=True), "plan" is the mesh's domain plan, "preempt" solve_preemptions' upload,
# launches, sync and fetch, "partial" batched_partial_admission's rounds
PHASES = ("encode", "route", "plan", "upload", "device", "fetch", "decode",
          "preempt", "partial")

# --- the registry of program variants run in this process ---
#
# The variant keys are the JAX package's (kueue_tpu/solver/service.py:
# 101-130): a dispatch or route whose key was never registered (by a
# warm or an earlier run) counts as counters["mid_traffic_compiles"].
_SEEN_PROGRAMS: set = set()
_SEEN_LOCK = threading.Lock()


def note_program(key: tuple) -> bool:
    """Record a program variant as run; True when it was new."""
    with _SEEN_LOCK:
        if key in _SEEN_PROGRAMS:
            return False
        _SEEN_PROGRAMS.add(key)
        return True


def reset_seen_programs() -> None:
    """Forget every recorded variant (a test's simulated restart)."""
    with _SEEN_LOCK:
        _SEEN_PROGRAMS.clear()


def _warm_deltas(L: int, dlt):
    """An inert delta prologue of `dlt` rows (every coord -1), or None
    (kueue_tpu/solver/service.py:132-146)."""
    if dlt is None:
        return None
    return (np.full(dlt, -1, np.int32),
            np.zeros(dlt, np.int32),
            np.zeros(dlt, np.int32),
            np.zeros(dlt, np.int64),
            np.full((L, dlt, 3), -1, np.int32),
            np.full((L, dlt), -1, np.int32))


class WarmContext:
    """The shapes every bucket warm runs at, built once by
    BatchSolver.warm_setup (the only warm step that changes solver
    state); each later warm call only reads the solver."""

    __slots__ = ("topo", "topo_dev", "usage", "cohort_usage",
                 "arena_dev", "arena_cap", "cluster")


# batched_partial_admission's answer for a head whose probe could not be
# encoded: it goes back to CPU nomination and its sequential reducer
# (kueue_tpu/solver/service.py:98)
CPU_FALLBACK = object()

# the most lockstep rounds of a partial-admission search (log2 of the
# largest reduction space in practice)
MAX_PARTIAL_ROUNDS = 40

_NO_FAIR_UNDER_MESH = ("fair-sharing preemption does not run under a mesh "
                       "(the Scheduler sends it to the CPU Preemptor)")

# the outputs of the preemption solves, in fetch order
PREEMPT_KEYS = ("preempt_targets", "preempt_feasible", "preempt_stats")
FAIR_KEYS = ("fair_targets", "fair_feasible", "fair_reasons", "fair_stats")


def preempt_aux(fetched: dict) -> Optional[dict]:
    """The preemption outputs of a fetch in the JAX package's aux form
    (kueue_tpu/solver/service.py:1709-1719): {"preempt": (targets,
    feasible), "preempt_stats": stats, "fair": (targets, feasible,
    reasons), "fair_stats": stats}, each half only when its solve ran;
    None when neither did."""
    aux = {}
    if "preempt_targets" in fetched:
        # the K9 kernel's rows of -1: a problem with more active slots
        # than the launch was sized for (kernel.solve_preempt)
        unsized = np.flatnonzero((fetched["preempt_stats"] == -1).all(1))
        if unsized.size:
            raise RuntimeError(
                f"solve_preempt left problems {unsized[:8].tolist()} "
                "unsolved: more active slots than its active_slots")
        aux["preempt"] = (fetched["preempt_targets"],
                          fetched["preempt_feasible"])
        aux["preempt_stats"] = fetched["preempt_stats"]
    if "fair_targets" in fetched:
        aux["fair"] = (fetched["fair_targets"], fetched["fair_feasible"],
                       fetched["fair_reasons"])
        aux["fair_stats"] = fetched["fair_stats"]
    return aux or None


def _scramble_outputs(outputs: dict) -> dict:
    """The collect site's CORRUPT action (kueue_tpu/solver/service.py:
    159): garbage decision outputs, as a bit-flipped copy would give,
    deliberately against the invariants (admitted rows without the fit
    bit), which _validate_fetched must catch. The compact format gets
    its fit plane zeroed and its admitted plane all ones, the dense one
    the same on its bool arrays. It scrambles copies of the device
    outputs, before the fetch."""
    out = dict(outputs)
    if "dec_bits" in outputs:
        bits = outputs["dec_bits"].clone()
        bits[0, :] = 0     # fit plane
        bits[1, :] = 0xFF  # admitted plane
        out["dec_bits"] = bits
        return out
    out["admitted"] = torch.ones_like(outputs["admitted"])
    out["fit"] = torch.zeros_like(outputs["fit"])
    return out


# collect's event poll: spin on the event this many times, then sleep
# between polls (a healthy cycle completes within the spins)
POLL_SPINS = 2000
POLL_SLEEP_S = 50e-6


def unpack_decisions(fetched: dict, num_podsets: int,
                     num_resources: int) -> dict:
    """Host-side inverse of kernel.pack: the compact wire format back to
    the dense decision arrays (kueue_tpu/solver/service.py:66). Dicts
    without the packed keys pass through."""
    if "dec_pr" not in fetched:
        return fetched
    pr = np.asarray(fetched["dec_pr"])
    bits = np.asarray(fetched["dec_bits"])
    W = pr.shape[0]
    planes = np.unpackbits(bits, axis=1,
                           bitorder="little")[:, :W].astype(bool)
    out = {k: v for k, v in fetched.items() if k not in DECISION_KEYS}
    out["fit"], out["admitted"], out["borrows"] = planes
    chosen = (pr & 0x7F).astype(np.int32) - 1
    out["chosen"] = chosen.reshape(W, num_podsets, num_resources)
    out["chosen_borrow"] = (pr >> 7).astype(bool).reshape(
        W, num_podsets, num_resources)
    return out


class Plan:
    """One cycle's encoded inputs, with the router's fit bits when the
    caller asked for them (prepare(..., route=True))."""

    def __init__(self, topo, topo_dev, state, batch, start_rank,
                 fit_pred=None):
        self.topo = topo
        self.topo_dev = topo_dev
        self.state = state
        self.batch = batch
        self.start_rank = start_rank
        # fit_pred[i]: Phase A's fit bit for head i against the host
        # mirror (BatchSolver._route). In a pipelined cycle the mirror
        # lags by the cycles still in flight, so the bits are advisory:
        # the dispatch's own Phase A decides (kueue_tpu/solver/
        # service.py:218-223).
        self.fit_pred = fit_pred
        self.slots = None       # arena slots of the heads (bound to queues)
        # The slots' arena generations, captured at encode time (not at
        # dispatch): the speculation token witnesses the state the rows
        # were gathered from (kueue_tpu/solver/service.py:228-233).
        self.slot_gens = None
        self.deltas = None      # the delta prologue (numpy tuple) or None
        self.resident = False   # dispatch on the device-resident state
        self.rs = None          # the ResidentState the plan was built on
        self.backlog_gen = 0
        self.cluster = None     # encode.ClusterColumns or None


class InFlight:
    """A dispatched cycle: its outputs on the device, the keys collect
    fetches, the CUDA events recorded before and after its launches
    (None on the CPU), the collect deadline and when the launches
    started and the dispatch ended; the minimal-preemption batch it
    solves (decoded by the pipelined preemption's collect); with the
    injector's hit that scrambled the arena's scatter, if one
    did. A started fetch (start_fetch) adds the host buffers the
    decisions are copied into and the event recorded after the
    copies."""

    def __init__(self, plan, result, keys, event, deadline_s, t_launch,
                 scramble=None, start_event=None, preempt_batch=None):
        self.plan = plan
        self.scramble = scramble  # the arena's last_scramble, or None
        self.result = result
        self.keys = keys
        self.event = event
        self.start_event = start_event
        self.deadline_s = deadline_s
        self.t_launch = t_launch
        self.t_dispatch = time.perf_counter()
        self.preempt_batch = preempt_batch
        self.host = None          # key -> host tensor, once fetch started
        self.fetch_event = None   # recorded after the copies (card)


class ResidentState:
    """Device-resident usage/cohort_usage across cycles + the host-side
    bookkeeping that keeps them honest (kueue_tpu/solver/service.py:256):

    - usage_dev/cohort_dev: the cycle's own post-cycle outputs, fed back
      as next cycle's inputs — no per-cycle state upload.
    - mirror_usage/mirror_cohort: numpy twin, kept bit-identical to the
      device by applying the same delta updates host-side.
    - pending: device-applied admissions awaiting their cache-journal
      confirmation (the assume write); confirmed entries cancel, entries
      the caller failed to assume are reverted.
    - device_backlog: net corrections (evictions, finishes, reverted
      admissions) the device has not seen yet; shipped as a sparse delta
      prologue in the next dispatch.
    """

    def __init__(self, token):
        self.token = token
        self.usage_dev = None
        self.cohort_dev = None
        self.mirror_usage = None
        self.mirror_cohort = None
        self.pending: dict = {}        # key -> (cq_name, usage dict, age)
        self.device_backlog: dict = {}  # (cq_name, fr) -> net delta
        self.backlog_gen = 0


class BatchSolver:
    def __init__(self, max_podsets: int = 4, device=None, mesh=None):
        """device=None means the card (raises without one); the tests
        pass device="cpu", which runs the kernels' plain versions. With a
        mesh (parallel.mesh.Mesh) the device is the mesh's and the cycle
        runs sharded over it. Workloads are ordered by the default
        wlpkg.Ordering."""
        self.max_podsets = max_podsets
        self.mesh = mesh
        if mesh is None:
            self.device = resolve(device)
        elif device is None or torch.device(device) == mesh.device:
            self.device = mesh.device
        else:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.ordering = wlpkg.Ordering()
        self._topo_cache = None
        self._topo_key = None
        self._cache = None   # bound Cache (usage journal source)
        self._queues = None  # bound Manager (encode arena delta feed)
        self._resident: Optional[ResidentState] = None
        # Workload encode arena: engaged only once a Manager is bound —
        # without the feed there is no invalidation source for in-place
        # object updates, so unbound callers keep the from-scratch encode.
        self._arena = WorkloadArena(max_podsets)
        self.counters = {"dispatches": 0, "collects": 0, "upload_bytes": 0,
                         "fetch_bytes": 0, "resident_cycles": 0,
                         "establishes": 0, "syncs": 0,
                         "dispatch_timeouts": 0, "validation_faults": 0,
                         "scatter_faults": 0, "supervised_timeouts": 0,
                         "mid_traffic_compiles": 0}
        # cumulative seconds per traced phase (_phase), the JAX package's
        # keys first; dotted keys are nested in their prefix
        self.phase_s = {"encode": 0.0, "route": 0.0, "dispatch": 0.0,
                        "dispatch.scatter": 0.0, "fetch": 0.0,
                        "decode": 0.0}
        self._recorder = None  # the Scheduler's FlightRecorder
        self.last_upload_bytes = 0
        self.last_phase_s = dict.fromkeys(PHASES, 0.0)
        # workload key -> remote cluster name, for the admitted heads the
        # last decode's mk_cluster placed (reset on every decode)
        self.last_placements: dict = {}
        # the mesh's domain plan of the last dispatch (parallel/domains)
        self.last_domain_plan = None
        # the usage the last dispatch read (after its delta prologue):
        # (topology, usage, cohort_usage) on the device, for
        # solve_preemptions
        self._cycle_state = None
        # lockstep rounds of the last batched_partial_admission
        self.last_partial_rounds = 0
        self._sync_samples: list = []  # recent launch-to-sync times (ms)
        self._probe_sync_ms: Optional[float] = None  # estimated_sync_ms
        # Supervised dispatch (kueue_tpu/solver/service.py:300-316): with
        # a deadline, the dispatch runs on a persistent worker thread and
        # a hang is abandoned instead of freezing the scheduler. Every
        # abandonment moves the epoch, which an orphaned dispatch checks
        # before each launch and each write to the arena twin or the
        # resident state; the lock keeps at most one dispatch inside the
        # arena upload.
        self.supervise_dispatch = True
        self._supervisor = SupervisedWorker("solver-dispatch")
        self._dispatch_epoch = 0
        self._arena_lock = threading.Lock()
        if self.device.type == "cuda":
            # Build every kernel now, outside any dispatch deadline: the
            # first supervised dispatch must not carry fourteen nvcc
            # builds, and a build failure raises here.
            _build.build_all()

    # --- binding to the control plane ---

    def bind_cache(self, cache) -> None:
        """Attach the Cache: enables the usage journal that keeps the
        device-resident state reconciled across cycles. Under a mesh the
        cycle is unbound and nothing drains a journal, so none is
        enabled."""
        self._cache = cache
        if self.mesh is None:
            cache.enable_usage_journal()

    def bind_recorder(self, recorder) -> None:
        """Attach the Scheduler's FlightRecorder: every phase interval
        is also a span of its open cycle trace."""
        self._recorder = recorder

    def _phase(self, name: str, t0: float, t1: float) -> None:
        """One phase interval: into the cumulative phase_s and, when a
        recorder is bound, a span of the open trace."""
        self.phase_s[name] = self.phase_s.get(name, 0.0) + t1 - t0
        rec = self._recorder
        if rec is not None:
            rec.span(name, t0, t1 - t0)

    @property
    def warm_ladder(self) -> bool:
        """Whether the compile governor walks the JAX package's warm
        ladder for this solver and its program variants are keyed: on
        the CPU only (see the module docstring)."""
        return self.mesh is None and self.device.type != "cuda"

    def _note_variant(self, key: tuple, width: int) -> None:
        """A hot-path run of the program variant `key`; on the CPU, one
        that no warm registered and no earlier run ran is a mid-traffic
        compile."""
        if self.warm_ladder and note_program(key):
            self._note_mid_traffic_compile(key[0], width)

    def _note_mid_traffic_compile(self, kind: str, width: int) -> None:
        """A program variant no warm registered runs for the first time
        in this process: counted, and annotated on the open trace
        (kueue_tpu/solver/service.py:1168-1182)."""
        self.counters["mid_traffic_compiles"] += 1
        rec = self._recorder
        if rec is not None:
            rec.annotate("compile",
                         f"unwarmed {kind} program at width {width} "
                         f"compiled mid-traffic", program=kind, width=width)

    def _topo_dims(self, topo) -> tuple:
        """The topology dims the variant keys carry."""
        return (topo.nominal.shape, topo.cohort_subtree.shape[0],
                topo.cq_chain.shape[1])

    @staticmethod
    def _compact_flag(topo) -> bool:
        """Whether the cycle fetches the packed decisions (K8)."""
        return topo.nominal.shape[1] <= MAX_COMPACT_FLAVORS

    # --- shape-bucket warmup (the compile governor's seam) ---

    def warm_setup(self, snapshot: Snapshot,
                   expected_pending: Optional[int] = None):
        """The zero state every bucket warm runs against
        (kueue_tpu/solver/service.py:516-574): the topology at the
        snapshot (cached, as a cycle caches it), zero usage on the
        solver's device, the snapshot's cluster columns, and, with the
        arena engaged (a bound Manager, or `expected_pending`), a zero
        twin at the arena's capacity, which is reserved here (at
        `expected_pending`, else at its floor). The only warm step that
        changes solver state. None on the card and under a mesh
        (`warm_ladder`): nothing there is compiled per shape, and the
        governor treats the solver as warm."""
        if not self.warm_ladder:
            return None
        topo, topo_dev = self._topology(snapshot)
        Q, F, R = topo.nominal.shape
        C = topo.cohort_subtree.shape[0]
        ctx = WarmContext()
        ctx.topo, ctx.topo_dev = topo, topo_dev
        ctx.usage = (Q, F, R)
        ctx.cohort_usage = (C, F, R)
        ctx.arena_dev = None
        ctx.arena_cap = 0
        ctx.cluster = encode.encode_cluster_columns(snapshot, topo)
        if expected_pending is not None:
            self._arena.reserve(expected_pending, topo)
        elif self._queues is not None:
            self._arena.reserve(1, topo)
        if self._arena.cap and (expected_pending is not None
                                or self._queues is not None):
            ctx.arena_dev = {
                name: torch.zeros(getattr(self._arena, name).shape,
                                  dtype=torch.from_numpy(getattr(
                                      self._arena, name)[:0]).dtype,
                                  device=self.device)
                for name in ARENA_FIELDS}
            ctx.arena_cap = self._arena.cap
        return ctx

    def _warm_zeros(self, ctx) -> tuple:
        """Fresh zero usage and cohort usage on the device (a resident
        variant's prologue writes them in place)."""
        return (torch.zeros(ctx.usage, dtype=torch.int64,
                            device=self.device),
                torch.zeros(ctx.cohort_usage, dtype=torch.int64,
                            device=self.device))

    @staticmethod
    def _warm_batch_arrays(topo, width: int, max_podsets: int):
        """A batch of `width`'s bucket of inert rows (nothing solvable)
        and an all-zero resume-rank array."""
        _, F, R = topo.nominal.shape
        W = encode._bucket(max(1, width))
        P = max_podsets
        return (W, np.zeros((W, P, R), np.int64), np.zeros((W, P), bool),
                np.zeros(W, np.int32), np.zeros(W, np.int64),
                np.zeros(W, np.float64), np.zeros((W, P, F), bool),
                np.zeros(W, bool), np.zeros((W, P, R), np.int32))

    def _cluster_variants(self, ctx) -> list:
        """(cluster args on the device or None, kdim) for each variant a
        solve warms: without columns, and at the snapshot's columns when
        it carried any (kueue_tpu/solver/service.py:680-692)."""
        variants = [(None, None)]
        cluster = ctx.cluster
        if cluster is not None:
            variants.append((tuple(self._upload(a) for a in
                                   encode.cluster_args_device(cluster)),
                             cluster.ccap.shape))
        return variants

    def warm_router(self, ctx, width: int) -> int:
        """The fit router (K1, K2) at one width bucket, with and without
        resume ranks: 2 programs, as the JAX package counts them."""
        topo = ctx.topo
        (W, requests, podset_active, wl_cq, priority, timestamp,
         eligible, solvable, start_rank) = self._warm_batch_arrays(
            topo, width, self.max_podsets)
        b = encode.WorkloadBatch(infos=[], n=0)
        (b.requests, b.podset_active, b.wl_cq, b.priority, b.timestamp,
         b.eligible, b.solvable, b.start_rank) = (
            requests, podset_active, wl_cq, priority, timestamp, eligible,
            solvable, start_rank)
        state = encode.State(usage=np.zeros(ctx.usage, np.int64),
                             cohort_usage=np.zeros(ctx.cohort_usage,
                                                   np.int64))
        self._route(ctx.topo_dev, state, b, None, warm=True)
        self._route(ctx.topo_dev, state, b, start_rank, warm=True)
        return 2

    def _warm_launch(self, kind: str, ctx, dev: list, deltas, kw: dict):
        """One launch of a solve program on the warm's inert batch."""
        usage, cohort_usage = self._warm_zeros(ctx)
        if kind == "fused":
            if kw.get("preempt_args") is None \
                    and kw.get("fair_preempt_args") is None:
                kw = {k: v for k, v in kw.items()
                      if k not in ("preempt_args", "fair_preempt_args",
                                   "fs_strategies")}
                return solve_cycle_fused(ctx.topo_dev, usage, cohort_usage,
                                         *dev, **kw)
            kw = dict(kw)
            pargs = kw.pop("preempt_args")
            return solve_cycle_with_preempt(ctx.topo_dev, usage,
                                            cohort_usage, *dev, pargs, **kw)
        deltas_dev = None if deltas is None else \
            tuple(self._upload(a) for a in deltas)
        if kind == "resident":
            return solve_cycle_resident(ctx.topo_dev, usage, cohort_usage,
                                        deltas_dev, *dev, **kw)
        slots = self._upload(np.full(dev[0].shape[0], -1, np.int32))
        return solve_cycle_resident_arena(ctx.topo_dev, usage, cohort_usage,
                                          deltas_dev, ctx.arena_dev, slots,
                                          **kw)

    def _warm_solves(self, ctx, width: int, max_ranks, deltas_buckets,
                     fair_sharing: bool, variants, srs) -> int:
        """The solve programs of one width bucket (the shared body of
        warm_bucket and warm_preempt_bucket): for each rank rung, resume
        flag, preemption variant and cluster variant, the fused (or with
        preemption) program and the resident one (the arena one when the
        arena is engaged) without and with each delta bucket. Each
        distinct program is launched once (a rank rung changes no kernel
        here); every JAX key is registered and counted."""
        topo = ctx.topo
        dims = self._topo_dims(topo)
        (W, *arrays, sr_arr) = self._warm_batch_arrays(
            topo, width, self.max_podsets)
        P = self.max_podsets
        dev = [self._upload(a) for a in arrays]
        sr_dev = self._upload(sr_arr)
        L = topo.cq_chain.shape[1]
        compact = self._compact_flag(topo)
        clusters = self._cluster_variants(ctx)
        launched: set = set()
        warmed = 0

        def run(kind, launch_key, deltas, kw):
            if launch_key not in launched:
                launched.add(launch_key)
                self._warm_launch(kind, ctx, dev, deltas, kw)

        for max_rank in dict.fromkeys(max_ranks):
            for vi, (pargs, psh, fargs, fsh, fflags) in enumerate(variants):
                for sr_on in srs:
                    for ci, (cargs, kdim) in enumerate(clusters):
                        kw = dict(num_podsets=P, fair_sharing=fair_sharing,
                                  start_rank=sr_dev if sr_on else None,
                                  compact=compact, cluster_args=cargs,
                                  preempt_args=pargs,
                                  fair_preempt_args=fargs,
                                  fs_strategies=fflags)
                        base = (vi, sr_on, ci)
                        preempting = pargs is not None or fargs is not None
                        run("fused", ("fused",) + base, None, kw)
                        note_program(
                            ("preempt" if preempting else "fused", dims, W,
                             P, max_rank, fair_sharing, sr_on)
                            + ((psh, fsh, fflags) if preempting
                               else ((), (), ())) + (compact, kdim))
                        warmed += 1
                        for dlt in (None,) + tuple(deltas_buckets):
                            deltas = _warm_deltas(L, dlt)
                            if ctx.arena_dev is None:
                                run("resident", ("resident", dlt) + base,
                                    deltas, kw)
                                key = ("resident", dims, W, P, max_rank,
                                       fair_sharing, sr_on, dlt, psh, fsh,
                                       fflags, compact, kdim)
                            else:
                                run("arena", ("arena", dlt) + base, deltas,
                                    kw)
                                key = ("arena", dims, ctx.arena_cap, W, P,
                                       max_rank, fair_sharing, sr_on, dlt,
                                       psh, fsh, fflags, compact, kdim)
                            note_program(key)
                            warmed += 1
        return warmed

    def warm_bucket(self, ctx, width: int, max_ranks=(8, 32, 128, 512),
                    deltas_buckets=(8,), fair_sharing: bool = False) -> int:
        """Every fit-path solve program of one width bucket
        (kueue_tpu/solver/service.py:612-677): the fused cycle (K1, K2,
        K4, K5, K8, and K3 with fair sharing) and the resident cycle
        with and without a delta prologue (K6), gathering from the
        arena twin (K7b) when the arena is engaged, each with and without
        resume ranks and per cluster variant (K12). Returns the JAX
        package's count for the same ladder."""
        return self._warm_solves(ctx, width, max_ranks, deltas_buckets,
                                 fair_sharing, [(None, (), None, (), ())],
                                 (False, True))

    def warm_scatter(self, ctx) -> int:
        """The arena scatter (K7a) at each changed-row bucket, on a
        throwaway zero twin with every slot out of range (dropped): one
        program a bucket (kueue_tpu/solver/service.py:694-718)."""
        if ctx.arena_dev is None:
            return 0
        from kueue_tpu_torch.solver.arena import _UPD_BUCKETS
        dims = self._topo_dims(ctx.topo)
        warmed = 0
        for D in _UPD_BUCKETS:
            slots = self._upload(np.full(D, ctx.arena_cap, np.int32))
            rows = {name: torch.zeros((D,) + tuple(a.shape[1:]),
                                      dtype=a.dtype, device=self.device)
                    for name, a in ctx.arena_dev.items()}
            burn = {name: torch.zeros_like(a)
                    for name, a in ctx.arena_dev.items()}
            kernel.scatter_arena_rows(burn, slots, rows)
            note_program(("scatter", ctx.arena_cap, self.max_podsets, dims,
                          D))
            warmed += 1
        return warmed

    def warm_preempt_bucket(self, ctx, width: int, pshapes,
                            max_ranks=(8,), deltas_buckets=(8,),
                            fair_sharing: bool = False,
                            fs_flags: tuple = (),
                            start_rank: bool = False) -> int:
        """The mixed admission and preemption programs of one width
        bucket over the preemption shape ladder `pshapes` (dicts of
        bucketed B, K, QL, CL, RF, U; kueue_tpu/solver/service.py:
        720-884): without fair sharing a minimal batch (K9) per shape;
        with it, minimal batches of the QL = 1 shapes, fair batches (K11)
        of the wider ones, and mixed pairs of equal B. Each variant is
        launched as the pipelined cycle runs it (in the solve, inert
        problems), and K9/K11 once more alone as the synchronous path's
        solve_preemptions runs them. Returns the JAX package's count."""
        if isinstance(pshapes, dict):
            pshapes = (pshapes,)
        DC = ctx.topo.cq_chain.shape[1]

        def build_pb(shape):
            B, K = shape["B"], shape["K"]
            QL, CL = shape["QL"], shape["CL"]
            RF, U = shape["RF"], shape["U"]
            pb = devpreempt.PreemptionBatch()
            pb.gq = np.full((B, QL), -1, np.int32)
            pb.gf = np.full((B, RF), -1, np.int32)
            pb.gr = np.zeros((B, RF), np.int32)
            pb.gc = np.full((B, CL), -1, np.int32)
            pb.chain_local = np.full((B, QL, DC), -1, np.int32)
            pb.requests = np.zeros((B, RF), np.int64)
            pb.frs_np = np.zeros((B, RF), bool)
            pb.cand_idx = np.zeros((B, K), np.int32)
            pb.cand_ql = np.full((B, K), -1, np.int16)
            pb.cand_usage = np.zeros((U, RF), np.int64)
            pb.cand_prio = np.zeros(U, np.int32)
            pb.allow_borrowing = np.zeros(B, bool)
            pb.threshold_active = np.zeros(B, bool)
            pb.threshold = np.zeros(B, np.int64)
            pb.has_cohort = np.zeros(B, bool)
            return pb

        def build_fb(pb, shape):
            B, K = shape["B"], shape["K"]
            QL, RF = shape["QL"], shape["RF"]
            fb = fairpreempt.FairBatch(
                **{f: getattr(pb, f) for f in (
                    "gq", "gf", "gr", "gc", "chain_local", "requests",
                    "frs_np", "cand_idx", "cand_ql", "cand_usage",
                    "cand_prio", "allow_borrowing", "threshold_active",
                    "threshold", "has_cohort")})
            fb.cand_rank = np.full((B, K), -1, np.int32)
            fb.cq_count = np.zeros((B, QL), np.int32)
            fb.cq_order = np.full((B, QL), 2**30, np.int32)
            fb.base_other = np.zeros((B, QL, RF), np.int64)
            fb.floor_ratio = np.full((B, QL), -1, np.int64)
            fb.floor_any = np.zeros((B, QL), bool)
            fb.weight = np.full((B, QL), 1000, np.int64)
            fb.lendable = np.zeros((B, RF), np.int64)
            return fb

        flags = tuple(fs_flags)
        built = []
        for shape in pshapes:
            pb = build_pb(shape)
            hp = preempt_args(pb)
            built.append((shape, pb, hp, tuple(a.shape for a in hp)))
        # (host pargs, pshapes key, host fargs, fshapes key, flags)
        host_variants = []
        for shape, pb, hp, psh in built:
            if not fair_sharing or shape["QL"] == 1:
                host_variants.append((hp, psh, None, (), ()))
        if fair_sharing:
            fair_by_b = {}
            for shape, pb, hp, psh in built:
                if shape["QL"] > 1:
                    hf = fair_args(build_fb(pb, shape))
                    fsh = tuple(a.shape for a in hf)
                    host_variants.append((None, (), hf, fsh, flags))
                    fair_by_b.setdefault(shape["B"], (hf, fsh))
            for shape, pb, hp, psh in built:
                if shape["QL"] == 1 and shape["B"] in fair_by_b:
                    hf, fsh = fair_by_b[shape["B"]]
                    host_variants.append((hp, psh, hf, fsh, flags))
        variants = []
        dims = self._topo_dims(ctx.topo)
        for hp, psh, hf, fsh, fflags in host_variants:
            pargs = None if hp is None else hp.map(self._upload)
            fargs = None if hf is None else tuple(self._upload(a)
                                                  for a in hf)
            variants.append((pargs, psh, fargs, fsh, fflags))
            if note_program(("preempt-solve", dims, psh, fsh, fflags)):
                usage, cohort_usage = self._warm_zeros(ctx)
                kernel.solve_preemptions(ctx.topo_dev, usage, cohort_usage,
                                         pargs, fargs, fflags)
        return self._warm_solves(ctx, width, max_ranks, deltas_buckets,
                                 fair_sharing, variants, (start_rank,))

    def bind_queues(self, queues) -> None:
        """Attach the queue Manager's workload delta feed: the encode
        arena's rows are invalidated/freed by deltas instead of being
        rebuilt per cycle. Idempotent."""
        if self._queues is queues:
            return
        self._queues = queues
        queues.add_workload_listener(self._arena.note)

    def release_workload(self, key: str) -> None:
        """The workload was admitted (it holds quota and leaves the
        pending set without a queue-manager delete), so its arena slot
        can be recycled."""
        self._arena.release(key)

    def slot_generations(self, slots):
        """Per-slot encode-arena generations for a dispatched batch's
        slots: any upsert/delete of a dispatched workload since bumps its
        slot's generation. None when no Manager is bound."""
        if slots is None or self._queues is None:
            return None
        return self._arena.slot_generations(slots)

    @property
    def resident_capable(self) -> bool:
        return self._cache is not None and self.mesh is None

    @property
    def arena(self) -> WorkloadArena:
        return self._arena

    @property
    def resident(self) -> Optional[ResidentState]:
        return self._resident

    def _sync(self) -> None:
        """Wait for the device (counted in counters["syncs"], also on
        the CPU, where there is nothing to wait for)."""
        self.counters["syncs"] += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def estimated_sync_ms(self) -> float:
        """The device's launch-and-sync floor (kueue_tpu/solver/
        service.py:434): a trivial launch and sync, timed once, and the
        minimum of it and the observed ones (a floor is a lower bound,
        robust to outliers such as a first launch that builds the
        kernels). The Scheduler's preemption work gate weighs it: device
        work must save more than this to be sent."""
        if self._probe_sync_ms is None:
            probe = torch.zeros(1, dtype=torch.int64, device=self.device)
            probe.add_(1)  # the first launch pays for the context
            self._sync()
            t0 = time.perf_counter()
            probe.add_(1)
            self._sync()
            self._probe_sync_ms = (time.perf_counter() - t0) * 1e3
        return min([self._probe_sync_ms, *self._sync_samples])

    def _observe_sync(self, ms: float) -> None:
        self._sync_samples.append(ms)
        if len(self._sync_samples) > 16:
            self._sync_samples.pop(0)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the solver's device that owns its
        memory (on the CPU a plain .to() would alias the array, and the
        resident tensors are updated in place)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                             copy=True)

    def _topology(self, snapshot: Snapshot):
        # keyed on topology_epoch: it bumps on every spec change that
        # alters the encoded tensors, never on workload churn
        key = snapshot.topology_epoch
        if key != self._topo_key or self._topo_cache is None:
            own_snap = None
            try:
                if snapshot.light and self._cache is not None:
                    # the topology encode walks whole resource trees:
                    # never off a light snapshot's shared live ones
                    snapshot = own_snap = self._cache.snapshot()
                    key = snapshot.topology_epoch
                topo = encode.encode_topology(snapshot)
                self._topo_cache = (topo, topo_to_device(topo, self.device))
                # stamped after the cache tuple is built: a fault in the
                # encode leaves the old (key, cache) pair consistent
                self._topo_key = key
            finally:
                if own_snap is not None:
                    self._cache.release_snapshot(own_snap)
        return self._topo_cache

    def prepare(self, snapshot: Snapshot, entries: list,
                route: bool = False) -> Optional[Plan]:
        """Encode the cycle; None when nothing is solvable. With a bound
        cache the usage state is device-resident and reconciled through
        the journal; with bound queues the batch comes from the arena,
        and the slots' generations are captured for the speculation
        token (Plan.slot_gens). With route (the pipelined cycle's call)
        the router's fit bits go into Plan.fit_pred (_route, timed as
        last_phase_s["route"]). Starts the cycle's phase times
        (last_phase_s)."""
        self.last_phase_s = dict.fromkeys(PHASES, 0.0)
        if not entries:
            return None
        t0 = time.perf_counter()
        topo, topo_dev = self._topology(snapshot)
        cycle_snapshot = snapshot
        state, deltas, resident, snapshot = self._state_for_cycle(snapshot,
                                                                  topo)
        # An establish off a light snapshot took a full one of its own:
        # released on every exit, fault paths included.
        own_snap = snapshot if snapshot is not cycle_snapshot else None
        try:
            if resident:
                self.counters["resident_cycles"] += 1
            slots = slot_gens = None
            if self._queues is not None:
                self._arena.begin_cycle(topo)
                batch, slots = self._arena.assemble(entries, snapshot, topo,
                                                    self.ordering,
                                                    self.max_podsets)
                slot_gens = self._arena.gen[
                    np.asarray(slots, np.int64)].copy()
            else:
                batch = encode.encode_workloads(entries, snapshot, topo,
                                                max_podsets=self.max_podsets)
        finally:
            if own_snap is not None:
                self._cache.release_snapshot(own_snap)
        cluster = encode.encode_cluster_columns(cycle_snapshot, topo)
        t1 = time.perf_counter()
        self.last_phase_s["encode"] = t1 - t0
        self._phase("encode", t0, t1)
        if not batch.solvable.any():
            return None
        start_rank = batch.start_rank if batch.start_rank.any() else None
        fit_pred = None
        if route:
            fit_pred = self._route(topo_dev, state, batch, start_rank)
            t2 = time.perf_counter()
            self.last_phase_s["route"] = t2 - t1
            self._phase("route", t1, t2)
        plan = Plan(topo, topo_dev, state, batch, start_rank, fit_pred)
        plan.cluster = cluster
        plan.slots = slots
        plan.slot_gens = slot_gens
        plan.deltas = deltas
        plan.resident = resident
        if resident:
            plan.rs = self._resident  # identity-pinned: a residency reset
            plan.backlog_gen = self._resident.backlog_gen
        return plan

    def _route(self, topo_dev, state, batch, start_rank,
               warm: bool = False) -> np.ndarray:
        """The fit router (kueue_tpu/solver/service.py:1183-1217): Phase A
        (kernel.solve_phase_a, fair sharing off, the batch's resume
        ranks) against the host mirror of the resident usage
        (state.usage, state.cohort_usage), with the batch's rows,
        uploaded to the solver's device. One sync, counted in
        counters["syncs"]; returns fit[:n] as a numpy bool array.

        A warm (warm_router) registers its variant without counting a
        mid-traffic compile and leaves the transport counters alone.

        On the card it launches avail and phase_a (K1, K2), or raises;
        on the CPU it runs their plain versions. There is no host-side
        route: the JAX package runs the same program on its local CPU
        backend. The launches share the device's default stream with
        any dispatch still in flight, so the router's sync waits behind
        that dispatch's kernels."""
        topo = self._topo_cache[0]
        key = ("route", self._topo_dims(topo), batch.requests.shape[0],
               self.max_podsets, start_rank is not None)
        if warm:
            note_program(key)
        else:
            self._note_variant(key, batch.requests.shape[0])
        host = (state.usage, state.cohort_usage, batch.requests,
                batch.podset_active, batch.wl_cq, batch.eligible,
                batch.solvable)
        fit = kernel.solve_phase_a(
            topo_dev, *(self._upload(a) for a in host),
            num_podsets=self.max_podsets, fair_sharing=False,
            start_rank=None if start_rank is None else
            self._upload(start_rank))[0]
        if warm:
            fit = fit.cpu().numpy()  # waits for the launches
            return fit[:batch.n].astype(bool)
        self._sync()
        up = sum(a.nbytes for a in host)
        if start_rank is not None:
            up += start_rank.nbytes
        self.counters["upload_bytes"] += up
        fit = fit.cpu().numpy()
        self.counters["fetch_bytes"] += fit.nbytes
        return fit[:batch.n].astype(bool)

    # --- device-resident state management ---

    def _state_for_cycle(self, snapshot: Snapshot, topo):
        """Returns (state-with-mirror-arrays, encoded deltas or None,
        resident?, the snapshot the cycle encodes against: an establish
        replaces a light one by a full one of its own). Establishes
        residency on the first cycle (full encode + upload), reconciles
        via the journal afterwards."""
        if not self.resident_capable:
            return encode.encode_state(snapshot, topo), None, False, snapshot
        rs = self._resident
        if rs is not None and rs.token == topo.token \
                and self._reconcile(snapshot, topo):
            state = encode.State(usage=rs.mirror_usage,
                                 cohort_usage=rs.mirror_cohort)
            if len(rs.device_backlog) > MAX_BACKLOG:
                # A huge correction set (mass completions): the mirror IS
                # device state + backlog, so re-upload it wholesale.
                rs.usage_dev = None
                rs.cohort_dev = None
                rs.device_backlog = {}
            if rs.usage_dev is None:
                # Not dispatched yet: the establishing upload ships the
                # (already-corrected) mirror itself — shipping the backlog
                # as a delta prologue too would double-count it.
                rs.device_backlog = {}
                deltas = None
            else:
                deltas = (encode.encode_deltas(rs.device_backlog, topo)
                          if rs.device_backlog else None)
                if deltas is None:
                    rs.device_backlog = {}
            return state, deltas, True, snapshot
        # (re)establish: the snapshot is the full truth — drop any journal
        # history up to it, encode once, upload once. A light snapshot's
        # usage is live, not frozen at its journal_seq: take a full one,
        # and bail out if the topology moved in between.
        if snapshot.light:
            snapshot = self._cache.snapshot()
            if snapshot.topology_epoch != self._topo_key:
                self._cache.release_snapshot(snapshot)
                raise RuntimeError("topology moved during establish")
        self._cache.drain_usage_journal(snapshot.journal_seq)
        state = encode.encode_state(snapshot, topo)
        rs = ResidentState(topo.token)
        rs.mirror_usage = state.usage
        rs.mirror_cohort = state.cohort_usage
        self._resident = rs
        return state, None, True, snapshot

    def _reconcile(self, snapshot: Snapshot, topo) -> bool:
        """Drain the cache journal up to the snapshot: device admissions
        confirmed by their assume write cancel; everything else (other
        admissions, evictions, finishes, reverts of failed assumes)
        becomes a sparse correction applied to the mirror now and shipped
        to the device at the next dispatch. False = residency must be
        dropped (journal overflow)."""
        # Fault site: a replay fault propagates out of prepare(); the
        # Scheduler drops residency and the cycle re-establishes from a
        # fresh full snapshot. The mirror is only written after the
        # whole drain below succeeds.
        faultinject.site(faultinject.SITE_REPLAY)
        rs = self._resident
        entries, overflow = self._cache.drain_usage_journal(
            snapshot.journal_seq)
        if overflow:
            self._resident = None
            return False
        corr: dict = {}
        for entry in entries:
            kind, cq_name, key, usage = entry[1], entry[2], entry[3], entry[4]
            if kind == "add":
                p = rs.pending.pop(key, None)
                if p is not None:
                    pcq, pusage, _age = p
                    if pcq == cq_name and pusage == usage:
                        continue  # confirmed exactly — device already has it
                    # divergent confirmation: revert the device's version,
                    # then apply the journal's
                    for fr, v in pusage.items():
                        k = (pcq, fr)
                        corr[k] = corr.get(k, 0) - v
                sign = 1
            elif kind == "del":
                sign = -1
            else:
                continue  # 'cq' / 'ready': no usage movement
            for fr, v in usage.items():
                k = (cq_name, fr)
                corr[k] = corr.get(k, 0) + sign * v
        # age out device admissions never confirmed (aborted cycles);
        # note_unapplied() covers the common failure synchronously.
        expired = [k for k, (_cq, _u, age) in rs.pending.items() if age >= 3]
        for key in expired:
            pcq, pusage, _age = rs.pending.pop(key)
            for fr, v in pusage.items():
                k = (pcq, fr)
                corr[k] = corr.get(k, 0) - v
        for key, (pcq, pusage, age) in rs.pending.items():
            rs.pending[key] = (pcq, pusage, age + 1)
        if corr:
            self._apply_corrections(rs, topo, corr)
        return True

    @staticmethod
    def _apply_corrections(rs: ResidentState, topo, corr: dict) -> None:
        """Fold net corrections into the mirror NOW and the device backlog
        (shipped as the next dispatch's delta prologue)."""
        deltas = encode.encode_deltas(corr, topo)
        if deltas is not None:
            encode.apply_deltas_np(topo, rs.mirror_usage,
                                   rs.mirror_cohort, deltas)
        for k, v in corr.items():
            nv = rs.device_backlog.get(k, 0) + v
            if nv:
                rs.device_backlog[k] = nv
            else:
                rs.device_backlog.pop(k, None)

    def note_unapplied(self, key: str) -> None:
        """The caller failed to assume a device-admitted workload: revert
        it from the mirror and queue the device correction."""
        rs = self._resident
        if rs is None:
            return
        p = rs.pending.pop(key, None)
        if p is None:
            return
        pcq, pusage, _age = p
        corr = {(pcq, fr): -v for fr, v in pusage.items()}
        topo = self._topo_cache[0] if self._topo_cache else None
        if topo is not None:
            self._apply_corrections(rs, topo, corr)

    def invalidate_resident(self) -> None:
        self._resident = None
        # The arena twin may hold rows from an aborted dispatch whose
        # dirty-set was already cleared: force a full re-upload.
        self._arena.drop_device()

    # --- the cycle ---

    def dispatch(self, plan: Plan, fair_sharing: bool = False,
                 preempt_batch=None, fair_batch=None,
                 fs_flags: tuple = (), deadline_s: Optional[float] = None,
                 supervise_deadline_s: Optional[float] = None) -> InFlight:
        """Upload what the cycle needs and launch it, without waiting for
        it. Returns the InFlight that collect takes. Bound, the upload is
        the heads' slot indices, the arena's changed rows, the delta
        prologue and the flavor-resume ranks; unbound, the state and the
        whole batch. fair_sharing orders the admits by DRF share
        (kernel.drf_share); a preempt_batch (solver/preempt.py) and a
        fair_batch (solver/fairpreempt.py, solved with the strategy flags
        fs_flags) are solved in the same call against the same usage
        (kernel.solve_cycle_with_preempt). The usage the cycle read is
        kept for solve_preemptions. Under a mesh the cycle is
        parallel.mesh.solve_cycle_sharded and a preempt_batch is solved by
        solve_preempt_sharded; a fair_batch raises.

        deadline_s bounds the collect (stamped on the InFlight). With
        supervise_deadline_s (and supervise_dispatch on) the dispatch
        runs on the supervised worker thread and one past it raises
        SupervisedTimeout (kueue_tpu/solver/service.py:1294-1331);
        whatever else the dispatch raises reaches the caller unchanged."""
        if supervise_deadline_s is None or not self.supervise_dispatch:
            return self._dispatch_impl(plan, fair_sharing, preempt_batch,
                                       fair_batch, fs_flags, deadline_s)
        epoch = self._dispatch_epoch
        index = None
        if self.device.type == "cuda":
            # the worker thread's current device is 0 whatever the
            # caller's is: it launches on the solver's device, or on the
            # caller's current one for a bare "cuda"
            index = self.device.index
            if index is None:
                index = torch.cuda.current_device()
        try:
            return self._supervisor.run(
                self._dispatch_on, index, plan, fair_sharing, preempt_batch,
                fair_batch, fs_flags, deadline_s, epoch,
                deadline_s=supervise_deadline_s)
        except DispatchTimeout:
            self._dispatch_epoch = epoch + 1
            self.counters["supervised_timeouts"] += 1
            raise

    def _dispatch_on(self, index: Optional[int], *args) -> InFlight:
        """_dispatch_impl on the supervised worker, under the CUDA device
        `index` (None off the card)."""
        if index is None:
            return self._dispatch_impl(*args)
        with torch.cuda.device(index):
            return self._dispatch_impl(*args)

    def _check_epoch(self, epoch: Optional[int]) -> None:
        """A dispatch the supervisor abandoned must not launch or write
        what the live cycle owns: it raises a DeviceFault that nobody
        sees (it parks on the orphaned request)."""
        if epoch is not None and epoch != self._dispatch_epoch:
            raise DeviceFault("dispatch abandoned by supervisor")

    def _dispatch_impl(self, plan: Plan, fair_sharing: bool = False,
                       preempt_batch=None, fair_batch=None,
                       fs_flags: tuple = (),
                       deadline_s: Optional[float] = None,
                       epoch: Optional[int] = None) -> InFlight:
        # Fault site: a raise is a failed dispatch, a delay the hang the
        # supervised deadline bounds.
        faultinject.site(faultinject.SITE_DISPATCH)
        self._check_epoch(epoch)
        if epoch is None:
            return self._dispatch_body(plan, fair_sharing, preempt_batch,
                                       fair_batch, fs_flags, deadline_s,
                                       epoch)
        kernel.launch_guard.check = lambda: self._check_epoch(epoch)
        try:
            return self._dispatch_body(plan, fair_sharing, preempt_batch,
                                       fair_batch, fs_flags, deadline_s,
                                       epoch)
        finally:
            kernel.launch_guard.check = None

    def _prepare_arena(self, epoch: Optional[int]) -> tuple:
        """(The arena twin, current as of the host rows, its changed rows
        scattered by K7a; the bytes uploaded; arena.last_scramble), under
        the arena lock: at most one dispatch,
        live or orphaned, is ever inside the upload
        (kueue_tpu/solver/service.py:1422-1451)."""
        if not self._arena_lock.acquire(timeout=1.0):
            raise DeviceFault("arena upload busy: a previous dispatch is "
                              "wedged in the device upload")
        try:
            self._check_epoch(epoch)
            arena_dev, up = self._arena.prepare_device(self.device)
            scramble = self._arena.last_scramble
            if epoch is not None and epoch != self._dispatch_epoch:
                # abandoned while inside the upload: the twin is stale
                self._arena.drop_device()
                raise DeviceFault("dispatch abandoned by supervisor")
        finally:
            self._arena_lock.release()
        return arena_dev, up, scramble

    def _dispatch_body(self, plan: Plan, fair_sharing, preempt_batch,
                       fair_batch, fs_flags, deadline_s,
                       epoch) -> InFlight:
        td = time.perf_counter()
        if self.mesh is not None:
            if fair_batch is not None:
                raise ValueError(_NO_FAIR_UNDER_MESH)
            self.last_domain_plan = meshpkg.plan_cycle(self.mesh, plan.topo,
                                                       plan.batch.wl_cq)
            tp = time.perf_counter()
            self.last_phase_s["plan"] = tp - td
            self._phase("dispatch.plan", td, tp)
        t0 = td
        scramble = None
        topo, batch, state = plan.topo, plan.batch, plan.state
        compact = self._compact_flag(topo)
        # the variant key (kueue_tpu/solver/service.py:1376-1396): a
        # dispatch of a registered variant never counts a mid-traffic
        # compile, one of an unregistered variant always does
        dims = self._topo_dims(topo)
        W = batch.requests.shape[0]
        D = plan.deltas[0].shape[0] if plan.deltas is not None else None
        # over the bucket's rows, padding (wl_cq 0) included, as the JAX
        # key counts them
        max_rank = kernel.max_rank_bound(
            batch.wl_cq, topo.cq_cohort, topo.cohort_root) \
            if self.warm_ladder else None
        sr_flag = plan.start_rank is not None
        kdim = plan.cluster.ccap.shape if plan.cluster is not None else None
        start_rank = None if plan.start_rank is None else \
            self._upload(plan.start_rank)
        # Identity check: the plan must have been built on the CURRENT
        # ResidentState — after an invalidate + re-establish, a stale
        # plan's decisions must not chain into the fresh device arrays.
        rs = self._resident
        if plan.resident and plan.rs is not rs:
            plan.resident = False
        establishing = rs is None or rs.usage_dev is None
        batch_np = (batch.requests, batch.podset_active, batch.wl_cq,
                    batch.priority, batch.timestamp, batch.eligible,
                    batch.solvable)
        # MultiKueue capacity columns ride the same cycle
        # (kernel.score_cluster_columns)
        host_cargs = None if plan.cluster is None else \
            encode.cluster_args_device(plan.cluster)
        kwargs = dict(num_podsets=self.max_podsets, fair_sharing=fair_sharing,
                      start_rank=start_rank, compact=compact,
                      cluster_args=None if host_cargs is None else
                      tuple(self._upload(a) for a in host_cargs))
        host_pargs = pargs = host_fargs = fargs = None
        if preempt_batch is not None:
            host_pargs = preempt_args(preempt_batch)
            pargs = host_pargs.map(self._upload)
        if fair_batch is not None:
            host_fargs = fair_args(fair_batch)
            fargs = tuple(self._upload(a) for a in host_fargs)
            kwargs.update(fair_preempt_args=fargs,
                          fs_strategies=tuple(fs_flags))
        pshapes = (tuple(a.shape for a in host_pargs)
                   if host_pargs is not None else ())
        fshapes = (tuple(a.shape for a in host_fargs)
                   if host_fargs is not None else ())
        flags = tuple(fs_flags) if host_fargs is not None else ()
        if plan.resident and rs is not None and rs.token == topo.token:
            if rs.usage_dev is None:
                usage_in = self._upload(state.usage)
                cohort_in = self._upload(state.cohort_usage)
            else:
                usage_in, cohort_in = rs.usage_dev, rs.cohort_dev
            deltas = None if plan.deltas is None else \
                tuple(self._upload(a) for a in plan.deltas)
            if plan.slots is not None:
                # Arena dispatch: the batch rows already live on the
                # device — ship the head slots and the changed rows.
                t_sc = time.perf_counter()
                arena_dev, up, scramble = self._prepare_arena(epoch)
                self._phase("dispatch.scatter", t_sc, time.perf_counter())
                self._note_variant(("arena", dims, self._arena.cap, W,
                                    self.max_podsets, max_rank,
                                    fair_sharing, sr_flag, D, pshapes,
                                    fshapes, flags, compact, kdim), W)
                slots_w = np.full(batch.requests.shape[0], -1, np.int32)
                slots_w[:batch.n] = plan.slots
                slots_dev = self._upload(slots_w)
                up += slots_w.nbytes
                self._sync()
                t1, start_event = self._launch_mark()
                # the delta prologue writes the resident usage in place
                self._check_epoch(epoch)
                result = solve_cycle_resident_arena(
                    plan.topo_dev, usage_in, cohort_in, deltas, arena_dev,
                    slots_dev, preempt_args=pargs, **kwargs)
            else:
                self._note_variant(("resident", dims, W, self.max_podsets,
                                    max_rank, fair_sharing, sr_flag, D,
                                    pshapes, fshapes, flags, compact,
                                    kdim), W)
                dev = [self._upload(a) for a in batch_np]
                up = sum(a.nbytes for a in batch_np)
                self._sync()
                t1, start_event = self._launch_mark()
                self._check_epoch(epoch)
                result = solve_cycle_resident(
                    plan.topo_dev, usage_in, cohort_in, deltas, *dev,
                    preempt_args=pargs, **kwargs)
            self._check_epoch(epoch)
            # usage_in/cohort_in now hold the corrected pre-cycle usage
            # (the prologue ran in place; phase_b wrote copies)
            self._cycle_state = (plan.topo_dev, usage_in, cohort_in)
            rs.usage_dev = result["usage"]
            rs.cohort_dev = result["cohort_usage"]
            if plan.deltas is not None and plan.backlog_gen == rs.backlog_gen:
                rs.device_backlog = {}
                rs.backlog_gen += 1
        else:
            plan.resident = False
            dev = [self._upload(a) for a in
                   (state.usage, state.cohort_usage, *batch_np)]
            up = sum(a.nbytes for a in batch_np)
            self._sync()
            t1, start_event = self._launch_mark()
            self._check_epoch(epoch)
            if self.mesh is not None:
                result = meshpkg.solve_cycle_sharded(
                    self.mesh, plan.topo_dev, *dev, plan=self.last_domain_plan,
                    **kwargs)
                if pargs is not None:
                    result.update(zip(PREEMPT_KEYS,
                                      meshpkg.solve_preempt_sharded(
                                          self.mesh, plan.topo_dev, dev[0],
                                          dev[1], pargs,
                                          meshpkg.preempt_weights(
                                              host_pargs[7]))))
            elif pargs is None and fargs is None:
                self._note_variant(("fused", dims, W, self.max_podsets,
                                    max_rank, fair_sharing, sr_flag,
                                    (), (), (), compact, kdim), W)
                result = solve_cycle_fused(plan.topo_dev, *dev, **kwargs)
            else:
                self._note_variant(("preempt", dims, W, self.max_podsets,
                                    max_rank, fair_sharing, sr_flag,
                                    pshapes, fshapes, flags, compact,
                                    kdim), W)
                result = solve_cycle_with_preempt(plan.topo_dev, *dev, pargs,
                                                  **kwargs)
            self._check_epoch(epoch)
            self._cycle_state = (plan.topo_dev, dev[0], dev[1])
        event = None
        if self.device.type == "cuda":
            # recorded on this thread's current stream, the device's
            # default one (see kernel._launch), after the cycle's launches
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        self.last_phase_s["upload"] = t1 - t0 - self.last_phase_s["plan"]
        for host in (host_pargs, host_fargs, host_cargs):
            if host is not None:
                up += sum(a.nbytes for a in host)
        if plan.start_rank is not None:
            up += plan.start_rank.nbytes
        if not plan.resident or establishing:
            up += state.usage.nbytes + state.cohort_usage.nbytes
        if plan.resident and plan.deltas is not None:
            up += sum(a.nbytes for a in plan.deltas)
        self.last_upload_bytes = up
        self.counters["dispatches"] += 1
        self.counters["upload_bytes"] += up
        if plan.resident and establishing:
            self.counters["establishes"] += 1
        keys = DECISION_KEYS if compact else DENSE_DECISION_KEYS
        if plan.cluster is not None:
            keys = keys + ("mk_cluster",)
        if pargs is not None:
            keys = keys + PREEMPT_KEYS
        if fargs is not None:
            keys = keys + FAIR_KEYS
        inflight = InFlight(plan, result, keys, event, deadline_s, t1,
                            scramble=scramble, start_event=start_event,
                            preempt_batch=preempt_batch)
        self._phase("dispatch", t0, inflight.t_dispatch)
        return inflight

    def _launch_mark(self) -> tuple:
        """(host time, CUDA event or None) just before the cycle's
        launches: the event, recorded on the launching thread's stream,
        lets a pipelined collect read the launches' device time."""
        if self.device.type != "cuda":
            return time.perf_counter(), None
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        return time.perf_counter(), start

    def start_fetch(self, inflight: InFlight) -> None:
        """Start bringing the cycle's decisions home at dispatch (the
        pipelined cycle; kueue_tpu/solver/service.py:1583-1588): on the
        card, each decision tensor (inflight.keys) is copied into a
        pinned host buffer with non_blocking=True on the device's
        default stream, the one the launches ran on, and an event is
        recorded after the copies. collect then only waits on that
        event and reads the buffers. On the CPU the outputs already lie
        in host memory and are the buffers.

        No thread pool is needed, unlike the JAX package's _fetch_pool:
        the copies are queued behind the launches on the stream, and an
        abandoned cycle's event is simply never waited on again (the
        JAX package's _abandon_fetch has no counterpart)."""
        outputs = {k: inflight.result[k] for k in inflight.keys}
        if self.device.type != "cuda":
            inflight.host = outputs
            return
        index = self.device.index
        if index is None:
            index = torch.cuda.current_device()
        with torch.cuda.device(index):
            host = {}
            for k, t in outputs.items():
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                host[k] = buf
            event = torch.cuda.Event()
            event.record()
        inflight.host = host
        inflight.fetch_event = event

    def _await_device(self, inflight: InFlight) -> None:
        """Wait for the cycle's launches (and its started fetch): one
        sync, counted in counters["syncs"]. With a deadline the event is
        polled, and a cycle whose event has not completed by the
        deadline counted from the dispatch's end raises DispatchTimeout:
        its outputs are abandoned, nothing waits on them, and the next
        establish allocates fresh tensors on the same stream, ordered
        after them. An event that has completed raises nothing, however
        long ago the dispatch was (kueue_tpu/solver/service.py:
        1644-1683): in a pipelined cycle a whole host cycle passes
        between the dispatch and the collect.

        The "device" phase: on a synchronous collect, the time from the
        first launch to the end of the wait, which is also the sample
        the watchdog's deadline reads (_observe_sync); on a collect with
        a started fetch, the launches' device time read from the events
        recorded around them (on the CPU the dispatch's own launch
        time), and no sample: its launch-to-wait time holds a host
        cycle."""
        self.counters["syncs"] += 1
        event = inflight.fetch_event or inflight.event
        deadline = inflight.deadline_s
        if deadline is None:
            if event is not None:
                event.synchronize()
        elif event is not None:
            t_end = inflight.t_dispatch + deadline
            spins = 0
            while not event.query():
                if time.perf_counter() > t_end:
                    waited = time.perf_counter() - inflight.t_dispatch
                    self.counters["dispatch_timeouts"] += 1
                    raise DispatchTimeout(deadline, waited)
                spins += 1
                if spins > POLL_SPINS:
                    time.sleep(POLL_SLEEP_S)
        if inflight.host is None:
            self.last_phase_s["device"] = \
                time.perf_counter() - inflight.t_launch
            self._observe_sync(self.last_phase_s["device"] * 1e3)
        elif inflight.start_event is not None:
            self.last_phase_s["device"] = inflight.start_event.elapsed_time(
                inflight.event) / 1e3
        else:
            self.last_phase_s["device"] = \
                inflight.t_dispatch - inflight.t_launch

    def _validate_fetched(self, plan: Plan, fetched: dict) -> None:
        """The decisions' invariants (kueue_tpu/solver/service.py:
        1590-1616): a few [W]-bool checks. Outputs against them are
        corrupt: raise DeviceFault, so the Scheduler drops the resident
        state and nominates the heads on the CPU instead of turning
        garbage into admissions."""
        n = plan.batch.n
        fit = fetched.get("fit")
        admitted = fetched.get("admitted")
        if fit is None or admitted is None \
                or np.asarray(fit).shape[0] < n \
                or np.asarray(admitted).shape[0] < n:
            self.counters["validation_faults"] += 1
            raise DeviceFault("solve output missing/short decision arrays")
        fit = np.asarray(fit)[:n].astype(bool)
        admitted = np.asarray(admitted)[:n].astype(bool)
        if bool(np.any(admitted & ~fit)):
            self.counters["validation_faults"] += 1
            raise DeviceFault("solve output corrupt: admitted without fit")
        if bool(np.any(fit & ~plan.batch.solvable[:n])):
            self.counters["validation_faults"] += 1
            raise DeviceFault("solve output corrupt: fit on unsolvable row")

    def collect(self, inflight: InFlight, snapshot: Snapshot):
        """Wait for the cycle (under its deadline), fetch the decisions
        only (or read the buffers of a started fetch), check their
        invariants, unpack and decode them, and update the residency
        bookkeeping. Returns (decisions, aux): aux holds the preemption
        outputs when the cycle had preemption batches (preempt_aux),
        else None. Past the wait only collect's own time (the wait and
        any delay injected at SITE_COLLECT) is held against the
        deadline, never the host's time between dispatch and collect."""
        plan = inflight.plan
        t0 = time.perf_counter()
        self._await_device(inflight)
        t_dev = time.perf_counter()
        src = inflight.host
        if src is None:
            src = {k: inflight.result[k] for k in inflight.keys}
        # Fault site: CORRUPT scrambles the decision outputs (caught by
        # _validate_fetched), DELAY holds the collect past its deadline.
        outputs = faultinject.site(faultinject.SITE_COLLECT, src,
                                   corrupt=_scramble_outputs)
        deadline = inflight.deadline_s
        if deadline is not None:
            waited = time.perf_counter() - t0
            if waited > deadline:
                self.counters["dispatch_timeouts"] += 1
                raise DispatchTimeout(deadline, waited)
        t1 = time.perf_counter()
        # a copy per key: on the H100 it beats _fetch's one copy of the
        # two or three decision arrays (chip_smoke's fetch_timing); a
        # started fetch's buffers are host memory already
        fetched = {k: v.cpu().numpy() for k, v in outputs.items()}
        self.counters["fetch_bytes"] += sum(v.nbytes for v in fetched.values())
        fetched = unpack_decisions(fetched, self.max_podsets,
                                   plan.topo.nominal.shape[2])
        self._validate_fetched(plan, fetched)
        if inflight.scramble is not None:
            # rows scrambled on their way to the card (SITE_SCATTER's
            # CORRUPT) would only deny their heads, and the port sends a
            # head the card denies to its NoFit shortcut, not to the
            # CPU: the cycle is a fault, so the Scheduler drops the
            # resident state and the twin, which the next dispatch
            # uploads whole
            self.counters["scatter_faults"] += 1
            raise InjectedFault(faultinject.SITE_SCATTER, inflight.scramble)
        self.counters["collects"] += 1
        t2 = time.perf_counter()
        # the JAX package's fetch is its wait and its copy; the wait is
        # nested as fetch.device
        self._phase("fetch", t0, t2)
        self._phase("fetch.device", t0, t_dev)
        # Mirror/pending updates only apply when the plan's ResidentState
        # is still the live one (not invalidated+re-established since).
        resident_ok = plan.resident and plan.rs is self._resident
        decisions = self._decode_batch(
            plan.batch.infos, snapshot, plan.topo, plan.batch, fetched,
            resident=resident_ok,
            cluster_names=plan.cluster.names if plan.cluster else None)
        t3 = time.perf_counter()
        self.last_phase_s["fetch"] = t2 - t1
        self.last_phase_s["decode"] = t3 - t2
        self._phase("decode", t2, t3)
        return decisions, preempt_aux(fetched)

    def solve_prepared(self, plan: Plan, snapshot: Snapshot,
                       preempt_batch=None, fair_sharing: bool = False,
                       fair_batch=None, fs_flags: tuple = (),
                       deadline_s: Optional[float] = None,
                       supervise_deadline_s: Optional[float] = None) -> tuple:
        """Dispatch the prepared cycle, sync once, decode
        (kueue_tpu/solver/service.py:1219, single chip). A preempt_batch
        and a fair_batch (with its strategy flags fs_flags) are solved in
        the same dispatch against the same pre-cycle usage. deadline_s
        bounds the collect (DispatchTimeout), supervise_deadline_s the
        dispatch (SupervisedTimeout). Returns (decisions, aux), aux as
        collect returns it."""
        inflight = self.dispatch(plan, fair_sharing=fair_sharing,
                                 preempt_batch=preempt_batch,
                                 fair_batch=fair_batch, fs_flags=fs_flags,
                                 deadline_s=deadline_s,
                                 supervise_deadline_s=supervise_deadline_s)
        return self.collect(inflight, snapshot)

    def _fetch(self, result: dict, keys) -> dict:
        """The outputs `keys` in one device-to-host copy: their bytes side
        by side in one buffer on the device, the widest type first, so
        that every array starts aligned for its type with no padding (an
        array's byte length is a multiple of its element size), split
        again on the host."""
        ts = sorted(((k, result[k]) for k in keys),
                    key=lambda kt: -kt[1].element_size())
        host = torch.cat([t.reshape(-1).view(torch.uint8)
                          for _, t in ts]).cpu().numpy()
        out, off = {}, 0
        for k, t in ts:
            n = t.numel() * t.element_size()
            dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
            out[k] = host[off:off + n].view(dtype).reshape(tuple(t.shape))
            off += n
        return out

    def solve_preemptions(self, preempt_batch=None, fair_batch=None,
                          fs_flags: tuple = ()) -> Optional[dict]:
        """K9 on preempt_batch and K11 on fair_batch (with the strategy
        flags fs_flags, fairpreempt.strategy_flags), launched back to back
        (kernel.solve_preemptions) against the usage the last dispatch
        read: the cycle's usage from before its admissions, never the
        resident state Phase B left. One upload of both batches, one sync
        and one fetch for both, timed as last_phase_s["preempt"]. Under a
        mesh K9 runs through parallel.mesh.solve_preempt_sharded and a
        fair_batch raises. Returns the aux dict of preempt_aux (numpy),
        None with no batch."""
        if preempt_batch is None and fair_batch is None:
            return None
        if self._cycle_state is None:
            raise RuntimeError("solve_preemptions needs a dispatched cycle")
        if self.mesh is not None and fair_batch is not None:
            raise ValueError(_NO_FAIR_UNDER_MESH)
        t0 = time.perf_counter()
        topo_dev, usage, cohort_usage = self._cycle_state
        host_p = None if preempt_batch is None else preempt_args(
            preempt_batch)
        host_f = None if fair_batch is None else fair_args(fair_batch)
        # the port launches K9/K11 apart from the fit cycle: their own
        # variant, keyed by the batches' shapes
        if self._topo_cache is not None:
            self._note_variant((
                "preempt-solve", self._topo_dims(self._topo_cache[0]),
                tuple(a.shape for a in host_p) if host_p is not None
                else (),
                tuple(a.shape for a in host_f) if host_f is not None
                else (), tuple(fs_flags) if host_f is not None else ()),
                0 if host_p is None else len(host_p[0]))
        dev_p = None if host_p is None else host_p.map(self._upload)
        dev_f = None if host_f is None else \
            tuple(self._upload(a) for a in host_f)
        t1 = time.perf_counter()
        if self.mesh is None:
            out = kernel.solve_preemptions(topo_dev, usage, cohort_usage,
                                           dev_p, dev_f, tuple(fs_flags))
        else:
            out = dict(zip(PREEMPT_KEYS, meshpkg.solve_preempt_sharded(
                self.mesh, topo_dev, usage, cohort_usage, dev_p,
                meshpkg.preempt_weights(host_p[7]))))
        self._sync()
        self._observe_sync((time.perf_counter() - t1) * 1e3)
        fetched = self._fetch(out, [k for k in PREEMPT_KEYS + FAIR_KEYS
                                    if k in out])
        up = sum(a.nbytes for host in (host_p, host_f) if host is not None
                 for a in host)
        self.last_upload_bytes += up
        self.counters["upload_bytes"] += up
        self.counters["fetch_bytes"] += sum(v.nbytes
                                            for v in fetched.values())
        t1 = time.perf_counter()
        self.last_phase_s["preempt"] = t1 - t0
        self._phase("preempt-plan.solve", t0, t1)
        return preempt_aux(fetched)

    def batched_partial_admission(self, plan: Plan, snapshot: Snapshot,
                                  infos: list) -> dict:
        """Partial admission for many heads at once
        (kueue_tpu/solver/service.py:1732; reference:
        podset_reducer.go:29-86, run per head per probe). Every head's
        binary search over its reduction space (podset_reducer's
        reduction_space / counts_for_index, shared with the sequential
        PodSetReducer) advances in lockstep: each round, each active
        head's probe, a shadow Info with its pod sets scaled to the
        candidate counts, is one row of one encoded batch, uploaded and
        run through Phase A alone (kernel.solve_phase_a, fair sharing off,
        no resume ranks) against the usage the cycle's dispatch read
        (the pre-cycle state, never the mirror its decode has moved on);
        one sync a round, then its fit bits are fetched. Only for heads
        whose probes cannot pass by preemption: the caller keeps to
        Never/Never CQs, where the reducer's predicate is fit alone.

        Returns {head index: the largest counts that fit, None when none
        does, or CPU_FALLBACK when a probe could not be encoded}. The
        rounds are in last_partial_rounds, their time in
        last_phase_s["partial"]."""
        if self._cycle_state is None:
            raise RuntimeError("batched_partial_admission needs a "
                               "dispatched cycle")
        t0 = time.perf_counter()
        topo = plan.topo
        topo_dev, usage, cohort_usage = self._cycle_state

        def shadow(info, counts):
            s = wlpkg.Info.__new__(wlpkg.Info)
            s.obj = info.obj
            s.cluster_queue = info.cluster_queue
            s.last_assignment = None
            s._fru_cache = None
            s._fr_keys_cache = None
            s.total_requests = [
                psr if psr.count == c else psr.scaled_to(c)
                for psr, c in zip(info.total_requests, counts)]
            return s

        class _Search:
            __slots__ = ("full", "deltas", "total", "lo", "hi", "good")

            def __init__(self, pod_sets):
                self.full, self.deltas, self.total = reduction_space(pod_sets)
                self.lo, self.hi = 0, self.total + 1
                self.good = None

            def counts(self, i):
                return counts_for_index(self.full, self.deltas, self.total,
                                        i)

        searches = {i: _Search(info.obj.spec.pod_sets)
                    for i, info in enumerate(infos)}
        out = {i: None for i in range(len(infos))}
        rounds = up = 0
        for _ in range(MAX_PARTIAL_ROUNDS):
            active = [i for i, s in searches.items()
                      if s.total > 0 and s.lo < s.hi]
            if not active:
                break
            rounds += 1
            mids = {i: (searches[i].lo + searches[i].hi) // 2 for i in active}
            batch = encode.encode_workloads(
                [shadow(infos[i], searches[i].counts(mids[i]))
                 for i in active], snapshot, topo, ordering=self.ordering,
                max_podsets=self.max_podsets)
            host = (batch.requests, batch.podset_active, batch.wl_cq,
                    batch.eligible, batch.solvable)
            up += sum(a.nbytes for a in host)
            fit = kernel.solve_phase_a(
                topo_dev, usage, cohort_usage,
                *(self._upload(a) for a in host),
                num_podsets=self.max_podsets, fair_sharing=False,
                start_rank=None)[0]
            self._sync()
            fit = fit.cpu().numpy()
            self.counters["fetch_bytes"] += fit.nbytes
            fit = fit[:batch.n]
            for k, i in enumerate(active):
                s = searches[i]
                if not batch.solvable[k]:
                    s.lo = s.hi = 0
                    s.good = None
                    out[i] = CPU_FALLBACK
                elif fit[k]:
                    s.good = mids[i]
                    s.hi = mids[i]
                else:
                    s.lo = mids[i] + 1
        for i, s in searches.items():
            if out[i] is not CPU_FALLBACK and s.good is not None \
                    and s.lo == s.good:
                out[i] = s.counts(s.good)
        self.last_partial_rounds = rounds
        self.last_upload_bytes += up
        self.counters["upload_bytes"] += up
        t1 = time.perf_counter()
        self.last_phase_s["partial"] = t1 - t0
        self._phase("nominate.partial", t0, t1)
        return out

    def solve_preempt(self, preempt_batch) -> tuple:
        """K9 alone through solve_preemptions. Returns numpy
        (targets[B,K], feasible[B], stats[B,4])."""
        aux = self.solve_preemptions(preempt_batch)
        return (*aux["preempt"], aux["preempt_stats"])

    def solve(self, snapshot: Snapshot, entries: list,
              fair_sharing: bool = False) -> dict:
        """entries: list of workload Info. Returns {entry index ->
        (fa.Assignment, admitted)} for every entry the solver could fully
        assign (fit mode); admitted=False means the assignment no longer
        fit after intra-cycle accounting (reference: scheduler.go:266-273)."""
        plan = self.prepare(snapshot, entries)
        if plan is None:
            return {}
        decisions, _ = self.solve_prepared(plan, snapshot,
                                           fair_sharing=fair_sharing)
        return decisions

    def _decode_batch(self, entries: list, snapshot: Snapshot,
                      topo: encode.Topology, batch, fetched: dict,
                      resident: bool = False,
                      cluster_names: Optional[tuple] = None) -> dict:
        """Decisions into the scheduler's Assignment form, with the
        LastTriedFlavorIdx resume state exactly as the CPU assigner
        stores it (reference: flavorassigner.go:289-324): the rank where
        the search ended, -1 when the list was exhausted (chosen == last
        flavor, or a TryNextFlavor CQ settling for a borrowing fit after
        scanning the whole list). With cluster columns, last_placements
        gets each admitted head's mk_cluster choice by name."""
        n = batch.n
        # reset on every decode, so that a cycle without columns never
        # hands a stale map to the Scheduler's placement flush
        self.last_placements = {}
        fit = np.asarray(fetched["fit"])[:n]
        idx = np.flatnonzero(fit)
        if idx.size == 0:
            return {}
        mkc = fetched.get("mk_cluster")
        mk_l = (np.asarray(mkc)[:n][idx].tolist()
                if mkc is not None and cluster_names else None)
        admitted = np.asarray(fetched["admitted"])[:n][idx]     # [M]
        chosen = np.asarray(fetched["chosen"])[:n][idx]          # [M,P,R]
        borrows = np.asarray(fetched["borrows"])[:n][idx]        # [M]
        chosen_borrow = np.asarray(fetched["chosen_borrow"])[:n][idx]
        qi_arr = batch.wl_cq[idx]                                 # [M]

        # With FlavorFungibility off the CPU assigner never writes the
        # tried index (stays at the dataclass default 0).
        fungibility_on = features.enabled(features.FLAVOR_FUNGIBILITY)
        fi_safe = np.maximum(chosen, 0)
        rank = topo.flavor_rank[qi_arr[:, None, None], fi_safe]   # [M,P,R]
        gi = topo.group_id[qi_arr]                                # [M,R]
        gsize = topo.group_size[qi_arr[:, None], np.maximum(gi, 0)]  # [M,R]
        exhausted = rank == gsize[:, None, :] - 1
        prefer_nb = topo.prefer_no_borrow[qi_arr]                 # [M]
        # TryNextFlavor CQs scanned the whole list looking for a no-borrow
        # fit before settling for this borrowing one.
        exhausted |= prefer_nb[:, None, None] & chosen_borrow
        if fungibility_on:
            tried = np.where(exhausted | (chosen < 0), -1, rank)
        else:
            tried = np.zeros_like(rank)

        fname_l = np.asarray(topo.flavors, dtype=object)[fi_safe].tolist()
        tried_l = tried.tolist()
        chosen_neg = (chosen < 0).tolist()
        borrows_l = borrows.tolist()
        admitted_l = admitted.tolist()
        resource_index = topo.resource_index

        # last_state generations per CQ, read fresh per cycle: the cohort
        # generation is the cache's capacity version, which moves on
        # events that never rebuild the topology.
        gen_cache: dict = {}
        rs = self._resident if resident else None
        mirror_corr: dict = {}
        out = {}
        for row, wi in enumerate(idx.tolist()):
            info = entries[wi]
            gens = gen_cache.get(info.cluster_queue)
            if gens is None:
                cq = snapshot.cluster_queues[info.cluster_queue]
                gens = (cq.allocatable_resource_generation,
                        cq.cohort.allocatable_resource_generation
                        if cq.cohort else 0)
                gen_cache[info.cluster_queue] = gens
            assignment = fa.Assignment(borrowing=bool(borrows_l[row]))
            assignment.last_state = wlpkg.AssignmentClusterQueueState(
                cluster_queue_generation=gens[0], cohort_generation=gens[1])
            covers_pods = topo.covers_pods[batch.wl_cq[wi]]
            usage = assignment.usage
            for pi, psr in enumerate(info.total_requests):
                reqs = dict(psr.requests)
                if covers_pods:
                    reqs[RESOURCE_PODS] = psr.count
                fname_p = fname_l[row][pi]
                neg_p = chosen_neg[row][pi]
                tried_p = tried_l[row][pi]
                flavors = {}
                flavor_idx = {}
                for r, v in reqs.items():
                    ri = resource_index[r]
                    if v > 0 and neg_p[ri]:
                        raise AssertionError(
                            "solver admitted workload without flavor")
                    fname = fname_p[ri]
                    t = tried_p[ri]
                    flavors[r] = fa.FlavorAssignment(name=fname, mode=fa.FIT,
                                                     tried_flavor_idx=t)
                    flavor_idx[r] = t
                    fr = FlavorResource(fname, r)
                    usage[fr] = usage.get(fr, 0) + v
                assignment.pod_sets.append(fa.PodSetAssignmentResult(
                    name=psr.name, flavors=flavors, requests=reqs,
                    count=psr.count))
                assignment.last_state.last_tried_flavor_idx.append(flavor_idx)
            was_admitted = bool(admitted_l[row])
            if mk_l is not None and was_admitted:
                ki = mk_l[row]
                if 0 <= ki < len(cluster_names):
                    self.last_placements[info.key] = cluster_names[ki]
            if rs is not None and was_admitted:
                # The device's phase B applied this usage; track it until
                # the assume write confirms it through the journal, and
                # bring the host mirror up to the device state.
                rs.pending[info.key] = (info.cluster_queue, dict(usage), 0)
                cq_name = info.cluster_queue
                for fr, v in usage.items():
                    k = (cq_name, fr)
                    mirror_corr[k] = mirror_corr.get(k, 0) + v
            out[wi] = (assignment, was_admitted)
        if rs is not None and mirror_corr:
            deltas = encode.encode_deltas(mirror_corr, topo)
            if deltas is not None:
                encode.apply_deltas_np(topo, rs.mirror_usage,
                                       rs.mirror_cohort, deltas)
        return out
