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

Left out of these slices (the JAX package has them): the host-side
router (`_route`, Plan.fit_pred), the dispatch supervisor and watchdog,
the background fetch pool, fault injection and the flight recorder.
"""

from __future__ import annotations

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
from kueue_tpu_torch.scheduler import flavorassigner as fa
from kueue_tpu_torch.scheduler.podset_reducer import (
    counts_for_index,
    reduction_space,
)
from kueue_tpu_torch.solver import encode, kernel
from kueue_tpu_torch.solver.arena import WorkloadArena
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
# "plan" is the mesh's domain plan, "preempt" solve_preemptions' upload,
# launches, sync and fetch, "partial" batched_partial_admission's rounds
PHASES = ("encode", "plan", "upload", "device", "fetch", "decode", "preempt",
          "partial")

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
    """One cycle's encoded inputs."""

    def __init__(self, topo, topo_dev, state, batch, start_rank):
        self.topo = topo
        self.topo_dev = topo_dev
        self.state = state
        self.batch = batch
        self.start_rank = start_rank
        self.slots = None       # arena slots of the heads (bound to queues)
        self.deltas = None      # the delta prologue (numpy tuple) or None
        self.resident = False   # dispatch on the device-resident state
        self.rs = None          # the ResidentState the plan was built on
        self.backlog_gen = 0
        self.cluster = None     # encode.ClusterColumns or None


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
                         "establishes": 0, "syncs": 0}
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

    # --- binding to the control plane ---

    def bind_cache(self, cache) -> None:
        """Attach the Cache: enables the usage journal that keeps the
        device-resident state reconciled across cycles. Under a mesh the
        cycle is unbound and nothing drains a journal, so none is
        enabled."""
        self._cache = cache
        if self.mesh is None:
            cache.enable_usage_journal()

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
            topo = encode.encode_topology(snapshot)
            self._topo_cache = (topo, topo_to_device(topo, self.device))
            self._topo_key = key
        return self._topo_cache

    def prepare(self, snapshot: Snapshot, entries: list) -> Optional[Plan]:
        """Encode the cycle; None when nothing is solvable. With a bound
        cache the usage state is device-resident and reconciled through
        the journal; with bound queues the batch comes from the arena.
        Starts the cycle's phase times (last_phase_s)."""
        self.last_phase_s = dict.fromkeys(PHASES, 0.0)
        if not entries:
            return None
        t0 = time.perf_counter()
        topo, topo_dev = self._topology(snapshot)
        state, deltas, resident = self._state_for_cycle(snapshot, topo)
        if resident:
            self.counters["resident_cycles"] += 1
        slots = None
        if self._queues is not None:
            self._arena.begin_cycle(topo)
            batch, slots = self._arena.assemble(entries, snapshot, topo,
                                                self.ordering,
                                                self.max_podsets)
        else:
            batch = encode.encode_workloads(entries, snapshot, topo,
                                            max_podsets=self.max_podsets)
        cluster = encode.encode_cluster_columns(snapshot, topo)
        self.last_phase_s["encode"] = time.perf_counter() - t0
        if not batch.solvable.any():
            return None
        start_rank = batch.start_rank if batch.start_rank.any() else None
        plan = Plan(topo, topo_dev, state, batch, start_rank)
        plan.cluster = cluster
        plan.slots = slots
        plan.deltas = deltas
        plan.resident = resident
        if resident:
            plan.rs = self._resident  # identity-pinned: a residency reset
            plan.backlog_gen = self._resident.backlog_gen
        return plan

    # --- device-resident state management ---

    def _state_for_cycle(self, snapshot: Snapshot, topo):
        """Returns (state-with-mirror-arrays, encoded deltas or None,
        resident?). Establishes residency on the first cycle (full
        encode + upload), reconciles via the journal afterwards."""
        if not self.resident_capable:
            return encode.encode_state(snapshot, topo), None, False
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
            return state, deltas, True
        # (re)establish: the snapshot is the full truth — drop any journal
        # history up to it, encode once, upload once.
        self._cache.drain_usage_journal(snapshot.journal_seq)
        state = encode.encode_state(snapshot, topo)
        rs = ResidentState(topo.token)
        rs.mirror_usage = state.usage
        rs.mirror_cohort = state.cohort_usage
        self._resident = rs
        return state, None, True

    def _reconcile(self, snapshot: Snapshot, topo) -> bool:
        """Drain the cache journal up to the snapshot: device admissions
        confirmed by their assume write cancel; everything else (other
        admissions, evictions, finishes, reverts of failed assumes)
        becomes a sparse correction applied to the mirror now and shipped
        to the device at the next dispatch. False = residency must be
        dropped (journal overflow)."""
        rs = self._resident
        entries, overflow = self._cache.drain_usage_journal(
            snapshot.journal_seq)
        if overflow:
            self._resident = None
            return False
        corr: dict = {}
        for _seq, kind, cq_name, key, usage in entries:
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
                 fs_flags: tuple = ()) -> tuple:
        """Upload what the cycle needs and run it. Returns (device
        outputs, keys to fetch). Bound, the upload is the heads' slot
        indices, the arena's changed rows, the delta prologue and the
        flavor-resume ranks; unbound, the state and the whole batch.
        fair_sharing orders the admits by DRF share (kernel.drf_share);
        a preempt_batch (solver/preempt.py) and a fair_batch
        (solver/fairpreempt.py, solved with the strategy flags fs_flags)
        are solved in the same call against the same usage
        (kernel.solve_cycle_with_preempt). The usage the cycle read is
        kept for solve_preemptions. Under a mesh the cycle is
        parallel.mesh.solve_cycle_sharded and a preempt_batch is solved by
        solve_preempt_sharded; a fair_batch raises."""
        if self.mesh is not None:
            if fair_batch is not None:
                raise ValueError(_NO_FAIR_UNDER_MESH)
            tp = time.perf_counter()
            self.last_domain_plan = meshpkg.plan_cycle(self.mesh, plan.topo,
                                                       plan.batch.wl_cq)
            self.last_phase_s["plan"] = time.perf_counter() - tp
        t0 = time.perf_counter()
        topo, batch, state = plan.topo, plan.batch, plan.state
        compact = topo.nominal.shape[1] <= MAX_COMPACT_FLAVORS
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
                arena_dev, up = self._arena.prepare_device(self.device)
                slots_w = np.full(batch.requests.shape[0], -1, np.int32)
                slots_w[:batch.n] = plan.slots
                slots_dev = self._upload(slots_w)
                up += slots_w.nbytes
                self._sync()
                t1 = time.perf_counter()
                result = solve_cycle_resident_arena(
                    plan.topo_dev, usage_in, cohort_in, deltas, arena_dev,
                    slots_dev, preempt_args=pargs, **kwargs)
            else:
                dev = [self._upload(a) for a in batch_np]
                up = sum(a.nbytes for a in batch_np)
                self._sync()
                t1 = time.perf_counter()
                result = solve_cycle_resident(
                    plan.topo_dev, usage_in, cohort_in, deltas, *dev,
                    preempt_args=pargs, **kwargs)
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
            t1 = time.perf_counter()
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
                result = solve_cycle_fused(plan.topo_dev, *dev, **kwargs)
            else:
                result = solve_cycle_with_preempt(plan.topo_dev, *dev, pargs,
                                                  **kwargs)
            self._cycle_state = (plan.topo_dev, dev[0], dev[1])
        self._sync()
        self.last_phase_s["upload"] = t1 - t0
        self.last_phase_s["device"] = time.perf_counter() - t1
        self._observe_sync(self.last_phase_s["device"] * 1e3)
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
        return result, keys

    def collect(self, plan: Plan, result: dict, keys, snapshot: Snapshot):
        """Fetch the decisions only, unpack and decode them, and update
        the residency bookkeeping. Returns (decisions, aux): aux holds the
        preemption outputs when the cycle had preemption batches
        (preempt_aux), else None."""
        t0 = time.perf_counter()
        # a copy per key: on the H100 it beats _fetch's one copy of the
        # two or three decision arrays (chip_smoke's fetch_timing)
        fetched = {k: result[k].cpu().numpy() for k in keys}
        self.counters["fetch_bytes"] += sum(v.nbytes for v in fetched.values())
        self.counters["collects"] += 1
        fetched = unpack_decisions(fetched, self.max_podsets,
                                   plan.topo.nominal.shape[2])
        t1 = time.perf_counter()
        # Mirror/pending updates only apply when the plan's ResidentState
        # is still the live one (not invalidated+re-established since).
        resident_ok = plan.resident and plan.rs is self._resident
        decisions = self._decode_batch(
            plan.batch.infos, snapshot, plan.topo, plan.batch, fetched,
            resident=resident_ok,
            cluster_names=plan.cluster.names if plan.cluster else None)
        self.last_phase_s["fetch"] = t1 - t0
        self.last_phase_s["decode"] = time.perf_counter() - t1
        return decisions, preempt_aux(fetched)

    def solve_prepared(self, plan: Plan, snapshot: Snapshot,
                       preempt_batch=None, fair_sharing: bool = False,
                       fair_batch=None, fs_flags: tuple = ()) -> tuple:
        """Dispatch the prepared cycle, sync once, decode
        (kueue_tpu/solver/service.py:1219, single chip). A preempt_batch
        and a fair_batch (with its strategy flags fs_flags) are solved in
        the same dispatch against the same pre-cycle usage. Returns
        (decisions, aux), aux as collect returns it."""
        result, keys = self.dispatch(plan, fair_sharing=fair_sharing,
                                     preempt_batch=preempt_batch,
                                     fair_batch=fair_batch,
                                     fs_flags=fs_flags)
        return self.collect(plan, result, keys, snapshot)

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
        self.last_phase_s["preempt"] = time.perf_counter() - t0
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
        self.last_phase_s["partial"] = time.perf_counter() - t0
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
