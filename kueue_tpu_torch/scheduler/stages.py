"""Typed inter-stage contract of the admission cycle.

``Scheduler.schedule()`` runs nominate (pop and validate heads, assign
flavors, find preemption targets against the cycle snapshot), solve
(the batched device solve of the routed heads) and apply (admit the
survivors with intra-cycle accounting, issue evictions, requeue the
rest). The dataclasses below are what the stages hand each other
(kueue_tpu/scheduler/stages.py), for the synchronous cycle (all three
stages inside one ``schedule()`` call) and for the speculative
pipeline, where the solve of cycle N runs while cycle N-1's apply is
still mutating the cache. A speculative result commits only after
``SpeculationToken.validate`` proves that the state it was computed
against still describes the live cache: the structural epochs, the
identity of the device-resident state, the encode arena's per-slot
generations and the solver's journal cursor. A mis-speculation
abandons the in-flight result undecoded (its heads re-heap, the
resident state drops) and the next cycle runs synchronously.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class SpeculationToken:
    """Generation stamp of the state a speculative solve was computed
    against (kueue_tpu/scheduler/stages.py:36-113). Cheap by
    construction: three epoch ints, one object identity and one small
    int64 gather, never a snapshot comparison.

    - ``epochs``: the snapshot's structural generation token
      (topology, cohort, flavor spec). Workload churn does not
      invalidate: the resident state reconciles usage movement through
      the usage journal; only structural edits make in-flight decisions
      unsound.
    - ``journal_seq``: the journal cursor the dispatch snapshot froze
      at (diagnostics; staleness itself is fine, losing entries is not).
    - ``resident``: the ResidentState the plan chained on, or None for
      a non-resident dispatch.
    - ``slots``/``slot_gens``: the encode-arena slots the dispatched
      batch gathered, with their per-slot generations: a mid-flight
      upsert or delete of a dispatched workload bumps its slot's
      generation, and the speculation aborts instead of admitting a
      stale object.
    """

    journal_seq: int = -1
    epochs: tuple = ()
    resident: object = None
    slots: object = None
    slot_gens: object = None

    # reason slugs per position of the canonical epochs tuple
    # (incremental.snapshot_generations / Cache.generation_token order)
    _EPOCH_REASONS = ("topology-epoch", "cohort-epoch",
                      "flavor-spec-epoch")

    @classmethod
    def stamp(cls, cache, solver, plan, snapshot) -> "SpeculationToken":
        from kueue_tpu_torch.cache.incremental import snapshot_generations
        slots = getattr(plan, "slots", None)
        # Prefer the encode-time capture (Plan.slot_gens): a delta
        # landing between the encode and this stamp must read as
        # staleness, not be baked into the witness.
        gens = getattr(plan, "slot_gens", None)
        if gens is None and slots is not None:
            slot_fn = getattr(solver, "slot_generations", None)
            if slot_fn is not None:
                gens = slot_fn(slots)
        return cls(
            journal_seq=getattr(snapshot, "journal_seq", -1),
            # The SNAPSHOT's generations, not the cache's current ones:
            # an epoch bump that raced in between the snapshot and this
            # stamp reads as the staleness it is.
            epochs=snapshot_generations(snapshot),
            resident=getattr(plan, "rs", None) if plan.resident else None,
            slots=slots,
            slot_gens=gens,
        )

    def validate(self, cache, solver) -> tuple:
        """(ok, reason). Reasons are stable slugs: topology-epoch |
        cohort-epoch | flavor-spec-epoch | residency | arena-slots |
        journal-overflow."""
        if self.epochs:
            live = cache.generation_token()
            if self.epochs != live:
                for i, reason in enumerate(self._EPOCH_REASONS):
                    if self.epochs[i] != live[i]:
                        return False, reason
        if self.resident is not None \
                and getattr(solver, "_resident", None) is not self.resident:
            return False, "residency"
        if self.slot_gens is not None:
            slot_fn = getattr(solver, "slot_generations", None)
            gens = slot_fn(self.slots) if slot_fn is not None else None
            if gens is None or not np.array_equal(gens, self.slot_gens):
                return False, "arena-slots"
        overflowed = getattr(cache, "journal_overflowed", None)
        if overflowed is not None and overflowed():
            return False, "journal-overflow"
        return True, ""


@dataclass
class InFlightCycle:
    """A dispatched, uncollected speculative cycle: what the solve stage
    hands the apply stage of a later call
    (kueue_tpu/scheduler/stages.py:116-135).

    - ``inflight``: the solver's InFlight (the outputs on the device and
      the started fetch).
    - ``snapshot``: the light snapshot the cycle was encoded against.
    - ``nofit_idx``: batch rows already requeued at dispatch by the
      device-NoFit shortcut.
    - ``pend_idx``/``pmeta``: the pipelined mixed cycle's preemption
      rows and their (pending entries, cq_by, full snapshot) state for
      the collect.
    - ``token``: the speculation stamp validated before commit.
    """

    inflight: object
    snapshot: object
    nofit_idx: set = field(default_factory=set)
    pend_idx: set = field(default_factory=set)
    pmeta: object = None
    token: Optional[SpeculationToken] = None


@dataclass
class NominatedCycle:
    """Output of the nominate stage (plus the solve stage's CPU-side
    spillover): everything the apply stage admits from.

    ``entries`` are sorted by the admission order
    (borrows -> DRF share -> priority -> FIFO); ``solver_entries``
    were already admitted/skipped by the device solve and only rejoin
    for the requeue sweep.
    """

    snapshot: object = None
    entries: list = field(default_factory=list)
    solver_entries: list = field(default_factory=list)
    route: str = ""
    # filled by the apply stage: per-CQ preemption-skip counts for the
    # admission_cycle_preemption_skips gauge
    skipped_preemptions: dict = field(default_factory=dict)


@dataclass
class AppliedCycle:
    """Output of the apply stage: the cycle's admission outcome, its
    observed regime ("fit" or "preempt") and whether a preempt-mode entry
    was blocked (the starvation bound's evidence)."""

    admitted: int = 0
    success: bool = False
    regime: str = "fit"
    blocked_preemptor: bool = False
