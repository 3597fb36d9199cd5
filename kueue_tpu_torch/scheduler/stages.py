"""Typed inter-stage contract of the synchronous admission cycle.

``Scheduler.schedule()`` runs nominate (pop and validate heads, assign
flavors, find preemption targets against the cycle snapshot), solve
(the batched device solve of the routed heads) and apply (admit the
survivors with intra-cycle accounting, issue evictions, requeue the
rest). The dataclasses below are what the stages hand each other
(kueue_tpu/scheduler/stages.py; the speculation token and the in-flight
cycle of the pipelined path are not ported).
"""

from __future__ import annotations

from dataclasses import dataclass, field


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


@dataclass
class AppliedCycle:
    """Output of the apply stage: the cycle's admission outcome."""

    admitted: int = 0
    success: bool = False
