"""Admission engine: the Scheduler's cycle (scheduler.py), which drives
the BatchSolver on the card and nominates the rest on the CPU; the
sequential flavor assigner and the Assignment types the solver decodes
into (flavorassigner.py); the CPU Preemptor (preemption.py)
(reference: pkg/scheduler)."""

from kueue_tpu_torch.scheduler.flavorassigner import (  # noqa: F401
    FIT,
    NO_FIT,
    PREEMPT,
    Assignment,
    FlavorAssigner,
)
from kueue_tpu_torch.scheduler.scheduler import Scheduler  # noqa: F401
