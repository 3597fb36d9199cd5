"""Flavor assignment: the sequential (CPU) assigner and the Assignment
types the solver decodes into (reference: pkg/scheduler/flavorassigner)."""

from kueue_tpu_torch.scheduler.flavorassigner import (  # noqa: F401
    FIT,
    NO_FIT,
    PREEMPT,
    Assignment,
    FlavorAssigner,
)
