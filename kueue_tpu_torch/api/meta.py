"""Object metadata, conditions and label selectors.

Equivalents of the k8s apimachinery types the reference relies on:
metav1.ObjectMeta, metav1.Condition (+ apimeta condition helpers) and
metav1.LabelSelector. Timestamps are float unix seconds.
"""

from __future__ import annotations

import fnmatch
import itertools
import time as _time
from dataclasses import dataclass, field
from typing import Optional

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "uid") -> str:
    return f"{prefix}-{next(_uid_counter)}"


class Clock:
    """Injectable time source (reference uses k8s.io/utils/clock)."""

    def now(self) -> float:
        return _time.time()


class FakeClock(Clock):
    def __init__(self, t: float = 1000.0):
        self.t = t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


REAL_CLOCK = Clock()


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    generation: int = 1
    resource_version: int = 0
    # None = unset (the sim store stamps clock.now() on create);
    # 0.0 is a valid explicit timestamp
    creation_timestamp: Optional[float] = None
    deletion_timestamp: Optional[float] = None
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    finalizers: list[str] = field(default_factory=list)
    owner_references: list[OwnerReference] = field(default_factory=list)


@dataclass
class Condition:
    type: str = ""
    status: str = "False"  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0
    observed_generation: int = 0


def find_condition(conditions: list[Condition], ctype: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == ctype:
            return c
    return None


def is_condition_true(conditions: list[Condition], ctype: str) -> bool:
    c = find_condition(conditions, ctype)
    return c is not None and c.status == "True"


def is_condition_false(conditions: list[Condition], ctype: str) -> bool:
    c = find_condition(conditions, ctype)
    return c is not None and c.status == "False"


def set_condition(conditions: list[Condition], new: Condition, now: Optional[float] = None) -> bool:
    """apimeta.SetStatusCondition: last_transition_time only moves when status flips.

    Returns True if anything changed.
    """
    if now is None:
        now = _time.time()
    existing = find_condition(conditions, new.type)
    if existing is None:
        if new.last_transition_time == 0.0:
            new.last_transition_time = now
        conditions.append(new)
        return True
    changed = False
    if existing.status != new.status:
        existing.status = new.status
        existing.last_transition_time = new.last_transition_time or now
        changed = True
    if existing.reason != new.reason:
        existing.reason = new.reason
        changed = True
    if existing.message != new.message:
        existing.message = new.message
        changed = True
    if existing.observed_generation != new.observed_generation:
        existing.observed_generation = new.observed_generation
        changed = True
    return changed


def remove_condition(conditions: list[Condition], ctype: str) -> None:
    conditions[:] = [c for c in conditions if c.type != ctype]


@dataclass
class LabelSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist
    values: list[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    """metav1.LabelSelector. An empty selector matches everything; None matches nothing
    (matching the semantics of LabelSelectorAsSelector)."""

    match_labels: dict[str, str] = field(default_factory=dict)
    match_expressions: list[LabelSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            val = labels.get(req.key)
            if req.operator == "In":
                if val is None or val not in req.values:
                    return False
            elif req.operator == "NotIn":
                if val is not None and val in req.values:
                    return False
            elif req.operator == "Exists":
                if req.key not in labels:
                    return False
            elif req.operator == "DoesNotExist":
                if req.key in labels:
                    return False
            else:
                raise ValueError(f"unknown selector operator {req.operator}")
        return True


def match_glob(pattern: str, value: str) -> bool:
    return fnmatch.fnmatchcase(value, pattern)
