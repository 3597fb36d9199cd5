"""Leveled structured logging (the reference's logr/zap V-convention).

The port's copy of kueue_tpu/utils/vlog.py. Equivalent of the verbosity
scheme the reference uses throughout (pkg/scheduler/logging.go:1-54):
numeric V levels on top
of Python's logging —

- V(2): per-cycle summaries (admitted/skipped counts, cycle latency)
- V(3): per-workload transitions (admit / requeue / evict)
- V(5): the scheduler's per-entry nomination attempts
- V(6): full cache-snapshot dumps at cycle start

``set_verbosity(n)`` (or KUEUE_TPU_V in the environment, read at import)
enables levels <= n. Messages are key=value structured, one line each,
through the standard ``logging`` machinery so handlers/formatters can be
swapped by embedders.
"""

from __future__ import annotations

import logging
import os

_BASE = logging.getLogger("kueue_tpu_torch")
# V(n) maps onto descending DEBUG sublevels so standard handlers order
# them sensibly: V0/V1 -> INFO, V2+ -> DEBUG-and-below.
_LEVEL_FOR_V = {0: logging.INFO, 1: logging.INFO}

_verbosity = 0


def set_verbosity(v: int) -> None:
    """Enable V(level) messages for level <= v (the --v flag analogue)."""
    global _verbosity
    _verbosity = int(v)
    _BASE.setLevel(logging.DEBUG if v >= 2 else logging.INFO)


def verbosity() -> int:
    return _verbosity


def env_verbosity() -> int:
    """The KUEUE_TPU_V override as read at import (0 when unset) —
    embedders reconcile their config level against THIS, not the
    mutable global, so one loud embedder can't ratchet another."""
    return _env_v


def enabled(v: int) -> bool:
    return v <= _verbosity


def _fmt(msg: str, kv: dict) -> str:
    if not kv:
        return msg
    parts = " ".join(f"{k}={v}" for k, v in kv.items())
    return f"{msg} {parts}"


class VLogger:
    """logr-style leveled logger bound to a component name."""

    def __init__(self, name: str):
        self._log = _BASE.getChild(name)

    def v(self, level: int, msg: str, **kv) -> None:
        if level > _verbosity:
            return
        pylevel = _LEVEL_FOR_V.get(level, logging.DEBUG)
        self._log.log(pylevel, _fmt(msg, kv))

    def info(self, msg: str, **kv) -> None:
        self.v(0, msg, **kv)

    def error(self, msg: str, **kv) -> None:
        self._log.error(_fmt(msg, kv))


def logger(name: str) -> VLogger:
    return VLogger(name)


# Environment override (the --v flag analogue for embedders without
# config access); applied through set_verbosity so the logger LEVEL
# moves too, or V>=2 records would be dropped by standard handlers.
_env_v = int(os.environ.get("KUEUE_TPU_V", "0") or 0)
if _env_v:
    set_verbosity(_env_v)


def dump_snapshot(log: VLogger, snapshot) -> None:
    """V(6): the full usage snapshot at cycle start (reference:
    logAdmissionAttemptIfVerbose -> dumpCache, logging.go:22-41)."""
    if not enabled(6):
        return
    for name, cq in sorted(snapshot.cluster_queues.items()):
        usage = {f"{fr.flavor}/{fr.resource}": v
                 for fr, v in sorted(cq.resource_node.usage.items())}
        log.v(6, "snapshot.clusterQueue", name=name,
              cohort=cq.cohort.name if cq.cohort else "",
              workloads=len(cq.workloads), usage=usage)


def dump_attempts(log: VLogger, entries) -> None:
    """V(5): per-entry nomination outcomes (reference: logging.go:43-54)."""
    if not enabled(5):
        return
    from kueue_tpu_torch.scheduler import flavorassigner as fa
    for e in entries:
        log.v(5, "attempt", workload=e.info.key,
              clusterQueue=e.info.cluster_queue,
              mode=fa.mode_name(e.assignment.representative_mode()),
              status=e.status or "notNominated",
              targets=len(e.preemption_targets or []),
              message=e.inadmissible_msg[:120])
