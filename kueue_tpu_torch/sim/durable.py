"""The durable store's fencing error.

The port's copy of `Fenced` from kueue_tpu/sim/durable.py. The durable
log itself (checkpoints, the write-ahead log, tail replay) waits for
ROADMAP item 6; until then a store has no log attached and nothing
raises this.
"""

from __future__ import annotations


class Fenced(RuntimeError):
    """A commit carrying a stale fencing epoch was rejected: another
    replica acquired the leader lease since this writer's. The deposed
    leader's write never reaches the WAL (and so can never be replayed
    by the new leader)."""
