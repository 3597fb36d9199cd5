"""Bounded fan-out over an index range.

Equivalent of the reference's pkg/util/parallelize/parallelize.go:17-40
(`Until`: N items, up to 8 workers, first error wins), used there to
hide per-item apiserver latency in hot paths like preemption issuing
(preemption.go:195-235) and snapshot construction.

Here every caller is in-process, so the fan-out only pays when the
per-item work releases the GIL or blocks (a remote store client, say) —
callers measure and pick their worker count; `until(n, fn, workers=1)`
degenerates to the plain loop with zero overhead.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

DEFAULT_WORKERS = 8

_pool = None
_pool_lock = threading.Lock()
# Re-entrancy marker: set while a chunk runs ON a shared-pool worker. A
# nested until(workers>1) from inside a worker could otherwise exhaust
# the bounded pool (every thread blocked on futures that have no free
# thread to run) and deadlock; nested calls degrade to the sequential
# path instead.
_in_pool_worker = threading.local()


def _shared_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=DEFAULT_WORKERS,
                                       thread_name_prefix="parallelize")
        return _pool


def _run_chunk(fn: Callable[[int], None], lo: int, hi: int, errs: list,
               errs_lock) -> None:
    for i in range(lo, hi):
        try:
            fn(i)
        except Exception as e:  # noqa: BLE001 — aggregate, re-raise later
            with errs_lock:
                errs.append(e)


def _run_chunk_pooled(fn: Callable[[int], None], lo: int, hi: int,
                      errs: list, errs_lock) -> None:
    _in_pool_worker.active = True
    try:
        _run_chunk(fn, lo, hi, errs, errs_lock)
    finally:
        _in_pool_worker.active = False


def until(n: int, fn: Callable[[int], None],
          workers: int = DEFAULT_WORKERS) -> None:
    """Run fn(i) for every i in range(n), at most `workers` at a time
    (one contiguous chunk per worker, like the reference's
    workqueue-chunked Until). All items are attempted even when some
    fail (errgroup-with-collect semantics), then the first exception is
    re-raised — identically in the sequential and parallel paths.
    Re-entrant calls from inside a pool worker run sequentially (the
    shared bounded pool cannot safely nest — see _in_pool_worker)."""
    errs: list = []
    errs_lock = threading.Lock()
    workers = min(workers, DEFAULT_WORKERS, n)
    if getattr(_in_pool_worker, "active", False):
        workers = 1
    if n <= 1 or workers <= 1:
        _run_chunk(fn, 0, n, errs, errs_lock)
    else:
        pool = _shared_pool()
        chunk = (n + workers - 1) // workers
        futures = [pool.submit(_run_chunk_pooled, fn, lo, min(lo + chunk, n),
                               errs, errs_lock)
                   for lo in range(0, n, chunk)]
        for f in futures:
            f.result()
    if errs:
        raise errs[0]
