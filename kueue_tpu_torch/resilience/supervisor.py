"""Supervised dispatch: the solver-worker thread that bounds a dispatch.

The port of kueue_tpu/resilience/supervisor.py. The watchdog bounds the
collect half of the device round trip; the dispatch (encode uploads,
the arena scatter, the cycle's launches) runs on a persistent
supervised worker thread, and the scheduler waits for the hand-off
with the watchdog's cold clamp, so a dispatch that wedges is abandoned
instead of freezing the scheduler.

A late dispatch is ABANDONED: Python cannot cancel a blocked call, only
stop waiting for it, so the worker is orphaned (a poison pill makes it
exit its loop once the wedged call returns), a fresh worker is spawned
lazily for the next dispatch, ``SupervisedTimeout`` propagates to the
scheduler's device-fault handler (residency dropped, heads nominated
on the CPU, fault fed to the breaker) and the cycle completes. The
solver's dispatch epoch keeps the orphan from launching or writing a
resident tensor once it wakes.

Exceptions raised by the dispatch body (an injected fault, a CUDA
error from torch, a kernel wrapper's raise) are relayed to the caller
unchanged.

The worker threads are daemons on purpose: an orphan stuck in a dead
call must never block interpreter shutdown.
"""

from __future__ import annotations

import atexit
import queue
import threading
import time
import weakref
from typing import Optional

from kueue_tpu_torch.resilience.watchdog import DispatchTimeout


class SupervisedTimeout(DispatchTimeout):
    """The supervised hand-off missed its deadline (a hang INSIDE the
    dispatch body — trace/compile/transfer). A distinct type from the
    collect-side DispatchTimeout so the scheduler's metrics can
    attribute the timeout to the right half of the round trip."""


# Live workers, drained at interpreter exit: a daemon thread that ran
# device work must not be torn down while parked, or the runtime's
# teardown can abort with "terminate called without an active
# exception". Parked workers wake on the poison pill
# and join promptly; a genuinely wedged orphan times out and stays a
# daemon (nothing can join a dead device call).
_live_workers: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _drain_workers_at_exit() -> None:
    for w in list(_live_workers):
        w.close(join_timeout=1.0)


class _Request:
    __slots__ = ("fn", "args", "kwargs", "done", "result", "exc")

    def __init__(self, fn, args, kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None


class SupervisedWorker:
    """A persistent daemon worker thread with a bounded hand-off.

    ``run(fn, *args, deadline_s=...)`` executes ``fn`` on the worker and
    waits at most ``deadline_s`` for it; a miss raises
    ``DispatchTimeout`` and orphans the worker (``orphaned`` counts
    them). The thread is REUSED across calls — spawning per dispatch
    would add thread start-up latency to every cycle; the only time a
    new thread is minted is after an abandonment (or lazily on first
    use). Exceptions raised by ``fn`` (injected faults, CUDA errors)
    propagate to the caller unchanged. ``deadline_s=None`` runs ``fn``
    inline — supervision off is zero-thread, zero-cost.

    Single-supervisor contract: one caller thread at a time (the
    scheduler); the worker processes one request at a time.
    """

    def __init__(self, name: str = "supervised-worker"):
        self.name = name
        self._queue: Optional[queue.SimpleQueue] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.timeouts = 0   # bounded waits that expired
        self.orphaned = 0   # workers abandoned mid-call
        self.calls = 0      # supervised calls handed off
        self._orphans: list = []  # abandoned threads, pruned when dead
        _live_workers.add(self)

    @staticmethod
    def _loop(q: "queue.SimpleQueue") -> None:
        while True:
            req = q.get()
            if req is None:  # poison pill: this worker was abandoned
                return
            try:
                req.result = req.fn(*req.args, **req.kwargs)
            except BaseException as exc:  # noqa: BLE001 — relayed to caller
                req.exc = exc
            req.done.set()
            # Parked on the next get, the worker must not hold the last
            # request: its callable and arguments (a solver's bound
            # method, a cycle's plan) would keep the solver, its cache
            # and its queues alive as long as the thread.
            del req

    def _ensure_worker(self) -> "queue.SimpleQueue":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._queue = queue.SimpleQueue()
                self._thread = threading.Thread(
                    target=self._loop, args=(self._queue,), daemon=True,
                    name=self.name)
                self._thread.start()
                # a worker dropped by its owner ends its parked thread
                weakref.finalize(self, self._queue.put, None)
            return self._queue

    def run(self, fn, *args, deadline_s: Optional[float] = None, **kwargs):
        """Run ``fn(*args, **kwargs)`` under supervision. Raises
        ``DispatchTimeout`` after ``deadline_s`` seconds; re-raises
        whatever ``fn`` raised otherwise."""
        if deadline_s is None:
            return fn(*args, **kwargs)
        q = self._ensure_worker()
        req = _Request(fn, args, kwargs)
        t0 = time.perf_counter()
        q.put(req)
        self.calls += 1
        if not req.done.wait(timeout=deadline_s):
            self._abandon()
            self.timeouts += 1
            raise SupervisedTimeout(deadline_s, time.perf_counter() - t0)
        if req.exc is not None:
            raise req.exc
        return req.result

    def _abandon(self) -> None:
        """Stop feeding the wedged worker; it exits its loop when (if)
        the stuck call ever returns. The next ``run`` mints a fresh
        worker so it is never queued behind the wedged call. The orphan
        stays tracked so ``close()`` can wait for stragglers at
        interpreter exit (an orphan mid-compile torn down with the
        runtime aborts the process)."""
        with self._lock:
            if self._queue is not None:
                self._queue.put(None)
            if self._thread is not None:
                self._orphans.append(self._thread)
            self._orphans = [t for t in self._orphans if t.is_alive()]
            self._thread = None
            self._queue = None
            self.orphaned += 1

    def stop(self) -> None:
        """Shut the (idle) worker down cleanly. Safe to call repeatedly;
        a worker mid-call drains its request first."""
        self.close(join_timeout=0.0)

    def close(self, join_timeout: float = 1.0) -> None:
        """stop(), then wait up to ``join_timeout`` (per thread) for
        the worker AND any orphans to exit — used at interpreter
        shutdown so no thread is torn down mid-device-call (the runtime
        may abort the process if its state unwinds under a live call). A
        genuinely wedged orphan still times out; nothing can join a
        dead device call."""
        with self._lock:
            thread, self._thread = self._thread, None
            q, self._queue = self._queue, None
            orphans, self._orphans = self._orphans, []
        if q is not None:
            q.put(None)
        if join_timeout > 0:
            for t in ([thread] if thread is not None else []) + orphans:
                t.join(timeout=join_timeout)

    def status(self) -> dict:
        with self._lock:
            alive = self._thread is not None and self._thread.is_alive()
        return {"alive": alive, "calls": self.calls,
                "timeouts": self.timeouts, "orphaned": self.orphaned}
