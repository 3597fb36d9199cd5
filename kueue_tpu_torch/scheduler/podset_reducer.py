"""Partial admission: binary search over the reducible pod count.

Equivalent of the reference's
pkg/scheduler/flavorassigner/podset_reducer.go:29-86: scale each PodSet
between min_count..count proportionally; the predicate is "assignment
fits (or can preempt)".
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple


def reduction_space(pod_sets: list) -> Tuple[list, list, int]:
    """(full counts, per-podset reducible deltas, total delta) — the
    search space both the sequential reducer and the solver's batched
    lockstep search iterate (podset_reducer.go:29-45). Shared so the two
    can never drift on the interpolation."""
    full_counts = [ps.count for ps in pod_sets]
    deltas = [ps.count - (ps.min_count if ps.min_count is not None else ps.count)
              for ps in pod_sets]
    return full_counts, deltas, sum(deltas)


def counts_for_index(full_counts: list, deltas: list, total_delta: int,
                     i: int) -> list:
    """Proportional scaling of each PodSet at reduction index i
    (podset_reducer.go:47-56)."""
    return [full - (d * i) // total_delta
            for full, d in zip(full_counts, deltas)]


class PodSetReducer:
    def __init__(self, pod_sets: list, fits: Callable[[list], Tuple[object, bool]]):
        self.pod_sets = pod_sets
        self.full_counts, self.deltas, self.total_delta = \
            reduction_space(pod_sets)
        self.fits = fits

    def _counts_for_index(self, i: int) -> list:
        return counts_for_index(self.full_counts, self.deltas,
                                self.total_delta, i)

    def search(self) -> Tuple[Optional[object], bool]:
        """Find the largest counts that pass fits() (smallest reduction
        index), via binary search like Go's sort.Search."""
        if self.total_delta == 0:
            return None, False
        last_good_idx = -1
        last_result = None
        lo, hi = 0, self.total_delta + 1  # search smallest i with fits true
        while lo < hi:
            mid = (lo + hi) // 2
            result, ok = self.fits(self._counts_for_index(mid))
            if ok:
                last_good_idx = mid
                last_result = result
                hi = mid
            else:
                lo = mid + 1
        return last_result, lo == last_good_idx
