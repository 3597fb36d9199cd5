"""Map-backed heap with PushIfNotPresent / PushOrUpdate / Delete.

The port's copy of kueue_tpu/utils/heap.py, equivalent of the
reference's pkg/util/heap/heap.go (183 LoC): a binary heap whose items
are addressable by key, used by the ClusterQueue pending heaps.
Implemented as a lazy heapq: stale entries are tombstoned and skipped on
pop/peek.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class Heap(Generic[T]):
    def __init__(self, key_func: Callable[[T], str], less_func: Callable[[T, T], bool]):
        self._key = key_func
        self._less = less_func
        self._items: dict[str, T] = {}
        self._heap: list = []  # entries: [_Cmp, seq, key]
        self._seq = itertools.count()

    class _Cmp:
        __slots__ = ("item", "less")

        def __init__(self, item, less):
            self.item = item
            self.less = less

        def __lt__(self, other):
            return self.less(self.item, other.item)

    def __len__(self) -> int:
        return len(self._items)

    def _push_entry(self, item: T, key: str) -> None:
        heapq.heappush(self._heap, (self._Cmp(item, self._less), next(self._seq), key))

    def push_if_not_present(self, item: T) -> bool:
        key = self._key(item)
        if key in self._items:
            return False
        self._items[key] = item
        self._push_entry(item, key)
        return True

    def push_or_update(self, item: T) -> None:
        key = self._key(item)
        self._items[key] = item
        self._push_entry(item, key)

    def delete(self, key: str) -> bool:
        return self._items.pop(key, None) is not None

    def get_by_key(self, key: str) -> Optional[T]:
        return self._items.get(key)

    def _prune(self) -> None:
        while self._heap:
            _, _, key = self._heap[0]
            current = self._items.get(key)
            if current is None or current is not self._heap[0][0].item:
                heapq.heappop(self._heap)  # stale/tombstoned
            else:
                return

    def peek(self) -> Optional[T]:
        self._prune()
        if not self._heap:
            return None
        return self._heap[0][0].item

    def pop(self) -> Optional[T]:
        self._prune()
        if not self._heap:
            return None
        entry = heapq.heappop(self._heap)
        key = entry[2]
        del self._items[key]
        return entry[0].item

    def items(self) -> list:
        return list(self._items.values())

    def keys(self) -> list:
        return list(self._items.keys())
