"""LRU program cache for the streaming request interface.

Keyed by (model schema hash, graph partition signature, geometry) — see
``repro_torch.engine.engine`` for key construction.  Repeated (model, graph)
shapes skip software compilation entirely (T_LoC == 0 on a hit), which is
what lets one overlay serve heavy repeated traffic.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Generic, Optional, TypeVar

V = TypeVar("V")


class LRUCache(Generic[V]):
    def __init__(self, capacity: int = 32) -> None:
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._d: "OrderedDict[str, V]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def get(self, key: str) -> Optional[V]:
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key: str, value: V) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def values(self):
        return list(self._d.values())

    def clear(self) -> None:
        self._d.clear()
