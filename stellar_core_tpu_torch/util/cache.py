"""RandomEvictionCache: bounded map with random eviction.

Copied (RandomEvictionCache only) from `stellar_core_tpu/util/cache.py` at
commit 6685f6a; carry a fix in either copy to the other.

Role parity: reference `src/util/RandomEvictionCache.h` — O(1) insert/lookup,
evicts a uniformly random victim when full (better worst-case than LRU under
adversarial scan patterns, which matters for the signature cache).
"""

from __future__ import annotations

import random
from typing import Dict, Generic, Hashable, List, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class RandomEvictionCache(Generic[K, V]):
    def __init__(self, max_size: int, rng: random.Random | None = None) -> None:
        assert max_size > 0
        self._max = max_size
        self._map: Dict[K, int] = {}
        self._keys: List[K] = []
        self._vals: List[V] = []
        self._rng = rng or random.Random(0xC0FFEE)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, k: K) -> bool:
        return k in self._map

    def exists(self, k: K) -> bool:
        if k in self._map:
            self.hits += 1
            return True
        self.misses += 1
        return False

    def get(self, k: K) -> V:
        i = self._map[k]
        return self._vals[i]

    def maybe_get(self, k: K):
        i = self._map.get(k)
        if i is None:
            self.misses += 1
            return None
        self.hits += 1
        return self._vals[i]

    def put(self, k: K, v: V) -> None:
        i = self._map.get(k)
        if i is not None:
            self._vals[i] = v
            return
        if len(self._keys) >= self._max:
            self._evict_one()
        self._map[k] = len(self._keys)
        self._keys.append(k)
        self._vals.append(v)

    def _evict_one(self) -> None:
        j = self._rng.randrange(len(self._keys))
        self._remove_at(j)
        self.evictions += 1

    def _remove_at(self, j: int) -> None:
        last = len(self._keys) - 1
        victim = self._keys[j]
        if j != last:
            self._keys[j] = self._keys[last]
            self._vals[j] = self._vals[last]
            self._map[self._keys[j]] = j
        self._keys.pop()
        self._vals.pop()
        del self._map[victim]

    def erase(self, k: K) -> bool:
        """Explicit O(1) removal (swap-remove); not counted as an
        eviction. Returns False when the key is absent."""
        j = self._map.get(k)
        if j is None:
            return False
        self._remove_at(j)
        return True

    def keys(self) -> List[K]:
        return list(self._keys)

    def clear(self) -> None:
        self._map.clear()
        self._keys.clear()
        self._vals.clear()
