"""Identity-keyed memoization for frozen serving objects.

Serving-path caches (folded int8 operands, stacked weight-stationary
operands, execution plans) key on *object identity*: a frozen pack's
arrays are never mutated in place, so ``id(pack)`` plus an ``is`` check is
a correct and allocation-free cache key.  The subtle invariants live here
once instead of at every cache site:

* values hold **strong references** to the keyed objects, so their ids
  cannot be recycled by the allocator while the entry lives;
* a hit re-verifies every keyed object with ``is`` (two live objects can
  never share an id, but a dead key's id can be reused — the strong refs
  prevent that for *our* entries; the check keeps the contract explicit);
* insertion-order eviction past ``max_entries`` bounds memory —
  **pinned** entries (``put(..., pin=True)``) are exempt: they neither
  count toward the bound nor get auto-evicted, because their lifetime is
  owned by an external manager (the serving pack cache) which removes
  them explicitly via :meth:`drop`.  Without the pin, the memo's
  insertion-order eviction was disconnected from the frontend lifetime:
  an evicted plan would be silently re-resolved (and re-jitted) as a
  *duplicate* on the next ``get_plan`` while a frontend still held the
  original — double device memory and a cold compile on the request path.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

MISS = object()        # sentinel: distinguishes "no entry" from value None


class IdentityMemo:
    def __init__(self, max_entries: int = 32):
        self.max_entries = max_entries
        self._entries: dict = {}
        self._pinned: set = set()

    @staticmethod
    def _key(objs: Sequence[Optional[object]], extra: Tuple) -> Tuple:
        return (tuple(None if o is None else id(o) for o in objs)
                + tuple(extra))

    def get(self, objs: Sequence[Optional[object]], extra: Tuple = ()):
        """Return the cached value, or :data:`MISS`."""
        hit = self._entries.get(self._key(objs, extra))
        if hit is None:
            return MISS
        held, value = hit
        if all(h is o for h, o in zip(held, objs)):
            return value
        return MISS

    def put(self, objs: Sequence[Optional[object]], extra: Tuple,
            value, *, pin: bool = False) -> None:
        """Insert an entry.  ``pin=True`` exempts it from auto-eviction
        (and from the ``max_entries`` count) until :meth:`drop` removes
        it — for entries whose lifetime an external cache manages."""
        key = self._key(objs, extra)
        if key not in self._entries and \
                len(self._entries) - len(self._pinned) >= self.max_entries:
            for k in self._entries:
                if k not in self._pinned:
                    del self._entries[k]
                    break
        if pin:
            self._pinned.add(key)
        self._entries[key] = (tuple(objs), value)

    def drop(self, obj: object) -> int:
        """Remove (and unpin) every entry keyed on ``obj``'s identity;
        returns how many were dropped.  The release half of the pinned
        contract: an entry owned by an external manager is removed here,
        never by auto-eviction."""
        dropped = 0
        for key in list(self._entries):
            held, _ = self._entries[key]
            if any(h is obj for h in held):
                del self._entries[key]
                self._pinned.discard(key)
                dropped += 1
        return dropped
