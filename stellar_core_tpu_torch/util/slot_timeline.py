"""SlotTimeline: per-slot consensus event journal.

Copied from `stellar_core_tpu/util/slot_timeline.py` at commit 6dc7ba8;
carry a fix in either copy to the other. Nothing is left out.

Role parity: the reference answers "where did slot N spend its time"
with per-node medida timers plus operator folklore; committee-consensus
measurement work (arXiv:2302.00418, DSig in PAPERS.md) shows commit
latency is dominated by cross-node propagation and stragglers — a
dimension a per-node span ring cannot see. This module records, for
every slot, the consensus-visible moments (first nomination vote seen,
own vote, accepts, ballot phase transitions, externalize, txset fetch,
ledger apply), each stamped with:

- `t`  — the application clock (virtual in tests/simulation, monotonic
  live), the per-node causal order;
- `pc` — `time.perf_counter()`, shared by every node in one process, so
  the fleet aggregator (util/fleet.py) can align N simulated nodes on
  one axis and compute externalize skew / flood latency across them.

Events carrying a `node` name the *sending* node (hex node id) — the
raw material for flood-latency and straggler attribution.

The journal is always on (unlike the span tracer): one dict append per
event, bounded by `max_slots` slots x `max_events_per_slot` events, with
per-slot (event, node) dedup for the seen-from-peer sites so a chatty
peer can't grow a slot's journal past nodes x statement-types.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set, Tuple

DEFAULT_MAX_SLOTS = 64
DEFAULT_MAX_EVENTS = 512


class SlotTimeline:
    def __init__(self, now_fn: Optional[Callable[[], float]] = None,
                 max_slots: int = DEFAULT_MAX_SLOTS,
                 max_events_per_slot: int = DEFAULT_MAX_EVENTS) -> None:
        self._now = now_fn or time.monotonic
        self.max_slots = max_slots
        self.max_events_per_slot = max_events_per_slot
        self._slots: "OrderedDict[int, List[dict]]" = OrderedDict()
        self._seen: Dict[int, Set[Tuple[str, Optional[str]]]] = {}
        self.dropped_slots = 0    # slots evicted from the ring
        self.dropped_events = 0   # events refused (stale slot / full slot)

    # -- recording -----------------------------------------------------------
    def record(self, slot: int, event: str,
               node: Optional[str] = None, dedupe: bool = False,
               dedupe_key: Optional[str] = None,
               **tags) -> bool:
        """Append one event to `slot`'s journal. With dedupe=True, only
        the FIRST (event, node) pair per slot is kept — the envelope-seen
        sites use this so the journal records first-arrival times, not
        every duplicate flood copy. `dedupe_key` replaces `node` in the
        dedup identity for events whose distinguishing dimension isn't
        the sender (competing txsets for one slot keyed by hash).
        Returns False when the event was dropped (deduped, slot evicted,
        or journal full)."""
        evs = self._slots.get(slot)
        if evs is None:
            if len(self._slots) >= self.max_slots:
                oldest = min(self._slots)
                if slot < oldest:
                    # a straggler event for an already-evicted slot must
                    # not resurrect it (the ring tracks RECENT slots)
                    self.dropped_events += 1
                    return False
                del self._slots[oldest]
                self._seen.pop(oldest, None)
                self.dropped_slots += 1
            evs = self._slots[slot] = []
        if dedupe:
            seen = self._seen.setdefault(slot, set())
            key = (event, dedupe_key if dedupe_key is not None else node)
            if key in seen:
                self.dropped_events += 1
                return False
            seen.add(key)
        if len(evs) >= self.max_events_per_slot:
            self.dropped_events += 1
            return False
        ev = {"event": event, "t": round(self._now(), 6),
              "pc": time.perf_counter()}
        if node is not None:
            ev["node"] = node
        if tags:
            ev.update(tags)
        evs.append(ev)
        return True

    # -- inspection ----------------------------------------------------------
    def slots(self) -> List[int]:
        return sorted(self._slots)

    def events(self, slot: int) -> List[dict]:
        # copies, not aliases: consumers (the fleet aggregator rebases
        # pc stamps in place) must not corrupt the live journal
        return [dict(ev) for ev in self._slots.get(slot, ())]

    def first(self, slot: int, event: str) -> Optional[dict]:
        for ev in self._slots.get(slot, ()):
            if ev["event"] == event:
                return ev
        return None

    def to_json(self, slot: Optional[int] = None) -> dict:
        """One slot's journal (`slot=N`) or the whole ring. The admin
        `timeline` endpoint and the fleet aggregator both consume this
        schema: {slots: {"<idx>": [event...]}, dropped_*}."""
        if slot is not None:
            slots = {str(slot): self.events(slot)}
        else:
            slots = {str(i): [dict(ev) for ev in evs]
                     for i, evs in sorted(self._slots.items())}
        return {"slots": slots,
                "dropped_slots": self.dropped_slots,
                "dropped_events": self.dropped_events}

    def clear(self) -> None:
        self._slots.clear()
        self._seen.clear()
        self.dropped_slots = 0
        self.dropped_events = 0
