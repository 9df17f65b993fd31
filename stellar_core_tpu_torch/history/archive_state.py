"""HistoryArchiveState: the JSON manifest naming a checkpoint's buckets.

Copied from `stellar_core_tpu/history/archive_state.py` at commit
86c1c88; carry a fix in either copy to the other.

Role parity: reference `src/history/HistoryArchive.{h,cpp}` (HAS struct,
cereal-serialized) — version, server string, currentLedger, and one
{curr, snap, next} hash triple per bucket level. `next` captures an
in-flight merge so restarts can resume it (reference FutureBucket
serialization states: clear / hashes / live-output).
"""

from __future__ import annotations

import json
from typing import List, Optional

HAS_VERSION = 1
ZERO = "0" * 64


class HASLevel:
    """next states mirror the reference FutureBucket serialization:
    0 = clear, 1 = output hash (merge resolved), 2 = input hashes
    (merge in flight: curr/snap/shadows — the only way a pre-12 shadowed
    merge can be resumed after restart/catchup)."""

    def __init__(self, curr: str = ZERO, snap: str = ZERO,
                 next_state: int = 0,
                 next_output: Optional[str] = None,
                 next_curr: Optional[str] = None,
                 next_snap: Optional[str] = None,
                 next_shadows: Optional[List[str]] = None) -> None:
        self.curr = curr
        self.snap = snap
        self.next_state = next_state
        self.next_output = next_output
        self.next_curr = next_curr
        self.next_snap = next_snap
        self.next_shadows = next_shadows or []

    def to_dict(self) -> dict:
        nxt: dict = {"state": self.next_state}
        if self.next_output is not None:
            nxt["output"] = self.next_output
        if self.next_state == 2:
            nxt["curr"] = self.next_curr
            nxt["snap"] = self.next_snap
            nxt["shadow"] = list(self.next_shadows)
        return {"curr": self.curr, "next": nxt, "snap": self.snap}

    @classmethod
    def from_dict(cls, d: dict) -> "HASLevel":
        nxt = d.get("next", {}) or {}
        return cls(d.get("curr", ZERO), d.get("snap", ZERO),
                   nxt.get("state", 0), nxt.get("output"),
                   nxt.get("curr"), nxt.get("snap"),
                   nxt.get("shadow"))


class HistoryArchiveState:
    def __init__(self, current_ledger: int = 0,
                 levels: Optional[List[HASLevel]] = None,
                 server: str = "stellar-core-tpu") -> None:
        from ..bucket import K_NUM_LEVELS
        self.version = HAS_VERSION
        self.server = server
        self.current_ledger = current_ledger
        self.levels = levels or [HASLevel() for _ in range(K_NUM_LEVELS)]

    @classmethod
    def from_bucket_list(cls, current_ledger: int, bucket_list,
                         server: str = "stellar-core-tpu"
                         ) -> "HistoryArchiveState":
        levels = []
        for lev in bucket_list.levels:
            nxt_state, nxt_out = 0, None
            nxt_curr = nxt_snap = None
            nxt_shadows: Optional[List[str]] = None
            if lev.next.is_live() and lev.next.merge_complete():
                nxt_state, nxt_out = 1, lev.next.resolve().get_hash().hex()
            elif lev.next.is_merging() and lev.next.has_hashes():
                # in-flight: record the merge INPUTS so a restart (or a
                # catchup assuming this state) resumes the exact merge —
                # shadowed pre-12 merges are not reconstructible any
                # other way
                nxt_state = 2
                nxt_curr = lev.next.input_curr_hash.hex()
                nxt_snap = lev.next.input_snap_hash.hex()
                nxt_shadows = [h.hex() for h in lev.next.input_shadow_hashes]
            levels.append(HASLevel(lev.curr.get_hash().hex(),
                                   lev.snap.get_hash().hex(),
                                   nxt_state, nxt_out,
                                   nxt_curr, nxt_snap, nxt_shadows))
        return cls(current_ledger, levels, server)

    def bucket_hashes(self) -> List[str]:
        """Every non-zero hash referenced (reference
        HistoryArchiveState::allBuckets) — including in-flight merge
        inputs and shadows, so archives carry what a resume needs."""
        out = []
        for lv in self.levels:
            for h in ((lv.curr, lv.snap, lv.next_output,
                       lv.next_curr, lv.next_snap) +
                      tuple(lv.next_shadows)):
                if h and h != ZERO:
                    out.append(h)
        return out

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "server": self.server,
            "currentLedger": self.current_ledger,
            "currentBuckets": [lv.to_dict() for lv in self.levels],
        }, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "HistoryArchiveState":
        d = json.loads(s)
        has = cls(d["currentLedger"],
                  [HASLevel.from_dict(x) for x in d["currentBuckets"]],
                  d.get("server", ""))
        has.version = d.get("version", HAS_VERSION)
        return has

def has_level_dicts(has: "HistoryArchiveState") -> List[dict]:
    """HAS levels → the bytes-keyed dicts BucketManager.assume_state
    takes (curr/snap always; next merge as output or inputs+shadows)."""
    out = []
    for lv in has.levels:
        d: dict = {"curr": bytes.fromhex(lv.curr),
                   "snap": bytes.fromhex(lv.snap)}
        if lv.next_state == 1 and lv.next_output:
            d["next_output"] = bytes.fromhex(lv.next_output)
        elif lv.next_state == 2 and lv.next_curr:
            d["next_curr"] = bytes.fromhex(lv.next_curr)
            d["next_snap"] = bytes.fromhex(lv.next_snap)
            d["next_shadows"] = [bytes.fromhex(h)
                                 for h in lv.next_shadows]
        out.append(d)
    return out
