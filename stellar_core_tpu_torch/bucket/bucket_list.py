"""BucketList: LSM-like temporal leveling of canonical ledger entries.

Copied from `stellar_core_tpu/bucket/bucket_list.py` at commit 637fb91;
carry a fix in either copy to the other. The close cockpit's `stats`
(ApplyStats, `ledger/apply_stats.py`) times each merge against its level
(`FutureBucket.start`'s `on_done`, `BucketLevel.prepare`).

Role parity: reference `src/bucket/BucketList.{h,cpp}` — kNumLevels=11
levels, each (curr, snap); level i spills every levelHalf(i) ledgers; merges
run in the background as futures (reference FutureBucket,
`bucket/FutureBucket.{h,cpp}`) and are committed (next→curr) when the level
above spills into them. The whole-list hash is
SHA256(concat_i SHA256(curr_i.hash ‖ snap_i.hash)) and lands in
`LedgerHeader.bucketListHash`.

Merges are pure CPU/IO (sorted-run merge) and stay on the host worker
pool, exactly like the reference's worker threads; the card sees a
bucket only when the state commitment hashes its entry leaves.
"""

from __future__ import annotations

from concurrent.futures import Executor, Future
from functools import lru_cache
from typing import Callable, List, Optional, Sequence

from ..crypto.hashing import SHA256
from ..util.log import get_logger
from ..xdr import LedgerEntry, LedgerKey
from .bucket import Bucket, merge_buckets

log = get_logger("Bucket")

K_NUM_LEVELS = 11
UINT32_MAX = 0xFFFFFFFF


# -- level arithmetic (reference BucketList.cpp:199-353) ---------------------

def level_size(level: int) -> int:
    """Idealized level size: 4^(level+1) (BucketList.cpp:210-215)."""
    assert level < K_NUM_LEVELS
    return 1 << (2 * (level + 1))


def level_half(level: int) -> int:
    return level_size(level) >> 1


def mask(v: int, m: int) -> int:
    return v & ~(m - 1) & UINT32_MAX


def level_should_spill(ledger: int, level: int) -> bool:
    """True at ledgers where `level` snaps curr and spills into level+1
    (BucketList.cpp:386-398); the deepest level never spills."""
    if level == K_NUM_LEVELS - 1:
        return False
    return (ledger == mask(ledger, level_half(level)) or
            ledger == mask(ledger, level_size(level)))


def keep_dead_entries(level: int) -> bool:
    """Tombstones are elided only when merging into the deepest level
    (BucketList.cpp:401-405)."""
    return level < K_NUM_LEVELS - 1


@lru_cache(maxsize=1 << 16)
def size_of_curr(ledger: int, level: int) -> int:
    """Number of ledgers covered by curr at `level` as of `ledger`
    (BucketList.cpp:245-283; validated by reference BucketListTests).
    Memoized: the recurrence branches into both (prev_relevant, level)
    and every lower level, which is exponential uncached (the reference
    caches the same way via BucketListDepth tables)."""
    assert ledger != 0 and level < K_NUM_LEVELS
    if level == 0:
        return 1 if ledger == 1 else 1 + ledger % 2
    size = level_size(level)
    half = level_half(level)
    if level != K_NUM_LEVELS - 1 and mask(ledger, half) != 0:
        size_delta = 1 << (2 * level - 1)
        if mask(ledger, half) == ledger or mask(ledger, size) == ledger:
            return size_delta
        prev_size = level_size(level - 1)
        prev_half = level_half(level - 1)
        prev_relevant = max(mask(ledger - 1, prev_half),
                            mask(ledger - 1, prev_size),
                            mask(ledger - 1, half),
                            mask(ledger - 1, size))
        if mask(ledger, prev_half) == ledger or \
                mask(ledger, prev_size) == ledger:
            return size_of_curr(prev_relevant, level) + size_delta
        return size_of_curr(prev_relevant, level)
    blsize = 0
    for lv in range(level):
        blsize += size_of_curr(ledger, lv)
        blsize += size_of_snap(ledger, lv)
    return ledger - blsize


@lru_cache(maxsize=1 << 16)
def size_of_snap(ledger: int, level: int) -> int:
    """(BucketList.cpp:286-310)."""
    assert ledger != 0 and level < K_NUM_LEVELS
    if level == K_NUM_LEVELS - 1:
        return 0
    if mask(ledger, level_size(level)) != 0:
        return level_half(level)
    size = 0
    for lv in range(level):
        size += size_of_curr(ledger, lv)
        size += size_of_snap(ledger, lv)
    size += size_of_curr(ledger, level)
    return ledger - size


def oldest_ledger_in_curr(ledger: int, level: int) -> int:
    """(BucketList.cpp:313-335)."""
    if size_of_curr(ledger, level) == 0:
        return UINT32_MAX
    count = ledger
    for lv in range(level):
        count -= size_of_curr(ledger, lv)
        count -= size_of_snap(ledger, lv)
    count -= size_of_curr(ledger, level)
    return count + 1


def oldest_ledger_in_snap(ledger: int, level: int) -> int:
    """(BucketList.cpp:337-354)."""
    if size_of_snap(ledger, level) == 0:
        return UINT32_MAX
    count = ledger
    for lv in range(level + 1):
        count -= size_of_curr(ledger, lv)
        count -= size_of_snap(ledger, lv)
    return count + 1


# -- FutureBucket ------------------------------------------------------------

class FutureBucket:
    """A pending (or resolved) merge producing a level's next curr
    (reference bucket/FutureBucket.h:54-63). States: clear, merging
    (future in flight), or live-resolved. Input hashes are retained so
    merges can be re-kicked after restart (restartMerges parity)."""

    FB_CLEAR = 0
    FB_MERGING = 1
    FB_RESOLVED = 2

    def __init__(self) -> None:
        self._state = FutureBucket.FB_CLEAR
        self._future: Optional[Future] = None
        self._result: Optional[Bucket] = None
        self.input_curr_hash: Optional[bytes] = None
        self.input_snap_hash: Optional[bytes] = None
        self.input_shadow_hashes: List[bytes] = []

    @classmethod
    def start(cls, executor: Optional[Executor], curr: Bucket, snap: Bucket,
              shadows: Sequence[Bucket], keep_dead: bool,
              max_protocol_version: int,
              adopt: Callable[[Bucket], Bucket],
              on_done: Optional[Callable[[float, int], None]] = None
              ) -> "FutureBucket":
        """`on_done(seconds, out_entries)` fires when the merge finishes
        (on the worker thread when an executor runs it) — the close
        cockpit's bucket-merge duration telemetry."""
        fb = cls()
        fb._state = FutureBucket.FB_MERGING
        fb.input_curr_hash = curr.get_hash()
        fb.input_snap_hash = snap.get_hash()
        fb.input_shadow_hashes = [s.get_hash() for s in shadows]

        def run() -> Bucket:
            from ..util.timer import real_monotonic
            t0 = real_monotonic()
            out = adopt(merge_buckets(
                curr, snap, shadows, keep_dead_entries=keep_dead,
                max_protocol_version=max_protocol_version))
            if on_done is not None:
                on_done(real_monotonic() - t0, len(out))
            return out

        if executor is not None:
            fb._future = executor.submit(run)
        else:
            fb._result = run()
        return fb

    @classmethod
    def resolved(cls, b: Bucket) -> "FutureBucket":
        fb = cls()
        fb._state = FutureBucket.FB_RESOLVED
        fb._result = b
        return fb

    def is_clear(self) -> bool:
        return self._state == FutureBucket.FB_CLEAR

    def is_live(self) -> bool:
        return self._state != FutureBucket.FB_CLEAR

    def is_merging(self) -> bool:
        return self._state == FutureBucket.FB_MERGING

    def merge_complete(self) -> bool:
        if self._state == FutureBucket.FB_RESOLVED:
            return True
        return self._future is not None and self._future.done()

    def resolve(self) -> Bucket:
        """Block until the merged bucket is available (reference
        FutureBucket::resolve)."""
        assert self.is_live()
        if self._state == FutureBucket.FB_MERGING:
            if self._future is not None:
                self._result = self._future.result()
                self._future = None
            self._state = FutureBucket.FB_RESOLVED
        assert self._result is not None
        return self._result

    def clear(self) -> None:
        self._state = FutureBucket.FB_CLEAR
        self._future = None
        self._result = None
        self.input_curr_hash = None
        self.input_snap_hash = None
        self.input_shadow_hashes = []

    def has_hashes(self) -> bool:
        return self.input_curr_hash is not None


# -- levels ------------------------------------------------------------------

class BucketLevel:
    """(curr, snap) pair plus the in-flight next curr
    (reference BucketLevel, BucketList.cpp:22-178)."""

    def __init__(self, level: int) -> None:
        self.level = level
        self.curr = Bucket()
        self.snap = Bucket()
        self.next = FutureBucket()
        # (curr_hash, snap_hash) -> level hash: most levels change only
        # at their spill boundaries, so a close re-hashes O(changed
        # levels), not all 11 (the incremental half of the state
        # commitment, applied to the consensus hash chain too)
        self._hash_cache: tuple = ()

    def get_hash(self) -> bytes:
        key = (self.curr.get_hash(), self.snap.get_hash())
        if len(self._hash_cache) == 2 and self._hash_cache[0] == key:
            return self._hash_cache[1]
        h = SHA256()
        h.add(key[0])
        h.add(key[1])
        out = h.finish()
        self._hash_cache = (key, out)
        return out

    def commit(self) -> None:
        """Promote a live next merge into curr (BucketList.cpp:80-89)."""
        if self.next.is_live():
            self.curr = self.next.resolve()
            self.next.clear()

    def snap_level(self) -> Bucket:
        """curr→snap, fresh empty curr (BucketList.cpp:168-178)."""
        self.snap = self.curr
        self.curr = Bucket()
        return self.snap

    def prepare(self, executor: Optional[Executor], curr_ledger: int,
                curr_ledger_protocol: int, snap: Bucket,
                shadows: Sequence[Bucket],
                adopt: Callable[[Bucket], Bucket],
                stats=None) -> None:
        """Kick off the merge for this level's next curr
        (BucketList.cpp:127-166). If this level's own curr is one
        prev-level-spill away from snapping, merge against an empty curr
        instead (the pending-snapshot subtlety). `stats` (ApplyStats)
        records the merge's duration against this level."""
        assert not self.next.is_merging(), "double prepare"
        curr = self.curr
        if self.level != 0:
            next_change = curr_ledger + level_half(self.level - 1)
            if level_should_spill(next_change, self.level):
                curr = Bucket()
        # at-and-after protocol 12 the snap determines shadow removal
        from .bucket import FIRST_PROTOCOL_SHADOWS_REMOVED
        use_shadows = [] if snap.get_version() >= \
            FIRST_PROTOCOL_SHADOWS_REMOVED else list(shadows)
        on_done = None
        if stats is not None:
            level = self.level
            on_done = (lambda secs, n, _s=stats, _l=level:
                       _s.record_merge(_l, secs, n))
        self.next = FutureBucket.start(
            executor, curr, snap, use_shadows,
            keep_dead=keep_dead_entries(self.level),
            max_protocol_version=curr_ledger_protocol, adopt=adopt,
            on_done=on_done)


class BucketList:
    def __init__(self, executor: Optional[Executor] = None,
                 adopt: Optional[Callable[[Bucket], Bucket]] = None,
                 stats=None) -> None:
        self.levels = [BucketLevel(i) for i in range(K_NUM_LEVELS)]
        self._executor = executor
        self._adopt = adopt or (lambda b: b)
        self._stats = stats   # ApplyStats: merge durations per level

    def get_level(self, i: int) -> BucketLevel:
        return self.levels[i]

    def get_hash(self) -> bytes:
        h = SHA256()
        for lev in self.levels:
            h.add(lev.get_hash())
        return h.finish()

    def resolve_any_ready_futures(self) -> None:
        for lev in self.levels:
            if lev.next.is_merging() and lev.next.merge_complete():
                lev.next.resolve()

    def futures_all_resolved(self, max_level: int = K_NUM_LEVELS - 1) -> bool:
        return not any(self.levels[i].next.is_merging()
                       for i in range(max_level + 1))

    def resolve_all_futures(self) -> None:
        for lev in self.levels:
            if lev.next.is_merging():
                lev.next.resolve()

    def get_max_merge_level(self, curr_ledger: int) -> int:
        i = 0
        while i < K_NUM_LEVELS - 1 and level_should_spill(curr_ledger, i):
            i += 1
        return i

    def add_batch(self, curr_ledger: int, curr_ledger_protocol: int,
                  init_entries: Sequence[LedgerEntry],
                  live_entries: Sequence[LedgerEntry],
                  dead_entries: Sequence[LedgerKey]) -> None:
        """One ledger close's delta enters level 0; spills cascade downward
        (reference BucketList::addBatch, BucketList.cpp:458-586). Processed
        deepest-level-first so a curr is snapped the moment it is
        half-a-level full."""
        assert curr_ledger > 0
        shadows: List[Bucket] = []
        for lev in self.levels:
            shadows.append(lev.curr)
            shadows.append(lev.snap)
        # levels i-1 and i never shadow their own merge (see reference
        # comment at BucketList.cpp:466-498): drop two per descent
        shadows = shadows[:-2]
        for i in range(K_NUM_LEVELS - 1, 0, -1):
            shadows = shadows[:-2]
            if level_should_spill(curr_ledger, i - 1):
                snap = self.levels[i - 1].snap_level()
                self.levels[i].commit()
                self.levels[i].prepare(self._executor, curr_ledger,
                                       curr_ledger_protocol, snap, shadows,
                                       self._adopt, stats=self._stats)
        assert not shadows
        fresh = self._adopt(Bucket.fresh(curr_ledger_protocol, init_entries,
                                         live_entries, dead_entries))
        self.levels[0].prepare(self._executor, curr_ledger,
                               curr_ledger_protocol, fresh, [], self._adopt,
                               stats=self._stats)
        self.levels[0].commit()
        self.resolve_any_ready_futures()

    def restart_merges(self, curr_ledger: int) -> None:
        """Re-kick merges whose inputs we still hold after a restart
        (reference BucketList::restartMerges, BucketList.cpp:588-640).
        Only valid with shadows removed (protocol >= 12), where the next
        state for level i+1 is recomputable from level i's snap alone; a
        clear next over a pre-12 nonempty snap means the serialized merge
        state was lost — restarting it shadowless would fork the bucket
        hash chain, so it is an error (reference :625-648)."""
        from .bucket import FIRST_PROTOCOL_SHADOWS_REMOVED
        for i in range(1, K_NUM_LEVELS):
            lev = self.levels[i]
            if lev.next.is_clear():
                snap = self.levels[i - 1].snap
                if snap.is_empty():
                    continue
                version = snap.get_version()
                if version < FIRST_PROTOCOL_SHADOWS_REMOVED:
                    raise RuntimeError(
                        "invalid state: level %d has clear future bucket "
                        "but pre-%d snap" % (i,
                                             FIRST_PROTOCOL_SHADOWS_REMOVED))
                # round the ledger down to when the merge was STARTED and
                # merge at the snap's own version — prepare()'s
                # pending-snapshot branch keys off the merge-start ledger,
                # and a mid-window restart ledger could flip its curr-vs-
                # empty decision (reference restartMerges:650-654)
                merge_start = mask(curr_ledger, level_half(i - 1))
                lev.prepare(self._executor, merge_start,
                            version, snap, [], self._adopt,
                            stats=self._stats)
