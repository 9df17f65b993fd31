"""BucketManager: content-addressed bucket store + the node's BucketList.

Copied from `stellar_core_tpu/bucket/bucket_manager.py` at commit bb973b8;
carry a fix in either copy to the other. BucketDB (`bucket_index.py`:
bloom-filtered per-bucket indexes built at adoption, serving
`LedgerTxnRoot`'s point reads) hooks the constructor, `adopt_bucket`
(`on_adopt`), `forget_unreferenced_buckets` (`invalidate`) and `shutdown`
(`close`); the close cockpit's `stats` (ApplyStats,
`ledger/apply_stats.py`) takes the level sizes at each snapshot and the
merge timings (`FutureBucket`'s `on_done`). The merge pool's size (the
reference's `num_workers` option, default 2) is the constant
`MERGE_WORKERS`.

Role parity: reference `src/bucket/BucketManager{,Impl}.{h,cpp}` — owns the
bucket directory (files named bucket-<hex>.xdr), dedups adopted buckets by
hash, tracks referenced hashes for GC (forgetUnreferencedBuckets), and runs
level merges on a shared worker pool (reference worker threads;
ThreadPoolExecutor here).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from ..util.log import get_logger
from ..util.threads import main_thread_only
from ..xdr import LedgerEntry, LedgerKey
from .bucket import Bucket
from .bucket_list import BucketList, K_NUM_LEVELS

log = get_logger("Bucket")

ZERO_HASH = b"\x00" * 32

# skip-list stride constants (reference BucketManager.h): every SKIP_1
# ledgers the header's skipList[0] takes the close's bucket-list hash,
# cascading the older values down at the larger strides
SKIP_1 = 50
SKIP_2 = 5000
SKIP_3 = 50000
SKIP_4 = 500000

# worker threads of the background merge pool (the reference's default)
MERGE_WORKERS = 2


def calculate_skip_values(header) -> None:
    """Advance the header's skipList in place (reference
    BucketManagerImpl::calculateSkipValues, BucketManagerImpl.cpp:726-752).
    Consensus-visible: every node must shift the same values at the same
    sequence numbers or header hashes fork."""
    if header.ledgerSeq % SKIP_1 != 0:
        return
    v = header.ledgerSeq - SKIP_1
    if v > 0 and v % SKIP_2 == 0:
        v = header.ledgerSeq - SKIP_2 - SKIP_1
        if v > 0 and v % SKIP_3 == 0:
            v = header.ledgerSeq - SKIP_3 - SKIP_2 - SKIP_1
            if v > 0 and v % SKIP_4 == 0:
                header.skipList[3] = header.skipList[2]
            header.skipList[2] = header.skipList[1]
        header.skipList[1] = header.skipList[0]
    header.skipList[0] = header.bucketListHash


class BucketManager:
    def __init__(self, bucket_dir: Optional[str] = None,
                 background_merges: bool = True,
                 stats=None, bucketdb_stats=None, faults=None,
                 bloom_bits_per_key: int = 10,
                 eager_index: bool = True) -> None:
        self.bucket_dir = bucket_dir
        if bucket_dir:
            os.makedirs(bucket_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._shared: Dict[bytes, Bucket] = {}
        self._executor = (ThreadPoolExecutor(
            max_workers=MERGE_WORKERS,
            thread_name_prefix="bucket-merge") if background_merges else None)
        # close cockpit (ledger/apply_stats.py): per-level sizes recorded
        # at every snapshot, merge durations from the worker pool
        self._stats = stats
        self.bucket_list = BucketList(self._executor, adopt=self.adopt_bucket,
                                      stats=stats)
        # BucketDB: bloom-filtered per-bucket indexes over the
        # live list, built at adopt time (close path + merge workers),
        # sidecars persisted beside the bucket files; LedgerTxnRoot
        # point reads route through it (bucket/bucket_index.py)
        from .bucket_index import BucketDB
        self.bucketdb = BucketDB(self, stats=bucketdb_stats, faults=faults,
                                 bits_per_key=bloom_bits_per_key,
                                 eager_index=eager_index)

    # -- store ---------------------------------------------------------------
    def bucket_filename(self, hash_: bytes) -> Optional[str]:
        if not self.bucket_dir:
            return None
        return os.path.join(self.bucket_dir, "bucket-%s.xdr" % hash_.hex())

    def adopt_bucket(self, b: Bucket) -> Bucket:
        """Deduplicate by hash and persist to the bucket dir (reference
        BucketManagerImpl::adoptFileAsBucket). Adoption also indexes the
        bucket for BucketDB (load the persisted sidecar, else build and
        persist one) — OUTSIDE the store lock, so a large merge output's
        index build never blocks concurrent bucket lookups."""
        h = b.get_hash()
        if h == ZERO_HASH:
            return b
        with self._lock:
            existing = self._shared.get(h)
            if existing is not None:
                return existing
            path = self.bucket_filename(h)
            if path and not os.path.exists(path):
                b.write_to(path + ".tmp")
                os.replace(path + ".tmp", path)
                b.path = path
            elif path:
                # bucket file already on disk (restart / catchup
                # re-download): serve reads from it
                b.path = path
            self._shared[h] = b
        self.bucketdb.on_adopt(b)
        return b

    def get_bucket_by_hash(self, hash_: bytes) -> Optional[Bucket]:
        if hash_ == ZERO_HASH:
            return Bucket()
        with self._lock:
            b = self._shared.get(hash_)
        if b is not None:
            return b
        path = self.bucket_filename(hash_)
        if path and os.path.exists(path):
            b = Bucket.read_from(path)
            return self.adopt_bucket(b)
        return None

    # -- the list ------------------------------------------------------------
    @main_thread_only
    def add_batch(self, curr_ledger: int, curr_ledger_protocol: int,
                  init_entries: Sequence[LedgerEntry],
                  live_entries: Sequence[LedgerEntry],
                  dead_entries: Sequence[LedgerKey]) -> None:
        self.bucket_list.add_batch(curr_ledger, curr_ledger_protocol,
                                   init_entries, live_entries, dead_entries)

    def get_hash(self) -> bytes:
        return self.bucket_list.get_hash()

    def snapshot_ledger(self, header) -> None:
        """Stamp the closing header with the bucket-list hash and advance
        its skipList (reference BucketManagerImpl::snapshotLedger)."""
        header.bucketListHash = self.get_hash()
        calculate_skip_values(header)
        if self._stats is not None:
            # per-level curr+snap entry counts — the close cockpit's
            # bucket-size view (bounded: K_NUM_LEVELS gauges)
            self._stats.record_level_sizes(
                (lev.level, len(lev.curr) + len(lev.snap))
                for lev in self.bucket_list.levels)

    def get_referenced_hashes(self) -> List[bytes]:
        refs: List[bytes] = []
        for lev in self.bucket_list.levels:
            for b in (lev.curr, lev.snap):
                if b.get_hash() != ZERO_HASH:
                    refs.append(b.get_hash())
            if lev.next.is_live():
                if lev.next.merge_complete():
                    refs.append(lev.next.resolve().get_hash())
                else:
                    if lev.next.input_curr_hash:
                        refs.append(lev.next.input_curr_hash)
                    if lev.next.input_snap_hash:
                        refs.append(lev.next.input_snap_hash)
                    refs.extend(lev.next.input_shadow_hashes)
        return refs

    def forget_unreferenced_buckets(
            self, extra_refs: Sequence[bytes] = ()) -> int:
        """GC: drop in-memory and on-disk buckets not referenced by the
        list (or by pending publish work via extra_refs) — reference
        BucketManagerImpl::forgetUnreferencedBuckets."""
        keep = set(self.get_referenced_hashes()) | set(extra_refs)
        dropped = 0
        victims = []
        with self._lock:
            for h in list(self._shared):
                if h not in keep:
                    b = self._shared.pop(h)
                    if b.path and os.path.exists(b.path):
                        os.remove(b.path)
                    victims.append((h, b.path))
                    dropped += 1
        # BucketDB index lifetime follows the bucket's: a GC'd bucket's
        # in-memory index, cached fd and persisted sidecar all go with
        # it — a stale sidecar left behind
        # would be adopted verbatim if the same content hash ever
        # returns, which is exactly why it must match the file's fate
        for h, path in victims:
            self.bucketdb.invalidate(h, path)
        return dropped

    # -- state restore (catchup / restart) -----------------------------------
    def assume_state(self, level_hashes: Sequence[Dict[str, object]],
                     curr_ledger: int, max_protocol_version: int) -> None:
        """Adopt a full set of level hashes (from a HistoryArchiveState)
        as the current bucket list, then resume merges (reference
        BucketManagerImpl::assumeState). Each level dict carries curr/
        snap plus the serialized next merge: "next_output" (resolved) or
        "next_curr"/"next_snap"/"next_shadows" (in flight) — the latter
        is the only way to resume a shadowed pre-12 merge exactly;
        restarting it shadowless forks the bucket hash chain."""
        from .bucket_list import FutureBucket, keep_dead_entries
        assert len(level_hashes) == K_NUM_LEVELS
        # resolve every bucket BEFORE mutating any level: a missing file
        # must not leave the list half-adopted
        resolved = []
        for i, lh in enumerate(level_hashes):
            curr = self.get_bucket_by_hash(lh["curr"])
            snap = self.get_bucket_by_hash(lh["snap"])
            if curr is None or snap is None:
                raise KeyError("missing bucket for level %d" % i)
            nxt = None
            if lh.get("next_output"):
                out = self.get_bucket_by_hash(lh["next_output"])
                if out is None:
                    raise KeyError("missing next output for level %d" % i)
                nxt = ("output", out)
            elif lh.get("next_curr"):
                mc = self.get_bucket_by_hash(lh["next_curr"])
                ms = self.get_bucket_by_hash(lh["next_snap"])
                sh = [self.get_bucket_by_hash(h)
                      for h in lh.get("next_shadows", [])]
                if mc is None or ms is None or any(s is None for s in sh):
                    raise KeyError("missing next inputs for level %d" % i)
                nxt = ("inputs", (mc, ms, sh))
            resolved.append((curr, snap, nxt))
        for i, (curr, snap, nxt) in enumerate(resolved):
            lev = self.bucket_list.get_level(i)
            lev.curr = curr
            lev.snap = snap
            lev.next.clear()
            if nxt is None:
                continue
            kind, payload = nxt
            if kind == "output":
                lev.next = FutureBucket.resolved(payload)
            else:
                mc, ms, sh = payload
                on_done = None
                if self._stats is not None:
                    on_done = (lambda secs, n, _s=self._stats, _l=i:
                               _s.record_merge(_l, secs, n))
                lev.next = FutureBucket.start(
                    self._executor, mc, ms, sh,
                    keep_dead=keep_dead_entries(i),
                    max_protocol_version=max_protocol_version,
                    adopt=self.adopt_bucket, on_done=on_done)
        self.bucket_list.restart_merges(curr_ledger)

    def shutdown(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
        self.bucketdb.close()
