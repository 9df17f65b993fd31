"""BucketApplicator: stream a bucket's entries into ledger state.

Copied from `stellar_core_tpu/bucket/applicator.py` at commit cb8dcc3;
carry a fix in either copy to the other.

Role parity: reference `src/bucket/BucketApplicator.{h,cpp}` — used by
catchup's ApplyBucketsWork to load a downloaded bucket-list snapshot into
the database in bounded chunks, newest level first, so the main loop stays
responsive.
"""

from __future__ import annotations

from typing import Iterable, Optional

from ..ledger.ledgertxn import LedgerTxn
from ..xdr import BucketEntryType, ledger_entry_key
from .bucket import Bucket


class BucketApplicator:
    def __init__(self, root, bucket: Bucket,
                 chunk_size: int = 0x1000) -> None:
        self._root = root
        self._entries = bucket.payload_entries()
        self._pos = 0
        self._chunk = chunk_size

    def __bool__(self) -> bool:
        return self._pos < len(self._entries)

    def advance(self) -> int:
        """Apply up to chunk_size entries in one nested commit; returns
        entries applied this step."""
        if not self:
            return 0
        n = 0
        # `with` rolls back on error: an abandoned-but-registered child
        # would otherwise block every future LedgerTxn over this root
        with LedgerTxn(self._root) as ltx:
            while self._pos < len(self._entries) and n < self._chunk:
                e = self._entries[self._pos]
                self._pos += 1
                t = e.disc
                if t in (BucketEntryType.LIVEENTRY,
                         BucketEntryType.INITENTRY):
                    key = ledger_entry_key(e.value)
                    cur = ltx.load(key)
                    if cur is not None:
                        cur.lastModifiedLedgerSeq = \
                            e.value.lastModifiedLedgerSeq
                        cur.data = e.value.data
                        cur.ext = e.value.ext
                    else:
                        ltx.create(e.value)
                elif t == BucketEntryType.DEADENTRY:
                    if ltx.load(e.value) is not None:
                        ltx.erase(e.value)
                n += 1
        return n


def apply_buckets(root, buckets: Iterable[Bucket]) -> int:
    """Apply a sequence of buckets newest-first (reference ApplyBucketsWork
    order: level 0 curr, level 0 snap, level 1 curr, ...). Entries already
    present (set by a newer bucket) must win, hence the load-before-create
    check in advance(); dead entries delete only if present."""
    total = 0
    seen = set()
    # Newest-first with a seen-key shield: the first bucket to mention a key
    # decides its final state; older buckets' entries for that key are noise.
    with LedgerTxn(root) as ltx:
        for b in buckets:
            for e in b.payload_entries():
                t = e.disc
                if t == BucketEntryType.METAENTRY:
                    continue
                if t in (BucketEntryType.LIVEENTRY,
                         BucketEntryType.INITENTRY):
                    key = ledger_entry_key(e.value)
                    kx = key.to_xdr()
                    if kx in seen:
                        continue
                    seen.add(kx)
                    cur = ltx.load(key)
                    if cur is not None:
                        cur.lastModifiedLedgerSeq = \
                            e.value.lastModifiedLedgerSeq
                        cur.data = e.value.data
                        cur.ext = e.value.ext
                    else:
                        ltx.create(e.value)
                elif t == BucketEntryType.DEADENTRY:
                    kx = e.value.to_xdr()
                    if kx in seen:
                        continue
                    seen.add(kx)
                    if ltx.load(e.value) is not None:
                        ltx.erase(e.value)
                total += 1
    return total
