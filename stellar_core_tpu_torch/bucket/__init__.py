"""Bucket layer: content-addressed LSM of canonical ledger entries.

Copied (the exports of what is ported) from `stellar_core_tpu/bucket/
__init__.py` at commit bb973b8; carry a fix in either copy to the other.
The reference's `BucketApplicator` / `apply_buckets` (they write through
`ledgertxn`) and BucketDB (`bucket_index.py`) are not ported yet.

Role parity: reference `src/bucket` (BucketList.h:14)."""

from .bucket import (
    Bucket, bucket_entry_sort_key, merge_buckets,
    FIRST_PROTOCOL_SHADOWS_REMOVED,
    FIRST_PROTOCOL_SUPPORTING_INITENTRY_AND_METAENTRY,
)
from .bucket_list import (
    BucketLevel, BucketList, FutureBucket, K_NUM_LEVELS, keep_dead_entries,
    level_half, level_should_spill, level_size, mask, oldest_ledger_in_curr,
    oldest_ledger_in_snap, size_of_curr, size_of_snap,
)
from .bucket_manager import BucketManager

__all__ = [
    "Bucket", "BucketLevel", "BucketList", "BucketManager", "FutureBucket",
    "K_NUM_LEVELS",
    "bucket_entry_sort_key", "keep_dead_entries", "level_half",
    "level_should_spill", "level_size", "mask", "merge_buckets",
    "oldest_ledger_in_curr", "oldest_ledger_in_snap", "size_of_curr",
    "size_of_snap",
    "FIRST_PROTOCOL_SHADOWS_REMOVED",
    "FIRST_PROTOCOL_SUPPORTING_INITENTRY_AND_METAENTRY",
]
