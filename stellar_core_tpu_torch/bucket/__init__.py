"""Bucket layer: content-addressed LSM of canonical ledger entries.

Copied from `stellar_core_tpu/bucket/__init__.py` at commit bb973b8;
carry a fix in either copy to the other.

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
from .applicator import BucketApplicator, apply_buckets
from .bucket_index import (
    BloomFilter, BucketDB, BucketDbStats, BucketIndex, IndexLoadError,
    sidecar_path,
)

__all__ = [
    "BloomFilter", "Bucket", "BucketApplicator", "BucketDB",
    "BucketDbStats", "BucketIndex", "BucketLevel", "BucketList",
    "BucketManager", "FutureBucket", "IndexLoadError", "K_NUM_LEVELS",
    "apply_buckets", "sidecar_path",
    "bucket_entry_sort_key", "keep_dead_entries", "level_half",
    "level_should_spill", "level_size", "mask", "merge_buckets",
    "oldest_ledger_in_curr", "oldest_ledger_in_snap", "size_of_curr",
    "size_of_snap",
    "FIRST_PROTOCOL_SHADOWS_REMOVED",
    "FIRST_PROTOCOL_SUPPORTING_INITENTRY_AND_METAENTRY",
]
