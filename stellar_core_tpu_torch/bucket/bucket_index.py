"""BucketDB: bloom-filtered, bucket-backed point reads over the bucket
list.

Copied from `stellar_core_tpu/bucket/bucket_index.py` at commit bb973b8;
carry a fix in either copy to the other. Key fingerprints stay one
`hashlib` SHA-256 per key on the host, as the reference's: the card's
SHA-256 hashes entry leaves for the state commitment, not these.

Role parity: stellar-core's BucketListDB direction (src/bucket/
BucketIndex.{h,cpp} + SearchableBucketListSnapshot) — serve apply-path
state reads from the immutable bucket files themselves and demote SQL to
a write-behind query index. Three layers:

- `BloomFilter`: per-bucket k-hash bloom over the bucket's LedgerKey
  XDR bytes, so a point read touches only the O(levels) buckets that
  MIGHT hold the key. Key fingerprints are one SHA-256 per lookup
  (process-stable — filters are persisted), double-hashed into k probes.
- `BucketIndex`: per-bucket sorted key index — for every payload entry,
  its canonical LedgerKey bytes plus (ordinal, file offset, length) of
  the LedgerEntry XDR inside the bucket file (DEAD tombstones carry
  length 0). Built at bucket write/merge time (adopt), memoized by the
  immutable bucket hash, persisted as a checksummed sidecar
  (`bucket-<hex>.xdr.idx`) beside the bucket file and rebuilt on any
  checksum/shape mismatch — a corrupt sidecar can degrade startup time,
  never correctness. The sidecar's bytes are the reference's, so either
  package loads the other's.
- `BucketDB`: the read facade. `lookup(kb)` walks the live bucket list
  newest-level-first (level 0 curr, level 0 snap, level 1 curr, ...)
  — bloom check, then index bisect, DEADENTRY short-circuits to
  "authoritatively absent". `prefetch_batch(kbs)` resolves a whole
  txset's touched keys in ONE pass per level (the txset_prefetch_keys
  bulk warm), feeding the apply engine its entry blobs directly through
  the warmed root cache. Blob bytes come from the bucket FILE via pread
  when the bucket is disk-backed (offsets are exercised for real,
  `bucketdb.bytes-read` is honest) and from the in-memory entry records
  otherwise.

`BucketDbStats` is the cockpit's BucketDB aggregation: one object,
private-registry default, `to_json` and `reset`.

Fault sites (util.faults): `bucketdb.index-corrupt` treats a sidecar
load as corrupt (exercises the rebuild path); `bucketdb.read-fail`
makes a read non-authoritative, degrading that lookup to the SQL
fallback in LedgerTxnRoot.

Threading: index builds run wherever buckets are adopted — the close
path (level-0 fresh buckets) and the bucket-merge worker pool — so the
memo and stats are lock-guarded; file reads use os.pread on cached fds
(no shared seek pointer).
"""

from __future__ import annotations

import hashlib
import os
import struct
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

from ..util.faults import check_faults
from ..util.log import get_logger
from ..util.metrics import MetricsRegistry
from ..util.threads import TrackedLock
from ..util.timer import real_monotonic
from ..xdr import BucketEntryType, ledger_entry_key

log = get_logger("Bucket")

_DEAD = BucketEntryType.DEADENTRY
_META = BucketEntryType.METAENTRY

# sidecar format: MAGIC | bucket hash | payload | SHA256(everything before)
_IDX_MAGIC = b"SCTIDX01"
_IDX_HEAD = struct.Struct("<IQB")      # n_keys, bloom bits, bloom k
_IDX_ROW = struct.Struct("<HIQI")      # key len, ordinal, offset, length

# a DEAD tombstone has no LedgerEntry payload; its row length is 0
_TOMBSTONE_LEN = 0


class IndexLoadError(Exception):
    """Sidecar missing/truncated/corrupt/mismatched — rebuild, don't
    trust (callers warn once and rebuild from the bucket itself)."""


def key_fingerprint(kb: bytes) -> Tuple[int, int]:
    """(h1, h2) bloom fingerprint of one LedgerKey XDR — computed ONCE
    per lookup and reused across every level's filter (double hashing:
    probe i is (h1 + i*h2) mod nbits). SHA-256 so persisted filters are
    stable across processes and PYTHONHASHSEED."""
    d = hashlib.sha256(kb).digest()
    return (int.from_bytes(d[:8], "little"),
            int.from_bytes(d[8:16], "little") | 1)


class BloomFilter:
    """Fixed-size k-hash bloom over key fingerprints."""

    __slots__ = ("nbits", "k", "bits", "_density")

    def __init__(self, nbits: int, k: int,
                 bits: Optional[bytearray] = None) -> None:
        assert nbits % 8 == 0 and nbits > 0 and k > 0
        self.nbits = nbits
        self.k = k
        self.bits = bits if bits is not None else bytearray(nbits // 8)
        self._density: Optional[float] = None

    @classmethod
    def for_capacity(cls, n: int, bits_per_key: int = 10) -> "BloomFilter":
        nbits = max(64, n * bits_per_key)
        nbits = (nbits + 7) & ~7
        # k = ln(2) * bits/key is the optimal probe count
        k = max(1, round(0.693 * bits_per_key))
        return cls(nbits, k)

    def add(self, fp: Tuple[int, int]) -> None:
        h1, h2 = fp
        bits, nbits = self.bits, self.nbits
        for i in range(self.k):
            b = (h1 + i * h2) % nbits
            bits[b >> 3] |= 1 << (b & 7)
        self._density = None

    def might_contain(self, fp: Tuple[int, int]) -> bool:
        h1, h2 = fp
        bits, nbits = self.bits, self.nbits
        for i in range(self.k):
            b = (h1 + i * h2) % nbits
            if not bits[b >> 3] & (1 << (b & 7)):
                return False
        return True

    def bit_density(self) -> float:
        """Fraction of set bits — the saturation signal the cockpit
        exposes (≈0.5 at design load for the optimal k). Memoized after
        the first call: filters are only mutated while their index is
        being built, and a million-key filter's popcount is ~1.25 MB of
        work that must never recur per close (the shape gauges refresh
        on every adopted bucket)."""
        if self._density is None:
            ones = bin(int.from_bytes(bytes(self.bits),
                                      "little")).count("1")
            self._density = ones / self.nbits
        return self._density


class BucketIndex:
    """Sorted (key -> ordinal/offset/length) map for one immutable
    bucket, plus its bloom filter. `ordinal` indexes the bucket's FULL
    entry tuple (META included) for the in-memory read path; `offset`/
    `length` locate the LedgerEntry XDR inside the on-disk framed
    stream for the pread path. length 0 marks a DEADENTRY."""

    __slots__ = ("bucket_hash", "keys", "ordinals", "offsets", "lengths",
                 "bloom")

    def __init__(self, bucket_hash: bytes, keys: List[bytes],
                 ordinals: List[int], offsets: List[int],
                 lengths: List[int], bloom: BloomFilter) -> None:
        self.bucket_hash = bucket_hash
        self.keys = keys
        self.ordinals = ordinals
        self.offsets = offsets
        self.lengths = lengths
        self.bloom = bloom

    def __len__(self) -> int:
        return len(self.keys)

    @classmethod
    def build(cls, bucket, bits_per_key: int = 10) -> "BucketIndex":
        """Index one bucket from its in-memory entries, computing each
        record's position in the on-disk framed stream (the exact bytes
        write_to/entry_record produce — 4-byte mark, 4-byte union disc,
        then the LedgerEntry/LedgerKey XDR)."""
        from .bucket import entry_record
        rows: List[Tuple[bytes, int, int, int]] = []
        off = 0
        for ordinal, e in enumerate(bucket.entries):
            rec_len = len(entry_record(e))
            t = e.disc
            if t == _META:
                off += rec_len
                continue
            if t == _DEAD:
                kb = e.value.to_xdr()
                rows.append((kb, ordinal, off + 8, _TOMBSTONE_LEN))
            else:
                kb = ledger_entry_key(e.value).to_xdr()
                rows.append((kb, ordinal, off + 8, rec_len - 8))
            off += rec_len
        rows.sort(key=lambda r: r[0])
        bloom = BloomFilter.for_capacity(len(rows), bits_per_key)
        keys: List[bytes] = []
        ordinals: List[int] = []
        offsets: List[int] = []
        lengths: List[int] = []
        for kb, ordinal, o, ln in rows:
            keys.append(kb)
            ordinals.append(ordinal)
            offsets.append(o)
            lengths.append(ln)
            bloom.add(key_fingerprint(kb))
        return cls(bucket.get_hash(), keys, ordinals, offsets, lengths,
                   bloom)

    def lookup(self, kb: bytes) -> Optional[Tuple[int, int, int]]:
        """(ordinal, offset, length) of the entry for `kb`, or None."""
        i = bisect_left(self.keys, kb)
        if i < len(self.keys) and self.keys[i] == kb:
            return (self.ordinals[i], self.offsets[i], self.lengths[i])
        return None

    # -- sidecar persistence --------------------------------------------------
    def to_bytes(self) -> bytes:
        parts = [_IDX_MAGIC, self.bucket_hash,
                 _IDX_HEAD.pack(len(self.keys), self.bloom.nbits,
                                self.bloom.k),
                 bytes(self.bloom.bits)]
        pack = _IDX_ROW.pack
        for kb, ordinal, off, ln in zip(self.keys, self.ordinals,
                                        self.offsets, self.lengths):
            parts.append(pack(len(kb), ordinal, off, ln))
            parts.append(kb)
        body = b"".join(parts)
        return body + hashlib.sha256(body).digest()

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(self.to_bytes())
        os.replace(tmp, path)

    @classmethod
    def from_bytes(cls, raw: bytes,
                   expected_hash: Optional[bytes] = None) -> "BucketIndex":
        if len(raw) < len(_IDX_MAGIC) + 32 + _IDX_HEAD.size + 32:
            raise IndexLoadError("sidecar truncated (%d bytes)" % len(raw))
        body, csum = raw[:-32], raw[-32:]
        if hashlib.sha256(body).digest() != csum:
            raise IndexLoadError("sidecar checksum mismatch")
        if not raw.startswith(_IDX_MAGIC):
            raise IndexLoadError("bad sidecar magic")
        p = len(_IDX_MAGIC)
        bucket_hash = body[p:p + 32]
        p += 32
        if expected_hash is not None and bucket_hash != expected_hash:
            raise IndexLoadError(
                "sidecar indexes bucket %s, expected %s"
                % (bucket_hash.hex()[:8], expected_hash.hex()[:8]))
        n, nbits, k = _IDX_HEAD.unpack_from(body, p)
        p += _IDX_HEAD.size
        nbytes = nbits // 8
        if p + nbytes > len(body):
            raise IndexLoadError("sidecar bloom truncated")
        bloom = BloomFilter(nbits, k, bytearray(body[p:p + nbytes]))
        p += nbytes
        keys: List[bytes] = []
        ordinals: List[int] = []
        offsets: List[int] = []
        lengths: List[int] = []
        unpack = _IDX_ROW.unpack_from
        row = _IDX_ROW.size
        for _ in range(n):
            if p + row > len(body):
                raise IndexLoadError("sidecar row table truncated")
            klen, ordinal, off, ln = unpack(body, p)
            p += row
            if p + klen > len(body):
                raise IndexLoadError("sidecar key bytes truncated")
            keys.append(body[p:p + klen])
            p += klen
            ordinals.append(ordinal)
            offsets.append(off)
            lengths.append(ln)
        if p != len(body):
            raise IndexLoadError("sidecar trailing garbage")
        return cls(bucket_hash, keys, ordinals, offsets, lengths, bloom)

    @classmethod
    def load(cls, path: str,
             expected_hash: Optional[bytes] = None) -> "BucketIndex":
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError as e:
            raise IndexLoadError("sidecar unreadable: %s" % e)
        return cls.from_bytes(raw, expected_hash)


def sidecar_path(bucket_path: str) -> str:
    return bucket_path + ".idx"


class BucketDbStats:
    """BucketDB cockpit aggregation (see module docstring). Private
    registry when none is injected."""

    def __init__(self, metrics=None, tracer=None, now_fn=None) -> None:
        self._now = now_fn or real_monotonic
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(now_fn=self._now)
        self.tracer = tracer
        self._lock = TrackedLock("bucketdb-stats")
        m = self.metrics
        self._m_reads = m.new_meter("bucketdb.reads")
        self._m_hit = m.new_meter("bucketdb.read.hit")
        self._m_miss = m.new_meter("bucketdb.read.miss")
        self._m_tomb = m.new_meter("bucketdb.read.tombstone")
        self._m_bloom_skip = m.new_meter("bucketdb.bloom.skips")
        self._m_bytes = m.new_meter("bucketdb.bytes-read")
        self._m_builds = m.new_meter("bucketdb.index.builds")
        self._m_loads = m.new_meter("bucketdb.index.loads")
        self._m_loadfail = m.new_meter("bucketdb.index.load-failures")
        self._m_sql_fallback = m.new_meter("bucketdb.fallback.sql")
        self._h_build = m.new_histogram("bucketdb.index.build.seconds")
        self._h_load = m.new_histogram("bucketdb.index.load.seconds")
        self._h_batch = m.new_histogram("bucketdb.prefetch.batch-keys")
        self._g_indexes = m.new_gauge("bucketdb.indexes")
        self._g_entries = m.new_gauge("bucketdb.index.entries")
        self._g_density = m.new_gauge("bucketdb.bloom.bit-density-pct")
        # per-level probe attribution, memoized (bounded: K_NUM_LEVELS
        # levels x {curr,snap} share one level number)
        self._m_level: Dict[Tuple[int, str], object] = {}
        self.reset()

    def reset(self) -> None:
        """Zero the cumulative aggregates (registry metrics keep their
        monotonic histories)."""
        with self._lock:
            self.reads = {"total": 0, "hits": 0, "misses": 0,
                          "tombstones": 0}
            self.levels: Dict[int, dict] = {}
            self.bloom = {"checks": 0, "skips": 0}
            self.index = {"builds": 0, "loads": 0, "load_failures": 0,
                          "build_seconds": 0.0, "load_seconds": 0.0}
            self.prefetch = {"batches": 0, "keys": 0, "resolved": 0}
            self.bytes_read = 0
            self.sql_fallbacks = 0

    def _level_meter(self, level: int, kind: str):
        key = (level, kind)
        mtr = self._m_level.get(key)
        if mtr is None:
            mtr = self.metrics.new_meter(
                "bucketdb.level.%d.%s" % (level, kind))
            self._m_level[key] = mtr
        return mtr

    def record_read(self, outcome: str, levels_probed,
                    bytes_read: int = 0) -> None:
        """One point read: outcome in hit|miss|tombstone, `levels_probed`
        is [(level, probe_outcome)] with probe_outcome in
        bloom-skip|hit|false-positive — folded into one lock
        acquisition (this hook sits inside the path it measures)."""
        self._m_reads.mark()
        if outcome == "hit":
            self._m_hit.mark()
        elif outcome == "tombstone":
            self._m_tomb.mark()
        else:
            self._m_miss.mark()
        if bytes_read:
            self._m_bytes.mark(bytes_read)
        for level, po in levels_probed:
            if po == "bloom-skip":
                self._m_bloom_skip.mark()
            else:
                self._level_meter(
                    level, "hits" if po == "hit" else "false-positives"
                ).mark()
            self._level_meter(level, "probes").mark()
        with self._lock:
            r = self.reads
            r["total"] += 1
            r["hits" if outcome == "hit" else
              "tombstones" if outcome == "tombstone" else "misses"] += 1
            self.bytes_read += bytes_read
            for level, po in levels_probed:
                lv = self.levels.setdefault(
                    level, {"probes": 0, "hits": 0, "false_positives": 0,
                            "bloom_skips": 0})
                lv["probes"] += 1
                if po == "bloom-skip":
                    lv["bloom_skips"] += 1
                    self.bloom["skips"] += 1
                elif po == "hit":
                    lv["hits"] += 1
                else:
                    lv["false_positives"] += 1
                self.bloom["checks"] += 1

    def record_build(self, seconds: float) -> None:
        self._m_builds.mark()
        self._h_build.update(seconds)
        with self._lock:
            self.index["builds"] += 1
            self.index["build_seconds"] += seconds

    def record_load(self, seconds: float) -> None:
        self._m_loads.mark()
        self._h_load.update(seconds)
        with self._lock:
            self.index["loads"] += 1
            self.index["load_seconds"] += seconds

    def record_load_failure(self) -> None:
        self._m_loadfail.mark()
        with self._lock:
            self.index["load_failures"] += 1

    def record_prefetch_batch(self, keys: int, resolved: int,
                              level_probes=(),
                              bytes_read: int = 0) -> None:
        """One batched prefetch pass; `level_probes` is
        [(level, bloom_skips, hits, false_positives)] aggregated over
        the pass, so batched reads feed the same per-level probe
        attribution (and the false-positive rate) as point lookups."""
        self._h_batch.update(keys)
        if bytes_read:
            self._m_bytes.mark(bytes_read)
        for level, skips, hits, fps in level_probes:
            if skips:
                self._m_bloom_skip.mark(skips)
            if hits:
                self._level_meter(level, "hits").mark(hits)
            if fps:
                self._level_meter(level, "false-positives").mark(fps)
            self._level_meter(level, "probes").mark(skips + hits + fps)
        with self._lock:
            self.prefetch["batches"] += 1
            self.prefetch["keys"] += keys
            self.prefetch["resolved"] += resolved
            self.bytes_read += bytes_read
            for level, skips, hits, fps in level_probes:
                lv = self.levels.setdefault(
                    level, {"probes": 0, "hits": 0, "false_positives": 0,
                            "bloom_skips": 0})
                lv["probes"] += skips + hits + fps
                lv["bloom_skips"] += skips
                lv["hits"] += hits
                lv["false_positives"] += fps
                self.bloom["checks"] += skips + hits + fps
                self.bloom["skips"] += skips

    def record_sql_fallback(self) -> None:
        self._m_sql_fallback.mark()
        with self._lock:
            self.sql_fallbacks += 1

    def set_index_shape(self, n_indexes: int, n_entries: int,
                        density_pct: float) -> None:
        self._g_indexes.set(n_indexes)
        self._g_entries.set(n_entries)
        self._g_density.set(round(density_pct, 3))

    def false_positive_rate(self) -> float:
        """False positives over bloom-passed probes (the filters' lie
        rate — ≈1% at 10 bits/key)."""
        with self._lock:
            fp = sum(lv["false_positives"] for lv in self.levels.values())
            passed = fp + sum(lv["hits"] for lv in self.levels.values())
        return fp / passed if passed else 0.0

    def to_json(self) -> dict:
        with self._lock:
            return {
                "reads": dict(self.reads),
                "levels": {str(k): dict(v)
                           for k, v in sorted(self.levels.items())},
                "bloom": dict(self.bloom),
                "index": {k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in self.index.items()},
                "prefetch": dict(self.prefetch),
                "bytes_read": self.bytes_read,
                "sql_fallbacks": self.sql_fallbacks,
            }


class BucketDB:
    """The bucket-backed read facade over one BucketManager's live
    bucket list; see module docstring. `lookup`/`prefetch_batch` return
    authoritative answers (found blob, or None = authoritatively
    absent) unless degraded by `bucketdb.read-fail`, in which case the
    caller (LedgerTxnRoot) falls back to SQL."""

    def __init__(self, manager, stats: Optional[BucketDbStats] = None,
                 faults=None, bits_per_key: int = 10,
                 eager_index: bool = True) -> None:
        self._manager = manager
        self.stats = stats if stats is not None else BucketDbStats()
        self.faults = faults
        self.bits_per_key = bits_per_key
        # eager_index=False (BUCKETDB_READS pinned off) skips indexing
        # at adopt time — nothing would ever read the indexes, and a
        # later direct lookup still builds lazily via index_for
        self.eager_index = eager_index
        self._lock = TrackedLock("bucketdb-indexes")
        self._indexes: Dict[bytes, BucketIndex] = {}
        self._fds: Dict[bytes, int] = {}
        # warn once per process on sidecar rebuilds, not once per bucket
        # (a corrupt bucket dir would otherwise spam the log at startup)
        self._warned_rebuild = False

    # -- index lifecycle -----------------------------------------------------
    def on_adopt(self, bucket) -> None:
        """Index an adopted bucket (close path for level-0 fresh
        buckets, merge workers for level merges): load the persisted
        sidecar if one matches, else build and persist."""
        if bucket.is_empty() or not self.eager_index:
            return
        self.index_for(bucket)

    def index_for(self, bucket) -> BucketIndex:
        h = bucket.get_hash()
        with self._lock:
            idx = self._indexes.get(h)
        if idx is not None:
            return idx
        idx = self._load_or_build(bucket)
        with self._lock:
            # first build wins on a race; both results are identical
            # (content-addressed input)
            existing = self._indexes.setdefault(h, idx)
        self._refresh_shape_gauges()
        return existing

    def _load_or_build(self, bucket) -> BucketIndex:
        h = bucket.get_hash()
        side = sidecar_path(bucket.path) if bucket.path else None
        if side is not None and os.path.exists(side):
            t0 = real_monotonic()
            try:
                if check_faults(self, "bucketdb.index-corrupt"):
                    raise IndexLoadError("injected index corruption")
                idx = BucketIndex.load(side, expected_hash=h)
                self.stats.record_load(real_monotonic() - t0)
                return idx
            except IndexLoadError as e:
                self.stats.record_load_failure()
                if not self._warned_rebuild:
                    self._warned_rebuild = True
                    log.warning("bucket index sidecar %s invalid (%s) — "
                                "rebuilding (further rebuilds logged at "
                                "debug)", side, e)
                else:
                    log.debug("bucket index sidecar %s invalid (%s) — "
                              "rebuilding", side, e)
        if not bucket.entries:
            # nonzero hash + no resident entries + no loadable sidecar:
            # building would produce an EMPTY index that silently
            # answers "absent" for every key in the bucket
            raise RuntimeError(
                "bucket %s has no resident entries and no valid sidecar "
                "to index from" % h.hex()[:8])
        t0 = real_monotonic()
        idx = BucketIndex.build(bucket, self.bits_per_key)
        self.stats.record_build(real_monotonic() - t0)
        if side is not None:
            try:
                idx.save(side)
            except OSError as e:
                log.warning("could not persist bucket index %s: %s",
                            side, e)
        return idx

    def invalidate(self, bucket_hash: bytes,
                   bucket_path: Optional[str] = None) -> None:
        """Drop a bucket's index + cached fd + sidecar — the GC hook
        (BucketManager.forget_unreferenced_buckets) and the
        replaced-after-catchup path."""
        with self._lock:
            self._indexes.pop(bucket_hash, None)
            fd = self._fds.pop(bucket_hash, None)
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass
        if bucket_path:
            side = sidecar_path(bucket_path)
            try:
                os.remove(side)
            except OSError:
                pass
        self._refresh_shape_gauges()

    def close(self) -> None:
        with self._lock:
            fds = list(self._fds.values())
            self._fds.clear()
            self._indexes.clear()
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass

    def _refresh_shape_gauges(self) -> None:
        with self._lock:
            idxs = list(self._indexes.values())
        n_entries = sum(len(i) for i in idxs)
        dens = [i.bloom.bit_density() for i in idxs if len(i)]
        avg = 100.0 * sum(dens) / len(dens) if dens else 0.0
        self.stats.set_index_shape(len(idxs), n_entries, avg)

    # -- reads ---------------------------------------------------------------
    def _live_buckets(self):
        """The live list newest-first: level 0 curr, level 0 snap,
        level 1 curr, ... (in-flight merges' INPUTS are exactly these
        curr/snap buckets, so the walk is complete). Liveness is by
        nonzero HASH, not entry presence: a file-backed bucket whose
        entries are not resident still serves reads via its index +
        pread."""
        zero = b"\x00" * 32
        for lev in self._manager.bucket_list.levels:
            if lev.curr.get_hash() != zero:
                yield lev.level, lev.curr
            if lev.snap.get_hash() != zero:
                yield lev.level, lev.snap

    def _read_blob(self, bucket, ordinal: int, offset: int,
                   length: int) -> Tuple[bytes, int]:
        """(LedgerEntry XDR, file bytes read). Disk-backed buckets pread
        from a cached fd — the offsets the sidecar committed to are
        exercised on every read; memory-only buckets slice the memoized
        framed record."""
        if bucket.path:
            fd = self._fd_for(bucket)
            if fd is not None:
                blob = os.pread(fd, length, offset)
                if len(blob) == length:
                    return blob, length
                log.warning("short bucket read %s@%d: %d < %d — falling "
                            "back to in-memory entries",
                            bucket.path, offset, len(blob), length)
        if not bucket.entries:
            # a file-backed bucket without resident entries has no
            # fallback — fail loudly rather than serve a wrong answer
            raise RuntimeError(
                "bucket %s unreadable at %d+%d and not memory-resident"
                % (bucket.get_hash().hex()[:8], offset, length))
        from .bucket import entry_record
        return entry_record(bucket.entries[ordinal])[8:], 0

    def _fd_for(self, bucket) -> Optional[int]:
        h = bucket.get_hash()
        with self._lock:
            fd = self._fds.get(h)
        if fd is not None:
            return fd
        try:
            fd = os.open(bucket.path, os.O_RDONLY)
        except OSError as e:
            log.warning("cannot open bucket file %s: %s", bucket.path, e)
            return None
        with self._lock:
            other = self._fds.setdefault(h, fd)
        if other is not fd and other != fd:
            os.close(fd)
            return other
        return fd

    def lookup(self, kb: bytes) -> Tuple[bool, Optional[bytes]]:
        """(served, blob): served=False degrades this read to the SQL
        fallback (`bucketdb.read-fail`); served=True answers
        authoritatively — blob None means absent (clean miss on every
        level, or a DEADENTRY tombstone short-circuit)."""
        if check_faults(self, "bucketdb.read-fail"):
            self.stats.record_sql_fallback()
            return False, None
        fp = key_fingerprint(kb)
        probes: List[Tuple[int, str]] = []
        for level, bucket in self._live_buckets():
            idx = self.index_for(bucket)
            if not idx.bloom.might_contain(fp):
                probes.append((level, "bloom-skip"))
                continue
            pos = idx.lookup(kb)
            if pos is None:
                probes.append((level, "false-positive"))
                continue
            ordinal, offset, length = pos
            probes.append((level, "hit"))
            if length == _TOMBSTONE_LEN:
                self.stats.record_read("tombstone", probes)
                return True, None
            blob, file_bytes = self._read_blob(bucket, ordinal, offset,
                                               length)
            self.stats.record_read("hit", probes, file_bytes)
            return True, blob
        self.stats.record_read("miss", probes)
        return True, None

    def prefetch_batch(self, kbs) -> Tuple[bool, Dict[bytes,
                                                      Optional[bytes]]]:
        """Resolve a whole txset's touched keys in ONE pass per level
        (newest-first): each level's bloom filters the still-pending
        keys, survivors bisect the level's indexes, hits and tombstones
        drop out of the pending set. Returns (served, {kb: blob|None});
        served=False degrades the whole batch to per-key SQL loads."""
        if check_faults(self, "bucketdb.read-fail"):
            self.stats.record_sql_fallback()
            return False, {}
        pending: Dict[bytes, Tuple[int, int]] = {
            kb: key_fingerprint(kb) for kb in kbs}
        out: Dict[bytes, Optional[bytes]] = {}
        requested = len(pending)
        resolved = 0
        file_bytes = 0
        level_probes: List[Tuple[int, int, int, int]] = []
        for level, bucket in self._live_buckets():
            if not pending:
                break
            idx = self.index_for(bucket)
            bloom = idx.bloom
            skips = hits = fps = 0
            for kb in list(pending):
                fp = pending[kb]
                if not bloom.might_contain(fp):
                    skips += 1
                    continue
                pos = idx.lookup(kb)
                if pos is None:
                    fps += 1
                    continue
                hits += 1
                ordinal, offset, length = pos
                if length == _TOMBSTONE_LEN:
                    out[kb] = None
                else:
                    blob, fb = self._read_blob(bucket, ordinal, offset,
                                               length)
                    out[kb] = blob
                    file_bytes += fb
                resolved += 1
                del pending[kb]
            level_probes.append((level, skips, hits, fps))
        for kb in pending:
            out[kb] = None     # clean miss on every level: absent
        self.stats.record_prefetch_batch(requested, resolved,
                                         level_probes, file_bytes)
        return True, out

    # -- exports -------------------------------------------------------------
    def to_json(self) -> dict:
        with self._lock:
            idxs = {h: i for h, i in self._indexes.items()}
        per_index = [
            {"bucket": h.hex()[:16], "entries": len(i),
             "bloom_bits": i.bloom.nbits, "bloom_k": i.bloom.k,
             "bloom_density_pct": round(100.0 * i.bloom.bit_density(), 3)}
            for h, i in sorted(idxs.items())]
        return {
            "indexes": len(idxs),
            "indexed_entries": sum(len(i) for i in idxs.values()),
            "bits_per_key": self.bits_per_key,
            "false_positive_rate": round(
                self.stats.false_positive_rate(), 6),
            "per_index": per_index[:32],
            **self.stats.to_json(),
        }
