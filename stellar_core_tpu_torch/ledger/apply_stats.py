"""ApplyStats: the close cockpit's shared aggregation.

Copied from `stellar_core_tpu/ledger/apply_stats.py` at commit bb973b8;
carry a fix in either copy to the other.

One instance per LedgerManager, shared by every layer that touches the
apply path — the apply engine (per-op count/ns table returned by
`_sctapply_torch.apply_close`), the Python op loop (per-op latency samples
from `TransactionFrame.apply`), the SQL root (`LedgerTxnRoot` point-lookup /
cache / prefetch / bucket-read telemetry) and the bucket layer (per-level
sizes, merge durations). The same aggregate objects feed:

- the metrics registry (`ledger.apply.*` / `bucket.*` names);
- the tracer: `close.apply` spans are tagged with the close's op mix and
  read-set stats so flight dumps carry close-shape forensics;
- `apply_breakdown()`: per-op ms + bail reasons + state-read stats whose
  parts sum to the measured apply wall (`chip_smoke.py` prints it).

Clocks: per-op and per-merge DURATIONS are real elapsed seconds via
util.timer.real_perf_counter/real_monotonic — an op apply or a bucket
merge takes real time even when the app clock is frozen — while meter
rates run on the injected app clock (`now_fn`), so runs under a
virtual clock stay deterministic. Recording happens on the main loop and
the bucket-merge worker pool; aggregate mutation is under `_lock`,
registry metric objects are individually thread-safe.

Why no histogram sample per engine op: the apply engine attributes with
one (count, ns) table per close — per-op latency HISTOGRAMS only get
samples on the Python path, where each op applies in its own nested txn.
Cumulative per-op counts and seconds cover both paths identically.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..util.metrics import MetricsRegistry
from ..util.threads import TrackedLock
from ..util.timer import real_monotonic
from ..xdr import OperationType

# OperationType value -> kebab-case metric segment ("manage-sell-offer").
# Bounded: the dynamic `ledger.apply.op.<type>.*` name space can never
# exceed the 14 wire op types (+ the distinct fee-bump/muxed tx meters).
OP_TYPE_NAMES: Dict[int, str] = {
    v: k.lower().replace("_", "-")
    for k, v in vars(OperationType).items()
    if isinstance(v, int) and not k.startswith("_") and k.isupper()
}


def op_type_name(op_type: int) -> str:
    return OP_TYPE_NAMES.get(op_type, "unknown-%d" % op_type)


def frame_traits(frame) -> tuple:
    """(is_fee_bump, touches_muxed) of one tx frame — the close
    cockpit's distinct fee-bump / muxed traffic counters. Muxed means a
    med25519 (sub-id-carrying) MuxedAccount anywhere an account is
    referenced: tx source, op sources, payment-family / account-merge
    destinations."""
    from ..xdr import CryptoKeyType, MuxedAccount
    mux = CryptoKeyType.KEY_TYPE_MUXED_ED25519
    fee_bump = hasattr(frame, "inner")
    tx = getattr(frame, "tx", None)
    if tx is None:
        tx = frame.inner.tx

    def _is_mux(acct) -> bool:
        return acct is not None and getattr(acct, "disc", None) == mux

    muxed = fee_bump and _is_mux(frame.fee_bump.feeSource)
    muxed = muxed or _is_mux(tx.sourceAccount)
    if not muxed:
        for op in tx.operations:
            if _is_mux(op.sourceAccount):
                muxed = True
                break
            body = op.body.value
            if isinstance(body, MuxedAccount):   # ACCOUNT_MERGE arm
                if _is_mux(body):
                    muxed = True
                    break
            elif _is_mux(getattr(body, "destination", None)):
                muxed = True
                break
    return fee_bump, muxed


def txset_prefetch_keys(frames) -> list:
    """The txset's statically-knowable touched keys, for bulk-warming
    the root entry cache before apply (reference LedgerManagerImpl::
    prefetchTxSourceIds + prefetchTransactionData): tx + op source
    accounts, create-account / payment / account-merge destinations, and
    the src/dest trustlines of credit-asset payments. Deduplicated in
    first-touch order."""
    from ..xdr import (
        Asset, AssetType, LedgerKey, MuxedAccount, OperationType,
    )
    keys: list = []
    seen: set = set()

    def add(key) -> None:
        kb = key.to_xdr()
        if kb not in seen:
            seen.add(kb)
            key.__dict__["_kb"] = kb   # the ledgertxn map key, pre-memoized
            keys.append(key)

    def add_acc(pk) -> None:
        if pk is not None:
            add(LedgerKey.account(pk))

    for frame in frames:
        if hasattr(frame, "inner"):          # fee bump: outer fee source
            add_acc(frame.fee_bump.feeSource.account_id)
            tx = frame.inner.tx
        else:
            tx = frame.tx
        add_acc(tx.sourceAccount.account_id)
        tx_src = tx.sourceAccount.account_id
        for op in tx.operations:
            src = (op.sourceAccount.account_id
                   if op.sourceAccount is not None else tx_src)
            add_acc(src)
            t = op.body.disc
            body = op.body.value
            if t == OperationType.CREATE_ACCOUNT:
                add_acc(body.destination)
            elif t == OperationType.PAYMENT:
                dest = body.destination.account_id
                add_acc(dest)
                if body.asset.disc != AssetType.ASSET_TYPE_NATIVE:
                    add(LedgerKey.trustline(src, body.asset))
                    add(LedgerKey.trustline(dest, body.asset))
            elif t == OperationType.ACCOUNT_MERGE and \
                    isinstance(body, MuxedAccount):
                add_acc(body.account_id)
    return keys


class ApplyStats:
    """Close-cockpit aggregation; see module docstring."""

    def __init__(self, metrics=None, tracer=None, now_fn=None) -> None:
        self._now = now_fn or real_monotonic
        # a private registry when none is injected keeps direct
        # constructions (tests, differential harnesses) app-registry-free
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(now_fn=self._now)
        self.tracer = tracer
        self._lock = TrackedLock("ledger.apply-stats")
        self.reset()
        # fixed-name registry metrics, created eagerly so an export
        # carries the full cockpit shape from the first read
        m = self.metrics
        self._t_wall = m.new_timer("ledger.apply.wall")
        self._h_read = m.new_histogram("ledger.apply.read-set")
        self._h_write = m.new_histogram("ledger.apply.write-set")
        self._h_pcov = m.new_histogram("ledger.apply.prefetch.coverage-pct")
        self._m_phit = m.new_meter("ledger.apply.prefetch.hit")
        self._m_pmiss = m.new_meter("ledger.apply.prefetch.miss")
        self._m_chit = m.new_meter("ledger.apply.state.cache-hit")
        self._m_cmiss = m.new_meter("ledger.apply.state.cache-miss")
        self._m_rows = m.new_meter("ledger.apply.state.bulk-scan-rows")
        # BucketDB routing: cache misses served from the
        # bucket list (never SQL), and the root entry cache's real-LRU
        # eviction count — silent coverage loss at 10^6 accounts is a
        # visible meter, not a mystery miss rate
        self._m_bucket_read = m.new_meter("ledger.apply.state.bucket-read")
        self._m_evict = m.new_meter("ledger.apply.entry-cache.evicted")
        self._m_feebump = m.new_meter("ledger.apply.tx.fee-bump")
        self._m_muxed = m.new_meter("ledger.apply.tx.muxed")
        self._h_merge = m.new_histogram("bucket.merge.seconds")
        # conflict-graph parallel close: per-close cluster
        # shape gauges + parallel/serial path meters
        self._g_cl_count = m.new_gauge("ledger.apply.cluster.count")
        self._g_cl_width = m.new_gauge("ledger.apply.cluster.width")
        self._g_cl_workers = m.new_gauge("ledger.apply.cluster.workers")
        self._m_cl_parallel = m.new_meter(
            "ledger.apply.cluster.parallel-close")
        self._m_cl_serial = m.new_meter("ledger.apply.cluster.serial-close")
        self._m_cl_degrade = m.new_meter("ledger.apply.cluster.degraded")
        # per-entry-type / per-op-type metrics, resolved once — the hot
        # read and apply loops must not pay a name format + registry
        # lookup per event (both name spaces are small and bounded)
        self._m_lookup: Dict[str, object] = {}
        self._m_op: Dict[str, object] = {}
        self._h_op: Dict[str, object] = {}
        self._g_level: Dict[int, object] = {}

    # -- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        """Zero the cumulative aggregates (registry metrics keep their
        monotonic histories — counters must never go backwards)."""
        with self._lock:
            self.ops: Dict[str, dict] = {}      # name -> {count, seconds}
            self.bails: Dict[str, int] = {}
            self.tx = {"total": 0, "fee_bump": 0, "muxed": 0}
            self.closes = {"native": 0, "python": 0}
            self.apply_wall_s = 0.0
            self.reads = {
                "lookups": {},          # entry type -> SQL point lookups
                "cache_hits": 0, "cache_misses": 0,
                "bucket_reads": 0,      # misses served by BucketDB
                "cache_evictions": 0,
                "bulk_scans": 0, "bulk_scan_rows": 0,
                "prefetch": {"calls": 0, "requested": 0, "cached": 0,
                             "hits": 0, "misses": 0},
            }
            self.buckets = {"levels": {}, "merges": 0, "merge_seconds": 0.0}
            self.clusters = {"parallel_closes": 0, "serial_closes": 0,
                             "degraded": 0, "last_count": 0,
                             "last_width": 0, "last_workers": 0,
                             "last_apply_ms": 0.0}
            self.last_close: Optional[dict] = None
            self._close = None

    # -- per-close bracketing ------------------------------------------------
    def begin_close(self, seq: int) -> None:
        """Open the per-close window; read counters recorded until
        end_close() are attributed to this close's blob + span tags."""
        with self._lock:
            self._close = {
                "seq": seq,
                # real stamp, NOT the app clock: abort_close() needs a
                # real elapsed even under a frozen virtual clock
                "t_real": real_monotonic(),
                "ops": {}, "path": None, "bail": None,
                "reads_base": self._reads_snapshot(),
            }

    def abort_close(self) -> Optional[dict]:
        """Seal the window of a close that RAISED (ledger_manager's
        close-exception handler): the real elapsed since begin_close()
        joins the cumulative apply wall so per-op seconds already
        recorded for the doomed close can't outgrow it — the
        apply_breakdown sum contract (other_ms >= 0) survives failed
        closes. Counts under path "failed"; no-op if the window was
        already sealed."""
        with self._lock:
            c = self._close
            if c is None:
                return None
            wall_s = real_monotonic() - c["t_real"]
        return self.end_close("failed", wall_s)

    def _reads_snapshot(self) -> dict:
        r = self.reads
        return {"lookups": dict(r["lookups"]),
                "cache_hits": r["cache_hits"],
                "cache_misses": r["cache_misses"],
                "bucket_reads": r["bucket_reads"],
                "bulk_scan_rows": r["bulk_scan_rows"]}

    def end_close(self, path: str, wall_s: float,
                  write_set: int = 0) -> Optional[dict]:
        """Seal the per-close window; returns the close blob (also kept
        as `last_close`) so the caller can tag its apply span."""
        if path != "failed":
            # a failed close's wall_s spans begin_close()→raise (which
            # may include post-apply work like bucket hashing) — it must
            # join the cumulative apply_wall_s for the sum contract, but
            # feeding it to the per-close apply-latency timer would
            # spike operator p95/p99 with non-apply time
            self._t_wall.update(wall_s)
            self._h_write.update(write_set)
        with self._lock:
            self.closes[path] = self.closes.get(path, 0) + 1
            self.apply_wall_s += wall_s
            c = self._close
            self._close = None
            if c is None:
                return None
            base = c["reads_base"]
            cur = self._reads_snapshot()
            lookups = {t: n - base["lookups"].get(t, 0)
                       for t, n in cur["lookups"].items()
                       if n - base["lookups"].get(t, 0)}
            bucket_reads = cur["bucket_reads"] - base["bucket_reads"]
            read_set = sum(lookups.values()) + bucket_reads + \
                (cur["cache_hits"] - base["cache_hits"])
            blob = {
                "seq": c["seq"], "path": path, "bail": c["bail"],
                "wall_ms": round(wall_s * 1e3, 3),
                "ops": {n: {"count": d["count"],
                            "ms": round(d["seconds"] * 1e3, 3)}
                        for n, d in c["ops"].items()},
                "reads": {
                    "lookups": lookups,
                    "cache_hits": cur["cache_hits"] - base["cache_hits"],
                    "cache_misses":
                        cur["cache_misses"] - base["cache_misses"],
                    "bucket_reads": bucket_reads,
                    "bulk_scan_rows":
                        cur["bulk_scan_rows"] - base["bulk_scan_rows"],
                    "read_set": read_set,
                    "write_set": write_set,
                },
            }
            self.last_close = blob
        if path != "failed":
            # a truncated close's partial read count is not a per-close
            # read-set sample (same skew rationale as the wall timer)
            self._h_read.update(blob["reads"]["read_set"])
        return blob

    # -- per-op attribution --------------------------------------------------
    def record_op(self, name: str, count: int = 1,
                  seconds: Optional[float] = None,
                  sample: bool = False) -> None:
        """`count` applications of op type `name` costing `seconds`
        total. `sample=True` additionally feeds the per-op latency
        histogram (the Python path, where each op is individually
        timed; the native table is per-close totals)."""
        meter = self._m_op.get(name)
        if meter is None:
            meter = self.metrics.new_meter("ledger.apply.op.%s.count" % name)
            self._m_op[name] = meter
        meter.mark(count)
        if seconds is not None and sample:
            hist = self._h_op.get(name)
            if hist is None:
                hist = self.metrics.new_histogram(
                    "ledger.apply.op.%s.seconds" % name)
                self._h_op[name] = hist
            hist.update(seconds)
        with self._lock:
            d = self.ops.setdefault(name, {"count": 0, "seconds": 0.0})
            d["count"] += count
            if seconds is not None:
                d["seconds"] += seconds
            if self._close is not None:
                c = self._close["ops"].setdefault(
                    name, {"count": 0, "seconds": 0.0})
                c["count"] += count
                if seconds is not None:
                    c["seconds"] += seconds

    def record_native_op_table(self, table) -> None:
        """The native engine's per-close {op_type: (count, ns)} table."""
        for op_type, (count, ns) in table.items():
            self.record_op(op_type_name(int(op_type)), count=int(count),
                           seconds=ns / 1e9)

    def record_tx(self, fee_bump: bool, muxed: bool) -> None:
        self.record_tx_counts(1, int(fee_bump), int(muxed))

    def record_tx_counts(self, total: int, fee_bump: int,
                         muxed: int) -> None:
        """Batched tx-mix counters: one lock acquisition per txset, not
        per tx (close_ledger classifies the whole set up front)."""
        with self._lock:
            self.tx["total"] += total
            self.tx["fee_bump"] += fee_bump
            self.tx["muxed"] += muxed
        if fee_bump:
            self._m_feebump.mark(fee_bump)
        if muxed:
            self._m_muxed.mark(muxed)

    def record_clusters(self, count: int, width: int, workers: int,
                        parallel: bool, apply_ns: int = 0) -> None:
        """One native close's conflict-graph shape: cluster count, max
        cluster width (txs), worker count, whether the engine actually
        ran the clusters concurrently, and the engine's tx-execution
        wall (the phase the parallelism accelerates — parse/verify/
        fees/emission excluded)."""
        self._g_cl_count.set(count)
        self._g_cl_width.set(width)
        self._g_cl_workers.set(workers)
        (self._m_cl_parallel if parallel else self._m_cl_serial).mark()
        with self._lock:
            key = "parallel_closes" if parallel else "serial_closes"
            self.clusters[key] += 1
            self.clusters["last_count"] = count
            self.clusters["last_width"] = width
            self.clusters["last_workers"] = workers
            self.clusters["last_apply_ms"] = round(apply_ns / 1e6, 3)
            if self._close is not None:
                self._close["clusters"] = {
                    "count": count, "width": width, "workers": workers,
                    "parallel": parallel,
                    "apply_ms": round(apply_ns / 1e6, 3)}

    def record_cluster_degrade(self) -> None:
        """apply.cluster-fail fired: this close runs serial instead of
        parallel (the fault's graceful-degradation contract)."""
        self._m_cl_degrade.mark()
        with self._lock:
            self.clusters["degraded"] += 1

    # -- native-bail forensics -----------------------------------------------
    def record_bail(self, reason: str) -> None:
        """One native_apply_txset ineligibility/bailout, classified
        (ledger/native_apply.py BAIL_* reasons + the engine's own)."""
        self.metrics.new_meter("ledger.apply.native-bail.%s" % reason).mark()
        with self._lock:
            self.bails[reason] = self.bails.get(reason, 0) + 1
            if self._close is not None:
                self._close["bail"] = reason
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant("ledger.apply.native-bail", cat="ledger",
                                reason=reason)

    # -- state-read telemetry (LedgerTxnRoot hooks) --------------------------
    def _lookup_meter(self, entry_type: str):
        m = self._m_lookup.get(entry_type)
        if m is None:
            m = self.metrics.new_meter(
                "ledger.apply.state.lookup.%s" % entry_type)
            self._m_lookup[entry_type] = m
        return m

    def record_read(self, hit: bool, prefetched: bool,
                    entry_type: Optional[str] = None,
                    source: str = "sql") -> None:
        """One root entry read, folded into a single lock acquisition —
        this hook sits inside the exact path the cockpit measures.
        Covers the cache hit/miss counters, the getPrefetchHitRate-parity
        prefetch hit/miss (a warm cache hit on a never-prefetched key
        records neither; every miss counts as a prefetch miss), and — on
        a miss — the point lookup by entry type, attributed to its
        serving `source`: "sql" feeds the per-type SQL lookup meters the
        zero-SQL read path asserts on; "bucket" (BucketDB-served)
        feeds the separate bucket-read counter, so routing state reads
        off SQL visibly DRAINS `ledger.apply.state.lookup.*` instead of
        inflating it."""
        if hit:
            self._m_chit.mark()
            if prefetched:
                self._m_phit.mark()
            with self._lock:
                self.reads["cache_hits"] += 1
                if prefetched:
                    self.reads["prefetch"]["hits"] += 1
        else:
            self._m_cmiss.mark()
            self._m_pmiss.mark()
            if entry_type is not None and source == "sql":
                self._lookup_meter(entry_type).mark()
            elif source == "bucket":
                self._m_bucket_read.mark()
            with self._lock:
                self.reads["cache_misses"] += 1
                self.reads["prefetch"]["misses"] += 1
                if source == "bucket":
                    self.reads["bucket_reads"] += 1
                elif entry_type is not None:
                    lk = self.reads["lookups"]
                    lk[entry_type] = lk.get(entry_type, 0) + 1

    def record_cache_evictions(self, n: int = 1) -> None:
        """Root entry-cache LRU evictions (the bounded-cache coverage
        signal made observable)."""
        self._m_evict.mark(n)
        with self._lock:
            self.reads["cache_evictions"] += n

    def record_bulk_scan(self, rows: int) -> None:
        self._m_rows.mark(rows)
        with self._lock:
            self.reads["bulk_scans"] += 1
            self.reads["bulk_scan_rows"] += rows

    def record_prefetch(self, requested: int, cached: int,
                        lookups: Optional[Dict[str, int]] = None,
                        bucket_loads: int = 0) -> None:
        """One prefetch() pass: `requested` keys asked for, `cached`
        resident in the entry cache afterwards (already-warm + newly
        loaded). Coverage = cached/requested — the per-txset number the
        bucket-read path gates on.
        `lookups` carries the pass's SQL point loads by entry type;
        `bucket_loads` counts keys the BucketDB batched pass resolved
        instead — both batched into this one acquisition."""
        cov = 100.0 * cached / requested if requested else 100.0
        self._h_pcov.update(cov)
        if lookups:
            for entry_type, n in lookups.items():
                self._lookup_meter(entry_type).mark(n)
        if bucket_loads:
            self._m_bucket_read.mark(bucket_loads)
        with self._lock:
            p = self.reads["prefetch"]
            p["calls"] += 1
            p["requested"] += requested
            p["cached"] += cached
            self.reads["bucket_reads"] += bucket_loads
            if lookups:
                lk = self.reads["lookups"]
                for entry_type, n in lookups.items():
                    lk[entry_type] = lk.get(entry_type, 0) + n

    def prefetch_totals(self) -> dict:
        """Cumulative prefetch aggregates (calls/requested/cached/
        hits/misses) — delta two snapshots to attribute one pass."""
        with self._lock:
            return dict(self.reads["prefetch"])

    def prefetch_hit_rate(self) -> float:
        """reference getPrefetchHitRate (LedgerTxn.cpp): root reads
        served from a prefetched key over those plus reads that fell
        through to SQL (warm cache hits on never-prefetched keys are
        not in the denominator)."""
        with self._lock:
            return self._hit_rate_locked()

    # -- bucket layer --------------------------------------------------------
    def record_merge(self, level: int, seconds: float,
                     out_entries: int) -> None:
        """One completed bucket merge (runs on the merge worker pool)."""
        self._h_merge.update(seconds)
        self.metrics.new_meter("bucket.merge.level.%d" % level).mark()
        with self._lock:
            self.buckets["merges"] += 1
            self.buckets["merge_seconds"] += seconds
            lv = self.buckets["levels"].setdefault(
                level, {"merges": 0, "merge_seconds": 0.0, "entries": 0})
            lv["merges"] += 1
            lv["merge_seconds"] += seconds
            lv["last_out_entries"] = out_entries

    def record_level_sizes(self, sizes) -> None:
        """Per-level curr+snap entry counts at a close (bucket_manager
        snapshot hook); levels are bounded at K_NUM_LEVELS=11. Runs every
        close — gauges are memoized and the lock taken once."""
        sizes = list(sizes)
        for level, n in sizes:
            g = self._g_level.get(level)
            if g is None:
                g = self.metrics.new_gauge("bucket.level.%d.entries" % level)
                self._g_level[level] = g
            g.set(n)
        with self._lock:
            for level, n in sizes:
                lv = self.buckets["levels"].setdefault(
                    level, {"merges": 0, "merge_seconds": 0.0, "entries": 0})
                lv["entries"] = n

    # -- exports -------------------------------------------------------------
    def to_json(self) -> dict:
        """The cockpit blob (the reference's admin `applystats`)."""
        with self._lock:
            return {
                "closes": dict(self.closes),
                "apply_wall_s": round(self.apply_wall_s, 6),
                "ops": {n: {"count": d["count"],
                            "ms": round(d["seconds"] * 1e3, 3)}
                        for n, d in sorted(self.ops.items())},
                "tx": dict(self.tx),
                "native_bails": dict(sorted(self.bails.items())),
                "state_reads": {
                    "lookups": dict(sorted(
                        self.reads["lookups"].items())),
                    "cache_hits": self.reads["cache_hits"],
                    "cache_misses": self.reads["cache_misses"],
                    "bucket_reads": self.reads["bucket_reads"],
                    "cache_evictions": self.reads["cache_evictions"],
                    "bulk_scans": self.reads["bulk_scans"],
                    "bulk_scan_rows": self.reads["bulk_scan_rows"],
                    "prefetch": dict(self.reads["prefetch"]),
                },
                "prefetch_hit_rate": round(self._hit_rate_locked(), 4),
                "buckets": {
                    "merges": self.buckets["merges"],
                    "merge_seconds":
                        round(self.buckets["merge_seconds"], 6),
                    "levels": {str(k): dict(v) for k, v in sorted(
                        self.buckets["levels"].items())},
                },
                "clusters": dict(self.clusters),
                "last_close": self.last_close,
            }

    def _hit_rate_locked(self) -> float:
        p = self.reads["prefetch"]
        total = p["hits"] + p["misses"]
        return p["hits"] / total if total else 0.0

    def apply_breakdown(self) -> dict:
        """The replay block: per-op ms + bail reasons +
        state-read stats whose parts sum to the measured apply wall —
        `other_ms` is the residual (fees, signature checks, parsing,
        delta serialization) so sum(per_op_ms) + other_ms ==
        apply_wall_s * 1000 by construction."""
        with self._lock:
            per_op_ms = {n: round(d["seconds"] * 1e3, 3)
                         for n, d in sorted(self.ops.items())}
            op_counts = {n: d["count"]
                         for n, d in sorted(self.ops.items())}
            wall_ms = self.apply_wall_s * 1e3
            other = wall_ms - sum(per_op_ms.values())
            return {
                "apply_wall_s": round(self.apply_wall_s, 6),
                "closes": dict(self.closes),
                "per_op_ms": per_op_ms,
                "op_counts": op_counts,
                "other_ms": round(other, 6),
                "bails": dict(sorted(self.bails.items())),
                "clusters": dict(self.clusters),
                "tx": dict(self.tx),
                "state_reads": {
                    "lookups": dict(sorted(
                        self.reads["lookups"].items())),
                    "cache_hits": self.reads["cache_hits"],
                    "cache_misses": self.reads["cache_misses"],
                    "bucket_reads": self.reads["bucket_reads"],
                    "cache_evictions": self.reads["cache_evictions"],
                    "bulk_scan_rows": self.reads["bulk_scan_rows"],
                    "prefetch": dict(self.reads["prefetch"]),
                    "prefetch_hit_rate": round(self._hit_rate_locked(), 4),
                },
            }
