"""BatchSigVerifier: the batch boundary every signature check goes through.

Port of `stellar_core_tpu/crypto/batch_verifier.py` at commit 02ed56d
(`VerifierStats`, `warmup_plan`, `VerifyFuture`, `BatchSigVerifier`,
`CpuSigVerifier`, `TpuSigVerifier` as `CudaSigVerifier`, `_StagingJob`,
`DeviceFleetHealth`, `CircuitBreaker`) and at commit a29fd1b (the stats'
flight recorder and queue series, `ResilientBatchVerifier`,
`ThreadedBatchVerifier`, `make_verifier`):

    enqueue(key32, sig, msg) -> VerifyFuture   (accumulate)
    flush()                                    (dispatch one device batch)
    verify_many(triples) -> [bool]             (whole-ledger/checkpoint drain)
    prewarm_many(triples) -> [bool]            (drain that seeds the cache)

Backends:
- CpuSigVerifier — synchronous CPU verify (crypto/keys.py).
- CudaSigVerifier — the counterpart of the reference's TpuSigVerifier, a
  verify fleet (parallel/mesh.py): a drain is cut into chunks of the
  largest bucket, each padded to a bucket of a fixed ladder; a chunk of
  at least SHARD_MIN_BATCH signatures is sharded over every healthy
  member (one launch of the CUDA verify kernel per member, on its own
  stream, then a gather), a smaller one runs on the first healthy member.
  While the fleet verifies chunk K, the `crypto.verify-staging` worker
  prepares chunk K+1 and copies it from pinned host memory on each
  member's staging stream (the double buffer). Each member has a circuit
  breaker (DeviceFleetHealth): a sick member drops out and the drain goes
  on with the others. Correctness contract: identical accept/reject
  decisions to CpuSigVerifier (RFC 8032 cofactorless).

Operator layers, stacked by make_verifier:
- ResilientBatchVerifier — a whole-backend circuit breaker over a primary
  backend: N consecutive failed drains trip it open for a cooldown, and a
  half-open probe re-closes it (meters, flight dump). Over the C verifier
  ("cpu-resilient") a fallback CpuSigVerifier serves the drains the
  primary fails or the open breaker bypasses (meter
  `crypto.verify.fallback-drain`). Over the fleet ("cuda-resilient") there
  is no fallback: a failed drain raises to the caller, and while the
  breaker is open every drain is refused with BreakerOpenError.
- ThreadedBatchVerifier — dispatch on a `crypto.verify-dispatch` worker,
  futures completed on the app clock's main loop (`clock.post_to_main`);
  a batch whose dispatch raises goes back to the head of the queue for
  the next flush.

Work that was sent to the card never moves to the CPU: not in the kernel
wrapper, not in CudaSigVerifier, not in the layers above it. A
CudaSigVerifier dispatch that raises propagates to its caller (a flush
puts its batch back in the queue first, so no future is lost), after
every participating member's breaker has counted it. When every member's
breaker is open the route uses every member. A stack with a member on a
card builds the kernel when it is constructed, so a failed build raises
there.

Observability, as in the reference: one VerifierStats per make_verifier()
stack (`verifier.*` metrics: per-bucket, per-member, staging and drain
series), tracer spans and instants (util/tracing.py) and the fault points
`verify.device-lost` and `verify.staging-stall` (util/faults.py).

Threads: dispatch runs on the caller's thread (the `crypto.verify-dispatch`
worker under ThreadedBatchVerifier) and is the only one that launches
during a drain; the staging worker prepares and copies but never launches
(its C host prep releases the interpreter lock, so it overlaps the
dispatch thread); warmup (`crypto.verify-warmup`) launches zeros on each
planned bucket. Event stamps read the injected app clock (`now_fn`); staging and
warmup durations read util.timer.real_monotonic (real elapsed time).

The global verify-result cache (crypto/keys.py) sits in front of every
backend; cache hits never enqueue.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .. import _build
from ..ops import ed25519 as _e
from ..parallel.mesh import (launch_shards, make_fleet, pad_batch_to,
                             place_shards)
from ..util.metrics import MetricsRegistry
from ..util.threads import TrackedLock, spawn_worker
from ..util.timer import real_monotonic
from ..util.tracing import tracer_instant, tracer_span
from . import keys as _keys

log = logging.getLogger(__name__)

Triple = Tuple[bytes, bytes, bytes]  # (key32, sig, msg)


class VerifierStats:
    """Cockpit aggregation for the batch-verify boundary.

    One instance per make_verifier() stack, shared by its layers. The same
    aggregates feed `to_json` (per-bucket occupancy / pad-waste
    histograms, per-member rows, staging, warmup, build-cache status,
    queue depth), the metrics registry (`verifier.*` names, identical to
    the reference's) and the tracer (`verifier.warmup.*` and
    `verifier.device.*` instants).

    Clocks: event stamps (`t` fields) read the injected app clock
    (`now_fn`); warmup and staging durations are real elapsed seconds.
    Aggregate mutation is under `_lock`; registry metric objects are
    individually thread-safe.

    `flight_recorder`, where given, is any object with
    `dump(reason, extra=...)`: a member's breaker trip, a failed warmup
    and an unusable build directory each leave one dump."""

    def __init__(self, metrics=None, tracer=None, now_fn=None,
                 flight_recorder=None) -> None:
        self._now = now_fn or real_monotonic
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(now_fn=self._now)
        self.tracer = tracer
        self.flight_recorder = flight_recorder
        self._lock = TrackedLock("crypto.verifier-stats")
        self.backends: dict = {}      # name -> {drains, sigs, pad_total}
        self.buckets: dict = {}       # bucket -> counts + histograms
        # per-member attribution: member index -> {drains, sigs,
        # pad_total, inflight} for every padded dispatch it joined
        self.devices: dict = {}
        # non-bucketed (CPU-path) drain sizes, power-of-two quantized
        self.drain_sizes: dict = {}   # backend -> {quantized_n: drains}
        # double-buffer staging aggregate
        self.staging = {"chunks": 0, "staged_s": 0.0, "overlap_s": 0.0,
                        "last_overlap_pct": None, "stalls": 0}
        self.queue = {"depth": 0, "inflight": 0,
                      "wait_last_mean_ms": None, "wait_last_max_ms": None}
        self.warmup = {"state": "idle", "planned": [], "source": None,
                       "begun_t": None, "done_t": None, "error": None,
                       "buckets": {}}
        # the kernel build directory stands where the reference's XLA
        # compile cache stood
        self.compile_cache = {"enabled": None, "dir": None, "hits": 0,
                              "misses": 0, "unknown": 0, "error": None}
        # fixed-name registry metrics, created eagerly so the export
        # carries the full cockpit shape from the first scrape
        m = self.metrics
        self._h_batch = m.new_histogram("verifier.drain.batch-size")
        self._h_pad = m.new_histogram("verifier.drain.pad-waste")
        self._h_occ = m.new_histogram("verifier.drain.occupancy-pct")
        self._h_splits = m.new_histogram("verifier.drain.splits")
        self._h_wsec = m.new_histogram("verifier.warmup.bucket-seconds")
        self._t_wait = m.new_timer("verifier.queue.wait")
        self._g_depth = m.new_gauge("verifier.queue.depth")
        self._g_inflight = m.new_gauge("verifier.queue.inflight")
        self._g_overlap = m.new_gauge("verifier.staging.overlap-pct")
        self._g_wstate = m.new_gauge("verifier.warmup.state")
        self._g_wdone = m.new_gauge("verifier.warmup.buckets-done")
        self._g_wsource = m.new_gauge("verifier.warmup.source")
        self._g_cc = m.new_gauge("verifier.compile-cache.enabled")
        self._c_hit = m.new_counter("verifier.compile-cache.hit")
        self._c_miss = m.new_counter("verifier.compile-cache.miss")

    # -- drains --------------------------------------------------------------
    def record_drain(self, backend: str, n: int, pad: int = 0,
                     splits: int = 1, bucketed: bool = False) -> None:
        """One verify_many drain, attributed to the backend that served
        it. `pad` is the total padding-lane waste. `bucketed=True` means
        the drain's traffic already landed in the per-bucket dispatch
        stats; unbucketed drains also feed `drain_sizes`."""
        occ = 100.0 * n / (n + pad) if (n + pad) else 100.0
        with self._lock:
            d = self.backends.setdefault(
                backend, {"drains": 0, "sigs": 0, "pad_total": 0})
            d["drains"] += 1
            d["sigs"] += n
            d["pad_total"] += pad
            if not bucketed and n > 0:
                q = 1 << (n - 1).bit_length()   # next power of two
                sizes = self.drain_sizes.setdefault(backend, {})
                sizes[q] = sizes.get(q, 0) + 1
        self._h_batch.update(n)
        self._h_pad.update(pad)
        self._h_occ.update(occ)
        self._h_splits.update(splits)
        self.metrics.new_meter("verifier.drains.%s" % backend).mark()

    def record_bucket_dispatch(self, bucket: int, n: int,
                               pad: int) -> None:
        """One padded device dispatch into a ladder bucket (buckets come
        from CudaSigVerifier.BUCKETS, so the `verifier.bucket.<b>.*` name
        space stays bounded)."""
        occ = 100.0 * n / bucket if bucket else 100.0
        with self._lock:
            b = self.buckets.get(bucket)
            if b is None:
                b = self.buckets[bucket] = {
                    "drains": 0, "sigs": 0, "pad_total": 0,
                    "_occ": self.metrics.new_histogram(
                        "verifier.bucket.%d.occupancy-pct" % bucket),
                    "_pad": self.metrics.new_histogram(
                        "verifier.bucket.%d.pad-waste" % bucket),
                    "_m": self.metrics.new_meter(
                        "verifier.bucket.%d.drains" % bucket)}
            b["drains"] += 1
            b["sigs"] += n
            b["pad_total"] += pad
        b["_occ"].update(occ)
        b["_pad"].update(pad)
        b["_m"].mark()

    # -- fleet: per-member attribution ---------------------------------------
    def record_device_dispatch(self, idx: int, n: int, pad: int) -> None:
        """One member's share of a padded dispatch (its lanes of a
        sharded chunk, or the whole bucket of a single-member one)."""
        with self._lock:
            d = self.devices.setdefault(
                idx, {"drains": 0, "sigs": 0, "pad_total": 0,
                      "inflight": 0})
            d["drains"] += 1
            d["sigs"] += n
            d["pad_total"] += pad
        self.metrics.new_meter("verifier.device.%d.drains" % idx).mark()

    def set_device_inflight(self, idx: int, inflight: bool) -> None:
        with self._lock:
            d = self.devices.setdefault(
                idx, {"drains": 0, "sigs": 0, "pad_total": 0,
                      "inflight": 0})
            d["inflight"] = int(inflight)
        self.metrics.new_gauge(
            "verifier.device.%d.inflight" % idx).set(int(inflight))

    def set_device_breaker(self, idx: int, code: int) -> None:
        self.metrics.new_gauge("verifier.device.%d.breaker" % idx).set(code)

    def device_trip(self, idx: int, breaker_json: dict) -> None:
        self.metrics.new_meter("verifier.device.trip").mark()
        tracer_instant(self.tracer, "verifier.device.trip", cat="crypto",
                       device=idx)
        if self.flight_recorder is not None:
            self.flight_recorder.dump(
                "verify-device-trip",
                extra={"device": idx, "breaker": breaker_json})

    def device_recover(self, idx: int) -> None:
        self.metrics.new_meter("verifier.device.recover").mark()
        tracer_instant(self.tracer, "verifier.device.recover",
                       cat="crypto", device=idx)

    # -- fleet: double-buffer staging ----------------------------------------
    def record_staging(self, staged_s: float, overlap_s: float,
                       chunks: int) -> None:
        """One drain's staging totals: `staged_s` of host prep + copies
        ran on the staging worker, `overlap_s` of it while the fleet ran
        the previous chunk. Near 100 % overlap means the card never waits
        on host marshalling between chunks."""
        pct = round(100.0 * overlap_s / staged_s, 1) if staged_s > 0 \
            else 100.0
        with self._lock:
            s = self.staging
            s["chunks"] += chunks
            s["staged_s"] = round(s["staged_s"] + staged_s, 6)
            s["overlap_s"] = round(s["overlap_s"] + overlap_s, 6)
            s["last_overlap_pct"] = pct
        self._g_overlap.set(pct)

    def record_staging_stall(self) -> None:
        """The staging worker failed (or verify.staging-stall fired): the
        chunk was re-staged on the dispatch thread."""
        with self._lock:
            self.staging["stalls"] += 1
        self.metrics.new_meter("verifier.staging.stall").mark()
        tracer_instant(self.tracer, "verifier.staging.stall", cat="crypto")

    # -- cockpit-driven bucket selection -------------------------------------
    def bucket_traffic(self, candidates) -> dict:
        """Observed drain traffic mapped onto a candidate bucket ladder:
        per-bucket device dispatch counts plus every non-bucketed drain
        size mapped to the smallest candidate that holds it."""
        cands = sorted(candidates)

        def fit(n: int) -> int:
            for c in cands:
                if n <= c:
                    return c
            return cands[-1]

        out: dict = {}
        with self._lock:
            for b, d in self.buckets.items():
                out[fit(b)] = out.get(fit(b), 0) + d["drains"]
            for sizes in self.drain_sizes.values():
                for n, drains in sizes.items():
                    out[fit(n)] = out.get(fit(n), 0) + drains
        return out

    def bucket_occupancy_p50(self) -> dict:
        """Median occupancy-% per device bucket (None until sampled)."""
        out = {}
        with self._lock:
            for b, d in self.buckets.items():
                snap = d["_occ"].snapshot()
                out[b] = snap["median"] if snap["count"] else None
        return out

    # -- queue ---------------------------------------------------------------
    def set_queue_depth(self, depth: int) -> None:
        self.queue["depth"] = depth
        self._g_depth.set(depth)

    def set_inflight(self, inflight: bool) -> None:
        self.queue["inflight"] = int(inflight)
        self._g_inflight.set(int(inflight))

    def record_queue_wait(self, mean_s: float, max_s: float) -> None:
        """One async batch's enqueue-to-dispatch wait (app clock)."""
        self.queue["wait_last_mean_ms"] = round(mean_s * 1e3, 3)
        self.queue["wait_last_max_ms"] = round(max_s * 1e3, 3)
        self._t_wait.update(mean_s)

    # -- build cache + warmup ------------------------------------------------
    def compile_cache_enabled(self, path: str) -> None:
        self.compile_cache.update(
            {"enabled": True, "dir": path, "error": None})
        self._g_cc.set(1)

    def compile_cache_error(self, err: str) -> None:
        """The build directory is unusable: a meter and a tracer instant,
        so a node paying a cold build on every restart is visible."""
        self.compile_cache.update({"enabled": False, "error": err})
        self._g_cc.set(0)
        self.metrics.new_meter("verifier.compile-cache.unavailable").mark()
        tracer_instant(self.tracer, "verifier.compile-cache.unavailable",
                       cat="crypto", error=err)
        if self.flight_recorder is not None:
            self.flight_recorder.dump("compile-cache-unavailable",
                                      extra={"error": err})

    WARMUP_STATE_CODE = {"idle": 0, "running": 1, "done": 2, "failed": 3}
    # where the warm-start bucket set came from: the default ladder, or
    # the cockpit-derived plan persisted beside the kernel libraries
    WARMUP_SOURCE_CODE = {"default": 0, "cockpit": 1}

    def warmup_begin(self, buckets, source: str = "default") -> None:
        with self._lock:
            self.warmup.update({"state": "running", "begun_t": self._now(),
                                "done_t": None, "error": None,
                                "source": source,
                                "planned": list(buckets)})
        self._g_wstate.set(self.WARMUP_STATE_CODE["running"])
        self._g_wsource.set(self.WARMUP_SOURCE_CODE.get(source, 0))
        tracer_instant(self.tracer, "verifier.warmup.begin", cat="crypto",
                       buckets=list(buckets), source=source)

    def warmup_bucket_done(self, bucket: int, seconds: float,
                           cache_hit) -> None:
        """One bucket warmed. `cache_hit` is True when the kernel's
        library was already built, False when this bucket built it, None
        where there is nothing to build (a CPU fleet)."""
        cache = ("hit" if cache_hit is True else
                 "miss" if cache_hit is False else "unknown")
        with self._lock:
            self.warmup["buckets"][str(bucket)] = {
                "seconds": round(seconds, 3), "cache": cache,
                "t": self._now()}
            done = len(self.warmup["buckets"])
            self.compile_cache[
                {"hit": "hits", "miss": "misses",
                 "unknown": "unknown"}[cache]] += 1
        self._h_wsec.update(seconds)
        self._g_wdone.set(done)
        if cache_hit is True:
            self._c_hit.inc()
        elif cache_hit is False:
            self._c_miss.inc()
        tracer_instant(self.tracer, "verifier.warmup.bucket", cat="crypto",
                       bucket=bucket, seconds=round(seconds, 3),
                       cache=cache)

    def warmup_done(self) -> None:
        with self._lock:
            self.warmup.update({"state": "done", "done_t": self._now()})
            total = sum(b["seconds"]
                        for b in self.warmup["buckets"].values())
            n = len(self.warmup["buckets"])
        self._g_wstate.set(self.WARMUP_STATE_CODE["done"])
        tracer_instant(self.tracer, "verifier.warmup.end", cat="crypto",
                       buckets=n, total_s=round(total, 3))

    def warmup_failed(self, err: str) -> None:
        with self._lock:
            self.warmup.update({"state": "failed", "done_t": self._now(),
                                "error": err})
        self._g_wstate.set(self.WARMUP_STATE_CODE["failed"])
        self.metrics.new_meter("verifier.warmup.failure").mark()
        tracer_instant(self.tracer, "verifier.warmup.failed", cat="crypto",
                       error=err)
        if self.flight_recorder is not None:
            self.flight_recorder.dump(
                "verify-warmup-failed",
                extra={"error": err, "warmup": self.warmup_json()})

    # -- export --------------------------------------------------------------
    def warmup_json(self) -> dict:
        with self._lock:
            w = dict(self.warmup)
            w["buckets"] = {k: dict(v)
                            for k, v in self.warmup["buckets"].items()}
        return w

    def to_json(self) -> dict:
        with self._lock:
            backends = {k: dict(v) for k, v in self.backends.items()}
            buckets = {
                str(b): {"drains": d["drains"], "sigs": d["sigs"],
                         "pad_waste_total": d["pad_total"],
                         "occupancy_pct": d["_occ"].snapshot(),
                         "pad_waste": d["_pad"].snapshot()}
                for b, d in sorted(self.buckets.items())}
            devices = {str(i): dict(d)
                       for i, d in sorted(self.devices.items())}
            staging = dict(self.staging)
            queue = dict(self.queue)
            cc = dict(self.compile_cache)
        return {
            "drains": {"by_backend": backends,
                       "batch_size": self._h_batch.snapshot(),
                       "pad_waste": self._h_pad.snapshot(),
                       "occupancy_pct": self._h_occ.snapshot(),
                       "splits": self._h_splits.snapshot()},
            "buckets": buckets,
            "devices": devices,
            "staging": staging,
            "warmup": self.warmup_json(),
            "compile_cache": cc,
            "queue": queue,
        }


def warmup_plan(stats, candidates):
    """Cockpit-driven warm-start bucket selection, derived from the
    `verifier.bucket.<b>.drains` / occupancy histograms (CPU drains
    included via `drain_sizes`).

    Rules, in order:
    - only candidate shapes with observed traffic are warmed, hottest
      (most drains) first;
    - a device bucket whose median occupancy is below 50 % mostly pays
      padding: the next smaller candidate is appended too;
    - no cockpit evidence (stats=None, or no drains) falls back to the
      full candidate ladder.

    Returns (buckets, info) where info carries `source`
    ("cockpit"/"default") and the evidence."""
    cands = sorted(candidates)
    if stats is None:
        return list(cands), {"source": "default",
                             "reason": "no cockpit stats"}
    traffic = stats.bucket_traffic(cands)
    if not traffic:
        return list(cands), {"source": "default",
                             "reason": "no recorded drains"}
    chosen = sorted(traffic, key=lambda b: (-traffic[b], b))
    extra = []
    for b, occ_p50 in sorted(stats.bucket_occupancy_p50().items()):
        if occ_p50 is None or occ_p50 >= 50.0 or b not in cands:
            continue
        i = cands.index(b)
        if i > 0 and cands[i - 1] not in chosen and \
                cands[i - 1] not in extra:
            extra.append(cands[i - 1])
    return chosen + extra, {"source": "cockpit", "traffic": traffic,
                            "low_occupancy_extra": extra}


class VerifyFuture:
    """Completion handle for one enqueued verify."""

    __slots__ = ("_done", "_result", "_callbacks")

    def __init__(self) -> None:
        self._done = False
        self._result = False
        self._callbacks: List[Callable[[bool], None]] = []

    def done(self) -> bool:
        return self._done

    def result(self) -> bool:
        if not self._done:
            raise RuntimeError("verify future not completed; call flush()")
        return self._result

    def add_done_callback(self, cb: Callable[[bool], None]) -> None:
        if self._done:
            cb(self._result)
        else:
            self._callbacks.append(cb)

    def _complete(self, ok: bool) -> None:
        self._done = True
        self._result = ok
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(ok)


class BatchSigVerifier:
    """Abstract backend; see module docstring."""

    name = "abstract"
    # span tracer, metrics registry, fault injector and the shared
    # VerifierStats, installed by make_verifier; None keeps direct
    # constructions silent
    tracer = None
    metrics = None
    faults = None
    stats = None

    def _span(self, name: str, **tags):
        return tracer_span(self.tracer, name, cat="crypto", **tags)

    def enqueue(self, key32: bytes, sig: bytes, msg: bytes) -> VerifyFuture:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def verify_many(self, triples: Sequence[Triple]) -> List[bool]:
        raise NotImplementedError

    def prewarm_many(self, triples: Sequence[Triple]) -> List[bool]:
        """Whole-ledger/checkpoint drain: verify a large batch in one
        dispatch and seed the result cache so later per-signature checks
        all hit. Already-cached triples are not re-dispatched.

        The cache keys hash per triple with hashlib. The reference hashes
        a drain of 256 or more in one native call (prep.c sct_cache_keys,
        `native.cache_keys_native` here); on the H100's host that call
        took about twice the hashlib loop's time over the 25,576-triple
        checkpoint drain (PERF.md), so the port keeps the loop."""
        with self._span("crypto.prewarm", backend=self.name,
                        n=len(triples)) as sp:
            cks = [_keys._cache_key(k, s, m) for (k, s, m) in triples]
            out: List[Optional[bool]] = [None] * len(triples)
            todo: List[Tuple[int, Triple, bytes]] = []  # (idx, triple, key)
            with _keys._cache_lock:
                for i, (t, ck) in enumerate(zip(triples, cks)):
                    hit = _keys._verify_cache.maybe_get(ck)
                    if hit is not None:
                        out[i] = hit
                    else:
                        todo.append((i, t, ck))
            sp.set_tag("cache_hits", len(triples) - len(todo))
            if todo:
                results = self.verify_many([t for (_i, t, _ck) in todo])
                with _keys._cache_lock:
                    for ((i, _t, ck), ok) in zip(todo, results):
                        _keys._verify_cache.put(ck, ok)
                        out[i] = ok
            return out  # type: ignore[return-value]

    def pending(self) -> int:
        return 0

    # -- pending-queue machinery (batch backends) ---------------------------
    # cache-probe on enqueue, self-flush at _max_pending, one verify_many
    # per flush, futures completed and the cache fed from the results

    _pending: List[Tuple[Triple, VerifyFuture]]
    _max_pending: int

    def _batch_enqueue(self, key32: bytes, sig: bytes,
                       msg: bytes) -> VerifyFuture:
        ck = _keys._cache_key(key32, sig, msg)
        with _keys._cache_lock:
            hit = _keys._verify_cache.maybe_get(ck)
        f = VerifyFuture()
        if hit is not None:
            f._complete(hit)
            return f
        self._pending.append(((key32, sig, msg), f))
        if self.stats is not None:
            self.stats.set_queue_depth(len(self._pending))
        if len(self._pending) >= self._max_pending:
            self.flush()
        return f

    def _batch_flush(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        if self.stats is not None:
            self.stats.set_queue_depth(0)
        try:
            results = self.verify_many([t for (t, _f) in batch])
        except BaseException:
            self._pending = batch + self._pending
            if self.stats is not None:
                self.stats.set_queue_depth(len(self._pending))
            raise
        for ((k, s, m), f), ok in zip(batch, results):
            with _keys._cache_lock:
                _keys._verify_cache.put(_keys._cache_key(k, s, m), ok)
            f._complete(ok)


class CpuSigVerifier(BatchSigVerifier):
    """Synchronous CPU backend."""

    name = "cpu"

    def enqueue(self, key32: bytes, sig: bytes, msg: bytes) -> VerifyFuture:
        f = VerifyFuture()
        f._complete(_keys.verify_sig(key32, sig, msg))
        return f

    def flush(self) -> None:
        pass

    def verify_many(self, triples: Sequence[Triple]) -> List[bool]:
        # CPU drains carry the device drains' batch-shape tags (no
        # padding here) so bucket selection sees all traffic
        with self._span("crypto.verify_many", backend=self.name,
                        n=len(triples), batches=1, pad_waste=0,
                        occupancy_pct=100.0):
            out = _keys.raw_verify_batch(triples)
            if self.stats is not None:
                self.stats.record_drain(self.name, len(triples))
            return out


class CudaSigVerifier(BatchSigVerifier):
    """Batched backend on the CUDA verify kernel, over a fleet of members
    (see the module docstring and parallel/mesh.py).

    `devices` names the members (repeats allowed: several members may
    share one card, each on its own streams); `device` is the one-member
    shorthand. With neither, the fleet is every visible card, and the
    constructor raises without one. Only a caller that names `cpu`
    members gets the kernel's plain version on the host."""

    name = "cuda"
    BUCKETS = (128, 512, 2048, 8192)

    # chunks below this size stay on one member: sharding a handful of
    # signatures buys nothing
    SHARD_MIN_BATCH = 1024

    # device drains between cockpit-plan autosaves (save_warmup_plan)
    PLAN_AUTOSAVE_DRAINS = 32

    ARG_KEYS = _e.ARG_KEYS

    PLAN_BASENAME = "warmup_buckets.json"

    def __init__(self, max_pending: int = 8192, device=None,
                 devices: Optional[Sequence] = None,
                 shard_threshold: Optional[int] = None,
                 now_fn: Optional[Callable[[], float]] = None,
                 device_breaker_threshold: int = 3,
                 device_breaker_cooldown: float = 30.0,
                 plan_dir: Optional[str] = None) -> None:
        if device is not None and devices is not None:
            raise ValueError("pass device= (one member) or devices= (a "
                             "fleet), not both")
        if device is not None:
            devices = [device]
        self._pending: List[Tuple[Triple, VerifyFuture]] = []
        self._max_pending = max_pending
        self.batches_dispatched = 0
        self.sigs_verified = 0
        # the warmup plan lives beside the kernel libraries
        self._plan_dir = plan_dir or _build.BUILD_DIR
        self._warmed = False
        self._warmup_thread: Optional[threading.Thread] = None
        self._now = now_fn
        self._dev_threshold = device_breaker_threshold
        self._dev_cooldown = device_breaker_cooldown
        self._mesh_fns: dict = {}   # tuple(member idxs) -> (fn, members)
        self._drains_since_plan_save = 0
        if shard_threshold is not None:
            self.SHARD_MIN_BATCH = shard_threshold
        self._members = make_fleet(devices)
        self._fleet_health = DeviceFleetHealth(
            len(self._members), threshold=self._dev_threshold,
            cooldown_s=self._dev_cooldown, now_fn=self._now, owner=self)
        self._platform = self._members[0].device.type
        if self.on_card:
            _e.load_kernel()

    # -- fleet topology ------------------------------------------------------
    @property
    def on_card(self) -> bool:
        """Whether any member is a CUDA device."""
        return any(m.device.type == "cuda" for m in self._members)

    @property
    def device(self):
        """The first member's device."""
        return self._members[0].device

    def _fleet(self):
        """(members, health)."""
        return self._members, self._fleet_health

    @property
    def fleet_health(self) -> "DeviceFleetHealth":
        return self._fleet()[1]

    def _mesh_fn(self, idxs: tuple):
        """(fn, members) of the sharded verify over the members at
        `idxs`: one entry per membership. A membership change after a
        breaker trip or recovery is counted, so degraded-fleet dispatch
        is never invisible."""
        got = self._mesh_fns.get(idxs)
        if got is None:
            members, _health = self._fleet()
            got = (launch_shards, tuple(members[i] for i in idxs))
            if self._mesh_fns and self.metrics is not None:
                self.metrics.new_meter("verifier.fleet.mesh-rebuild").mark()
            self._mesh_fns[idxs] = got
        return got

    def _single_fn(self):
        return launch_shards

    def _route(self, n: int):
        """(fn, padded bucket, member idxs) for an n-sig sub-batch.

        Membership is the healthy member set at route time; the
        verify.device-lost fault point simulates losing the first healthy
        member for this dispatch (its breaker counts the failure, so
        repeated fires trip it and the fleet degrades to N-1)."""
        devs, health = self._fleet()
        idxs = health.healthy() if len(devs) > 1 else [0]
        if len(idxs) > 1 and self.faults is not None and \
                self.faults.should_fire("verify.device-lost"):
            lost = idxs[0]
            health.record_failure(lost)
            idxs = [i for i in idxs if i != lost]
        if not idxs:
            # every breaker open: use every member (never the CPU)
            idxs = list(range(len(devs)))
        if len(idxs) > 1 and n >= self.SHARD_MIN_BATCH:
            fn, _members = self._mesh_fn(tuple(idxs))
            ndev = len(idxs)
        else:
            # a straggler tail keeps its own small bucket on ONE member,
            # the first healthy one
            fn = self._single_fn()
            idxs = idxs[:1]
            ndev = 1
        b = -(-self._bucket(n) // ndev) * ndev
        return fn, b, tuple(idxs)

    # -- staging (host prep + host->device copies) ---------------------------
    def _stage_chunk(self, chunk: Sequence[Triple], route) -> dict:
        """Prepare one sub-batch and copy it to its member(s). Runs on the
        staging worker when double-buffered; the returned blob is all
        dispatch needs."""
        fn, b, idxs = route
        prep = _e.prepare_batch(
            [t[0] for t in chunk], [t[1] for t in chunk],
            [t[2] for t in chunk])
        padded = pad_batch_to(prep, b)
        return {"args": self._device_args(padded, idxs),
                "pre_ok": prep["pre_ok"], "n": len(chunk), "b": b,
                "fn": fn, "idxs": idxs}

    def _device_args(self, padded: dict, idxs: tuple) -> tuple:
        """Explicit host->device placement: each member's lanes copied
        from pinned memory on its staging stream, with the event its
        launch waits on (parallel/mesh.place_shards)."""
        devs, _health = self._fleet()
        return place_shards([devs[i] for i in idxs],
                            [padded[k] for k in self.ARG_KEYS])

    # -- warm start ----------------------------------------------------------
    def warmup_plan_path(self) -> str:
        """The cockpit-derived bucket plan persists beside the kernel
        libraries: the restart that finds the kernel built finds the
        bucket set real traffic uses."""
        return os.path.join(self._plan_dir, self.PLAN_BASENAME)

    def _load_warmup_plan(self):
        """(buckets, source): the persisted cockpit plan when present and
        still valid against the ladder, else the full default BUCKETS."""
        try:
            with open(self.warmup_plan_path()) as fh:
                blob = json.load(fh)
            buckets = [int(b) for b in blob["buckets"]]
            if buckets and all(b in self.BUCKETS for b in buckets):
                return buckets, "cockpit"
            log.warning("persisted warmup plan %r does not fit the "
                        "candidate ladder %r; using the default set",
                        buckets, tuple(self.BUCKETS))
        except (OSError, ValueError, KeyError, TypeError):
            pass
        return list(self.BUCKETS), "default"

    def save_warmup_plan(self) -> Optional[str]:
        """Persist the cockpit-derived bucket plan beside the kernel
        libraries. No-op until the cockpit has seen traffic. Returns the
        path written, or None."""
        if self.stats is None:
            return None
        buckets, info = warmup_plan(self.stats, self.BUCKETS)
        if info.get("source") != "cockpit":
            return None
        path = self.warmup_plan_path()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"version": 1, "buckets": buckets,
                           "candidates": sorted(self.BUCKETS),
                           "traffic": {str(k): v for k, v in
                                       sorted(info["traffic"].items())},
                           "low_occupancy_extra":
                               info["low_occupancy_extra"]}, fh)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("could not persist warmup plan: %s", e)
            return None
        return path

    def _enable_compile_cache(self) -> None:
        """The kernel build directory stands where the reference's XLA
        compile cache stood: a built library serves every later process."""
        try:
            os.makedirs(self._plan_dir, exist_ok=True)
            if self.stats is not None:
                self.stats.compile_cache_enabled(self._plan_dir)
        except OSError as e:
            log.warning("kernel build directory unavailable: %s", e)
            if self.stats is not None:
                self.stats.compile_cache_error(repr(e))

    def _kernel_built(self) -> Optional[bool]:
        """Whether the verify kernel's library is already built for the
        current sources; None on a CPU fleet, which builds nothing."""
        if self._members[0].stream is None:
            return None
        return _build.cuda_built("ed25519_verify")

    def warmup(self, wait: bool = False) -> None:
        """Build the kernel and launch every planned bucket's route off
        the caller's path (a startup thread). Idempotent."""
        if self._warmed:
            return
        if self._warmup_thread is None:
            self._warmup_thread = spawn_worker(
                "crypto.verify-warmup", self._warmup_impl)
        if wait:
            self._warmup_thread.join()

    def _compile_bucket(self, b: int) -> None:
        """Build the kernel if it is not built, then launch zeros on the
        bucket's route, routed exactly like live traffic (sharded at or
        above SHARD_MIN_BATCH)."""
        fn, bb, idxs = self._route(b)
        zeros = {
            "ay": np.zeros((bb, 20), np.int32),
            "a_sign": np.zeros((bb,), np.int32),
            "ry": np.zeros((bb, 20), np.int32),
            "r_sign": np.zeros((bb,), np.int32),
            "s_nibs": np.zeros((bb, 64), np.int32),
            "k_nibs": np.zeros((bb, 64), np.int32),
        }
        np.asarray(fn(*self._device_args(zeros, idxs)))

    def _warmup_impl(self) -> None:
        st = self.stats
        try:
            self._enable_compile_cache()
            planned, source = self._load_warmup_plan()
            if st is not None:
                st.warmup_begin(planned, source=source)
            for b in planned:
                hit = self._kernel_built()
                t0 = real_monotonic()
                self._compile_bucket(b)
                dt = real_monotonic() - t0
                if st is not None:
                    st.warmup_bucket_done(b, dt, hit)
            self._warmed = True
            if st is not None:
                st.warmup_done()
            log.info("verify kernel warmup complete (%s buckets, %s plan)",
                     len(planned), source)
        except Exception as e:
            log.warning("verify kernel warmup failed: %s", e)
            if st is not None:
                st.warmup_failed(repr(e))

    # -- the boundary --------------------------------------------------------
    def enqueue(self, key32: bytes, sig: bytes, msg: bytes) -> VerifyFuture:
        return self._batch_enqueue(key32, sig, msg)

    def pending(self) -> int:
        return len(self._pending)

    def flush(self) -> None:
        self._batch_flush()

    def _bucket(self, n: int) -> int:
        for b in self.BUCKETS:
            if n <= b:
                return b
        return self.BUCKETS[-1]

    def verify_many(self, triples: Sequence[Triple]) -> List[bool]:
        out: List[bool] = []
        st = self.stats
        with self._span("crypto.verify_many", backend=self.name,
                        platform=self._platform, n=len(triples)) as sp:
            chunks: List[Sequence[Triple]] = []
            i = 0
            while i < len(triples):
                chunks.append(triples[i:i + self.BUCKETS[-1]])
                i += len(chunks[-1])
            batches = 0
            pad_waste = 0
            staged_s = overlap_s = 0.0
            staged_chunks = 0
            staged = self._stage_chunk(chunks[0],
                                       self._route(len(chunks[0]))) \
                if chunks else None
            for k in range(len(chunks)):
                job = None
                n, b, idxs = staged["n"], staged["b"], staged["idxs"]
                if st is not None:
                    for di in idxs:
                        st.set_device_inflight(di, True)
                try:
                    with self._span("crypto.dispatch", backend=self.name,
                                    n=n, bucket=b, pad=b - n,
                                    devices=len(idxs)):
                        # one launch per member, each on its own stream
                        ok_dev = staged["fn"](*staged["args"])
                        # double buffer: chunk K+1 is prepared and copied
                        # on the staging worker while the fleet runs chunk
                        # K. It starts after the launches, so its host
                        # work does not hold the interpreter between one
                        # member's launch and the next
                        job = _StagingJob(self, chunks[k + 1]) \
                            if k + 1 < len(chunks) else None
                        wait_t0 = real_monotonic()
                        ok = np.asarray(ok_dev)   # blocks on the gather
                        wait_t1 = real_monotonic()
                except Exception:
                    # a raising dispatch cannot name the guilty member: it
                    # counts against every participant's breaker, and
                    # reaches the caller
                    for di in idxs:
                        self._fleet_health.record_failure(di)
                    raise
                finally:
                    if st is not None:
                        for di in idxs:
                            st.set_device_inflight(di, False)
                # every participant's breaker sees the success, so
                # failures spread over time never read as consecutive and
                # a half-open member recovers through small drains too
                for di in idxs:
                    self._fleet_health.record_success(di)
                out.extend((ok[:n] & staged["pre_ok"]).tolist())
                self.batches_dispatched += 1
                self.sigs_verified += n
                batches += 1
                pad_waste += b - n
                if st is not None:
                    # keyed by the LADDER bucket, not the fleet-rounded
                    # padded size: 8192 over 3 members pads to 8193, and an
                    # off-ladder key would escape warmup_plan and mint
                    # unbounded verifier.bucket.<b>.* families
                    st.record_bucket_dispatch(self._bucket(n), n, b - n)
                    lanes = b // len(idxs)
                    for j, di in enumerate(idxs):
                        real = min(max(n - j * lanes, 0), lanes)
                        st.record_device_dispatch(di, real, lanes - real)
                if job is not None:
                    staged, s_s, o_s, stalled = job.result(wait_t0,
                                                           wait_t1)
                    if stalled:
                        # re-stage on this thread so the drain completes
                        # (the fleet idles for one chunk; the stall meter
                        # says so); the failed attempt does not count
                        # toward the overlap figure
                        if st is not None:
                            st.record_staging_stall()
                        staged = self._stage_chunk(
                            chunks[k + 1], self._route(len(chunks[k + 1])))
                    else:
                        staged_s += s_s
                        overlap_s += o_s
                        staged_chunks += 1
            sp.set_tag("batches", batches)
            sp.set_tag("pad_waste", pad_waste)
            total = len(triples)
            sp.set_tag("occupancy_pct", round(
                100.0 * total / (total + pad_waste), 1)
                if total + pad_waste else 100.0)
            if staged_chunks:
                sp.set_tag("staging_overlap_pct", round(
                    100.0 * overlap_s / staged_s, 1) if staged_s > 0
                    else 100.0)
            if st is not None:
                if staged_chunks:
                    st.record_staging(staged_s, overlap_s, staged_chunks)
                st.record_drain(self.name, total, pad=pad_waste,
                                splits=batches, bucketed=True)
            self._drains_since_plan_save += 1
            if self._drains_since_plan_save >= self.PLAN_AUTOSAVE_DRAINS:
                self._drains_since_plan_save = 0
                self.save_warmup_plan()
        return out


class _StagingJob:
    """One double-buffer staging unit: prepares drain chunk K+1 and copies
    it to its members on the `crypto.verify-staging` worker while the
    dispatch thread waits on chunk K. A staging failure (including the
    verify.staging-stall fault point) is reported as `stalled`, and the
    caller re-stages on its own thread so the drain always completes."""

    __slots__ = ("v", "chunk", "staged", "error", "t0", "t1", "thread")

    def __init__(self, verifier: CudaSigVerifier,
                 chunk: Sequence[Triple]) -> None:
        self.v = verifier
        self.chunk = chunk
        self.staged = None
        self.error: Optional[Exception] = None
        self.t0 = self.t1 = 0.0
        self.thread = spawn_worker("crypto.verify-staging", self._run)

    def _run(self) -> None:
        self.t0 = real_monotonic()
        try:
            if self.v.faults is not None:
                self.v.faults.fire_point("verify.staging-stall")
            self.staged = self.v._stage_chunk(
                self.chunk, self.v._route(len(self.chunk)))
        except Exception as e:
            self.error = e
        self.t1 = real_monotonic()

    def result(self, wait_t0: float, wait_t1: float):
        """(staged, staged_s, overlap_s, stalled): overlap is the
        intersection of the staging window with the caller's wait window
        [wait_t0, wait_t1]."""
        self.thread.join()
        staged_s = max(0.0, self.t1 - self.t0)
        overlap_s = max(0.0, min(self.t1, wait_t1) -
                        max(self.t0, wait_t0))
        if self.error is not None:
            log.warning("verify staging stalled (%s); re-staging chunk "
                        "synchronously", self.error)
            return None, staged_s, overlap_s, True
        return self.staged, staged_s, overlap_s, False


class DeviceFleetHealth:
    """One circuit breaker per fleet member: a sick member trips and
    recovers on its own, so the fleet degrades to N-1 members. State is
    exported as `verifier.device.<i>.breaker` gauges (0 closed / 1 open /
    2 half-open) plus trip/recover meters.

    Attribution: a failed sharded dispatch cannot name the guilty member,
    so it counts against every participant; single-member attribution
    comes from the verify.device-lost fault point."""

    def __init__(self, n_devices: int, threshold: int = 3,
                 cooldown_s: float = 30.0,
                 now_fn: Optional[Callable[[], float]] = None,
                 owner=None) -> None:
        self.owner = owner     # verifier; stats read dynamically
        # the ring is touched from the dispatch thread AND the staging
        # worker (_route runs on both): one lock makes allow()/record_*
        # transitions atomic. Lock order: fleet-health -> verifier-stats.
        self._lock = TrackedLock("crypto.fleet-health")
        self.breakers: List[CircuitBreaker] = []
        for i in range(n_devices):
            self.breakers.append(CircuitBreaker(
                threshold=threshold, cooldown_s=cooldown_s, now_fn=now_fn,
                on_trip=(lambda i=i: self._on_trip(i)),
                on_recover=(lambda i=i: self._on_recover(i))))

    def _stats(self):
        return getattr(self.owner, "stats", None) \
            if self.owner is not None else None

    def healthy(self) -> List[int]:
        """Member indices whose breaker admits a dispatch now (open
        breakers past their cooldown flip to half-open here)."""
        with self._lock:
            return [i for i, br in enumerate(self.breakers)
                    if br.allow()]

    def record_failure(self, idx: int) -> bool:
        with self._lock:
            tripped = self.breakers[idx].record_failure()
        self._sync_gauge(idx)
        return tripped

    def record_success(self, idx: int) -> None:
        with self._lock:
            self.breakers[idx].record_success()
        self._sync_gauge(idx)

    def _sync_gauge(self, idx: int) -> None:
        st = self._stats()
        if st is not None:
            st.set_device_breaker(idx, self.breakers[idx].state_code())

    def _on_trip(self, idx: int) -> None:
        log.warning("verify member %d breaker TRIPPED; fleet degrades to "
                    "%d member(s)", idx,
                    sum(1 for br in self.breakers
                        if br.state == CircuitBreaker.CLOSED))
        st = self._stats()
        if st is not None:
            st.device_trip(idx, self.breakers[idx].to_json())

    def _on_recover(self, idx: int) -> None:
        log.info("verify member %d breaker recovered", idx)
        st = self._stats()
        if st is not None:
            st.device_recover(idx)

    def to_json(self) -> dict:
        with self._lock:
            return {"devices": {str(i): br.to_json()
                                for i, br in enumerate(self.breakers)}}


class CircuitBreaker:
    """closed -> open -> half-open -> closed over a dispatch path.

    CLOSED: `threshold` CONSECUTIVE failures trip to OPEN. OPEN: bypassed
    until `cooldown_s` elapses on the injected clock, then the next
    allow() becomes the HALF-OPEN probe. HALF-OPEN: one success re-closes
    (recover), one failure re-opens for another cooldown."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"
    _STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 now_fn: Optional[Callable[[], float]] = None,
                 on_trip: Optional[Callable[[], None]] = None,
                 on_recover: Optional[Callable[[], None]] = None) -> None:
        self.threshold = max(1, threshold)
        self.cooldown_s = cooldown_s
        self._now = now_fn or real_monotonic
        self.on_trip = on_trip
        self.on_recover = on_recover
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.trips = 0
        self.recoveries = 0
        self._retry_at = 0.0

    def allow(self) -> bool:
        """May the next dispatch try this path?"""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN and self._now() >= self._retry_at:
            self.state = self.HALF_OPEN
            return True
        return self.state == self.HALF_OPEN

    def record_success(self) -> None:
        recovered = self.state == self.HALF_OPEN
        self.state = self.CLOSED
        self.consecutive_failures = 0
        if recovered:
            self.recoveries += 1
            if self.on_recover is not None:
                self.on_recover()

    def record_failure(self) -> bool:
        """True when this failure tripped (or re-opened) the breaker."""
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN or \
                self.consecutive_failures >= self.threshold:
            reopened = self.state != self.CLOSED
            self.state = self.OPEN
            self._retry_at = self._now() + self.cooldown_s
            if not reopened:
                self.trips += 1
                if self.on_trip is not None:
                    self.on_trip()
            return True
        return False

    def state_code(self) -> int:
        return self._STATE_CODE[self.state]

    def to_json(self) -> dict:
        return {"state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "trips": self.trips, "recoveries": self.recoveries,
                "threshold": self.threshold, "cooldown_s": self.cooldown_s,
                "retry_at": self._retry_at}


class BreakerOpenError(RuntimeError):
    """A drain refused while the breaker of a backend without a fallback
    is open."""


class ResilientBatchVerifier(BatchSigVerifier):
    """Primary backend behind a circuit breaker, with or without a
    fallback.

    Every dispatch-shaped call (verify_many; flush routes through it)
    asks the breaker whether the primary may be tried; a raising primary
    records a failure. With a fallback, that batch, and every batch while
    the breaker is open, runs on the fallback, so callers always get
    results. Without one, the failure raises to the caller and an open
    breaker refuses each drain (BreakerOpenError) until its half-open
    probe. A primary on a card takes no fallback: its work never moves to
    the CPU. A trip emits metrics and a flight-recorder dump; recovery
    (the first successful half-open probe) emits the matching recover
    marker."""

    name = "resilient"

    def __init__(self, primary: BatchSigVerifier,
                 fallback: Optional[BatchSigVerifier] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 max_pending: int = 8192) -> None:
        if fallback is not None and getattr(primary, "on_card", False):
            raise ValueError("a primary on a card takes no fallback: its "
                             "drains raise or wait for the card")
        self.primary = primary
        self.fallback = fallback
        self.breaker = breaker or CircuitBreaker()
        self.breaker.on_trip = self._on_trip
        self.breaker.on_recover = self._on_recover
        self.flight_recorder = None   # installed by make_verifier
        self._pending: List[Tuple[Triple, VerifyFuture]] = []
        self._max_pending = max_pending

    # -- breaker events ------------------------------------------------------
    def _breaker_mark(self, event: str) -> None:
        if self.metrics is not None:
            self.metrics.new_meter("crypto.breaker.%s" % event).mark()
            self.metrics.new_counter("crypto.breaker.state").set_count(
                self.breaker.state_code())
        tracer_instant(self.tracer, "crypto.breaker.%s" % event,
                       cat="crypto", primary=self.primary.name,
                       failures=self.breaker.consecutive_failures)

    def _on_trip(self) -> None:
        log.warning("verify breaker TRIPPED: %d consecutive %s-dispatch "
                    "failures; %s for %.0fs",
                    self.breaker.consecutive_failures, self.primary.name,
                    ("falling back to %s" % self.fallback.name
                     if self.fallback is not None else "refusing drains"),
                    self.breaker.cooldown_s)
        self._breaker_mark("trip")
        if self.flight_recorder is not None:
            self.flight_recorder.dump(
                "verify-breaker-trip",
                extra={"primary": self.primary.name,
                       "breaker": self.breaker.to_json()})

    def _on_recover(self) -> None:
        log.info("verify breaker recovered: %s backend healthy again",
                 self.primary.name)
        self._breaker_mark("recover")

    # -- delegation ----------------------------------------------------------
    @property
    def inner(self) -> BatchSigVerifier:
        return self.primary

    @property
    def batches_dispatched(self) -> int:
        return getattr(self.primary, "batches_dispatched", 0)

    @property
    def sigs_verified(self) -> int:
        return getattr(self.primary, "sigs_verified", 0)

    def warmup(self, wait: bool = False) -> None:
        w = getattr(self.primary, "warmup", None)
        if w is not None:
            w(wait)

    def save_warmup_plan(self):
        f = getattr(self.primary, "save_warmup_plan", None)
        return f() if f is not None else None

    @property
    def fleet_health(self):
        return getattr(self.primary, "_fleet_health", None)

    # -- verify paths --------------------------------------------------------
    def verify_many(self, triples: Sequence[Triple]) -> List[bool]:
        if self.breaker.allow():
            try:
                # the primary attempt has its own span, so a dispatch
                # failure is tagged on the drain it killed
                with self._span("crypto.dispatch_primary",
                                backend=self.primary.name,
                                n=len(triples)):
                    if self.faults is not None:
                        self.faults.fire_point("device.dispatch")
                    out = self.primary.verify_many(triples)
                self.breaker.record_success()
                return out
            except Exception as e:
                if self.metrics is not None:
                    self.metrics.new_meter(
                        "crypto.verify.dispatch-failure").mark()
                tripped = self.breaker.record_failure()
                if not tripped:
                    log.warning("%s dispatch failed (%s): %d/%d toward "
                                "breaker trip", self.primary.name, e,
                                self.breaker.consecutive_failures,
                                self.breaker.threshold)
                if self.fallback is None:
                    raise
        elif self.fallback is None:
            if self.metrics is not None:
                self.metrics.new_meter("crypto.verify.refused-drain").mark()
            raise BreakerOpenError(
                "%s breaker open (%d consecutive failures); the half-open "
                "probe comes at app-clock %.3f s"
                % (self.primary.name, self.breaker.consecutive_failures,
                   self.breaker.to_json()["retry_at"]))
        if self.metrics is not None:
            # drains served by the fallback while the primary is failing
            # or the breaker is open
            self.metrics.new_meter("crypto.verify.fallback-drain").mark()
        # served_by names the backend that ran the drain; the fallback's
        # own verify_many records the drain stats under its name
        with self._span("crypto.verify_fallback", backend=self.name,
                        served_by=self.fallback.name,
                        n=len(triples), breaker=self.breaker.state):
            return self.fallback.verify_many(triples)

    def enqueue(self, key32: bytes, sig: bytes, msg: bytes) -> VerifyFuture:
        return self._batch_enqueue(key32, sig, msg)

    def pending(self) -> int:
        return len(self._pending)

    def flush(self) -> None:
        # with a fallback, a primary failure re-runs the batch there: a
        # trip mid-drain still completes every future correctly. Without
        # one, the batch goes back to the queue and the failure raises
        self._batch_flush()


class ThreadedBatchVerifier(BatchSigVerifier):
    """Async wrapper: dispatch runs on a worker thread, futures complete on
    the caller's main loop via clock.post_to_main, so the thread that
    cranks the clock is the only one that sees results. Enqueue, dispatch
    and completion stamps read the app clock; `crypto.verify.latency`
    times each verify from enqueue to completion. A batch whose dispatch
    raises goes back to the head of the queue, uncompleted (meter
    `crypto.verify.requeued`), and the next flush dispatches it again."""

    name = "threaded"

    def __init__(self, inner: BatchSigVerifier, clock,
                 metrics=None) -> None:
        self._inner = inner
        self._clock = clock
        self._metrics = metrics
        self._lock = TrackedLock("crypto.threaded-pending")
        # (triple, future, enqueue app-clock stamp)
        self._pending: List[Tuple[Triple, VerifyFuture, float]] = []
        self._inflight = False

    @property
    def inner(self) -> BatchSigVerifier:
        """The device verifier (unwrapping a resilient layer)."""
        return getattr(self._inner, "inner", self._inner)

    @property
    def breaker(self):
        return getattr(self._inner, "breaker", None)

    def warmup(self, wait: bool = False) -> None:
        w = getattr(self._inner, "warmup", None)
        if w is not None:
            w(wait)

    def save_warmup_plan(self):
        f = getattr(self._inner, "save_warmup_plan", None)
        return f() if f is not None else None

    @property
    def fleet_health(self):
        return getattr(self._inner, "fleet_health", None)

    def enqueue(self, key32: bytes, sig: bytes, msg: bytes) -> VerifyFuture:
        ck = _keys._cache_key(key32, sig, msg)
        with _keys._cache_lock:
            hit = _keys._verify_cache.maybe_get(ck)
        f = VerifyFuture()
        if hit is not None:
            f._complete(hit)
            return f
        with self._lock:
            self._pending.append(((key32, sig, msg), f, self._clock.now()))
            depth = len(self._pending)
        if self.stats is not None:
            self.stats.set_queue_depth(depth)
        return f

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def flush(self) -> None:
        with self._lock:
            if not self._pending or self._inflight:
                return
            batch, self._pending = self._pending, []
            self._inflight = True
        st = self.stats
        if st is not None:
            st.set_queue_depth(0)
            st.set_inflight(True)

        def work() -> None:
            triples = [t for (t, _f, _t0) in batch]
            # queue wait: enqueue -> dispatch start, per batch; dispatch
            # time is the span's own duration
            t_disp = self._clock.now()
            waits = [t_disp - t0 for (_t, _f, t0) in batch]
            if st is not None:
                st.record_queue_wait(sum(waits) / len(waits), max(waits))
            with self._span("crypto.batch_dispatch",
                            backend="threaded:%s" % self._inner.name,
                            n=len(batch),
                            queue_wait_max_ms=round(max(waits) * 1e3, 3),
                            queue_wait_mean_ms=round(
                                sum(waits) / len(waits) * 1e3, 3)):
                try:
                    results = self._inner.verify_many(triples)
                except Exception as e:
                    # the worker must neither die with futures pending nor
                    # leave _inflight latched (every later flush would be
                    # a no-op)
                    log.warning("threaded dispatch failed (%s); %d verifies "
                                "queued again", e, len(batch))
                    self._clock.post_to_main(lambda: self._requeue(batch))
                    return

            def complete() -> None:
                done = self._clock.now()
                lat = (self._metrics.new_timer("crypto.verify.latency")
                       if self._metrics is not None else None)
                for ((k, s, m), f, t0), ok in zip(batch, results):
                    with _keys._cache_lock:
                        _keys._verify_cache.put(_keys._cache_key(k, s, m), ok)
                    if lat is not None:
                        lat.update(done - t0)
                    f._complete(ok)
                with self._lock:
                    self._inflight = False
                    more = bool(self._pending)
                if st is not None:
                    st.set_inflight(False)
                if more:
                    # verifies enqueued while the batch was in flight form
                    # the next batch at once
                    self.flush()

            self._clock.post_to_main(complete)

        spawn_worker("crypto.verify-dispatch", work)

    def _requeue(self, batch: list) -> None:
        with self._lock:
            self._pending = batch + self._pending
            self._inflight = False
            depth = len(self._pending)
        if self._metrics is not None:
            self._metrics.new_meter("crypto.verify.requeued").mark(len(batch))
        if self.stats is not None:
            self.stats.set_queue_depth(depth)
            self.stats.set_inflight(False)

    def verify_many(self, triples: Sequence[Triple]) -> List[bool]:
        return self._inner.verify_many(triples)


def make_verifier(backend: str = "cuda", max_pending: int = 8192,
                  device=None, metrics=None, tracer=None, faults=None,
                  clock=None, flight_recorder=None,
                  breaker_threshold: int = 3,
                  breaker_cooldown: float = 30.0) -> BatchSigVerifier:
    """Backend selection by name:

    - "cuda" (the default): the bare fleet, one member per visible card
      or the one member `device` where given; it raises without a card
      unless `device="cpu"` is named;
    - "cpu": the C verifier;
    - "cpu-resilient": the C verifier behind the breaker machinery, with a
      CpuSigVerifier fallback, so the failure domain can be driven
      without a card;
    - "cuda-resilient": the fleet behind a breaker, without a fallback
      (the counterpart of the reference's "tpu", whose fallback is the
      CPU): a failed drain raises, an open breaker refuses drains;
    - "cuda-async": "cuda-resilient" under a ThreadedBatchVerifier on
      `clock` (the reference's "tpu-async"; a clock is required).

    Every layer of the stack shares one VerifierStats (`<verifier>.stats`,
    with `flight_recorder`), so drains are attributed to the backend that
    served them. `clock.now` drives the breakers and the stats' stamps."""
    now_fn = clock.now if clock is not None else None
    stats = VerifierStats(metrics=metrics, tracer=tracer, now_fn=now_fn,
                          flight_recorder=flight_recorder)

    def resilient(primary: BatchSigVerifier,
                  fb: Optional[BatchSigVerifier]) -> ResilientBatchVerifier:
        primary.tracer = tracer
        primary.metrics = metrics
        primary.stats = stats
        # verify.device-lost / verify.staging-stall fire inside the
        # device backend, device.dispatch in the resilient layer
        primary.faults = faults
        if fb is not None:
            fb.tracer = tracer
            fb.metrics = metrics
            fb.stats = stats
        r = ResilientBatchVerifier(
            primary, fb,
            CircuitBreaker(threshold=breaker_threshold,
                           cooldown_s=breaker_cooldown, now_fn=now_fn),
            max_pending=max_pending)
        r.tracer = tracer
        r.flight_recorder = flight_recorder
        r.stats = stats
        return r

    def fleet() -> CudaSigVerifier:
        # the per-member breakers share the resilient layer's threshold,
        # cooldown and clock
        return CudaSigVerifier(max_pending=max_pending, device=device,
                               now_fn=now_fn,
                               device_breaker_threshold=breaker_threshold,
                               device_breaker_cooldown=breaker_cooldown)

    if backend == "cpu":
        v: BatchSigVerifier = CpuSigVerifier()
    elif backend == "cuda":
        v = fleet()
    elif backend == "cpu-resilient":
        v = resilient(CpuSigVerifier(), CpuSigVerifier())
    elif backend == "cuda-resilient":
        v = resilient(fleet(), None)
    elif backend == "cuda-async":
        if clock is None:
            raise ValueError("the cuda-async backend needs a clock")
        inner = resilient(fleet(), None)
        inner.metrics = metrics
        inner.faults = faults
        v = ThreadedBatchVerifier(inner, clock, metrics=metrics)
    else:
        raise ValueError("unknown sig verify backend %r" % backend)
    v.tracer = tracer
    v.metrics = metrics
    v.faults = faults
    v.stats = stats
    return v
