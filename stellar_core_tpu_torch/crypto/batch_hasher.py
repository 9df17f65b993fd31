"""BatchHasher: the batched SHA-256 boundary.

Port of `stellar_core_tpu/crypto/batch_hasher.py` at commit abe2377
(`KNOWN_SITES`, `HasherStats`, `BatchHasher`, `CpuBatchHasher`,
`TpuBatchHasher` as `CudaBatchHasher`, `_HashStagingJob`,
`ResilientBatchHasher`, `make_hasher`); carry a fix in either copy to the
other. SHA-256 has two traffic shapes in a ledger close, so the boundary
has two call shapes:

    hash_many(msgs, site)     -> [digest]  one digest per message: the
        bucket entry leaves the state commitment hashes by the thousand
        (ledger/state_commitment.py), the device-batchable load
    hash_stream(chunks, site) -> digest    one digest over a concatenated
        stream (txset contents, result sets, bucket identity): sequential
        by construction, served on the host through bounded join groups
    digest_one(data, site)    -> digest    one small message: host-served,
        a one-lane launch would pay the round trip for nothing

Backends:
- CpuBatchHasher — hashlib per message.
- CudaBatchHasher — the counterpart of the reference's TpuBatchHasher:
  messages are stably sorted by block count, cut into chunks of at most
  4,096 lanes, and each chunk is padded to a (lane bucket x block bucket)
  shape of a fixed ladder and hashed by one launch of the CUDA kernel
  (ops/sha256.hash_blocks_kernel). Digests come back in the caller's
  order. Messages longer than the largest block bucket (> 16 blocks,
  > 1,015 B) are hashed on the host and counted (`hasher.oversize`): the
  reference's own routing, not a fallback. Staging is double-buffered:
  two pinned host buffers, each of the largest shape; the C padder
  (ops/sha256.pad_chunk) writes a chunk's real blocks into one, a
  non-blocking copy takes it to the card on the staging stream, and the
  launch waits on that copy's event. While the kernel digests chunk K,
  the `crypto.hash-staging` worker stages chunk K+1 into the other buffer.
- ResilientBatchHasher — a circuit breaker over a primary backend. Over
  the CPU backend ("cpu-resilient") a CPU fallback serves the drains the
  primary fails or the open breaker bypasses; digests are SHA-256 either
  way. Over the card ("cuda-resilient") there is no fallback: a failed
  drain raises, and while the breaker is open every drain is refused with
  BreakerOpenError until its half-open probe.

Work that was sent to the card never moves to the CPU: a build or launch
failure raises to the caller.

Observability, as in the reference: one HasherStats per make_hasher()
stack, shared by every layer, so drains are attributed to the backend
that served them (`hasher.*` metrics: buckets, sites, oversize, staging,
warmup); tracer spans and instants (util/tracing.py); the fault points
`hash.device-lost` (inside the device backend's drain) and
`hash.dispatch-fail` (in the resilient layer, before the primary's
drain). The reference's persistent XLA compile cache is the kernel build
directory here (_build.BUILD_DIR): a warmup shape is a cache "hit" when
the SHA-256 library was already built for the current sources.

Threads: a drain's launches run on the caller's thread; the staging job
(`crypto.hash-staging`) pads and copies but never launches, and its C
padder releases the interpreter lock; the warmup (`crypto.hash-warmup`)
launches zeros at each warm shape. A hasher's staging buffers serve one
drain or warmup shape at a time (a lock).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..ops import sha256 as _sha
from ..util.metrics import MetricsRegistry
from ..util.threads import TrackedLock, spawn_worker
from ..util.timer import real_monotonic
from ..util.tracing import tracer_instant, tracer_span
from .batch_verifier import BreakerOpenError, CircuitBreaker
from .hashing import SHA256, sha256

log = logging.getLogger(__name__)

# bounded join group for streamed digests: one C-level update per ~1 MiB
# keeps per-chunk Python overhead amortized and peak memory flat on large
# txsets and buckets
_STREAM_GROUP_BYTES = 1 << 20

# the cockpit's bounded call-site ladder: every hash drain is attributed
# to the close-path site that issued it
KNOWN_SITES = ("txset", "result-set", "header", "bucket-entries",
               "bench", "other")


def stream_digest(chunks) -> bytes:
    """One SHA-256 over an iterable of byte chunks, grouped into bounded
    joins (see _STREAM_GROUP_BYTES)."""
    h = SHA256()
    buf: List[bytes] = []
    size = 0
    for c in chunks:
        buf.append(c)
        size += len(c)
        if size >= _STREAM_GROUP_BYTES:
            h.add(b"".join(buf))
            buf = []
            size = 0
    if buf:
        h.add(b"".join(buf))
    return h.finish()


class HasherStats:
    """Cockpit aggregation for the batch-hash boundary: one instance per
    make_hasher() stack, shared by every layer, so drains are attributed
    to the backend that served them; the same aggregates feed `to_json`,
    the metrics registry (`hasher.*`) and the tracer.

    Clocks: event stamps read the injected app clock (`now_fn`); warmup
    durations read util.timer.real_monotonic (a build takes real time
    under a frozen virtual clock). Recording happens on the caller's
    thread, the staging worker and the warmup thread under `_lock`;
    registry metric objects are individually thread-safe."""

    def __init__(self, metrics=None, tracer=None, now_fn=None,
                 flight_recorder=None) -> None:
        self._now = now_fn or real_monotonic
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(now_fn=self._now)
        self.tracer = tracer
        self.flight_recorder = flight_recorder
        self._lock = TrackedLock("crypto.hasher-stats")
        self.backends: dict = {}   # name -> {drains, msgs, bytes, pad_blocks}
        self.buckets: dict = {}    # "LxB" -> counts + histograms
        self.sites: dict = {}      # site -> {drains, msgs, bytes}
        self.oversize = 0
        self.staging = {"chunks": 0, "staged_s": 0.0, "overlap_s": 0.0,
                        "last_overlap_pct": None, "stalls": 0}
        self.warmup = {"state": "idle", "planned": [], "begun_t": None,
                       "done_t": None, "error": None, "shapes": {}}
        self.compile_cache = {"enabled": None, "dir": None, "hits": 0,
                              "misses": 0, "unknown": 0, "error": None}
        m = self.metrics
        self._h_batch = m.new_histogram("hasher.drain.batch-size")
        self._h_bytes = m.new_histogram("hasher.drain.bytes")
        self._h_pad = m.new_histogram("hasher.drain.pad-waste")
        self._h_occ = m.new_histogram("hasher.drain.occupancy-pct")
        self._h_splits = m.new_histogram("hasher.drain.splits")
        self._g_overlap = m.new_gauge("hasher.staging.overlap-pct")
        self._g_wstate = m.new_gauge("hasher.warmup.state")
        self._g_wdone = m.new_gauge("hasher.warmup.shapes-done")
        self._h_wsec = m.new_histogram("hasher.warmup.shape-seconds")
        self._g_cc = m.new_gauge("hasher.compile-cache.enabled")
        self._c_hit = m.new_counter("hasher.compile-cache.hit")
        self._c_miss = m.new_counter("hasher.compile-cache.miss")

    # -- drains --------------------------------------------------------------
    def record_drain(self, backend: str, msgs: int, nbytes: int,
                     pad_blocks: int = 0, real_blocks: int = 0,
                     splits: int = 1) -> None:
        """One hash_many drain attributed to the serving backend.
        `pad_blocks` is the total padding waste in 64-byte block units
        across every padded dispatch of the drain (0 on host drains);
        occupancy is real blocks over padded capacity."""
        total = real_blocks + pad_blocks
        occ = 100.0 * real_blocks / total if total else 100.0
        with self._lock:
            d = self.backends.setdefault(
                backend, {"drains": 0, "msgs": 0, "bytes": 0,
                          "pad_blocks": 0})
            d["drains"] += 1
            d["msgs"] += msgs
            d["bytes"] += nbytes
            d["pad_blocks"] += pad_blocks
        self._h_batch.update(msgs)
        self._h_bytes.update(nbytes)
        self._h_pad.update(pad_blocks)
        self._h_occ.update(occ)
        self._h_splits.update(splits)
        self.metrics.new_meter("hasher.drains.%s" % backend).mark()

    def record_bucket_dispatch(self, lanes: int, blocks: int, msgs: int,
                               real_blocks: int) -> None:
        """One padded device dispatch into the fixed (lanes x blocks)
        shape; names come from the backend's static ladder, so the
        `hasher.bucket.<b>.*` name space stays bounded."""
        key = "%dx%d" % (lanes, blocks)
        cap = lanes * blocks
        pad = cap - real_blocks
        occ = 100.0 * real_blocks / cap if cap else 100.0
        with self._lock:
            b = self.buckets.get(key)
            if b is None:
                b = self.buckets[key] = {
                    "dispatches": 0, "msgs": 0, "pad_blocks": 0,
                    "_occ": self.metrics.new_histogram(
                        "hasher.bucket.%s.occupancy-pct" % key),
                    "_pad": self.metrics.new_histogram(
                        "hasher.bucket.%s.pad-waste" % key),
                    "_m": self.metrics.new_meter(
                        "hasher.bucket.%s.drains" % key)}
            b["dispatches"] += 1
            b["msgs"] += msgs
            b["pad_blocks"] += pad
        b["_occ"].update(occ)
        b["_pad"].update(pad)
        b["_m"].mark()

    def record_site(self, site: str, msgs: int, nbytes: int) -> None:
        """Close-path attribution: which hashing consumer issued the
        drain. `site` comes from the bounded KNOWN_SITES ladder."""
        if site not in KNOWN_SITES:
            site = "other"
        with self._lock:
            s = self.sites.setdefault(site, {"drains": 0, "msgs": 0,
                                             "bytes": 0})
            s["drains"] += 1
            s["msgs"] += msgs
            s["bytes"] += nbytes
        self.metrics.new_meter("hasher.site.%s.drains" % site).mark()

    def record_oversize(self, n: int) -> None:
        """Messages whose padded block count exceeds the largest device
        shape: hashed on the host instead (split out of the dispatch)."""
        with self._lock:
            self.oversize += n
        self.metrics.new_meter("hasher.oversize").mark(n)

    # -- staging -------------------------------------------------------------
    def record_staging(self, staged_s: float, overlap_s: float,
                       chunks: int) -> None:
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
        with self._lock:
            self.staging["stalls"] += 1
        self.metrics.new_meter("hasher.staging.stall").mark()
        tracer_instant(self.tracer, "hasher.staging.stall", cat="crypto")

    # -- compile cache (the kernel build directory) + warmup -----------------
    def compile_cache_enabled(self, path: str) -> None:
        self.compile_cache.update(
            {"enabled": True, "dir": path, "error": None})
        self._g_cc.set(1)

    def compile_cache_error(self, err: str) -> None:
        self.compile_cache.update({"enabled": False, "error": err})
        self._g_cc.set(0)
        self.metrics.new_meter("hasher.compile-cache.unavailable").mark()
        tracer_instant(self.tracer, "hasher.compile-cache.unavailable",
                       cat="crypto", error=err)
        if self.flight_recorder is not None:
            self.flight_recorder.dump("hash-compile-cache-unavailable",
                                      extra={"error": err})

    WARMUP_STATE_CODE = {"idle": 0, "running": 1, "done": 2, "failed": 3}

    def warmup_begin(self, shapes) -> None:
        with self._lock:
            self.warmup.update({"state": "running", "begun_t": self._now(),
                                "done_t": None, "error": None,
                                "planned": ["%dx%d" % s for s in shapes]})
        self._g_wstate.set(self.WARMUP_STATE_CODE["running"])
        tracer_instant(self.tracer, "hasher.warmup.begin", cat="crypto",
                       shapes=["%dx%d" % s for s in shapes])

    def warmup_shape_done(self, shape, seconds: float, cache_hit) -> None:
        cache = ("hit" if cache_hit is True else
                 "miss" if cache_hit is False else "unknown")
        key = "%dx%d" % shape
        with self._lock:
            self.warmup["shapes"][key] = {
                "seconds": round(seconds, 3), "cache": cache,
                "t": self._now()}
            done = len(self.warmup["shapes"])
            self.compile_cache[
                {"hit": "hits", "miss": "misses",
                 "unknown": "unknown"}[cache]] += 1
        self._h_wsec.update(seconds)
        self._g_wdone.set(done)
        if cache_hit is True:
            self._c_hit.inc()
        elif cache_hit is False:
            self._c_miss.inc()
        tracer_instant(self.tracer, "hasher.warmup.shape", cat="crypto",
                       shape=key, seconds=round(seconds, 3), cache=cache)

    def warmup_done(self) -> None:
        with self._lock:
            self.warmup.update({"state": "done", "done_t": self._now()})
        self._g_wstate.set(self.WARMUP_STATE_CODE["done"])
        tracer_instant(self.tracer, "hasher.warmup.end", cat="crypto",
                       shapes=len(self.warmup["shapes"]))

    def warmup_failed(self, err: str) -> None:
        with self._lock:
            self.warmup.update({"state": "failed", "done_t": self._now(),
                                "error": err})
        self._g_wstate.set(self.WARMUP_STATE_CODE["failed"])
        self.metrics.new_meter("hasher.warmup.failure").mark()
        tracer_instant(self.tracer, "hasher.warmup.failed", cat="crypto",
                       error=err)
        if self.flight_recorder is not None:
            self.flight_recorder.dump("hash-warmup-failed",
                                      extra={"error": err})

    # -- export --------------------------------------------------------------
    def to_json(self) -> dict:
        with self._lock:
            backends = {k: dict(v) for k, v in self.backends.items()}
            buckets = {
                k: {"dispatches": d["dispatches"], "msgs": d["msgs"],
                    "pad_blocks_total": d["pad_blocks"],
                    "occupancy_pct": d["_occ"].snapshot(),
                    "pad_waste": d["_pad"].snapshot()}
                for k, d in sorted(self.buckets.items())}
            sites = {k: dict(v) for k, v in sorted(self.sites.items())}
            staging = dict(self.staging)
            warm = dict(self.warmup)
            warm["shapes"] = {k: dict(v)
                              for k, v in self.warmup["shapes"].items()}
            cc = dict(self.compile_cache)
            oversize = self.oversize
        return {
            "drains": {"by_backend": backends,
                       "batch_size": self._h_batch.snapshot(),
                       "bytes": self._h_bytes.snapshot(),
                       "pad_waste": self._h_pad.snapshot(),
                       "occupancy_pct": self._h_occ.snapshot(),
                       "splits": self._h_splits.snapshot()},
            "buckets": buckets,
            "sites": sites,
            "oversize_msgs": oversize,
            "staging": staging,
            "warmup": warm,
            "compile_cache": cc,
        }


class BatchHasher:
    """Abstract backend; see module docstring. `tracer`/`metrics`/
    `faults`/`stats` are installed by make_hasher; None keeps direct
    constructions silent."""

    name = "abstract"
    wants_warmup = False
    tracer = None
    metrics = None
    faults = None
    stats = None

    def _span(self, name: str, **tags):
        return tracer_span(self.tracer, name, cat="crypto", **tags)

    def hash_many(self, msgs: Sequence[bytes],
                  site: str = "other") -> List[bytes]:
        raise NotImplementedError

    def digest_one(self, data: bytes, site: str = "other") -> bytes:
        """Single-digest convenience (header hash, txset identity),
        always served on the host and attributed to the cockpit like any
        drain."""
        if self.stats is not None:
            self.stats.record_site(site, 1, len(data))
            self.stats.record_drain("host-stream", 1, len(data))
        return sha256(data)

    def hash_stream(self, chunks, site: str = "other") -> bytes:
        """One digest over a concatenated stream, served on the host via
        `stream_digest`'s bounded join groups; counts chunks and bytes for
        the cockpit under `site`."""
        counted = {"n": 0, "bytes": 0}

        def walk():
            for c in chunks:
                counted["n"] += 1
                counted["bytes"] += len(c)
                yield c

        out = stream_digest(walk())
        if self.stats is not None:
            self.stats.record_site(site, counted["n"], counted["bytes"])
            self.stats.record_drain("host-stream", counted["n"],
                                    counted["bytes"])
        return out


class CpuBatchHasher(BatchHasher):
    """Synchronous hashlib backend: the CPU stacks' primary and the
    fallback of "cpu-resilient"."""

    name = "cpu"

    def hash_many(self, msgs: Sequence[bytes],
                  site: str = "other") -> List[bytes]:
        nbytes = sum(len(m) for m in msgs)
        with self._span("crypto.hash_many", backend=self.name,
                        site=site, n=len(msgs), bytes=nbytes):
            out = [sha256(m) for m in msgs]
            if self.stats is not None:
                self.stats.record_site(site, len(msgs), nbytes)
                self.stats.record_drain(self.name, len(msgs), nbytes)
            return out


class _StagingBuffer:
    """One of a hasher's two host staging buffers, each of the largest
    shape (pinned on a card), and the event of the last copy out of it."""

    __slots__ = ("words", "counts", "copied")

    def __init__(self, lanes: int, blocks: int, pin: bool) -> None:
        self.words = torch.empty(lanes * blocks * 16, dtype=torch.int32,
                                 pin_memory=pin)
        self.counts = torch.empty(lanes, dtype=torch.int32, pin_memory=pin)
        self.copied: Optional[torch.cuda.Event] = None


# one chunk of a drain: the caller's indices of its messages, its lane
# bucket and its block bucket
Chunk = Tuple[np.ndarray, int, int]


class CudaBatchHasher(BatchHasher):
    """Batched backend on the CUDA SHA-256 kernel; see the module
    docstring.

    Runs on `device` (default: the current CUDA device). Without CUDA the
    constructor raises, unless the caller asks for `device="cpu"`, where
    the wrapper runs the kernel's plain version and the staging buffers
    are ordinary memory. Plain counters (`batches`, `real_blocks`,
    `pad_blocks`, `oversize_msgs`) count this hasher's drains beside the
    cockpit."""

    name = "cuda"
    wants_warmup = True
    LANE_BUCKETS = (256, 1024, 4096)
    BLOCK_BUCKETS = (1, 2, 4, 8, 16)
    # shapes the warmup launches: the small-drain shape plus the bulk
    # entry-leaf shapes
    WARM_SHAPES = ((256, 2), (4096, 2), (4096, 4))

    def __init__(self, device=None) -> None:
        self.device = torch.device("cuda" if device is None else device)
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CudaBatchHasher needs a CUDA device; none is "
                    "available (pass device='cpu' to run the kernel's "
                    "plain version)")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self.on_card else None
        self._buffers = [_StagingBuffer(self.LANE_BUCKETS[-1],
                                        self.BLOCK_BUCKETS[-1],
                                        self.on_card) for _ in range(2)]
        # the staging buffers serve one drain (or warmup shape) at a time
        self._lock = TrackedLock("crypto.hash-staging-buffers")
        self._warmed = False
        self._warmup_thread: Optional[threading.Thread] = None
        self.batches = 0          # kernel dispatches of drains
        self.pad_blocks = 0       # padded-but-empty blocks shipped
        self.real_blocks = 0      # message blocks hashed on the device
        self.oversize_msgs = 0    # messages hashed on the host

    # -- routing -------------------------------------------------------------
    @staticmethod
    def _bucket(ladder: Tuple[int, ...], n: int) -> int:
        for b in ladder:
            if n <= b:
                return b
        return ladder[-1]

    def _route(self, blocks: np.ndarray) -> Tuple[np.ndarray, List[Chunk]]:
        """`plan` on an array of block counts, with index arrays."""
        max_dev = self.BLOCK_BUCKETS[-1]
        over = np.flatnonzero(blocks > max_dev)
        dev = np.flatnonzero(blocks <= max_dev)
        dev = dev[np.argsort(blocks[dev], kind="stable")]
        step = self.LANE_BUCKETS[-1]
        chunks = []
        for k in range(0, len(dev), step):
            idx = dev[k:k + step]
            chunks.append((idx, self._bucket(self.LANE_BUCKETS, len(idx)),
                           self._bucket(self.BLOCK_BUCKETS,
                                        int(blocks[idx[-1]]))))
        return over, chunks

    def plan(self, blocks: Sequence[int]) -> Tuple[List[int], list]:
        """Route a drain given each message's block count: the indices of
        the oversize messages (hashed on the host), and the device chunks,
        each (indices, lane bucket, block bucket). Device messages are
        stably sorted by block count, so a chunk's block bucket fits its
        longest member tightly."""
        over, chunks = self._route(np.asarray(blocks, np.int64).reshape(-1))
        return over.tolist(), [(idx.tolist(), lanes, blk)
                               for idx, lanes, blk in chunks]

    # -- staging + launch ----------------------------------------------------
    def _stage_hash_chunk(self, blob: bytes, off: np.ndarray,
                          lens: np.ndarray, lanes: int, blocks: int,
                          slot: int) -> dict:
        """Pad one chunk (messages blob[off[i]:off[i] + lens[i]]) into
        staging buffer `slot` and, on a card, start its copy to the device
        on the staging stream; runs on the staging worker when
        double-buffered."""
        buf = self._buffers[slot]
        if buf.copied is not None:
            # the copy out of this buffer two chunks ago must be done
            # before the padder rewrites it
            buf.copied.synchronize()
        words = buf.words[:lanes * blocks * 16].view(lanes, blocks, 16)
        counts = buf.counts[:lanes]
        _sha.pad_chunk(blob, off, lens, words.numpy(), counts.numpy())
        staged = {"n": len(off), "lanes": lanes, "blocks": blocks,
                  "words": words, "counts": counts, "ready": None}
        if not self.on_card:
            return staged
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._copy_stream):
            staged["words"] = words.to(self.device, non_blocking=True)
            staged["counts"] = counts.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        buf.copied = staged["ready"] = ready
        return staged

    def _launch(self, staged: dict) -> torch.Tensor:
        """Launch the kernel on a staged chunk, on the caller's current
        stream, after the chunk's copy; returns its (lanes, 8) digest words
        on the device (asynchronous)."""
        ready = staged["ready"]
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            # made on the staging stream, read on this one: the caching
            # allocator must not hand the memory out again before the
            # kernel is done with it
            staged["words"].record_stream(cur)
            staged["counts"].record_stream(cur)
        return _sha.hash_blocks_kernel(staged["words"], staged["counts"])

    # -- warmup (the kernel build directory stands for the compile cache) ----
    def _enable_compile_cache(self) -> None:
        try:
            os.makedirs(_build.BUILD_DIR, exist_ok=True)
            if self.stats is not None:
                self.stats.compile_cache_enabled(_build.BUILD_DIR)
        except OSError as e:
            log.warning("kernel build directory unavailable: %s", e)
            if self.stats is not None:
                self.stats.compile_cache_error(repr(e))

    def _kernel_built(self) -> Optional[bool]:
        """Whether the SHA-256 library is already built for the current
        sources; None on the CPU, which builds nothing."""
        return _build.cuda_built("sha256") if self.on_card else None

    def warmup(self, wait: bool = False) -> None:
        """Build the kernel and launch every warm shape off the caller's
        path (a startup thread). Idempotent."""
        if self._warmed:
            return
        if self._warmup_thread is None:
            self._warmup_thread = spawn_worker(
                "crypto.hash-warmup", self._hash_warmup_impl)
        if wait:
            self._warmup_thread.join()

    def _compile_shape(self, lanes: int, blocks: int) -> None:
        """Build the kernel if it is not built, then hash `lanes` zero
        messages that fill the shape, through the staging and launch path
        of live traffic."""
        size = 64 * blocks - 9
        with self._lock:
            staged = self._stage_hash_chunk(
                bytes(size), np.zeros(lanes, np.uint64),
                np.full(lanes, size, np.uint64), lanes, blocks, 0)
            self._launch(staged).cpu()

    def _hash_warmup_impl(self) -> None:
        st = self.stats
        try:
            self._enable_compile_cache()
            if st is not None:
                st.warmup_begin(self.WARM_SHAPES)
            for shape in self.WARM_SHAPES:
                hit = self._kernel_built()
                t0 = real_monotonic()
                self._compile_shape(*shape)
                dt = real_monotonic() - t0
                if st is not None:
                    st.warmup_shape_done(shape, dt, hit)
            self._warmed = True
            if st is not None:
                st.warmup_done()
            log.info("hash kernel warmup complete (%d shapes)",
                     len(self.WARM_SHAPES))
        except Exception as e:
            log.warning("hash kernel warmup failed: %s", e)
            if st is not None:
                st.warmup_failed(repr(e))

    # -- the drain -----------------------------------------------------------
    def hash_many(self, msgs: Sequence[bytes],
                  site: str = "other") -> List[bytes]:
        if self.faults is not None:
            # the device vanishing mid-drain: the drain raises to the
            # caller (a resilient layer's breaker counts it)
            self.faults.fire_point("hash.device-lost")
        n = len(msgs)
        blob, off, lens = _sha.join_messages(msgs)
        nbytes = len(blob)
        st = self.stats
        out: List[Optional[bytes]] = [None] * n
        with self._span("crypto.hash_many", backend=self.name,
                        platform=self.device.type, site=site, n=n,
                        bytes=nbytes) as sp:
            # FIPS block counts: the message, the 0x80 marker and the
            # 8-byte length, in 64-byte blocks
            blocks = (lens + np.uint64(72)) // np.uint64(64)
            over, chunks = self._route(blocks)
            if len(over):
                # oversize lanes hash on the host, split out of the padded
                # dispatch entirely
                if st is not None:
                    st.record_oversize(len(over))
                self.oversize_msgs += len(over)
                for i in over.tolist():
                    out[i] = sha256(msgs[i])
            pad_blocks = real_total = batches = 0
            staged_s = overlap_s = 0.0
            staged_chunks = 0
            if chunks:
                def stage(c: int, slot: int) -> dict:
                    idx, lanes, blk = chunks[c]
                    return self._stage_hash_chunk(blob, off[idx], lens[idx],
                                                  lanes, blk, slot)

                with self._lock:
                    staged = stage(0, 0)
                    for c, (idx, _lanes, _blk) in enumerate(chunks):
                        job = None
                        try:
                            with self._span("crypto.hash.dispatch",
                                            backend=self.name,
                                            n=staged["n"],
                                            lanes=staged["lanes"],
                                            blocks=staged["blocks"]):
                                dig_dev = self._launch(staged)
                                # double buffer: chunk K+1 is padded and
                                # copied on the staging worker while the
                                # kernel digests chunk K; it starts after
                                # the launch, so its host work does not
                                # delay it
                                if c + 1 < len(chunks):
                                    job = _HashStagingJob(stage, c + 1,
                                                          (c + 1) % 2)
                                wait_t0 = real_monotonic()
                                dig = dig_dev[:staged["n"]].cpu()  # waits
                                wait_t1 = real_monotonic()
                        except BaseException:
                            # the job writes a staging buffer: it must be
                            # done before the lock lets another drain in
                            if job is not None:
                                job.thread.join()
                            raise
                        raw = _sha.digests_to_bytes(
                            dig.numpy().view(np.uint32))
                        for i, d in zip(idx.tolist(), raw):
                            out[i] = d
                        real = int(blocks[idx].sum())
                        cap = staged["lanes"] * staged["blocks"]
                        pad_blocks += cap - real
                        real_total += real
                        batches += 1
                        if st is not None:
                            st.record_bucket_dispatch(
                                staged["lanes"], staged["blocks"],
                                staged["n"], real)
                        if job is not None:
                            staged, s_s, o_s, stalled = job.result(
                                wait_t0, wait_t1)
                            if stalled:
                                # re-stage on this thread so the drain
                                # completes; the failed attempt does not
                                # count toward the overlap figure
                                if st is not None:
                                    st.record_staging_stall()
                                staged = stage(c + 1, (c + 1) % 2)
                            else:
                                staged_s += s_s
                                overlap_s += o_s
                                staged_chunks += 1
                    self.batches += batches
                    self.real_blocks += real_total
                    self.pad_blocks += pad_blocks
            sp.set_tag("batches", batches)
            sp.set_tag("pad_blocks", pad_blocks)
            sp.set_tag("oversize", len(over))
            if staged_chunks:
                sp.set_tag("staging_overlap_pct", round(
                    100.0 * overlap_s / staged_s, 1) if staged_s > 0
                    else 100.0)
            if st is not None:
                if staged_chunks:
                    st.record_staging(staged_s, overlap_s, staged_chunks)
                st.record_site(site, n, nbytes)
                st.record_drain(self.name, n, nbytes,
                                pad_blocks=pad_blocks,
                                real_blocks=real_total,
                                splits=max(1, batches))
        return out  # type: ignore[return-value]


class _HashStagingJob:
    """One double-buffer staging unit: pads and copies hash chunk K+1 on
    the `crypto.hash-staging` worker while the dispatch thread waits on
    chunk K. Timing is util.timer.real_monotonic (host/device overlap is
    real elapsed time). A staging failure is reported as `stalled`; the
    caller re-stages on its own thread so the drain always completes."""

    __slots__ = ("stage", "chunk", "slot", "staged", "error", "t0", "t1",
                 "thread")

    def __init__(self, stage: Callable[[int, int], dict], chunk: int,
                 slot: int) -> None:
        self.stage = stage
        self.chunk = chunk
        self.slot = slot
        self.staged = None
        self.error: Optional[Exception] = None
        self.t0 = self.t1 = 0.0
        self.thread = spawn_worker("crypto.hash-staging", self._run)

    def _run(self) -> None:
        self.t0 = real_monotonic()
        try:
            self.staged = self.stage(self.chunk, self.slot)
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
            log.warning("hash staging stalled (%s); re-staging chunk "
                        "synchronously", self.error)
            return None, staged_s, overlap_s, True
        return self.staged, staged_s, overlap_s, False


class ResilientBatchHasher(BatchHasher):
    """Primary backend behind a circuit breaker, with or without a
    fallback (the verify breaker's closed -> open -> half-open machinery,
    on the same injected app clock).

    A raising primary records a failure. With a fallback, that drain,
    and every drain while the breaker is open, runs on the fallback;
    digests are SHA-256 either way. Without one, the failure raises to
    the caller and an open breaker refuses each drain (BreakerOpenError,
    meter `hasher.refused-drain`) until its half-open probe. A primary on
    a card takes no fallback: its work never moves to the CPU. A trip
    emits metrics and a flight dump; the first successful half-open probe
    emits the recover marker."""

    name = "resilient"

    def __init__(self, primary: BatchHasher,
                 fallback: Optional[BatchHasher] = None,
                 breaker: Optional[CircuitBreaker] = None) -> None:
        if fallback is not None and getattr(primary, "on_card", False):
            raise ValueError("a primary on a card takes no fallback: its "
                             "drains raise or wait for the card")
        self.primary = primary
        self.fallback = fallback
        self.breaker = breaker or CircuitBreaker()
        self.breaker.on_trip = self._on_trip
        self.breaker.on_recover = self._on_recover
        self.flight_recorder = None   # installed by make_hasher

    # -- breaker events ------------------------------------------------------
    def _breaker_mark(self, event: str) -> None:
        if self.metrics is not None:
            self.metrics.new_meter("hasher.breaker.%s" % event).mark()
            self.metrics.new_counter("hasher.breaker.state").set_count(
                self.breaker.state_code())
        tracer_instant(self.tracer, "hasher.breaker.%s" % event,
                       cat="crypto", primary=self.primary.name,
                       failures=self.breaker.consecutive_failures)

    def _on_trip(self) -> None:
        log.warning("hash breaker TRIPPED: %d consecutive %s-dispatch "
                    "failures; %s for %.0fs",
                    self.breaker.consecutive_failures, self.primary.name,
                    ("falling back to %s" % self.fallback.name
                     if self.fallback is not None else "refusing drains"),
                    self.breaker.cooldown_s)
        self._breaker_mark("trip")
        if self.flight_recorder is not None:
            self.flight_recorder.dump(
                "hash-breaker-trip",
                extra={"primary": self.primary.name,
                       "breaker": self.breaker.to_json()})

    def _on_recover(self) -> None:
        log.info("hash breaker recovered: %s backend healthy again",
                 self.primary.name)
        self._breaker_mark("recover")

    # -- delegation ----------------------------------------------------------
    @property
    def wants_warmup(self) -> bool:
        return self.primary.wants_warmup

    @property
    def inner(self) -> BatchHasher:
        return self.primary

    def warmup(self, wait: bool = False) -> None:
        w = getattr(self.primary, "warmup", None)
        if w is not None:
            w(wait)

    def hash_many(self, msgs: Sequence[bytes],
                  site: str = "other") -> List[bytes]:
        if self.breaker.allow():
            try:
                with self._span("crypto.hash_dispatch_primary",
                                backend=self.primary.name, n=len(msgs)):
                    if self.faults is not None:
                        self.faults.fire_point("hash.dispatch-fail")
                    out = self.primary.hash_many(msgs, site=site)
                self.breaker.record_success()
                return out
            except Exception as e:
                if self.metrics is not None:
                    self.metrics.new_meter(
                        "hasher.dispatch-failure").mark()
                tripped = self.breaker.record_failure()
                if not tripped:
                    log.warning("%s hash dispatch failed (%s): %d/%d "
                                "toward breaker trip", self.primary.name,
                                e, self.breaker.consecutive_failures,
                                self.breaker.threshold)
                if self.fallback is None:
                    raise
        elif self.fallback is None:
            if self.metrics is not None:
                self.metrics.new_meter("hasher.refused-drain").mark()
            raise BreakerOpenError(
                "%s hash breaker open (%d consecutive failures); the "
                "half-open probe comes at app-clock %.3f s"
                % (self.primary.name, self.breaker.consecutive_failures,
                   self.breaker.to_json()["retry_at"]))
        if self.metrics is not None:
            self.metrics.new_meter("hasher.fallback-drain").mark()
        with self._span("crypto.hash_fallback", backend=self.name,
                        served_by=self.fallback.name, n=len(msgs),
                        breaker=self.breaker.state):
            return self.fallback.hash_many(msgs, site=site)


def make_hasher(backend: str = "cuda", device=None, clock=None,
                metrics=None, tracer=None, faults=None,
                flight_recorder=None, breaker_threshold: int = 3,
                breaker_cooldown: float = 30.0) -> BatchHasher:
    """Backend selection by name:

    - "cuda" (the default): the bare CudaBatchHasher on `device`; it
      raises without a card unless `device="cpu"` is given;
    - "cpu": hashlib;
    - "cpu-resilient": hashlib behind the breaker machinery, with a CPU
      fallback, so the hash failure domain can be driven without a card;
    - "cuda-resilient": the CudaBatchHasher behind a breaker, without a
      fallback (the counterpart of the reference's "tpu", whose fallback
      is the CPU): a failed drain raises, an open breaker refuses drains.

    Every layer of the stack shares one HasherStats (`<hasher>.stats`,
    with `flight_recorder`), so drains are attributed to the backend that
    served them. `clock.now` drives the breaker and the stats' stamps."""
    now_fn = clock.now if clock is not None else None
    stats = HasherStats(metrics=metrics, tracer=tracer, now_fn=now_fn,
                        flight_recorder=flight_recorder)

    def resilient(primary: BatchHasher,
                  fb: Optional[BatchHasher]) -> ResilientBatchHasher:
        primary.tracer = tracer
        primary.metrics = metrics
        primary.stats = stats
        # hash.device-lost fires inside the device backend,
        # hash.dispatch-fail in the resilient layer
        primary.faults = faults
        if fb is not None:
            fb.tracer = tracer
            fb.metrics = metrics
            fb.stats = stats
        r = ResilientBatchHasher(
            primary, fb,
            CircuitBreaker(threshold=breaker_threshold,
                           cooldown_s=breaker_cooldown, now_fn=now_fn))
        r.flight_recorder = flight_recorder
        return r

    if backend == "cpu":
        h: BatchHasher = CpuBatchHasher()
    elif backend == "cuda":
        h = CudaBatchHasher(device=device)
    elif backend == "cpu-resilient":
        h = resilient(CpuBatchHasher(), CpuBatchHasher())
    elif backend == "cuda-resilient":
        h = resilient(CudaBatchHasher(device=device), None)
    else:
        raise ValueError("unknown hash backend %r" % backend)
    h.tracer = tracer
    h.metrics = metrics
    h.faults = faults
    h.stats = stats
    return h
