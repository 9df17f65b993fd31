"""Span tracer, flight recorder and the tracer guards.

Copied (`Span`, `_NoopSpan`, `tracer_span`, `tracer_instant`, `Tracer`,
`FlightRecorder`) from `stellar_core_tpu/util/tracing.py` at commit
abe2377, and `app_span` at commit 6dc7ba8; carry a fix in either copy to
the other. The collector spans (`Tracer(gc_spans=True)`, below) are the
port's own and are not carried back: the copies differ there.

- `Tracer`: nested spans with tags in a bounded ring buffer. Disabled
  (the default) a span is one attribute check, so the instrumentation
  stays in the hot paths.
- `to_chrome_trace`: Chrome trace-event JSON (chrome://tracing,
  Perfetto).
- `phase_breakdown`: exclusive (self-time) totals per phase from the
  recorded spans; the phase key carries a span's `backend` tag, and its
  `platform` tag where that differs (`crypto.hash_many:cuda@cpu` is the
  kernel's plain version on the CPU, not the card).
- `FlightRecorder`: on a trigger (a breaker trip, a failed warmup),
  snapshots the last spans, the open spans and the metrics registry to
  a JSON file; a dump failure is logged, never raised.
- `tracer_span` / `tracer_instant`: spans and instants against a
  possibly-absent, possibly-disabled tracer (a no-op then).
- Collector spans: a tracer built with `gc_spans=True` records each
  cyclic collection while it is enabled, as a span `gc.gen0`/`gc.gen1`/
  `gc.gen2` (tags `collected`, `uncollectable`) on the collecting thread,
  under the span that thread has open. Each such tracer puts one hook in
  `gc.callbacks` on `enable()` and takes it out on `disable()`, or when
  the tracer is freed while enabled; otherwise the interpreter runs no
  callback of the port's. `Application` builds its tracer so; a bare
  `Tracer()` records none, so a trace over a fixed ring holds only the
  program's spans. Under a load heavy in young-generation collections
  (thousands a second) the collector spans can fill a small ring and
  evict the spans around them: `dropped` counts the spans evicted since
  `enable()`, so read it before trusting a window, and give a long trace
  a larger ring (`Config.TRACE_CAPACITY`, or `enable(capacity=...)`).

The port's spans beyond the reference's ("dispatch thread" is the thread
that called `verify_many`: the main loop on the synchronous stacks, the
`ThreadedBatchVerifier` worker on `cuda-async`):

- `crypto.cache_keys`, `crypto.cache_probe`, `crypto.cache_fill`, under
  `crypto.prewarm` on the caller's thread: the hashlib loop of a drain's
  verify-cache keys, the lookups and the puts after the drain (the last
  two under the cache lock).
- `crypto.stage` (tags `n`, `bucket`), `CudaSigVerifier._stage_chunk`:
  one chunk's host prep and copies, under `crypto.verify_many` on the
  dispatch thread for the first chunk, a root span on the
  `crypto.verify-staging` worker for the rest. Its children in order:
  `crypto.stage.prep` (`pack_batch` and the C prep; without the C prep
  the plain numpy prep, recode included), `crypto.stage.recode` (the C
  prep's digits made signed, `finish_native`), `crypto.stage.pad`
  (`pad_batch_to`), `crypto.stage.copy` (`place_shards`: pinning,
  host-to-device copies, ready events).
- `crypto.launch` (tags `bucket`, `lanes_real`, `members`) then
  `crypto.gather`, under `crypto.dispatch` on the dispatch thread: the
  kernel launches, one a member, and the decisions brought back (pinned
  output, device-to-host copy, stream wait). The resilient layer has no
  span of its own around the primary's drain: a failed drain is tagged
  `error` on the primary's `crypto.verify_many`.
- `herder.recv_scp_envelope` (cat `scp`, tags `slot`, `state` set on
  return), a root span on the main loop: the whole
  `Herder.recv_scp_envelope` call, the verify's enqueue, a synchronous
  stack's flush and `on_verified` inside it.
- `catchup.load_files` (tag `checkpoint`), in `ApplyCheckpointWork._load`
  itself under the caller's span: one a load, from `on_run` or called
  directly.
- `gc.gen0` / `gc.gen1` / `gc.gen2` (cat `gc`): above.

Threading: span stacks are thread-local (a worker thread's spans nest on
their own stack); the ring append is a deque operation.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import threading
import time
import traceback
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)

DEFAULT_CAPACITY = 16384


class Span:
    """One completed (or in-flight) traced region."""

    __slots__ = ("name", "cat", "t0", "dur", "tags", "tid", "sid",
                 "parent", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 tags: Optional[dict]) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.tags: Optional[dict] = tags
        self.tid = threading.get_ident()
        self.sid = 0
        self.parent = 0
        self.t0 = 0.0
        self.dur: Optional[float] = None   # None while open

    def set_tag(self, key: str, value) -> "Span":
        if self.tags is None:
            self.tags = {}
        self.tags[key] = value
        return self

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.set_tag("error", exc_type.__name__)
        self._tracer._pop(self)
        return False

    def to_dict(self) -> dict:
        d = {"name": self.name, "cat": self.cat, "ts": self.t0,
             "dur": self.dur, "tid": self.tid, "sid": self.sid,
             "parent": self.parent}
        if self.tags:
            d["tags"] = dict(self.tags)
        return d


class _NoopSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_tag(self, key: str, value) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


def tracer_span(tracer, name: str, cat: str = "core", **tags):
    """The single tracer-guard: a span against a possibly-absent,
    possibly-disabled tracer. Every instrumentation site goes through
    this (or the wrappers below) so the enable semantics live in one
    place."""
    if tracer is None or not tracer.enabled:
        return _NOOP
    return tracer.span(name, cat, **tags)


def tracer_instant(tracer, name: str, cat: str = "core", **tags) -> None:
    if tracer is not None and tracer.enabled:
        tracer.instant(name, cat, **tags)


def app_span(app, name: str, cat: str = "core", **tags):
    """Span against `app.tracer`, tolerating apps (test doubles, partial
    wirings) that have no tracer at all — the instrumentation sites must
    never require one."""
    return tracer_span(getattr(app, "tracer", None), name, cat, **tags)


def _collector_hook(ref: "weakref.ref[Tracer]") -> Callable:
    """A `gc.callbacks` entry that records each collection as a
    `gc.gen<N>` span on the tracer `ref` names, directly (never pushed),
    its parent the innermost span open on the collecting thread."""
    t0: List[Optional[float]] = [None]

    def hook(phase: str, info: dict) -> None:
        t = ref()
        if t is None or not t.enabled:
            return
        if phase == "start":
            t0[0] = t._now()
            return
        if t0[0] is None:
            return
        s = Span(t, "gc.gen%d" % info["generation"], "gc",
                 {"collected": info["collected"],
                  "uncollectable": info["uncollectable"]})
        s.t0, t0[0] = t0[0], None
        s.dur = t._now() - s.t0
        s.sid = t._new_sid()
        st = t._stack()
        s.parent = st[-1].sid if st else 0
        t._record(s)
    return hook


def _unhook(hook: Callable) -> None:
    if hook in gc.callbacks:
        gc.callbacks.remove(hook)


class Tracer:
    """Bounded-ring span recorder; see module docstring. With `gc_spans`,
    every cyclic collection while enabled is recorded as a span too."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 now_fn: Callable[[], float] = time.perf_counter,
                 gc_spans: bool = False) -> None:
        self.enabled = False
        self._now = now_fn
        self._buf: deque = deque(maxlen=capacity)
        self._tls = threading.local()
        self._next_sid = 0
        self._sid_lock = threading.Lock()
        self.dropped = 0   # spans evicted from the ring since enable()
        self.gc_spans = gc_spans
        self._gc_unhook: Optional[weakref.finalize] = None

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    # -- lifecycle -----------------------------------------------------------
    def enable(self, capacity: Optional[int] = None) -> None:
        if capacity is not None and capacity != self._buf.maxlen:
            self._buf = deque(self._buf, maxlen=capacity)
        self.dropped = 0
        self.enabled = True
        if self.gc_spans and self._gc_unhook is None:
            hook = _collector_hook(weakref.ref(self))
            gc.callbacks.append(hook)
            # a tracer freed while enabled takes its hook with it
            self._gc_unhook = weakref.finalize(self, _unhook, hook)
            self._gc_unhook.atexit = False

    def disable(self) -> None:
        self.enabled = False
        if self._gc_unhook is not None:
            self._gc_unhook()
            self._gc_unhook = None

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0

    # -- recording -----------------------------------------------------------
    def span(self, name: str, cat: str = "core", **tags):
        """`with tracer.span("close.apply", seq=7):` — returns a shared
        no-op when disabled; tag values must be JSON-serializable."""
        if not self.enabled:
            return _NOOP
        return Span(self, name, cat, tags or None)

    def instant(self, name: str, cat: str = "core", **tags) -> None:
        """Zero-duration marker event (Chrome 'i' phase)."""
        if not self.enabled:
            return
        s = Span(self, name, cat, tags or None)
        s.t0 = self._now()
        s.dur = 0.0
        s.sid = self._new_sid()
        s.parent = self._stack()[-1].sid if self._stack() else 0
        self._record(s)

    def _new_sid(self) -> int:
        with self._sid_lock:
            self._next_sid += 1
            return self._next_sid

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, span: Span) -> None:
        st = self._stack()
        span.sid = self._new_sid()
        span.parent = st[-1].sid if st else 0
        st.append(span)
        span.t0 = self._now()

    def _pop(self, span: Span) -> None:
        span.dur = self._now() - span.t0
        st = self._stack()
        # tolerate mismatched exits (a span leaked across an exception):
        # unwind to and including this span
        while st:
            top = st.pop()
            if top is span:
                break
        self._record(span)

    def _record(self, span: Span) -> None:
        if len(self._buf) == self._buf.maxlen:
            self.dropped += 1
        self._buf.append(span)

    # -- inspection ----------------------------------------------------------
    def spans(self, last_n: Optional[int] = None) -> List[Span]:
        out = list(self._buf)
        if last_n is not None:
            # guard last_n=0: out[-0:] would be the WHOLE list
            out = out[-last_n:] if last_n > 0 else []
        return out

    def open_spans(self) -> List[Span]:
        """In-flight spans on the CALLING thread (flight-recorder dumps
        run on the thread that hit the trigger, which is the interesting
        stack)."""
        return list(self._stack())

    def to_chrome_trace(self, last_n: Optional[int] = None) -> dict:
        """Chrome trace-event JSON (chrome://tracing, Perfetto): complete
        ('X') events with microsecond timestamps, tags under args."""
        events = []
        for s in self.spans(last_n):
            ev = {"name": s.name, "cat": s.cat,
                  "ph": "X" if s.dur else "i",
                  "ts": round(s.t0 * 1e6, 1),
                  "dur": round((s.dur or 0.0) * 1e6, 1),
                  "pid": os.getpid(), "tid": s.tid}
            if s.tags:
                ev["args"] = s.tags
            if ev["ph"] == "i":
                ev["s"] = "t"
                del ev["dur"]
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "dropped_spans": self.dropped}

    # -- phase attribution ---------------------------------------------------
    def phase_breakdown(self, wall_s: Optional[float] = None,
                        phase_of: Optional[Callable[[Span],
                                                    Optional[str]]] = None,
                        ) -> dict:
        """Exclusive per-phase totals from the recorded spans.

        Self-time = span duration minus its direct children's durations,
        so nested spans (verify drains inside an apply span) never double
        count. Default phase key is the span name with a `backend` tag
        appended (`crypto.verify_many:cuda` vs `:cpu`), so device and
        fallback time stay apart. With `wall_s`,
        adds an `untraced` phase (wall minus the dominant thread's root
        spans) so the totals sum to the measured wall exactly on
        single-threaded runs; concurrent worker-thread spans (cuda-async
        dispatches) still report their own self-time, so accounted_s may
        legitimately exceed wall then.
        """
        spans = [s for s in self._buf if s.dur is not None]
        child_time: Dict[int, float] = {}
        for s in spans:
            if s.parent:
                child_time[s.parent] = child_time.get(s.parent, 0.0) + s.dur
        phases: Dict[str, dict] = {}
        root_by_tid: Dict[int, float] = {}
        for s in spans:
            if phase_of is not None:
                key = phase_of(s)
                if key is None:
                    continue
            else:
                key = s.name
                if s.tags and "backend" in s.tags:
                    key = "%s:%s" % (key, s.tags["backend"])
                    # actual backing platform when it differs from the
                    # configured backend — a "cuda" drain on the CPU keys
                    # as crypto.verify_many:cuda@cpu, not as device time
                    plat = s.tags.get("platform")
                    if plat and plat != s.tags["backend"]:
                        key = "%s@%s" % (key, plat)
            self_s = max(0.0, s.dur - child_time.get(s.sid, 0.0))
            p = phases.setdefault(key, {"total_s": 0.0, "count": 0})
            p["total_s"] += self_s
            p["count"] += 1
            if not s.parent:
                root_by_tid[s.tid] = root_by_tid.get(s.tid, 0.0) + s.dur
        out = {"phases": phases, "dropped_spans": self.dropped}
        if wall_s:
            # wall is covered by the DOMINANT thread's roots (the main
            # loop); worker-thread roots run concurrently with it and
            # must not deflate `untraced` (an async-backend dispatch span
            # overlaps a close span — summing both would clamp untraced
            # to 0 and push pct_of_wall past 100)
            root_total = max(root_by_tid.values(), default=0.0)
            untraced = max(0.0, wall_s - root_total)
            phases["untraced"] = {"total_s": untraced, "count": 1}
            out["wall_s"] = wall_s
        total = sum(p["total_s"] for p in phases.values())
        out["accounted_s"] = round(total, 6)
        for p in phases.values():
            p["total_s"] = round(p["total_s"], 6)
            if wall_s:
                p["pct_of_wall"] = round(100.0 * p["total_s"] / wall_s, 2)
        return out


class FlightRecorder:
    """Black box: on a trigger, snapshot the tracer ring + open spans +
    metrics registry to
    `<dir>/sct-flight[-<node>]-<reason>-<t>-<seq>.json` (node name +
    zero-padded app-clock stamp + per-recorder sequence: concurrent
    multi-node chaos runs sharing a directory — and repeat dumps at an
    unchanged virtual clock — never overwrite each other's evidence).
    Dump failures are logged, never raised — the recorder must not turn
    a stall into a crash."""

    def __init__(self, tracer: Tracer, metrics=None,
                 out_dir: Optional[str] = None,
                 max_spans: int = 512,
                 min_interval_s: float = 60.0,
                 node_name: str = "",
                 now_fn: Optional[Callable[[], float]] = None) -> None:
        import tempfile
        self.tracer = tracer
        self.metrics = metrics
        self.out_dir = (out_dir or os.environ.get("SCT_FLIGHT_DIR")
                        or tempfile.gettempdir())
        # node name + app-clock stamp go into every dump filename so
        # concurrent multi-node chaos runs sharing one directory never
        # overwrite each other's incident evidence
        self.node_name = node_name
        self._now = now_fn or time.monotonic
        self.max_spans = max_spans
        # per-reason cooldown: a sustained burst of triggers (every slow
        # close in a slow patch) must not re-serialize the registry on
        # each close nor overwrite the FIRST incident's evidence — the
        # first dump in a burst is the interesting one
        self.min_interval_s = min_interval_s
        self._last_dump_at: Dict[str, float] = {}
        self.dumps = 0
        self.suppressed = 0
        self.last_path: Optional[str] = None

    def dump(self, reason: str, exc: Optional[BaseException] = None,
             extra: Optional[dict] = None,
             force: bool = False) -> Optional[str]:
        try:
            now = time.monotonic()
            last = self._last_dump_at.get(reason)
            if not force and last is not None and \
                    now - last < self.min_interval_s:
                self.suppressed += 1
                return None
            self._last_dump_at[reason] = now
            blob = {
                "reason": reason,
                "at_unix": int(time.time()),
                "pid": os.getpid(),
                "spans": [s.to_dict()
                          for s in self.tracer.spans(self.max_spans)],
                "open_spans": [s.to_dict()
                               for s in self.tracer.open_spans()],
                "dropped_spans": self.tracer.dropped,
                "tracing_enabled": self.tracer.enabled,
            }
            if exc is not None:
                blob["exception"] = {
                    "type": type(exc).__name__,
                    "message": str(exc),
                    "traceback": traceback.format_exception(
                        type(exc), exc, exc.__traceback__),
                }
            if self.metrics is not None:
                blob["metrics"] = self.metrics.to_json()
            if extra:
                blob["extra"] = extra
            def _safe(s: str) -> str:
                return "".join(c if c.isalnum() or c in "-_" else "-"
                               for c in s)
            parts = ["sct-flight"]
            if self.node_name:
                parts.append(_safe(self.node_name))
            parts.append(_safe(reason))
            # app-clock stamp + per-recorder sequence: two forced dumps
            # at an UNCHANGED virtual clock must still get distinct
            # paths, or the second overwrites the first's evidence
            parts.append("%012.3f" % max(0.0, self._now()))
            parts.append("%03d" % self.dumps)
            path = os.path.join(self.out_dir,
                                "-".join(parts) + ".json")
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(blob, fh, indent=1, default=repr)
            os.replace(tmp, path)
            self.dumps += 1
            self.last_path = path
            log.warning("flight recorder dumped %r to %s", reason, path)
            return path
        except Exception as e:   # noqa: BLE001 - recorder never raises
            log.error("flight recorder dump failed: %s", e)
            return None
