"""Metrics registry: counters, gauges, meters, timers, histograms.

Copied from `stellar_core_tpu/util/metrics.py` at commit d7c5801; carry
a fix in either copy to the other. Nothing is left out: the registry, its
metric types, and the Prometheus exposition with its HELP catalog (the
admin `metrics?format=prometheus` path). Deliberately different: the
catalog is read from `docs/metrics.md` and `docs/metrics-torch.md`, which
documents the metrics only the port registers (its card stacks refuse or
requeue a drain where the reference falls back to the CPU). Metric names and JSON shapes are the
reference's, so `verifier.device.<i>.drains`, `verifier.device.<i>.breaker`
and the rest read the same on both stacks.

Role parity: reference libmedida — a per-app registry exported as JSON.
Rates come from a sliding window rather than EWMA; percentiles from a
bounded reservoir.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple


class Counter:
    def __init__(self) -> None:
        self.count = 0

    def inc(self, n: int = 1) -> None:
        self.count += n

    def dec(self, n: int = 1) -> None:
        self.count -= n

    def set_count(self, n: int) -> None:
        self.count = n

    def to_json(self) -> dict:
        return {"type": "counter", "count": self.count}


class Gauge:
    """Point-in-time value (queue depth, warmup state, occupancy): `set`
    overwrites; there is no history."""

    def __init__(self) -> None:
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def to_json(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Meter:
    """Event-rate meter. Events aggregate into per-second buckets held in
    a deque, so mark() is O(1) amortized and memory is bounded by the
    15-minute window regardless of event rate."""

    def __init__(self, now_fn: Callable[[], float]) -> None:
        self._now = now_fn
        self.count = 0
        self._buckets: Deque[tuple[int, int]] = deque()  # (sec, n)

    def mark(self, n: int = 1) -> None:
        self.count += n
        sec = int(self._now())
        b = self._buckets
        if b and b[-1][0] == sec:
            b[-1] = (sec, b[-1][1] + n)
        else:
            b.append((sec, n))
            self._prune(sec)

    def _prune(self, sec: int) -> None:
        cutoff = sec - 900
        b = self._buckets
        while b and b[0][0] < cutoff:
            b.popleft()

    def rate(self, window: float) -> float:
        t = self._now()
        # prune on reads too: an idle meter decays to 0
        self._prune(int(t))
        total = sum(n for (sec, n) in self._buckets if sec >= t - window)
        return total / window if window > 0 else 0.0

    def one_minute_rate(self) -> float:
        return self.rate(60.0)

    def to_json(self) -> dict:
        return {"type": "meter", "count": self.count,
                "1_min_rate": self.one_minute_rate(),
                "5_min_rate": self.rate(300.0),
                "15_min_rate": self.rate(900.0)}


class Histogram:
    MAX_SAMPLES = 1028

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._samples: List[float] = []
        self._i = 0
        # worker threads (verify dispatch, staging) update while another
        # thread exports: the lock makes count/sum/reservoir one cut
        self._lock = threading.Lock()

    def update(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._samples) < self.MAX_SAMPLES:
                self._samples.append(v)
            else:
                # deterministic ring replacement keeps a recent-biased
                # reservoir
                self._samples[self._i % self.MAX_SAMPLES] = v
                self._i += 1

    @staticmethod
    def _pick(sorted_samples: List[float], q: float) -> float:
        if not sorted_samples:
            return 0.0
        idx = min(int(q * len(sorted_samples)), len(sorted_samples) - 1)
        return sorted_samples[idx]

    def percentile(self, q: float) -> float:
        return self._pick(sorted(self._samples), q)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        """Atomic export: count/sum/min/max and the reservoir are
        captured under the update lock, then sorted outside it, so the
        quantiles describe exactly the population `count` reports."""
        with self._lock:
            count, total = self.count, self.total
            mn, mx = self.min, self.max
            samples = list(self._samples)
        s = sorted(samples)
        return {"count": count, "sum": total,
                "mean": (total / count) if count else 0.0,
                "min": mn or 0.0, "max": mx or 0.0,
                "median": self._pick(s, 0.5), "p75": self._pick(s, 0.75),
                "p95": self._pick(s, 0.95), "p99": self._pick(s, 0.99)}

    def to_json(self) -> dict:
        snap = self.snapshot()
        del snap["sum"]
        return {"type": "histogram", **snap}


class Timer(Histogram):
    """Histogram of durations (seconds), measured with the registry's
    injected `now_fn` (`perf_counter` when none was injected)."""

    def __init__(self, now_fn: Callable[[], float] | None = None) -> None:
        super().__init__()
        self._now = now_fn or time.perf_counter

    class _Ctx:
        def __init__(self, t: "Timer") -> None:
            self._t = t

        def __enter__(self):
            self._start = self._t._now()
            return self

        def __exit__(self, *exc):
            self._t.update(self._t._now() - self._start)
            return False

    def time(self) -> "Timer._Ctx":
        return Timer._Ctx(self)

    def to_json(self) -> dict:
        d = super().to_json()
        d["type"] = "timer"
        return d


class MetricsRegistry:
    def __init__(self, now_fn: Callable[[], float] | None = None) -> None:
        self._now = now_fn or time.monotonic
        # timers measure with the injected clock; with no injection they
        # keep perf_counter
        self._timer_now = now_fn
        self._metrics: Dict[str, object] = {}
        # first-use registration can happen on worker threads while
        # another thread exports; the already-registered path stays a
        # lock-free dict get
        self._reg_lock = threading.Lock()

    def _get(self, name: str, factory):
        m = self._metrics.get(name)
        if m is None:
            with self._reg_lock:
                m = self._metrics.get(name)
                if m is None:
                    m = factory()
                    self._metrics[name] = m
        return m

    def new_counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def new_gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def new_meter(self, name: str) -> Meter:
        return self._get(name, lambda: Meter(self._now))

    def new_timer(self, name: str) -> Timer:
        return self._get(name, lambda: Timer(self._timer_now))

    def new_histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def to_json(self, prefix: str | None = None) -> dict:
        """Export the registry; with `prefix`, only metrics whose name
        starts with it."""
        with self._reg_lock:
            items = list(self._metrics.items())
        return {name: m.to_json()
                for name, m in sorted(items)
                if prefix is None or name.startswith(prefix)}


# -- Prometheus text exposition (docs/metrics.md#prometheus-exposition) ------
#
# `metrics?format=prometheus` renders the registry (plus the merged
# crypto-boundary extras) in text exposition format 0.0.4 so real
# deployments scrape nodes with stock Prometheus. The renderer consumes
# the *JSON* export, not live metric objects: whatever the JSON endpoint
# says is exactly what Prometheus sees, and the count/quantile pairs
# come from one atomic Histogram.snapshot().

def prometheus_name(name: str, prefix: str = "sct_") -> str:
    """Name mangling: lowercase, every char outside [a-z0-9_] becomes
    `_`, `sct_` namespace prefix, leading digits guarded. Documented in
    docs/metrics.md — the drift-guard test keeps the catalog honest."""
    out = "".join(c if (c.isascii() and (c.isalnum() or c == "_"))
                  else "_" for c in name.lower())
    if out and out[0].isdigit():
        out = "_" + out
    return prefix + out


def _num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


# -- HELP catalog (docs/metrics.md -> `# HELP` lines) -------------------------
#
# Real Prometheus/Grafana setups expect self-describing scrapes. The
# HELP text is sourced from the docs/metrics.md catalog tables (the same
# file the M1 drift guard keeps complete), parsed once per process:
# exact names map directly, dynamic names (`fault.injected.<site>`) map
# by the literal prefix before the first `<...>` placeholder.

class HelpCatalog:
    def __init__(self, exact: Dict[str, str],
                 prefixes: List[Tuple[str, str, str]]) -> None:
        self.exact = exact
        # (prefix, suffix, text), most-specific-first: families that
        # share a placeholder prefix (`overlay.recv.<type>.count` vs
        # `.bytes`) are distinguished by the literal after the
        # placeholder
        self.prefixes = sorted(
            prefixes, key=lambda kv: -(len(kv[0]) + len(kv[1])))

    def lookup(self, name: str) -> Optional[str]:
        t = self.exact.get(name)
        if t is not None:
            return t
        for prefix, suffix, text in self.prefixes:
            if name.startswith(prefix) and name.endswith(suffix) and \
                    len(name) > len(prefix) + len(suffix):
                return text
        return None


_HELP_CATALOG: Optional[HelpCatalog] = None


def _strip_markdown(cell: str) -> str:
    out = cell.replace("\\|", "|").replace("`", "")
    out = re.sub(r"\[([^\]]*)\]\([^)]*\)", r"\1", out)   # [text](link)
    return " ".join(out.split())


def load_help_catalog(path: Optional[str] = None) -> HelpCatalog:
    """Parse the catalog tables into {metric: help-text}: `docs/metrics.md`
    and `docs/metrics-torch.md` (the metrics only the port registers), or
    the one file at `path`. Cached after the first call (the docs ship
    with the package); a missing or unreadable file degrades to an empty
    catalog — the exposition then falls back to the metric name itself."""
    global _HELP_CATALOG
    if _HELP_CATALOG is not None and path is None:
        return _HELP_CATALOG
    cache = path is None
    if path is None:
        docs = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "docs")
        paths = [os.path.join(docs, "metrics.md"),
                 os.path.join(docs, "metrics-torch.md")]
    else:
        paths = [path]
    exact: Dict[str, str] = {}
    prefixes: List[Tuple[str, str, str]] = []
    for p in paths:
        try:
            with open(p, encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            text = ""
        _parse_catalog(text, exact, prefixes)
    catalog = HelpCatalog(exact, prefixes)
    if cache:
        _HELP_CATALOG = catalog
    return catalog


def _parse_catalog(text: str, exact: Dict[str, str],
                   prefixes: List[Tuple[str, str, str]]) -> None:
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("|"):
            continue
        cells = re.split(r"(?<!\\)\|", line.strip("|"))
        if len(cells) < 3:
            continue
        names = re.findall(r"`([^`]+)`", cells[0])
        meaning = _strip_markdown(cells[-1])
        if not meaning or meaning.lower() == "meaning":
            continue
        for name in names:
            name = name.strip()
            if not name or name.startswith((".", "-")):
                continue   # shorthand continuation like `-miss`
            if "<" in name:
                prefix = name.split("<", 1)[0]
                suffix = name.rsplit(">", 1)[-1] if ">" in name else ""
                prefixes.append((prefix, suffix, meaning))
            else:
                exact[name] = meaning


def _help_text(s: str) -> str:
    # exposition-format escaping for HELP lines
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def render_prometheus(metrics_json: Dict[str, dict],
                      prefix: str = "sct_",
                      help_catalog: Optional[HelpCatalog] = None) -> str:
    """Registry JSON -> exposition text. Mapping:

    - counter / gauge      -> gauge (medida counters can be set/decremented)
    - meter                -> `<n>_total` counter + `<n>_rate{window="1m|5m|15m"}` gauges
    - timer / histogram    -> summary (`quantile` labels, `_sum`, `_count`)
                              + `<n>_min` / `<n>_max` gauges
    - bare `{count: N}`    -> gauge (the merged crypto-boundary extras)

    Two source names that mangle to the same series keep only the
    first (sorted source order); the duplicate is emitted as a comment
    so the collision is visible in the scrape body.

    With `help_catalog` (the admin endpoint passes the docs/metrics.md
    catalog), every `# TYPE` line is preceded by a `# HELP` line whose
    text comes from the catalog where available, falling back to the
    source metric name — real Prometheus/Grafana setups then get
    self-describing scrapes.
    """
    lines: List[str] = []
    emitted: set = set()
    q_map = (("0.5", "median"), ("0.75", "p75"),
             ("0.95", "p95"), ("0.99", "p99"))
    for name in sorted(metrics_json):
        m = metrics_json[name]
        base = prometheus_name(name, prefix)
        t = m.get("type")
        help_text = None
        if help_catalog is not None:
            help_text = _help_text(help_catalog.lookup(name) or name)

        def _help(series: str) -> None:
            if help_text is not None:
                lines.append("# HELP %s %s" % (series, help_text))
        # reserve every series this metric will emit, not just the base:
        # a counter named "foo.total" must not collide with meter "foo"'s
        # generated `foo_total` either
        if t == "meter":
            series = {base + "_total", base + "_rate"}
        elif t in ("timer", "histogram"):
            series = {base, base + "_sum", base + "_count",
                      base + "_min", base + "_max"}
        else:
            series = {base}
        if series & emitted:
            lines.append("# collision: %s maps onto already-emitted "
                         "series %s (skipped)"
                         % (name, sorted(series & emitted)))
            continue
        emitted |= series
        if t == "meter":
            _help(base + "_total")
            lines.append("# TYPE %s_total counter" % base)
            lines.append("%s_total %s" % (base, _num(m["count"])))
            _help(base + "_rate")
            lines.append("# TYPE %s_rate gauge" % base)
            for w, k in (("1m", "1_min_rate"), ("5m", "5_min_rate"),
                         ("15m", "15_min_rate")):
                lines.append('%s_rate{window="%s"} %s'
                             % (base, w, _num(m.get(k, 0.0))))
        elif t in ("timer", "histogram"):
            _help(base)
            lines.append("# TYPE %s summary" % base)
            for q, k in q_map:
                lines.append('%s{quantile="%s"} %s'
                             % (base, q, _num(m.get(k, 0.0))))
            # sum reconstructed from the same snapshot's mean*count —
            # still tear-free because both came from one snapshot()
            lines.append("%s_sum %s" % (
                base, _num(m.get("mean", 0.0) * m.get("count", 0))))
            lines.append("%s_count %s" % (base, _num(m.get("count", 0))))
            for k in ("min", "max"):
                _help("%s_%s" % (base, k))
                lines.append("# TYPE %s_%s gauge" % (base, k))
                lines.append("%s_%s %s" % (base, k, _num(m.get(k, 0.0))))
        elif t == "gauge":
            _help(base)
            lines.append("# TYPE %s gauge" % base)
            lines.append("%s %s" % (base, _num(m.get("value", 0.0))))
        elif "count" in m:   # counter or merged bare-count extra
            _help(base)
            lines.append("# TYPE %s gauge" % base)
            lines.append("%s %s" % (base, _num(m["count"])))
        # anything else (malformed entry) is skipped silently: the JSON
        # endpoint remains the lossless export
    return "\n".join(lines) + "\n"
