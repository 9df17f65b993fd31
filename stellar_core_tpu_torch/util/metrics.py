"""Metrics registry: counters, gauges, meters, timers, histograms.

Copied (the registry and the parts of its metric types the verifier
uses; not the Prometheus exposition or its HELP catalog) from
`stellar_core_tpu/util/metrics.py` at commit 02ed56d; carry a fix in
either copy to the other. Metric names and JSON
shapes are the reference's, so `verifier.device.<i>.drains`,
`verifier.device.<i>.breaker` and the rest read the same on both stacks.

Role parity: reference libmedida — a per-app registry exported as JSON.
Rates come from a sliding window rather than EWMA; percentiles from a
bounded reservoir.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List


class Counter:
    def __init__(self) -> None:
        self.count = 0

    def inc(self, n: int = 1) -> None:
        self.count += n

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
