"""Helpers the per-layer metric readers share. Each takes what the run
recorded (see `portbench.run.Context`) and returns a number, or None when
there is nothing to read."""

from __future__ import annotations

from typing import Optional


def durations(spans, name: str) -> list:
    return [b - a for (n, a, b, _tid) in spans if n == name]


def mean_ms(values) -> Optional[float]:
    values = list(values)
    return 1e3 * sum(values) / len(values) if values else None


def span_mean_ms(spans, name: str) -> Optional[float]:
    """Mean duration of the spans called `name`, in ms."""
    return mean_ms(durations(spans, name))


def less_children_ms(outer, inner, child: str) -> Optional[float]:
    """Mean, over the `outer` spans (name, start, end[, tid]), of each
    one's duration less the `child` spans of `inner` inside it."""
    kids = sorted((a, b) for (n, a, b, _t) in inner if n == child)
    out = []
    for s in outer:
        a, b = s[1], s[2]
        out.append((b - a) - sum(y - x for (x, y) in kids
                                 if x >= a and y <= b))
    return mean_ms(out)


def idle_pct(trace) -> Optional[float]:
    """The card's idle share of a traced window."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 - 100.0 * trace.busy_s / trace.window_s
