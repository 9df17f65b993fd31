"""The device's side of a traced window, from `torch.profiler` (CUDA
activity): the union of every device interval (copied from the port's
`chip_smoke.py::profile_drain`, whose arithmetic it freezes), device time
by name, and the idle gaps between device intervals, each named by what
the host was doing then.

A marker kernel launched at a known host time aligns the profiler's clock
with the host's `time.perf_counter`, so that gaps can be named by spans.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class DeviceTrace:
    t0: float                            # the traced window, host clock
    window_s: float
    busy_s: float                        # union of device activity
    intervals: List[Tuple[float, float]] = field(default_factory=list)
    seconds_by_name: dict = field(default_factory=dict)
    launches_by_name: dict = field(default_factory=dict)

    def kernel_time(self, part: str) -> Tuple[float, int]:
        """Seconds and launches of the operations whose name holds `part`."""
        s = sum(v for k, v in self.seconds_by_name.items() if part in k)
        n = sum(v for k, v in self.launches_by_name.items() if part in k)
        return s, n


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


class Profiled:
    """`with Profiled() as p: ...` records the card's activity over the
    block; `p.trace` is then a DeviceTrace on the host's clock."""

    def __enter__(self) -> "Profiled":
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._marker = torch.ones(1, device="cuda")
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t_marker = time.perf_counter()
        self._marker.mul_(2.0)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.trace: Optional[DeviceTrace] = None
        return self

    def __exit__(self, *exc) -> bool:
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        dev = [e for e in self._prof.events()
               if e.device_type == DeviceType.CUDA]
        # the first device event is the marker's multiply: its start is
        # the marker's host time plus a launch, which the alignment takes
        # as nought
        dev.sort(key=lambda e: e.time_range.start)
        off = 0.0
        if dev:
            off = self._t_marker - dev[0].time_range.start * 1e-6
            dev = dev[1:]
        iv = [(e.time_range.start * 1e-6 + off,
               e.time_range.end * 1e-6 + off) for e in dev]
        by_name: dict = {}
        launches: dict = {}
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() * 1e-6
            launches[e.name] = launches.get(e.name, 0) + 1
        self.trace = DeviceTrace(
            t0=self.t0, window_s=t1 - self.t0, busy_s=union_s(iv),
            intervals=sorted(iv), seconds_by_name=by_name,
            launches_by_name=launches)
        return False


def idle_gaps(trace: DeviceTrace, spans,
              top: int = 10) -> List[Tuple[str, float]]:
    """The longest stretches of the traced window in which the card ran
    nothing, each named by the innermost span (name, start, end) the host
    was in then, or "untraced": a gap is cut where the innermost span
    changes, and the pieces of one gap under one name are summed."""
    t0, t1 = trace.t0, trace.t0 + trace.window_s
    gaps = []
    prev = t0
    for a, b in trace.intervals:
        if a > prev:
            gaps.append((prev, min(a, t1)))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    pieces = []
    for a, b in gaps:
        inside = [(n, s, e) for (n, s, e) in spans if s < b and e > a]
        cuts = sorted({a, b} | {x for (_n, s, e) in inside
                                for x in (s, e) if a < x < b})
        named: dict = {}
        for x, y in zip(cuts, cuts[1:]):
            mid = (x + y) / 2
            cover = [(e - s, n) for (n, s, e) in inside if s <= mid <= e]
            name = min(cover)[1] if cover else "untraced"
            named[name] = named.get(name, 0.0) + (y - x)
        pieces += named.items()
    pieces.sort(key=lambda kv: -kv[1])
    return pieces[:top]
