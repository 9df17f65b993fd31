"""The app clock: VirtualClock, VirtualTimer, and the sanctioned real clock.

Copied (`ClockMode`, `real_monotonic`, `VirtualClock`, `VirtualTimer`)
from `stellar_core_tpu/util/timer.py` at commit a29fd1b; carry a fix in
either copy to the other.

`VirtualClock` either tracks real time or runs fully virtual,
deterministic time (tests), with an event queue cranked from the main
thread and cancellable timers. Work that touches the caller's state runs
on the thread that cranks the clock; worker threads post their
completions back through `post_to_main` (the async verifier's dispatch
worker does).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time as _time
from collections import deque
from enum import Enum
from typing import Callable, Optional


class ClockMode(Enum):
    REAL_TIME = 0
    VIRTUAL_TIME = 1


def real_monotonic() -> float:
    """Wall-clock monotonic seconds: for code that measures real elapsed
    time with no app clock injected (breaker defaults, staging overlap)."""
    return _time.monotonic()


class _Event:
    __slots__ = ("when", "seq", "fn", "cancelled")

    def __init__(self, when: float, seq: int, fn: Callable[[], None]) -> None:
        self.when = when
        self.seq = seq
        self.fn = fn
        self.cancelled = False

    def __lt__(self, other: "_Event") -> bool:
        return (self.when, self.seq) < (other.when, other.seq)


class VirtualClock:
    """Deterministic (virtual) or real-time event loop.

    - `post(fn)`: run fn on the next crank (FIFO "action queue").
    - `post_to_main(fn)`: thread-safe variant for worker threads.
    - timers via VirtualTimer.
    - `crank(block)`: run due actions/timers; in VIRTUAL mode, if nothing is
      due and timers exist, time jumps to the next deadline.
    """

    def __init__(self, mode: ClockMode = ClockMode.VIRTUAL_TIME) -> None:
        self.mode = mode
        self._virtual_now = 0.0
        self._seq = itertools.count()
        self._timers: list[_Event] = []
        self._actions: deque[Callable[[], None]] = deque()
        self._xq_lock = threading.Lock()
        self._xq: deque[Callable[[], None]] = deque()
        self._stopped = False

    # -- time ---------------------------------------------------------------
    def now(self) -> float:
        if self.mode == ClockMode.REAL_TIME:
            return _time.monotonic()
        return self._virtual_now

    def system_now(self) -> int:
        """Wall-clock seconds (close times). Virtual mode derives it from
        virtual time so tests are deterministic."""
        if self.mode == ClockMode.REAL_TIME:
            return int(_time.time())
        return int(self._virtual_now)

    def set_virtual_time(self, t: float) -> None:
        assert self.mode == ClockMode.VIRTUAL_TIME
        assert t >= self._virtual_now
        self._virtual_now = t

    # -- scheduling ---------------------------------------------------------
    def post(self, fn: Callable[[], None]) -> None:
        self._actions.append(fn)

    def post_to_main(self, fn: Callable[[], None]) -> None:
        with self._xq_lock:
            self._xq.append(fn)

    def _schedule(self, when: float, fn: Callable[[], None]) -> _Event:
        ev = _Event(when, next(self._seq), fn)
        heapq.heappush(self._timers, ev)
        return ev

    # -- crank --------------------------------------------------------------
    def _drain_cross_thread(self) -> None:
        with self._xq_lock:
            while self._xq:
                self._actions.append(self._xq.popleft())

    def crank(self, block: bool = False) -> int:
        """Run pending work. Returns number of handlers executed."""
        if self._stopped:
            return 0
        n = 0
        self._drain_cross_thread()

        # run all queued actions (they may enqueue more; run snapshot)
        for _ in range(len(self._actions)):
            fn = self._actions.popleft()
            fn()
            n += 1

        # fire due timers
        nowt = self.now()
        while self._timers and self._timers[0].when <= nowt:
            ev = heapq.heappop(self._timers)
            if not ev.cancelled:
                ev.fn()
                n += 1

        if n:
            return n

        # nothing due: advance (virtual) or wait (real) if blocking
        self._prune_cancelled()
        if self._timers:
            nxt = self._timers[0].when
            if self.mode == ClockMode.VIRTUAL_TIME:
                self._virtual_now = max(self._virtual_now, nxt)
                while self._timers and self._timers[0].when <= self._virtual_now:
                    ev = heapq.heappop(self._timers)
                    if not ev.cancelled:
                        ev.fn()
                        n += 1
            elif block:
                _time.sleep(min(max(nxt - nowt, 0.0), 0.050))
        elif block and self.mode == ClockMode.REAL_TIME:
            _time.sleep(0.001)
        return n

    def crank_ready(self) -> int:
        """Run queued actions and already-due timers WITHOUT advancing
        virtual time (used by manual-close style synchronous drains)."""
        if self._stopped:
            return 0
        n = 0
        self._drain_cross_thread()
        for _ in range(len(self._actions)):
            self._actions.popleft()()
            n += 1
        nowt = self.now()
        while self._timers and self._timers[0].when <= nowt:
            ev = heapq.heappop(self._timers)
            if not ev.cancelled:
                ev.fn()
                n += 1
        return n

    def _prune_cancelled(self) -> None:
        if self._timers and all(e.cancelled for e in self._timers):
            self._timers.clear()

    def stop(self) -> None:
        self._stopped = True

    @property
    def stopped(self) -> bool:
        return self._stopped


class VirtualTimer:
    """Cancellable one-shot timer bound to a VirtualClock.

    Role parity: reference VirtualTimer (src/util/Timer.h:244): expires_at /
    expires_from_now + async_wait(on_fire, on_cancel); cancel() invokes the
    error handler (reference passes asio error codes; we pass a flag).
    """

    def __init__(self, clock: VirtualClock) -> None:
        self._clock = clock
        self._ev: Optional[_Event] = None
        self._deadline = 0.0

    @property
    def deadline(self) -> float:
        return self._deadline

    def expires_from_now(self, delay: float) -> None:
        self.cancel()
        self._deadline = self._clock.now() + delay

    def expires_at(self, when: float) -> None:
        self.cancel()
        self._deadline = when

    def async_wait(self, on_fire: Callable[[], None],
                   on_cancel: Optional[Callable[[], None]] = None) -> None:
        self.cancel()
        ev_holder = {}

        def fire() -> None:
            if ev_holder["ev"].cancelled:
                return
            self._ev = None
            on_fire()

        ev = self._clock._schedule(self._deadline, fire)
        ev_holder["ev"] = ev
        self._ev = ev
        self._on_cancel = on_cancel

    def cancel(self) -> None:
        if self._ev is not None:
            self._ev.cancelled = True
            self._ev = None
            cb = getattr(self, "_on_cancel", None)
            self._on_cancel = None
            if cb is not None:
                cb()

    @property
    def seated(self) -> bool:
        return self._ev is not None
