"""WorkScheduler: cranks the work tree one step per main-loop turn.

Copied from `stellar_core_tpu/work/scheduler.py` at commit 9a356c0; carry
a fix in either copy to the other.

Role parity: reference `src/work/WorkScheduler.cpp:39-69` — posts a single
crank to the io_context per turn so long work trees never starve consensus.
"""

from __future__ import annotations

from typing import List, Optional

from ..util.timer import VirtualClock
from .basic_work import BasicWork, State


class WorkScheduler:
    def __init__(self, clock: VirtualClock) -> None:
        self.clock = clock
        self._roots: List[BasicWork] = []
        self._scheduled = False

    def schedule_work(self, work: BasicWork, on_done=None) -> BasicWork:
        work.start(on_done)
        work.set_wake_cb(self._schedule_crank)
        self._roots.append(work)
        self._schedule_crank()
        return work

    def _schedule_crank(self) -> None:
        if self._scheduled:
            return
        self._scheduled = True
        self.clock.post(self._crank)

    def _crank(self) -> None:
        self._scheduled = False
        live = [w for w in self._roots if not w.is_done()]
        for w in live:
            w.crank_work()
        self._roots = [w for w in self._roots if not w.is_done()]
        # repost only while a root can actually take a step: parked
        # (WAITING/RETRYING) roots re-arm via their wake_cb, and an idle
        # action queue is what lets the virtual clock advance to the
        # retry/backoff timers those roots are sleeping on
        if any(w.is_crankable() for w in self._roots):
            self._schedule_crank()

    def all_done(self) -> bool:
        return not self._roots

    def abort_all(self) -> None:
        for w in self._roots:
            w.abort()
        self._schedule_crank()
