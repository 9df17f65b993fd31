"""Work trees: Work (children), WorkSequence, BatchWork, ConditionalWork.

Copied from `stellar_core_tpu/work/work.py` at commit 9a356c0; carry a
fix in either copy to the other.

Role parity: reference `src/work/Work.{h,cpp}`, `WorkSequence.cpp`,
`BatchWork.cpp` (bounded-concurrency yieldMoreWork), `ConditionalWork.cpp`.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

from .basic_work import FAILURE, RUNNING, SUCCESS, WAITING, BasicWork, State


class Work(BasicWork):
    """A work node with children: runs children to completion (cranking one
    pending child per step), then does its own do_work."""

    def __init__(self, clock, name, max_retries=5) -> None:
        super().__init__(clock, name, max_retries)
        self.children: List[BasicWork] = []

    def add_work(self, w: BasicWork) -> BasicWork:
        w._parent = self
        self.children.append(w)
        if w.state == State.PENDING:
            w.start()
        return w

    def on_reset(self) -> None:
        self.children.clear()
        self.do_reset()

    def do_reset(self) -> None:
        pass

    def do_work(self) -> State:
        return SUCCESS

    def _any_failed(self) -> bool:
        return any(c.state in (State.FAILURE, State.ABORTED)
                   for c in self.children)

    def _all_done(self) -> bool:
        return all(c.is_done() for c in self.children)

    def on_run(self) -> State:
        for c in self.children:
            if c.is_crankable():
                c.crank_work()
                break
        if self._any_failed():
            return FAILURE
        if self._all_done():
            return self.do_work()
        # every live child is WAITING/RETRYING: park; their wake_up (or
        # retry timer) propagates up and re-arms this work — busy-cranking
        # here would pin the virtual clock and starve those very timers
        if any(c.is_crankable() for c in self.children):
            return RUNNING
        return WAITING


class WorkSequence(BasicWork):
    """Children executed strictly in order (reference WorkSequence)."""

    def __init__(self, clock, name, sequence: List[BasicWork],
                 max_retries=5) -> None:
        super().__init__(clock, name, max_retries)
        self.sequence = sequence
        self._idx = 0
        for w in sequence:
            w._parent = self

    def on_reset(self) -> None:
        self._idx = 0
        for w in self.sequence:
            if w.is_done():
                w.state = State.PENDING   # re-armed on next on_run

    def on_run(self) -> State:
        if self._idx >= len(self.sequence):
            return SUCCESS
        cur = self.sequence[self._idx]
        if cur.state == State.PENDING:
            cur._parent = self
            cur.start()
        if not cur.is_done():
            cur.crank_work()
            if not cur.is_done():
                # park while the child WAITs/RETRIes; its wake_up (or
                # retry timer) re-arms this sequence
                return RUNNING if cur.is_crankable() else WAITING
        if cur.state != State.SUCCESS:
            return FAILURE
        self._idx += 1
        return RUNNING if self._idx < len(self.sequence) else SUCCESS


class BatchWork(Work):
    """Bounded-concurrency batch: keeps up to `max_concurrent` children
    running, pulling new ones from yield_more_work (reference BatchWork)."""

    def __init__(self, clock, name, max_concurrent: int = 8,
                 max_retries=5) -> None:
        super().__init__(clock, name, max_retries)
        self.max_concurrent = max_concurrent
        self._exhausted = False

    def yield_more_work(self) -> Optional[BasicWork]:
        raise NotImplementedError

    def on_reset(self) -> None:
        self.children.clear()
        self._exhausted = False
        self.do_reset()

    def on_run(self) -> State:
        # harvest finished, fail fast
        if self._any_failed():
            return FAILURE
        self.children = [c for c in self.children if not c.is_done()]
        while not self._exhausted and \
                len(self.children) < self.max_concurrent:
            w = self.yield_more_work()
            if w is None:
                self._exhausted = True
                break
            self.add_work(w)
        for c in self.children:
            if c.is_crankable():
                c.crank_work()
        if self.children:
            if any(c.is_crankable() or c.is_done() for c in self.children):
                return RUNNING   # finished children are harvested next crank
            return WAITING       # all blocked; children wake us
        return self.do_work() if self._exhausted else RUNNING


class ConditionalWork(BasicWork):
    """Runs inner work once a condition becomes true (reference
    ConditionalWork)."""

    # re-check cadence while parked on a false condition (reference
    # ConditionalWork sleepDelay); virtual seconds cost nothing in tests
    POLL_DELAY = 0.1

    def __init__(self, clock, name, condition: Callable[[], bool],
                 inner: BasicWork) -> None:
        super().__init__(clock, name, 0)
        self.condition = condition
        self.inner = inner
        self._condition_met = False   # latched once true (reference
        inner._parent = self          # ConditionalWork clears mConditionFn)
        from ..util.timer import VirtualTimer
        self._poll_timer = VirtualTimer(clock)

    def on_reset(self) -> None:
        self._condition_met = False
        if self.inner.is_done():
            self.inner.state = State.PENDING   # re-armed when gate opens

    def on_run(self) -> State:
        if not self._condition_met:
            if not self.condition():
                # park instead of busy-polling (the poll would pin the
                # scheduler and starve sibling retry timers); the timer
                # re-checks on a cadence
                self._poll_timer.expires_from_now(self.POLL_DELAY)
                self._poll_timer.async_wait(self.wake_up)
                return WAITING
            self._condition_met = True
        if self.inner.state == State.PENDING:
            self.inner.start()
        if not self.inner.is_done():
            self.inner.crank_work()
            if not self.inner.is_done():
                return RUNNING if self.inner.is_crankable() else WAITING
        return SUCCESS if self.inner.state == State.SUCCESS else FAILURE


class FunctionWork(BasicWork):
    """Small adapter: run a callable once (used by tests and simple steps)."""

    def __init__(self, clock, name, fn: Callable[[], bool],
                 max_retries=0) -> None:
        super().__init__(clock, name, max_retries)
        self.fn = fn

    def on_run(self) -> State:
        return SUCCESS if self.fn() else FAILURE
