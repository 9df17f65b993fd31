"""BasicWork: cooperative async job state machine.

Copied from `stellar_core_tpu/work/basic_work.py` at commit 9a356c0;
carry a fix in either copy to the other.

Role parity: reference `src/work/BasicWork.{h,cpp}:25-106` — states
PENDING/RUNNING/WAITING/SUCCESS/FAILURE/RETRYING/ABORTING with bounded
retries and exponential backoff; `wakeUp` re-arms WAITING work; one
`onRun` step per crank keeps the main thread responsive. A raising
`on_run` is a FAILURE (`crank_work`), so a checkpoint drain that fails on
the card fails its work.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable, Optional

from ..util.log import get_logger
from ..util.timer import VirtualClock, VirtualTimer

log = get_logger("Work")


class State(Enum):
    PENDING = 0
    RUNNING = 1
    WAITING = 2
    SUCCESS = 3
    FAILURE = 4
    RETRYING = 5
    ABORTING = 6
    ABORTED = 7


# what on_run may return
RUNNING = State.RUNNING
WAITING = State.WAITING
SUCCESS = State.SUCCESS
FAILURE = State.FAILURE


RETRY_NEVER = 0
RETRY_ONCE = 1
RETRY_A_FEW = 5
RETRY_A_LOT = 32


class BasicWork:
    # decorrelated-jitter retry backoff (docs/robustness.md): delay_k is
    # uniform in [BASE, 3 * delay_{k-1}], capped — a fleet of works that
    # failed on one shared cause (archive outage, dead peer) desyncs
    # instead of re-firing as a synchronized retry storm
    RETRY_BACKOFF_BASE = 0.5
    RETRY_BACKOFF_CAP = 256.0

    def __init__(self, clock: VirtualClock, name: str,
                 max_retries: int = RETRY_A_FEW) -> None:
        self.clock = clock
        self.name = name
        self.max_retries = max_retries
        self.retries = 0
        self.state = State.PENDING
        self._retry_timer = VirtualTimer(clock)
        self._last_retry_delay = 0.0
        self._on_done: Optional[Callable[[State], None]] = None

    # -- subclass hooks -----------------------------------------------------
    def on_reset(self) -> None:
        pass

    def on_run(self) -> State:
        raise NotImplementedError

    def on_abort(self) -> bool:
        """Return True when abort is complete."""
        return True

    def on_success(self) -> None:
        pass

    def on_failure_raise(self) -> None:
        pass

    def on_failure_retry(self) -> None:
        pass

    # -- lifecycle ----------------------------------------------------------
    def start(self, on_done: Optional[Callable] = None) -> None:
        assert self.state in (State.PENDING, State.SUCCESS, State.FAILURE,
                              State.ABORTED)
        self._on_done = on_done
        self.retries = 0
        self._last_retry_delay = 0.0
        self.on_reset()
        self.state = State.RUNNING

    def is_done(self) -> bool:
        return self.state in (State.SUCCESS, State.FAILURE, State.ABORTED)

    def is_crankable(self) -> bool:
        """True when crank_work would actually run a step (WAITING and
        RETRYING work only progresses via wake_up / its retry timer)."""
        return self.state in (State.RUNNING, State.ABORTING)

    def crank_work(self) -> None:
        if self.is_done() or self.state in (State.WAITING, State.RETRYING,
                                            State.PENDING):
            return
        if self.state == State.ABORTING:
            if self.on_abort():
                self._finish(State.ABORTED)
            return
        try:
            res = self.on_run()
        except Exception as e:
            log.warning("work %s raised: %s", self.name, e)
            res = State.FAILURE
        if res == State.FAILURE:
            if self.retries < self.max_retries:
                self._schedule_retry()
            else:
                self.on_failure_raise()
                self._finish(State.FAILURE)
        elif res == State.SUCCESS:
            self.on_success()
            self._finish(State.SUCCESS)
        elif res in (State.RUNNING, State.WAITING):
            self.state = res

    def _schedule_retry(self) -> None:
        self.on_failure_retry()
        self.state = State.RETRYING
        from ..util import rnd
        prev = self._last_retry_delay or self.RETRY_BACKOFF_BASE
        delay = min(self.RETRY_BACKOFF_CAP,
                    rnd.g_random.uniform(self.RETRY_BACKOFF_BASE,
                                         prev * 3.0))
        self._last_retry_delay = delay
        self.retries += 1

        def fire() -> None:
            if self.state == State.RETRYING:
                self.on_reset()
                self.state = State.RUNNING
                self.wake_up()

        # always a real timer, virtual clocks included: WAITING/RETRYING
        # propagates up the work tree (work.py) so the scheduler goes
        # idle, the virtual clock advances to this deadline, and the
        # jittered delays keep co-failed works off the same tick
        self._retry_timer.expires_from_now(delay)
        self._retry_timer.async_wait(fire)

    def wake_up(self) -> None:
        if self.state == State.WAITING:
            self.state = State.RUNNING
        cb = getattr(self, "_wake_cb", None)
        if cb is not None:
            cb()
        # a woken child must wake the whole ancestor chain: parents park
        # in WAITING when every child is blocked, and the scheduler only
        # re-cranks on a root wake
        self.wake_up_parent()

    def set_wake_cb(self, cb: Callable[[], None]) -> None:
        self._wake_cb = cb

    def abort(self) -> None:
        if not self.is_done():
            self.state = State.ABORTING

    def _finish(self, st: State) -> None:
        self.state = st
        if self._on_done is not None:
            self._on_done(st)
        self.wake_up_parent()

    def wake_up_parent(self) -> None:
        p = getattr(self, "_parent", None)
        if p is not None:
            p.wake_up()

    def get_status(self) -> str:
        return "%s: %s" % (self.name, self.state.name)
