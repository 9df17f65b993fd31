"""The port's work framework held against the JAX package's.

Each case of `tests/test_work.py` (the BasicWork state machine: success,
retries, retries exhausted; Work trees; WorkSequence order and stop on
failure; BatchWork's concurrency bound; ConditionalWork's gate) runs on
both packages' `work/` over their own `VirtualClock`, and what it
observes (states, run and reset counts, order, peak concurrency) is the
same on both and what the reference test asserts.
"""

from types import SimpleNamespace
from typing import List, Optional

import stellar_core_tpu.util.timer as r_timer
import stellar_core_tpu.work.basic_work as r_basic
import stellar_core_tpu.work.work as r_work
import stellar_core_tpu_torch.util.timer as p_timer
import stellar_core_tpu_torch.work.basic_work as p_basic
import stellar_core_tpu_torch.work.work as p_work

PKGS = {
    "port": SimpleNamespace(timer=p_timer, basic=p_basic, work=p_work),
    "reference": SimpleNamespace(timer=r_timer, basic=r_basic, work=r_work),
}


def both(scenario):
    """The scenario's observations on each package; they must agree."""
    got = {name: scenario(W) for name, W in PKGS.items()}
    assert got["port"] == got["reference"], got
    return got["port"]


def new_clock(W):
    return W.timer.VirtualClock(W.timer.ClockMode.VIRTUAL_TIME)


def step_work(W):
    class StepWork(W.basic.BasicWork):
        """Succeeds after N cranks, optionally failing first `fails`
        times."""

        def __init__(self, clock, name="step", steps=1, fails=0,
                     max_retries=5):
            super().__init__(clock, name, max_retries=max_retries)
            self.steps = steps
            self.fails = fails
            self.runs = 0
            self.resets = 0

        def on_reset(self):
            self.resets += 1
            self._left = self.steps

        def on_run(self):
            self.runs += 1
            if self.fails > 0:
                self.fails -= 1
                return W.basic.State.FAILURE
            self._left -= 1
            return (W.basic.State.SUCCESS if self._left <= 0
                    else W.basic.State.RUNNING)

    return StepWork


def crank(clock, works, max_cranks=10000):
    for _ in range(max_cranks):
        if all(w.is_done() for w in works):
            return True
        for w in works:
            if not w.is_done():
                w.crank_work()
        clock.crank(False)
    return all(w.is_done() for w in works)


def test_basic_success():
    def scenario(W):
        clock = new_clock(W)
        w = step_work(W)(clock, steps=3)
        w.start()
        return crank(clock, [w]), w.state.name, w.runs

    assert both(scenario) == (True, "SUCCESS", 3)


def test_retry_then_success():
    def scenario(W):
        clock = new_clock(W)
        w = step_work(W)(clock, fails=2, max_retries=5)
        w.start()
        return crank(clock, [w]), w.state.name, w.resets, w.retries

    done, state, resets, retries = both(scenario)
    assert done and state == "SUCCESS"
    assert resets >= 3 and retries == 2   # initial + 2 retries


def test_retries_exhausted_is_failure():
    def scenario(W):
        clock = new_clock(W)
        w = step_work(W)(clock, fails=99, max_retries=2)
        w.start()
        return crank(clock, [w]), w.state.name, w.resets

    assert both(scenario) == (True, "FAILURE", 3)   # initial + 2 retries


def test_work_tree_child_failure_fails_parent():
    def scenario(W):
        clock = new_clock(W)
        StepWork = step_work(W)

        class Parent(W.work.Work):
            def do_reset(self):
                self.ok = self.add_work(StepWork(clock, "ok", steps=1))
                self.bad = self.add_work(
                    StepWork(clock, "bad", fails=99, max_retries=0))

        p = Parent(clock, "parent", max_retries=0)
        p.start()
        return crank(clock, [p]), p.state.name, p.bad.state.name

    assert both(scenario) == (True, "FAILURE", "FAILURE")


def test_work_sequence_runs_in_order():
    def scenario(W):
        clock = new_clock(W)
        log: List[str] = []

        class LogWork(W.basic.BasicWork):
            def __init__(self, name):
                super().__init__(clock, name)

            def on_run(self):
                log.append(self.name)
                return W.basic.State.SUCCESS

        seq = W.work.WorkSequence(clock, "seq",
                                  [LogWork("a"), LogWork("b"),
                                   LogWork("c")])
        seq.start()
        return crank(clock, [seq]), seq.state.name, log

    assert both(scenario) == (True, "SUCCESS", ["a", "b", "c"])


def test_work_sequence_stops_on_failure():
    def scenario(W):
        clock = new_clock(W)
        ran: List[str] = []
        S = W.basic.State

        class F(W.basic.BasicWork):
            def __init__(self, name, st):
                super().__init__(clock, name, max_retries=0)
                self.st = st

            def on_run(self):
                ran.append(self.name)
                return self.st

        seq = W.work.WorkSequence(
            clock, "seq", [F("a", S.SUCCESS), F("b", S.FAILURE),
                           F("c", S.SUCCESS)], max_retries=0)
        seq.start()
        return crank(clock, [seq]), seq.state.name, ran

    assert both(scenario) == (True, "FAILURE", ["a", "b"])


def test_batch_work_bounded_concurrency():
    def scenario(W):
        clock = new_clock(W)
        live = [0]
        peak = [0]

        class Slot(W.basic.BasicWork):
            def __init__(self, i):
                super().__init__(clock, "slot-%d" % i)
                self.ticks = 2

            def on_reset(self):
                self.started = False

            def on_run(self):
                if not self.started:
                    self.started = True
                    live[0] += 1
                    peak[0] = max(peak[0], live[0])
                self.ticks -= 1
                if self.ticks <= 0:
                    live[0] -= 1
                    return W.basic.State.SUCCESS
                return W.basic.State.RUNNING

        class B(W.work.BatchWork):
            def __init__(self):
                super().__init__(clock, "batch", max_concurrent=3)
                self.spawned = 0

            def yield_more_work(self) -> Optional[object]:
                if self.spawned >= 10:
                    return None
                self.spawned += 1
                return Slot(self.spawned)

        b = B()
        b.start()
        return crank(clock, [b]), b.state.name, b.spawned, peak[0]

    done, state, spawned, peak = both(scenario)
    assert (done, state, spawned) == (True, "SUCCESS", 10)
    assert peak <= 3, "batch exceeded its concurrency bound"


def test_conditional_work_waits_for_predicate():
    def scenario(W):
        clock = new_clock(W)
        gate = [False]
        inner = step_work(W)(clock, "inner", steps=1)
        c = W.work.ConditionalWork(clock, "cond", lambda: gate[0], inner)
        c.start()
        for _ in range(50):
            c.crank_work()
            clock.crank(False)
        before = (c.is_done(), inner.runs)
        gate[0] = True
        return before, crank(clock, [c]), c.state.name, inner.runs

    assert both(scenario) == ((False, 0), True, "SUCCESS", 1)
