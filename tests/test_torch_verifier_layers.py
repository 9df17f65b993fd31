"""The port's verifier operator layers against the JAX package's.

`ResilientBatchVerifier`, `ThreadedBatchVerifier`, `VirtualClock` and
`make_verifier`'s stacks, each run through the same script on both
packages, mirroring the reference cases that need no node stack:

- from `tests/test_faults.py`: the breaker's state machine under a
  virtual clock, a trip during a drain, a raising dispatch that must not
  strand futures, `prewarm_many` through the breaker;
- from `tests/test_verifier_cockpit.py`: a fallback drain attributed to
  the backend that served it, the async layer's queue depth, in-flight
  flag and queue wait, a failed warmup's flight dump (the port takes any
  recorder with `dump(reason, extra=...)`; a stub here);
- `VirtualClock`: `post_to_main` from worker threads and timer order
  under `crank`;
- `make_verifier`'s five backends against the reference stacks on the
  same triples: the C verifier, the breaker over it, the bare fleet and
  the resilient and async fleets (`device="cpu"`, the kernel's plain
  version at the 128 bucket, against the reference's `tpu` and
  `tpu-async` on the JAX CPU backend).

Decisions, futures, breaker JSON, meters and stats must be equal; the
one renaming is the drain meter named after the device backend ("tpu"
there, "cuda" here). Where the reference serves a failed device drain on
the CPU (its `tpu` stack's fallback, its async layer's `_flush_fallback`),
the port's device stacks do not: a failed drain raises or goes back to
the queue, an open breaker refuses drains, and the decisions, once the
device serves the drain, equal the reference's. Tolerance: none.
"""

import contextlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from stellar_core_tpu.crypto import batch_verifier as RBV
from stellar_core_tpu.crypto import keys as RK
from stellar_core_tpu.util.faults import FaultInjector as RefFaultInjector
from stellar_core_tpu.util.metrics import MetricsRegistry as RefRegistry
from stellar_core_tpu.util.timer import ClockMode as RefClockMode
from stellar_core_tpu.util.timer import VirtualClock as RefVirtualClock
from stellar_core_tpu.util.timer import VirtualTimer as RefVirtualTimer
from stellar_core_tpu.util.tracing import FlightRecorder, Tracer
from stellar_core_tpu.xdr import PublicKey
from stellar_core_tpu_torch.crypto import batch_verifier as BV
from stellar_core_tpu_torch.crypto import keys as K
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.util.faults import FaultInjector, InjectedFault
from stellar_core_tpu_torch.util.metrics import MetricsRegistry
from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
from stellar_core_tpu_torch.util.timer import VirtualTimer

REF = {"bv": RBV, "registry": RefRegistry, "faults": RefFaultInjector,
       "clock": RefVirtualClock, "mode": RefClockMode,
       "timer": RefVirtualTimer}
PORT = {"bv": BV, "registry": MetricsRegistry, "faults": FaultInjector,
        "clock": VirtualClock, "mode": ClockMode, "timer": VirtualTimer}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_caches():
    K.flush_verify_cache()
    RK.flush_verify_cache()
    yield
    K.flush_verify_cache()
    RK.flush_verify_cache()


def _flush_caches():
    K.flush_verify_cache()
    RK.flush_verify_cache()


def _signed_triples(n, bad=(), tag=b"msg"):
    """The reference fault tests' triples: (key32, sig, msg), the
    signatures at `bad` with their last bit flipped."""
    out = []
    for i in range(n):
        sk = SecretKey.from_seed(bytes([i % 250 + 1] * 32))
        msg = tag + b"-%d" % i
        sig = sk.sign(msg)
        if i in bad:
            sig = sig[:-1] + bytes([sig[-1] ^ 1])
        out.append((sk.public_key, sig, msg))
    return out


def _enqueue(side, v, triples):
    if side is REF:
        return [v.enqueue(PublicKey.ed25519(k), s, m) for (k, s, m) in triples]
    return [v.enqueue(k, s, m) for (k, s, m) in triples]


def _crank_until_done(clock, futs, limit_s=60.0):
    deadline = time.monotonic() + limit_s
    while not all(f.done() for f in futs) and time.monotonic() < deadline:
        clock.crank(False)
        time.sleep(0.002)
    assert all(f.done() for f in futs)
    return [f.result() for f in futs]


def _counts(reg, prefixes=("crypto.", "verifier.drains.", "fault.")):
    """Every metric under `prefixes` as its count (or value), with the
    device backend's drain meter named as the port names it."""
    out = {}
    for k, m in reg.to_json().items():
        if k.startswith(prefixes):
            out[k.replace("verifier.drains.tpu", "verifier.drains.cuda")] = \
                m.get("count", m.get("value"))
    return out


def _by_backend(stats):
    d = stats.to_json()["drains"]["by_backend"]
    return {("cuda" if k == "tpu" else k): v for k, v in d.items()}


class _Span:
    def __init__(self, name, tags):
        self.name = name
        self.tags = dict(tags)

    def set_tag(self, key, value):
        self.tags[key] = value
        return self


class _SpanLog:
    """A tracer stand-in for the port (its Tracer arrives with the util
    layer): records every span and instant."""

    enabled = True

    def __init__(self):
        self.recorded = []

    @contextlib.contextmanager
    def span(self, name, cat, **tags):
        sp = _Span(name, tags)
        self.recorded.append(sp)
        yield sp

    def instant(self, name, cat, **tags):
        self.recorded.append(_Span(name, tags))

    def spans(self):
        return list(self.recorded)


class _StubRecorder:
    """A flight recorder stand-in: keeps every dump."""

    def __init__(self):
        self.dumps = []

    def dump(self, reason, extra=None):
        self.dumps.append((reason, extra))


# ------------------------------------------------------------ CircuitBreaker


def _breaker_script(side):
    clock = side["clock"](side["mode"].VIRTUAL_TIME)
    CB = side["bv"].CircuitBreaker
    br = CB(threshold=3, cooldown_s=10.0, now_fn=clock.now)
    seen = [br.state, br.allow()]
    br.record_failure()
    br.record_failure()
    seen.append(br.state)                       # below threshold
    seen.append(br.record_failure())            # third trips
    seen += [br.state, br.trips, br.allow()]
    clock.set_virtual_time(9.9)
    seen.append(br.allow())                     # still cooling down
    clock.set_virtual_time(10.0)
    seen += [br.allow(), br.state]              # half-open probe
    br.record_failure()                         # re-opens, no new trip
    seen += [br.state, br.trips, br.allow()]
    clock.set_virtual_time(20.0)
    seen.append(br.allow())
    br.record_success()
    seen += [br.state, br.recoveries, br.consecutive_failures,
             br.to_json()]
    return seen


def test_breaker_state_machine_virtual_clock():
    seen = _breaker_script(PORT)
    assert seen == _breaker_script(REF)
    assert seen[:-1] == [
        "closed", True, "closed", True, "open", 1, False, False, True,
        "half-open", "open", 1, False, True, "closed", 1, 0]


# ------------------------------------------------ resilient layer (drains)


def _trip_during_drain(side):
    clock = side["clock"](side["mode"].VIRTUAL_TIME)
    reg = side["registry"](now_fn=clock.now)
    if side is REF:
        v = RBV.make_verifier("cpu-resilient", clock, metrics=reg,
                              breaker_threshold=1, breaker_cooldown=5.0)
    else:
        v = BV.make_verifier("cpu-resilient", clock=clock, metrics=reg,
                             breaker_threshold=1, breaker_cooldown=5.0)
    v.faults = side["faults"](metrics=reg)
    v.faults.configure("device.dispatch", count=1)
    triples = _signed_triples(6, bad={2, 4})
    rounds = []
    futs = _enqueue(side, v, triples)
    v.flush()                                   # dispatch fails, trips
    rounds.append(([f.result() for f in futs], v.breaker.to_json()))
    _flush_caches()                             # open: the fallback serves
    futs = _enqueue(side, v, triples)
    v.flush()
    rounds.append(([f.result() for f in futs], v.breaker.to_json()))
    clock.set_virtual_time(6.0)                 # half-open probe re-closes
    _flush_caches()
    futs = _enqueue(side, v, triples)
    v.flush()
    rounds.append(([f.result() for f in futs], v.breaker.to_json()))
    return rounds, _counts(reg), _by_backend(v.stats)


def test_trip_during_drain_returns_correct_results():
    rounds, counts, drains = _trip_during_drain(PORT)
    assert (rounds, counts, drains) == _trip_during_drain(REF)
    want = [True, True, False, True, False, True]
    assert [r[0] for r in rounds] == [want] * 3
    assert [r[1]["state"] for r in rounds] == ["open", "open", "closed"]
    assert rounds[2][1]["trips"] == 1 and rounds[2][1]["recoveries"] == 1
    assert counts["crypto.verify.fallback-drain"] == 2
    assert counts["crypto.verify.dispatch-failure"] == 1
    assert counts["crypto.breaker.trip"] == 1
    assert counts["crypto.breaker.recover"] == 1


def _resilient_prewarm(side):
    clock = side["clock"](side["mode"].VIRTUAL_TIME)
    reg = side["registry"](now_fn=clock.now)
    if side is REF:
        v = RBV.make_verifier("cpu-resilient", clock, metrics=reg,
                              breaker_threshold=1, breaker_cooldown=5.0)
    else:
        v = BV.make_verifier("cpu-resilient", clock=clock, metrics=reg,
                             breaker_threshold=1, breaker_cooldown=5.0)
    v.faults = side["faults"](metrics=reg)
    v.faults.configure("device.dispatch", count=1)
    out = v.prewarm_many(_signed_triples(5, bad={0}))
    return out, v.breaker.trips, _counts(reg)


def test_resilient_prewarm_routes_through_breaker():
    got = _resilient_prewarm(PORT)
    assert got == _resilient_prewarm(REF)
    out, trips, counts = got
    assert out == [False, True, True, True, True]
    assert trips == 1 and counts["crypto.breaker.trip"] == 1


def test_flush_recompletes_futures_on_dispatch_exception():
    """The reference's bare TpuSigVerifier re-completes a raising flush on
    the CPU inside the backend. The port's device stacks serve no drain on
    the CPU: the resilient fleet counts the failure, keeps the batch
    queued and raises, as the bare fleet does, and the next flush
    completes the same futures with the reference's decisions."""
    triples = _signed_triples(4, bad={1})

    def boom(triples):
        raise RuntimeError("device gone")

    ref = RBV.TpuSigVerifier()
    ref.verify_many = boom
    futs = _enqueue(REF, ref, triples)
    ref.flush()
    want = [f.result() for f in futs]
    assert want == [True, False, True, True]

    _flush_caches()
    reg = MetricsRegistry()
    v = BV.make_verifier("cuda-resilient", device="cpu", metrics=reg)
    v.primary.BUCKETS = (128,)
    v.primary.verify_many = boom
    futs = _enqueue(PORT, v, triples)
    with pytest.raises(RuntimeError, match="device gone"):
        v.flush()
    assert v.pending() == 4 and not any(f.done() for f in futs)
    assert _counts(reg)["crypto.verify.dispatch-failure"] == 1
    del v.primary.verify_many
    v.flush()
    assert [f.result() for f in futs] == want
    assert v.pending() == 0 and v.breaker.state == "closed"
    assert "crypto.verify.fallback-drain" not in _counts(reg)
    assert _by_backend(v.stats) == {"cuda": {"drains": 1, "sigs": 4,
                                             "pad_total": 124}}

    _flush_caches()
    bare = BV.CudaSigVerifier(device="cpu")
    bare.verify_many = boom
    futs = _enqueue(PORT, bare, triples)
    with pytest.raises(RuntimeError, match="device gone"):
        bare.flush()
    assert bare.pending() == 4 and not any(f.done() for f in futs)


def test_async_dispatch_exception_requeues_the_batch():
    """The reference's async layer completes a batch whose dispatch raised
    on the CPU (`_flush_fallback`). The port's puts it back at the head of
    the queue, uncompleted, and the next flush dispatches it to the fleet
    again: the reference's decisions, none of them from the CPU."""
    triples = _signed_triples(5, bad={3})

    def boom(triples):
        raise RuntimeError("dispatch died")

    rclock = RefVirtualClock(RefClockMode.VIRTUAL_TIME)
    ref = RBV.make_verifier("tpu-async", rclock,
                            metrics=RefRegistry(now_fn=rclock.now))
    ref._inner.verify_many = boom
    futs = _enqueue(REF, ref, triples)
    ref.flush()
    want = _crank_until_done(rclock, futs)
    assert want == [True, True, True, False, True]

    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    reg = MetricsRegistry(now_fn=clock.now)
    v = BV.make_verifier("cuda-async", device="cpu", clock=clock,
                         metrics=reg)
    fleet = v.inner
    fleet.BUCKETS = (128,)
    fleet.verify_many = boom
    futs = _enqueue(PORT, v, triples)
    v.flush()
    deadline = time.monotonic() + 60.0
    while v.pending() < 5 and time.monotonic() < deadline:
        clock.crank(False)
        time.sleep(0.002)
    assert v.pending() == 5 and not any(f.done() for f in futs)
    c = _counts(reg)
    assert c["crypto.verify.dispatch-failure"] == 1
    assert c["crypto.verify.requeued"] == 5
    queue = v.stats.to_json()["queue"]
    assert queue["inflight"] == 0 and queue["depth"] == 5
    del fleet.verify_many
    v.flush()
    assert _crank_until_done(clock, futs) == want
    c = _counts(reg)
    assert "crypto.verify.fallback-drain" not in c
    assert "crypto.verify.flush-fallback" not in c
    assert c["crypto.verify.latency"] == 5
    assert _by_backend(v.stats) == {"cuda": {"drains": 1, "sigs": 5,
                                             "pad_total": 123}}
    assert v.breaker.state == "closed" and v.pending() == 0


def test_cuda_resilient_raises_and_refuses_while_open():
    """The fleet's breaker without a fallback: failed drains raise and keep
    their batch, the trip dumps, an open breaker refuses drains without
    touching the fleet, and the half-open probe serves the batch and
    re-closes it."""
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    reg = MetricsRegistry(now_fn=clock.now)
    rec = _StubRecorder()
    v = BV.make_verifier("cuda-resilient", device="cpu", clock=clock,
                         metrics=reg, flight_recorder=rec,
                         breaker_threshold=2, breaker_cooldown=5.0)
    assert v.fallback is None
    v.inner.BUCKETS = (128,)
    v.faults = FaultInjector(metrics=reg)
    v.faults.configure("device.dispatch", count=2)
    triples = _signed_triples(6, bad={2, 4})
    futs = _enqueue(PORT, v, triples)
    for _ in range(2):
        with pytest.raises(InjectedFault):
            v.flush()
        assert v.pending() == 6 and not any(f.done() for f in futs)
    assert v.breaker.state == "open" and v.breaker.trips == 1
    assert [r for r, _e in rec.dumps] == ["verify-breaker-trip"]
    with pytest.raises(BV.BreakerOpenError, match="open"):
        v.flush()
    assert v.pending() == 6 and v.inner.batches_dispatched == 0
    c = _counts(reg)
    assert c["crypto.verify.dispatch-failure"] == 2
    assert c["crypto.verify.refused-drain"] == 1
    assert c["crypto.breaker.trip"] == 1
    assert "crypto.verify.fallback-drain" not in c
    clock.set_virtual_time(5.0)                 # the half-open probe
    v.flush()
    assert [f.result() for f in futs] == [True, True, False, True, False,
                                          True]
    assert v.breaker.state == "closed" and v.breaker.recoveries == 1
    assert v.inner.batches_dispatched == 1
    assert _by_backend(v.stats) == {"cuda": {"drains": 1, "sigs": 6,
                                             "pad_total": 122}}


def test_card_primary_takes_no_fallback():
    class _OnCard(BV.BatchSigVerifier):
        on_card = True

    with pytest.raises(ValueError, match="no fallback"):
        BV.ResilientBatchVerifier(_OnCard(), BV.CpuSigVerifier())
    assert BV.ResilientBatchVerifier(_OnCard()).fallback is None
    assert not BV.CudaSigVerifier(device="cpu").on_card


# ------------------------------------------------------------ cockpit cases


def _fallback_attribution(side):
    class _FailingDevice(side["bv"].BatchSigVerifier):
        name = "tpu" if side is REF else "cuda"

        def verify_many(self, triples):
            raise RuntimeError("injected device loss")

    reg = side["registry"]()
    tr = Tracer() if side is REF else _SpanLog()
    if side is REF:
        tr.enable()
    stats = side["bv"].VerifierStats(metrics=reg, tracer=tr)
    primary = _FailingDevice()
    primary.stats = stats
    fb = side["bv"].CpuSigVerifier()
    fb.stats = stats
    fb.tracer = tr
    r = side["bv"].ResilientBatchVerifier(
        primary, fb, side["bv"].CircuitBreaker(threshold=2))
    r.stats = stats
    r.tracer = tr
    r.metrics = reg
    res = r.verify_many(_signed_triples(3, tag=b"cockpit"))
    spans = [s for s in tr.spans() if s.name == "crypto.verify_fallback"]
    tags = dict(spans[-1].tags)
    return (res, _by_backend(stats), tags["served_by"], tags["n"],
            tags["breaker"], _counts(reg))


def test_fallback_drain_attributed_to_serving_backend():
    got = _fallback_attribution(PORT)
    assert got == _fallback_attribution(REF)
    res, drains, served_by, n, breaker, counts = got
    assert all(res)
    assert drains == {"cpu": {"drains": 1, "sigs": 3, "pad_total": 0}}
    assert served_by == "cpu" and n == 3 and breaker == "closed"
    assert counts["verifier.drains.cpu"] == 1


def _threaded_queue(side):
    clock = side["clock"](side["mode"].VIRTUAL_TIME)
    reg = side["registry"]()
    inner = side["bv"].CpuSigVerifier()
    v = side["bv"].ThreadedBatchVerifier(inner, clock, metrics=reg)
    stats = side["bv"].VerifierStats(metrics=reg, now_fn=clock.now)
    inner.stats = stats
    v.stats = stats
    depths = []
    futs = []
    for t in _signed_triples(4, tag=b"queue"):
        futs += _enqueue(side, v, [t])
        depths.append(stats.queue["depth"])
    depth_gauge = reg.to_json()["verifier.queue.depth"]["value"]
    clock.set_virtual_time(clock.now() + 2.5)   # queue wait on app clock
    v.flush()
    after_flush = stats.queue["depth"]
    res = _crank_until_done(clock, futs)
    wait = reg.to_json()["verifier.queue.wait"]
    return (depths, depth_gauge, after_flush, res, dict(stats.queue),
            wait["count"], wait["max"])


def test_threaded_queue_depth_inflight_and_wait():
    got = _threaded_queue(PORT)
    assert got == _threaded_queue(REF)
    depths, gauge, after, res, queue, wait_n, wait_max = got
    assert depths == [1, 2, 3, 4] and gauge == 4 and after == 0
    assert all(res)
    assert queue["inflight"] == 0 and queue["wait_last_max_ms"] >= 2500.0
    assert wait_n == 1 and wait_max >= 2.5


def test_warmup_failure_dumps_flight(tmp_path):
    """A failed warmup marks the failure meter, sets the state gauge and
    leaves one flight dump naming the error, as the reference's does."""

    def boom(b):
        raise RuntimeError("no device")

    reg = MetricsRegistry()
    rec = _StubRecorder()
    v = BV.CudaSigVerifier(device="cpu")
    v.BUCKETS = (128,)
    v.stats = BV.VerifierStats(metrics=reg, flight_recorder=rec)
    v._enable_compile_cache = lambda: None
    v._compile_bucket = boom
    v.warmup(wait=True)
    assert not v._warmed
    assert v.stats.warmup["state"] == "failed"
    m = reg.to_json()
    assert m["verifier.warmup.failure"]["count"] == 1
    assert m["verifier.warmup.state"]["value"] == 3
    assert [r for r, _e in rec.dumps] == ["verify-warmup-failed"]
    extra = rec.dumps[0][1]

    ref_reg = RefRegistry()
    tr = Tracer()
    tr.enable()
    fr = FlightRecorder(tr, metrics=ref_reg, out_dir=str(tmp_path))
    ref = RBV.TpuSigVerifier()
    ref.BUCKETS = (128,)
    ref.stats = RBV.VerifierStats(metrics=ref_reg, tracer=tr,
                                  flight_recorder=fr)
    ref._enable_compile_cache = lambda: None
    ref._compile_bucket = boom
    ref.warmup(wait=True)
    dumps = [f for f in os.listdir(str(tmp_path))
             if "verify-warmup-failed" in f]
    assert len(dumps) == 1
    with open(os.path.join(str(tmp_path), dumps[0])) as fh:
        blob = json.load(fh)
    assert extra["error"] == blob["extra"]["error"]
    assert "no device" in extra["error"]
    for k in ("state", "planned", "error", "source"):
        assert extra["warmup"][k] == blob["extra"]["warmup"][k], k


def _stats_dumps(side, recorder):
    clock = {"t": 100.0}

    class _Owner:
        stats = side["bv"].VerifierStats(now_fn=lambda: clock["t"],
                                         flight_recorder=recorder)

    h = side["bv"].DeviceFleetHealth(2, threshold=2, cooldown_s=5.0,
                                     now_fn=lambda: clock["t"],
                                     owner=_Owner)
    h.record_failure(1)
    h.record_failure(1)                         # trips member 1
    _Owner.stats.compile_cache_error("PermissionError('/ro/build')")
    return _Owner.stats.metrics.to_json()["verifier.device.trip"]["count"]


def test_member_trip_and_build_dir_errors_dump_flight(tmp_path):
    rec = _StubRecorder()
    assert _stats_dumps(PORT, rec) == 1
    assert [r for r, _e in rec.dumps] == ["verify-device-trip",
                                          "compile-cache-unavailable"]
    tr = Tracer()
    fr = FlightRecorder(tr, out_dir=str(tmp_path))
    assert _stats_dumps(REF, fr) == 1
    blobs = {}
    for f in os.listdir(str(tmp_path)):
        with open(os.path.join(str(tmp_path), f)) as fh:
            blob = json.load(fh)
        blobs[blob["reason"]] = blob["extra"]
    assert blobs == {r: e for r, e in rec.dumps}
    assert rec.dumps[0][1]["device"] == 1
    assert rec.dumps[0][1]["breaker"]["state"] == "open"


# ------------------------------------------------------------ VirtualClock


def _clock_script(side):
    clock = side["clock"](side["mode"].VIRTUAL_TIME)
    VT = side["timer"]
    order = []
    timers = []
    for delay, tag in ((3.0, "c"), (1.0, "a"), (2.0, "b"), (1.0, "a2")):
        t = VT(clock)
        t.expires_from_now(delay)
        t.async_wait(lambda tag=tag: order.append((tag, clock.now())))
        timers.append(t)
    dropped = VT(clock)
    dropped.expires_from_now(1.5)
    dropped.async_wait(lambda: order.append(("dropped-fired", clock.now())),
                       lambda: order.append(("dropped", clock.now())))
    dropped.cancel()
    clock.post(lambda: order.append(("posted", clock.now())))
    for i in range(4):
        # each worker posts its completion back to the main loop
        w = threading.Thread(target=lambda i=i: clock.post_to_main(
            lambda: order.append(("worker-%d" % i, clock.now()))))
        w.start()
        w.join(timeout=10)
        assert not w.is_alive()
    ran = [clock.crank(False) for _ in range(6)]
    seated = [t.seated for t in timers]
    return order, ran, seated, clock.now()


def test_virtual_clock_posts_and_timer_order():
    got = _clock_script(PORT)
    assert got == _clock_script(REF)
    order, ran, seated, now = got
    assert order == [("dropped", 0.0), ("posted", 0.0)] + [
        ("worker-%d" % i, 0.0) for i in range(4)] + [
        ("a", 1.0), ("a2", 1.0), ("b", 2.0), ("c", 3.0)]
    # the third crank jumps to the cancelled timer's deadline and runs
    # nothing
    assert ran == [5, 2, 0, 1, 1, 0] and now == 3.0
    assert seated == [False] * 4


def test_virtual_clock_real_time_worker_posts():
    clock = VirtualClock(ClockMode.REAL_TIME)
    done = []
    w = threading.Thread(target=lambda: clock.post_to_main(
        lambda: done.append(threading.current_thread().name)))
    w.start()
    w.join(timeout=10)
    assert not w.is_alive() and done == []
    deadline = time.monotonic() + 10
    while not done and time.monotonic() < deadline:
        clock.crank(True)
    assert done == [threading.current_thread().name]
    assert clock.now() == pytest.approx(time.monotonic(), abs=1.0)


# ---------------------------------------------- make_verifier's five stacks

# the port's backend name -> the reference's
BACKENDS = {"cpu": "cpu", "cpu-resilient": "cpu-resilient", "cuda": "tpu",
            "cuda-resilient": "tpu", "cuda-async": "tpu-async"}


def _stack(side, backend):
    clock = side["clock"](side["mode"].VIRTUAL_TIME)
    reg = side["registry"](now_fn=clock.now)
    rec = _StubRecorder()
    if side is REF:
        v = RBV.make_verifier(BACKENDS[backend], clock, metrics=reg,
                              flight_recorder=rec)
    else:
        v = BV.make_verifier(backend, device="cpu", clock=clock, metrics=reg,
                             flight_recorder=rec)
    device = getattr(v, "inner", v)
    if backend.startswith("cuda"):
        device.BUCKETS = (128,)
    triples = _signed_triples(100, bad=set(range(3, 100, 7)), tag=b"stack")
    futs = _enqueue(side, v, triples)
    v.flush()
    flushed = _crank_until_done(clock, futs)
    _flush_caches()
    warmed = v.prewarm_many(triples)
    again = v.prewarm_many(triples)             # all cache hits
    breaker = getattr(v, "breaker", None)
    return {"flushed": flushed, "warmed": warmed, "again": again,
            "breaker": breaker.to_json() if breaker is not None else None,
            "dispatched": getattr(device, "batches_dispatched", None),
            "drains": _by_backend(v.stats), "counts": _counts(reg),
            "dumps": rec.dumps, "layers": type(v).__name__}


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_make_verifier_stack_equals_the_reference(backend):
    port = _stack(PORT, backend)
    ref = _stack(REF, backend)
    if backend == "cuda":
        # the reference has no bare device backend: "tpu" is the resilient
        # stack, whose breaker and layer name the bare fleet lacks
        assert port["breaker"] is None and port["layers"] == "CudaSigVerifier"
        ref["breaker"] = None
        ref["layers"] = port["layers"]
    else:
        port["layers"] = port["layers"].replace("Cuda", "Tpu")
    assert port == ref
    want = [i % 7 != 3 for i in range(100)]
    assert port["flushed"] == port["warmed"] == port["again"] == want
    assert port["dumps"] == []
    assert "crypto.verify.fallback-drain" not in port["counts"]
    if backend.startswith("cuda"):
        assert port["dispatched"] == 2
        assert port["drains"] == {"cuda": {"drains": 2, "sigs": 200,
                                           "pad_total": 56}}
    if port["breaker"] is not None:
        assert port["breaker"]["state"] == "closed"


def test_cuda_async_needs_a_clock():
    with pytest.raises(ValueError, match="clock"):
        BV.make_verifier("cuda-async", device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        BV.make_verifier("tpu", device="cpu")


def test_async_cuda_stack_serves_bursts_in_turn():
    """Verifies enqueued while a batch is in flight form the next batch at
    once: two bursts, one flush each, every future right, no fallback."""
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    reg = MetricsRegistry(now_fn=clock.now)
    v = BV.make_verifier("cuda-async", device="cpu", clock=clock,
                         metrics=reg)
    v.inner.BUCKETS = (128,)
    triples = _signed_triples(20, bad={4, 11}, tag=b"bursts")
    first = _enqueue(PORT, v, triples[:10])
    v.flush()
    second = _enqueue(PORT, v, triples[10:])
    v.flush()                                   # in flight: a no-op
    got = _crank_until_done(clock, first + second)
    assert got == [i not in (4, 11) for i in range(20)]
    assert v.inner.batches_dispatched == 2 and v.pending() == 0
    c = _counts(reg)
    assert "crypto.verify.fallback-drain" not in c
    assert "crypto.verify.flush-fallback" not in c
    assert c["crypto.verify.latency"] == 20
    assert np.isfinite(reg.to_json()["crypto.verify.latency"]["max"])


@pytest.mark.parametrize("backend", ["cuda-resilient", "cuda-async"])
def test_stack_delegates_to_the_fleet(backend, tmp_path):
    """The layers hand warmup, the plan file, the fleet's health and the
    dispatch counters through to the fleet they wrap."""
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    v = BV.make_verifier(backend, device="cpu", clock=clock)
    fleet = v.inner
    assert isinstance(fleet, BV.CudaSigVerifier)
    fleet.BUCKETS = (128,)
    fleet._plan_dir = str(tmp_path)
    warmed = []
    fleet._enable_compile_cache = lambda: None
    fleet._compile_bucket = warmed.append
    v.warmup(wait=True)
    assert warmed == [128] and fleet._warmed
    assert v.fleet_health is fleet.fleet_health
    assert v.save_warmup_plan() is None        # no traffic seen yet
    resilient = v if backend == "cuda-resilient" else v._inner
    assert resilient.batches_dispatched == fleet.batches_dispatched == 0
    assert resilient.sigs_verified == 0
    assert v.breaker is resilient.breaker
