"""The port's spans inside a verify drain, the herder's envelope intake, the
checkpoint load and the collector, and the benchmark's readers of them.

- A drain on a CPU-member `CudaSigVerifier` records one
  `crypto.verify_many`; each chunk has one `crypto.stage` whose children
  are prep, recode, pad and copy in that order (the first chunk's under
  `crypto.verify_many`, the others' on the staging worker), and one
  `crypto.dispatch` with `crypto.launch` (tags `bucket`, `lanes_real`,
  `members`) then `crypto.gather`. Decisions are the same with the tracer
  on and off, and a disabled tracer makes no `Span`.
- `prewarm_many` records `crypto.cache_keys`, `crypto.cache_probe` and,
  after the drain, `crypto.cache_fill` under `crypto.prewarm`.
- `Herder.recv_scp_envelope` records `herder.recv_scp_envelope` (tags
  `slot`, `state`) with the drain inside it.
- `ApplyCheckpointWork._load` records `catchup.load_files` once, called
  directly or through `on_run`.
- Collector spans: a `Tracer(gc_spans=True)` records `gc.gen2` under the
  open span after `gc.collect()` while enabled and none while disabled; a
  bare `Tracer()` none; a dropped one leaves no callback in
  `gc.callbacks`.
- The resilient layer records no span of its own around the primary's
  drain; a failed drain is tagged `error` on `crypto.verify_many`.
- Each of the benchmark's readers of these spans
  (`portbench/metrics/<name>.py`) against a hand-built context, and None
  where the spans are missing (a program without them).
"""

import gc
import os
import types

import pytest

from stellar_core_tpu_torch.crypto import batch_verifier as BV
from stellar_core_tpu_torch.crypto import keys as K
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.util import tracing as T
from stellar_core_tpu_torch.util.metrics import MetricsRegistry

import torch_threads  # noqa: F401  (one intra-op thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_STEPS = ["crypto.stage.prep", "crypto.stage.recode",
               "crypto.stage.pad", "crypto.stage.copy"]


@pytest.fixture(autouse=True)
def _empty_cache():
    K.flush_verify_cache()
    yield
    K.flush_verify_cache()


def _triples(n, bad=()):
    sks = [SecretKey.from_seed(bytes([i + 7] * 32)) for i in range(3)]
    out = []
    for i in range(n):
        sk, m = sks[i % 3], b"spans-%03d" % i
        sig = sk.sign(m)
        if i in bad:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        out.append((sk.public_key.key_bytes, sig, m))
    return out


def _fleet(tracer=None):
    v = BV.CudaSigVerifier(device="cpu")
    v.BUCKETS = (8,)      # 20 signatures make three chunks
    v.tracer = tracer
    return v


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.sid),
                  key=lambda s: s.t0)


# ------------------------------------------------------------ the drain


def test_drain_records_stage_launch_and_gather_per_chunk():
    tr = T.Tracer()
    tr.enable()
    out = _fleet(tr).verify_many(_triples(20, bad={5}))
    assert out == [i != 5 for i in range(20)]
    spans = tr.spans()
    (vm,) = [s for s in spans if s.name == "crypto.verify_many"]
    stages = sorted((s for s in spans if s.name == "crypto.stage"),
                    key=lambda s: s.t0)
    dispatches = _children(spans, vm)
    dispatches = [s for s in dispatches if s.name == "crypto.dispatch"]
    assert [s.tags for s in stages] == [
        {"n": 8, "bucket": 8}, {"n": 8, "bucket": 8}, {"n": 4, "bucket": 8}]
    assert len(dispatches) == 3
    # the first chunk stages on the dispatch thread under the drain, the
    # others on the staging worker, inside the drain's time
    assert stages[0].parent == vm.sid and stages[0].tid == vm.tid
    for s in stages[1:]:
        assert s.parent == 0 and s.tid != vm.tid
        assert vm.t0 <= s.t0 and s.t0 + s.dur <= vm.t0 + vm.dur
    for s in stages:
        kids = _children(spans, s)
        assert [k.name for k in kids] == STAGE_STEPS
        assert all(k.tid == s.tid for k in kids)
    for d, n in zip(dispatches, (8, 8, 4)):
        kids = _children(spans, d)
        assert [k.name for k in kids] == ["crypto.launch", "crypto.gather"]
        assert kids[0].tags == {"bucket": 8, "lanes_real": n, "members": 1}
        assert kids[0].t0 + kids[0].dur <= kids[1].t0
    assert tr.dropped == 0


def test_decisions_equal_with_the_tracer_on_and_off():
    triples = _triples(20, bad={0, 13, 19})
    off = _fleet(T.Tracer()).verify_many(triples)
    K.flush_verify_cache()
    tr = T.Tracer()
    tr.enable()
    on = _fleet(tr).verify_many(triples)
    assert on == off == [i not in {0, 13, 19} for i in range(20)]
    assert tr.spans()


def test_a_disabled_tracer_makes_no_span(monkeypatch):
    made = []

    class Counted(T.Span):
        __slots__ = ()

        def __init__(self, *a, **k):
            made.append(a[1])
            super().__init__(*a, **k)

    monkeypatch.setattr(T, "Span", Counted)
    tr = T.Tracer()
    v = _fleet(tr)
    assert v.prewarm_many(_triples(20)) == [True] * 20
    assert made == [] and tr.spans() == []
    K.flush_verify_cache()
    tr.enable()
    v.prewarm_many(_triples(20))
    assert "crypto.stage.copy" in made and "crypto.launch" in made


def test_prewarm_records_cache_keys_probe_and_fill():
    tr = T.Tracer()
    tr.enable()
    v = _fleet(tr)
    assert v.prewarm_many(_triples(12, bad={3})) == \
        [i != 3 for i in range(12)]
    spans = tr.spans()
    (pw,) = [s for s in spans if s.name == "crypto.prewarm"]
    assert [s.name for s in _children(spans, pw)] == [
        "crypto.cache_keys", "crypto.cache_probe", "crypto.verify_many",
        "crypto.cache_fill"]
    # every triple cached: no drain, so no fill
    tr.clear()
    v.prewarm_many(_triples(12, bad={3}))
    spans = tr.spans()
    (pw,) = [s for s in spans if s.name == "crypto.prewarm"]
    assert pw.tags["cache_hits"] == 12
    assert [s.name for s in _children(spans, pw)] == [
        "crypto.cache_keys", "crypto.cache_probe"]


def test_the_resilient_layer_adds_no_span_and_a_failed_drain_is_tagged(
        monkeypatch):
    def lost(*_a, **_k):
        raise RuntimeError("card lost")

    tr = T.Tracer()
    tr.enable()
    metrics = MetricsRegistry()
    v = BV.make_verifier("cuda-resilient", device="cpu", tracer=tr,
                         metrics=metrics)
    v.primary.BUCKETS = (8,)
    assert v.verify_many(_triples(4)) == [True] * 4
    assert [s.name for s in tr.spans() if s.parent == 0] == \
        ["crypto.verify_many"]
    tr.clear()
    monkeypatch.setattr(BV, "launch_shards", lost)
    with pytest.raises(RuntimeError, match="card lost"):
        v.verify_many(_triples(4))
    spans = tr.spans()
    assert not [s for s in spans if "dispatch_primary" in s.name]
    (vm,) = [s for s in spans if s.name == "crypto.verify_many"]
    assert vm.parent == 0 and vm.tags["error"] == "RuntimeError"
    (launch,) = [s for s in spans if s.name == "crypto.launch"]
    assert launch.tags["error"] == "RuntimeError"
    assert metrics.new_meter("crypto.verify.dispatch-failure").count == 1


# ------------------------------------------------- herder and catchup


def test_recv_scp_envelope_span_holds_the_drain():
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.main.application import Application
    from stellar_core_tpu_torch.main.config import Config
    from stellar_core_tpu_torch.scp.scp import SCP
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    import stellar_core_tpu_torch.xdr as X

    cfg = Config.test_config(0, backend="cpu-resilient")
    foreign = SecretKey.from_seed(bytes([41]) * 32)
    cfg.QUORUM_SET = X.SCPQuorumSet(
        threshold=2, validators=[cfg.NODE_SEED.public_key,
                                 foreign.public_key], innerSets=[])
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME), cfg)
    app.start()
    try:
        slot = app.herder.current_slot()
        sv = X.StellarValue(txSetHash=bytes([9]) * 32, closeTime=123,
                            upgrades=[], ext=X.StellarValueExt(0, None))
        st = X.SCPStatement(
            nodeID=foreign.public_key, slotIndex=slot,
            pledges=X.SCPPledges(
                X.SCPStatementType.SCP_ST_NOMINATE,
                X.SCPNomination(quorumSetHash=sha256(
                    cfg.QUORUM_SET.to_xdr()), votes=[sv.to_xdr()],
                    accepted=[])))
        env = X.SCPEnvelope(statement=st, signature=b"")
        env.signature = foreign.sign(
            app.herder.scp_driver._envelope_sign_bytes(st))
        tr = app.tracer
        tr.enable()
        seen = []
        state = app.herder.recv_scp_envelope(env, on_verified=seen.append)
        tr.disable()
        assert seen == [True]
        spans = tr.spans()
        (rs,) = [s for s in spans if s.name == "herder.recv_scp_envelope"]
        assert rs.cat == "scp" and rs.parent == 0
        assert rs.tags == {"slot": slot, "state": state}
        assert state == SCP.EnvelopeState.VALID
        (vm,) = [s for s in spans if s.name == "crypto.verify_many"]
        by_sid = {s.sid: s for s in spans}
        up = vm
        while up.parent:
            up = by_sid[up.parent]
        assert up is rs
        assert rs.t0 <= vm.t0 and vm.t0 + vm.dur <= rs.t0 + rs.dur
    finally:
        app.stop()


@pytest.mark.parametrize("route", ["direct", "on_run"])
def test_load_records_load_files_once(tmp_path, route):
    from stellar_core_tpu_torch.historywork.apply_works import \
        ApplyCheckpointWork
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    from stellar_core_tpu_torch.work.basic_work import FAILURE

    tr = T.Tracer()
    tr.enable()
    app = types.SimpleNamespace(clock=VirtualClock(ClockMode.VIRTUAL_TIME),
                                tracer=tr)
    work = ApplyCheckpointWork(app, str(tmp_path), 0x3f, 1, 0x3f)
    if route == "direct":
        # empty files: a load that finds nothing to decode
        for name in ("ledger-0000003f.xdr", "transactions-0000003f.xdr"):
            (tmp_path / name).write_bytes(b"")
        assert work._load() is True
    else:
        # no files: on_run's load fails the work
        assert work.on_run() == FAILURE
    (s,) = tr.spans()
    assert (s.name, s.cat, s.tags) == ("catchup.load_files", "catchup",
                                       {"checkpoint": 0x3f})


# ------------------------------------------------------ collector spans


def _port_hooks():
    return [cb for cb in gc.callbacks
            if getattr(cb, "__module__", None) == T.__name__]


def test_gc_spans_while_enabled_only():
    tr = T.Tracer(gc_spans=True)
    gc.collect()
    assert tr.spans() == []
    tr.enable()
    with tr.span("outer") as outer:
        gc.collect()
    tr.disable()
    gen2 = [s for s in tr.spans() if s.name == "gc.gen2"]
    assert gen2
    s = gen2[-1]
    assert s.cat == "gc" and s.parent == outer.sid and s.dur >= 0
    assert set(s.tags) == {"collected", "uncollectable"}
    assert outer.t0 <= s.t0 and s.t0 + s.dur <= outer.t0 + outer.dur
    n = len(tr.spans())
    gc.collect()
    assert len(tr.spans()) == n
    assert not _port_hooks()


def test_a_bare_tracer_records_no_gc_span():
    tr = T.Tracer()
    tr.enable()
    gc.collect()
    assert tr.spans() == []
    assert not _port_hooks()


def test_a_dropped_gc_tracer_leaves_no_callback():
    tr = T.Tracer(gc_spans=True)
    tr.enable()
    with tr.span("held"):
        pass
    assert len(_port_hooks()) == 1
    del tr          # its spans hold it in a cycle: a collection frees it
    gc.collect()
    assert not _port_hooks()


# ------------------------------------------------------ the readers


def _reader(name):
    from portbench.run import metric_reader
    return metric_reader(REPO, name)


def _ctx(spans, trace=None):
    from portbench.run import Context
    return Context("hand-built", program_spans=spans, trace=trace)


def _trace(t0, window_s, intervals):
    from portbench.yardstick.devtrace import DeviceTrace, union_s
    return DeviceTrace(t0=t0, window_s=window_s, busy_s=union_s(intervals),
                       intervals=sorted(intervals))


@pytest.mark.parametrize("name,span", [
    ("catchup.load_ms", "catchup.load_files"),
    ("verifier.cache_hash_ms", "crypto.cache_keys"),
    ("verifier.cache_probe_ms", "crypto.cache_probe"),
    ("verifier.cache_fill_ms", "crypto.cache_fill"),
    ("verifier.pad_ms.drain", "crypto.stage.pad"),
    ("verifier.prep_ms.drain", "crypto.stage.prep"),
    ("verifier.recode_ms.drain", "crypto.stage.recode"),
    ("verifier.copy_ms.drain", "crypto.stage.copy"),
    ("verifier.stage_ms.scp", "crypto.stage"),
    ("verifier.launch_ms.scp", "crypto.launch"),
    ("verifier.gather_ms.scp", "crypto.gather"),
])
def test_span_mean_readers(name, span):
    read = _reader(name)
    spans = [(span, 1.0, 1.002, 1), (span + ".other", 2.0, 3.0, 1),
             (span, 5.0, 5.006, 2), ("crypto.verify_many", 0.0, 9.0, 1)]
    assert read(_ctx(spans)) == pytest.approx(4.0)
    assert read(_ctx([("crypto.verify_many", 0.0, 9.0, 1)])) is None


def test_gc_pct_reader():
    read = _reader("process.gc_pct.drain")
    spans = [("gc.gen2", 99.0, 101.0, 1), ("gc.gen0", 105.0, 106.0, 2),
             ("gc.gen1", 109.5, 111.0, 1), ("catchup.load_files", 100.0,
                                            110.0, 1)]
    trace = _trace(100.0, 10.0, [(101.0, 102.0)])
    assert read(_ctx(spans, trace)) == pytest.approx(25.0)
    assert read(_ctx(spans)) is None                  # no device trace
    assert read(_ctx(spans[3:], trace)) is None       # no collector spans


def test_recv_self_reader():
    read = _reader("herder.recv_self_ms")
    spans = [("herder.recv_scp_envelope", 0.0, 0.004, 1),
             ("crypto.verify_many", 0.001, 0.003, 1),
             ("crypto.verify_many", 0.0005, 0.0015, 2),   # another thread
             ("herder.recv_scp_envelope", 0.010, 0.011, 1),
             ("crypto.verify_many", 0.0105, 0.0125, 1)]   # not inside
    assert read(_ctx(spans)) == pytest.approx(1.5)
    assert read(_ctx(spans[1:3])) is None


@pytest.mark.parametrize("early_ms", [0.0, 12.0])
def test_flush_host_reader(early_ms):
    """Three flushes inside the window: one the device covers in part (two
    overlapping copies), one in part (a kernel), one whole; a fourth ends
    after the window and is not counted. The device intervals arrive on
    the host clock or 12 ms early (the marker's launch latency): the
    reader reads only their union's length, so either way it is the
    same."""
    read = _reader("verifier.flush_host_ms.scp")
    ms = 1e-3
    spans = [("crypto.verify_many", 100 * ms, 110 * ms, 1),
             ("crypto.verify_many", 120 * ms, 130 * ms, 1),
             ("crypto.verify_many", 150 * ms, 152 * ms, 1),
             ("crypto.verify_many", 290 * ms, 310 * ms, 1),
             ("crypto.stage", 100 * ms, 102 * ms, 1)]
    device = [(101, 103), (102, 104), (122, 127), (150, 152)]
    trace = _trace(0.0, 0.3, [((a - early_ms) * ms, (b - early_ms) * ms)
                              for (a, b) in device])
    # (10 - 3) + (10 - 5) + (2 - 2) ms over three flushes
    assert read(_ctx(spans, trace)) == pytest.approx(4.0)
    assert read(_ctx(spans)) is None
    assert read(_ctx(spans[3:], trace)) is None
