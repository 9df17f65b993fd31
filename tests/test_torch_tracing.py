"""The port's Tracer and FlightRecorder against the JAX package's (mirrors
the cases of tests/test_tracing.py that need no Application).

Each case runs the same span sequence, on the same hand-cranked clock,
through the port's tracer and the reference's, checks the port's result
as the reference's test checks the reference, and requires the two
exports to be equal: spans (names, tags, parents, durations),
Chrome-trace events and phase breakdowns. Flight dumps are compared with
their wall-clock stamp and pid aside.
"""

import json
import os

import pytest

from stellar_core_tpu.util import tracing as RT
from stellar_core_tpu_torch.util import tracing as PT


class FakeClock:
    """Hand-cranked now_fn so span durations are exact."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _both(run):
    """run(tracing module) on the port and on the reference; returns the
    port's result after checking the two are equal."""
    got, want = run(PT), run(RT)
    assert got == want
    return got


def _span_dicts(tr):
    return [s.to_dict() for s in tr.spans()]


def test_span_nesting_parent_links_and_tags():
    def run(T):
        clk = FakeClock()
        tr = T.Tracer(now_fn=clk)
        tr.enable()
        with tr.span("outer", cat="test", seq=7):
            clk.advance(1.0)
            with tr.span("inner") as inner:
                clk.advance(0.25)
                inner.set_tag("n", 3)
            clk.advance(0.5)
        assert tr.open_spans() == []
        return [{k: v for k, v in d.items() if k != "tid"}
                for d in _span_dicts(tr)]

    si, so = _both(run)
    assert (si["name"], so["name"]) == ("inner", "outer")  # close order
    assert si["parent"] == so["sid"] and so["parent"] == 0
    assert si["dur"] == 0.25 and so["dur"] == 1.75
    assert so["tags"] == {"seq": 7} and si["tags"] == {"n": 3}


def test_disabled_tracer_is_noop_and_records_nothing():
    tr = PT.Tracer()
    sp = tr.span("x", whatever=1)
    assert sp is PT._NOOP
    with sp as s:
        s.set_tag("a", 1)   # must not raise
    tr.instant("y")
    assert tr.spans() == []
    assert PT.tracer_span(None, "z") is PT._NOOP
    assert PT.tracer_span(tr, "z") is PT._NOOP
    PT.tracer_instant(None, "z")


def test_ring_buffer_bounding_and_dropped_count():
    def run(T):
        tr = T.Tracer(capacity=8)
        tr.enable()
        for i in range(20):
            with tr.span("s%d" % i):
                pass
        assert tr.spans(last_n=3) == tr.spans()[-3:]
        assert tr.spans(last_n=0) == []   # not the whole buffer
        return tr.dropped, [s.name for s in tr.spans()]

    dropped, names = _both(run)
    assert dropped == 12
    assert names == ["s%d" % i for i in range(12, 20)]


def test_span_exception_tags_error_and_unwinds():
    def run(T):
        tr = T.Tracer()
        tr.enable()
        with pytest.raises(ValueError):
            with tr.span("boom"):
                raise ValueError("x")
        assert tr.open_spans() == []
        (s,) = tr.spans()
        return s.tags

    assert _both(run)["error"] == "ValueError"


def test_chrome_trace_export_validity():
    def run(T):
        clk = FakeClock()
        tr = T.Tracer(now_fn=clk)
        tr.enable()
        with tr.span("work", cat="test", n=2):
            clk.advance(0.002)
            tr.instant("marker", slot=5)
        return json.loads(json.dumps(tr.to_chrome_trace()))

    blob = _both(run)
    evs = blob["traceEvents"]
    assert len(evs) == 2
    for ev in evs:
        assert {"name", "cat", "ph", "ts", "pid", "tid"} <= set(ev)
    marker = next(e for e in evs if e["name"] == "marker")
    assert marker["ph"] == "i" and marker["args"]["slot"] == 5
    work = next(e for e in evs if e["name"] == "work")
    assert work["ph"] == "X" and work["dur"] == pytest.approx(2000.0)


def test_phase_breakdown_self_time_sums_to_wall():
    def run(T):
        clk = FakeClock()
        tr = T.Tracer(now_fn=clk)
        tr.enable()
        # root A (4 s: 1 s self, 3 s in a child hash drain of the "cuda"
        # backend on the CPU)
        with tr.span("apply"):
            clk.advance(1.0)
            with tr.span("hash", backend="cuda", platform="cpu"):
                clk.advance(3.0)
        # root B, 2 s, cpu backend
        with tr.span("hash", backend="cpu"):
            clk.advance(2.0)
        return tr.phase_breakdown(wall_s=8.0)

    pb = _both(run)
    ph = pb["phases"]
    assert ph["apply"]["total_s"] == pytest.approx(1.0)
    # a "cuda" drain on the CPU keys as @cpu, not as device time
    assert ph["hash:cuda@cpu"]["total_s"] == pytest.approx(3.0)
    assert ph["hash:cpu"]["total_s"] == pytest.approx(2.0)
    assert ph["untraced"]["total_s"] == pytest.approx(2.0)
    assert sum(p["total_s"] for p in ph.values()) == pytest.approx(8.0)
    assert pb["accounted_s"] == pytest.approx(8.0)
    assert ph["hash:cpu"]["pct_of_wall"] == pytest.approx(25.0)


def test_phase_breakdown_concurrent_worker_roots_do_not_deflate_untraced():
    """Worker-thread root spans overlap main-thread wall time; only the
    dominant thread's roots count against `untraced`."""
    def run(T):
        clk = FakeClock()
        tr = T.Tracer(now_fn=clk)
        tr.enable()
        with tr.span("main.work"):          # main thread: 6 s root
            clk.advance(6.0)
        # a concurrent worker-thread root (4 s, overlapping the above)
        s = tr.span("worker.dispatch", backend="threaded:cuda")
        tr._push(s)
        s.tid = 999999
        clk.advance(4.0)
        tr._pop(s)
        return tr.phase_breakdown(wall_s=8.0)

    ph = _both(run)["phases"]
    assert ph["untraced"]["total_s"] == pytest.approx(2.0)
    assert ph["main.work"]["total_s"] == pytest.approx(6.0)
    assert ph["worker.dispatch:threaded:cuda"]["total_s"] == \
        pytest.approx(4.0)


def test_flight_recorder_never_raises(tmp_path):
    for T in (PT, RT):
        fr = T.FlightRecorder(T.Tracer(), out_dir=str(
            tmp_path / "does" / "not" / "exist"))
        assert fr.dump("broken") is None   # logged, not raised


def test_flight_recorder_per_reason_cooldown(tmp_path):
    """A burst of same-reason triggers must not overwrite the first
    incident's evidence; force=True bypasses the cooldown."""
    def run(T):
        out = tmp_path / T.__name__
        out.mkdir()
        fr = T.FlightRecorder(T.Tracer(), out_dir=str(out),
                              min_interval_s=3600.0)
        got = [fr.dump("slow-close", extra={"n": 1}) is not None,
               fr.dump("slow-close", extra={"n": 2}) is not None,
               fr.dump("other-reason") is not None,
               fr.dump("slow-close", force=True) is not None]
        return got, fr.dumps, fr.suppressed

    assert _both(run) == ([True, False, True, True], 3, 1)


def test_flight_dumps_at_unchanged_clock_get_distinct_paths(tmp_path):
    """Two forced dumps at one app-clock stamp keep both; the dumps carry
    the same spans, open spans, metrics and extra as the reference's."""
    from stellar_core_tpu.util.metrics import MetricsRegistry as RM
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry as PM

    def run(T):
        out = tmp_path / T.__name__
        out.mkdir()
        clk = FakeClock()
        tr = T.Tracer(now_fn=clk)
        tr.enable()
        reg = (PM if T is PT else RM)(now_fn=clk)
        reg.new_meter("hasher.breaker.trip").mark()
        fr = T.FlightRecorder(tr, metrics=reg, out_dir=str(out),
                              node_name="n1", now_fn=lambda: 12.0)
        with tr.span("crypto.hash_many", backend="cuda", n=3):
            clk.advance(0.5)
            p1 = fr.dump("manual", force=True, extra={"k": 1})
        p2 = fr.dump("manual", force=True)
        assert p1 != p2
        assert os.path.exists(p1) and os.path.exists(p2)
        assert "n1" in os.path.basename(p1)
        blobs = []
        for p in (p1, p2):
            with open(p) as fh:
                b = json.load(fh)
            del b["at_unix"], b["pid"]
            for s in b["spans"] + b["open_spans"]:
                del s["tid"]
            blobs.append(b)
        return [os.path.basename(p) for p in (p1, p2)], blobs

    names, (b1, b2) = _both(run)
    assert names[0].startswith("sct-flight-n1-manual-")
    assert b1["open_spans"][0]["name"] == "crypto.hash_many"
    assert b1["extra"] == {"k": 1}
    assert [s["name"] for s in b2["spans"]] == ["crypto.hash_many"]
