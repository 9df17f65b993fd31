"""The yardstick's arithmetic: the union of device intervals, idle gaps
named by spans, the verify kernel's operation count and roofline, and the
per-layer readers."""

import pytest

from portbench.run import Context
from portbench.yardstick import readers, roofline
from portbench.yardstick.devtrace import DeviceTrace, idle_gaps, union_s


def test_union_of_intervals():
    assert union_s([]) == 0.0
    assert union_s([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == 3.0


def test_idle_gaps_are_cut_by_the_innermost_span():
    trace = DeviceTrace(t0=0.0, window_s=10.0, busy_s=2.0,
                        intervals=[(1, 2), (5, 6)])
    spans = [("outer", 0, 3), ("inner", 2.5, 4.5), ("late", 6, 9)]
    assert idle_gaps(trace, spans) == [
        ("late", 3.0), ("inner", 2.0), ("outer", 1.0), ("untraced", 1.0),
        ("outer", 0.5), ("untraced", 0.5)]


def test_verify_count_is_the_frozen_one():
    assert roofline.FE_MUL_PER_VERIFY == 1811
    assert roofline.FE_SQ_PER_VERIFY == 1550
    assert roofline.PRODUCTS_PER_VERIFY == 266350


def test_roofline_share():
    props = {"sms": 132, "clock_hz": 1.98e9}
    bound, by = roofline.verify_bound_s(8192, 1, props)
    assert by == "operations"
    assert bound == pytest.approx(8192 * 266350 / (132 * 64 * 1.98e9))
    trace = DeviceTrace(t0=0.0, window_s=1.0, busy_s=0.002,
                        seconds_by_name={"ed25519_verify_kernel(int*)":
                                         2 * bound},
                        launches_by_name={"ed25519_verify_kernel(int*)": 1})
    assert roofline.verify_roofline_pct(8192, trace, props) == \
        pytest.approx(50.0)
    # nothing to read: no trace, no kernel, no signature
    assert roofline.verify_roofline_pct(8192, None, props) is None
    empty = DeviceTrace(t0=0.0, window_s=1.0, busy_s=0.0)
    assert roofline.verify_roofline_pct(8192, empty, props) is None
    assert roofline.verify_roofline_pct(0, trace, props) is None


def test_readers():
    spans = [("a", 0.0, 1.0, 1), ("b", 0.2, 0.4, 1), ("a", 2.0, 2.5, 1)]
    assert readers.span_mean_ms(spans, "a") == pytest.approx(750.0)
    assert readers.span_mean_ms(spans, "z") is None
    outer = [s for s in spans if s[0] == "a"]
    assert readers.less_children_ms(outer, spans, "b") == \
        pytest.approx((800.0 + 500.0) / 2)
    assert readers.idle_pct(None) is None
    assert readers.idle_pct(DeviceTrace(0.0, 4.0, 1.0)) == \
        pytest.approx(75.0)


def test_staging_reader():
    from portbench.run import metric_reader
    from portbench.tests.conftest import REPO
    read = metric_reader(REPO, "verifier.staging_ms")
    ctx = Context("x", staging_before={"chunks": 2, "staged_s": 0.1},
                  staging_after={"chunks": 10, "staged_s": 0.5})
    assert read(ctx) == pytest.approx(50.0)
    assert read(Context("x")) is None
