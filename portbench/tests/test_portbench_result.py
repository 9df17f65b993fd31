"""The result line each run prints, on the CPU (the device block is the
card's; here a stand-in)."""

import json

import pytest

from portbench.run import cell_metrics, load_benchmark, result_line, \
    run_cell

DEVICE = {"platform": "gpu", "kind": "a stand-in", "count": 1}


@pytest.mark.parametrize("workload", ["catchup-verify.pubnet",
                                      "scp-bursts.tier1"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(small_root, workload, trace):
    r = run_cell(small_root, workload, 2 ** 31 + 3, 2.0, trace,
                 backend="cpu-resilient")
    err, line = result_line(r, DEVICE)
    assert list(line)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(line)[-1] == "checks" and "device" in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    json.loads(json.dumps(line))
    bench = load_benchmark(small_root)
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in cell_metrics(bench, kind,
                                                        workload)}
    assert set(line["metrics"]) <= set(units)
    if not trace:
        assert set(line["metrics"]) == set(units)
    else:
        # the spans' readers find their spans; the device's need a card
        assert line["metrics"]
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
        assert isinstance(m["value"], float) and m["value"] > 0
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
        assert err[-len(line["checks"]):][list(line["checks"]).index(
            name)] == "check %s = %s (limit %s)" % (name, c["value"],
                                                    c["limit"])
    assert "memory_peak_bytes" in line["device"]
