"""BENCHMARK.json against the contract's shapes, and the harness finding
configurations, traffic mixes and per-layer metrics by name, new files
among them."""

import json
import os
import re

import pytest

from portbench.run import (cell_metrics, find_cell, load_benchmark,
                           metric_reader, run_cell)
from portbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_shapes():
    b = load_benchmark(REPO)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        # every cell that reports this metric reports the one it moves
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:
        assert len(cell_metrics(b, "end_to_end", w)) >= 2
        assert cell_metrics(b, "per_layer", w)
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_is_found():
    b = load_benchmark(REPO)
    for w in b["workloads"]:
        _cell, config, traffic = find_cell(REPO, b, w["name"])
        assert config["name"] == w["config"]
        assert os.path.exists(os.path.join(
            REPO, "portbench", "kinds", traffic["kind"] + ".py"))
    for m in b["per_layer"]:
        assert callable(metric_reader(REPO, m["name"]))


def test_new_files_alone_add_a_cell(small_root):
    """A configuration, a traffic mix and a per-layer metric, each a new
    file, and a new cell naming them: the harness runs it."""
    pb = os.path.join(small_root, "portbench")
    with open(os.path.join(pb, "configs", "pubnet-tier1-watcher.json")) as f:
        cfg = json.load(f)
    cfg.update(name="three-orgs", orgs=3, outer_threshold=2)
    with open(os.path.join(pb, "configs", "three-orgs.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "scp-bursts.json")) as f:
        mix = json.load(f)
    mix["steps"] = mix["steps"][2:]
    with open(os.path.join(pb, "traffic", "scp-ballots.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "metrics", "scp.decode_ms.py"), "w") as f:
        f.write("from portbench.yardstick.readers import mean_ms\n\n\n"
                "def read(ctx):\n"
                "    return mean_ms(b - a for (n, a, b) in ctx.spans\n"
                "                   if n == 'scp.decode')\n")
    path = os.path.join(small_root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append({"name": "three-orgs", "source": "a test",
                         "file": "portbench/configs/three-orgs.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "scp-ballots.three", "config":
                           "three-orgs", "traffic": "scp-ballots",
                           "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if "scp-bursts.tier1" in m.get("workloads", []):
            m["workloads"].append("scp-ballots.three")
    b["per_layer"].append({"name": "scp.decode_ms", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "herder", "moves": "envelope_ms",
                           "workloads": ["scp-ballots.three"]})
    with open(path, "w") as f:
        json.dump(b, f)
    r = run_cell(small_root, "scp-ballots.three", 41, 5.0, True,
                 backend="cpu-resilient")
    assert r["correct"], r["checks"]
    assert r["attempted"] == 4 * 9
    assert r["metrics"]["scp.decode_ms"]["value"] > 0
    r = run_cell(small_root, "scp-ballots.three", 41, 5.0, False,
                 backend="cpu-resilient")
    assert set(r["metrics"]) == {"envelope_ms", "setup_s"}


def test_an_unknown_cell_is_refused(small_root):
    with pytest.raises(SystemExit):
        find_cell(small_root, load_benchmark(small_root), "no-such.cell")
