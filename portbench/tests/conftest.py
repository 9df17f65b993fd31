"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
(BENCHMARK.json, configurations, traffic, metric readers) cut to a size a
test run holds, which `run_cell` and the control read in place of the
checkout's."""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the cuts: a checkpoint of 4 ledgers x 60 payments over 300 accounts, 6
# of them multisig; the tier-1 shape as it stands
SMALL = {
    ("configs", "pubnet-catchup"): {"ledger_entries": 300,
                                    "multisig_accounts": 6,
                                    "checkpoint_frequency": 4,
                                    "max_tx_set_operations": 60},
    ("traffic", "catchup-verify"): {"reference_sample": 24},
}


def copy_data(dst: str, cuts=SMALL) -> str:
    """BENCHMARK.json and portbench's data directories under `dst`, with
    `cuts` applied; returns `dst`."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(REPO, "portbench", d),
                        os.path.join(dst, "portbench", d))
    for (d, name), changes in cuts.items():
        path = os.path.join(dst, "portbench", d, name + ".json")
        with open(path) as fh:
            blob = json.load(fh)
        blob.update(changes)
        with open(path, "w") as fh:
            json.dump(blob, fh)
    return dst


@pytest.fixture
def small_root(tmp_path):
    return copy_data(str(tmp_path / "root"))


@pytest.fixture(autouse=True)
def _own_tmpdir(tmp_path, monkeypatch):
    # the runs' data directories and the port's files go under the test's
    # own directory
    d = tmp_path / "tmpdir"
    d.mkdir()
    monkeypatch.setenv("TMPDIR", str(d))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(d))
