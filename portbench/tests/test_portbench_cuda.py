"""Each cell run on the card as the benchmark command runs it, with a short
window. Marked `cuda`: the fixture skips where there is no card."""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run only on one")


@pytest.mark.parametrize("workload", ["catchup-verify.pubnet",
                                      "scp-bursts.tier1"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, workload, trace):
    r = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", "4000000000", "--seconds", "6", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ))
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert line["device"]["busy_s"] > 0
        assert line["breakdown"]["device_ops"]
