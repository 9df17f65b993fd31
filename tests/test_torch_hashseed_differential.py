"""The port's hash-seed probe (`stellar_core_tpu_torch/testing/
hashseed_probe.py`) held against itself under two hash seeds and
against the JAX package's probe.

`tests/test_hashseed_differential.py` runs the reference's probe under
`PYTHONHASHSEED` 1 and 97 and requires byte-identical output. Here the
port's probe (`--backend cpu`: the port's default is the card's stacks)
runs under the same two seeds: the two outputs are byte-identical, and
both are byte-equal to the reference probe's output under seed 1 (every
node's header hash, bucket-list hash and txset apply order at heights
1-4). Without `--backend` the probe builds the card's stacks and fails
where there is no card. Tolerance: none.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe(pkg: str, hashseed: int, *extra) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = str(hashseed)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", pkg + ".testing.hashseed_probe",
         "--heights", "4"] + list(extra),
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)


def test_port_probe_identical_under_two_seeds_and_equal_to_reference():
    a = _probe("stellar_core_tpu_torch", 1, "--backend", "cpu")
    b = _probe("stellar_core_tpu_torch", 97, "--backend", "cpu")
    ref = _probe("stellar_core_tpu", 1)
    for r in (a, b, ref):
        assert r.returncode == 0, r.stdout + r.stderr
    assert a.stdout == b.stdout, "consensus output depends on PYTHONHASHSEED"
    assert a.stdout == ref.stdout, "the port's probe differs from the " \
        "reference's"
    data = json.loads(a.stdout)
    assert len(data) == 3
    for heights in data.values():
        assert set(heights) >= {"1", "2", "3", "4"}
    assert any(rec["txs"]
               for heights in data.values() for rec in heights.values())


def test_probe_fails_without_a_card():
    r = _probe("stellar_core_tpu_torch", 1)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA" in r.stderr
