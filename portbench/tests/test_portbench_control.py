"""The control: the reference in the port's place with one guarantee
broken comes out not correct on every seed; unbroken, correct. At a size
a test run holds; `python3 -m portbench.control` runs it at the cells'
own size."""

import pytest

from portbench.control import control_checks

SEEDS = (1, 2 ** 31 + 5, 77)


@pytest.mark.parametrize("workload,control,correct", [
    ("catchup-verify.pubnet", "none", True),
    ("catchup-verify.pubnet", "canonical_s", False),
    ("catchup-verify.pubnet", "cofactored", False),
    ("scp-bursts.tier1", "none", True),
    ("scp-bursts.tier1", "canonical_s", False),
    ("scp-bursts.tier1", "cofactored", False),
])
def test_control(small_root, workload, control, correct):
    for seed in SEEDS:
        checks = control_checks(small_root, workload, seed, control, 6.0, 1)
        assert all(c.ok for c in checks) is correct, (seed, checks)
