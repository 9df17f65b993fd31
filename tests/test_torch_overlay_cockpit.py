"""The port's overlay and propagation cockpits
(`stellar_core_tpu_torch/overlay/overlay_stats.py`,
`overlay/propagation_stats.py`) held against the JAX package's.

Every case of `tests/test_overlay_cockpit.py` (15) and of
`tests/test_propagation.py` (13) runs on both packages from the
reference's own source (`torch_mirror_harness.Mirror`), the port's nodes
built by its own `simulation/` (on the CPU: `torch_sim_harness.SIM_SUBS`)
and `main/application.py`, with the decisions of
`torch_overlay_records.record_overlay` recorded on both sides and equal,
in order: the `overlaystats`, `propagation` and `health` endpoints, on a
live net and over HTTP, and the Prometheus exposition with its help
catalog included. The endpoint case's load comes from each package's own
`simulation/load_generator.py`. Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mirror_harness import Mirror  # noqa: E402
from torch_sim_harness import SIM_SUBS  # noqa: E402
import torch_overlay_records as R  # noqa: E402

MIRROR = Mirror(("test_overlay_cockpit.py", "test_propagation.py"),
                patch=R.record_overlay,
                port_subs=SIM_SUBS)
CASES = MIRROR.cases()


def test_mirrors_twenty_two_cases():
    """Twenty-eight, since the port has its admin endpoints."""
    by_file = {}
    for f, _n, _i in CASES:
        by_file[f] = by_file.get(f, 0) + 1
    assert by_file == {"test_overlay_cockpit.py": 15,
                       "test_propagation.py": 13}
    # the disabled-cockpit case reads the endpoints on both sides
    src = MIRROR.sides["port"]["mods"]["test_propagation.py"]
    assert "command_handler" in \
        src.test_propagation_disabled_by_config.__code__.co_names


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    sides = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        sides[side] = MIRROR.run(side, case, {"tmp_path": d})
    assert sides["port"] == sides["ref"]
