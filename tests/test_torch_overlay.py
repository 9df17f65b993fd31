"""The port's overlay (`stellar_core_tpu_torch/overlay/`) and fleet view
(`util/fleet.py`) held against the JAX package's.

Every case of `tests/test_overlay.py` (17, the two `slow`-marked
consensus cases included), of `tests/test_survey_load.py` (6) and nine of
the ten of `tests/test_fleet.py` runs on both packages from the
reference's own source (`torch_mirror_harness.Mirror`); the port's side
builds its nodes with its own `simulation/` (`Simulation`, `topologies`,
on the CPU: `torch_sim_harness.SIM_SUBS`), `main/application.py` and
`testing.AppLedgerAdapter`. On both sides every handshake's outcome
(`accept_authenticated_peer`: who accepted whom), every peer drop and its
reason, every floodgate record and broadcast, every envelope the herder
took in and every close (sequence and ledger hash) are recorded, and the
two records are equal, in order. Left out of `test_fleet.py`:
`test_bench_multi_node_leg_emits_fleet_block`, which runs the JAX
package's `bench.py` (the port's bench is ROADMAP Queue 1 item 12).
Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mirror_harness import Mirror  # noqa: E402
from torch_sim_harness import SIM_SUBS  # noqa: E402
import torch_overlay_records as R  # noqa: E402

MIRROR = Mirror(("test_overlay.py", "test_survey_load.py", "test_fleet.py"),
                patch=R.record_overlay,
                port_subs=SIM_SUBS)
CASES = MIRROR.cases(drop=("test_bench_multi_node_leg_emits_fleet_block",))


def test_mirrors_twenty_seven_cases():
    """Thirty-two, since the port has its admin endpoints."""
    by_file = {}
    for f, _n, _i in CASES:
        by_file[f] = by_file.get(f, 0) + 1
    assert by_file == {"test_overlay.py": 17, "test_survey_load.py": 6,
                       "test_fleet.py": 9}


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    sides = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        sides[side] = MIRROR.run(side, case, {"tmp_path": d})
    assert sides["port"] == sides["ref"]
