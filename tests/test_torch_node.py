"""The port's node (`stellar_core_tpu_torch/main/application.py` and the
layers it wires) held against the JAX package's, through the reference's
node-level test files.

Every case of `tests/test_herder_e2e.py` (8), `tests/test_recovery.py`
(10), `tests/test_offers_depth.py` (8), `tests/test_protocol_matrix.py`
(5 functions over 5 protocol versions) and `tests/test_infer_quorum.py`
(1), the cases of `tests/test_restart_continuity.py` that
`tests/test_torch_history.py` does not mirror (all but
`test_restart_resumes_chain_and_state`), and the third case of
`tests/test_status_manager.py` (the armed upgrades in `info`; the first
two run in `test_torch_history.py`) run on both packages from the
reference's own source (`torch_mirror_harness.Mirror`). `test_catchup.py`
is loaded beside them for the helpers `test_infer_quorum.py` imports (its
own cases run elsewhere). Every admin command, close, admission and
`TestLedger` application is recorded on both sides
(`torch_main_harness.node_records`), and the two records are equal; each
case keeps its own assertions. On the port's side a `TestLedger` built
without a verifier verifies on the host, as the reference's does
(`torch_main_harness.cpu_test_ledger`). Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_main_harness import cpu_test_ledger, node_records  # noqa: E402
from torch_mirror_harness import Mirror  # noqa: E402

FILES = ("test_catchup.py", "test_herder_e2e.py", "test_recovery.py",
         "test_offers_depth.py", "test_protocol_matrix.py",
         "test_infer_quorum.py", "test_restart_continuity.py",
         "test_status_manager.py")
MIRROR = Mirror(FILES, hook=cpu_test_ledger, patch=node_records,
                siblings=("test_catchup",))
MIRRORED_ELSEWHERE = ("test_restart_resumes_chain_and_state",
                      "test_set_get_remove", "test_iteration_in_category_order")
CASES = [c for c in MIRROR.cases(drop=MIRRORED_ELSEWHERE)
         if c[0] != "test_catchup.py"]


def test_mirrors_every_case():
    by_file = {}
    for f, _name, _i in CASES:
        by_file[f] = by_file.get(f, 0) + 1
    assert by_file == {
        "test_herder_e2e.py": 8, "test_recovery.py": 10,
        "test_offers_depth.py": 8, "test_protocol_matrix.py": 25,
        "test_infer_quorum.py": 1, "test_restart_continuity.py": 7,
        "test_status_manager.py": 1}


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    logs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        logs[side] = MIRROR.run(side, case, builtins={
            "tmp_path": d, "monkeypatch": None})
    assert logs["port"] == logs["ref"]
