"""The port's admin API and command line (`stellar_core_tpu_torch/main/
command_handler.py`, `main/commandline.py`) held against the JAX
package's.

24 of the 26 cases of `tests/test_admin.py` and 7 of the 9 of
`tests/test_cli_extra.py` run on both packages from the reference's own
source (`torch_mirror_harness.Mirror`), each side on its own
`Application` and its own temporary directory. Every admin command's
name, status and body shape, every close's LCL sequence and hash, and
every transaction admission's status are recorded on both sides
(`torch_main_harness.node_records`), and the two records are equal; each
case keeps its own assertions. The CLI cases' TOML configs name the CPU
for both backends (`torch_main_harness.CPU_TOML`): the port's defaults
are the card's stacks. Left out, until `simulation/` is ported (ROADMAP
Queue 1 item 9): `test_generateload_endpoint` and
`test_generateload_requires_testing_flag` (the `generateload` endpoint)
`test_gen_fuzz_then_single_input` (the `gen-fuzz` and `fuzz` commands)
and `test_simulate` (the `simulate` command). Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_main_harness import CPU_TOML, node_records  # noqa: E402
from torch_mirror_harness import Mirror  # noqa: E402

MIRROR = Mirror(("test_admin.py", "test_cli_extra.py"), patch=node_records,
                subs=CPU_TOML)
WAIT_FOR_SIMULATION = ("test_generateload_endpoint",
                       "test_generateload_requires_testing_flag",
                       "test_gen_fuzz_then_single_input", "test_simulate")
CASES = MIRROR.cases(drop=WAIT_FOR_SIMULATION)


def test_mirrors_every_case():
    """24 of test_admin.py's 26 and 7 of test_cli_extra.py's 9."""
    by_file = {}
    for f, _name, _i in CASES:
        by_file[f] = by_file.get(f, 0) + 1
    assert by_file == {"test_admin.py": 24, "test_cli_extra.py": 7}


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path, capsys):
    logs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        logs[side] = MIRROR.run(side, case, builtins={
            "tmp_path": d, "capsys": capsys})
    assert logs["port"] == logs["ref"]
