"""The port's admin API and command line (`stellar_core_tpu_torch/main/
command_handler.py`, `main/commandline.py`) held against the JAX
package's.

Every case of `tests/test_admin.py` (26) and of `tests/test_cli_extra.py`
(9) runs on both packages from the reference's own
source (`torch_mirror_harness.Mirror`), each side on its own
`Application` and its own temporary directory. Every admin command's
name, status and body shape, every close's LCL sequence and hash, and
every transaction admission's status are recorded on both sides
(`torch_main_harness.node_records`), and the two records are equal; each
case keeps its own assertions. The CLI cases' TOML configs name the CPU
for both backends (`torch_main_harness.CPU_TOML`): the port's defaults
are the card's stacks. The `simulate`, `gen-fuzz` and `fuzz` commands,
which read no config in those cases, get one naming the CPU on the port's
side, and their first output line is read (the port's print their launch
counts on a second; `torch_main_harness.CLI_CPU_CONF`). Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_main_harness import (  # noqa: E402
    CLI_CPU_CONF, CPU_TOML, node_records,
)
from torch_mirror_harness import Mirror  # noqa: E402

MIRROR = Mirror(("test_admin.py", "test_cli_extra.py"), patch=node_records,
                subs=CPU_TOML, port_subs=CLI_CPU_CONF)
CASES = MIRROR.cases()


def test_mirrors_every_case():
    """All 26 of test_admin.py and all 9 of test_cli_extra.py."""
    by_file = {}
    for f, _name, _i in CASES:
        by_file[f] = by_file.get(f, 0) + 1
    assert by_file == {"test_admin.py": 26, "test_cli_extra.py": 9}


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path, capsys):
    logs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        logs[side] = MIRROR.run(side, case, builtins={
            "tmp_path": d, "capsys": capsys})
    assert logs["port"] == logs["ref"]
