"""The port's ledger upgrades held against the JAX package's, through the
reference's upgrade matrices.

Every collected case of `tests/test_upgrades_matrix.py` (31: protocol
upgrades over offers and liabilities, reserve changes) and
`tests/test_upgrades_matrix2.py` (26: upgrade listing and validation, an
`Application`'s ledger manager applying each upgrade type, history rows,
expiry, and three simulated networks voting on an upgrade) runs on both
packages from the reference's own source (`torch_mirror_harness.Mirror`;
`tests/test_ledgertxn.py` is loaded beside them for the `make_header`
both import, its own cases run in `test_torch_ledgertxn.py`), one test a
case, with the reference's asserts on both sides. Each side records every
transaction its `TestLedger` applies and every close its ledger manager
makes (headers as XDR, `torch_ops_records.op_records`) and every exception
a case expects; the two records are equal byte for byte. The port's side
names the CPU for its `Application`s and simulated nodes
(`torch_sim_harness.SIM_SUBS`, `Config.test_config(..., backend="cpu")`).
Tolerance: none.
"""

import functools

import pytest

import torch_threads  # noqa: F401  (one intra-op thread a worker)
from torch_mirror_harness import Mirror
from torch_ops_records import (
    CPU_CONFIG_SUBS, host_verifier, op_records, record_raises,
)
from torch_sim_harness import SIM_SUBS

# what `pytest --collect-only` collects from each reference file
FILES = {"test_upgrades_matrix.py": 31, "test_upgrades_matrix2.py": 26}
MIRROR = Mirror(("test_ledgertxn.py",) + tuple(FILES), hook=record_raises,
                patch=functools.partial(op_records, verifier=host_verifier),
                siblings=("test_ledgertxn",),
                port_subs=SIM_SUBS + CPU_CONFIG_SUBS)
CASES = [c for c in MIRROR.cases() if c[0] in FILES]


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_cases_collected(name):
    assert sum(c[0] == name for c in CASES) == FILES[name]


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    logs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        logs[side] = MIRROR.run(side, case, builtins={"tmp_path": d})
    assert logs["port"] == logs["ref"]
