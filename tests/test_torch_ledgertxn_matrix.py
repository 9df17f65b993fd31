"""The port's LedgerTxn held against the JAX package's, through the
reference's LedgerTxn matrix.

Every collected case of `tests/test_ledgertxn_matrix.py` (187: the tests
of its 18 `Test*` classes, those that take the `root` fixture once over
the in-memory root and once over the SQL root, as its
`params=["memory", "sql"]` gives them) runs on both packages from the
reference's own source (`torch_mirror_harness.Mirror`), one test a case,
with the reference's asserts on both sides. After every `commit` and
`rollback` each side records its root's entries (XDR in key order) and
header (`torch_ops_records.ltx_records`), and the type of every exception
a case expects; the two records are equal byte for byte. Tolerance: none.
"""

import pytest

import torch_threads  # noqa: F401  (one intra-op thread a worker)
from torch_mirror_harness import Mirror
from torch_ops_records import ltx_records, record_raises

FILE = "test_ledgertxn_matrix.py"
COLLECTED = 187          # what `pytest --collect-only` collects from FILE
MIRROR = Mirror((FILE,), hook=record_raises, patch=ltx_records)
CASES = MIRROR.cases()


def test_reference_cases_collected():
    assert len(CASES) == COLLECTED
    classes = {c[1].split(".")[0] for c in CASES}
    assert len(classes) == 18 and all(n.startswith("Test") for n in classes)


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case):
    logs = {side: MIRROR.run(side, case) for side in ("ref", "port")}
    assert logs["port"] == logs["ref"]
