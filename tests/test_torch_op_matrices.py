"""The port's operations held against the JAX package's, through the
reference's operation matrices and vectors.

Every collected case of `tests/test_payment_matrix.py` (23),
`tests/test_path_payment_matrix.py` (41),
`tests/test_path_payment_vectors.py` (18), `tests/test_offer_matrix.py`
(28), `tests/test_exchange_vectors.py` (76),
`tests/test_liabilities_matrix.py` (78),
`tests/test_op_liability_matrix.py` (17),
`tests/test_allow_trust_matrix.py` (10) and
`tests/test_inflation_matrix.py` (4) runs on both packages from the reference's own source
(`torch_mirror_harness.Mirror`), one test a case, with the reference's
asserts on both sides. Each side records every transaction its
`TestLedger` applies (`torch_ops_records.op_records`: the return value,
each result and the header as XDR, a SHA-256 over the root's entries)
and every exception a case expects (`record_raises`); the two records are
equal byte for byte. The port's `TestLedger` verifies on the host here
(the C verifier); `chip_smoke.py`'s T1 runs the same cases on the card.
Tolerance: none, one result code that differs forks consensus.
"""

import functools

import pytest

import torch_threads  # noqa: F401  (one intra-op thread a worker)
from torch_mirror_harness import Mirror
from torch_ops_records import (
    VERIFIER_SUBS, host_verifier, op_records, record_raises,
)

# what `pytest --collect-only` collects from each reference file
FILES = {"test_payment_matrix.py": 23, "test_path_payment_matrix.py": 41,
         "test_path_payment_vectors.py": 18, "test_offer_matrix.py": 28,
         "test_exchange_vectors.py": 76, "test_liabilities_matrix.py": 78,
         "test_op_liability_matrix.py": 17, "test_allow_trust_matrix.py": 10,
         "test_inflation_matrix.py": 4}
MIRROR = Mirror(tuple(FILES), hook=record_raises, subs=VERIFIER_SUBS,
                patch=functools.partial(op_records, verifier=host_verifier))
CASES = MIRROR.cases()


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_cases_collected(name):
    assert sum(c[0] == name for c in CASES) == FILES[name]


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case):
    logs = {side: MIRROR.run(side, case) for side in ("ref", "port")}
    assert logs["port"] == logs["ref"]
