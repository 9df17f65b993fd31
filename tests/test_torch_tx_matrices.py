"""The port's transaction envelopes, signatures, merges, queue and fee
bumps held against the JAX package's, through the reference's matrices.

Every collected case of `tests/test_txenvelope_matrix.py` (25),
`tests/test_multisig_merge_queue_matrix.py` (38),
`tests/test_fee_bump_vectors.py` (17) and `tests/test_txresults_matrix.py`
(22) runs on both packages from the reference's own source
(`torch_mirror_harness.Mirror`), one test a case, with the reference's
asserts on both sides: multisig thresholds, twenty signers, bad, missing,
duplicate and extra signatures, pre-auth and hash-x signers, merges in
one set and in the queue, fee bumps' outer and inner envelopes. Each side
records every transaction its `TestLedger` applies (return value, each
result with a fee bump's inner result, the header, a SHA-256 over the
root's entries; `torch_ops_records.op_records`) and every exception a
case expects; the records are equal byte for byte. Where a case hands a
queue or a check no verifier, both sides pass the ledger's
(`torch_ops_records.VERIFIER_SUBS`). The port's `TestLedger` verifies on
the host here; `chip_smoke.py`'s T1 runs the same cases on the card.
Tolerance: none.
"""

import functools

import pytest

import torch_threads  # noqa: F401  (one intra-op thread a worker)
from torch_mirror_harness import Mirror
from torch_ops_records import (
    VERIFIER_SUBS, host_verifier, op_records, record_raises,
)

# what `pytest --collect-only` collects from each reference file
FILES = {"test_txenvelope_matrix.py": 25,
         "test_multisig_merge_queue_matrix.py": 38,
         "test_fee_bump_vectors.py": 17, "test_txresults_matrix.py": 22}
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
