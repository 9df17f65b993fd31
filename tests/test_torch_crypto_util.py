"""The port's crypto and utility modules held against the JAX package's,
through `tests/test_crypto.py` and `tests/test_util.py`.

Every collected case of the two files but one runs on both packages from
the reference's own source (`torch_mirror_harness.Mirror`), one test a
case, with the reference's asserts on both sides and every exception a
case expects recorded equal: SHA-256, HMAC and HKDF vectors, SipHash,
strkeys, signing and the verify cache, curve25519, the C batch verifier;
the virtual clock and timers, the eviction cache, metrics, the XDR
stream, the slow-execution log. The port's side reads the reference's
`TpuSigVerifier` as the card's verifier on the host
(`CudaSigVerifier(device="cpu")`). Left out:
`test_crypto.py::test_tpu_kernel_matches_cpu_semantics`, marked `slow`
in the reference: its reference side compiles the JAX kernel (85.7 s in
a six-worker run), and the port's kernel route is held against the
reference's kernel and the C verifier on the same adversarial batch in
`test_torch_verifier.py`. Tolerance: none.
"""

import pytest

import torch_threads  # noqa: F401  (one intra-op thread a worker)
from torch_mirror_harness import Mirror
from torch_ops_records import TPU_NAME_SUBS, record_raises

# what `pytest --collect-only` collects from each reference file
FILES = {"test_crypto.py": 10, "test_util.py": 13}
DROPPED = ("test_tpu_kernel_matches_cpu_semantics",)
MIRROR = Mirror(tuple(FILES), hook=record_raises, port_subs=TPU_NAME_SUBS)
CASES = MIRROR.cases(drop=DROPPED)


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_cases_collected(name):
    dropped = len(DROPPED) if name == "test_crypto.py" else 0
    assert sum(c[0] == name for c in CASES) + dropped == FILES[name]


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    logs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        logs[side] = MIRROR.run(side, case, builtins={"tmp_path": d})
    assert logs["port"] == logs["ref"]
