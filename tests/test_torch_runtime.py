"""The port's runtime checks and operator knobs held against the JAX
package's: the thread discipline and lock-order checker
(`stellar_core_tpu_torch/util/threads.py`), fault injection
(`util/faults.py` with its spec parser, the admin `faults` endpoint and
the node's FAULTS table) and the metric catalog.

Every case of `tests/test_threads.py` (13), the cases of
`tests/test_faults.py` that `tests/test_torch_verifier_layers.py` does
not run (all but the breaker state machine, the trip during a drain, the
raising dispatch, which the reference runs on its `TpuSigVerifier`, and
`prewarm_many` through the breaker) and both cases of
`tests/test_metrics_catalog.py` run on both packages from the reference's
own source (`torch_mirror_harness.Mirror`), with every admin command,
close, admission and `TestLedger` application recorded on both sides
(`torch_main_harness.node_records`, which arms the port's checks as
`tests/conftest.py` arms the reference's) and held equal. The catalog
cases run each side's own lint engine with its M1 rule over its own
package and catalog (the port's engine reads `docs/metrics.md` and
`docs/metrics-torch.md`, the metrics only the port registers): every
metric the port registers is documented, and the scanner finds the core
metrics in the port too. Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_main_harness import cpu_test_ledger, node_records  # noqa: E402
from torch_mirror_harness import Mirror  # noqa: E402

MIRROR = Mirror(("test_threads.py", "test_faults.py",
                 "test_metrics_catalog.py"),
                hook=cpu_test_ledger, patch=node_records)
RUN_ELSEWHERE = ("test_breaker_state_machine_virtual_clock",
                 "test_trip_during_drain_returns_correct_results",
                 "test_tpu_flush_recompletes_futures_on_dispatch_exception",
                 "test_resilient_prewarm_routes_through_breaker")
CASES = MIRROR.cases(drop=RUN_ELSEWHERE)


def test_mirrors_every_case():
    by_file = {}
    for f, _name, _i in CASES:
        by_file[f] = by_file.get(f, 0) + 1
    assert by_file == {"test_threads.py": 13, "test_faults.py": 17,
                       "test_metrics_catalog.py": 2}


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path, monkeypatch):
    logs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        logs[side] = MIRROR.run(side, case, builtins={
            "tmp_path": d, "monkeypatch": monkeypatch})
    assert logs["port"] == logs["ref"]
