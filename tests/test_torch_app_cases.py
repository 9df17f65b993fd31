"""The reference's cases that need an `Application`, run on the port's.

From `tests/test_tracing.py`: the close-exception and SCP-stall flight
dumps (`:151`, `:185`), the `trace` admin endpoint (`:259`), the
`metrics` prefix filter (`:291`) and the disabled-tracing overhead guard
(`:313`, a wall-clock ratio with the reference's own bound, run on each
package against itself); from `tests/test_verifier_cockpit.py`: the
`verifier` endpoint and the Prometheus roundtrip on a `cpu-resilient`
node (`:330`, `:358`); from `tests/test_state_commitment.py`: the
`checkpoint` admin endpoint over six loaded closes (`:202`); and the
cases other port files left for want of a layer the port now has:
`tests/test_upgrades.py`'s armed upgrades applied through consensus,
`tests/test_bucket.py`'s bucket apply into a ledgertxn root and skip list
in closed headers, and `tests/test_history_matrix.py`'s `new-hist` over
an initialised archive. Each runs on both packages from the reference's
own source (`torch_mirror_harness.Mirror`), with the reference's asserts
on both sides, and each side records every admin command (status and body
shape), close, admission and applied transaction
(`torch_main_harness.node_records`), every `close_ledger`'s header as
XDR (`torch_ops_records.op_records`) and every exception a case expects;
the two records are equal. The port's side names the CPU for its node
(`Config.test_config(..., backend="cpu")`, and both backend lines in
the `new-hist` config; the cockpit cases name `cpu-resilient`
themselves) and its `TpuSigVerifier` is the card's verifier on the host
(`CudaSigVerifier(device="cpu")`). A case that
patches a class gets a monkeypatch of its own side, undone after it.
The other cases of these files run in `test_torch_tracing.py`,
`test_torch_verifier_layers.py`, `test_torch_state_commitment.py`,
`test_torch_simulation.py`, `test_torch_transactions.py`,
`test_torch_bucket.py` and `test_torch_history.py`
(`test_torch_mirror_census.py`). Tolerance: none.
"""

import contextlib

import pytest

import torch_threads  # noqa: F401  (one intra-op thread a worker)
from torch_main_harness import node_records
from torch_mirror_harness import Mirror
from torch_ops_records import (
    CPU_CONFIG_SUBS, TPU_NAME_SUBS, host_verifier, op_records,
    record_raises,
)

APP_CASES = {
    "test_tracing.py": (
        "test_flight_recorder_dump_on_close_exception",
        "test_flight_recorder_dump_on_scp_stall",
        "test_trace_endpoint_start_close_dump_stop",
        "test_metrics_filter_prefix",
        "test_disabled_tracing_close_overhead_within_noise"),
    "test_verifier_cockpit.py": (
        "test_admin_verifier_endpoint_live",
        "test_verifier_gauges_prometheus_roundtrip"),
    "test_state_commitment.py": ("test_checkpoint_admin_endpoint",),
    "test_upgrades.py": ("test_armed_upgrades_apply_through_consensus",),
    "test_bucket.py": ("test_apply_buckets_restores_state",
                       "test_skip_list_nonzero_in_closed_headers"),
    "test_history_matrix.py": (
        "test_initialize_existing_history_store_fails",),
}

# both sides: the bucket case imports `make_header` through the `tests`
# package, which names the reference's; it gets its own side's copy
SUBS = ((r"from tests\.test_ledgertxn import",
         "from test_ledgertxn import"),)
# the port side's `new-hist` config names the CPU for both backends (the
# port's `Config` defaults them to the card's stack)
NEW_HIST_CPU = (
    (r"'UNSAFE_QUORUM = true\\n'",
     r"""'UNSAFE_QUORUM = true\\n' 'SIG_VERIFY_BACKEND = "cpu"\\n' """
     r"""'HASH_BACKEND = "cpu"\\n'"""),)


@contextlib.contextmanager
def app_records(pkg: str, log: list):
    with node_records(pkg, log), op_records(pkg, log,
                                            verifier=host_verifier):
        yield


MIRROR = Mirror(("test_ledgertxn.py",) + tuple(APP_CASES),
                hook=record_raises, patch=app_records, subs=SUBS,
                siblings=("test_ledgertxn",),
                port_subs=CPU_CONFIG_SUBS + TPU_NAME_SUBS + NEW_HIST_CPU)
CASES = [c for c in MIRROR.cases() if c[1] in APP_CASES.get(c[0], ())]


def test_reference_cases_collected():
    assert sorted(c[1] for c in CASES) == sorted(
        n for names in APP_CASES.values() for n in names)


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    logs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            logs[side] = MIRROR.run(side, case, builtins={
                "tmp_path": d, "monkeypatch": mp})
    assert logs["port"] == logs["ref"]
