"""Which port test holds each of the reference's test files, and what it
leaves out.

`CENSUS` has one row for every `tests/test_*.py` of the JAX package: the
port files that check it against the reference (by running its cases on
both packages through `torch_mirror_harness.Mirror`, or by a differential
of their own on the same inputs), the cases they leave out with the
reason, and for a file no port test can hold, the reason. One test a row
checks that the reference file is there, that each named port file
exists and mentions it, and that each case left out is one of its tests.
A reference file without a row fails `test_every_reference_file_has_a_row`.
"""

import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))

SLOW = "marked `slow` in the reference, which tier-1 deselects"
BENCH = ("runs the JAX package's `bench.py`; the port's bench comes with "
         "its benchmark PR (ROADMAP Queue 1 item 3)")

# reference file: (port files, {case left out: reason}, reason no port
# file holds it, or None)
CENSUS = {
    "test_admin.py": (("test_torch_admin.py",), {}, None),
    "test_allow_trust_matrix.py": (("test_torch_op_matrices.py",), {}, None),
    "test_apply_cockpit.py": (("test_torch_apply_cockpit.py",), {}, None),
    "test_batch_boundary.py": (("test_torch_simulation.py",), {
        "test_live_path_latency_slo": SLOW}, None),
    "test_batch_hasher.py": (("test_torch_batch_hasher.py",
                              "test_torch_hasher_layers.py"), {}, None),
    "test_bench_compare.py": ((), {}, (
        "tests `tools/bench_compare.py` over the JAX package's committed "
        "BENCH_*/MULTICHIP_* records and `bench.py`'s tiny leg; the port's "
        "bench and its records come with its benchmark PR (ROADMAP Queue 1 "
        "item 3)")),
    "test_bucket.py": (("test_torch_bucket.py", "test_torch_app_cases.py"),
                       {}, None),
    "test_bucketdb.py": (("test_torch_bucketdb.py",), {}, None),
    "test_catchup.py": (("test_torch_catchup.py", "test_torch_history.py",
                         "test_torch_node.py"), {}, None),
    "test_chaos_soak.py": (("test_torch_simulation.py",), {
        "test_chaos_soak_long": SLOW}, None),
    "test_cli_extra.py": (("test_torch_admin.py", "test_torch_fuzz.py"),
                          {}, None),
    "test_close_meta_stream.py": (("test_torch_close_meta_stream.py",), {},
                                  None),
    "test_cold_start.py": ((), {}, (
        "a wall-clock ratio on JAX's persistent compile cache across a "
        "restart; the port's kernels are built by nvcc into "
        "`stellar_core_tpu_torch/build/` and have no compile cache")),
    "test_crypto.py": (("test_torch_crypto_util.py",), {
        "test_tpu_kernel_matches_cpu_semantics": (
            SLOW + "; its reference side compiles the JAX kernel (85.7 s in "
            "a six-worker run), and test_torch_verifier.py holds the port's "
            "kernel route against the C verifier on the adversarial batch")},
        None),
    "test_ed25519_adversarial.py": (("test_torch_ed25519.py",
                                     "test_torch_verifier.py"), {}, None),
    "test_exchange_vectors.py": (("test_torch_op_matrices.py",), {}, None),
    "test_faults.py": (("test_torch_runtime.py",
                        "test_torch_verifier_layers.py"), {}, None),
    "test_fee_bump_vectors.py": (("test_torch_tx_matrices.py",), {}, None),
    "test_fleet.py": (("test_torch_overlay.py",), {
        "test_bench_multi_node_leg_emits_fleet_block": BENCH}, None),
    "test_fuzz.py": (("test_torch_fuzz.py",), {}, None),
    "test_hashseed_differential.py": (
        ("test_torch_hashseed_differential.py",), {}, None),
    "test_herder_e2e.py": (("test_torch_node.py",), {}, None),
    "test_history_matrix.py": (("test_torch_history.py",
                                "test_torch_app_cases.py"), {}, None),
    "test_infer_quorum.py": (("test_torch_node.py",), {}, None),
    "test_inflation_matrix.py": (("test_torch_op_matrices.py",), {}, None),
    "test_ingress.py": (("test_torch_herder.py",), {}, None),
    "test_invariants.py": (("test_torch_invariants.py",), {}, None),
    "test_ledgertxn.py": (("test_torch_ledgertxn.py",), {}, None),
    "test_ledgertxn_matrix.py": (("test_torch_ledgertxn_matrix.py",), {},
                                 None),
    "test_liabilities_matrix.py": (("test_torch_op_matrices.py",), {}, None),
    "test_metrics_catalog.py": (("test_torch_runtime.py",), {}, None),
    "test_multichip.py": (("test_torch_mesh.py",), {}, None),
    "test_multisig_merge_queue_matrix.py": (("test_torch_tx_matrices.py",),
                                            {}, None),
    "test_native_apply.py": (("test_torch_native_apply.py",), {}, None),
    "test_native_prep.py": (("test_torch_native_prep.py",), {}, None),
    "test_native_sanitized.py": (("test_torch_native_sanitized.py",), {},
                                 None),
    "test_native_xdr.py": (("test_torch_native_xdr.py",), {}, None),
    "test_offer_matrix.py": (("test_torch_op_matrices.py",), {}, None),
    "test_offers_depth.py": (("test_torch_node.py",), {}, None),
    "test_op_liability_matrix.py": (("test_torch_op_matrices.py",), {},
                                    None),
    "test_overlay.py": (("test_torch_overlay.py",), {}, None),
    "test_overlay_cockpit.py": (("test_torch_overlay_cockpit.py",), {},
                                None),
    "test_overlay_tcp.py": (("test_torch_overlay_tcp.py",
                             "test_torch_overlay_tcp_auth.py",
                             "test_torch_overlay_tcp_peers.py"), {}, None),
    "test_path_payment_matrix.py": (("test_torch_op_matrices.py",), {},
                                    None),
    "test_path_payment_vectors.py": (("test_torch_op_matrices.py",), {},
                                     None),
    "test_payment_matrix.py": (("test_torch_op_matrices.py",), {}, None),
    "test_propagation.py": (("test_torch_overlay_cockpit.py",), {}, None),
    "test_protocol_matrix.py": (("test_torch_node.py",), {}, None),
    "test_quorum_churn.py": (("test_torch_simulation.py",), {}, None),
    "test_quorum_intersection.py": (("test_torch_herder.py",), {}, None),
    "test_recovery.py": (("test_torch_node.py",), {}, None),
    "test_restart_continuity.py": (("test_torch_history.py",
                                    "test_torch_node.py"), {}, None),
    "test_scenarios.py": (("test_torch_scenarios.py",), {
        "test_bench_scenario_end_to_end_and_schema": BENCH,
        "test_scenario_soak": "the `slow` soaks, which tier-1 deselects"},
        None),
    "test_scp.py": (("test_torch_scp.py",), {}, None),
    "test_scp_ballot_vectors.py": (("test_torch_scp.py",), {}, None),
    "test_scp_ballot_vectors2.py": (("test_torch_scp.py",), {}, None),
    "test_scp_cockpit.py": (("test_torch_simulation.py",), {}, None),
    "test_scp_nomination_vectors.py": (("test_torch_scp.py",), {}, None),
    "test_simulation.py": (("test_torch_simulation.py",), {
        "test_core4_externalizes_ledgers": SLOW}, None),
    "test_slot_timeline.py": (("test_torch_herder.py",), {}, None),
    "test_state_commitment.py": (("test_torch_state_commitment.py",
                                  "test_torch_simulation.py",
                                  "test_torch_app_cases.py"), {}, None),
    "test_static_analysis.py": (("test_torch_static_analysis.py",), {},
                                None),
    "test_status_manager.py": (("test_torch_history.py",
                                "test_torch_node.py"), {}, None),
    "test_surge_pricing.py": (("test_torch_herder.py",), {}, None),
    "test_survey_load.py": (("test_torch_overlay.py",), {}, None),
    "test_threads.py": (("test_torch_runtime.py",), {}, None),
    "test_tracing.py": (("test_torch_tracing.py", "test_torch_app_cases.py"),
                        {"test_replay_phase_breakdown_accounts_for_wall":
                         SLOW + "; " + BENCH}, None),
    "test_transactions.py": (("test_torch_transactions.py",), {}, None),
    "test_tx_queue.py": (("test_torch_herder.py",), {}, None),
    "test_txenvelope_matrix.py": (("test_torch_tx_matrices.py",), {}, None),
    "test_txresults_matrix.py": (("test_torch_tx_matrices.py",), {}, None),
    "test_upgrades.py": (("test_torch_transactions.py",
                          "test_torch_app_cases.py"), {}, None),
    "test_upgrades_matrix.py": (("test_torch_upgrades_matrices.py",), {},
                                None),
    "test_upgrades_matrix2.py": (("test_torch_upgrades_matrices.py",), {},
                                 None),
    "test_util.py": (("test_torch_crypto_util.py",), {}, None),
    "test_verifier_cockpit.py": (("test_torch_verifier_layers.py",
                                  "test_torch_app_cases.py"), {}, None),
    "test_verify_fleet.py": (("test_torch_fleet.py", "test_torch_mesh.py"),
                             {}, None),
    "test_work.py": (("test_torch_work.py",), {}, None),
    "test_xdr.py": (("test_torch_xdr.py",), {}, None),
}


def _read(name: str) -> str:
    with open(os.path.join(HERE, name)) as fh:
        return fh.read()


def test_every_reference_file_has_a_row():
    ref = sorted(f for f in os.listdir(HERE) if re.fullmatch(
        r"test_\w+\.py", f) and not f.startswith("test_torch_"))
    assert ref == sorted(CENSUS)


@pytest.mark.parametrize("ref", sorted(CENSUS))
def test_census_row(ref):
    ports, dropped, reason = CENSUS[ref]
    assert os.path.exists(os.path.join(HERE, ref))
    assert bool(ports) != bool(reason), "a row names port files or a reason"
    stem = re.compile(r"\b%s\b" % re.escape(ref[:-3]))
    for port in ports:
        assert port.startswith("test_torch_")
        assert stem.search(_read(port)), "%s does not mention %s" % (port,
                                                                     ref)
    defined = set(re.findall(r"(?m)^\s*def (test_\w+)\(", _read(ref)))
    for case, why in dropped.items():
        assert case in defined and why
