"""The port's scenario lab (`stellar_core_tpu_torch/testing/scenarios.py`,
with `testing/bench_records.py`) held against the JAX package's.

Every tier-1 case of `tests/test_scenarios.py` but one runs on both
packages from the reference's own source (`torch_mirror_harness.Mirror`),
the port's scenarios on the CPU (`torch_sim_harness.SIM_SUBS`), each case
keeping its own assertions (every scenario asserts its own invariants as
it runs: liveness, hash equality at every common height, the recovery
path's metrics, the ban, the pool's and the ingress tier's bounds, the
light clients' verdicts). Every block a case gets from `run_scenario` is
recorded on both sides as `torch_sim_harness.comparable` gives it, and the
two records are equal: every count, virtual-clock latency, assertion,
topology and record, less the fields that read the host's clock (the
fleet view's slot latencies and skews, measured on the slot journal's
`perf_counter` stamps, and what follows them; the light clients' verify
timings; the churn scenario's schedule, which follows its archive's `cp`
subprocesses: two runs of the reference differ in exactly these).

Left out: `test_bench_scenario_end_to_end_and_schema`, which runs the
reference's `bench.py --scenario surge --record`; the port runs no
`bench.py`. In its place the port's surge block, records included (made
by `testing/bench_records.py`), is held equal to the reference's, each
record valid under the reference's own schema check. The `slow` soaks
are left out as tier-1 leaves them out.

Port-only: `run_scenario` with no backend named builds the card's
stacks and raises where there is no card. Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mirror_harness import Mirror  # noqa: E402
from torch_sim_harness import SIM_SUBS, comparable  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def record_blocks(side, pkg, mods, log) -> None:
    """Every block `run_scenario` returns to a case, recorded as
    `comparable` gives it."""
    mod = mods["test_scenarios.py"]
    run = mod.run_scenario

    def run_scenario(*a, **kw):
        block = run(*a, **kw)
        log.append(comparable(block))
        return block

    mod.run_scenario = run_scenario


MIRROR = Mirror(("test_scenarios.py",), hook=record_blocks,
                port_subs=SIM_SUBS)
CASES = MIRROR.cases(drop=("test_bench_scenario_end_to_end_and_schema",
                           "test_scenario_soak"))


def test_mirrors_every_tier1_case_but_the_bench_one():
    assert sorted(n for _f, n, _i in CASES) == [
        "test_bench_scenario_gate_fails_on_regression",
        "test_checkpoint_scenario_serves_light_clients",
        "test_churn_scenario_recovers_via_recovery_path",
        "test_flood_scenario_caps_and_bans_the_flooder",
        "test_overload_scenario_ingress_holds_the_line",
        "test_partition_scenario_heals_via_scp_state",
        "test_scenario_registry_is_cataloged",
        "test_surge_scenario_evicts_by_fee_bid",
        "test_unknown_scenario_raises"]


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    sides = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        sides[side] = MIRROR.run(side, case, {"tmp_path": d})
    assert sides["port"] == sides["ref"]


def test_surge_block_and_records_equal_the_reference(tmp_path):
    """What the left-out `bench.py --scenario surge` case checks of the
    block, on the port's own block: its records made by
    `testing/bench_records.py`, each valid under the reference's schema
    check, and the block (records included) equal to the reference's."""
    from stellar_core_tpu.testing import scenarios as ref
    from stellar_core_tpu_torch.testing import scenarios as port
    from tools import bench_compare as bc
    p = port.run_scenario("surge", seed=1, workdir=str(tmp_path / "p"),
                          backend="cpu")
    r = ref.run_scenario("surge", seed=1, workdir=str(tmp_path / "r"))
    assert [rec["metric"] for rec in p["records"]] == [
        "scenario_slot_latency_p95", "scenario_externalize_skew_max",
        "tx_latency_total_p50_ms", "tx_latency_total_p95_ms"]
    for rec in p["records"]:
        assert bc.validate_record(rec, "surge") == []
    assert p["records"][2:] == r["records"][2:]
    assert comparable(p) == comparable(r)


def test_run_scenario_raises_without_a_card(tmp_path):
    """No backend named: the scenario's fleet is built on the card's
    stacks, and here (no card, no CPU fallback) the first node raises."""
    import torch

    from stellar_core_tpu_torch.testing.scenarios import run_scenario
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario("surge", seed=1, workdir=str(tmp_path))
