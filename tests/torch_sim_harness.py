"""What the simulation mirrors share: the port side's source rewrites
and the scenario blocks' comparable view.

The port has its own `simulation/` (`Simulation`, `topologies`,
`LoadGenerator`), scenario lab, fuzzer and hash-seed probe, each on the
card's stacks unless the CPU is named. `SIM_SUBS` are the
`torch_mirror_harness.Mirror` `port_subs` that name the CPU in a mirrored
reference test's port side: every `Simulation(...)`,
`topologies.<builder>(...)`, `run_scenario(...)`, `run_suite(...)`,
`fuzz_tx(...)`, `fuzz_overlay(...)`, `gen_input(...)` and `run_one(...)`
call gets `backend="cpu"` (wrapped as `functools.partial(f,
backend="cpu")(...)`, which keeps the call's own arguments as they are).

`comparable(block)` is a scenario block without the fields that read the
host's clock, so that two runs of one (scenario, seed, scale) give equal
views: the slot journal stamps each event with `time.perf_counter()`
beside the app clock (`util/slot_timeline.py`), and the fleet view's
slot latencies, externalize skews and propagation hop latencies are
measured on it; the flood scenario's p95 ratios, each block's `value` and
the records that carry those numbers follow them; the checkpoint
scenario's light-client verify timings read the host's clock directly.
The churn scenario's schedule also depends on the host's clock: its
archive is written and read by `cp` subprocesses, and the fleet's
virtual clocks move on while one runs, so its slot count, stragglers,
time to tracking and number of common heights vary from run to run (two
runs of the reference differ in them too); its view keeps the header
hashes' agreement, the recovery cycles and the topology. The view keeps
everything else: every count, every virtual-clock latency (the
tx-lifecycle funnel's), every assertion of the block.

It imports only the port and the standard library, so `chip_smoke.py`
can use it where the JAX package is absent.
"""

import json

_CPU_CALLS = ("Simulation", "run_scenario", "run_suite", "fuzz_tx",
              "fuzz_overlay", "gen_input", "run_one")

# the mirror's port-side rewrites (see the module docstring)
SIM_SUBS = (
    (r"(?<![\w.])((?:[A-Za-z_]\w*\.)*(?:%s|topologies\.\w+))\("
     % "|".join(_CPU_CALLS),
     r'__import__("functools").partial(\1, backend="cpu")('),)

# host-clock fields of every block: (sub-block, keys)
_FLEET_KEYS = ("slot_latency_p50_ms", "slot_latency_p95_ms",
               "externalize_skew_p50_ms", "externalize_skew_max_ms")
# record metrics whose values are host-clock numbers
_HOST_RECORDS = {"scenario_slot_latency_p95",
                 "scenario_externalize_skew_max",
                 "scenario_flood_latency_ratio",
                 "scenario_flood_prop_overhead_ratio",
                 "prop_hop_latency_p50_ms", "prop_hop_latency_p95_ms",
                 "scenario_checkpoint_verify_p95"}
_HOST_ASSERTIONS = {"p95_ratio_on_vs_off", "prop_overhead_ratio",
                    "verify_p50_ms", "verify_p95_ms"}
# the churn scenario's schedule follows its archive's subprocesses
_CHURN_FLEET = ("slot_count", "stragglers")
_CHURN_ASSERTIONS = {"recovery_time_to_tracking_s",
                     "common_heights_hash_equal"}
_CHURN_RECORDS = {"scenario_recovery_time_to_tracking"}


def comparable(block: dict) -> dict:
    """`block` (one scenario's, as `run_scenario` returns it) without its
    host-clock fields; a copy."""
    b = json.loads(json.dumps(block))
    churn = b.get("scenario") == "churn"
    b.pop("value", None)
    for key in ("fleet", "baseline_fleet", "control_fleet"):
        sub = b.get(key)
        if isinstance(sub, dict):
            for k in _FLEET_KEYS + (_CHURN_FLEET if churn else ()):
                sub.pop(k, None)
    prop = b.get("propagation")
    if isinstance(prop, dict):
        for k in ("hop_latency_p50_ms", "hop_latency_p95_ms"):
            prop.pop(k, None)
    drop = _HOST_ASSERTIONS | (_CHURN_ASSERTIONS if churn else set())
    for k in drop:
        b.get("assertions", {}).pop(k, None)
    host = _HOST_RECORDS | (_CHURN_RECORDS if churn else set())
    for r in b.get("records", []):
        if r["metric"] in host:
            r.pop("value")
    return b
