"""The port's simulation (`stellar_core_tpu_torch/simulation/`) held
against the JAX package's.

Every tier-1 case (the `slow`-marked ones left out, as the tier-1 run
leaves them out) of `tests/test_simulation.py` (13), `test_scp_cockpit.py`
(6), `test_quorum_churn.py` (3) and `test_chaos_soak.py` (7: the three
seeds of the deterministic soak, the partition over the real overlay and
the three archive legs), and `test_state_commitment.py`'s 30-ledger
replay (which drives the load generator), runs on both packages from the
reference's own source (`torch_mirror_harness.Mirror`). The port's side
builds its fleets with its own `Simulation` and `topologies` on the CPU
(`torch_sim_harness.SIM_SUBS`); on both sides
`torch_overlay_records.record_overlay` records every handshake, peer
drop, floodgate record and broadcast, every envelope the herder took in
and every close (sequence and ledger hash), and the two records are
equal, in order. Each case keeps its own assertions.

`tests/test_batch_boundary.py`'s six tier-1 cases run on the port's side
only, each held to the numbers the reference test itself asserts, at the
test's own sizes, with the reference's TPU names pointed at the port's
(`TpuSigVerifier` at `CudaSigVerifier`, "tpu-async" at "cuda-async") and
the port's card stacks on `device="cpu"` (the kernel's plain version).
Every one of them builds the reference's TPU verifier on its reference
side, whose XLA compile on this host's CPU costs 35 to 86 s a bucket
(`test_txset_100_txs_at_most_2_dispatches` 83 s and
`test_envelope_verifies_accumulate_one_dispatch` 86 s alone;
`test_txset_prewarm_correct_rejections` 45 s and
`test_aot_warmup_compiles_all_buckets` 36 s when those two run first),
more than the tier-1 budget of the simulation files together; and the
async cases' records (which set a verify lands in, at which virtual
instant) follow the verify threads' host timing on either package. In
`test_core3_consensus_with_async_backend` the port's CPU fleet decides
with the C verifier: its three nodes' virtual clocks run on while their
verify threads work, and the plain version's seconds a batch let the
stuck timer fire first.

Port-only: a `Simulation` or `topologies` fleet built with no backend
named builds the card's stacks and raises where there is no card (no CPU
fallback). Tolerance: none.
"""

import contextlib
import functools
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_main_harness import cpu_test_ledger  # noqa: E402
from torch_mirror_harness import Mirror  # noqa: E402
from torch_ops_records import TPU_NAME_SUBS  # noqa: E402
from torch_sim_harness import SIM_SUBS  # noqa: E402
import torch_overlay_records as R  # noqa: E402

SIM = Mirror(("test_simulation.py", "test_scp_cockpit.py",
              "test_quorum_churn.py", "test_chaos_soak.py"),
             patch=R.record_overlay, port_subs=SIM_SUBS)
SIM_CASES = SIM.cases(drop=("test_core4_externalizes_ledgers",
                            "test_chaos_soak_long"))

COMMIT = Mirror(("test_state_commitment.py",), patch=R.record_overlay)
COMMIT_CASES = [c for c in COMMIT.cases() if c[1] ==
                "test_thirty_ledger_replay_oracle_checkpoints_and_proofs"]

# a fleet on real-time verify threads whose virtual clocks run on while a
# batch verifies: the kernel's plain version (seconds a batch on the CPU)
# lets the stuck timer fire before the first slot externalizes, so here
# the CPU fleet decides with the C verifier (`_c_decides`)
C_DECIDES = ("test_core3_consensus_with_async_backend",)


@contextlib.contextmanager
def _card_on_cpu(pkg: str, _log: list):
    """On the port's side, `make_verifier` and `make_hasher` build the
    card's stacks on `device="cpu"` (as the application and every module
    see them)."""
    if not pkg.endswith("_torch"):
        yield
        return
    bv = __import__(pkg + ".crypto.batch_verifier", fromlist=["x"])
    bh = __import__(pkg + ".crypto.batch_hasher", fromlist=["x"])
    app = __import__(pkg + ".main.application", fromlist=["x"])
    saved = [(bv, "make_verifier", bv.make_verifier),
             (app, "make_verifier", app.make_verifier),
             (bh, "make_hasher", bh.make_hasher)]

    def on_cpu(fn):
        @functools.wraps(fn)
        def wrapper(backend="cuda", *a, **kw):
            if backend.startswith("cuda"):
                kw["device"] = "cpu"
            return fn(backend, *a, **kw)
        return wrapper

    for mod, name, fn in saved:
        setattr(mod, name, on_cpu(fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def _c_decides():
    """The port's `CudaSigVerifier.verify_many` decides with the C
    verifier, counting one dispatch a call (the async layer, the breaker
    and the queue stay as they are)."""
    from stellar_core_tpu_torch.crypto import batch_verifier as bv
    from stellar_core_tpu_torch.crypto import keys
    orig = bv.CudaSigVerifier.verify_many

    def verify_many(self, triples):
        self.batches_dispatched += 1
        self.sigs_verified += len(triples)
        return keys.raw_verify_batch(list(triples))

    bv.CudaSigVerifier.verify_many = verify_many
    try:
        yield
    finally:
        bv.CudaSigVerifier.verify_many = orig


BATCH = Mirror(("test_batch_boundary.py",), patch=_card_on_cpu,
               hook=cpu_test_ledger, port_subs=TPU_NAME_SUBS + SIM_SUBS)
BATCH_CASES = BATCH.cases(drop=("test_live_path_latency_slo",))


def test_mirrors_every_tier1_case():
    by_file = {}
    for f, _n, _i in SIM_CASES + COMMIT_CASES + BATCH_CASES:
        by_file[f] = by_file.get(f, 0) + 1
    assert by_file == {"test_simulation.py": 13, "test_scp_cockpit.py": 6,
                       "test_quorum_churn.py": 3, "test_chaos_soak.py": 7,
                       "test_state_commitment.py": 1,
                       "test_batch_boundary.py": 6}


def _sides(mirror, case, tmp_path) -> dict:
    sides = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        sides[side] = mirror.run(side, case, {"tmp_path": d})
    return sides


@pytest.mark.parametrize("case", SIM_CASES + COMMIT_CASES,
                         ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    mirror = COMMIT if case in COMMIT_CASES else SIM
    sides = _sides(mirror, case, tmp_path)
    assert sides["port"] == sides["ref"]


@pytest.mark.parametrize("case", BATCH_CASES, ids=Mirror.case_id)
def test_batch_boundary_on_the_port(case, tmp_path):
    with _c_decides() if case[1] in C_DECIDES else \
            contextlib.nullcontext():
        BATCH.run("port", case, {"tmp_path": tmp_path})


def test_default_fleet_is_the_cards_and_raises_without_one():
    """No backend named: every node's stacks are the card's
    ("cuda-resilient"), and building one raises here (no card, no CPU
    fallback); naming the CPU builds the CPU's."""
    import torch

    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.simulation import topologies
    from stellar_core_tpu_torch.simulation.simulation import Simulation
    from stellar_core_tpu_torch.xdr import SCPQuorumSet
    assert not torch.cuda.is_available()
    sim = Simulation()
    assert sim.backend == "cuda-resilient"
    k = SecretKey.from_seed(sha256(b"no-card"))
    q = SCPQuorumSet(threshold=1, validators=[k.public_key], innerSets=[])
    seen = []
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.add_node(k, q, cfg_tweak=lambda c: seen.append(
            (c.SIG_VERIFY_BACKEND, c.HASH_BACKEND)))
    assert seen == [("cuda-resilient", "cuda-resilient")]
    for build in (lambda: topologies.core(2, 2),
                  lambda: topologies.core4(),
                  lambda: topologies.hierarchical(1),
                  lambda: topologies.hierarchical_simplified(2, 1),
                  lambda: topologies.core(
                      2, 2, mode=Simulation.OVER_PEERS)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    # "cuda-async" hashes on the card's resilient stack
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(backend="cuda-async").add_node(
            k, q, cfg_tweak=lambda c: seen.append(
                (c.SIG_VERIFY_BACKEND, c.HASH_BACKEND)))
    assert seen[-1] == ("cuda-async", "cuda-resilient")
    node = Simulation(backend="cpu").add_node(k, q)
    assert node.app.sig_verifier.name == "cpu"
    assert node.app.config.HASH_BACKEND == "cpu"
