"""The port's sharded verify (`parallel/mesh.py`) over fleets of CPU members.

A fleet member is a device with streams of its own; on the CPU a member
runs the verify kernel's plain version, so a fleet of N `cpu` members
walks the same split, per-member launch and gather as N members on a
card. Held against the JAX package: the fleet verifier at N = 1, 2, 3, 4
and 8 against the reference's `CpuSigVerifier` (with the N=3 rounding of
a bucket to a multiple of the fleet), `multichip_verify` of 13 items on 8
members against `verify_oracle`, and the multi-device dry run. Without a
card, the fleet's default constructions raise. These are the port's
counterparts of `tests/test_multichip.py`, whose cases drive JAX's mesh
(`make_mesh`, `sharded_verify_fn`) over 8 virtual CPU devices and do not
run on the port; its weak-scaling timing has none on the CPU (the card's
scaling over 1-4 members is timed in `chip_smoke.py`'s phase 4b).
Tolerance: none.
"""

import numpy as np
import pytest
import torch

from stellar_core_tpu.crypto.batch_verifier import \
    CpuSigVerifier as JaxCpuSigVerifier
from stellar_core_tpu.ops.ed25519 import verify_oracle
from stellar_core_tpu_torch import graft_entry
from stellar_core_tpu_torch.crypto import keys as K
from stellar_core_tpu_torch.crypto.batch_verifier import (
    CudaSigVerifier, VerifierStats, make_verifier,
)
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ops import ed25519 as E
from stellar_core_tpu_torch.parallel.mesh import (
    make_fleet, multichip_verify, place_shards, sharded_verify,
)
from stellar_core_tpu_torch.testing.vectors import _vectors

import torch_threads  # noqa: F401  (one intra-op thread a worker)

LADDER = (16, 64)



def _batch(n, n_keys=6, tag=b"fleet"):
    """The reference fleet tests' batch (tests/test_verify_fleet.py)."""
    sks = [SecretKey.from_seed(bytes([i + 1] * 32)) for i in range(n_keys)]
    out = []
    for i in range(n):
        sk = sks[i % n_keys]
        m = tag + b"-%04d" % i
        out.append((sk.public_key.key_bytes, sk.sign(m), m))
    return out


def _corrupt(triples, idxs):
    for i in idxs:
        k, s, m = triples[i]
        triples[i] = (k, bytes([s[0] ^ 1]) + s[1:], m)
    return triples


def _fleet_triples():
    return (_corrupt(_batch(100), {3, 41, 97})
            + [(p, s, m) for (_l, p, s, m) in _vectors()])


@pytest.mark.parametrize("n_members", [1, 2, 3, 4, 8])
def test_fleet_matches_reference_cpu_verifier(n_members):
    """165 triples (100 signed, 3 corrupted, then the adversarial vectors)
    over ladder (16, 64): chunks of 64, 64 and 37, each padded to 64
    rounded up to a multiple of the fleet (66 on 3 members)."""
    K.flush_verify_cache()
    triples = _fleet_triples()
    st = VerifierStats()
    v = CudaSigVerifier(devices=["cpu"] * n_members, shard_threshold=1)
    v.BUCKETS = LADDER
    v.stats = st
    got = v.verify_many(triples)
    assert got == JaxCpuSigVerifier().verify_many(triples)
    assert v.batches_dispatched == 3
    padded = -(-64 // n_members) * n_members
    j = st.to_json()
    # the stats key by the ladder bucket, never the rounded size
    assert list(j["buckets"]) == ["64"]
    assert j["buckets"]["64"]["drains"] == 3
    assert j["buckets"]["64"]["pad_waste_total"] == 3 * padded - 165
    if n_members == 1:
        assert v._mesh_fns == {}
    else:
        assert list(v._mesh_fns) == [tuple(range(n_members))]
    lanes = padded // n_members
    want = {}
    for n in (64, 64, 37):
        for m in range(n_members):
            real = min(max(n - m * lanes, 0), lanes)
            row = want.setdefault(str(m), {"drains": 0, "sigs": 0,
                                           "pad_total": 0, "inflight": 0})
            row["drains"] += 1
            row["sigs"] += real
            row["pad_total"] += lanes - real
    assert j["devices"] == want
    if n_members == 3:
        assert padded == 66 and lanes == 22
    K.flush_verify_cache()


def test_multichip_verify_pads_to_the_fleet_and_matches_the_oracle():
    """13 items on 8 members: padded to 16, the padding lanes masked."""
    triples = _corrupt(_batch(13, tag=b"mc"), {5})
    pubs, sigs, msgs = map(list, zip(*triples))
    ok = multichip_verify(pubs, sigs, msgs, make_fleet(["cpu"] * 8))
    assert ok.shape == (13,) and ok.dtype == np.bool_
    assert ok.tolist() == [verify_oracle(*t) for t in triples]
    assert ok.tolist() == [i != 5 for i in range(13)]


def test_sharded_verify_equals_plain_on_the_whole_batch():
    """Kernel #3's counterpart against its plain version (`verify_plain`
    over the unsharded batch), lane for lane, at 2 and 4 members."""
    triples = [(p, s, m) for (_l, p, s, m) in _vectors()][:16]
    prep = E.prepare_batch(*map(list, zip(*triples)))
    args = [prep[k] for k in E.ARG_KEYS]
    want = E.verify_plain(*(torch.from_numpy(a) for a in args))
    for n in (2, 4):
        got = sharded_verify(make_fleet(["cpu"] * n))(*args)
        assert got.dtype == torch.bool and torch.equal(got, want)


def test_place_shards_cuts_contiguous_lane_ranges():
    fleet = make_fleet(["cpu"] * 4)
    arrays = [np.arange(8 * 3, dtype=np.int32).reshape(8, 3),
              np.arange(8, dtype=np.int32)]
    shards = place_shards(fleet, arrays)
    assert [sh.member for sh in shards] == list(fleet)
    for j, sh in enumerate(shards):
        assert sh.ready is None
        assert sh.args[0].tolist() == arrays[0][2 * j:2 * j + 2].tolist()
        assert sh.args[1].tolist() == [2 * j, 2 * j + 1]
    with pytest.raises(ValueError, match="does not split"):
        place_shards(make_fleet(["cpu"] * 3), arrays)


def test_make_fleet_rejects_mixed_and_empty_fleets():
    assert [m.device.type for m in make_fleet(["cpu", "cpu"])] == \
        ["cpu", "cpu"]
    assert all(m.stream is None for m in make_fleet(["cpu"]))
    with pytest.raises(ValueError):
        make_fleet([])
    with pytest.raises(ValueError):
        make_fleet(["cpu", "cuda"])
    with pytest.raises(ValueError):
        make_fleet(["meta"])
    with pytest.raises(ValueError, match="not both"):
        CudaSigVerifier(device="cpu", devices=["cpu"])


def test_dryrun_multichip_on_cpu_members(capsys):
    graft_entry.dryrun_multichip(4, devices=["cpu"] * 4)
    assert "dryrun_multichip(4): ok (256 verifies, 224 valid" \
        in capsys.readouterr().out


def test_fleet_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaSigVerifier()
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaSigVerifier(devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_verifier("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_fleet()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(2)
