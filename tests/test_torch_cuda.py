"""The CUDA kernels on the card (marked `cuda`; skipped without one).

Run on a machine with a CUDA card (no JAX needed):

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The verify kernel's decisions must equal its plain version's on the same
CUDA tensors, lane for lane (adversarial vectors plus a seeded corpus),
at lane counts that end inside a warp, one past a block, a 3-member shard
of 8,193 and the largest bucket;
the SHA-256 kernel's digest words must equal its plain version's, every
lane including padding lanes and out-of-range counts, and hashlib's. Each
wrapper must count each launch and reject what its kernel does not take,
and `CudaSigVerifier` / `CudaBatchHasher` on their default device must
match the CPU backends, as must fleets of 2 and 3 members sharing the
card (a staged drain repeated five times), and a 3-member sharded verify
on a ragged lane count must equal verify_plain. Tolerance: none.
"""

import numpy as np
import pytest
import torch

import hashlib

from stellar_core_tpu_torch.crypto import keys as K
from stellar_core_tpu_torch.crypto.batch_hasher import (
    CudaBatchHasher, make_hasher,
)
from stellar_core_tpu_torch.crypto.batch_verifier import (
    CpuSigVerifier, CudaSigVerifier,
)
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ops import ed25519 as E
from stellar_core_tpu_torch.ops import sha256 as S
from stellar_core_tpu_torch.testing.vectors import _vectors

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _triples(n: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    keys = [SecretKey(rng.bytes(32)) for _ in range(8)]
    out = []
    for i in range(n):
        msg = rng.bytes(int(rng.integers(0, 400)))
        sig = bytearray(keys[i % 8].sign(msg))
        if i % 7 == 6:
            sig[int(rng.integers(0, 64))] ^= 4
        out.append((keys[i % 8].public_key, bytes(sig), msg))
    return out


def _device_args(triples, device):
    prep = E.prepare_batch(*map(list, zip(*triples)))
    return prep, tuple(torch.from_numpy(prep[k]).to(device)
                       for k in E.ARG_KEYS)


@pytest.mark.parametrize("n", [1, 33, 128, 129, 1000, 2731, 8192])
def test_kernel_matches_plain_on_card(card, n):
    vecs = [(p, s, m) for (_l, p, s, m) in _vectors()]
    triples = (vecs + _triples(max(n - len(vecs), 0)))[:n]
    prep, args = _device_args(triples, card)
    before = E.LAUNCHES
    got = E.verify_kernel(*args)
    torch.cuda.synchronize()
    assert E.LAUNCHES == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.bool
    want = E.verify_plain(*args)
    assert torch.equal(got, want)
    decisions = (got.cpu().numpy() & prep["pre_ok"]).tolist()
    assert decisions == K.raw_verify_batch(triples)


def test_empty_batch_launches_nothing(card):
    _prep, args = _device_args(_triples(2), card)
    before = E.LAUNCHES
    out = E.verify_kernel(*(a[:0] for a in args))
    assert out.shape == (0,) and E.LAUNCHES == before


def test_wrapper_rejects_mixed_devices(card):
    _prep, args = _device_args(_triples(4), card)
    with pytest.raises(ValueError):
        E.verify_kernel(args[0].cpu(), *args[1:])
    with pytest.raises(ValueError):
        E.verify_kernel(args[0], args[1].cpu(), *args[2:])


def test_cuda_verifier_matches_cpu(card):
    K.flush_verify_cache()
    triples = _triples(300, seed=12)
    v = CudaSigVerifier()
    assert v.device.type == "cuda"
    assert v.verify_many(triples) == CpuSigVerifier().verify_many(triples)
    assert v.batches_dispatched == 1
    K.flush_verify_cache()


def test_two_member_fleet_on_one_card_matches_cpu(card):
    """Two members sharing the card, each on its own streams: a 2048
    chunk sharded 1024 + 1024 (two launches), the 300 tail on member 0."""
    K.flush_verify_cache()
    triples = _triples(2048 + 300, seed=15)
    v = CudaSigVerifier(devices=["cuda:0", "cuda:0"])
    v.BUCKETS = (512, 2048)
    before = E.LAUNCHES
    assert v.verify_many(triples) == CpuSigVerifier().verify_many(triples)
    assert E.LAUNCHES == before + 3
    assert list(v._mesh_fns) == [(0, 1)]
    K.flush_verify_cache()


def test_three_member_sharded_verify_equals_plain_on_ragged_lanes(card):
    """129 lanes over three members of the card, 43 each (not a multiple
    of the kernel's block): every lane, the padding lane too, equals
    verify_plain over the whole batch."""
    from stellar_core_tpu_torch.parallel.mesh import (
        make_fleet, pad_batch_to, sharded_verify,
    )
    triples = [(p, s, m) for (_l, p, s, m) in _vectors()][:64]
    triples += _triples(128 - len(triples), seed=17)
    prep = pad_batch_to(E.prepare_batch(*map(list, zip(*triples))), 129)
    arrays = [prep[k] for k in E.ARG_KEYS]
    got = sharded_verify(make_fleet(["cuda:0"] * 3))(*arrays)
    want = E.verify_plain(*(torch.from_numpy(a).cuda() for a in arrays))
    assert torch.equal(got, want.cpu())
    assert (got[:128].numpy() & prep["pre_ok"][:128]).tolist() == \
        K.raw_verify_batch(triples)


def test_staged_drain_repeats_identically(card):
    """A multi-chunk drain over three members of the card, five times:
    chunk K+1 is copied on the staging streams while chunk K runs, so a
    launch that does not wait for its copies would read a half-copied
    batch and give other decisions on some run."""
    K.flush_verify_cache()
    triples = _triples(4 * 1024 + 77, seed=16)
    want = CpuSigVerifier().verify_many(triples)
    v = CudaSigVerifier(devices=["cuda:0"] * 3)
    v.BUCKETS = (128, 1024)
    for _ in range(5):
        assert v.verify_many(triples) == want
    assert v.batches_dispatched == 5 * 5
    K.flush_verify_cache()


# --- SHA-256 ------------------------------------------------------------------

def _hash_args(lanes: int, blocks: int, device, seed: int = 13):
    """Real padded messages in most lanes, then lanes of random words with
    counts in [-1, blocks + 3]."""
    rng = np.random.default_rng(seed)
    n = max(1, lanes * 3 // 4)
    msgs = [rng.bytes(int(x)) for x in rng.integers(0, 64 * blocks - 8, n)]
    words = rng.integers(0, 1 << 32, (lanes, blocks, 16),
                         dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(-1, blocks + 4, lanes).astype(np.int32)
    words[:n], counts[:n] = S.pad_messages_np(msgs, blocks)
    return msgs, (torch.from_numpy(words.view(np.int32)).to(device),
                  torch.from_numpy(counts).to(device))


@pytest.mark.parametrize("lanes,blocks", [(1, 1), (33, 2), (256, 16),
                                          (4096, 2), (1000, 5)])
def test_sha256_kernel_matches_plain_on_card(card, lanes, blocks):
    msgs, args = _hash_args(lanes, blocks, card)
    before = S.LAUNCHES
    got = S.hash_blocks_kernel(*args)
    torch.cuda.synchronize()
    assert S.LAUNCHES == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, S.hash_blocks_plain(*args))
    host = got.cpu().numpy().view(np.uint32)
    assert S.digests_to_bytes(host[:len(msgs)]) == \
        [hashlib.sha256(m).digest() for m in msgs]


def test_sha256_empty_batch_launches_nothing(card):
    _msgs, (w, c) = _hash_args(4, 1, card)
    before = S.LAUNCHES
    out = S.hash_blocks_kernel(w[:0], c[:0])
    assert out.shape == (0, 8) and S.LAUNCHES == before


def test_sha256_wrapper_rejects_mixed_devices_and_misalignment(card):
    _msgs, (w, c) = _hash_args(4, 2, card)
    with pytest.raises(ValueError):
        S.hash_blocks_kernel(w.cpu(), c)
    with pytest.raises(ValueError):
        S.hash_blocks_kernel(w, c.cpu())
    flat = torch.zeros(4 * 2 * 16 + 1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        S.hash_blocks_kernel(flat[1:].view(4, 2, 16), c)


def test_cuda_hasher_matches_hashlib(card):
    rng = np.random.default_rng(14)
    msgs = [rng.bytes(n) for n in
            (0, 3, 40, 64, 119, 300, 900, 1015, 1016, 2048)] * 3
    msgs += [rng.bytes(int(n)) for n in rng.integers(0, 200, 5000)]
    h = make_hasher("cuda")
    assert isinstance(h, CudaBatchHasher) and h.device.type == "cuda"
    before = S.LAUNCHES
    assert h.hash_many(msgs, site="bench") == \
        [hashlib.sha256(m).digest() for m in msgs]
    assert h.oversize_msgs == 6 and h.batches == 2
    assert S.LAUNCHES == before + 2
