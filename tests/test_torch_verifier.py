"""The port's BatchSigVerifier boundary against the JAX package's CPU backend.

`CudaSigVerifier(device="cpu")` runs the kernel's plain version behind the
same boundary the card uses: bucket padding, chunking of oversize drains,
the verify-result cache, enqueue/flush futures. Its decisions must equal
the port's `CpuSigVerifier` (native C) and the JAX package's
`CpuSigVerifier` on the same triples; the ladder is patched small so the
plain version stays quick on the CPU. Tolerance: none.
"""

import numpy as np
import pytest
import torch

from stellar_core_tpu.crypto.batch_verifier import \
    CpuSigVerifier as JaxCpuSigVerifier
from stellar_core_tpu_torch.crypto import keys as K
from stellar_core_tpu_torch.crypto.batch_verifier import (
    CpuSigVerifier, CudaSigVerifier, make_verifier,
)
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.testing.vectors import _vectors

SMALL_LADDER = (4, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version issues many tiny ops; one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _triples(n: int, seed: int):
    """Seeded triples: every 5th signature corrupted, one short signature,
    one 31-byte key, messages of 0..300 bytes."""
    rng = np.random.default_rng(seed)
    keys = [SecretKey(rng.bytes(32)) for _ in range(4)]
    out = []
    for i in range(n):
        msg = rng.bytes(int(rng.integers(0, 301)))
        sk = keys[i % len(keys)]
        sig = bytearray(sk.sign(msg))
        if i % 5 == 4:
            sig[int(rng.integers(0, 64))] ^= 0x10
        out.append((sk.public_key, bytes(sig), msg))
    out[1] = (out[1][0], out[1][1][:63], out[1][2])
    out[2] = (out[2][0][:31], out[2][1], out[2][2])
    return out


@pytest.fixture
def verifier():
    K.flush_verify_cache()
    v = CudaSigVerifier(device="cpu")
    v.BUCKETS = SMALL_LADDER
    yield v
    K.flush_verify_cache()


def test_verify_many_chunks_and_matches_cpu_backends(verifier):
    triples = _triples(37, seed=1)          # chunks 16 + 16 + 5 (bucket 8)
    got = verifier.verify_many(triples)
    assert verifier.batches_dispatched == 3
    assert verifier.sigs_verified == 37
    assert got == CpuSigVerifier().verify_many(triples) \
        == JaxCpuSigVerifier().verify_many(triples)
    assert got == [i % 5 != 4 and i not in (1, 2) for i in range(37)]


def test_adversarial_vectors_match_cpu_backends(verifier):
    verifier.BUCKETS = (128,)
    triples = [(p, s, m) for (_l, p, s, m) in _vectors()]
    got = verifier.verify_many(triples)
    assert got == CpuSigVerifier().verify_many(triples) \
        == JaxCpuSigVerifier().verify_many(triples)


def test_prewarm_many_seeds_the_cache(verifier):
    triples = _triples(12, seed=2)
    want = JaxCpuSigVerifier().verify_many(triples)
    assert verifier.prewarm_many(triples) == want
    assert verifier.batches_dispatched == 1
    # all hits now: nothing dispatches, and enqueue completes at once
    assert verifier.prewarm_many(triples) == want
    assert verifier.batches_dispatched == 1
    futs = [verifier.enqueue(*t) for t in triples]
    assert verifier.pending() == 0
    assert [f.result() for f in futs] == want
    assert K.verify_cache_stats()["size"] == len(triples)


def test_enqueue_flush_resolves_futures(verifier):
    triples = _triples(11, seed=3)
    want = CpuSigVerifier().verify_many(triples)
    seen = []
    futs = [verifier.enqueue(*t) for t in triples]
    futs[0].add_done_callback(seen.append)
    assert verifier.pending() == 11 and not any(f.done() for f in futs)
    with pytest.raises(RuntimeError):
        futs[0].result()
    verifier.flush()
    assert verifier.pending() == 0 and verifier.batches_dispatched == 1
    assert [f.result() for f in futs] == want
    assert seen == [want[0]]
    verifier.flush()                         # empty flush dispatches nothing
    assert verifier.batches_dispatched == 1


def test_enqueue_self_flushes_at_max_pending():
    K.flush_verify_cache()
    v = CudaSigVerifier(max_pending=6, device="cpu")
    v.BUCKETS = SMALL_LADDER
    triples = _triples(6, seed=4)
    futs = [v.enqueue(*t) for t in triples]
    assert v.batches_dispatched == 1 and v.pending() == 0
    assert [f.result() for f in futs] == CpuSigVerifier().verify_many(
        triples)
    K.flush_verify_cache()


def test_failed_dispatch_raises_and_keeps_the_batch(verifier, monkeypatch):
    """No CPU fallback on the port: the error reaches the caller and the
    batch stays queued, every future unresolved."""
    triples = _triples(5, seed=5)
    futs = [verifier.enqueue(*t) for t in triples]

    def boom(_triples):
        raise RuntimeError("device lost")

    monkeypatch.setattr(verifier, "verify_many", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        verifier.flush()
    assert verifier.pending() == 5 and not any(f.done() for f in futs)
    monkeypatch.undo()
    verifier.flush()
    assert [f.result() for f in futs] == CpuSigVerifier().verify_many(
        triples)


def test_cuda_verifier_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaSigVerifier()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_verifier("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_verifier()


def test_make_verifier_backends():
    assert isinstance(make_verifier("cpu"), CpuSigVerifier)
    v = make_verifier("cuda", device="cpu")
    assert isinstance(v, CudaSigVerifier) and v.device.type == "cpu"
    with pytest.raises(ValueError):
        make_verifier("tpu")


def test_cpu_enqueue_is_cached():
    K.flush_verify_cache()
    t = _triples(3, seed=6)[0]
    f = CpuSigVerifier().enqueue(*t)
    assert f.done() and f.result() == K.raw_verify(*t)
    assert K.verify_cache_stats()["size"] == 1
    K.flush_verify_cache()
