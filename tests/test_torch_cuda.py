"""The CUDA verify kernel on the card (marked `cuda`; skipped without one).

Run on a machine with a CUDA card (no JAX needed):

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The kernel's decisions must equal its plain version's on the same CUDA
tensors, lane for lane (adversarial vectors plus a seeded corpus), the
wrapper must count each launch and reject what the kernel does not take,
and `CudaSigVerifier` on its default device must match the CPU verifier.
Tolerance: none.
"""

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch.crypto import keys as K
from stellar_core_tpu_torch.crypto.batch_verifier import (
    CpuSigVerifier, CudaSigVerifier,
)
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ops import ed25519 as E
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


@pytest.mark.parametrize("n", [1, 33, 128, 1000])
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
