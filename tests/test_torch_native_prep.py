"""The port's C host prep (`native/prep.c`) against the JAX package's prep.

Mirrors `tests/test_native_prep.py` on its `_batch()` rows (a
non-canonical S, a key at p + 3, a 20-byte signature, an empty message,
messages of 111, 112 and 192 bytes):

- the port's native `prepare_batch` equals the JAX package's
  `prepare_batch` under `SCT_NATIVE_PREP=0` (numpy) and `=1` (its own C
  copy), and the port's numpy `prepare_batch_plain`, on `pre_ok` and on
  all six arrays of every row that reaches a decision. Rows that `pre_ok`
  rejects are not compared: the two paths fill them differently, and the
  mask hides them from every decision;
- k mod L read back from the signed digits equals Python integers;
- the port's prep then `verify_plain` on 128 lanes equals the JAX
  package's `verify_oracle`, decision for decision;
- `cache_keys_native` equals `keys._cache_key` triple for triple, and
  returns None on a batch holding one 31-byte and one 33-byte key, which
  the reference's `cache_keys_native` accepts (its sum-of-lengths check)
  and keys misaligned; a `prewarm_many` of that batch, whichever form of
  cache key it takes, leaves the cache right.

Tolerance: none. Skipped only where the host has no C compiler.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from stellar_core_tpu import native as ref_native
from stellar_core_tpu.ops import ed25519 as RE
from stellar_core_tpu_torch import _build
from stellar_core_tpu_torch import native
from stellar_core_tpu_torch.crypto import keys as K
from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ops import ed25519 as E
from stellar_core_tpu_torch.parallel.mesh import pad_batch_to


@pytest.fixture(autouse=True)
def _needs_cc():
    if _build.find_cc() is None:
        pytest.skip("no C compiler on this host: the numpy prep runs")


def _batch(n=200, seed=5):
    """The reference test's batch, signed with the port's keys."""
    rnd = random.Random(seed)
    sks = [SecretKey.from_seed(bytes([i + 1] * 32)) for i in range(8)]
    pubs, sigs, msgs = [], [], []
    for i in range(n):
        sk = sks[i % 8]
        m = rnd.randbytes(rnd.randrange(0, 300))
        pubs.append(sk.public_key)
        sigs.append(sk.sign(m))
        msgs.append(m)
    # adversarial rows
    sigs[5] = sigs[5][:32] + (
        int.from_bytes(sigs[5][32:], "little") + E.L).to_bytes(32, "little")
    pubs[6] = (E.P + 3 | (1 << 255)).to_bytes(32, "little")
    sigs[7] = sigs[7][:20]
    msgs[8] = b""
    msgs[9] = rnd.randbytes(111)   # crosses the first SHA-512 block exactly
    msgs[10] = rnd.randbytes(112)
    msgs[11] = rnd.randbytes(128 + 64)
    return pubs, sigs, msgs


def _native_prep(pubs, sigs, msgs) -> dict:
    calls = native.PREP_CALLS
    prep = E.prepare_batch(pubs, sigs, msgs)
    assert native.PREP_CALLS == calls + 1, "the C prep did not run"
    return prep


@pytest.mark.parametrize("ref_mode", ["0", "1"])
def test_native_prep_equals_the_reference_prep(monkeypatch, ref_mode):
    pubs, sigs, msgs = _batch()
    monkeypatch.setenv("SCT_NATIVE_PREP", ref_mode)
    ref = RE.prepare_batch(pubs, sigs, msgs)
    nat = _native_prep(pubs, sigs, msgs)
    assert nat["pre_ok"].dtype == bool
    assert (ref["pre_ok"] == nat["pre_ok"]).all()
    assert not nat["pre_ok"][5:8].any() and nat["pre_ok"][8:12].all()
    mask = ref["pre_ok"]
    for k in E.ARG_KEYS:
        assert nat[k].dtype == np.int32 and nat[k].shape == ref[k].shape, k
        assert (ref[k][mask] == nat[k][mask]).all(), k


def test_native_prep_equals_the_port_numpy_prep():
    """Short, long and missing rows: both preps normalise the lists to the
    key count, and agree on every deciding row."""
    pubs, sigs, msgs = _batch(64, seed=3)
    pubs = pubs + [pubs[0] + b"\x00"]        # a 33-byte key
    sigs = sigs + [sigs[0]]
    msgs = msgs[:60]                          # rows 60..64 lack a message
    ref = E.prepare_batch_plain(pubs, sigs, msgs)
    nat = _native_prep(pubs, sigs, msgs)
    assert (ref["pre_ok"] == nat["pre_ok"]).all()
    assert not nat["pre_ok"][60:].any()
    mask = ref["pre_ok"]
    for k in E.ARG_KEYS:
        assert (ref[k][mask] == nat[k][mask]).all(), k


def test_native_mod_l_against_python_ints():
    """k mod L from the signed digits of the C path's Barrett reduction,
    against Python integers."""
    pubs, sigs, msgs = _batch(64, seed=9)
    nat = _native_prep(pubs, sigs, msgs)
    checked = 0
    for i in range(64):
        if not nat["pre_ok"][i]:
            continue
        k = int.from_bytes(
            hashlib.sha512(sigs[i][:32] + pubs[i] + msgs[i]).digest(),
            "little") % E.L
        digs = nat["k_nibs"][i]
        assert (digs >= -8).all() and (digs < 8).all(), i
        assert sum(int(digs[j]) << (4 * j) for j in range(64)) == k, i
        checked += 1
    assert checked == 61


def test_native_prep_feeds_verify_plain():
    """The port's C prep then `verify_plain` on 128 lanes (the padding
    lanes masked) equals the reference's oracle."""
    pubs, sigs, msgs = _batch(48, seed=11)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        prep = pad_batch_to(_native_prep(pubs, sigs, msgs), 128)
        ok = E.verify_plain(*(torch.from_numpy(prep[k])
                              for k in E.ARG_KEYS)).numpy()
    finally:
        torch.set_num_threads(n)
    got = list(ok[:48] & prep["pre_ok"][:48])
    want = [RE.verify_oracle(p, s, m) for p, s, m in zip(pubs, sigs, msgs)]
    assert got == want
    # rows 5-7 are malformed; rows 8-11 had their messages replaced
    # after signing
    assert sum(want) == 41


def test_cache_keys_native_equals_cache_key():
    pubs, sigs, msgs = _batch(300, seed=13)
    triples = [t for i, t in enumerate(zip(pubs, sigs, msgs)) if i != 7]
    got = native.cache_keys_native(triples)
    assert got == [K._cache_key(*t) for t in triples]
    assert native.cache_keys_native([]) is None


def _ragged_keys_batch():
    """300 well-formed triples, then a 31-byte key and a 33-byte one that
    starts with the byte the first lacks: the summed key lengths are still
    32 per triple, and the first 32 bytes of the two keys together are
    the valid key of the first triple. Returns (triples, that triple)."""
    pubs, sigs, msgs = _batch(303, seed=17)
    triples = [t for i, t in enumerate(zip(pubs, sigs, msgs)) if i != 7]
    valid = triples[-2]
    k0, s0, m0 = valid
    k1, s1, m1 = triples[-1]
    triples[-2] = (k0[:31], s0, m0)
    triples[-1] = (k0[31:] + k1, s1, m1)
    return triples, valid


@pytest.mark.parametrize("via", ["cache_keys_native", "prewarm_many"])
def test_cache_keys_native_rejects_ragged_keys(via):
    triples, valid = _ragged_keys_batch()
    assert len(triples) == 302
    if via == "prewarm_many":
        # a drain holding the ragged pair rejects both, and the valid
        # triple that the reference's misaligned keys would have cached as
        # rejected still verifies through the cache
        K.flush_verify_cache()
        try:
            out = CpuSigVerifier().prewarm_many(triples)
            assert out[-2:] == [False, False]
            assert out[:-2] == [K.raw_verify(*t) for t in triples[:-2]]
            assert K.raw_verify(*valid)
            assert K.verify_sig(*valid)
        finally:
            K.flush_verify_cache()
        return
    assert native.cache_keys_native(triples) is None
    # the reference's loader checks only the summed lengths: it accepts
    # the batch and keys the 31-byte triple as the valid one
    if ref_native.available():
        ref = ref_native.cache_keys_native(triples)
        assert ref is not None
        assert ref[:-2] == [K._cache_key(*t) for t in triples[:-2]]
        assert ref[-2] == K._cache_key(*valid) != K._cache_key(*triples[-2])
