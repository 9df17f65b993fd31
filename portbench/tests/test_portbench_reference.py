"""The reference verify against RFC 8032's vectors, the port's adversarial
vectors and the port's CPU verifiers, and its two controls."""

import hashlib

import pytest

from portbench.yardstick import ed25519_ref as ref
from portbench.yardstick.signer import signer

# RFC 8032, section 7.1, TEST 1 to TEST 3: (secret, public, message,
# signature)
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("secret,public,msg,sig", RFC8032)
def test_rfc8032_vectors(secret, public, msg, sig):
    pub, m = bytes.fromhex(public), bytes.fromhex(msg)
    s = bytes.fromhex(secret)
    assert signer().public(s) == pub
    assert signer().sign(s, m) == bytes.fromhex(sig)
    assert ref.verify(pub, bytes.fromhex(sig), m)
    assert not ref.verify(pub, bytes.fromhex(sig), m + b"\x00")


def test_reference_matches_the_port_on_adversarial_vectors():
    from stellar_core_tpu_torch.crypto import fallback
    from stellar_core_tpu_torch.native import ed25519_native
    from stellar_core_tpu_torch.ops.ed25519 import verify_oracle
    from stellar_core_tpu_torch.testing.vectors import _vectors
    lib = ed25519_native()
    vecs = _vectors()
    assert len(vecs) >= 50
    for label, pub, sig, msg in vecs:
        want = ref.verify(pub, sig, msg)
        assert verify_oracle(pub, sig, msg) is want, label
        assert fallback._py_verify(pub, sig, msg) is want, label
        if lib is not None:
            assert lib.verify(pub, sig, msg) is want, label


def test_canonical_checks_and_controls():
    seed = hashlib.sha256(b"edge").digest()
    pub, msg = signer().public(seed), b"m" * 32
    sig = signer().sign(seed, msg)
    assert ref.verify(pub, sig, msg)
    # S + L: refused; the canonical-S control reduces it and accepts
    mall = ref.s_plus_l(sig)
    assert not ref.verify(pub, mall, msg)
    assert ref.verify(pub, mall, msg, canonical_s=False)
    # R with a point of order 8: refused; the cofactored control accepts
    mixed = ref.mixed_order_sign(seed, msg)
    assert not ref.verify(pub, mixed, msg)
    assert ref.verify(pub, mixed, msg, cofactored=True)
    # T8 has order 8
    assert ref.equal(ref.scalar_mul(8, ref.T8), ref.IDENTITY)
    assert not ref.equal(ref.scalar_mul(4, ref.T8), ref.IDENTITY)
    # a flipped bit, a non-canonical y (y + p) for R, a short key
    assert not ref.verify(pub, ref.flip_bit(sig, 300), msg)
    y = int.from_bytes(sig[:32], "little") & ((1 << 255) - 1)
    if y + ref.P < 1 << 255:
        bad_r = (y + ref.P | (sig[31] >> 7) << 255).to_bytes(32, "little")
        assert not ref.verify(pub, bad_r + sig[32:], msg)
    assert not ref.verify(pub[:31], sig, msg)
    assert not ref.verify(pub, sig[:63], msg)
