"""The crypto overlay needs (`stellar_core_tpu_torch/crypto/hashing.py`'s
HMAC, HKDF, SipHash and SHA-512, `crypto/fallback.py`'s X25519 and
ChaCha20-Poly1305, `crypto/curve25519.py` and the `x25519` binding of
`native/ed25519c.c`) held against the JAX package's, byte for byte.

X25519 runs through the port's C ladder and its pure-Python ladder, on
RFC 7748's vectors (section 5.2 and the section 6.1 exchange) and on
seeded keys, against the reference's `curve25519` (which takes the
`cryptography` package where it is importable) and its fallback; an
all-zero shared secret raises ValueError on both paths of both packages.
ChaCha20-Poly1305 seals the same bytes as the reference's and opens the
reference's; a sealed box made by one package opens in the other, both
ways, and a tampered one is refused by both. Tolerance: none.
"""

import random

import pytest

from stellar_core_tpu.crypto import curve25519 as RC
from stellar_core_tpu.crypto import fallback as RF
from stellar_core_tpu.crypto import hashing as RH
from stellar_core_tpu_torch import native as PN
from stellar_core_tpu_torch.crypto import curve25519 as PC
from stellar_core_tpu_torch.crypto import fallback as PF
from stellar_core_tpu_torch.crypto import hashing as PH

RFC7748 = [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
]
ALICE = ("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
         "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
BOB = ("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb",
       "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
SHARED = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"


def _blobs(seed: int, n: int):
    rng = random.Random(seed)
    return [bytes(rng.getrandbits(8) for _ in range(rng.choice(
        (0, 1, 7, 8, 15, 16, 31, 32, 63, 64, 65, 200))))
        for _ in range(n)]


@pytest.fixture(params=["c", "python"])
def ladder(request, monkeypatch):
    """The port's X25519 through its C library, or with the library
    hidden (its pure-Python ladder)."""
    if request.param == "c":
        assert PN.ed25519_native() is not None, "no C compiler here"
    else:
        monkeypatch.setattr(PN, "ed25519_native", lambda: None)
    return request.param


def test_hashing_equals_reference_on_seeded_inputs():
    keys = _blobs(1, 24)
    data = _blobs(2, 24)
    for k, d in zip(keys, data):
        assert PH.hmac_sha256(k, d) == RH.hmac_sha256(k, d)
        mac = RH.hmac_sha256(k, d)
        assert PH.hmac_sha256_verify(k, d, mac) is True
        bad = mac[:-1] + bytes([mac[-1] ^ 1])
        assert PH.hmac_sha256_verify(k, d, bad) is \
            RH.hmac_sha256_verify(k, d, bad) is False
        assert PH.sha512(d) == RH.sha512(d)
        prk = PH.hkdf_extract(d, k.ljust(32, b"\x00")[:32])
        assert prk == RH.hkdf_extract(d, k.ljust(32, b"\x00")[:32])
        assert PH.hkdf_extract(d) == RH.hkdf_extract(d)
        for length in (1, 32, 33, 100):
            assert PH.hkdf_expand(prk, k, length) == \
                RH.hkdf_expand(prk, k, length)
        key16 = (k + bytes(16))[:16]
        assert PH.siphash24(key16, d) == RH.siphash24(key16, d)


def test_short_hash_equals_reference():
    key = bytes(range(16))
    PH.ShortHash.initialize(key)
    RH.ShortHash.initialize(key)
    try:
        for d in _blobs(3, 16):
            assert PH.ShortHash.compute(d) == RH.ShortHash.compute(d)
    finally:
        PH.ShortHash.initialize()
        RH.ShortHash.initialize()


def test_x25519_rfc7748_vectors(ladder):
    for k, u, out in RFC7748:
        k, u = bytes.fromhex(k), bytes.fromhex(u)
        assert PF.x25519_shared(k, u).hex() == out
        assert RF._x25519(k, u).hex() == out
    for sk, pk in (ALICE, BOB):
        assert PC.curve25519_derive_public(bytes.fromhex(sk)).hex() == pk
        assert RC.curve25519_derive_public(bytes.fromhex(sk)).hex() == pk
    assert PF.x25519_shared(bytes.fromhex(ALICE[0]),
                            bytes.fromhex(BOB[1])).hex() == SHARED
    assert PF.x25519_shared(bytes.fromhex(BOB[0]),
                            bytes.fromhex(ALICE[1])).hex() == SHARED


def test_x25519_seeded_keys_equal_reference(ladder):
    rng = random.Random(7)
    for _ in range(12):
        a = bytes(rng.getrandbits(8) for _ in range(32))
        b = bytes(rng.getrandbits(8) for _ in range(32))
        pa = PC.curve25519_derive_public(a)
        pb = PC.curve25519_derive_public(b)
        assert pa == RC.curve25519_derive_public(a) == RF.x25519_public(a)
        assert pb == RC.curve25519_derive_public(b)
        # both session orders, both packages: the peers' shared key
        for sk, remote in ((a, pb), (b, pa)):
            got = PC.curve25519_derive_shared(sk, remote, pa, pb)
            assert got == RC.curve25519_derive_shared(sk, remote, pa, pb)
        assert PC.curve25519_derive_shared(a, pb, pa, pb) == \
            PC.curve25519_derive_shared(b, pa, pa, pb)


def test_all_zero_shared_secret_raises(ladder):
    k = bytes.fromhex(ALICE[0])
    for small in (bytes(32), (1).to_bytes(32, "little")):
        with pytest.raises(ValueError):
            PF.x25519_shared(k, small)
        with pytest.raises(ValueError):
            PC.curve25519_derive_shared(k, small, small, small)
        with pytest.raises(ValueError):
            RF.x25519_shared(k, small)
        with pytest.raises(ValueError):
            RC.curve25519_derive_shared(k, small, small, small)


def test_chacha20_poly1305_byte_for_byte():
    ref_cls = RC._aead_cls()
    rng = random.Random(11)
    for n in (0, 1, 63, 64, 65, 200, 1000):
        key = bytes(rng.getrandbits(8) for _ in range(32))
        nonce = bytes(rng.getrandbits(8) for _ in range(12))
        data = bytes(rng.getrandbits(8) for _ in range(n))
        aad = bytes(rng.getrandbits(8) for _ in range(n % 17))
        ct = PF.ChaCha20Poly1305(key).encrypt(nonce, data, aad)
        assert ct == ref_cls(key).encrypt(nonce, data, aad)
        assert ct == RF.ChaCha20Poly1305(key).encrypt(nonce, data, aad)
        assert PF.ChaCha20Poly1305(key).decrypt(nonce, ct, aad) == data
        bad = ct[:-1] + bytes([ct[-1] ^ 0x80])
        with pytest.raises(ValueError):
            PF.ChaCha20Poly1305(key).decrypt(nonce, bad, aad)
    with pytest.raises(ValueError):
        PF.ChaCha20Poly1305(b"\x00" * 31)


def test_sealed_boxes_cross_packages(ladder):
    msg = b"topology payload" * 20
    for seal_mod, open_mod in ((PC, RC), (RC, PC)):
        sk = seal_mod.curve25519_random_secret()
        pk = open_mod.curve25519_derive_public(sk)
        blob = seal_mod.curve25519_seal(pk, msg)
        assert len(blob) == 32 + len(msg) + 16
        assert open_mod.curve25519_unseal(sk, blob) == msg
        tampered = bytearray(blob)
        tampered[40] ^= 0x01
        for mod in (PC, RC):
            with pytest.raises(Exception):
                mod.curve25519_unseal(sk, bytes(tampered))
