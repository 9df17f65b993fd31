"""X25519 ECDH for peer session keys, and the survey's sealed boxes.

Copied from `stellar_core_tpu/crypto/curve25519.py` at commit ba35320;
carry a fix in either copy to the other. Nothing is left out. Different
from the reference: it prefers the `cryptography` package and falls back
to crypto/fallback.py; the port never imports `cryptography` (the card's
host has none) and takes its own order, as crypto/keys.py does for
ed25519: the C ladder of native/ed25519c.c, else pure Python (both in
crypto/fallback.py). X25519 is deterministic, so the public keys and
shared keys are the reference's byte for byte; a secret is 32 bytes of
`os.urandom` (the ladder clamps it, as `cryptography` does).
ChaCha20-Poly1305 is crypto/fallback.py's, in Python.

Role parity: reference `src/crypto/Curve25519.{h,cpp}:47-71` — random scalar,
derive public, ECDH → HKDF shared key; used by overlay PeerAuth.
"""

from __future__ import annotations

import os

from .fallback import ChaCha20Poly1305, x25519_public, x25519_shared
from .hashing import hkdf_expand, hkdf_extract, sha256


def curve25519_random_secret() -> bytes:
    return os.urandom(32)


def curve25519_derive_public(secret32: bytes) -> bytes:
    return x25519_public(secret32)


def curve25519_derive_shared(local_secret32: bytes, remote_public32: bytes,
                             public_a: bytes, public_b: bytes) -> bytes:
    """ECDH then HKDF-extract over (shared ‖ publicA ‖ publicB) — the caller
    fixes the A/B ordering so both sides derive the same key
    (reference Curve25519.cpp:47-71). Raises ValueError on an all-zero
    shared secret (a small-order peer point)."""
    shared = x25519_shared(local_secret32, remote_public32)
    return hkdf_extract(shared + public_a + public_b)


def hkdf_expand_key(key32: bytes, info: bytes) -> bytes:
    return hkdf_expand(key32, info, 32)


def curve25519_seal(recipient_public32: bytes, plaintext: bytes) -> bytes:
    """Anonymous sealed box (libsodium crypto_box_seal role, reference
    SurveyManager encrypted responses): ephemeral X25519 + ChaCha20-
    Poly1305, key = HKDF(ECDH ‖ epk ‖ recipient), nonce derived from the
    public halves. Output: epk(32) ‖ ciphertext."""
    esk = curve25519_random_secret()
    epk = curve25519_derive_public(esk)
    key = curve25519_derive_shared(esk, recipient_public32, epk,
                                   recipient_public32)
    nonce = sha256(b"sealed-box-nonce" + epk + recipient_public32)[:12]
    return epk + ChaCha20Poly1305(key).encrypt(nonce, plaintext, b"")


def curve25519_unseal(secret32: bytes, blob: bytes) -> bytes:
    """Inverse of curve25519_seal; raises on tamper/garbage."""
    epk, ct = blob[:32], blob[32:]
    pub = curve25519_derive_public(secret32)
    key = curve25519_derive_shared(secret32, epk, epk, pub)
    nonce = sha256(b"sealed-box-nonce" + epk + pub)[:12]
    return ChaCha20Poly1305(key).decrypt(nonce, ct, b"")
