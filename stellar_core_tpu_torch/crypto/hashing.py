"""Hashing: SHA-256 (one-shot + incremental), HMAC, HKDF, SipHash short hash.

Copied from `stellar_core_tpu/crypto/hashing.py` at commit a7226ae; carry a
fix in either copy to the other. Nothing is left out. Overlay reads the
HMAC (the per-frame MACs, compared in constant time), HKDF (the session
keys) and SHA-512; `ShortHash` keys the process's in-memory short hashes.

Role parity: reference `src/crypto/SHA.cpp:14,37,88-129` (sha256, SHA256
incremental, hmacSha256, hkdf) and `src/crypto/ShortHash.cpp:18` (SipHash-2-4
keyed short hash used for in-memory hash maps).
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import struct


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


class SHA256:
    """Incremental SHA-256 (reference SHA256 class, crypto/SHA.cpp:37)."""

    def __init__(self) -> None:
        self._h = hashlib.sha256()

    def add(self, data: bytes) -> "SHA256":
        self._h.update(data)
        return self

    def finish(self) -> bytes:
        return self._h.digest()


def hmac_sha256(key: bytes, data: bytes) -> bytes:
    return _hmac.new(key, data, hashlib.sha256).digest()


def hmac_sha256_verify(key: bytes, data: bytes, mac: bytes) -> bool:
    return _hmac.compare_digest(hmac_sha256(key, data), mac)


def hkdf_extract(ikm: bytes, salt: bytes = b"\x00" * 32) -> bytes:
    """HKDF-Extract with zero salt default (reference crypto/SHA.cpp:106)."""
    return hmac_sha256(salt, ikm)


def hkdf_expand(prk: bytes, info: bytes = b"", length: int = 32) -> bytes:
    """HKDF-Expand (single-block is all the reference needs,
    crypto/SHA.cpp:118)."""
    assert length <= 255 * 32
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac_sha256(prk, t + info + bytes([i]))
        out += t
        i += 1
    return out[:length]


# --- SipHash-2-4 (short hash for hash maps; keyed per-process) -------------

def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & 0xFFFFFFFFFFFFFFFF


def siphash24(key16: bytes, data: bytes) -> int:
    k0, k1 = struct.unpack("<QQ", key16)
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573

    def rounds(n: int) -> None:
        nonlocal v0, v1, v2, v3
        for _ in range(n):
            v0 = (v0 + v1) & 0xFFFFFFFFFFFFFFFF
            v1 = _rotl(v1, 13) ^ v0
            v0 = _rotl(v0, 32)
            v2 = (v2 + v3) & 0xFFFFFFFFFFFFFFFF
            v3 = _rotl(v3, 16) ^ v2
            v0 = (v0 + v3) & 0xFFFFFFFFFFFFFFFF
            v3 = _rotl(v3, 21) ^ v0
            v2 = (v2 + v1) & 0xFFFFFFFFFFFFFFFF
            v1 = _rotl(v1, 17) ^ v2
            v2 = _rotl(v2, 32)

    b = len(data) & 0xFF
    i = 0
    while len(data) - i >= 8:
        m = struct.unpack_from("<Q", data, i)[0]
        v3 ^= m
        rounds(2)
        v0 ^= m
        i += 8
    tail = data[i:] + b"\x00" * (7 - (len(data) - i)) + bytes([b])
    m = struct.unpack("<Q", tail)[0]
    v3 ^= m
    rounds(2)
    v0 ^= m
    v2 ^= 0xFF
    rounds(4)
    return v0 ^ v1 ^ v2 ^ v3


class ShortHash:
    """Process-wide keyed short hash (reference crypto/ShortHash.cpp:18)."""

    _key = os.urandom(16)

    @classmethod
    def initialize(cls, key: bytes | None = None) -> None:
        cls._key = key if key is not None else os.urandom(16)

    @classmethod
    def compute(cls, data: bytes) -> int:
        return siphash24(cls._key, data)
