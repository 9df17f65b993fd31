"""Keys, the synchronous CPU signature path and the verify-result cache.

Port of the parts of `stellar_core_tpu/crypto/keys.py` the verify boundary
needs: `SecretKey` (from a 32-byte seed; `public_key` is the raw 32-byte
ed25519 key), `raw_verify` / `raw_verify_batch` (RFC 8032 cofactorless,
the semantics every verify backend must match) and the global
verify-result cache that sits in front of every batch backend.

CPU crypto is the native C library (native/ed25519c.c) where a C compiler
exists and the pure-Python RFC 8032 code (crypto/fallback.py) elsewhere:
identical accept/reject decisions either way. Keys are raw 32-byte values:
`SecretKey.public_key` returns the raw key, not the reference's XDR
`PublicKey`, and its callers rely on that. `PubKeyUtils.verify_sig`
(copied from the reference at commit 89bbd6f) is the one entry that takes
an XDR `PublicKey`, for the state commitment's light clients; it reads
the key's `key_bytes` and goes through the same cached `verify_sig`.
"""

from __future__ import annotations

import hashlib
import threading

from ..native import ed25519_native
from ..util.cache import RandomEvictionCache
from . import fallback as _fb

VERIFY_CACHE_SIZE = 0xFFFF

# the one structure every thread that verifies touches
_cache_lock = threading.Lock()
_verify_cache: RandomEvictionCache = RandomEvictionCache(VERIFY_CACHE_SIZE)


def _cache_key(key32: bytes, sig: bytes, msg: bytes) -> bytes:
    h = hashlib.sha256()
    h.update(key32)
    h.update(sig)
    h.update(msg)
    return h.digest()


def verify_cache_stats() -> dict:
    with _cache_lock:
        return {"hits": _verify_cache.hits, "misses": _verify_cache.misses,
                "size": len(_verify_cache)}


def flush_verify_cache() -> None:
    with _cache_lock:
        _verify_cache.clear()
        _verify_cache.hits = 0
        _verify_cache.misses = 0


def raw_verify(key32: bytes, sig: bytes, msg: bytes) -> bool:
    """Uncached single ed25519 verify on the CPU."""
    if len(key32) != 32 or len(sig) != 64:
        return False
    return _fb.ed25519_verify(key32, sig, msg)


def raw_verify_batch(triples) -> list:
    """[(key32, sig, msg)] → [bool], one native call when the C library
    is available (CpuSigVerifier's whole-batch drain path)."""
    lib = ed25519_native()
    if lib is None:
        return [raw_verify(k, s, m) for (k, s, m) in triples]
    out = [False] * len(triples)
    good = [i for i, (k, s, _m) in enumerate(triples)
            if len(k) == 32 and len(s) == 64]
    for i, ok in zip(good, lib.verify_batch([triples[i] for i in good])):
        out[i] = ok
    return out


def verify_sig(key32: bytes, sig: bytes, msg: bytes) -> bool:
    """Cached verify — the L0 in front of any batch backend (reference
    `PubKeyUtils.verify_sig`)."""
    ck = _cache_key(key32, sig, msg)
    with _cache_lock:
        got = _verify_cache.maybe_get(ck)
    if got is not None:
        return got
    ok = raw_verify(key32, sig, msg)
    with _cache_lock:
        _verify_cache.put(ck, ok)
    return ok


class PubKeyUtils:
    @staticmethod
    def verify_sig(key, sig: bytes, msg: bytes) -> bool:
        """Cached verify of an XDR `PublicKey`'s signature (reference
        SecretKey.cpp:310-337)."""
        return verify_sig(key.key_bytes, sig, msg)


class SecretKey:
    """Ed25519 secret key (seed form)."""

    def __init__(self, seed32: bytes) -> None:
        if len(seed32) != 32:
            raise ValueError("ed25519 seed must be 32 bytes")
        self._seed = seed32
        self._pub = _fb.ed25519_public(seed32)

    @classmethod
    def from_seed(cls, seed32: bytes) -> "SecretKey":
        return cls(seed32)

    @property
    def public_key(self) -> bytes:
        return self._pub

    def sign(self, msg: bytes) -> bytes:
        return _fb.ed25519_sign(self._seed, msg)

    def __repr__(self) -> str:
        return "SecretKey(%s)" % self._pub.hex()
