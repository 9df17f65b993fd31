"""SHA-256, one-shot and incremental.

Copied (`sha256` and `SHA256` only) from `stellar_core_tpu/crypto/hashing.py`
at commit ada2c73; carry a fix in either copy to the other.

Role parity: reference `src/crypto/SHA.cpp:14,37` (sha256, the SHA256
incremental hasher).
"""

from __future__ import annotations

import hashlib


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


class SHA256:
    """Incremental SHA-256 (reference SHA256 class, crypto/SHA.cpp:37)."""

    def __init__(self) -> None:
        self._h = hashlib.sha256()

    def add(self, data: bytes) -> "SHA256":
        self._h.update(data)
        return self

    def finish(self) -> bytes:
        return self._h.digest()
