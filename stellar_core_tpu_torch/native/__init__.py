"""Native (C) ed25519 for the port: the CPU signer and CPU verifier.

`ed25519c.c` and `gen_constants.py` are copies of the reference package's
files (see their headers). The library is built by `_build.build_native`
and loaded here through ctypes, as `stellar_core_tpu/native/__init__.py`
loads its own copy.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_ED_LIB = None
_ED_TRIED = False


class _Ed25519Native:
    """Thin ctypes wrapper; one instance per process."""

    def __init__(self, lib) -> None:
        self._lib = lib

    def public(self, seed: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        self._lib.sct_ed25519_public(seed, out)
        return out.raw

    def sign(self, seed: bytes, msg: bytes) -> bytes:
        out = ctypes.create_string_buffer(64)
        self._lib.sct_ed25519_sign(seed, msg, len(msg), out)
        return out.raw

    def verify(self, pub: bytes, sig: bytes, msg: bytes) -> bool:
        if len(pub) != 32 or len(sig) != 64:
            return False
        return bool(self._lib.sct_ed25519_verify(pub, sig, msg, len(msg)))

    def verify_batch(self, triples) -> list:
        """[(key32, sig64, msg)] → [bool] in one C call."""
        n = len(triples)
        if n == 0:
            return []
        pubs = b"".join(t[0] for t in triples)
        sigs = b"".join(t[1] for t in triples)
        if len(pubs) != 32 * n or len(sigs) != 64 * n:
            # odd-length keys/sigs: per-item path handles rejections
            return [self.verify(k, s, m) for (k, s, m) in triples]
        msgs = b"".join(t[2] for t in triples)
        off = np.zeros(n + 1, np.uint64)
        np.cumsum([len(t[2]) for t in triples], out=off[1:])
        out = np.empty(n, np.uint8)
        self._lib.sct_ed25519_verify_batch(
            pubs, sigs, msgs or b"\x00",
            off.ctypes.data_as(ctypes.c_void_p), n,
            out.ctypes.data_as(ctypes.c_void_p))
        return out.astype(bool).tolist()


def ed25519_native() -> Optional[_Ed25519Native]:
    """Build + load the native ed25519 library; None only when the host
    has no C compiler (callers then use crypto/fallback.py's pure-Python
    path). A failed build or a failed self-init raises."""
    global _ED_LIB, _ED_TRIED
    with _LOCK:
        if _ED_TRIED:
            return _ED_LIB
        from .._build import build_native
        so = build_native()
        if so is not None:
            lib = ctypes.CDLL(so)
            lib.sct_ed25519_public.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p]
            lib.sct_ed25519_sign.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_char_p]
            lib.sct_ed25519_verify.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_uint64]
            lib.sct_ed25519_verify.restype = ctypes.c_int
            lib.sct_ed25519_verify_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            if lib.sct_ed25519_init() != 0:
                raise RuntimeError("sct_ed25519_init failed")
            _ED_LIB = _Ed25519Native(lib)
        _ED_TRIED = True
        return _ED_LIB
