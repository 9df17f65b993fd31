"""Native (C) code of the port, loaded through ctypes.

- `ed25519c.c`: the CPU signer and the CPU verifier (`ed25519_native`).
- `prep.c`: the verify boundary's batched host prep (`prep_lib`,
  `prepare_batch_native`, `cache_keys_native`): SHA-512 and mod L per
  signature, the canonicality prechecks and bit-slicing in one C call per
  batch (ops/ed25519.prepare_batch), and the verify-cache keys of a drain
  in another. No caller uses `cache_keys_native` yet: on the H100's host
  its scalar SHA-256 took about twice the time of the per-triple hashlib
  loop that `prewarm_many` keeps (PERF.md).
- `sha256_pad.c`: the hasher's chunk padder (`sha256_pad_lib`,
  `sha256_pad_native`): FIPS 180-4 padding of a chunk's messages into the
  kernel's big-endian words, written straight into the staging buffer, one
  C call per chunk (ops/sha256.pad_chunk).

`ed25519c.c`, `prep.c` and `gen_constants.py` are copies of the reference
package's files (see their headers); `_build.build_native` builds each C
file into its own library. The loaders here copy
`stellar_core_tpu/native/__init__.py`'s at commit a29fd1b, except that
`cache_keys_native` checks each triple's lengths, not their sums (the
reference's sum check passes a 31-byte key beside a 33-byte one and hashes
the wrong byte ranges). ctypes releases the interpreter lock for the
length of each C call.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_ED_LIB = None
_ED_TRIED = False
_PREP_LIB = None
_PREP_TRIED = False
_PAD_LIB = None
_PAD_TRIED = False

# prepare_batch_native calls that reached the C library (chip_smoke.py
# reads it to show the drain prepared every chunk there)
PREP_CALLS = 0
_CALLS_LOCK = threading.Lock()
# sha256_pad_native calls that reached the C library (chip_smoke.py reads
# it to show a drain padded every chunk there)
PAD_CALLS = 0
_PAD_ERRORS = {1: "bad shape (n outside 0..lanes, or no lanes or blocks)",
               2: "a message reaches past the end of the blob",
               3: "a message needs more blocks than the chunk's bucket"}


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
        so = build_native("ed25519c")
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


def prep_lib() -> Optional[ctypes.CDLL]:
    """Build + load the host-prep library (prep.c); None only when the
    host has no C compiler (callers then use the numpy prep). A failed
    build raises."""
    global _PREP_LIB, _PREP_TRIED
    with _LOCK:
        if _PREP_TRIED:
            return _PREP_LIB
        from .._build import build_native
        so = build_native("prep")
        if so is not None:
            lib = ctypes.CDLL(so)
            lib.sct_prepare_batch.restype = ctypes.c_int
            lib.sct_prepare_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.sct_cache_keys.restype = ctypes.c_int
            lib.sct_cache_keys.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            _PREP_LIB = lib
        _PREP_TRIED = True
        return _PREP_LIB


def _msg_blob(msgs) -> tuple:
    """(concatenated bodies as a uint8 array, n + 1 uint64 offsets)."""
    blob = b"".join(msgs)
    off = np.zeros(len(msgs) + 1, np.uint64)
    np.cumsum([len(m) for m in msgs], out=off[1:])
    return (np.frombuffer(blob, np.uint8) if blob
            else np.zeros(1, np.uint8)), off


def prepare_batch_native(pub_arr: np.ndarray, sig_arr: np.ndarray,
                         msgs: list) -> Optional[dict]:
    """(n, 32) / (n, 64) uint8 + n messages -> the kernel's arrays with
    UNSIGNED radix-16 digits and `pre_ok`, or None when the library is
    unavailable. Rows with wrong-length keys or signatures must be
    zero-filled by the caller (ops/ed25519._pack32) and masked by it."""
    global PREP_CALLS
    lib = prep_lib()
    if lib is None:
        return None
    n = len(msgs)
    if pub_arr.dtype != np.uint8 or pub_arr.shape != (n, 32) or \
            sig_arr.dtype != np.uint8 or sig_arr.shape != (n, 64):
        raise ValueError("prepare_batch_native wants (%d, 32) and (%d, 64) "
                         "uint8, got %s %r and %s %r"
                         % (n, n, pub_arr.dtype, pub_arr.shape,
                            sig_arr.dtype, sig_arr.shape))
    msg_c, off = _msg_blob(msgs)
    ay = np.empty((n, 20), np.int32)
    ry = np.empty((n, 20), np.int32)
    a_sign = np.empty(n, np.int32)
    r_sign = np.empty(n, np.int32)
    s_nibs = np.empty((n, 64), np.int32)
    k_nibs = np.empty((n, 64), np.int32)
    pre_ok = np.empty(n, np.uint8)
    pub_c = np.ascontiguousarray(pub_arr)
    sig_c = np.ascontiguousarray(sig_arr)
    lib.sct_prepare_batch(
        pub_c.ctypes.data, sig_c.ctypes.data, msg_c.ctypes.data,
        off.ctypes.data, n,
        ay.ctypes.data, a_sign.ctypes.data,
        ry.ctypes.data, r_sign.ctypes.data,
        s_nibs.ctypes.data, k_nibs.ctypes.data, pre_ok.ctypes.data)
    with _CALLS_LOCK:
        PREP_CALLS += 1
    return {"ay": ay, "a_sign": a_sign, "ry": ry, "r_sign": r_sign,
            "s_nibs": s_nibs, "k_nibs": k_nibs,
            "pre_ok": pre_ok.astype(bool)}


def cache_keys_native(triples) -> Optional[list]:
    """[(key32, sig64, msg)] -> [sha256(key ‖ sig ‖ msg)] in one C call,
    or None when the library is unavailable, the batch is empty, or any
    triple's key is not 32 bytes or its signature not 64 (the caller then
    hashes per triple with hashlib)."""
    lib = prep_lib()
    n = len(triples)
    if lib is None or n == 0 or \
            not all(len(k) == 32 and len(s) == 64 for (k, s, _m) in triples):
        return None
    pubs = b"".join(t[0] for t in triples)
    sigs = b"".join(t[1] for t in triples)
    msg_c, off = _msg_blob([t[2] for t in triples])
    out = np.empty(32 * n, np.uint8)
    lib.sct_cache_keys(pubs, sigs, msg_c.ctypes.data, off.ctypes.data, n,
                       out.ctypes.data)
    ob = out.tobytes()
    return [ob[32 * i:32 * i + 32] for i in range(n)]


def sha256_pad_lib() -> Optional[ctypes.CDLL]:
    """Build + load the chunk padder (sha256_pad.c); None only when the
    host has no C compiler (callers then use the numpy padding). A failed
    build raises."""
    global _PAD_LIB, _PAD_TRIED
    with _LOCK:
        if _PAD_TRIED:
            return _PAD_LIB
        from .._build import build_native
        so = build_native("sha256_pad")
        if so is not None:
            lib = ctypes.CDLL(so)
            lib.sct_sha256_pad.restype = ctypes.c_int
            lib.sct_sha256_pad.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            _PAD_LIB = lib
        _PAD_TRIED = True
        return _PAD_LIB


def sha256_pad_native(blob: bytes, off: np.ndarray, lens: np.ndarray,
                      words: np.ndarray, counts: np.ndarray) -> bool:
    """Pad messages blob[off[i]:off[i] + lens[i]] into lanes 0..n-1 of
    `words` ((lanes, blocks, 16) int32, C-contiguous) and write all of
    `counts` ((lanes,) int32; 0 on padding lanes) in one C call. False
    when the library is unavailable; ValueError on arrays of the wrong
    type or shape and on a message that does not fit (nothing is written
    then)."""
    global PAD_CALLS
    lib = sha256_pad_lib()
    if lib is None:
        return False
    n = len(off)
    if words.dtype != np.int32 or words.ndim != 3 or \
            words.shape[2] != 16 or not words.flags.c_contiguous or \
            counts.dtype != np.int32 or counts.shape != words.shape[:1] \
            or not counts.flags.c_contiguous:
        raise ValueError("sha256_pad_native wants (lanes, blocks, 16) and "
                         "(lanes,) C-contiguous int32, got %s %r and %s %r"
                         % (words.dtype, words.shape, counts.dtype,
                            counts.shape))
    if off.dtype != np.uint64 or lens.dtype != np.uint64 or \
            off.shape != (n,) or lens.shape != (n,) or \
            not off.flags.c_contiguous or not lens.flags.c_contiguous:
        raise ValueError("sha256_pad_native wants (n,) C-contiguous uint64 "
                         "offsets and lengths")
    rc = lib.sct_sha256_pad(blob, len(blob), off.ctypes.data,
                            lens.ctypes.data, n, words.shape[0],
                            words.shape[1], words.ctypes.data,
                            counts.ctypes.data)
    if rc != 0:
        raise ValueError("sct_sha256_pad refused the chunk: %s"
                         % _PAD_ERRORS.get(rc, "error %d" % rc))
    with _CALLS_LOCK:
        PAD_CALLS += 1
    return True
