"""The benchmark's ed25519 signer: the frozen C source in `csrc/`, built
with `cc` into `portbench/cache/` (a fixed directory inside the checkout,
keyed by a hash of the source and flags) and loaded with ctypes.

Only the traffic generators use it; the reference verify is
`ed25519_ref.py`, and neither calls anything of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(HERE, "csrc")
CACHE_DIR = os.path.join(os.path.dirname(HERE), "cache")
FLAGS = ["-O2", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_SIGNER = None


def _build() -> str:
    src = os.path.join(SRC_DIR, "ed25519c.c")
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in ("ed25519c.c", "prep_constants.h"):
        with open(os.path.join(SRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    so = os.path.join(CACHE_DIR, "libbenchsigner-%s.so" % h.hexdigest()[:16])
    if os.path.exists(so):
        return so
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("the benchmark's signer needs a C compiler")
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = "%s.tmp%d" % (so, os.getpid())
    r = subprocess.run([cc] + FLAGS + ["-I", SRC_DIR, "-o", tmp, src],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError("cc failed for the signer:\n%s" % r.stderr[-4000:])
    os.replace(tmp, so)
    return so


class Signer:
    """ed25519 key derivation and signing (RFC 8032)."""

    def __init__(self, so_path: str) -> None:
        lib = ctypes.CDLL(so_path)
        lib.sct_ed25519_public.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.sct_ed25519_sign.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_size_t, ctypes.c_char_p]
        if lib.sct_ed25519_init() != 0:
            raise RuntimeError("the signer failed to initialise")
        self._lib = lib

    def public(self, seed: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        self._lib.sct_ed25519_public(seed, out)
        return out.raw

    def sign(self, seed: bytes, msg: bytes) -> bytes:
        out = ctypes.create_string_buffer(64)
        self._lib.sct_ed25519_sign(seed, msg, len(msg), out)
        return out.raw

    def sign_many(self, jobs, workers: int = 0) -> list:
        """The signatures of (seed, msg) jobs, in order, on `workers`
        threads (the host's cores by default): a foreign call releases the
        interpreter lock."""
        workers = workers or min(8, os.cpu_count() or 1)
        if workers <= 1 or len(jobs) < 1024:
            return [self.sign(s, m) for (s, m) in jobs]
        step = -(-len(jobs) // workers)
        parts = [jobs[i:i + step] for i in range(0, len(jobs), step)]
        with ThreadPoolExecutor(workers) as ex:
            done = ex.map(lambda part: [self.sign(s, m) for (s, m) in part],
                          parts)
            return [sig for part in done for sig in part]


def signer() -> Signer:
    global _SIGNER
    with _LOCK:
        if _SIGNER is None:
            _SIGNER = Signer(_build())
        return _SIGNER
