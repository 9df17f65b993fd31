"""Self-contained ed25519 fallback for hosts without a C compiler.

Copied from `stellar_core_tpu/crypto/fallback.py` at commit 6685f6a, its
ed25519 part only (the X25519 and ChaCha20-Poly1305 parts wait for the
overlay slice); carry a fix in either copy to the other. In this package
it backs crypto/keys.py where no C compiler exists.

ed25519 sign/verify/public — RFC 8032 cofactorless, rejecting
non-canonical S and non-canonical point encodings, byte-for-byte the
decisions of `ops.ed25519.verify_oracle` (the repo's semantics oracle).

Dispatch order: the native C implementation (native/ed25519c.c, loaded
via ctypes like prep.c) when a compiler is available, else the pure-
Python ints below. The Python path deliberately does NOT import
ops.ed25519 (which would pull jax into processes — bench orchestrator,
scrubbed children — that must never touch it); the ~60 lines of curve
math are duplicated here against that constraint.

Not constant-time. The reference's production path is libsodium; this
fallback exists so the suite, the differential tests, and the bench's
CPU legs run in hermetic containers.
"""

from __future__ import annotations

import hashlib
from typing import Optional

# --- curve constants (python ints; match ops/ed25519.py) -------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
B_Y = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> Optional[int]:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


class _Pt:
    """Extended-coordinate point over python ints."""

    __slots__ = ("x", "y", "z", "t")

    def __init__(self, x, y, z=1, t=None):
        self.x, self.y, self.z = x % P, y % P, z % P
        self.t = (x * y * pow(z, P - 2, P)) % P if t is None else t % P

    @classmethod
    def identity(cls):
        return cls(0, 1, 1, 0)

    def add(self, o: "_Pt") -> "_Pt":
        a = (self.y - self.x) * (o.y - o.x) % P
        b = (self.y + self.x) * (o.y + o.x) % P
        c = self.t * D2 % P * o.t % P
        d = 2 * self.z * o.z % P
        e, f, g, h = b - a, d - c, d + c, b + a
        return _Pt(e * f % P, g * h % P, f * g % P, e * h % P)

    def dbl(self) -> "_Pt":
        a = self.x * self.x % P
        b = self.y * self.y % P
        c = 2 * self.z * self.z % P
        h = a + b
        e = h - (self.x + self.y) ** 2 % P
        g = a - b
        f = c + g
        return _Pt(e * f % P, g * h % P, f * g % P, e * h % P)

    def mul(self, n: int) -> "_Pt":
        q = _Pt.identity()
        p = self
        while n:
            if n & 1:
                q = q.add(p)
            p = p.dbl()
            n >>= 1
        return q

    def affine(self) -> tuple:
        zi = pow(self.z, P - 2, P)
        return (self.x * zi % P, self.y * zi % P)

    def compress(self) -> bytes:
        x, y = self.affine()
        return int.to_bytes(y | ((x & 1) << 255), 32, "little")


B_POINT = _Pt(_recover_x(B_Y, 0), B_Y)


# --- ed25519 ----------------------------------------------------------------

def _clamped_scalar(seed: bytes) -> tuple:
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def _py_public(seed: bytes) -> bytes:
    a, _prefix = _clamped_scalar(seed)
    return B_POINT.mul(a).compress()


def _py_sign(seed: bytes, msg: bytes) -> bytes:
    a, prefix = _clamped_scalar(seed)
    a_enc = B_POINT.mul(a).compress()
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    r_enc = B_POINT.mul(r).compress()
    k = int.from_bytes(hashlib.sha512(r_enc + a_enc + msg).digest(),
                       "little") % L
    s = (r + k * a) % L
    return r_enc + s.to_bytes(32, "little")


def _py_verify(pub: bytes, sig: bytes, msg: bytes) -> bool:
    if len(pub) != 32 or len(sig) != 64:
        return False
    r_bytes, s_bytes = sig[:32], sig[32:]
    s = int.from_bytes(s_bytes, "little")
    if s >= L:
        return False
    ay = int.from_bytes(pub, "little")
    a_sign, ay = ay >> 255, ay & ((1 << 255) - 1)
    ry = int.from_bytes(r_bytes, "little")
    r_sign, ry = ry >> 255, ry & ((1 << 255) - 1)
    ax = _recover_x(ay, a_sign)
    rx = _recover_x(ry, r_sign)
    if ax is None or rx is None:
        return False
    k = int.from_bytes(hashlib.sha512(r_bytes + pub + msg).digest(),
                       "little") % L
    a_neg = _Pt(P - ax if ax else 0, ay)
    q = B_POINT.mul(s).add(a_neg.mul(k))  # [S]B − [k]A
    qx, qy = q.affine()
    return qx == rx and qy == ry


def ed25519_public(seed: bytes) -> bytes:
    from ..native import ed25519_native
    lib = ed25519_native()
    if lib is not None:
        return lib.public(seed)
    return _py_public(seed)


def ed25519_sign(seed: bytes, msg: bytes) -> bytes:
    from ..native import ed25519_native
    lib = ed25519_native()
    if lib is not None:
        return lib.sign(seed, msg)
    return _py_sign(seed, msg)


def ed25519_verify(pub: bytes, sig: bytes, msg: bytes) -> bool:
    from ..native import ed25519_native
    lib = ed25519_native()
    if lib is not None:
        return lib.verify(pub, sig, msg)
    return _py_verify(pub, sig, msg)

