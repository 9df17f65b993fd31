"""Self-contained crypto fallbacks for hosts without a C compiler.

Copied from `stellar_core_tpu/crypto/fallback.py`: the ed25519 part at
commit 6685f6a, the X25519 and ChaCha20-Poly1305 parts at commit ba35320;
carry a fix in either copy to the other. Nothing is left out. In this
package it backs crypto/keys.py and crypto/curve25519.py (the port has no
`cryptography`; see that file's header):

- ed25519 sign/verify/public — RFC 8032 cofactorless, rejecting
  non-canonical S and non-canonical point encodings, byte-for-byte the
  decisions of `ops.ed25519.verify_oracle` (the repo's semantics oracle).
- X25519 ECDH (RFC 7748) for overlay peer session keys.
- ChaCha20-Poly1305 AEAD (RFC 8439) for sealed survey responses.

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
import struct
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


# --- X25519 (RFC 7748) ------------------------------------------------------

_A24 = 121665


def _x25519_ladder(k_int: int, u_int: int) -> int:
    x1 = u_int % P
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (k_int >> t) & 1
        if swap ^ kt:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = z3 * z3 % P * x1 % P
        x2 = aa * bb % P
        z2 = e * (aa + _A24 * e) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return x2 * pow(z2, P - 2, P) % P


def _x25519(scalar32: bytes, u32: bytes) -> bytes:
    k = bytearray(scalar32)
    k[0] &= 248
    k[31] &= 127
    k[31] |= 64
    k_int = int.from_bytes(bytes(k), "little")
    u_int = int.from_bytes(u32, "little") & ((1 << 255) - 1)
    return _x25519_ladder(k_int, u_int).to_bytes(32, "little")


_X25519_BASE = (9).to_bytes(32, "little")


def x25519_public(secret32: bytes) -> bytes:
    from ..native import ed25519_native
    lib = ed25519_native()
    if lib is not None:
        return lib.x25519(secret32, _X25519_BASE)
    return _x25519(secret32, _X25519_BASE)


def x25519_shared(secret32: bytes, public32: bytes) -> bytes:
    """Raises ValueError on an all-zero shared secret (small-order peer
    point), matching `cryptography`'s X25519PrivateKey.exchange."""
    from ..native import ed25519_native
    lib = ed25519_native()
    out = (lib.x25519(secret32, public32) if lib is not None
           else _x25519(secret32, public32))
    if out == b"\x00" * 32:
        raise ValueError("X25519 shared secret is all zeros")
    return out


# --- ChaCha20-Poly1305 (RFC 8439) ------------------------------------------

def _rotl32(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & 0xFFFFFFFF


def _chacha_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    st = list(struct.unpack("<4I", b"expand 32-byte k"))
    st += list(struct.unpack("<8I", key))
    st.append(counter & 0xFFFFFFFF)
    st += list(struct.unpack("<3I", nonce))
    ws = st[:]

    def qr(a, b, c, d):
        ws[a] = (ws[a] + ws[b]) & 0xFFFFFFFF
        ws[d] = _rotl32(ws[d] ^ ws[a], 16)
        ws[c] = (ws[c] + ws[d]) & 0xFFFFFFFF
        ws[b] = _rotl32(ws[b] ^ ws[c], 12)
        ws[a] = (ws[a] + ws[b]) & 0xFFFFFFFF
        ws[d] = _rotl32(ws[d] ^ ws[a], 8)
        ws[c] = (ws[c] + ws[d]) & 0xFFFFFFFF
        ws[b] = _rotl32(ws[b] ^ ws[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return struct.pack("<16I", *((w + s) & 0xFFFFFFFF
                                 for w, s in zip(ws, st)))


def _chacha20(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 64):
        ks = _chacha_block(key, counter + i // 64, nonce)
        chunk = data[i:i + 64]
        out += bytes(a ^ b for a, b in zip(chunk, ks))
    return bytes(out)


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little") & \
        0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:], "little")
    pp = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        blk = msg[i:i + 16]
        n = int.from_bytes(blk + b"\x01", "little")
        acc = (acc + n) * r % pp
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b"\x00" * (-len(b) % 16)


def _aead_tag(key: bytes, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
    poly_key = _chacha_block(key, 0, nonce)[:32]
    mac_data = (aad + _pad16(aad) + ct + _pad16(ct) +
                struct.pack("<QQ", len(aad), len(ct)))
    return _poly1305(poly_key, mac_data)


class ChaCha20Poly1305:
    """Drop-in for cryptography.hazmat.primitives.ciphers.aead's class
    (the two methods SurveyManager's sealed boxes use)."""

    def __init__(self, key: bytes) -> None:
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = key

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes) -> bytes:
        aad = aad or b""
        ct = _chacha20(self._key, 1, nonce, data)
        return ct + _aead_tag(self._key, nonce, aad, ct)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes) -> bytes:
        aad = aad or b""
        if len(data) < 16:
            raise ValueError("ciphertext too short")
        ct, tag = data[:-16], data[-16:]
        want = _aead_tag(self._key, nonce, aad, ct)
        if not _consteq(want, tag):
            raise ValueError("authentication tag mismatch")
        return _chacha20(self._key, 1, nonce, ct)


def _consteq(a: bytes, b: bytes) -> bool:
    import hmac
    return hmac.compare_digest(a, b)
