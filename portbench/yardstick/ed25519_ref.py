"""The benchmark's reference ed25519 verify: RFC 8032, cofactorless.

Plain Python integers, written for the benchmark and independent of the
port. The decision rule is the one the configurations state:

- S must be canonical, S < L; otherwise reject.
- A and R must be canonical encodings: y < p, and x = 0 with the sign
  bit set is refused; a y with no square root is refused.
- Accept when [S]B - [k]A equals R, k = SHA-512(R || A || M) mod L, with
  no multiplication by the cofactor.

`verify(..., canonical_s=False)` and `verify(..., cofactored=True)` each
break one of those guarantees: they are the controls of the comparison
that decides `correct`. The helpers below make the traffic's corrupted
signatures: one bit flipped, S + L (the same signature, malleated), and a
signature whose R carries a point of order 8 (valid only to a cofactored
verify).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

Point = Tuple[int, int, int, int]     # extended (X, Y, Z, T), x = X/Z
IDENTITY: Point = (0, 1, 1, 0)


def _recover_x(y: int, sign: int) -> Optional[int]:
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x2 = u * pow(v, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
        if (x * x - x2) % P:
            return None
    if x & 1 != sign:
        x = P - x
    return x


def decode_point(b: bytes) -> Optional[Point]:
    """The point a 32-byte encoding names, or None when the encoding is
    not canonical or names no point."""
    n = int.from_bytes(b, "little")
    y, sign = n & ((1 << 255) - 1), n >> 255
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def encode_point(p: Point) -> bytes:
    x, y, z, _t = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def add(p: Point, q: Point) -> Point:
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def double(p: Point) -> Point:
    x1, y1, z1, _t = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = (h - (x1 + y1) * (x1 + y1)) % P
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def neg(p: Point) -> Point:
    x, y, z, t = p
    return ((P - x) % P, y, z, (P - t) % P)


def equal(p: Point, q: Point) -> bool:
    return (p[0] * q[2] - q[0] * p[2]) % P == 0 and \
        (p[1] * q[2] - q[1] * p[2]) % P == 0


def _table16(p: Point) -> list:
    t = [IDENTITY, p]
    for _ in range(14):
        t.append(add(t[-1], p))
    return t


B: Point = decode_point((4 * pow(5, P - 2, P) % P).to_bytes(32, "little"))
_B_TABLE = _table16(B)


def double_scalar_mul(s: int, b_table: list, k: int, a_table: list) -> Point:
    """[s]B + [k]A from the two points' tables of [0..15] multiples,
    four bits a step (Straus)."""
    q = IDENTITY
    for shift in range(252, -1, -4):
        q = double(double(double(double(q))))
        i = (s >> shift) & 15
        if i:
            q = add(q, b_table[i])
        j = (k >> shift) & 15
        if j:
            q = add(q, a_table[j])
    return q


def scalar_mul(n: int, p: Point) -> Point:
    q = IDENTITY
    while n:
        if n & 1:
            q = add(q, p)
        p = double(p)
        n >>= 1
    return q


def verify(pub: bytes, sig: bytes, msg: bytes, canonical_s: bool = True,
           cofactored: bool = False) -> bool:
    """RFC 8032 cofactorless verify with the canonical checks; the two
    flags break one guarantee each (the controls)."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        if canonical_s:
            return False
        s %= L
    a = decode_point(pub)
    r = decode_point(sig[:32])
    if a is None or r is None:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(),
                       "little") % L
    q = double_scalar_mul(s, _B_TABLE, k, _table16(neg(a)))
    if cofactored:
        diff = add(q, neg(r))
        return equal(double(double(double(diff))), IDENTITY)
    return equal(q, r)


# --- the traffic's corrupted signatures -------------------------------------

def flip_bit(sig: bytes, bit: int) -> bytes:
    """`sig` with bit `bit` (0..511, little-endian within each byte)
    flipped."""
    b = bytearray(sig)
    b[bit // 8] ^= 1 << (bit % 8)
    return bytes(b)


def s_plus_l(sig: bytes) -> bytes:
    """The same signature with S replaced by S + L: a verifier that
    reduces S mod L instead of refusing it accepts it."""
    s = int.from_bytes(sig[32:], "little") + L
    return sig[:32] + s.to_bytes(32, "little")


def _order8_point() -> Point:
    """A point of order 8: [L]P for the first point P (by y = 2, 3, ...)
    whose torsion part has that order."""
    for y in range(2, 1000):
        p = decode_point(y.to_bytes(32, "little"))
        if p is None:
            continue
        t = scalar_mul(L, p)
        if not equal(scalar_mul(4, t), IDENTITY):
            return t
    raise RuntimeError("no point of order 8 found")


T8: Point = _order8_point()


def mixed_order_sign(seed: bytes, msg: bytes) -> bytes:
    """A signature by `seed` whose R is rB + T8, T8 of order 8: a
    cofactored verify accepts it, the cofactorless rule refuses it."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    pub = encode_point(scalar_mul(a, B))
    r = int.from_bytes(hashlib.sha512(h[32:] + msg).digest(), "little") % L
    r_enc = encode_point(add(scalar_mul(r, B), T8))
    k = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(),
                       "little") % L
    s = (r + k * a) % L
    return r_enc + s.to_bytes(32, "little")
