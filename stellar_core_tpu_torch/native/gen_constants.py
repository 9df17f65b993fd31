"""Generate exact integer constants for the native host-prep module.

Copied from `stellar_core_tpu/native/gen_constants.py` at commit 6685f6a;
carry a fix in either copy to the other. In this package it feeds
native/ed25519c.c and native/prep.c.

SHA-512 round constants are the first 64 bits of the fractional parts of
the cube roots of the first 80 primes; the initial state is the same for
square roots of the first 8 primes (FIPS 180-4). C's long-double math
cannot produce these exactly, so they are computed here with exact integer
arithmetic and embedded into the generated header.
"""

from __future__ import annotations

L = 2**252 + 27742317777372353535851937790883648493
P25519 = 2**255 - 19


def _primes(n: int):
    out, k = [], 2
    while len(out) < n:
        if all(k % p for p in out if p * p <= k):
            out.append(k)
        k += 1
    return out


def _iroot(x: int, n: int) -> int:
    """Integer floor n-th root."""
    if x == 0:
        return 0
    hi = 1 << ((x.bit_length() + n - 1) // n + 1)
    lo = 0
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if mid**n <= x:
            lo = mid
        else:
            hi = mid
    return lo


def _frac_bits(prime: int, root: int) -> int:
    """First 64 bits of frac(prime^(1/root)), exactly."""
    # prime^(1/root) * 2^64 = (prime * 2^(64*root)) ^ (1/root)
    whole = _iroot(prime << (64 * root), root)
    return whole & ((1 << 64) - 1)


def k_table():
    return [_frac_bits(p, 3) for p in _primes(80)]


def h_init():
    return [_frac_bits(p, 2) for p in _primes(8)]


def limbs64(x: int, n: int):
    return [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(n)]


def header_text() -> str:
    lines = ["/* generated by gen_constants.py — do not edit */",
             "#include <stdint.h>", ""]
    lines.append("static const uint64_t SHA512_K[80] = {")
    ks = k_table()
    for i in range(0, 80, 4):
        lines.append("    " + ", ".join("0x%016xULL" % v
                                        for v in ks[i:i + 4]) + ",")
    lines.append("};")
    lines.append("static const uint64_t SHA512_H0[8] = {")
    lines.append("    " + ", ".join("0x%016xULL" % v for v in h_init()) +
                 ",")
    lines.append("};")
    # ed25519 group order L and Barrett mu = floor(2^512 / L), 64-bit limbs
    mu = (1 << 512) // L
    lines.append("static const uint64_t ED_L[4] = {")
    lines.append("    " + ", ".join("0x%016xULL" % v
                                    for v in limbs64(L, 4)) + ",")
    lines.append("};")
    lines.append("static const uint64_t ED_MU[5] = {")
    lines.append("    " + ", ".join("0x%016xULL" % v
                                    for v in limbs64(mu, 5)) + ",")
    lines.append("};")
    lines.append("static const uint64_t ED_P[4] = {")
    lines.append("    " + ", ".join("0x%016xULL" % v
                                    for v in limbs64(P25519, 4)) + ",")
    lines.append("};")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    import hashlib
    # self-check against hashlib before emitting anything
    ks = k_table()
    assert ks[0] == 0x428a2f98d728ae22 and ks[79] == 0x6c44198c4a475817
    hs = h_init()
    assert hs[0] == 0x6a09e667f3bcc908
    print(header_text())
