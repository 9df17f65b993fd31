"""Wycheproof-class ed25519 adversarial vectors, built on the port's own
curve arithmetic.

Copied from `tests/test_ed25519_adversarial.py` (`_torsion_points`,
`_k_scalar`, `_vectors`) at commit 6685f6a, rewritten on this package's
`_Pt` and `SecretKey` so that the chip smoke run can drive the hostile
encodings without importing the JAX package; carry a fix in either copy to
the other. The vector classes: small-order A (all 8 torsion points) with
S=0 forgeries, accept- and reject-shaped; small-order R; mixed-order A;
non-canonical y >= p for A and R; S edge cases around L; identity points;
non-point encodings; malformed lengths.
"""

import hashlib

from ..crypto.keys import SecretKey
from ..ops.ed25519 import L, P, _Pt, _recover_x


def _torsion_points():
    """All 8 small-order points, found with the module's own arithmetic:
    [L]Q kills the prime-order component of any curve point, leaving its
    torsion part."""
    pts = {}
    y = 0
    while len(pts) < 8 and y < 5000:
        y += 1
        for sign in (0, 1):
            x = _recover_x(y % P, sign)
            if x is None:
                continue
            t = _Pt(x, y % P).mul(L)
            pts[t.compress()] = t
    assert len(pts) == 8, "expected the full 8-torsion subgroup"
    return pts




def _k_scalar(r_enc: bytes, a_enc: bytes, msg: bytes) -> int:
    return int.from_bytes(
        hashlib.sha512(r_enc + a_enc + msg).digest(), "little") % L


def _vectors():
    """(label, pub32, sig64, msg) tuples — ≥50 adversarial cases."""
    torsion = _torsion_points()
    sk = SecretKey.from_seed(b"\x2a" * 32)
    pub = sk.public_key.key_bytes
    msg = b"wycheproof-class vector"
    good = sk.sign(msg)
    vecs = [("honest baseline", pub, good, msg)]

    # --- S edge cases on an otherwise-honest signature ---------------------
    r_enc = good[:32]
    for label, s_val in [
        ("S=0", 0),
        ("S=1", 1),
        ("S=L-1", L - 1),
        ("S=L", L),
        ("S=L+1", L + 1),
        ("S=2^252", 2 ** 252),
        ("S=2^255-1", 2 ** 255 - 1),
        ("S=L+2^253 (high-bit game)", L + 2 ** 253),
    ]:
        vecs.append(("sig %s" % label, pub,
                     r_enc + s_val.to_bytes(32, "little"), msg))

    # --- small-order A, S=0: accept-shaped forgeries -----------------------
    # with S=0 the equation is R == [-k]A; for 8-torsion A an attacker
    # scans R over the torsion group until H(R||A||m) hits the right
    # residue mod the point's order. All backends must AGREE (RFC 8032
    # cofactorless accepts these; a blacklist-style implementation that
    # rejects them would fork).
    accept_shaped = 0
    for a_enc, a_pt in torsion.items():
        ax, ay = a_pt.affine()   # stored points are extended-coordinate
        neg_a = _Pt(P - ax if ax else 0, ay)
        # scan (R candidate, msg nonce) pairs until the equation holds —
        # each try hits with probability ~1/order(A), so a small bounded
        # scan always finds one for every torsion point
        found = False
        for nonce in range(64):
            m = msg + b"/%d" % nonce
            for r_enc2 in torsion:
                if neg_a.mul(_k_scalar(r_enc2, a_enc, m)).compress() \
                        == r_enc2:
                    vecs.append(
                        ("small-order A=%s S=0 accept-shaped"
                         % a_enc[:4].hex(), a_enc,
                         r_enc2 + b"\x00" * 32, m))
                    accept_shaped += 1
                    found = True
                    break
            if found:
                break
        # reject-shaped: R = torsion point that does NOT satisfy it
        for r_enc2 in torsion:
            if neg_a.mul(_k_scalar(r_enc2, a_enc, msg)).compress() \
                    != r_enc2:
                vecs.append(
                    ("small-order A=%s S=0 reject-shaped" % a_enc[:4].hex(),
                     a_enc, r_enc2 + b"\x00" * 32, msg))
                break
    # every torsion point must contribute an accept-shaped forgery, or
    # the dangerous half of the matrix is quietly missing
    assert accept_shaped == len(torsion), accept_shaped

    # --- small-order R with honest A --------------------------------------
    for i, r_enc2 in enumerate(torsion):
        vecs.append(("small-order R #%d honest A" % i, pub,
                     r_enc2 + good[32:], msg))

    # --- identity point everywhere -----------------------------------------
    ident = _Pt.identity().compress()
    vecs.append(("identity A, honest sig", ident, good, msg))
    vecs.append(("identity A identity R S=0", ident,
                 ident + b"\x00" * 32, msg))
    vecs.append(("honest A identity R S=0", pub, ident + b"\x00" * 32, msg))

    # --- mixed-order A: honest point + torsion component -------------------
    ax = _recover_x(int.from_bytes(pub, "little") & ((1 << 255) - 1),
                    int.from_bytes(pub, "little") >> 255)
    a_pt = _Pt(ax, int.from_bytes(pub, "little") & ((1 << 255) - 1))
    for i, (t_enc, t_pt) in enumerate(torsion.items()):
        if t_pt.x == 0 and t_pt.y == 1:
            continue  # identity: A' == A
        mixed = a_pt.add(t_pt).compress()
        vecs.append(("mixed-order A (+T%d), honest sig" % i, mixed,
                     good, msg))

    # --- non-canonical y >= p for A and R ----------------------------------
    for delta, y_desc in [(0, "y=p"), (1, "y=p+1"), (2, "y=p+2"),
                          (18, "y=p+18")]:
        y = P + delta
        for sign in (0, 1):
            enc = int.to_bytes(y | (sign << 255), 32, "little")
            vecs.append(("non-canonical A %s sign=%d" % (y_desc, sign),
                         enc, good, msg))
            vecs.append(("non-canonical R %s sign=%d" % (y_desc, sign),
                         pub, enc + good[32:], msg))
    # y just below p: canonical but likely not on curve — agreement only
    enc = int.to_bytes(P - 1, 32, "little")
    vecs.append(("A y=p-1 (on-curve order-2 sibling?)", enc, good, msg))

    # --- non-point encodings ----------------------------------------------
    vecs.append(("A all-0xff", b"\xff" * 32, good, msg))
    vecs.append(("R all-0xff", pub, b"\xff" * 32 + good[32:], msg))

    # --- malformed lengths (cheap sanity; oracle contract is False) --------
    vecs.append(("short sig", pub, good[:63], msg))
    vecs.append(("long msg honest", pub, sk.sign(b"m" * 4096), b"m" * 4096))
    return vecs
