"""Batched ed25519 verification: the plain PyTorch version, host prep, and
the wrapper that launches the Hopper kernel.

Port of `stellar_core_tpu/ops/ed25519.py`:

- Verification equation (RFC 8032, cofactorless, the semantics of the CPU
  verifiers): [S]B == R + [k]A with k = SHA512(R‖A‖M) mod L, computed as
  Q = [S]B + [k](−A) and compared with the decompressed R projectively.
- `verify_plain` is the plain version of the reference's `verify_kernel`:
  the same field ops (ops/field.py, 20 13-bit limbs, limb-first), the same
  point formulas and the same signed radix-16 ladders. Where the TPU
  selected table entries with a masked sum (a select is pure data movement
  on its vector unit), this version gathers by index: verification inputs
  are public, so a direct indexed load is correct.
- `verify_kernel` is the wrapper: on CUDA tensors it launches
  `csrc/ed25519_verify.cu` (built at first use) and counts the launch in
  `LAUNCHES`; on CPU tensors it runs `verify_plain`. It never falls back
  from the card to the plain version: a build or launch failure raises.
- Host prep (`prepare_batch`): SHA-512 and mod L per item, canonicality
  prechecks, limb and digit slicing, as in the reference. One C call does
  it for the whole batch (native/prep.c) wherever the host has a C
  compiler; `prepare_batch_plain`, the numpy/hashlib path, runs where it
  has none and is the plain version the C call is held against. The
  arrays are the kernel's input contract, unchanged.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading

import numpy as np
import torch

from .. import native as _native
from .field import (
    NLIMBS, LIMB_BITS, LIMB_MASK, P, _bcast, fe_add, fe_eq, fe_is_zero,
    fe_mul, fe_mul_small, fe_neg, fe_one, fe_parity, fe_pow_p58, fe_sq,
    fe_sub, fe_zero, limbs_from_int, on_device,
)

# --- curve constants (python ints) ----------------------------------------

L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
B_Y = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> int | None:
    """Python-int point decompression (RFC 8032 §5.1.3 math)."""
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


B_X = _recover_x(B_Y, 0)


class _Pt:
    """Python-int extended-coordinate point (oracle + table generation)."""

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

    def affine(self) -> tuple[int, int]:
        zi = pow(self.z, P - 2, P)
        return (self.x * zi % P, self.y * zi % P)

    def compress(self) -> bytes:
        x, y = self.affine()
        return int.to_bytes(y | ((x & 1) << 255), 32, "little")


B_POINT = _Pt(B_X, B_Y)


def verify_oracle(pub: bytes, sig: bytes, msg: bytes) -> bool:
    """Pure-Python RFC 8032 cofactorless verify — the semantics oracle
    every backend must match."""
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


# --- precomputed fixed-base table (Niels form) -----------------------------

def _build_fixed_table() -> np.ndarray:
    """table[j, v] = Niels(v · 16^j · B) as 3×20 limbs: (y+x, y−x, 2dxy).
    Only magnitudes 0..8 are stored — scalars are recoded to signed
    radix-16 digits in [−8, 8) and a negative digit negates the selected
    entry (a y±x swap plus an xy2d negation)."""
    tab = np.zeros((64, 9, 3, NLIMBS), np.int32)
    base = B_POINT
    for j in range(64):
        acc = _Pt.identity()
        for v in range(9):
            x, y = acc.affine() if v else (0, 1)
            tab[j, v, 0] = limbs_from_int((y + x) % P)
            tab[j, v, 1] = limbs_from_int((y - x) % P)
            tab[j, v, 2] = limbs_from_int(2 * D * x % P * y % P)
            acc = acc.add(base)
        for _ in range(4):
            base = base.dbl()
    return tab


_FIXED_TABLE: np.ndarray | None = None


def fixed_table() -> np.ndarray:
    global _FIXED_TABLE
    if _FIXED_TABLE is None:
        _FIXED_TABLE = _build_fixed_table()
    return _FIXED_TABLE


# --- the kernel's radix 2^25.5 and its parameter block ---------------------

# limb k of the kernel's field elements sits at bit ceil(25.5 k), 26 bits
# wide for even k and 25 for odd k (csrc/fe25519.cuh)
RADIX_OFFSETS = tuple((51 * k + 1) // 2 for k in range(10))
RADIX_WIDTHS = tuple(26 if k % 2 == 0 else 25 for k in range(10))


def radix25_from_int(x: int) -> np.ndarray:
    """A value in [0, 2^255) as the kernel's 10 limbs (int32)."""
    return np.array([(x >> o) & ((1 << w) - 1)
                     for o, w in zip(RADIX_OFFSETS, RADIX_WIDTHS)], np.int32)


def radix25_from_limbs13(limbs: np.ndarray) -> np.ndarray:
    """(..., 20) 13-bit limbs → (..., 10) kernel limbs, value for value."""
    flat = np.asarray(limbs).reshape(-1, NLIMBS)
    out = np.zeros((flat.shape[0], 10), np.int32)
    for r in range(flat.shape[0]):
        x = sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(flat[r]))
        out[r] = radix25_from_int(x)
    return out.reshape(np.asarray(limbs).shape[:-1] + (10,))


def kernel_params(table13: np.ndarray) -> np.ndarray:
    """The kernel's int32 parameter block: the fixed-base table (64, 9, 3,
    20) re-encoded to (64, 9, 3, 10), then d, 2d and sqrt(−1)."""
    if table13.shape != (64, 9, 3, NLIMBS):
        raise ValueError("fixed table must be (64, 9, 3, 20), got %r"
                         % (table13.shape,))
    consts = [radix25_from_int(c) for c in (D, D2, SQRT_M1)]
    return np.concatenate([radix25_from_limbs13(table13).reshape(-1)] +
                          consts).astype(np.int32)


# --- point ops: points are (x, y, z, t) tuples of (20, ...) limbs ----------

Point = tuple  # (x, y, z, t)


def pt_identity(batch_shape=(), device=None) -> Point:
    return (fe_zero(batch_shape, device), fe_one(batch_shape, device),
            fe_one(batch_shape, device), fe_zero(batch_shape, device))


_D2_LIMBS = limbs_from_int(D2)
_SQRT_M1_LIMBS = limbs_from_int(SQRT_M1)
_D_LIMBS = limbs_from_int(D)


def pt_add(p: Point, q: Point) -> Point:
    """Unified a=−1 extended addition (add-2008-hwcd-3)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = fe_mul(fe_sub(y1, x1), fe_sub(y2, x2))
    b = fe_mul(fe_add(y1, x1), fe_add(y2, x2))
    c = fe_mul(fe_mul(t1, _bcast(_D2_LIMBS, t1)), t2)
    d = fe_mul_small(fe_mul(z1, z2), 2)
    e = fe_sub(b, a)
    f = fe_sub(d, c)
    g = fe_add(d, c)
    h = fe_add(b, a)
    return (fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))


def pt_add_folded(p: Point, q: Point, need_t: bool = False) -> Point:
    """Extended add where q's T coordinate is pre-multiplied by 2d (table
    form). By default the output T is skipped (ladder adds feed doublings,
    which never read T); the final window add passes need_t=True because
    the fixed-base Niels chain reads it."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2d = q
    a = fe_mul(fe_sub(y1, x1), fe_sub(y2, x2))
    b = fe_mul(fe_add(y1, x1), fe_add(y2, x2))
    c = fe_mul(t1, t2d)
    d = fe_mul_small(fe_mul(z1, z2), 2)
    e = fe_sub(b, a)
    f = fe_sub(d, c)
    g = fe_add(d, c)
    h = fe_add(b, a)
    t = fe_mul(e, h) if need_t else fe_zero(x1.shape[1:], x1.device)
    return (fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), t)


def pt_add_niels(p: Point, n: tuple) -> Point:
    """Mixed addition with a precomputed Niels point (y+x, y−x, 2dxy)."""
    x1, y1, z1, t1 = p
    ypx, ymx, xy2d = n
    a = fe_mul(fe_sub(y1, x1), ymx)
    b = fe_mul(fe_add(y1, x1), ypx)
    c = fe_mul(t1, xy2d)
    d = fe_mul_small(z1, 2)
    e = fe_sub(b, a)
    f = fe_sub(d, c)
    g = fe_add(d, c)
    h = fe_add(b, a)
    return (fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))


def pt_dbl(p: Point, need_t: bool = True) -> Point:
    """a=−1 extended doubling (dbl-2008-hwcd). Doubling never reads T, so
    ladder doublings whose output feeds another doubling pass
    need_t=False and skip the e·h multiply."""
    x1, y1, z1, _ = p
    a = fe_sq(x1)
    b = fe_sq(y1)
    c = fe_mul_small(fe_sq(z1), 2)
    h = fe_add(a, b)
    e = fe_sub(h, fe_sq(fe_add(x1, y1)))
    g = fe_sub(a, b)
    f = fe_add(c, g)
    t = fe_mul(e, h) if need_t else fe_zero(x1.shape[1:], x1.device)
    return (fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), t)


def pt_neg(p: Point) -> Point:
    x, y, z, t = p
    return (fe_neg(x), y, z, fe_neg(t))


def fe_decompress(y_limbs: torch.Tensor, sign: torch.Tensor):
    """Decompress (y, sign) → (x, ok). y is canonical (host-checked y < p).

    x = sqrt((y²−1)/(dy²+1)); multiply by sqrt(−1) when the first candidate
    fails; reject when neither squares to the target or x=0 with sign=1.
    """
    one = fe_one(y_limbs.shape[1:], y_limbs.device)
    y2 = fe_sq(y_limbs)
    u = fe_sub(y2, one)
    v = fe_add(fe_mul(y2, _bcast(_D_LIMBS, y2)), one)
    v3 = fe_mul(fe_sq(v), v)
    v7 = fe_mul(fe_sq(v3), v)
    x = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)))
    vx2 = fe_mul(v, fe_sq(x))
    ok1 = fe_eq(vx2, u)
    ok2 = fe_eq(vx2, fe_neg(u))
    x_alt = fe_mul(x, _bcast(_SQRT_M1_LIMBS, x))
    x = torch.where((ok2 & ~ok1)[None], x_alt, x)
    ok = ok1 | ok2
    x_is_zero = fe_is_zero(x)
    ok = ok & ~(x_is_zero & (sign == 1))
    # fix parity
    flip = fe_parity(x) != sign
    x = torch.where(flip[None], fe_neg(x), x)
    return x, ok


def _select_signed9(stacks: tuple, dig: torch.Tensor) -> tuple:
    """Signed-digit select: each stack (9, 20, B) of extended coords with
    T pre-folded by 2d, dig (B,) in [−8, 8). Gathers entry |dig| of each
    lane, then negates the point where dig < 0 — Edwards negation flips x
    and t only."""
    neg = dig < 0
    idx = dig.abs().long().view(1, 1, -1).expand(1, NLIMBS, dig.shape[0])
    x, y, z, t2d = (torch.gather(s, 0, idx)[0] for s in stacks)
    x = torch.where(neg[None], fe_neg(x), x)
    t2d = torch.where(neg[None], fe_neg(t2d), t2d)
    return (x, y, z, t2d)


def verify_plain(ay: torch.Tensor, a_sign: torch.Tensor,
                 ry: torch.Tensor, r_sign: torch.Tensor,
                 s_nibs: torch.Tensor, k_nibs: torch.Tensor) -> torch.Tensor:
    """Batched verify core, plain PyTorch. All inputs int32, batch-first
    (host layout): ay, ry: (B, 20) canonical y limbs; a_sign, r_sign:
    (B,); s_nibs, k_nibs: (B, 64) signed radix-16 digits in [−8, 8)
    (least significant first) of S and of k = SHA512(R‖A‖M) mod L.
    Returns (B,) bool on the inputs' device."""
    dev = ay.device
    ay = ay.movedim(-1, 0)
    ry = ry.movedim(-1, 0)
    s_nibs = s_nibs.movedim(-1, 0)
    k_nibs = k_nibs.movedim(-1, 0)
    batch = ay.shape[1:]

    ax, a_ok = fe_decompress(ay, a_sign)
    rx, r_ok = fe_decompress(ry, r_sign)

    # A in extended coords, negated: Q = [S]B + [k](−A)
    neg_ax = fe_neg(ax)
    neg_at = fe_neg(fe_mul(ax, ay))
    a_pt = (neg_ax, ay, fe_one(batch, dev), neg_at)

    # per-item table of v·(−A), v = 0..8, T pre-multiplied by 2d
    entries = [pt_identity(batch, dev), a_pt]
    for v in range(2, 9):
        if v % 2 == 0:
            entries.append(pt_dbl(entries[v // 2]))
        else:
            entries.append(pt_add(entries[v - 1], a_pt))
    d2 = _bcast(_D2_LIMBS, ax)
    a_table = tuple(
        torch.stack([e[c] if c < 3 else fe_mul(e[3], d2) for e in entries],
                    dim=0)
        for c in range(4))                       # 4 × (9, 20, B)

    # variable base: most significant of the 64 signed digits of k first
    def vb_window(q, dig, need_t):
        q = pt_dbl(q, need_t=False)
        q = pt_dbl(q, need_t=False)
        q = pt_dbl(q, need_t=False)
        q = pt_dbl(q, need_t=True)
        return pt_add_folded(q, _select_signed9(a_table, dig),
                             need_t=need_t)

    q = pt_identity(batch, dev)
    for i in range(63):
        q = vb_window(q, k_nibs[63 - i], False)
    # final window: its add produces T, which the fixed-base chain reads
    q = vb_window(q, k_nibs[0], True)

    # fixed base: Σ_j table[j][s_dig_j], 64 Niels additions, no doublings
    ftab = on_device(fixed_table(), dev)           # (64, 9, 3, 20)
    for j in range(64):
        dig = s_nibs[j]
        fneg = (dig < 0)[None]
        sel = ftab[j][dig.abs().long()].permute(1, 2, 0)   # (3, 20, B)
        # Niels negation: swap (y+x, y−x), negate 2dxy
        ypx = torch.where(fneg, sel[1], sel[0])
        ymx = torch.where(fneg, sel[0], sel[1])
        xy2d = torch.where(fneg, fe_neg(sel[2]), sel[2])
        q = pt_add_niels(q, (ypx, ymx, xy2d))

    # projective compare with affine R: X == rx·Z and Y == ry·Z
    xq, yq, zq, _ = q
    eq = fe_eq(xq, fe_mul(rx, zq)) & fe_eq(yq, fe_mul(ry, zq))
    return a_ok & r_ok & eq


# --- the wrapper: CUDA kernel on the card, plain version on the CPU --------

# kernel launches since import (or since a caller reset it); the wrapper
# adds one where it launches the CUDA kernel and nowhere else
LAUNCHES = 0

_LIB_LOCK = threading.Lock()
_LIB = None
_PARAMS: dict = {}     # device -> kernel parameter block on that device
# the verify fleet launches from its dispatch thread and its warmup thread
_LAUNCH_LOCK = threading.Lock()


def _cuda_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from .._build import build_cuda
            lib = ctypes.CDLL(build_cuda()["ed25519_verify"])
            lib.sct_ed25519_verify.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_int, ctypes.c_void_p]
            lib.sct_ed25519_verify.restype = ctypes.c_int
            lib.sct_ed25519_param_words.restype = ctypes.c_int
            lib.sct_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sct_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def load_kernel() -> None:
    """Build and load the kernel's library now, not at the first launch,
    so that a failed build raises at the caller."""
    _cuda_lib()


def _kernel_params_on(device: torch.device) -> torch.Tensor:
    """The parameter block on `device`, copied there once. The copy is
    waited for before the block is handed out: members of a fleet read it
    from streams of their own, and a copy ordered on one member's stream
    is not ordered before another stream's launch."""
    key = str(device)
    with _LIB_LOCK:
        t = _PARAMS.get(key)
        if t is None:
            t = torch.from_numpy(kernel_params(fixed_table())).to(device)
            torch.cuda.current_stream(device).synchronize()
            _PARAMS[key] = t
    return t


def _check_args(args: tuple) -> int:
    ay, a_sign, ry, r_sign, s_nibs, k_nibs = args
    n = ay.shape[0] if ay.dim() == 2 else -1
    want = ((n, NLIMBS), (n,), (n, NLIMBS), (n,), (n, 64), (n, 64))
    for name, a, shape in zip(("ay", "a_sign", "ry", "r_sign", "s_nibs",
                               "k_nibs"), args, want):
        if a.device != ay.device:
            raise ValueError("%s is on %s, ay on %s"
                             % (name, a.device, ay.device))
        if a.dtype != torch.int32:
            raise ValueError("%s must be int32, got %s" % (name, a.dtype))
        if tuple(a.shape) != shape:
            raise ValueError("%s must have shape %r, got %r"
                             % (name, shape, tuple(a.shape)))
        if not a.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    return n


def verify_kernel(ay: torch.Tensor, a_sign: torch.Tensor,
                  ry: torch.Tensor, r_sign: torch.Tensor,
                  s_nibs: torch.Tensor, k_nibs: torch.Tensor) -> torch.Tensor:
    """(B,) bool verify decisions for prepared inputs (the contract of
    `verify_plain`). CUDA tensors launch the Hopper kernel on the current
    stream (no synchronisation); CPU tensors run `verify_plain`."""
    global LAUNCHES
    args = (ay, a_sign, ry, r_sign, s_nibs, k_nibs)
    n = _check_args(args)
    dev = ay.device
    if dev.type == "cpu":
        return verify_plain(*args)
    if dev.type != "cuda":
        raise ValueError("verify_kernel runs on cuda or cpu, not %s" % dev)
    lib = _cuda_lib()
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        params = _kernel_params_on(dev)
        if params.numel() != lib.sct_ed25519_param_words():
            raise RuntimeError("kernel parameter block size mismatch")
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sct_ed25519_verify(
            *(a.data_ptr() for a in args), params.data_ptr(),
            out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError("ed25519 verify kernel launch failed: %s"
                           % lib.sct_cuda_error_string(rc).decode())
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return out


# --- host-side batch preparation (numpy-vectorized) ------------------------

_L_BYTES_BE = np.frombuffer(L.to_bytes(32, "big"), np.uint8)
_P_BYTES_BE = np.frombuffer(P.to_bytes(32, "big"), np.uint8)


def bytes_to_limbs_np(b: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 → (B, 20) int32 13-bit limbs (little-endian value)."""
    x = b.astype(np.int64)
    out = np.zeros((*b.shape[:-1], NLIMBS), np.int64)
    for i in range(NLIMBS):
        bit = LIMB_BITS * i
        k, r = bit >> 3, bit & 7
        v = x[..., k] >> r
        if k + 1 < 32:
            v = v | (x[..., k + 1] << (8 - r))
        if k + 2 < 32:
            v = v | (x[..., k + 2] << (16 - r))
        out[..., i] = v & LIMB_MASK
    return out.astype(np.int32)


def bytes_to_nibs_np(b: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 → (B, 64) int32 radix-16 digits, LSB-first."""
    lo = (b & 15).astype(np.int32)
    hi = (b >> 4).astype(np.int32)
    return np.stack([lo, hi], axis=-1).reshape(*b.shape[:-1], 64)


def signed_recode_nibs_np(nibs: np.ndarray) -> np.ndarray:
    """(…, 64) unsigned radix-16 digits → signed digits in [−8, 8) with
    the same value (carry-propagating recode, vectorized over the batch).
    Values are < 2^253 (S and k are both < L), so digit 63 is ≤ 1 and the
    final carry is always absorbed — asserted, since an overflow here
    would silently verify a wrong equation."""
    d = nibs.astype(np.int32).copy()
    carry = np.zeros(d.shape[:-1], np.int32)
    for i in range(d.shape[-1]):
        v = d[..., i] + carry
        carry = (v >= 8).astype(np.int32)
        d[..., i] = v - (carry << 4)
    assert not carry.any(), "signed recode overflow: input >= 2^253"
    return d


def _lex_lt_be(a: np.ndarray, bound_be: np.ndarray) -> np.ndarray:
    """Vectorized big-endian lexicographic a < bound over (B, 32) uint8."""
    diff = a != bound_be[None, :]
    first = np.argmax(diff, axis=-1)
    rows = np.arange(a.shape[0])
    return np.where(diff.any(axis=-1),
                    a[rows, first] < bound_be[first], False)


def _pack32(items, n: int, width: int) -> np.ndarray:
    """List of bytes → (n, width) uint8, zero-filling wrong-length items
    and normalizing the list length to n (short lists pad with invalid
    zero rows; callers mark those pre_ok=False via the length check)."""
    items = list(items[:n]) + [b""] * (n - len(items))
    blob = b"".join(x if len(x) == width else b"\x00" * width for x in items)
    return np.frombuffer(blob, np.uint8).reshape(n, width)


def pack_batch(pubs: list[bytes], sigs: list[bytes],
               msgs: list[bytes]) -> tuple:
    """(good, pub_arr, sig_arr, msgs): the length mask (a 32-byte key and
    a 64-byte signature), the (n, 32) keys and (n, 64) signatures with
    wrong-length rows zero-filled, and the messages padded to n."""
    n = len(pubs)
    good = np.zeros(n, bool)
    for i in range(min(n, len(sigs), len(msgs))):
        good[i] = len(pubs[i]) == 32 and len(sigs[i]) == 64
    msgs = list(msgs[:n]) + [b""] * (n - len(msgs))
    return good, _pack32(pubs, n, 32), _pack32(sigs, n, 64), msgs


def finish_native(prep: dict, good: np.ndarray) -> dict:
    """The C prep's arrays made the kernel's contract: the length mask
    ANDed into `pre_ok` (the C call sees only zero-filled rows there), and
    its unsigned digits recoded to signed ones."""
    prep["pre_ok"] = prep["pre_ok"] & good
    prep["s_nibs"] = signed_recode_nibs_np(prep["s_nibs"])
    prep["k_nibs"] = signed_recode_nibs_np(prep["k_nibs"])
    return prep


def prepare_batch(pubs: list[bytes], sigs: list[bytes],
                  msgs: list[bytes]) -> dict:
    """Host preprocessing: hashing, canonicality prechecks, bit-slicing.
    Returns the kernel's int32 input arrays + a host-side precheck mask
    `pre_ok`, from one C call (native/prep.c) wherever the host has a C
    compiler, else from `prepare_batch_plain`. Rows that `pre_ok` rejects
    carry no meaning and may differ between the two paths."""
    good, pub_arr, sig_arr, msgs = pack_batch(pubs, sigs, msgs)
    prep = _native.prepare_batch_native(pub_arr, sig_arr, msgs)
    if prep is not None:
        return finish_native(prep, good)
    return _prepare_numpy(good, pub_arr, sig_arr, msgs)


def prepare_batch_plain(pubs: list[bytes], sigs: list[bytes],
                        msgs: list[bytes]) -> dict:
    """`prepare_batch` in numpy, vectorized across the batch except the
    per-item SHA-512 + 512-bit mod L (hashlib and Python ints): the plain
    version the C prep is held against."""
    return _prepare_numpy(*pack_batch(pubs, sigs, msgs))


def _prepare_numpy(good: np.ndarray, pub_arr: np.ndarray,
                   sig_arr: np.ndarray, msgs: list) -> dict:
    n = len(msgs)
    r_arr = sig_arr[:, :32]
    s_arr = sig_arr[:, 32:]

    a_sign = (pub_arr[:, 31] >> 7).astype(np.int32)
    r_sign = (r_arr[:, 31] >> 7).astype(np.int32)
    ay = pub_arr.copy()
    ay[:, 31] &= 0x7F
    ry = r_arr.copy()
    ry[:, 31] &= 0x7F

    # canonicality prechecks, big-endian lexicographic compare
    s_ok = _lex_lt_be(s_arr[:, ::-1], _L_BYTES_BE)
    ay_ok = _lex_lt_be(ay[:, ::-1], _P_BYTES_BE)
    ry_ok = _lex_lt_be(ry[:, ::-1], _P_BYTES_BE)
    pre_ok = good & s_ok & ay_ok & ry_ok

    # k = SHA512(R‖A‖M) mod L — the only per-item loop
    k_bytes = bytearray(32 * n)
    for i in range(n):
        if not pre_ok[i]:
            continue
        h = hashlib.sha512(
            sig_arr[i, :32].tobytes() + pub_arr[i].tobytes() +
            msgs[i]).digest()
        k = int.from_bytes(h, "little") % L
        k_bytes[32 * i:32 * i + 32] = k.to_bytes(32, "little")
    k_arr = np.frombuffer(bytes(k_bytes), np.uint8).reshape(n, 32)

    zero_bad = pre_ok[:, None].astype(np.uint8)
    return {
        "ay": bytes_to_limbs_np(ay * zero_bad), "a_sign": a_sign,
        "ry": bytes_to_limbs_np(ry * zero_bad), "r_sign": r_sign,
        "s_nibs": signed_recode_nibs_np(bytes_to_nibs_np(s_arr * zero_bad)),
        "k_nibs": signed_recode_nibs_np(bytes_to_nibs_np(k_arr)),
        "pre_ok": pre_ok,
    }


ARG_KEYS = ("ay", "a_sign", "ry", "r_sign", "s_nibs", "k_nibs")

