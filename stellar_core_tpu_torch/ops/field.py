"""GF(2^255-19) arithmetic in int32 limbs: the plain PyTorch version.

This is the port of `stellar_core_tpu/ops/field.py`, kept limb for limb:
the same layout (limbs on the leading axis, a field element batch is
(20, ...batch)), the same radix 2^13 in int32, the same parallel carry with
the 608 fold, the same 64p bias for subtraction, the symmetric half-product
squaring, the same fe_pow_p58 chain and the same fe_freeze. Given the same
limbs it returns the same limbs, so tests compare limbs exactly, not just
values mod p.

Products are summed into their 39 columns with one `index_add_` over the
(20, 20) outer product instead of 20 shifted, padded partial products.
Integer addition is exact, so the columns and everything after them are
identical to the reference's.

It is the reference the CUDA kernel (`csrc/ed25519_verify.cu`, which uses
its own radix) is held against, and what the verify wrapper runs on CPU
tensors.

Bound audit (unchanged from the reference; every op keeps limbs <=
LIMB_BOUND and intermediate column sums < 2^31):
  mul columns:  20 * 10100^2            = 2.04e9  < 2^31 (5% margin)
  sq columns:   the same value as the ordered 20x20 sum, so the same
                bound; each doubled term 2*10100^2 = 2.04e8 < 2^31
  fe_sub/neg:   10100 + 16382           = 26482; 1 carry round ->
                8191 + 3 + 3*608        = 10015  <= LIMB_BOUND
  fe_add/x2:    2*10100 = 20200; 1 round -> 8191 + 2 + 2*608 = 9409
  mul/sq tail:  post-round cols <= 2.57e5; fold <= 1.57e8; two carry
                rounds -> <= 10015
"""

from __future__ import annotations

import numpy as np
import torch

NLIMBS = 20
LIMB_BITS = 13
LIMB_MASK = (1 << LIMB_BITS) - 1
FOLD = 19 * 32  # 2^260 ≡ 19·2^5 (mod p)
LIMB_BOUND = 10100  # loose per-limb bound maintained between ops

P = 2**255 - 19

# 64·p as a limb vector: every limb exceeds LIMB_BOUND, so a + _K64P - b is
# non-negative limb-wise whenever b's limbs are within bound.
# 32p = 2^260 - 608 = [8192-608, 8191, ..., 8191]; doubled below.
_K64P_NP = np.array([2 * (8192 - 608)] + [2 * 8191] * 19, np.int32)

# column index i+j of every (i, j) product, row-major over the outer
# product; and the symmetric half: the diagonal (col 2i), then i < j
_MUL_COLS = np.add.outer(np.arange(NLIMBS),
                         np.arange(NLIMBS)).reshape(-1).astype(np.int64)
_SQ_I, _SQ_J = (x.astype(np.int64) for x in np.triu_indices(NLIMBS, k=1))
_SQ_COLS = np.concatenate([2 * np.arange(NLIMBS), _SQ_I + _SQ_J])


def limbs_from_int(x: int) -> np.ndarray:
    out = np.zeros(NLIMBS, np.int32)
    for i in range(NLIMBS):
        out[i] = (x >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def int_from_limbs(a) -> int:
    a = np.asarray(a)
    return sum(int(a[i, ...]) << (LIMB_BITS * i) for i in range(NLIMBS))


_ON_DEVICE: dict = {}


def on_device(arr: np.ndarray, device) -> torch.Tensor:
    """A module-level constant array as a tensor on `device`, copied once
    per device (keyed by the array's identity, so only for arrays that
    live as long as the module)."""
    key = (id(arr), str(device))
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = torch.as_tensor(arr, device=device)
    return t


def _bcast(v: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Static (20,) int32 limb vector broadcast against (20, ...batch)."""
    return on_device(v, like.device).reshape(
        (NLIMBS,) + (1,) * (like.dim() - 1))


def _carry_round_20(c: torch.Tensor) -> torch.Tensor:
    """One parallel carry round over 20 limbs with top fold (2^260 wrap)."""
    lo = c & LIMB_MASK
    hi = c >> LIMB_BITS
    wrapped = torch.cat([hi[19:20] * FOLD, hi[:19]], dim=0)
    return lo + wrapped


def fe_carry(c: torch.Tensor, rounds: int = 2) -> torch.Tensor:
    for _ in range(rounds):
        c = _carry_round_20(c)
    return c


def fe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_carry(a + b, rounds=1)


def fe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_carry(a + _bcast(_K64P_NP, a) - b, rounds=1)


def fe_neg(a: torch.Tensor) -> torch.Tensor:
    return fe_carry(_bcast(_K64P_NP, a) - a, rounds=1)


def fe_mul_small(a: torch.Tensor, c: int) -> torch.Tensor:
    """Multiply by a small constant (c·LIMB_BOUND must stay < 2^31);
    c <= 2 for the 1-round carry bound to hold."""
    if c > 2:
        raise ValueError("fe_mul_small: c must be <= 2, got %d" % c)
    return fe_carry(a * c, rounds=1)


def _columns(terms: torch.Tensor, cols: np.ndarray) -> torch.Tensor:
    """Sum (k, ...batch) product terms into (39, ...batch) columns."""
    out = torch.zeros((2 * NLIMBS - 1,) + tuple(terms.shape[1:]),
                      dtype=terms.dtype, device=terms.device)
    return out.index_add_(0, on_device(cols, terms.device), terms)


def _columns_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product columns c[k] = Σ_{i+j=k} a_i·b_j as (39, ...). All terms
    < 2^31 (bound audit)."""
    a, b = torch.broadcast_tensors(a, b)
    outer = a[:, None] * b[None, :]                  # (20, 20, ...)
    return _columns(outer.reshape((NLIMBS * NLIMBS,) + a.shape[1:]),
                    _MUL_COLS)


def _columns_sq(a: torch.Tensor) -> torch.Tensor:
    """Squaring columns via symmetry: diagonal a_i² at column 2i plus
    doubled upper-triangle products — 210 products instead of 400."""
    i = on_device(_SQ_I, a.device)
    j = on_device(_SQ_J, a.device)
    terms = torch.cat([a * a, (a[i] * 2) * a[j]], dim=0)
    return _columns(terms, _SQ_COLS)


def _reduce39(c: torch.Tensor) -> torch.Tensor:
    """Columns (39, ...) → field element: one widening carry round, fold
    the high 20 columns (2^(260+13j) ≡ 608·2^13j mod p), then two parallel
    carry rounds (reference `_reduce39`)."""
    lo = c & LIMB_MASK
    hi = c >> LIMB_BITS
    z1 = torch.zeros_like(c[:1])
    c = torch.cat([lo, z1], dim=0) + torch.cat([z1, hi], dim=0)
    low = c[:NLIMBS] + FOLD * c[NLIMBS:]
    return fe_carry(low, rounds=2)


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce39(_columns_mul(a, b))


def fe_sq(a: torch.Tensor) -> torch.Tensor:
    return _reduce39(_columns_sq(a))


def fe_one(batch_shape=(), device=None) -> torch.Tensor:
    one = torch.zeros((NLIMBS,) + tuple(batch_shape), dtype=torch.int32,
                      device=device)
    one[0] = 1
    return one


def fe_zero(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((NLIMBS,) + tuple(batch_shape), dtype=torch.int32,
                       device=device)


def _sqn(x: torch.Tensor, n: int) -> torch.Tensor:
    """x^(2^n) by n squarings."""
    for _ in range(n):
        x = fe_sq(x)
    return x


def fe_pow_p58(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252 - 3) via the curve25519 addition chain
    (ref10 pow22523 structure): 251 squarings + 11 multiplies."""
    z2 = fe_sq(x)                      # 2
    z8 = _sqn(z2, 2)                   # 8
    z9 = fe_mul(x, z8)                 # 9
    z11 = fe_mul(z2, z9)               # 11
    z22 = fe_sq(z11)                   # 22
    z_5_0 = fe_mul(z9, z22)            # 2^5 - 1
    z_10_0 = fe_mul(_sqn(z_5_0, 5), z_5_0)      # 2^10 - 1
    z_20_0 = fe_mul(_sqn(z_10_0, 10), z_10_0)   # 2^20 - 1
    z_40_0 = fe_mul(_sqn(z_20_0, 20), z_20_0)   # 2^40 - 1
    z_50_0 = fe_mul(_sqn(z_40_0, 10), z_10_0)   # 2^50 - 1
    z_100_0 = fe_mul(_sqn(z_50_0, 50), z_50_0)  # 2^100 - 1
    z_200_0 = fe_mul(_sqn(z_100_0, 100), z_100_0)  # 2^200 - 1
    z_250_0 = fe_mul(_sqn(z_200_0, 50), z_50_0)    # 2^250 - 1
    return fe_mul(_sqn(z_250_0, 2), x)  # 2^252 - 3


def _seq_carry(v: torch.Tensor):
    """Exact sequential carry over the 20 limbs: (limbs, carry out)."""
    limbs = []
    carry = torch.zeros_like(v[0])
    for i in range(NLIMBS):
        t = v[i] + carry
        limbs.append(t & LIMB_MASK)
        carry = t >> LIMB_BITS
    return torch.stack(limbs, dim=0), carry


def fe_freeze(a: torch.Tensor) -> torch.Tensor:
    """Full canonical reduction to the unique representative in [0, p),
    with exact 13-bit limbs (reference `fe_freeze`, step for step)."""
    # 1) exact sequential carry over 20 limbs, folding the top twice
    v, c = _seq_carry(a)
    v[0] += c * FOLD
    v, c = _seq_carry(v)  # c == 0 now; value < 2^260
    # 2) fold bits 255..259: hi = limb19 >> 8, v mod 2^255 + 19*hi
    for _ in range(2):
        hi = v[19] >> 8
        v[19] &= 0xFF
        v[0] += 19 * hi
        v, _ = _seq_carry(v)
    # 3) value < 2^255 + eps; conditional subtract p via the +19 trick:
    #    v >= p  <=>  v + 19 >= 2^255
    t = v.clone()
    t[0] += 19
    t, _ = _seq_carry(t)
    ge = (t[19] >> 8) > 0
    t[19] &= 0xFF
    return torch.where(ge[None], t, v)


def fe_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Equality over the canonical forms: (...,) bool."""
    return torch.all(fe_freeze(a) == fe_freeze(b), dim=0)


def fe_is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(fe_freeze(a) == 0, dim=0)


def fe_parity(a: torch.Tensor) -> torch.Tensor:
    """Low bit of the canonical representative."""
    return fe_freeze(a)[0] & 1
