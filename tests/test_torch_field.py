"""The port's plain field arithmetic against the JAX package's, limb for limb.

`stellar_core_tpu_torch/ops/field.py` keeps the reference's 20×13-bit int32
limb layout and algorithms, so every op must return exactly the limbs that
`stellar_core_tpu/ops/field.py` returns (jnp, eager on the CPU) on the same
numpy-seeded inputs, and values that equal the Python-int result mod p.
Inputs: random limbs within LIMB_BOUND, limbs at LIMB_BOUND, and values
>= p (up to 2^260) before fe_freeze. Tolerance: none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stellar_core_tpu.ops import field as JF
from stellar_core_tpu_torch.ops import field as TF

P = TF.P
B = 24


def _inputs(seed: int) -> np.ndarray:
    """(20, B) int32: random limbs, all-LIMB_BOUND lanes, and lanes whose
    value is at or just above p, or near 2^260."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, TF.LIMB_BOUND + 1, (TF.NLIMBS, B)).astype(np.int32)
    a[:, 0] = TF.LIMB_BOUND
    a[:, 1] = rng.integers(TF.LIMB_BOUND - 50, TF.LIMB_BOUND + 1, TF.NLIMBS)
    for lane, v in zip(range(2, 8), (P, P + 1, P + 18, 2 * P - 1,
                                     2**255 - 1, 2**260 - 1)):
        a[:, lane] = TF.limbs_from_int(v)
    a[:, 8] = 0
    return a


def _value(limbs: np.ndarray, lane: int) -> int:
    return TF.int_from_limbs(np.asarray(limbs)[:, lane])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version issues many tiny ops; one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


A = _inputs(1)
BB = _inputs(2)

# name -> (port fn, JAX fn, Python-int result of the lane values or None)
BINARY = {
    "fe_add": (TF.fe_add, JF.fe_add, lambda x, y: x + y),
    "fe_sub": (TF.fe_sub, JF.fe_sub, lambda x, y: x - y),
    "fe_mul": (TF.fe_mul, JF.fe_mul, lambda x, y: x * y),
}
UNARY = {
    "fe_neg": (TF.fe_neg, JF.fe_neg, lambda x: -x),
    "fe_sq": (TF.fe_sq, JF.fe_sq, lambda x: x * x),
    "fe_mul_small": (lambda a: TF.fe_mul_small(a, 2),
                     lambda a: JF.fe_mul_small(a, 2), lambda x: 2 * x),
    "fe_carry": (TF.fe_carry, JF.fe_carry, lambda x: x),
    "fe_pow_p58": (TF.fe_pow_p58, JF.fe_pow_p58,
                   lambda x: pow(x, (P - 5) // 8, P)),
}


def _check_values(out: np.ndarray, expect) -> None:
    for lane in range(B):
        assert _value(out, lane) % P == expect(lane) % P, lane


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op_matches_jax(name):
    port, ref, py = BINARY[name]
    out = port(torch.from_numpy(A), torch.from_numpy(BB)).numpy()
    want = np.asarray(ref(jnp.asarray(A), jnp.asarray(BB)))
    np.testing.assert_array_equal(out, want)
    assert out.dtype == np.int32
    assert np.abs(out).max() <= TF.LIMB_BOUND
    _check_values(out, lambda lane: py(_value(A, lane), _value(BB, lane)))


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_op_matches_jax(name):
    port, ref, py = UNARY[name]
    out = port(torch.from_numpy(A)).numpy()
    want = np.asarray(ref(jnp.asarray(A)))
    np.testing.assert_array_equal(out, want)
    _check_values(out, lambda lane: py(_value(A, lane)))


def test_mul_broadcasts_a_constant_like_jax():
    d = TF.limbs_from_int(37 * 2**200 + 5)[:, None]
    out = TF.fe_mul(torch.from_numpy(A), torch.from_numpy(d)).numpy()
    want = np.asarray(JF.fe_mul(jnp.asarray(A), jnp.asarray(d)))
    np.testing.assert_array_equal(out, want)


def test_freeze_is_canonical_and_matches_jax():
    out = TF.fe_freeze(torch.from_numpy(A)).numpy()
    want = np.asarray(JF.fe_freeze(jnp.asarray(A)))
    np.testing.assert_array_equal(out, want)
    assert ((out >= 0) & (out <= TF.LIMB_MASK)).all()
    for lane in range(B):
        assert _value(out, lane) == _value(A, lane) % P, lane


def test_predicates_match_jax():
    # pairs with equal values in different limbs (x and x + p), unequal
    # pairs, zero in several representations
    rng = np.random.default_rng(3)
    xs = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(B)]
    a = np.stack([TF.limbs_from_int(x) for x in xs], axis=1)
    b = np.stack([TF.limbs_from_int(x + P if i % 3 else x + i)
                  for i, x in enumerate(xs)], axis=1)
    zero = np.stack([TF.limbs_from_int(v) for v in
                     ([0, P, 2 * P] * B)[:B]], axis=1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    eq = TF.fe_eq(ta, tb).numpy()
    np.testing.assert_array_equal(eq, np.asarray(JF.fe_eq(ja, jb)))
    assert eq.tolist() == [bool(i % 3) or i == 0 for i in range(B)]
    for x in (a, zero, A):
        np.testing.assert_array_equal(
            TF.fe_is_zero(torch.from_numpy(x)).numpy(),
            np.asarray(JF.fe_is_zero(jnp.asarray(x))))
        np.testing.assert_array_equal(
            TF.fe_parity(torch.from_numpy(x)).numpy(),
            np.asarray(JF.fe_parity(jnp.asarray(x))))
    assert TF.fe_is_zero(torch.from_numpy(zero)).all()
    assert TF.fe_parity(ta).tolist() == [x & 1 for x in xs]


def test_limb_conversions_match_jax():
    for x in (0, 1, P - 1, 2**255 - 1, 2**260 - 1):
        np.testing.assert_array_equal(TF.limbs_from_int(x),
                                      JF.limbs_from_int(x))
        assert TF.int_from_limbs(TF.limbs_from_int(x)) == x


def test_mul_small_rejects_large_constant():
    with pytest.raises(ValueError):
        TF.fe_mul_small(torch.from_numpy(A), 3)
