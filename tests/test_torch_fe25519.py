"""The CUDA kernel's field arithmetic (`csrc/fe25519.cuh`), compiled as
host C++, against Python big-int arithmetic mod p.

The header's bound audit promises: `fe_mul` takes a first factor with
limbs of magnitude up to M = 4T = 2^27 and a second up to 3T, `fe_sq` a
factor up to 3T (T = 2^25), and both return tight limbs (even <= 2^25,
odd <= 2^24 + 2^16) of the product mod p; the carry keeps the value and
makes any int32 limbs tight; `fe_freeze` returns the canonical
representative. The inputs sit at the audit's extremes (every limb at the
bound, both signs and mixed, canonical values < 2^255 with limbs up to
2T = 2^26 and their negations) and at seeded random points in between
(numpy). Tolerance: none.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from stellar_core_tpu_torch import _build
from stellar_core_tpu_torch.ops.ed25519 import RADIX_OFFSETS, radix25_from_int
from stellar_core_tpu_torch.ops.field import P

T = 1 << 25                 # tight
M = 4 * T                   # fe_mul's first factor
G = 3 * T                   # fe_mul's second factor, fe_sq's factor
TIGHT = np.array([T if k % 2 == 0 else (1 << 24) + (1 << 16)
                  for k in range(10)])


@pytest.fixture(scope="module")
def fe_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the field header for the host")
    d = tmp_path_factory.mktemp("host_fe")
    src = d / "host_fe.cpp"
    src.write_text(
        '#include "fe25519.cuh"\n'
        '#define SCT_EACH(name, body) extern "C" void name(const int32_t *f,'
        ' const int32_t *g, int32_t *h, int n) {\\\n'
        '  for (int b = 0; b < n; b++) { fe x, y, z;\\\n'
        '    fe_load(x, f + 10 * b); fe_load(y, g + 10 * b); body;\\\n'
        '    for (int i = 0; i < 10; i++) h[10 * b + i] = z.v[i]; } }\n'
        'SCT_EACH(host_fe_mul, fe_mul(z, x, y))\n'
        'SCT_EACH(host_fe_sq, (void)y; fe_sq(z, x))\n'
        'SCT_EACH(host_fe_carry, (void)y; fe_carry(z, x))\n'
        'SCT_EACH(host_fe_freeze, (void)y; fe_freeze(z, x))\n')
    so = d / "libhost_fe.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-I", _build.CSRC_DIR,
                    "-o", str(so), str(src)], check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for fn in (lib.host_fe_mul, lib.host_fe_sq, lib.host_fe_carry,
               lib.host_fe_freeze):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return lib


def _run(fn, f: np.ndarray, g: np.ndarray) -> np.ndarray:
    f = np.ascontiguousarray(f, np.int32)
    g = np.ascontiguousarray(g, np.int32)
    h = np.zeros_like(f)
    fn(f.ctypes.data, g.ctypes.data, h.ctypes.data, f.shape[0])
    return h


def _value(limbs) -> int:
    return sum(int(v) << o for v, o in zip(limbs, RADIX_OFFSETS))


def _extremes(rng: np.random.Generator, n: int, bound: int) -> np.ndarray:
    """(n + 6, 10) limbs: all +bound, all -bound, alternating signs, both
    canonical extremes, then n rows of these kinds in turn: limbs +-bound
    with random signs, uniform in [-bound, bound], canonical values,
    negated ones."""
    rows = [np.full(10, bound), np.full(10, -bound),
            np.array([bound, -bound] * 5), np.array([-bound, bound] * 5),
            radix25_from_int(P - 1), -radix25_from_int((1 << 255) - 1)]
    for i in range(n):
        kind = i % 4
        if kind == 0:
            rows.append(bound * rng.choice([-1, 1], 10))
        elif kind == 1:
            rows.append(rng.integers(-bound, bound + 1, 10))
        else:
            x = int.from_bytes(rng.bytes(32), "little") >> 1
            rows.append(radix25_from_int(x) * (1 if kind == 2 else -1))
    return np.array(rows, np.int64)


@pytest.mark.parametrize("op", ["mul", "sq"])
def test_mul_and_sq_at_the_audit_extremes(fe_lib, op):
    rng = np.random.default_rng(25519 + (op == "sq"))
    if op == "mul":
        f = _extremes(rng, 400, M)
        g = _extremes(rng, 400, G)[rng.permutation(f.shape[0])]
    else:
        f = g = _extremes(rng, 400, G)
    h = (_run(fe_lib.host_fe_mul, f, g) if op == "mul"
         else _run(fe_lib.host_fe_sq, f, f))
    assert (np.abs(h) <= TIGHT).all(), "product limbs not tight"
    for a, b, c in zip(f, g, h):
        assert _value(c) % P == _value(a) * _value(b) % P


def test_carry_keeps_the_value_and_makes_limbs_tight(fe_lib):
    rng = np.random.default_rng(7)
    big = (1 << 31) - 1
    f = np.concatenate([
        np.array([np.full(10, big), np.full(10, -big),
                  np.array([big, -big] * 5)]),
        rng.integers(-big, big + 1, (300, 10)),
        _extremes(rng, 100, M)])
    h = _run(fe_lib.host_fe_carry, f, f)
    assert (np.abs(h) <= TIGHT).all()
    for a, c in zip(f, h):
        assert _value(c) % P == _value(a) % P


def test_freeze_is_canonical(fe_lib):
    rng = np.random.default_rng(8)
    f = np.concatenate([
        _extremes(rng, 200, M),
        [radix25_from_int(x) for x in (0, 1, P - 1, P, P + 1, 2 * P - 1,
                                       (1 << 255) - 1, 19, P - 19)]])
    h = _run(fe_lib.host_fe_freeze, f, f)
    for a, c in zip(f, h):
        want = _value(a) % P
        assert _value(c) == want and (c >= 0).all()
        assert (c == radix25_from_int(want)).all()
