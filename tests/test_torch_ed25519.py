"""The port's verify path against the JAX package's, on the same inputs.

- `prepare_batch`: the port's numpy arrays (`prepare_batch_plain`) equal
  the JAX package's numpy path (SCT_NATIVE_PREP=0) in every row, and the
  port's `prepare_batch` (its C prep) equals the JAX package's native C
  prep (SCT_NATIVE_PREP=1) in every row that reaches a decision.
- The fixed-base table: `fixed_table_from_jax(jax fixed_table())` equals
  the port's own table, in both the reference radix and the kernel's.
- `verify_plain` equals JAX `verify_batch_jit` bit for bit on every
  adversarial vector plus a seeded corpus (every 7th signature corrupted)
  at B = 128, the live-SCP bucket (the shape the JAX adversarial test
  already compiles). One module-scoped JAX call.
- The CUDA kernel's source, compiled as host C++, equals `verify_plain` on
  the same batch: there a lockstep loop runs each signature's four lanes
  in turn through the kernel's own rounds, exchanging through an array
  where the card shuffles.
- The wrapper runs the plain version on CPU tensors, counts no launch
  there, and rejects arguments outside its contract.
Tolerance: none.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stellar_core_tpu.ops import ed25519 as JE
from stellar_core_tpu_torch import _build
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.graft_entry import entry
from stellar_core_tpu_torch.models.verifier_model import (
    fixed_table_from_jax,
)
from stellar_core_tpu_torch.ops import ed25519 as TE
from stellar_core_tpu_torch.ops.field import int_from_limbs
from stellar_core_tpu_torch.testing.vectors import _vectors

import torch_threads  # noqa: F401  (one intra-op thread a worker)

BUCKET = 128
VECTORS = _vectors()



def _corpus(n: int, seed: int = 7):
    """n seeded triples over 8 keys, 32 B / ~200 B messages, every 7th
    signature with one bit flipped."""
    rng = np.random.default_rng(seed)
    keys = [SecretKey(rng.bytes(32)) for _ in range(8)]
    out = []
    for i in range(n):
        msg = rng.bytes(32 if i % 2 else int(rng.integers(150, 251)))
        sk = keys[i % len(keys)]
        sig = bytearray(sk.sign(msg))
        if i % 7 == 6:
            bit = int(rng.integers(0, 512))
            sig[bit // 8] ^= 1 << (bit % 8)
        out.append((sk.public_key.key_bytes, bytes(sig), msg))
    return out


def _args(prep: dict) -> tuple:
    return tuple(torch.from_numpy(prep[k]) for k in TE.ARG_KEYS)


@pytest.fixture(scope="module")
def batch():
    triples = [(p, s, m) for (_l, p, s, m) in VECTORS] + \
        _corpus(BUCKET - len(VECTORS))
    prep = TE.prepare_batch(*map(list, zip(*triples)))
    jax_ok = np.asarray(JE.verify_batch_jit(
        *(jnp.asarray(prep[k]) for k in TE.ARG_KEYS)))
    plain_ok = TE.verify_plain(*_args(prep)).numpy()
    return triples, prep, jax_ok, plain_ok


def test_vectors_are_the_reference_vectors():
    import test_ed25519_adversarial as ref
    assert len(VECTORS) >= 50
    assert VECTORS == ref.VECTORS


@pytest.mark.parametrize("native", ["1", "0"])
def test_prepare_batch_matches_jax(monkeypatch, native):
    monkeypatch.setenv("SCT_NATIVE_PREP", native)
    triples = [(p, s, m) for (_l, p, s, m) in VECTORS] + _corpus(40, 9)
    pubs, sigs, msgs = map(list, zip(*triples))
    # malformed lengths and a short message list
    pubs[3] = pubs[3][:31]
    sigs[5] = sigs[5] + b"\x00"
    msgs = msgs[:-2]
    prep = TE.prepare_batch if native == "1" else TE.prepare_batch_plain
    got = prep(pubs, sigs, msgs)
    want = JE.prepare_batch(pubs, sigs, msgs)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["pre_ok"], want["pre_ok"])
    assert not got["pre_ok"][[3, 5, len(pubs) - 1]].any()
    # the native preps leave rows that only the Python length checks
    # reject unzeroed (their decisions are masked by pre_ok), so there
    # the rows that reach a decision must match; between the numpy paths
    # every row must
    rows = got["pre_ok"] if native == "1" else slice(None)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k][rows], want[k][rows],
                                      err_msg=k)


def test_fixed_table_from_jax_equals_port_table():
    table, params = fixed_table_from_jax(JE.fixed_table())
    own = TE.fixed_table()
    assert table.dtype == torch.int32 and tuple(table.shape) == own.shape
    assert torch.equal(table, torch.from_numpy(own))
    assert torch.equal(params, torch.from_numpy(TE.kernel_params(own)))
    # the kernel radix holds the same values: spot-check entries and the
    # curve constants at the end of the block
    k = params.numpy()[:64 * 9 * 3 * 10].reshape(64, 9, 3, 10)

    def v10(limbs):
        return sum(int(x) << o for x, o in zip(limbs, TE.RADIX_OFFSETS))

    for j, v, c in [(0, 0, 0), (0, 1, 2), (17, 5, 1), (63, 8, 2)]:
        assert v10(k[j, v, c]) == int_from_limbs(own[j, v, c])
    tail = params.numpy()[64 * 9 * 3 * 10:].reshape(3, 10)
    assert [v10(t) for t in tail] == [TE.D, TE.D2, TE.SQRT_M1]


def test_verify_plain_matches_jax_bit_for_bit(batch):
    triples, prep, jax_ok, plain_ok = batch
    assert plain_ok.dtype == np.bool_ and plain_ok.shape == (BUCKET,)
    np.testing.assert_array_equal(plain_ok, jax_ok)
    decisions = (plain_ok & prep["pre_ok"]).tolist()
    oracle = [TE.verify_oracle(*t) for t in triples]
    assert decisions == oracle == [JE.verify_oracle(*t) for t in triples]
    corpus_expect = [i % 7 != 6 for i in range(BUCKET - len(VECTORS))]
    assert decisions[len(VECTORS):] == corpus_expect
    assert any(decisions[1:len(VECTORS)]), "no hostile vector accepted"


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/ed25519_verify.cu compiled as host C++: its host lockstep
    driver (`verify_one`: the quad's four lanes in turn within each round,
    the table in a local array) run over a batch on the CPU."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernel source for the "
                    "host")
    d = tmp_path_factory.mktemp("host_kernel")
    src = d / "host_verify.cpp"
    src.write_text(
        '#include "ed25519_verify.cu"\n'
        'extern "C" void host_verify(const int32_t *ay, const int32_t *as,'
        ' const int32_t *ry, const int32_t *rs, const int32_t *s,'
        ' const int32_t *k, const int32_t *params, uint8_t *out, int n) {\n'
        '  for (int b = 0; b < n; b++)\n'
        '    out[b] = verify_one(ay + 20 * b, as[b], ry + 20 * b, rs[b],'
        ' s + 64 * b, k + 64 * b, params);\n}\n')
    so = d / "libhost_verify.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-I", _build.CSRC_DIR,
                    "-o", str(so), str(src)], check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.host_verify.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int]
    return lib


def test_kernel_source_on_host_matches_plain(batch, host_kernel):
    _triples, prep, _jax_ok, plain_ok = batch
    args = [np.ascontiguousarray(prep[k]) for k in TE.ARG_KEYS]
    params = TE.kernel_params(TE.fixed_table())
    out = np.zeros(BUCKET, np.uint8)
    host_kernel.host_verify(*(a.ctypes.data for a in args),
                            params.ctypes.data, out.ctypes.data, BUCKET)
    np.testing.assert_array_equal(out.astype(bool), plain_ok)


def test_wrapper_runs_plain_on_cpu_without_counting(batch):
    _triples, prep, _jax_ok, plain_ok = batch
    before = TE.LAUNCHES
    sub = {k: np.ascontiguousarray(prep[k][64:80]) for k in TE.ARG_KEYS}
    got = TE.verify_kernel(*_args(sub))
    np.testing.assert_array_equal(got.numpy(), plain_ok[64:80])
    assert TE.LAUNCHES == before


def test_wrapper_rejects_arguments_outside_the_contract():
    z = {"ay": np.zeros((4, 20), np.int32), "a_sign": np.zeros(4, np.int32),
         "ry": np.zeros((4, 20), np.int32), "r_sign": np.zeros(4, np.int32),
         "s_nibs": np.zeros((4, 64), np.int32),
         "k_nibs": np.zeros((4, 64), np.int32)}
    good = _args(z)
    bad_dtype = (good[0].long(),) + good[1:]
    bad_shape = good[:4] + (good[4][:, :32].contiguous(),) + good[5:]
    strided = torch.zeros((20, 4), dtype=torch.int32).t()
    bad_layout = (strided,) + good[1:]
    meta = tuple(a.to("meta") for a in good)
    for args in (bad_dtype, bad_shape, bad_layout, meta):
        with pytest.raises(ValueError):
            TE.verify_kernel(*args)


def test_entry_matches_reference_entry():
    import __graft_entry__ as ref
    fwd, args = entry()
    _ref_fwd, ref_args = ref.entry()
    assert not torch.cuda.is_initialized()
    for a, r in zip(args, ref_args):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    assert fwd.keywords == {"device": None}   # the card, by default
    fwd_cpu, _ = entry(device="cpu")
    assert fwd_cpu(*args).all()


def test_entry_forward_without_a_card_raises(monkeypatch):
    """The entry's forward runs on the card unless the caller asks for the
    CPU: with no card it raises instead of computing on the CPU."""
    fwd, args = entry()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fwd(*args)
