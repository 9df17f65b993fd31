"""The port's batched SHA-256 against the JAX package's, on the same inputs.

- The FIPS constants, `blocks_for_len`, `pad_messages_np` and
  `digests_to_bytes` equal the reference's on every padding boundary.
- `hash_blocks_plain` equals JAX `hash_blocks_jit` word for word at
  (1, 1), (7, 2) and (256, 16) lanes x blocks: real padded messages plus
  lanes of random words with ragged counts, zero-count padding lanes, a
  count past max_blocks and a negative count. The JAX side stays at
  <= 256 lanes and compiles each of those three shapes once.
- The CUDA kernel's source, compiled as host C++, runs the schedule and
  round functions that the card's two warps call. Run in turn per lane
  (`sha256_lane`), and run a warp pair at a time through the card's
  staging offsets and two-slot ring (`sha256_pair`: block i + 1's
  schedule written before block i's rounds read theirs, rows past a
  lane's count poisoned), both equal `hash_blocks_plain` and
  `hash_blocks_jit` at the three shapes; the pair loop also at 33 x 20
  (a partial pair, lanes longer than the hasher's 16-block bucket).
- The wrapper runs the plain version on CPU tensors, counts no launch
  there, and rejects arguments outside its contract.
Tolerance: none (a digest one bit off forks consensus).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stellar_core_tpu.ops import sha256 as JS
from stellar_core_tpu_torch import _build
from stellar_core_tpu_torch.ops import sha256 as TS

# every FIPS padding boundary (tests/test_batch_hasher.py:29-53) plus the
# largest message of the largest block bucket
BOUNDARY_LENS = (0, 1, 3, 54, 55, 56, 63, 64, 118, 119, 120, 128, 250,
                 500, 1015)
SHAPES = ((1, 1), (7, 2), (256, 16))


def _msgs(rng, lens):
    return [rng.bytes(int(n)) for n in lens]


def _batch(lanes: int, blocks: int, seed: int):
    """(words uint32, counts int32) at one shape: real messages that fit,
    then lanes of random words with counts in [-1, blocks + 3], then
    zero-count padding lanes."""
    rng = np.random.default_rng(seed)
    fits = [n for n in BOUNDARY_LENS if TS.blocks_for_len(n) <= blocks]
    n_real = max(1, min(len(fits) + lanes // 4, lanes // 2))
    lens = (fits + [int(x) for x in rng.integers(
        0, 64 * blocks - 8, max(n_real - len(fits), 0))])[:n_real]
    words = np.zeros((lanes, blocks, 16), np.uint32)
    counts = np.zeros((lanes,), np.int32)
    words[:n_real], counts[:n_real] = TS.pad_messages_np(_msgs(rng, lens),
                                                         blocks)
    n_rand = (lanes - n_real) // 2
    sl = slice(n_real, n_real + n_rand)
    words[sl] = rng.integers(0, 1 << 32, (n_rand, blocks, 16),
                             dtype=np.uint64).astype(np.uint32)
    counts[sl] = rng.integers(-1, blocks + 4, n_rand)
    return words, counts


def _plain(words, counts):
    return TS.hash_blocks_plain(torch.from_numpy(words.view(np.int32)),
                                torch.from_numpy(counts)) \
        .numpy().view(np.uint32)


def test_round_constants_and_initial_state_equal_the_reference():
    np.testing.assert_array_equal(TS._K, JS._K)
    np.testing.assert_array_equal(TS._H0, JS._H0)
    assert TS._K.dtype == JS._K.dtype and TS._H0.dtype == JS._H0.dtype


@pytest.mark.parametrize("n", BOUNDARY_LENS + (1016, 2048))
def test_blocks_for_len_equals_the_reference(n):
    assert TS.blocks_for_len(n) == JS.blocks_for_len(n)


@pytest.mark.parametrize("max_blocks", [0, 16, 40])
def test_pad_messages_np_equals_the_reference(max_blocks):
    msgs = _msgs(np.random.default_rng(1), BOUNDARY_LENS + (1016, 2048))
    if max_blocks:
        msgs = [m for m in msgs if TS.blocks_for_len(len(m)) <= max_blocks]
    words, counts = TS.pad_messages_np(msgs, max_blocks)
    jwords, jcounts = JS.pad_messages_np(msgs, max_blocks)
    assert words.dtype == jwords.dtype and counts.dtype == jcounts.dtype
    np.testing.assert_array_equal(words, jwords)
    np.testing.assert_array_equal(counts, jcounts)


def test_digests_to_bytes_equals_the_reference():
    dig = np.random.default_rng(2).integers(
        0, 1 << 32, (9, 8), dtype=np.uint64).astype(np.uint32)
    assert TS.digests_to_bytes(dig) == JS.digests_to_bytes(dig)


def test_sha256_batch_device_on_cpu_equals_hashlib():
    msgs = _msgs(np.random.default_rng(3), BOUNDARY_LENS)
    assert TS.sha256_batch_device(msgs, device="cpu") == \
        TS.sha256_batch_host(msgs) == JS.sha256_batch_host(msgs)
    assert TS.sha256_batch_device(msgs, max_blocks=16, device="cpu") == \
        TS.sha256_batch_host(msgs)
    assert TS.sha256_batch_device([], device="cpu") == []


@pytest.fixture(scope="module")
def batches():
    """Each shape's arrays, the JAX kernel's digests and the plain
    version's, computed once."""
    out = {}
    for i, (lanes, blocks) in enumerate(SHAPES):
        words, counts = _batch(lanes, blocks, seed=10 + i)
        jax_out = np.asarray(JS.hash_blocks_jit(jnp.asarray(words),
                                                jnp.asarray(counts)))
        out[(lanes, blocks)] = (words, counts, jax_out, _plain(words, counts))
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
def test_plain_equals_hash_blocks_jit(batches, shape):
    words, counts, jax_out, plain = batches[shape]
    assert jax_out.dtype == np.uint32 and plain.shape == (shape[0], 8)
    np.testing.assert_array_equal(plain, jax_out)
    # padding lanes and non-positive counts keep the initial state
    idle = counts <= 0
    assert idle.any() or shape[0] == 1
    np.testing.assert_array_equal(plain[idle],
                                  np.broadcast_to(TS._H0, (idle.sum(), 8)))


def test_plain_digests_equal_hashlib():
    rng = np.random.default_rng(4)
    msgs = _msgs(rng, BOUNDARY_LENS)
    words, counts = TS.pad_messages_np(msgs, 16)
    assert TS.digests_to_bytes(_plain(words, counts)) == \
        TS.sha256_batch_host(msgs)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/sha256.cu compiled as host C++, with its two host loops over
    a batch: `host_sha256` (`sha256_lane` per lane) and `host_sha256_pairs`
    (`sha256_pair` per 32 lanes)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernel source for the "
                    "host")
    d = tmp_path_factory.mktemp("host_sha256")
    src = d / "host_sha256.cpp"
    src.write_text(
        '#include "sha256.cu"\n'
        'extern "C" void host_sha256(const uint32_t *words,'
        ' const int32_t *n_blocks, uint32_t *out, int batch,'
        ' int max_blocks) {\n'
        '  for (int b = 0; b < batch; b++)\n'
        '    sha256_lane(words + (size_t)b * max_blocks * 16, n_blocks[b],'
        ' max_blocks, out + 8 * (size_t)b);\n}\n'
        'extern "C" void host_sha256_pairs(const uint32_t *words,'
        ' const int32_t *n_blocks, uint32_t *out, int batch,'
        ' int max_blocks) {\n'
        '  for (int b = 0; b < batch; b += SHA_WARP)\n'
        '    sha256_pair(words, n_blocks, out, batch, max_blocks, b);\n}\n')
    so = d / "libhost_sha256.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-I", _build.CSRC_DIR,
                    "-o", str(so), str(src)], check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for fn in (lib.host_sha256, lib.host_sha256_pairs):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    return lib


def _host_run(fn, words, counts):
    out = np.zeros((words.shape[0], 8), np.uint32)
    fn(words.ctypes.data, counts.ctypes.data, out.ctypes.data,
       words.shape[0], words.shape[1])
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
def test_kernel_source_on_host_matches_plain(batches, host_kernel, shape):
    words, counts, jax_out, plain = batches[shape]
    out = _host_run(host_kernel.host_sha256, words, counts)
    np.testing.assert_array_equal(out, plain)
    np.testing.assert_array_equal(out, jax_out)


@pytest.mark.parametrize("shape", SHAPES + ((33, 20),),
                         ids=lambda s: "%dx%d" % s)
def test_kernel_pair_ring_on_host_matches_plain(batches, host_kernel,
                                                 shape):
    if shape in batches:
        words, counts, jax_out, plain = batches[shape]
    else:
        words, counts = _batch(*shape, seed=20)
        jax_out, plain = None, _plain(words, counts)
        # some lane is longer than the hasher's 16-block bucket
        assert counts.max() > 16
    out = _host_run(host_kernel.host_sha256_pairs, words, counts)
    np.testing.assert_array_equal(out, plain)
    if jax_out is not None:
        np.testing.assert_array_equal(out, jax_out)


def test_wrapper_runs_plain_on_cpu_without_counting(batches):
    words, counts, _jax_out, plain = batches[(7, 2)]
    before = TS.LAUNCHES
    got = TS.hash_blocks_kernel(torch.from_numpy(words.view(np.int32)),
                                torch.from_numpy(counts))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy().view(np.uint32), plain)
    assert TS.LAUNCHES == before


def test_wrapper_rejects_arguments_outside_the_contract():
    w = torch.zeros((4, 2, 16), dtype=torch.int32)
    c = torch.ones(4, dtype=torch.int32)
    bad = [
        (w.long(), c),                                   # dtype
        (w, c.long()),
        (w.view(torch.uint32), c),
        (w[:, :, :8].contiguous(), c),                   # shape
        (w.reshape(4, 32), c),
        (w, c[:3]),
        (w.transpose(0, 1), c),                          # contiguity
        (w, torch.ones((4, 2), dtype=torch.int32)[:, 0]),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            TS.hash_blocks_kernel(*args)
    assert TS.hash_blocks_kernel(w, c).shape == (4, 8)
