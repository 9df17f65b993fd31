"""The port's BatchHasher boundary against the JAX package's, on the same
inputs (mirrors tests/test_batch_hasher.py:29-100 without the breaker and
the warmup, which the port has not taken yet).

`CudaBatchHasher(device="cpu")` runs the kernel's plain version behind the
same routing the card uses: the stable sort by block count, chunks of at
most 4,096 lanes padded to the (lane x block) ladder, oversize messages to
the host. Its digests must equal `CpuBatchHasher`'s, hashlib's and the
reference `make_hasher("tpu")`'s, in the caller's order, and its counters
must equal the reference cockpit's. The JAX side stays at 256 lanes.
Tolerance: none.
"""

import hashlib

import numpy as np
import pytest
import torch

from stellar_core_tpu.crypto.batch_hasher import make_hasher as jax_hasher
from stellar_core_tpu.ops.sha256 import sha256_batch_host
from stellar_core_tpu_torch.crypto.batch_hasher import (
    CpuBatchHasher, CudaBatchHasher, make_hasher, stream_digest,
)
from stellar_core_tpu_torch.ops import sha256 as TS

import torch_threads  # noqa: F401  (one intra-op thread a worker)


def _mixed_msgs(seed: int = 0):
    """tests/test_batch_hasher.py:56-60 from a seeded generator: mixed
    sizes including two oversize ones (> 16 blocks = > 1,015 bytes)."""
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in
            (0, 3, 40, 64, 119, 300, 900, 1015, 1016, 2048)] * 3


@pytest.fixture(scope="module")
def reference():
    """The reference's digests and cockpit for `_mixed_msgs()`."""
    msgs = _mixed_msgs()
    h = jax_hasher("tpu")
    return msgs, h.hash_many(msgs, site="bench"), h.stats.to_json()


def test_cuda_hasher_on_cpu_matches_reference_and_hashlib_in_order(
        reference):
    msgs, ref_digests, ref_stats = reference
    want = sha256_batch_host(msgs)
    assert ref_digests == want
    h = CudaBatchHasher(device="cpu")
    assert h.hash_many(msgs, site="bench") == want
    assert CpuBatchHasher().hash_many(msgs, site="bench") == want
    assert make_hasher("cpu").hash_many(msgs) == want
    # the oversize lanes split out to the host and are counted
    assert h.oversize_msgs == ref_stats["oversize_msgs"] == 6
    # one dispatch at the reference's shape, with its padding
    assert list(ref_stats["buckets"]) == ["256x16"]
    assert h.batches == ref_stats["buckets"]["256x16"]["dispatches"] == 1
    assert h.pad_blocks == ref_stats["buckets"]["256x16"][
        "pad_blocks_total"]
    assert h.real_blocks == sum(TS.blocks_for_len(len(m)) for m in msgs
                                if len(m) <= 1015)


def test_plan_sorts_chunks_and_buckets():
    h = CudaBatchHasher(device="cpu")
    blocks = [3, 1, 17, 2, 1] * 1100 + [16]
    over, chunks = h.plan(blocks)
    assert over == [i for i, b in enumerate(blocks) if b == 17]
    idx = [i for c in chunks for i in c[0]]
    assert sorted(idx) == [i for i, b in enumerate(blocks) if b != 17]
    assert [blocks[i] for i in idx] == sorted(blocks[i] for i in idx)
    # stable: equal block counts keep the caller's order
    ones = [i for i in idx if blocks[i] == 1]
    assert ones == sorted(ones)
    assert [(len(c[0]), c[1], c[2]) for c in chunks] == [(4096, 4096, 4),
                                                         (305, 1024, 16)]


def test_multi_chunk_drain_equals_hashlib_in_order():
    """4,100 messages: a full 4,096-lane chunk and a short tail, in a
    shuffled order the hasher must restore."""
    rng = np.random.default_rng(5)
    lens = rng.permutation(np.concatenate([
        rng.integers(0, 56, 3000), rng.integers(56, 120, 1090),
        rng.integers(120, 1016, 10)]))
    msgs = [rng.bytes(int(n)) for n in lens]
    h = make_hasher("cuda", device="cpu")
    assert isinstance(h, CudaBatchHasher)
    assert h.hash_many(msgs, site="bucket-entries") == \
        sha256_batch_host(msgs)
    assert h.batches == 2 and h.oversize_msgs == 0
    assert h.real_blocks == sum(TS.blocks_for_len(int(n)) for n in lens)


def test_empty_drain_dispatches_nothing():
    h = CudaBatchHasher(device="cpu")
    before = TS.LAUNCHES
    assert h.hash_many([]) == []
    assert h.batches == 0 and TS.LAUNCHES == before


def test_hash_stream_equals_one_shot_digest():
    rng = np.random.default_rng(6)
    chunks = [rng.bytes(1000) for _ in range(40)]
    want = hashlib.sha256(b"".join(chunks)).digest()
    assert stream_digest(iter(chunks)) == want
    assert CpuBatchHasher().hash_stream(iter(chunks),
                                        site="result-set") == want
    assert CudaBatchHasher(device="cpu").hash_stream(iter(chunks)) == want
    # cross the bounded-join group boundary (1 MiB) — memory-flat path
    big = [b"z" * (300 * 1024)] * 5
    assert stream_digest(iter(big)) == \
        hashlib.sha256(b"".join(big)).digest()
    assert stream_digest(iter([])) == hashlib.sha256(b"").digest()


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_digest_one_matches_sha256(backend):
    h = make_hasher(backend, device="cpu")
    assert h.digest_one(b"header-bytes", site="header") == \
        hashlib.sha256(b"header-bytes").digest()


def test_cuda_hasher_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_hasher("cuda")
    with pytest.raises(RuntimeError):
        make_hasher()
    with pytest.raises(RuntimeError):
        CudaBatchHasher()
    assert CudaBatchHasher(device="cpu").device.type == "cpu"


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError):
        make_hasher("tpu")
