"""The C chunk padder (`native/sha256_pad.c`) against the reference's
`pad_messages_np`, on the same messages.

`sha256_pad_native` writes a chunk's messages into a staging buffer that
holds stale words: it must write every real block of every lane (the
message, the 0x80 marker, zeros and the bit length) word for word as the
reference pads it, and every lane's count, 0 on the padding lanes. Words
past a lane's count are left as they were, so the comparison covers real
blocks only; neither version of the kernel reads past a lane's count,
which `hash_blocks_plain` on such a buffer shows against hashlib. Lengths:
every length from 0 to 130 bytes, 1,015 (the largest that fits 16
blocks) and seeded chunks of bucket-entry leaves. A message that does not
fit, a message past the end of the blob and a bad shape are refused with
nothing written. `pad_chunk` takes the C path wherever the host has a C
compiler; `pad_chunk_plain` (the numpy path) equals the reference on every
block. Tolerance: none.
"""

import hashlib

import numpy as np
import pytest
import torch

from stellar_core_tpu.ops.sha256 import pad_messages_np as ref_pad
from stellar_core_tpu_torch import native
from stellar_core_tpu_torch.ops import sha256 as TS
from stellar_core_tpu_torch.testing.entries import entry_records

STALE = -0x5A5A5A5B   # the stale buffer's fill word


@pytest.fixture(scope="module")
def lib():
    lib = native.sha256_pad_lib()
    if lib is None:
        pytest.skip("no C compiler on this host: the numpy path serves")
    return lib


def _stale(lanes: int, blocks: int):
    return (np.full((lanes, blocks, 16), STALE, np.int32),
            np.full((lanes,), 77, np.int32))


def _check_real_blocks(msgs, words, counts, blocks: int) -> None:
    """Counts equal the reference's (0 on padding lanes) and every real
    block equals the reference's words; blocks past a count are stale."""
    want_w, want_c = ref_pad(msgs, blocks)
    n = len(msgs)
    assert (counts[:n] == want_c).all()
    assert (counts[n:] == 0).all()
    for i in range(n):
        c = int(want_c[i])
        assert (words[i, :c].view(np.uint32) == want_w[i, :c]).all(), i
        assert (words[i, c:] == STALE).all(), i


def test_every_length_to_130_and_1015_equals_reference(lib):
    rng = np.random.default_rng(31)
    lens = list(range(131)) + [1015]
    msgs = [rng.bytes(n) for n in lens]
    words, counts = _stale(len(msgs) + 9, 16)
    calls = native.PAD_CALLS
    assert native.sha256_pad_native(*TS.join_messages(msgs), words,
                                    counts)
    assert native.PAD_CALLS == calls + 1
    _check_real_blocks(msgs, words, counts, 16)


@pytest.mark.parametrize("n,lanes,blocks", [(1000, 1024, 16),
                                            (256, 256, 4), (37, 256, 16)])
def test_entry_leaf_chunks_equal_reference(lib, n, lanes, blocks):
    rng = np.random.default_rng(n)
    msgs = [b"\x00" + r for r in entry_records(rng, n)]
    msgs = [m for m in msgs if TS.blocks_for_len(len(m)) <= blocks]
    words, counts = _stale(lanes, blocks)
    assert native.sha256_pad_native(*TS.join_messages(msgs), words,
                                    counts)
    _check_real_blocks(msgs, words, counts, blocks)


def test_stale_words_past_the_counts_are_not_read(lib):
    """The plain kernel over a C-padded buffer of stale words gives
    hashlib's digests, and H0 on the padding lanes."""
    rng = np.random.default_rng(32)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 250, 40)]
    words, counts = _stale(64, 4)
    assert native.sha256_pad_native(*TS.join_messages(msgs), words,
                                    counts)
    dig = TS.hash_blocks_plain(torch.from_numpy(words),
                               torch.from_numpy(counts))
    host = dig.numpy().view(np.uint32)
    assert TS.digests_to_bytes(host[:40]) == \
        [hashlib.sha256(m).digest() for m in msgs]
    assert (host[40:] == TS._H0).all()


@pytest.mark.parametrize("case", ["too-long", "past-blob", "too-many",
                                  "no-blocks"])
def test_refusals_write_nothing(lib, case):
    msgs = [b"a" * 100, b"b" * 56]
    blob, off, lens = TS.join_messages(msgs)
    lanes, blocks = 4, 2
    if case == "too-long":
        blocks = 1                       # the 100-byte message needs 2
    elif case == "past-blob":
        lens = lens.copy()
        lens[1] += 1
    elif case == "too-many":
        lanes = 1
    words, counts = _stale(lanes, blocks)
    if case == "no-blocks":
        words = words[:, :0]
    before = (words.copy(), counts.copy())
    calls = native.PAD_CALLS
    with pytest.raises(ValueError):
        native.sha256_pad_native(blob, off, lens, words, counts)
    assert native.PAD_CALLS == calls
    assert (words == before[0]).all() and (counts == before[1]).all()


def test_arrays_outside_the_contract_are_refused(lib):
    blob, off, lens = TS.join_messages([b"x"])
    words, counts = _stale(4, 1)
    for w, c, o in ((words.astype(np.int64), counts, off),
                    (words, counts[:3], off),
                    (words[:, :, ::2], counts, off),
                    (words, counts, off.astype(np.int64))):
        with pytest.raises(ValueError):
            native.sha256_pad_native(blob, o, lens, w, c)


def test_padding_lanes_only_get_count_zero(lib):
    words, counts = _stale(256, 2)
    assert native.sha256_pad_native(*TS.join_messages([]), words, counts)
    assert (counts == 0).all() and (words == STALE).all()


def test_pad_chunk_takes_the_c_path_and_plain_equals_reference(lib):
    rng = np.random.default_rng(33)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 120, 300)]
    words, counts = _stale(1024, 2)
    calls = native.PAD_CALLS
    TS.pad_chunk(*TS.join_messages(msgs), words, counts)
    assert native.PAD_CALLS == calls + 1
    _check_real_blocks(msgs, words, counts, 2)
    # the numpy path writes every block of its lanes: zeros past a count
    pw, pc = _stale(1024, 2)
    TS.pad_chunk_plain(*TS.join_messages(msgs), pw, pc)
    want_w, want_c = ref_pad(msgs, 2)
    assert (pw[:300].view(np.uint32) == want_w).all()
    assert (pc[:300] == want_c).all() and (pc[300:] == 0).all()
    assert native.PAD_CALLS == calls + 1
