"""BatchHasher: the batched SHA-256 boundary.

Port of the core of `stellar_core_tpu/crypto/batch_hasher.py` at commit
ada2c73. SHA-256 has two traffic shapes in a ledger close, so the boundary
has two call shapes:

    hash_many(msgs, site)     -> [digest]  one digest per message: the
        bucket entry leaves the state commitment hashes by the thousand
        (ledger/state_commitment.py), the device-batchable load
    hash_stream(chunks, site) -> digest    one digest over a concatenated
        stream (txset contents, result sets, bucket identity): sequential
        by construction, served on the host through bounded join groups
    digest_one(data, site)    -> digest    one small message: host-served,
        a one-lane launch would pay the round trip for nothing

Backends:
- CpuBatchHasher — hashlib per message.
- CudaBatchHasher — the counterpart of the reference's TpuBatchHasher:
  messages are stably sorted by block count, cut into chunks of at most
  4,096 lanes, and each chunk is padded to a (lane bucket x block bucket)
  shape of a fixed ladder and hashed by one launch of the CUDA kernel
  (ops/sha256.hash_blocks_kernel). Digests come back in the caller's
  order. Messages longer than the largest block bucket (> 16 blocks,
  > 1,015 B) are hashed on the host and counted in `oversize_msgs`: the
  reference's own routing, not a fallback.

Unlike the reference's `make_hasher("tpu")`, the "cuda" backend is not
wrapped in a circuit breaker with a CPU fallback: a build or launch failure
raises to the caller. The breaker, the `HasherStats` cockpit, the staging
double buffer and the warmup come back as explicit operator layers in a
later slice; until then plain counters on the hasher (`batches`,
`pad_blocks`, `real_blocks`, `oversize_msgs`) stand in for the cockpit, and
`site` names the caller for it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import sha256 as _sha
from .hashing import SHA256, sha256

# bounded join group for streamed digests: one C-level update per ~1 MiB
# keeps per-chunk Python overhead amortized and peak memory flat on large
# txsets and buckets
_STREAM_GROUP_BYTES = 1 << 20


def stream_digest(chunks) -> bytes:
    """One SHA-256 over an iterable of byte chunks, grouped into bounded
    joins (see _STREAM_GROUP_BYTES)."""
    h = SHA256()
    buf: List[bytes] = []
    size = 0
    for c in chunks:
        buf.append(c)
        size += len(c)
        if size >= _STREAM_GROUP_BYTES:
            h.add(b"".join(buf))
            buf = []
            size = 0
    if buf:
        h.add(b"".join(buf))
    return h.finish()


class BatchHasher:
    """Abstract backend; see module docstring."""

    name = "abstract"

    def hash_many(self, msgs: Sequence[bytes],
                  site: str = "other") -> List[bytes]:
        raise NotImplementedError

    def digest_one(self, data: bytes, site: str = "other") -> bytes:
        """Single-digest convenience (header hash, txset identity), always
        served on the host."""
        return sha256(data)

    def hash_stream(self, chunks, site: str = "other") -> bytes:
        """One digest over a concatenated stream, served on the host via
        `stream_digest`'s bounded join groups."""
        return stream_digest(chunks)


class CpuBatchHasher(BatchHasher):
    """Synchronous hashlib backend."""

    name = "cpu"

    def hash_many(self, msgs: Sequence[bytes],
                  site: str = "other") -> List[bytes]:
        return [sha256(m) for m in msgs]


# one chunk of a drain: the caller's indices of its messages, its lane
# bucket and its block bucket
Chunk = Tuple[List[int], int, int]


class CudaBatchHasher(BatchHasher):
    """Batched backend on the CUDA SHA-256 kernel.

    Runs on `device` (default: the current CUDA device). Without CUDA the
    constructor raises, unless the caller asks for `device="cpu"`, where
    the wrapper runs the kernel's plain version."""

    name = "cuda"
    LANE_BUCKETS = (256, 1024, 4096)
    BLOCK_BUCKETS = (1, 2, 4, 8, 16)

    def __init__(self, device=None) -> None:
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CudaBatchHasher needs a CUDA device; none is available "
                "(pass device='cpu' to run the kernel's plain version)")
        self.batches = 0          # kernel dispatches
        self.pad_blocks = 0       # padded-but-empty blocks shipped
        self.real_blocks = 0      # message blocks hashed on the device
        self.oversize_msgs = 0    # messages hashed on the host

    @staticmethod
    def _bucket(ladder: Tuple[int, ...], n: int) -> int:
        for b in ladder:
            if n <= b:
                return b
        return ladder[-1]

    def plan(self, blocks: Sequence[int]) -> Tuple[List[int], List[Chunk]]:
        """Route a drain given each message's block count: the indices of
        the oversize messages (hashed on the host), and the device chunks.
        Device messages are stably sorted by block count, so a chunk's
        block bucket fits its longest member tightly."""
        max_dev = self.BLOCK_BUCKETS[-1]
        over = [i for i, b in enumerate(blocks) if b > max_dev]
        dev = sorted((i for i, b in enumerate(blocks) if b <= max_dev),
                     key=lambda i: blocks[i])
        step = self.LANE_BUCKETS[-1]
        chunks = []
        for k in range(0, len(dev), step):
            idx = dev[k:k + step]
            chunks.append((idx, self._bucket(self.LANE_BUCKETS, len(idx)),
                           self._bucket(self.BLOCK_BUCKETS, blocks[idx[-1]])))
        return over, chunks

    @staticmethod
    def stage(msgs: Sequence[bytes], lanes: int,
              blocks: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pad one chunk into its (lanes, blocks, 16) shape on the host:
        int32 words (uint32 bits) and int32 counts, 0 on padding lanes."""
        words = np.zeros((lanes, blocks, 16), np.uint32)
        counts = np.zeros((lanes,), np.int32)
        words[:len(msgs)], counts[:len(msgs)] = _sha.pad_messages_np(msgs,
                                                                     blocks)
        return words.view(np.int32), counts

    def hash_many(self, msgs: Sequence[bytes],
                  site: str = "other") -> List[bytes]:
        blocks = [_sha.blocks_for_len(len(m)) for m in msgs]
        over, chunks = self.plan(blocks)
        out: List[Optional[bytes]] = [None] * len(msgs)
        for i in over:
            out[i] = sha256(msgs[i])
        self.oversize_msgs += len(over)
        for idx, lanes, blk in chunks:
            words, counts = self.stage([msgs[i] for i in idx], lanes, blk)
            dig = _sha.hash_blocks_kernel(
                torch.from_numpy(words).to(self.device),
                torch.from_numpy(counts).to(self.device))
            raw = _sha.digests_to_bytes(
                dig[:len(idx)].cpu().numpy().view(np.uint32))
            for i, d in zip(idx, raw):
                out[i] = d
            real = int(counts.sum())
            self.batches += 1
            self.real_blocks += real
            self.pad_blocks += lanes * blk - real
        return out  # type: ignore[return-value]


def make_hasher(backend: str = "cuda", device=None) -> BatchHasher:
    """Backend selection by name: "cuda" (the default; it raises without a
    card unless `device="cpu"` is given) or "cpu" (hashlib)."""
    if backend == "cpu":
        return CpuBatchHasher()
    if backend == "cuda":
        return CudaBatchHasher(device=device)
    raise ValueError("unknown hash backend %r" % backend)
