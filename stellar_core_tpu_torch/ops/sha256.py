"""Batched SHA-256: host padding, the plain PyTorch version, and the wrapper
that launches the Hopper kernel.

Port of `stellar_core_tpu/ops/sha256.py` at commit ada2c73 (`_K`, `_H0`,
`blocks_for_len`, `pad_messages_np`, `digests_to_bytes` and the hashlib
oracle `sha256_batch_host` are copies; carry a fix in either copy to the
other):

- One message per lane, FIPS 180-4 over the lane's own padded blocks. The
  host pads every message of a dispatch to one block count and passes each
  lane's true count; a lane absorbs blocks `0 .. n_blocks-1` only, so a
  padding lane (`n_blocks == 0`) keeps the initial state H0, exactly as the
  reference's mask `i < n_blocks` leaves it.
- Words travel as int32 tensors holding the reference's uint32 bits:
  PyTorch has no shifts on uint32 CPU tensors and `>>` on int32 is
  arithmetic, so `hash_blocks_plain` computes in int64 and masks to 32 bits
  after every add and shift.
- `hash_blocks_kernel` is the wrapper: on CUDA tensors it launches
  `csrc/sha256.cu` (built at first use) and counts the launch in
  `LAUNCHES`; on CPU tensors it runs `hash_blocks_plain`. It never falls
  back from the card to the plain version: a build or launch failure
  raises.
- Layout: batch-first (B, max_blocks, 16) words, the host's byte order
  already turned into word values by `pad_messages_np` (big-endian), so
  neither version byte-swaps; `digests_to_bytes` swaps back on the host.
- `pad_chunk` pads one chunk of a drain into a staging buffer: one call of
  the C padder (`native/sha256_pad.c`) wherever the host has a C
  compiler, else `pad_chunk_plain`, the numpy path over
  `pad_messages_np`. The C padder writes each lane's real blocks only;
  the words past a lane's count keep whatever the buffer held, which
  neither version of the kernel reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import native as _native

# FIPS 180-4 round constants and initial state
_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19], dtype=np.uint32)

_M32 = 0xFFFFFFFF


def blocks_for_len(n: int) -> int:
    """FIPS padded 64-byte block count for an n-byte message (the 0x80
    marker plus the 8-byte bit length always fit, so empty = 1 block)."""
    return (n + 9 + 63) // 64


# --- the plain version (PyTorch, any device) --------------------------------

def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress(state: List[torch.Tensor], w: List[torch.Tensor],
              k: List[int]) -> List[torch.Tensor]:
    """One FIPS 180-4 compression of a block (16 words, each a (B,) int64
    tensor of 32-bit values) into the 8-word state."""
    w = list(w)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & _M32 & g)
        t1 = (h + s1 + ch + k[t] + w[t]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & _M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & _M32
    return [(s + o) & _M32 for s, o in zip(state, (a, b, c, d, e, f, g, h))]


def hash_blocks_plain(words: torch.Tensor,
                      n_blocks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the reference's `hash_blocks_kernel`.
    `words`: (B, max_blocks, 16) int32 (uint32 bits, big-endian message
    words, FIPS-padded per lane); `n_blocks`: (B,) int32 true block counts.
    Returns (B, 8) int32 digest words (uint32 bits). Block `i` updates only
    the lanes with `i < n_blocks`, so a lane stops at its own last block."""
    w64 = words.to(torch.int64) & _M32
    counts = n_blocks.to(torch.int64)
    batch = words.shape[0]
    state = [torch.full((batch,), int(v), dtype=torch.int64,
                        device=words.device) for v in _H0]
    k = [int(v) for v in _K]
    for i in range(words.shape[1]):
        new = _compress(state, list(w64[:, i].unbind(1)), k)
        active = i < counts
        state = [torch.where(active, n, o) for n, o in zip(new, state)]
    out = torch.stack(state, dim=1)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


# --- the wrapper: CUDA kernel on the card, plain version on the CPU --------

# kernel launches since import (or since a caller reset it); the wrapper
# adds one where it launches the CUDA kernel and nowhere else
LAUNCHES = 0

_LIB_LOCK = threading.Lock()
_LIB = None


def _cuda_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from .._build import build_cuda
            lib = ctypes.CDLL(build_cuda()["sha256"])
            lib.sct_sha256_blocks.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.sct_sha256_blocks.restype = ctypes.c_int
            lib.sct_sha256_error_string.argtypes = [ctypes.c_int]
            lib.sct_sha256_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check_args(words: torch.Tensor, n_blocks: torch.Tensor) -> None:
    if n_blocks.device != words.device:
        raise ValueError("n_blocks is on %s, words on %s"
                         % (n_blocks.device, words.device))
    for name, a in (("words", words), ("n_blocks", n_blocks)):
        if a.dtype != torch.int32:
            raise ValueError("%s must be int32, got %s" % (name, a.dtype))
        if not a.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if words.dim() != 3 or words.shape[2] != 16:
        raise ValueError("words must have shape (B, max_blocks, 16), got %r"
                         % (tuple(words.shape),))
    if tuple(n_blocks.shape) != (words.shape[0],):
        raise ValueError("n_blocks must have shape %r, got %r"
                         % ((words.shape[0],), tuple(n_blocks.shape)))


def hash_blocks_kernel(words: torch.Tensor,
                       n_blocks: torch.Tensor) -> torch.Tensor:
    """(B, 8) int32 digest words for padded blocks (the contract of
    `hash_blocks_plain`). CUDA tensors launch the Hopper kernel on the
    current stream (no synchronisation); CPU tensors run
    `hash_blocks_plain`."""
    global LAUNCHES
    _check_args(words, n_blocks)
    dev = words.device
    if dev.type == "cpu":
        return hash_blocks_plain(words, n_blocks)
    if dev.type != "cuda":
        raise ValueError("hash_blocks_kernel runs on cuda or cpu, not %s"
                         % dev)
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned (the kernel copies "
                         "each block as four 16-byte cp.async)")
    lib = _cuda_lib()
    batch, max_blocks = words.shape[0], words.shape[1]
    out = torch.empty((batch, 8), dtype=torch.int32, device=dev)
    if batch == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sct_sha256_blocks(words.data_ptr(), n_blocks.data_ptr(),
                                   out.data_ptr(), batch, max_blocks,
                                   stream)
    if rc != 0:
        raise RuntimeError("sha256 kernel launch failed: %s"
                           % lib.sct_sha256_error_string(rc).decode())
    LAUNCHES += 1
    return out


# --- host-side batch preparation (numpy / C-speed per message) -------------

def pad_messages_np(msgs: Sequence[bytes],
                    max_blocks: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """FIPS-pad a batch into device-ready arrays: (B, max_blocks, 16)
    uint32 big-endian words + (B,) int32 true block counts. max_blocks=0
    sizes the array to the longest message; an explicit bucket shape
    must hold every message (asserted — routing splits oversize lanes
    out before prep)."""
    n = len(msgs)
    counts = np.array([blocks_for_len(len(m)) for m in msgs], np.int32) \
        if n else np.zeros((0,), np.int32)
    need = int(counts.max()) if n else 1
    if max_blocks <= 0:
        max_blocks = need
    assert need <= max_blocks, (need, max_blocks)
    words = np.zeros((n, max_blocks, 16), np.uint32)
    for i, m in enumerate(msgs):
        padded = m + b"\x80" + b"\x00" * ((-(len(m) + 9)) % 64) + \
            (8 * len(m)).to_bytes(8, "big")
        arr = np.frombuffer(padded, dtype=">u4").astype(np.uint32)
        words[i, :len(arr) // 16] = arr.reshape(-1, 16)
    return words, counts


def join_messages(msgs: Sequence[bytes]) -> Tuple[bytes, np.ndarray,
                                                  np.ndarray]:
    """(the messages joined, each one's uint64 offset, uint64 lengths): a
    drain's messages in the form `pad_chunk` takes, a chunk being the
    offsets and lengths of its lanes."""
    lens = np.fromiter(map(len, msgs), np.uint64, len(msgs))
    off = np.zeros(len(msgs), np.uint64)
    np.cumsum(lens[:-1], out=off[1:])
    return b"".join(msgs), off, lens


def pad_chunk(blob: bytes, off: np.ndarray, lens: np.ndarray,
              words: np.ndarray, counts: np.ndarray) -> None:
    """Pad the messages blob[off[i]:off[i] + lens[i]] (uint64 offsets and
    lengths) into lanes 0..n-1 of `words`, a (lanes, blocks, 16) int32
    buffer, and write every lane's count into `counts`, 0 on the padding
    lanes. Only each lane's real blocks are written. One C call where the
    host has a C compiler (a message that does not fit raises ValueError),
    else `pad_chunk_plain`."""
    if not _native.sha256_pad_native(blob, off, lens, words, counts):
        pad_chunk_plain(blob, off, lens, words, counts)


def pad_chunk_plain(blob: bytes, off: np.ndarray, lens: np.ndarray,
                    words: np.ndarray, counts: np.ndarray) -> None:
    """`pad_chunk`'s numpy path: `pad_messages_np` over the chunk's
    messages, copied into the first n lanes (every block of the bucket,
    zeros past a lane's count)."""
    n = len(off)
    msgs = [blob[o:o + m] for o, m in zip(off.tolist(), lens.tolist())]
    w, c = pad_messages_np(msgs, words.shape[1])
    words[:n] = w.view(np.int32)
    counts[:n] = c
    counts[n:] = 0


def digests_to_bytes(digests: np.ndarray) -> List[bytes]:
    """(B, 8) uint32 digest words -> 32-byte big-endian digests."""
    blob = np.ascontiguousarray(np.asarray(digests, np.uint32)) \
        .astype(">u4").tobytes()
    return [blob[32 * i:32 * i + 32] for i in range(len(digests))]


def sha256_batch_device(msgs: Sequence[bytes], max_blocks: int = 0,
                        device=None) -> List[bytes]:
    """End-to-end batched hash (host prep + one kernel launch) on `device`:
    the card unless the caller asks for the CPU. A one-launch convenience
    for a small batch whose messages all fit the kernel (no bucketing, no
    oversize routing); a ledger's drains go through
    crypto/batch_hasher.py's `CudaBatchHasher`."""
    if not msgs:
        return []
    dev = torch.device("cuda" if device is None else device)
    words, counts = pad_messages_np(msgs, max_blocks)
    out = hash_blocks_kernel(torch.from_numpy(words.view(np.int32)).to(dev),
                             torch.from_numpy(counts).to(dev))
    return digests_to_bytes(out.cpu().numpy().view(np.uint32))


def sha256_batch_host(msgs: Sequence[bytes]) -> List[bytes]:
    """The hashlib oracle both backends must match byte-for-byte."""
    return [hashlib.sha256(m).digest() for m in msgs]
