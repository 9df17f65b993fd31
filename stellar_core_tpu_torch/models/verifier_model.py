"""The flagship device model: the batched ed25519 verification graph.

Port of `stellar_core_tpu/models/verifier_model.py`. The "model" is a
fixed-function cryptographic pipeline (point decompression + double-scalar
multiplication + projective equality over a batch axis), packaged with the
standard model-API surface: build inputs, forward step, and carry the one
parameter tensor (the fixed-base table) across from the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..crypto.keys import SecretKey
from ..ops import ed25519 as E


def make_example_batch(batch: int = 256, n_keys: int = 16,
                       corrupt_every: int = 0) -> Tuple[list, list, list]:
    """Deterministic signed batch for compile checks and benches."""
    sks = [SecretKey.from_seed(bytes([i + 1] * 32)) for i in range(n_keys)]
    pubs, sigs, msgs = [], [], []
    for i in range(batch):
        sk = sks[i % n_keys]
        m = b"bench-msg-%08d" % i
        s = bytearray(sk.sign(m))
        if corrupt_every and i % corrupt_every == corrupt_every - 1:
            s[i % 64] ^= 1
        pubs.append(sk.public_key.key_bytes)
        sigs.append(bytes(s))
        msgs.append(m)
    return pubs, sigs, msgs


def device_args(pubs: List[bytes], sigs: List[bytes],
                msgs: List[bytes]) -> tuple:
    """Host (CPU tensor) argument tuple for `forward`. Staying on the host
    matters: a caller probing `entry()` decides for itself when (and
    whether) to initialise CUDA, by moving the tensors to the card."""
    prep = E.prepare_batch(pubs, sigs, msgs)
    return tuple(torch.from_numpy(np.ascontiguousarray(prep[k]))
                 for k in E.ARG_KEYS)


def forward(ay, a_sign, ry, r_sign, s_nibs, k_nibs,
            device=None) -> torch.Tensor:
    """The forward step: (B, ...) int32 tensors → (B,) bool. It moves its
    arguments to `device` and runs there: the card by default, where it
    launches the CUDA kernel, and it raises when there is no card. Only a
    caller that asks for `device="cpu"` gets the kernel's plain version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "forward needs a CUDA device; none is available (pass "
            "device='cpu' to run the kernel's plain version)")
    return E.verify_kernel(*(a.to(dev) for a in (ay, a_sign, ry, r_sign,
                                                 s_nibs, k_nibs)))


def fixed_table_from_jax(np_table: np.ndarray
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Carry the JAX package's one parameter tensor across: its
    `fixed_table()` array (64, 9, 3, 20) of 13-bit limbs becomes the
    port's table tensor (same limbs, used by the plain version) and the
    kernel's parameter block (the table in radix 2^25.5, then the curve
    constants d, 2d and sqrt(−1) in the same radix)."""
    table = np.ascontiguousarray(np_table, dtype=np.int32)
    return torch.from_numpy(table.copy()), \
        torch.from_numpy(E.kernel_params(table))
