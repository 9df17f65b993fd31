"""Batch padding for the verify dispatch.

Port of `pad_batch_to` from `stellar_core_tpu/parallel/mesh.py`. The rest
of that module (the multi-device data-parallel verify) comes to the port
with its multi-GPU slice.
"""

from __future__ import annotations

import numpy as np


def pad_batch_to(prep: dict, size: int) -> dict:
    """Pad host-prepared arrays up to `size` (invalid padding lanes verify
    False and are masked by pre_ok)."""
    n = prep["ay"].shape[0]
    if size < n:
        raise ValueError("cannot pad a batch of %d down to %d" % (n, size))
    pad = size - n
    out = {}
    for k, v in prep.items():
        if k == "pre_ok":
            out[k] = np.concatenate([v, np.zeros(pad, bool)])
        else:
            out[k] = np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
    return out
