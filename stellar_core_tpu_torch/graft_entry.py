"""Entry point of the port's flagship model: the counterpart of the
reference's `__graft_entry__.entry()`.

`entry()` returns the forward step of the flagship device model (the
batched ed25519 verifier) and example arguments at batch 128, the
live-SCP verify bucket. Calling `entry()` never initialises CUDA: the
arguments are host (CPU) tensors, and the returned forward moves them to
the card when it is called, launches the CUDA kernel there, and raises
when there is no card. `entry(device="cpu")` returns a forward that runs
the kernel's plain version on the CPU instead.
"""

from __future__ import annotations

import functools


def entry(device=None):
    from .models.verifier_model import (
        device_args, forward, make_example_batch,
    )
    pubs, sigs, msgs = make_example_batch(batch=128, n_keys=8)
    return (functools.partial(forward, device=device),
            device_args(pubs, sigs, msgs))
