"""Entry point of the port's flagship model: the counterpart of the
reference's `__graft_entry__.entry()`.

`entry()` returns the forward step of the flagship device model (the
batched ed25519 verifier) and example arguments at batch 128, the
live-SCP verify bucket. Calling `entry()` never initialises CUDA: the
arguments are host (CPU) tensors, and the returned forward moves them to
the card when it is called, launches the CUDA kernel there, and raises
when there is no card. `entry(device="cpu")` returns a forward that runs
the kernel's plain version on the CPU instead.

`dryrun_multichip(n, devices)` is the counterpart of the reference's
multi-device dry run: the sharded verify over n fleet members.
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


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The counterpart of the reference's `dryrun_multichip`: 64 verifies
    per member, every 8th signature corrupted, through both sharded paths
    (`multichip_verify` and a `CudaSigVerifier` fleet with shard threshold
    1); raises unless every decision is right and the verifier took the
    sharded route. `devices` names the members (repeats allowed); by
    default the first `n_devices` cards, and it raises with fewer."""
    import torch

    from .crypto.batch_verifier import CudaSigVerifier
    from .models.verifier_model import make_example_batch
    from .parallel.mesh import make_fleet, multichip_verify

    if n_devices < 2:
        raise ValueError("a sharded dryrun needs at least 2 members")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError("dryrun_multichip(%d) needs %d CUDA devices, "
                               "%d visible" % (n_devices, n_devices, have))
        devices = ["cuda:%d" % i for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError("need %d members, got %d" % (n_devices,
                                                      len(devices)))
    batch = n_devices * 64
    pubs, sigs, msgs = make_example_batch(batch=batch, n_keys=4,
                                          corrupt_every=8)
    expect = [(i % 8) != 7 for i in range(batch)]

    ok = multichip_verify(pubs, sigs, msgs, make_fleet(devices))
    if ok.tolist() != expect:
        raise RuntimeError("multichip verify results wrong")

    v = CudaSigVerifier(shard_threshold=1, devices=devices)
    got = v.verify_many(list(zip(pubs, sigs, msgs)))
    if got != expect:
        raise RuntimeError("CudaSigVerifier sharded results wrong")
    if tuple(range(n_devices)) not in v._mesh_fns:
        raise RuntimeError("CudaSigVerifier did not take the sharded route "
                           "over %d members" % n_devices)
    print("dryrun_multichip(%d): ok (%d verifies, %d valid, sharded route "
          "over %s)" % (n_devices, batch, sum(got),
                        ", ".join(str(m.device) for m in v._members)))
