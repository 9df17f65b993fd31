"""Batch padding and the data-parallel verify over a fleet of members.

Port of `stellar_core_tpu/parallel/mesh.py`. The reference shards a verify
batch pure data-parallel over a 1-D `dp` mesh: XLA partitions the verify
kernel, each device runs B/N lanes, and the only cross-device traffic is
the gather of the decisions. Here the mesh is a fleet: a tuple of
members, each a `torch.device` with two CUDA streams of its own (one to
launch on, one to stage host->device copies on). A device may repeat, so
2, 3 or 4 members can share one card, each on its own streams. A fleet of
CPU members runs the kernel's plain version; it exists only where the
caller names `cpu` devices.

The sharded verify is the single-device kernel (`ops/ed25519.verify_kernel`,
`csrc/ed25519_verify.cu`) launched once per member on that member's
stream, on its contiguous slice of lanes, then one device->host copy per
member into one pinned (B,) buffer and one wait for the members' streams.
No collective library is involved: one process drives every member, as
JAX's SPMD runtime does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class Member(NamedTuple):
    """One member of a verify fleet: its device and, on a card, the
    stream it launches on and the stream its inputs are copied on."""
    device: torch.device
    stream: Optional["torch.cuda.Stream"]
    staging_stream: Optional["torch.cuda.Stream"]


class Shard(NamedTuple):
    """One member's lanes of a batch, on that member's device. `ready`
    is the event recorded on its staging stream after the copies (None on
    the CPU)."""
    member: Member
    args: tuple
    ready: Optional["torch.cuda.Event"]


def make_fleet(devices: Optional[Sequence] = None) -> Tuple[Member, ...]:
    """The counterpart of `make_mesh`: one member per entry of `devices`
    (repeats allowed), or one per visible card when `devices` is None.
    Raises without a card unless every member is a CPU device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a verify fleet needs a CUDA device; none is available "
                "(name CPU members, e.g. ['cpu'] * n, to run the kernel's "
                "plain version)")
        devices = ["cuda:%d" % i for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a fleet needs at least one member")
    kinds = {d.type for d in devs}
    if not kinds <= {"cpu", "cuda"} or len(kinds) > 1:
        raise ValueError("a fleet's members are all cuda or all cpu "
                         "devices, got %s" % sorted(map(str, devs)))
    if kinds == {"cpu"}:
        return tuple(Member(torch.device("cpu"), None, None) for _ in devs)
    if not torch.cuda.is_available():
        raise RuntimeError("a verify fleet on %s needs a CUDA device; none "
                           "is available" % devs[0])
    members = []
    for d in devs:
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        members.append(Member(d, torch.cuda.Stream(d), torch.cuda.Stream(d)))
    return tuple(members)


def place_shards(fleet: Sequence[Member],
                 arrays: Sequence) -> Tuple[Shard, ...]:
    """Cut lanes [j·B/N, (j+1)·B/N) of the six prepared arrays (numpy or
    tensors, B a multiple of N = len(fleet)) for member j and copy them
    onto it. Host data goes through pinned memory with non-blocking
    copies on each member's staging stream, which records the event its
    launch waits on. Callable from any thread (the staging worker calls
    it): it enters each member's device itself."""
    n = len(fleet)
    ts = [torch.as_tensor(a) for a in arrays]
    b = ts[0].shape[0]
    if b % n:
        raise ValueError("batch of %d lanes does not split over %d members"
                         % (b, n))
    lanes = b // n
    if fleet[0].stream is None:
        return tuple(Shard(m, tuple(t[j * lanes:(j + 1) * lanes].to(m.device)
                                    for t in ts), None)
                     for j, m in enumerate(fleet))
    ts = [t.pin_memory() if t.device.type == "cpu" else t for t in ts]
    out = []
    on_card = any(t.is_cuda for t in ts)
    for j, m in enumerate(fleet):
        with torch.cuda.device(m.device):
            caller = torch.cuda.current_stream()
        stream = m.staging_stream
        with torch.cuda.device(m.device), torch.cuda.stream(stream):
            if on_card:
                # inputs the caller made on the card are ordered before
                # the copies
                stream.wait_stream(caller)
            args = tuple(t[j * lanes:(j + 1) * lanes].to(
                m.device, non_blocking=True) for t in ts)
            # made on the staging stream, read on the member's: the
            # caching allocator must not hand the memory out again before
            # the member's stream is done with it
            for a in args:
                a.record_stream(m.stream)
            ready = torch.cuda.Event()
            ready.record(stream)
        out.append(Shard(m, args, ready))
    return tuple(out)


class Launched:
    """A sharded launch in flight: each member's (lanes,) bool decisions
    on its device. `gather()` (or `np.asarray`, as on JAX's async result)
    brings them to the host in lane order and waits."""

    __slots__ = ("shards", "outs")

    def __init__(self, shards: Sequence[Shard], outs: list) -> None:
        self.shards = tuple(shards)
        self.outs = outs

    def gather(self) -> torch.Tensor:
        return gather_decisions(self.shards, self.outs)

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        ok = self.gather().numpy()
        return ok if dtype is None else ok.astype(dtype)


def launch_shards(*shards: Shard) -> Launched:
    """Launch the verify kernel once per shard on its member's stream,
    after the shard's copies; no synchronisation. A failed launch
    raises."""
    from ..ops import ed25519 as _e
    outs = []
    for sh in shards:
        m = sh.member
        if m.stream is None:
            outs.append(_e.verify_kernel(*sh.args))
            continue
        with torch.cuda.device(m.device), torch.cuda.stream(m.stream):
            m.stream.wait_event(sh.ready)
            outs.append(_e.verify_kernel(*sh.args))
    return Launched(shards, outs)


def gather_decisions(shards: Sequence[Shard], outs: Sequence) -> torch.Tensor:
    """The members' decisions in lane order on the host: one
    device->host copy per member, on its stream, into one pinned buffer,
    then a wait for each member's stream."""
    if shards[0].member.stream is None:
        return torch.cat(list(outs))
    host = torch.empty(sum(o.shape[0] for o in outs), dtype=torch.bool,
                       pin_memory=True)
    off = 0
    for sh, o in zip(shards, outs):
        m = sh.member
        with torch.cuda.device(m.device), torch.cuda.stream(m.stream):
            host[off:off + o.shape[0]].copy_(o, non_blocking=True)
        off += o.shape[0]
    for sh in shards:
        sh.member.stream.synchronize()
    return host


def sharded_verify(fleet: Sequence[Member]):
    """The counterpart of `sharded_verify_fn`: a function of the six
    prepared arrays (B a multiple of the fleet size) that verifies member
    j's lanes on member j and returns the (B,) decisions, in lane order,
    on the host."""
    fleet = tuple(fleet)

    def fn(ay, a_sign, ry, r_sign, s_nibs, k_nibs) -> torch.Tensor:
        return launch_shards(*place_shards(
            fleet, (ay, a_sign, ry, r_sign, s_nibs, k_nibs))).gather()

    return fn


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


def multichip_verify(pubs, sigs, msgs,
                     fleet: Optional[Sequence[Member]] = None) -> np.ndarray:
    """End-to-end sharded verify: host prep -> padding to a multiple of
    the fleet size -> one launch per member -> gather. `fleet` defaults to
    one member per visible card."""
    from ..ops.ed25519 import ARG_KEYS, prepare_batch
    fleet = make_fleet() if fleet is None else fleet
    ndev = len(fleet)
    prep = prepare_batch(pubs, sigs, msgs)
    n = prep["ay"].shape[0]
    prep = pad_batch_to(prep, -(-n // ndev) * ndev)
    ok = sharded_verify(fleet)(*(prep[k] for k in ARG_KEYS)).numpy()
    return ok[:n] & prep["pre_ok"][:n]
