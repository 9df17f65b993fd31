"""Topologies: canned quorum/network shapes for simulations.

Copied from `stellar_core_tpu/simulation/topologies.py` at commit a593ccf;
carry a fix in either copy to the other. Nothing is left out. One
deliberate difference: every builder takes `backend` (default
"cuda-resilient", the card's stack) and passes it to its `Simulation`, so
the fleet runs on the card unless the CPU is named (`simulation.py`).

Role parity: reference `src/simulation/Topologies.{h,cpp}` (core4, cycle,
branched, hierarchical).
"""

from __future__ import annotations

from typing import List

from ..crypto.hashing import sha256
from ..crypto.keys import SecretKey
from ..xdr import SCPQuorumSet
from .simulation import Simulation


def _keys(n: int, tag: bytes) -> List[SecretKey]:
    return [SecretKey.from_seed(sha256(tag + bytes([i])))
            for i in range(n)]


def core(n: int, threshold: int,
         passphrase: str = "(sct) simulation network",
         mode: int = Simulation.OVER_LOOPBACK,
         cfg_tweak=None, backend: str = "cuda-resilient") -> Simulation:
    """Fully-connected core of n validators all trusting each other."""
    sim = Simulation(mode=mode, network_passphrase=passphrase,
                     backend=backend)
    keys = _keys(n, b"core")
    qset = SCPQuorumSet(threshold=threshold,
                        validators=[k.public_key for k in keys],
                        innerSets=[])
    names = []
    for k in keys:
        node = sim.add_node(k, qset, cfg_tweak=cfg_tweak)
        names.append(node.name)
    for i in range(n):
        for j in range(i + 1, n):
            sim.connect(names[i], names[j])
    return sim


def core4(passphrase: str = "(sct) simulation network",
          backend: str = "cuda-resilient") -> Simulation:
    return core(4, 3, passphrase, backend=backend)


def cycle(n: int = 4, backend: str = "cuda-resilient") -> Simulation:
    """Ring: each node trusts itself + both neighbours (threshold 2)."""
    sim = Simulation(backend=backend)
    keys = _keys(n, b"cycle")
    names = []
    for i, k in enumerate(keys):
        left = keys[(i - 1) % n].public_key
        right = keys[(i + 1) % n].public_key
        qset = SCPQuorumSet(threshold=2,
                            validators=[k.public_key, left, right],
                            innerSets=[])
        node = sim.add_node(k, qset,
                            cfg_tweak=lambda c: setattr(
                                c, "UNSAFE_QUORUM", True))
        names.append(node.name)
    for i in range(n):
        sim.connect(names[i], names[(i + 1) % n])
    return sim


def branched_core(n_core: int = 3,
                  backend: str = "cuda-resilient") -> Simulation:
    """Core + one leaf validator attached to each core node."""
    sim = Simulation(backend=backend)
    core_keys = _keys(n_core, b"bcore")
    core_q = SCPQuorumSet(
        threshold=(n_core * 2 + 2) // 3,
        validators=[k.public_key for k in core_keys], innerSets=[])
    core_names = [sim.add_node(k, core_q).name for k in core_keys]
    for i in range(n_core):
        for j in range(i + 1, n_core):
            sim.connect(core_names[i], core_names[j])
    leaf_keys = _keys(n_core, b"leaf")
    for i, lk in enumerate(leaf_keys):
        q = SCPQuorumSet(threshold=2, validators=[
            lk.public_key, core_keys[i].public_key], innerSets=[])
        leaf = sim.add_node(lk, q)
        sim.connect(leaf.name, core_names[i])
    return sim


def hierarchical(n_branches: int = 3,
                 mode: int = Simulation.OVER_LOOPBACK,
                 backend: str = "cuda-resilient") -> Simulation:
    """Core-4 top tier + per-branch middle-tier validators whose qsets
    are {self} + an inner 2-of-4 top-tier set (reference
    Topologies::hierarchicalQuorum, "Figure 3 from the paper")."""
    sim = Simulation(mode=mode, backend=backend)
    core_keys = _keys(4, b"hcore")
    core_q = SCPQuorumSet(
        threshold=3, validators=[k.public_key for k in core_keys],
        innerSets=[])
    core_names = [sim.add_node(k, core_q).name for k in core_keys]
    for i in range(4):
        for j in range(i + 1, 4):
            sim.connect(core_names[i], core_names[j])
    top_tier_inner = SCPQuorumSet(
        threshold=2, validators=[k.public_key for k in core_keys],
        innerSets=[])
    mid_keys = _keys(n_branches, b"hmid")
    for b in range(n_branches):
        mk = mid_keys[b]
        q = SCPQuorumSet(threshold=2, validators=[mk.public_key],
                         innerSets=[top_tier_inner])
        node = sim.add_node(mk, q)
        # round-robin connections into the core
        sim.connect(node.name, core_names[b % 4])
        sim.connect(node.name, core_names[(b + 1) % 4])
    return sim


def hierarchical_simplified(core_size: int = 4, n_outer: int = 4,
                            mode: int = Simulation.OVER_LOOPBACK,
                            backend: str = "cuda-resilient"
                            ) -> Simulation:
    """Core + outer validators whose flat qsets are {self + core} at
    Byzantine-safe threshold (reference
    Topologies::hierarchicalQuorumSimplified)."""
    sim = Simulation(mode=mode, backend=backend)
    core_keys = _keys(core_size, b"hsimp")
    core_q = SCPQuorumSet(
        threshold=(core_size * 3 + 3) // 4,
        validators=[k.public_key for k in core_keys], innerSets=[])
    core_names = [sim.add_node(k, core_q).name for k in core_keys]
    for i in range(core_size):
        for j in range(i + 1, core_size):
            sim.connect(core_names[i], core_names[j])
    n = core_size + 1
    outer_keys = _keys(n_outer, b"houter")
    for i in range(n_outer):
        ok = outer_keys[i]
        q = SCPQuorumSet(
            threshold=n - (n - 1) // 3,
            validators=[k.public_key for k in core_keys] + [ok.public_key],
            innerSets=[])
        node = sim.add_node(ok, q)
        sim.connect(node.name, core_names[i % core_size])
        sim.connect(node.name, core_names[(i + 1) % core_size])
    return sim
