"""Global deterministic RNG.

Copied from `stellar_core_tpu/util/rnd.py` at commit a7226ae; carry a fix
in either copy to the other. Kept: `g_random` (what
`SecretKey.pseudo_random_for_testing` and overlay draw from) and
`rand_bytes` (overlay's `Peer` draws its handshake nonces from it); the
reference's `reseed` and other `rand_*` helpers come back with their
first caller.

Role parity: reference `src/util/Math.cpp` gRandomEngine.
"""

from __future__ import annotations

import random

g_random = random.Random(0)


def rand_bytes(n: int) -> bytes:
    return bytes(g_random.getrandbits(8) for _ in range(n))
