"""Global deterministic RNG, reseedable per test.

Copied from `stellar_core_tpu/util/rnd.py` at commit a7226ae; carry a fix
in either copy to the other. Nothing is left out.

Role parity: reference `src/util/Math.cpp` gRandomEngine + the Catch listener
that reseeds before every test case (src/test/test.cpp:47-68).
"""

from __future__ import annotations

import random

g_random = random.Random(0)


def reseed(seed: int) -> None:
    g_random.seed(seed)


def rand_int(lo: int, hi: int) -> int:
    """Uniform in [lo, hi]."""
    return g_random.randint(lo, hi)


def rand_fraction() -> float:
    return g_random.random()


def rand_flip() -> bool:
    return g_random.random() < 0.5


def rand_bytes(n: int) -> bytes:
    return bytes(g_random.getrandbits(8) for _ in range(n))


def rand_element(seq):
    return seq[g_random.randrange(len(seq))]
