"""Global deterministic RNG.

Copied from `stellar_core_tpu/util/rnd.py` at commit a7226ae; carry a fix
in either copy to the other. Only `g_random` is kept (what
`SecretKey.pseudo_random_for_testing` draws from); the reference's
`reseed` and `rand_*` helpers come back with their first caller.

Role parity: reference `src/util/Math.cpp` gRandomEngine.
"""

from __future__ import annotations

import random

g_random = random.Random(0)
