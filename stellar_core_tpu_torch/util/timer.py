"""The sanctioned real clock.

Copied (`real_monotonic` only) from `stellar_core_tpu/util/timer.py` at
commit 02ed56d; carry a fix in either copy to the other. `VirtualClock`
arrives with the node-stack slice; code that needs deterministic time
takes a `now_fn` instead.
"""

from __future__ import annotations

import time as _time


def real_monotonic() -> float:
    """Wall-clock monotonic seconds: for code that measures real elapsed
    time with no app clock injected (breaker defaults, staging overlap)."""
    return _time.monotonic()
