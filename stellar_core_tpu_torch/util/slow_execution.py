"""LogSlowExecution: warn when a scoped operation overruns its budget.

Copied from `stellar_core_tpu/util/slow_execution.py` at commit c3880fc;
carry a fix in either copy to the other.

Role parity: reference `src/util/LogSlowExecution.h` — a scope timer
that logs on destruction when elapsed time exceeds a threshold, used by
`LedgerManagerImpl::closeLedger` (:526-528) so operators see slow closes
in the "Perf" partition without tracing.
"""

from __future__ import annotations

import time

from .log import get_logger

log = get_logger("Perf")

DEFAULT_THRESHOLD = 1.0  # seconds (reference default: 1s)


class LogSlowExecution:
    """Context manager: `with LogSlowExecution("ledger close"):` logs a
    warning if the body takes longer than `threshold` seconds.

    `on_slow(elapsed)` fires on overrun after the log line — the
    slow-close watchdog hook the flight recorder hangs off (a close that
    blows its budget leaves a span+metrics snapshot behind). It must not
    raise into the traced scope."""

    def __init__(self, name: str,
                 threshold: float = DEFAULT_THRESHOLD,
                 on_slow=None) -> None:
        self.name = name
        self.threshold = threshold
        self.elapsed = 0.0
        self.on_slow = on_slow

    def __enter__(self) -> "LogSlowExecution":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.elapsed = time.perf_counter() - self._t0
        if self.elapsed > self.threshold:
            log.warning("%s hung for %.3fs (threshold %.1fs)",
                        self.name, self.elapsed, self.threshold)
            if self.on_slow is not None:
                try:
                    self.on_slow(self.elapsed)
                except Exception as e:   # noqa: BLE001
                    log.error("slow-execution hook failed: %s", e)
        return False
