"""Partitioned logging.

Copied from `stellar_core_tpu/util/log.py` at commit 9a356c0; carry a fix in
either copy to the other.

Role parity: reference `src/util/Logging.h:25-36` (easylogging++ behind a
Logging facade with per-partition levels, runtime settable via HTTP `ll`).
"""

from __future__ import annotations

import logging
import sys

PARTITIONS = [
    "Fs", "SCP", "Bucket", "Database", "History", "Process", "Ledger",
    "Overlay", "Herder", "Tx", "LoadGen", "Work", "Invariant", "Perf",
    "Fault",
]

_FMT = "%(asctime)s [%(name)s %(levelname)s] %(message)s"
_initialized = False


def init_logging(level: int = logging.INFO) -> None:
    global _initialized
    if _initialized:
        return
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(_FMT))
    root = logging.getLogger("stellar")
    root.addHandler(h)
    root.setLevel(level)
    root.propagate = False
    _initialized = True


def get_logger(partition: str) -> logging.Logger:
    init_logging()
    assert partition in PARTITIONS, partition
    return logging.getLogger("stellar.%s" % partition)


_LEVELS = {
    "trace": logging.DEBUG, "debug": logging.DEBUG, "info": logging.INFO,
    "warning": logging.WARNING, "error": logging.ERROR, "fatal": logging.CRITICAL,
    "none": logging.CRITICAL + 10,
}


def set_log_level(partition: str | None, level_name: str) -> None:
    """Runtime log-level control (HTTP `ll` command parity)."""
    lv = _LEVELS[level_name.lower()]
    if partition is None:
        logging.getLogger("stellar").setLevel(lv)
    else:
        get_logger(partition).setLevel(lv)


def get_log_levels() -> dict:
    out = {}
    for p in PARTITIONS:
        lg = logging.getLogger("stellar.%s" % p)
        out[p] = logging.getLevelName(lg.getEffectiveLevel())
    return out
