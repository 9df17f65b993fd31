"""Catchup: archive-driven recovery (reference `src/catchup`).

Copied from `stellar_core_tpu/catchup/__init__.py` at commit 378eae4;
carry a fix in either copy to the other."""

from .catchup_manager import CatchupManager
from .catchup_work import CatchupWork
from .range import (CURRENT, CatchupConfiguration, CatchupRange,
                    calculate_catchup_range)

__all__ = [
    "CURRENT", "CatchupConfiguration", "CatchupManager", "CatchupRange",
    "CatchupWork", "calculate_catchup_range",
]
