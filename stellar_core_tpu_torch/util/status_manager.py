"""Rolled-up per-subsystem status lines.

Copied from `stellar_core_tpu/util/status_manager.py` at commit 183ecd9;
carry a fix in either copy to the other. The `info` endpoint renders the
lines (`main/application.py`'s `get_info`).

Role parity: reference `src/util/StatusManager.{h,cpp}` — a small
category→message map; subsystems keep one human-readable line each
(publish backlog, catchup progress, armed upgrades).
"""


from __future__ import annotations

from typing import Dict, Iterator, Tuple

from .log import get_logger

log = get_logger("History")


class StatusCategory:
    HISTORY_CATCHUP = 0
    HISTORY_PUBLISH = 1
    NTP = 2
    REQUIRES_UPGRADES = 3


class StatusManager:
    def __init__(self) -> None:
        self._messages: Dict[int, str] = {}

    def set_status_message(self, category: int, message: str) -> None:
        """Idempotent: a change is logged once, a repeat is silent
        (reference call sites compare before set; centralized here)."""
        if self._messages.get(category) == message:
            return
        self._messages[category] = message
        log.info("%s", message)

    def remove_status_message(self, category: int) -> None:
        self._messages.pop(category, None)

    def get_status_message(self, category: int) -> str:
        return self._messages.get(category, "")

    def __iter__(self) -> Iterator[Tuple[int, str]]:
        return iter(sorted(self._messages.items()))

    def __len__(self) -> int:
        return len(self._messages)

    def to_list(self) -> list:
        """The info endpoint's "status" array (category order, like the
        reference's map iteration)."""
        return [msg for _cat, msg in self]
