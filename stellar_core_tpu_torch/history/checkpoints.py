"""Checkpoint arithmetic.

Copied from `stellar_core_tpu/history/checkpoints.py` at commit 17156c3;
carry a fix in either copy to the other.

Role parity: reference `src/history/HistoryManagerImpl.cpp:85-133` —
history is published in checkpoints of CHECKPOINT_FREQUENCY (64) ledgers;
a checkpoint is named by its last ledger (63, 127, 191, ...; the first
spans genesis..63).
"""

from __future__ import annotations

DEFAULT_FREQUENCY = 64


def checkpoint_containing(ledger: int, freq: int = DEFAULT_FREQUENCY) -> int:
    """Last ledger of the checkpoint that contains `ledger`."""
    return (ledger // freq) * freq + freq - 1


def is_last_in_checkpoint(ledger: int, freq: int = DEFAULT_FREQUENCY) -> bool:
    return (ledger + 1) % freq == 0


def first_in_checkpoint(checkpoint: int,
                        freq: int = DEFAULT_FREQUENCY) -> int:
    """First ledger included in the checkpoint named `checkpoint`
    (genesis checkpoint starts at ledger 1)."""
    assert is_last_in_checkpoint(checkpoint, freq)
    return max(1, checkpoint + 1 - freq)


def prev_checkpoint(checkpoint: int, freq: int = DEFAULT_FREQUENCY) -> int:
    return checkpoint - freq


def checkpoints_in_range(first_ledger: int, last_ledger: int,
                         freq: int = DEFAULT_FREQUENCY):
    """Checkpoint ledgers covering [first_ledger, last_ledger]."""
    c = checkpoint_containing(first_ledger, freq)
    while c - freq + 1 <= last_ledger:
        yield c
        c += freq
