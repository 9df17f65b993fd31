"""Catchup range arithmetic.

Copied from `stellar_core_tpu/catchup/range.py` at commit 65439bf; carry
a fix in either copy to the other.

Role parity: reference `src/catchup/CatchupConfiguration.{h,cpp}` and
`src/catchup/CatchupRange.{h,cpp}` — given (lcl, target ledger, count),
decide whether to fast-forward state by applying a bucket snapshot at a
checkpoint boundary and how many ledgers to replay after it.

Modes (reference CommandLine catchup `<to>/<count>` syntax):
  count >= target  → CATCHUP_COMPLETE: replay everything from the LCL.
  count == 0       → CATCHUP_MINIMAL: buckets at the newest possible
                      checkpoint, replay only the tail.
  else             → CATCHUP_RECENT: buckets then replay `count` ledgers.
"""

from __future__ import annotations

from ..history.checkpoints import (DEFAULT_FREQUENCY, checkpoint_containing,
                                   is_last_in_checkpoint)

CURRENT = 0xFFFFFFFF  # "catch up to the archive tip" sentinel


class CatchupConfiguration:
    def __init__(self, to_ledger: int = CURRENT, count: int = CURRENT
                 ) -> None:
        self.to_ledger = to_ledger
        self.count = count

    @classmethod
    def complete(cls) -> "CatchupConfiguration":
        return cls(CURRENT, CURRENT)

    @classmethod
    def minimal(cls) -> "CatchupConfiguration":
        return cls(CURRENT, 0)

    @classmethod
    def recent(cls, count: int) -> "CatchupConfiguration":
        return cls(CURRENT, count)

    def resolve(self, archive_tip: int) -> "CatchupConfiguration":
        to = archive_tip if self.to_ledger == CURRENT else self.to_ledger
        return CatchupConfiguration(to, self.count)


class CatchupRange:
    """The resolved plan: optionally apply buckets at `apply_buckets_at`
    (a checkpoint ledger), then replay [replay_first..replay_last]."""

    def __init__(self, apply_buckets: bool, apply_buckets_at: int,
                 replay_first: int, replay_last: int) -> None:
        self.apply_buckets = apply_buckets
        self.apply_buckets_at = apply_buckets_at
        self.replay_first = replay_first
        self.replay_last = replay_last

    def replay_count(self) -> int:
        if self.replay_first > self.replay_last:
            return 0
        return self.replay_last - self.replay_first + 1

    def __repr__(self) -> str:
        return ("CatchupRange(buckets@%s, replay %d..%d)"
                % (self.apply_buckets_at if self.apply_buckets else "-",
                   self.replay_first, self.replay_last))


def calculate_catchup_range(lcl: int, cfg: CatchupConfiguration,
                            freq: int = DEFAULT_FREQUENCY) -> CatchupRange:
    """Reference `CatchupRange::CatchupRange` (CatchupRange.cpp): prefer
    pure replay when the LCL is close enough (or count covers the gap);
    otherwise bucket-apply at the newest checkpoint that still leaves
    >= count ledgers to replay."""
    target = cfg.to_ledger
    assert target > lcl, "nothing to catch up (target %d <= lcl %d)" \
        % (target, lcl)
    gap = target - lcl
    if cfg.count >= gap:
        return CatchupRange(False, 0, lcl + 1, target)

    # earliest ledger we are obliged to replay
    first_replay = target - cfg.count + 1 if cfg.count > 0 else target + 1
    # bucket-apply point: a checkpoint ledger strictly before first_replay,
    # as late as possible
    c = checkpoint_containing(first_replay - 1, freq)
    if c >= first_replay:
        c -= freq
    if c <= lcl:
        # LCL already past every usable checkpoint: pure replay
        return CatchupRange(False, 0, lcl + 1, target)
    assert is_last_in_checkpoint(c, freq)
    return CatchupRange(True, c, c + 1, target)
