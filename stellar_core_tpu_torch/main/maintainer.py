"""Maintainer + ExternalQueue: bounded retention of historical rows.

Copied from `stellar_core_tpu/main/maintainer.py` at commit eee8012; carry
a fix in either copy to the other. Nothing is left out.

Role parity: reference `src/main/Maintainer.{h,cpp}` (periodic deletion
of old `scphistory`/`txhistory`/`txfeehistory` rows, timer-driven by
AUTOMATIC_MAINTENANCE_PERIOD/COUNT) and `src/main/ExternalQueue.{h,cpp}`
(the `pubsub` cursor table: downstream consumers advance a cursor per
resource id, and maintenance never deletes rows a consumer has not
acknowledged). Rows still needed by queued history publishes are also
retained.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..history.checkpoints import first_in_checkpoint
from ..util.log import get_logger
from ..util.timer import VirtualTimer

log = get_logger("History")


class ExternalQueue:
    """Cursor registry gating row GC (reference ExternalQueue.cpp)."""

    def __init__(self, app) -> None:
        self.app = app

    def _db(self):
        return getattr(self.app, "database", None)

    def set_cursor(self, resid: str, cursor: int) -> None:
        assert cursor >= 0
        db = self._db()
        if db is None:
            return
        db.execute("INSERT OR REPLACE INTO pubsub (resid, lastread) "
                   "VALUES (?,?)", (resid, cursor))
        db.commit()

    def get_cursors(self, resid: Optional[str] = None) -> Dict[str, int]:
        db = self._db()
        if db is None:
            return {}
        if resid:
            row = db.execute("SELECT lastread FROM pubsub WHERE resid=?",
                             (resid,)).fetchone()
            return {resid: row[0]} if row else {}
        return {r: c for r, c in
                db.execute("SELECT resid, lastread FROM pubsub")}

    def delete_cursor(self, resid: str) -> None:
        db = self._db()
        if db is None:
            return
        db.execute("DELETE FROM pubsub WHERE resid=?", (resid,))
        db.commit()

    def min_cursor(self) -> Optional[int]:
        cursors = self.get_cursors()
        return min(cursors.values()) if cursors else None


class Maintainer:
    def __init__(self, app) -> None:
        self.app = app
        self._timer = VirtualTimer(app.clock)
        self.rows_deleted = 0

    def start(self) -> None:
        """Arm periodic maintenance (reference Maintainer::start)."""
        period = self.app.config.AUTOMATIC_MAINTENANCE_PERIOD
        count = self.app.config.AUTOMATIC_MAINTENANCE_COUNT
        if period <= 0 or count <= 0:
            return

        def tick() -> None:
            self.perform_maintenance(count)
            self._timer.expires_from_now(period)
            self._timer.async_wait(tick)

        self._timer.expires_from_now(period)
        self._timer.async_wait(tick)

    def _retention_bound(self) -> int:
        """Highest ledgerseq (exclusive) safe to delete below."""
        app = self.app
        lcl = app.ledger_manager.last_closed_ledger_num()
        freq = app.config.CHECKPOINT_FREQUENCY
        # never delete rows a future checkpoint snapshot still needs
        bound = first_in_checkpoint(
            ((lcl // freq) * freq + freq - 1), freq)
        # nor rows a queued-but-unpublished checkpoint needs
        hm = getattr(app, "history_manager", None)
        if hm is not None:
            q = hm.publish_queue()
            if q:
                bound = min(bound, first_in_checkpoint(q[0], freq))
        # nor rows a downstream consumer hasn't read
        eq = getattr(app, "external_queue", None)
        if eq is not None:
            mc = eq.min_cursor()
            if mc is not None:
                bound = min(bound, mc + 1)
        return bound

    def perform_maintenance(self, count: int) -> int:
        """Delete up to `count` rows per table below the retention bound
        (reference Maintainer::performMaintenance)."""
        db = getattr(self.app, "database", None)
        if db is None:
            return 0
        bound = self._retention_bound()
        deleted = 0
        for table in ("scphistory", "txhistory", "txfeehistory"):
            cur = db.execute(
                "DELETE FROM %s WHERE ledgerseq < ? AND ledgerseq IN "
                "(SELECT ledgerseq FROM %s WHERE ledgerseq < ? "
                "ORDER BY ledgerseq LIMIT ?)" % (table, table),
                (bound, bound, count))
            deleted += cur.rowcount if cur.rowcount > 0 else 0
        db.commit()
        self.rows_deleted += deleted
        if deleted:
            log.debug("maintenance deleted %d rows below %d", deleted,
                      bound)
        return deleted
