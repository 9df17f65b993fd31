"""HistoryManager: queue and publish checkpoints.

Copied from `stellar_core_tpu/history/history_manager.py` at commit
9a356c0; carry a fix in either copy to the other.

Role parity: reference `src/history/HistoryManagerImpl.{h,cpp}` — every
CHECKPOINT_FREQUENCY ledgers the close path queues a checkpoint inside the
ledger-close DB transaction (crash-safe: LedgerManagerImpl.cpp:681-710),
then publishes after commit. Archives with `put` commands receive the
files; multiple archives each get a copy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ..util.log import get_logger
from ..util.tmpdir import TmpDir
from .archive import (ArchivePool, HistoryArchive, WELL_KNOWN, bucket_path,
                      category_path)
from .archive_state import HistoryArchiveState
from .checkpoints import is_last_in_checkpoint
from .snapshot import StateSnapshot, gzip_file

log = get_logger("History")


class HistoryManager:
    def __init__(self, app) -> None:
        self.app = app
        self.archives: Dict[str, HistoryArchive] = {}
        for name, d in app.config.HISTORY.items():
            self.archives[name] = HistoryArchive.from_config(name, d)
        self.publish_queue_dir = TmpDir("history-publish")
        self.published_checkpoints = 0
        self.failed_publishes = 0
        self._readable_pool: Optional[ArchivePool] = None

    # -- archive selection ---------------------------------------------------
    def add_archive(self, archive: HistoryArchive) -> None:
        self.archives[archive.name] = archive
        self._readable_pool = None   # rebuilt on next readable_pool()

    def writable_archives(self) -> List[HistoryArchive]:
        return [a for a in self.archives.values() if a.has_put()]

    def readable_archive(self) -> Optional[HistoryArchive]:
        for a in self.archives.values():
            if a.has_get():
                return a
        return None

    def readable_pool(self) -> Optional[ArchivePool]:
        """All readable archives behind one health-scored failover pool
        (docs/robustness.md). One pool instance per manager, so health
        accumulated by one catchup informs the next."""
        pool = getattr(self, "_readable_pool", None)
        if pool is None:
            readable = [a for a in self.archives.values() if a.has_get()]
            if not readable:
                return None
            pool = ArchivePool(readable, now_fn=self.app.clock.now,
                               metrics=getattr(self.app, "metrics", None))
            self._readable_pool = pool
        return pool

    def has_any_writable_history_archive(self) -> bool:
        return bool(self.writable_archives())

    # -- queueing (called inside ledger close) ------------------------------
    def maybe_queue_checkpoint(self, ledger_manager) -> None:
        seq = ledger_manager.last_closed_ledger_num()
        freq = self.app.config.CHECKPOINT_FREQUENCY
        if not is_last_in_checkpoint(seq, freq):
            return
        if not self.has_any_writable_history_archive():
            return
        db = getattr(self.app, "database", None)
        bm = getattr(self.app, "bucket_manager", None)
        has = HistoryArchiveState.from_bucket_list(
            seq, bm.bucket_list) if bm is not None else \
            HistoryArchiveState(seq)
        if db is not None:
            db.execute(
                "INSERT OR REPLACE INTO publishqueue (ledgerseq, state) "
                "VALUES (?,?)", (seq, has.to_json()))
            db.commit()
        else:
            self._mem_queue = getattr(self, "_mem_queue", {})
            self._mem_queue[seq] = has
        log.info("queued checkpoint %d for publication", seq)
        # publish outside the close path
        self.app.clock.post(self.publish_queued_history)

    def publish_queue(self) -> List[int]:
        db = getattr(self.app, "database", None)
        if db is not None:
            return [r[0] for r in db.execute(
                "SELECT ledgerseq FROM publishqueue ORDER BY ledgerseq"
            ).fetchall()]
        return sorted(getattr(self, "_mem_queue", {}))

    def _queued_has(self, seq: int) -> Optional[HistoryArchiveState]:
        db = getattr(self.app, "database", None)
        if db is not None:
            row = db.execute(
                "SELECT state FROM publishqueue WHERE ledgerseq = ?",
                (seq,)).fetchone()
            return HistoryArchiveState.from_json(row[0]) if row else None
        return getattr(self, "_mem_queue", {}).get(seq)

    def _dequeue(self, seq: int) -> None:
        db = getattr(self.app, "database", None)
        if db is not None:
            db.execute("DELETE FROM publishqueue WHERE ledgerseq = ?",
                       (seq,))
            db.commit()
        else:
            getattr(self, "_mem_queue", {}).pop(seq, None)

    # -- publishing ----------------------------------------------------------
    def publish_queued_history(self) -> int:
        """Publish every queued checkpoint synchronously-in-order via the
        work scheduler's process path. Returns checkpoints published."""
        n = 0
        for seq in self.publish_queue():
            if self._publish_one(seq):
                self._dequeue(seq)
                self.published_checkpoints += 1
                n += 1
            else:
                self.failed_publishes += 1
                break                # retry next time, keep order
        self._update_publish_status()
        return n

    def _update_publish_status(self) -> None:
        """One rolled-up line about the publish backlog (reference
        HistoryManagerImpl::logAndUpdatePublishStatus:104-122)."""
        from ..util.status_manager import StatusCategory
        sm = getattr(self.app, "status_manager", None)
        if sm is None:
            return
        queue = self.publish_queue()
        if queue:
            sm.set_status_message(
                StatusCategory.HISTORY_PUBLISH,
                "Publishing %d queued checkpoints [%s]" % (
                    len(queue), ", ".join(str(s) for s in queue[:8])))
        else:
            sm.remove_status_message(StatusCategory.HISTORY_PUBLISH)

    def _publish_one(self, checkpoint: int) -> bool:
        has = self._queued_has(checkpoint)
        if has is None:
            return True
        staging = os.path.join(self.publish_queue_dir.path,
                               "%08x" % checkpoint)
        snap = StateSnapshot(self.app, checkpoint, has, staging)
        files = snap.write_all()
        ok_all = True
        for archive in self.writable_archives():
            ok = self._put_snapshot(archive, checkpoint, has, files)
            ok_all = ok_all and ok
            if ok:
                m = getattr(self.app, "metrics", None)
                if m is not None:
                    m.new_meter("history.publish.success").mark()
                log.info("published checkpoint %d to %s", checkpoint,
                         archive.name)
        return ok_all

    def _put_snapshot(self, archive: HistoryArchive, checkpoint: int,
                      has: HistoryArchiveState, files: dict) -> bool:
        for category in ("ledger", "transactions", "results", "scp"):
            src = files[category]
            if not os.path.exists(src):
                continue
            gz = gzip_file(src)
            if not archive.put_file_sync(
                    gz, category_path(category, checkpoint, ".xdr.gz")):
                return False
        for bpath in files["buckets"]:
            hh = os.path.basename(bpath).split("-")[1].split(".")[0]
            gz = gzip_file(bpath)
            if not archive.put_file_sync(gz, bucket_path(hh)):
                return False
        if not archive.put_file_sync(
                files["has"], category_path("history", checkpoint, ".json")):
            return False
        return archive.put_file_sync(files["has"], WELL_KNOWN)
