"""StateSnapshot: materialize one checkpoint's files from the database.

Copied from `stellar_core_tpu/history/snapshot.py` at commit 17156c3;
carry a fix in either copy to the other. `statement_qset_hash` is the
reference herder's (`herder/pending_envelopes.py`), copied here until
the herder is ported.

Role parity: reference `src/history/StateSnapshot.{h,cpp}` — per
checkpoint writes four XDR streams (ledger headers, transactions,
results, SCP messages) plus the HistoryArchiveState JSON and the bucket
files it names; reference WriteSnapshotWork runs this on a worker thread.
"""

from __future__ import annotations

import gzip
import os
from typing import List, Optional

from ..crypto.hashing import sha256
from ..util.log import get_logger
from ..util.xdrstream import XDROutputFileStream
from ..xdr import (
    LedgerHeader, LedgerHeaderHistoryEntry, LedgerSCPMessages, SCPEnvelope,
    SCPHistoryEntry, SCPHistoryEntryV0, SCPQuorumSet, SCPStatementType,
    TransactionEnvelope, TransactionHistoryEntry,
    TransactionHistoryResultEntry, TransactionSet, TransactionResultPair,
    TransactionResultSet, _Ext,
)
from .archive_state import HistoryArchiveState
from .checkpoints import first_in_checkpoint

log = get_logger("History")


def statement_qset_hash(st) -> bytes:
    """The quorum-set hash an SCP statement names (copied from
    `stellar_core_tpu/herder/pending_envelopes.py` at commit a09415e)."""
    t = st.pledges.disc
    if t == SCPStatementType.SCP_ST_EXTERNALIZE:
        return st.pledges.value.commitQuorumSetHash
    return st.pledges.value.quorumSetHash


def gzip_file(path: str) -> str:
    out = path + ".gz"
    with open(path, "rb") as f, gzip.open(out, "wb", compresslevel=6) as g:
        g.write(f.read())
    return out


def gunzip_file(path: str) -> str:
    assert path.endswith(".gz")
    out = path[:-3]
    with gzip.open(path, "rb") as g, open(out, "wb") as f:
        f.write(g.read())
    return out


class StateSnapshot:
    """Writes checkpoint files into a staging dir; the publish work then
    gzips and uploads them."""

    def __init__(self, app, checkpoint: int, has: HistoryArchiveState,
                 staging_dir: str) -> None:
        self.app = app
        self.checkpoint = checkpoint
        self.has = has
        self.dir = staging_dir
        os.makedirs(staging_dir, exist_ok=True)

    def _path(self, category: str, suffix: str = ".xdr") -> str:
        return os.path.join(self.dir, "%s-%08x%s"
                            % (category, self.checkpoint, suffix))

    # -- writers -------------------------------------------------------------
    def write_ledger_headers(self) -> str:
        db = self.app.database
        lo = first_in_checkpoint(self.checkpoint,
                                 self.app.config.CHECKPOINT_FREQUENCY)
        path = self._path("ledger")
        with XDROutputFileStream(path) as out:
            for (h, data) in db.execute(
                    "SELECT ledgerhash, data FROM ledgerheaders WHERE "
                    "ledgerseq BETWEEN ? AND ? ORDER BY ledgerseq",
                    (lo, self.checkpoint)).fetchall():
                out.write_one(LedgerHeaderHistoryEntry,
                              LedgerHeaderHistoryEntry(
                                  hash=bytes.fromhex(h),
                                  header=LedgerHeader.from_xdr(data),
                                  ext=_Ext.v0()))
        return path

    def write_transactions(self) -> str:
        db = self.app.database
        lo = first_in_checkpoint(self.checkpoint,
                                 self.app.config.CHECKPOINT_FREQUENCY)
        path = self._path("transactions")
        with XDROutputFileStream(path) as out:
            for seq in range(lo, self.checkpoint + 1):
                rows = db.execute(
                    "SELECT txbody FROM txhistory WHERE ledgerseq = ? "
                    "ORDER BY txindex", (seq,)).fetchall()
                if not rows:
                    continue
                prev = db.execute(
                    "SELECT prevhash FROM ledgerheaders WHERE ledgerseq = ?",
                    (seq,)).fetchone()
                prev_hash = bytes.fromhex(prev[0]) if prev else b"\x00" * 32
                txs = [TransactionEnvelope.from_xdr(r[0]) for r in rows]
                out.write_one(TransactionHistoryEntry, TransactionHistoryEntry(
                    ledgerSeq=seq,
                    txSet=TransactionSet(previousLedgerHash=prev_hash,
                                         txs=txs),
                    ext=_Ext.v0()))
        return path

    def write_results(self) -> str:
        db = self.app.database
        lo = first_in_checkpoint(self.checkpoint,
                                 self.app.config.CHECKPOINT_FREQUENCY)
        path = self._path("results")
        with XDROutputFileStream(path) as out:
            for seq in range(lo, self.checkpoint + 1):
                rows = db.execute(
                    "SELECT txresult FROM txhistory WHERE ledgerseq = ? "
                    "ORDER BY txindex", (seq,)).fetchall()
                if not rows:
                    continue
                results = [TransactionResultPair.from_xdr(r[0])
                           for r in rows]
                out.write_one(
                    TransactionHistoryResultEntry,
                    TransactionHistoryResultEntry(
                        ledgerSeq=seq,
                        txResultSet=TransactionResultSet(results=results),
                        ext=_Ext.v0()))
        return path

    def write_scp_messages(self) -> str:
        db = self.app.database
        lo = first_in_checkpoint(self.checkpoint,
                                 self.app.config.CHECKPOINT_FREQUENCY)
        path = self._path("scp")
        with XDROutputFileStream(path) as out:
            for seq in range(lo, self.checkpoint + 1):
                rows = db.execute(
                    "SELECT envelope FROM scphistory WHERE ledgerseq = ?",
                    (seq,)).fetchall()
                if not rows:
                    continue
                msgs = [SCPEnvelope.from_xdr(r[0]) for r in rows]
                qhashes = set()
                qsets: List[SCPQuorumSet] = []
                for env in msgs:
                    qh = statement_qset_hash(env.statement)
                    if qh in qhashes:
                        continue
                    qrow = db.execute(
                        "SELECT qset FROM scpquorums WHERE qsethash = ?",
                        (qh.hex(),)).fetchone()
                    if qrow:
                        qhashes.add(qh)
                        qsets.append(SCPQuorumSet.from_xdr(qrow[0]))
                out.write_one(SCPHistoryEntry, SCPHistoryEntry(
                    0, SCPHistoryEntryV0(
                        quorumSets=qsets,
                        ledgerMessages=LedgerSCPMessages(
                            ledgerSeq=seq, messages=msgs))))
        return path

    def write_has(self) -> str:
        path = self._path("history", ".json")
        with open(path, "w") as f:
            f.write(self.has.to_json())
        return path

    def bucket_files(self) -> List[str]:
        """Paths of the bucket files the HAS references (from the bucket
        manager's content-addressed store)."""
        bm = self.app.bucket_manager
        out = []
        if bm is None:
            return out
        for hh in self.has.bucket_hashes():
            b = bm.get_bucket_by_hash(bytes.fromhex(hh))
            if b is None:
                log.warning("snapshot missing bucket %s", hh[:8])
                continue
            if not b.path:
                # in-memory-only store: stage the bucket beside the streams
                p = os.path.join(self.dir, "bucket-%s.xdr" % hh)
                b.write_to(p)
            out.append(b.path)
        return out

    def write_all(self) -> dict:
        return {
            "ledger": self.write_ledger_headers(),
            "transactions": self.write_transactions(),
            "results": self.write_results(),
            "scp": self.write_scp_messages(),
            "has": self.write_has(),
            "buckets": self.bucket_files(),
        }
