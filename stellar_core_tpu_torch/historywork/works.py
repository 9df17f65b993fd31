"""History work units: remote file transfer, (de)compression, archive
state fetch, batched checkpoint downloads, ledger-chain verification.

Copied from `stellar_core_tpu/historywork/works.py` at commit 9a356c0;
carry a fix in either copy to the other. Bucket identity hashes stay on
`hashlib` (`Bucket.read_from`), as in the reference.

Role parity: reference `src/historywork/*` — `GetRemoteFileWork` /
`PutRemoteFileWork` / `MakeRemoteDirWork` shell out through the process
manager (`GetRemoteFileWork.cpp`), `GunzipFileWork`/`GzipFileWork`
(`GunzipFileWork.cpp`), `GetAndUnzipRemoteFileWork.cpp`,
`BatchDownloadWork.cpp` (bounded-parallel per-checkpoint downloads),
`VerifyBucketWork.cpp` (hash downloaded bucket), and
`VerifyLedgerChainWork.cpp` (hash-chain back-link verification).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ..crypto.hashing import sha256
from ..history.archive import (ArchivePool, HistoryArchive, bucket_path,
                               category_path)
from ..history.archive_state import HistoryArchiveState
from ..history.checkpoints import checkpoints_in_range
from ..history.snapshot import gunzip_file, gzip_file
from ..util.log import get_logger
from ..util.xdrstream import XDRInputFileStream
from ..work.basic_work import (FAILURE, RETRY_A_FEW, RETRY_NEVER, RUNNING,
                               SUCCESS, WAITING, BasicWork, State)
from ..work.work import BatchWork, WorkSequence
from ..xdr import LedgerHeaderHistoryEntry

log = get_logger("History")


class RunCommandWork(BasicWork):
    """Run one shell command through the app's ProcessManager; the work
    WAITs until the subprocess exit event fires (reference
    `historywork/RunCommandWork.cpp`)."""

    def __init__(self, app, name: str, max_retries: int = RETRY_A_FEW
                 ) -> None:
        super().__init__(app.clock, name, max_retries)
        self.app = app
        self._ev = None
        self._exit_code: Optional[int] = None

    def get_command(self) -> str:
        raise NotImplementedError

    def on_reset(self) -> None:
        self._ev = None
        self._exit_code = None

    def on_run(self) -> State:
        if self._exit_code is not None:
            return SUCCESS if self._exit_code == 0 else FAILURE
        if self._ev is None:
            cmd = self.get_command()
            if not cmd:
                return FAILURE
            self._ev = self.app.process_manager.run_process(cmd)

            def done(code: int) -> None:
                self._exit_code = code
                self.wake_up()

            self._ev.add_done_callback(done)
        return WAITING


class GetRemoteFileWork(RunCommandWork):
    """Download archive:remote -> local (reference GetRemoteFileWork).

    `archive` may be a single HistoryArchive or an ArchivePool: with a
    pool, every attempt re-picks the healthiest archive not yet tried
    for THIS file, so a retry after a transport failure (or after a
    downstream corruption detection excluded the culprit) lands on a
    different archive (docs/robustness.md failover). Fault points
    `archive.get-fail` / `archive.corrupt` / `archive.short-read`
    (util/faults.py) simulate a broken transfer, a bit-flipped file and
    a truncated file respectively."""

    def __init__(self, app, archive, remote: str, local: str) -> None:
        super().__init__(app, "get-remote-file %s" % remote)
        self.archive = archive
        self.pool = archive if isinstance(archive, ArchivePool) else None
        self.current_archive: Optional[HistoryArchive] = \
            None if self.pool is not None else archive
        self._tried: List[str] = []   # archive names tried for this file
        self.remote = remote
        self.local = local

    def get_command(self) -> str:
        if self.pool is not None:
            self.current_archive = self.pool.pick(exclude=self._tried)
        if self.current_archive is None:
            return ""
        os.makedirs(os.path.dirname(self.local) or ".", exist_ok=True)
        return self.current_archive.get_cmd(self.remote, self.local)

    def exclude_current(self) -> None:
        """Mark the archive of the last attempt as tried (called by this
        work and by parents that detect corruption downstream)."""
        if self.current_archive is not None and \
                self.current_archive.name not in self._tried:
            self._tried.append(self.current_archive.name)

    def on_run(self) -> State:
        st = super().on_run()
        if st != SUCCESS:
            return st
        faults = getattr(self.app, "faults", None)
        if faults is not None:
            if faults.should_fire("archive.get-fail"):
                return FAILURE
            if faults.should_fire("archive.corrupt") and \
                    os.path.exists(self.local):
                size = os.path.getsize(self.local)
                with open(self.local, "r+b") as f:
                    if size:
                        f.seek(size // 2)
                        b = f.read(1)
                        f.seek(size // 2)
                        f.write(bytes([b[0] ^ 0xFF]))
                    else:
                        # an empty file "corrupts" by growing garbage
                        f.write(b"\xff")
            if faults.should_fire("archive.short-read") and \
                    os.path.exists(self.local):
                with open(self.local, "r+b") as f:
                    f.truncate(os.path.getsize(self.local) // 2)
        if self.pool is not None and self.current_archive is not None:
            self.pool.report_success(self.current_archive)
        return SUCCESS

    def on_failure_retry(self) -> None:
        if os.path.exists(self.local):
            os.unlink(self.local)
        if self.pool is not None and self.current_archive is not None:
            self.pool.report_failure(self.current_archive)
            self.exclude_current()

    def on_failure_raise(self) -> None:
        self.on_failure_retry()


class PutRemoteFileWork(RunCommandWork):
    """Upload local -> archive:remote (reference PutRemoteFileWork)."""

    def __init__(self, app, archive: HistoryArchive, local: str,
                 remote: str) -> None:
        super().__init__(app, "put-remote-file %s" % remote)
        self.archive = archive
        self.local = local
        self.remote = remote

    def get_command(self) -> str:
        return self.archive.put_cmd(self.local, self.remote)


class MakeRemoteDirWork(RunCommandWork):
    """mkdir -p on the archive (reference MakeRemoteDirWork)."""

    def __init__(self, app, archive: HistoryArchive, remote_dir: str
                 ) -> None:
        super().__init__(app, "make-remote-dir %s" % remote_dir)
        self.archive = archive
        self.remote_dir = remote_dir

    def get_command(self) -> str:
        return self.archive.mkdir_cmd(self.remote_dir)


class GunzipFileWork(BasicWork):
    """Decompress foo.gz -> foo in-process (reference GunzipFileWork
    shells out to gzip; python's gzip module plays that role)."""

    def __init__(self, app, gz_path: str, keep: bool = False) -> None:
        super().__init__(app.clock, "gunzip %s" % gz_path, RETRY_NEVER)
        self.gz_path = gz_path
        self.keep = keep

    def on_run(self) -> State:
        if not os.path.exists(self.gz_path):
            return FAILURE
        gunzip_file(self.gz_path)
        if not self.keep:
            os.unlink(self.gz_path)
        return SUCCESS


class GzipFileWork(BasicWork):
    """Compress foo -> foo.gz (reference GzipFileWork)."""

    def __init__(self, app, path: str, keep: bool = False) -> None:
        super().__init__(app.clock, "gzip %s" % path, RETRY_NEVER)
        self.path = path
        self.keep = keep

    def on_run(self) -> State:
        if not os.path.exists(self.path):
            return FAILURE
        gzip_file(self.path)
        if not self.keep:
            os.unlink(self.path)
        return SUCCESS


class GetAndUnzipRemoteFileWork(WorkSequence):
    """Download then gunzip, optionally verifying the sha256 of the
    decompressed file (reference GetAndUnzipRemoteFileWork). A failure
    detected AFTER the download succeeded — gunzip error on a truncated
    file, content-hash mismatch on a corrupted one — indicts the archive
    that served the bytes: it is reported to the pool and excluded, so
    the sequence retry re-downloads from a different archive."""

    def __init__(self, app, archive, remote_gz: str,
                 local: str, expected_hash: Optional[bytes] = None) -> None:
        self.local = local
        self.expected_hash = expected_hash
        self._get = GetRemoteFileWork(app, archive, remote_gz,
                                      local + ".gz")
        seq: List[BasicWork] = [
            self._get,
            GunzipFileWork(app, local + ".gz"),
        ]
        super().__init__(app.clock, "get-and-unzip %s" % remote_gz, seq)

    def on_run(self) -> State:
        st = super().on_run()
        if st == SUCCESS and self.expected_hash is not None:
            with open(self.local, "rb") as f:
                if sha256(f.read()) != self.expected_hash:
                    log.warning("hash mismatch on %s", self.local)
                    return FAILURE
        return st

    def _blame_archive(self) -> None:
        g = self._get
        # only a post-download failure is news here; a transport failure
        # already reported itself inside GetRemoteFileWork's own retries
        if g.state == State.SUCCESS and g.pool is not None and \
                g.current_archive is not None:
            g.pool.report_failure(g.current_archive)
            g.exclude_current()

    def on_failure_retry(self) -> None:
        self._blame_archive()
        for p in (self.local, self.local + ".gz"):
            if os.path.exists(p):
                os.unlink(p)

    def on_failure_raise(self) -> None:
        self._blame_archive()


class GetHistoryArchiveStateWork(BasicWork):
    """Fetch a HistoryArchiveState JSON — the well-known (archive tip) or
    a specific checkpoint's (reference GetHistoryArchiveStateWork)."""

    def __init__(self, app, archive, local_dir: str,
                 checkpoint: Optional[int] = None) -> None:
        super().__init__(app.clock, "get-history-archive-state",
                         RETRY_A_FEW)
        self.app = app
        self.archive = archive
        self.checkpoint = checkpoint
        self.local = os.path.join(
            local_dir,
            "has-%s.json" % ("well-known" if checkpoint is None
                             else "%08x" % checkpoint))
        self.has: Optional[HistoryArchiveState] = None
        self._get: Optional[GetRemoteFileWork] = None
        # archive names to avoid, SHARED into every inner download so a
        # corrupt-HAS blame survives this work's own retries (on_reset
        # rebuilds the download work)
        self._tried: List[str] = []

    def _remote(self) -> str:
        from ..history.archive import WELL_KNOWN
        if self.checkpoint is None:
            return WELL_KNOWN
        return category_path("history", self.checkpoint, ".json")

    def on_reset(self) -> None:
        self._get = None
        self.has = None

    def on_run(self) -> State:
        if self._get is None:
            self._get = GetRemoteFileWork(self.app, self.archive,
                                          self._remote(), self.local)
            self._get._tried = self._tried
            self._get._parent = self
            self._get.start()
        if not self._get.is_done():
            self._get.crank_work()
            if not self._get.is_done():
                return RUNNING if self._get.is_crankable() else WAITING
        if self._get.state != State.SUCCESS:
            return FAILURE
        try:
            with open(self.local) as f:
                self.has = HistoryArchiveState.from_json(f.read())
        except Exception as e:
            # the bytes arrived but don't parse: the serving archive is
            # corrupt for this file — blame it so the retry (our own
            # on_reset rebuilds the download) picks a different one
            log.warning("unparseable HistoryArchiveState from %s: %s",
                        getattr(self._get.current_archive, "name", "?"), e)
            g = self._get
            if g.pool is not None and g.current_archive is not None:
                g.pool.report_failure(g.current_archive)
                g.exclude_current()
            return FAILURE
        return SUCCESS


class BatchDownloadWork(BatchWork):
    """Download-and-unzip one category file per checkpoint over a ledger
    range, bounded-parallel (reference BatchDownloadWork.cpp)."""

    def __init__(self, app, archive, category: str,
                 first_ledger: int, last_ledger: int, download_dir: str,
                 max_concurrent: int = 8) -> None:
        super().__init__(app.clock, "batch-download %s [%d..%d]"
                         % (category, first_ledger, last_ledger),
                         max_concurrent)
        self.app = app
        self.archive = archive
        self.category = category
        self.download_dir = download_dir
        freq = app.config.CHECKPOINT_FREQUENCY
        self._checkpoints = list(checkpoints_in_range(
            first_ledger, last_ledger, freq))
        self._idx = 0

    def local_path(self, checkpoint: int) -> str:
        return os.path.join(self.download_dir, "%s-%08x.xdr"
                            % (self.category, checkpoint))

    def do_reset(self) -> None:
        self._idx = 0

    def yield_more_work(self) -> Optional[BasicWork]:
        if self._idx >= len(self._checkpoints):
            return None
        c = self._checkpoints[self._idx]
        self._idx += 1
        return GetAndUnzipRemoteFileWork(
            self.app, self.archive,
            category_path(self.category, c, ".xdr.gz"),
            self.local_path(c))


class VerifyBucketWork(BasicWork):
    """Hash a downloaded bucket file and compare to its content address
    (reference VerifyBucketWork runs the hash on a worker thread; one
    bucket per crank keeps the loop responsive here)."""

    def __init__(self, app, path: str, expected_hash: bytes) -> None:
        super().__init__(app.clock, "verify-bucket %s"
                         % expected_hash.hex()[:8], RETRY_NEVER)
        self.path = path
        self.expected_hash = expected_hash

    def on_run(self) -> State:
        from ..bucket.bucket import Bucket
        b = Bucket.read_from(self.path)
        if b.get_hash() != self.expected_hash:
            log.warning("bucket %s hash mismatch",
                        self.expected_hash.hex()[:8])
            return FAILURE
        return SUCCESS


class DownloadBucketsWork(BatchWork):
    """Fetch + verify + adopt every bucket a HAS references (reference
    DownloadBucketsWork.cpp). Buckets already in the local store are
    skipped (content addressing makes this safe)."""

    def __init__(self, app, archive, hashes: List[str],
                 download_dir: str, max_concurrent: int = 8) -> None:
        super().__init__(app.clock, "download-buckets(%d)" % len(hashes),
                         max_concurrent)
        self.app = app
        self.archive = archive
        self.download_dir = download_dir
        self._hashes = list(dict.fromkeys(hashes))  # dedup, keep order
        self._idx = 0

    def local_path(self, hash_hex: str) -> str:
        return os.path.join(self.download_dir,
                            "bucket-%s.xdr" % hash_hex)

    def do_reset(self) -> None:
        self._idx = 0

    def yield_more_work(self) -> Optional[BasicWork]:
        bm = self.app.bucket_manager
        while self._idx < len(self._hashes):
            hh = self._hashes[self._idx]
            self._idx += 1
            if bm is not None and \
                    bm.get_bucket_by_hash(bytes.fromhex(hh)) is not None:
                continue                      # already have it
            local = self.local_path(hh)
            seq: List[BasicWork] = [
                GetAndUnzipRemoteFileWork(self.app, self.archive,
                                          bucket_path(hh), local),
                VerifyBucketWork(self.app, local, bytes.fromhex(hh)),
            ]
            return WorkSequence(self.clock, "fetch-bucket %s" % hh[:8],
                                seq)
        return None

    def do_work(self) -> State:
        # adopt everything downloaded into the content-addressed store
        from ..bucket.bucket import Bucket
        bm = self.app.bucket_manager
        if bm is None:
            return SUCCESS
        for hh in self._hashes:
            if bm.get_bucket_by_hash(bytes.fromhex(hh)) is not None:
                continue
            path = self.local_path(hh)
            if os.path.exists(path):
                bm.adopt_bucket(Bucket.read_from(path))
        return SUCCESS


class VerifyLedgerChainWork(BasicWork):
    """Walk downloaded ledger-header files verifying the hash chain:
    every entry's hash must equal SHA256(header) and every header's
    previousLedgerHash must back-link the prior entry (reference
    VerifyLedgerChainWork.cpp; it walks newest→oldest, one checkpoint
    per crank — mirrored here oldest→newest, same predicate). An
    optional trusted (seq, hash) pins the top of the chain."""

    def __init__(self, app, download_dir: str, first_ledger: int,
                 last_ledger: int,
                 trusted: Optional[tuple] = None,
                 local_genesis: Optional[tuple] = None) -> None:
        super().__init__(app.clock, "verify-ledger-chain", RETRY_NEVER)
        self.app = app
        self.download_dir = download_dir
        self.first_ledger = first_ledger
        self.last_ledger = last_ledger
        self.trusted = trusted            # (seq, hash) to match exactly
        self.local_genesis = local_genesis  # (lcl_seq, lcl_hash) link check
        freq = app.config.CHECKPOINT_FREQUENCY
        self._checkpoints = list(checkpoints_in_range(
            first_ledger, last_ledger, freq))
        self._ci = 0
        self._prev: Optional[LedgerHeaderHistoryEntry] = None
        self._trusted_matched = False

    def on_reset(self) -> None:
        self._ci = 0
        self._prev = None
        self._trusted_matched = False

    def _entry_ok(self, e: LedgerHeaderHistoryEntry) -> bool:
        if sha256(e.header.to_xdr()) != e.hash:
            log.warning("header %d self-hash mismatch", e.header.ledgerSeq)
            return False
        if self._prev is not None:
            if e.header.ledgerSeq != self._prev.header.ledgerSeq + 1:
                # a seq gap would let a forged segment skip the back-link
                # check entirely — reject it outright
                log.warning("ledger seq gap: %d after %d",
                            e.header.ledgerSeq, self._prev.header.ledgerSeq)
                return False
            if e.header.previousLedgerHash != self._prev.hash:
                log.warning("chain break at %d", e.header.ledgerSeq)
                return False
        if self.local_genesis is not None:
            seq, hsh = self.local_genesis
            if e.header.ledgerSeq == seq + 1 and \
                    e.header.previousLedgerHash != hsh:
                log.warning("chain does not link local LCL %d", seq)
                return False
        return True

    def on_run(self) -> State:
        if self._ci >= len(self._checkpoints):
            if self.trusted is not None and not self._trusted_matched and \
                    self.first_ledger <= self.trusted[0] <= self.last_ledger:
                # the consensus anchor was inside the range but never seen
                log.warning("trusted hash %d absent from chain",
                            self.trusted[0])
                return FAILURE
            return SUCCESS
        c = self._checkpoints[self._ci]
        self._ci += 1
        path = os.path.join(self.download_dir, "ledger-%08x.xdr" % c)
        if not os.path.exists(path):
            return FAILURE
        with XDRInputFileStream(path) as ins:
            for e in ins.read_all(LedgerHeaderHistoryEntry):
                if not self._entry_ok(e):
                    return FAILURE
                if self.trusted is not None and \
                        e.header.ledgerSeq == self.trusted[0]:
                    if e.hash != self.trusted[1]:
                        log.warning("trusted hash mismatch at %d",
                                    e.header.ledgerSeq)
                        return FAILURE
                    self._trusted_matched = True
                self._prev = e
        return RUNNING
