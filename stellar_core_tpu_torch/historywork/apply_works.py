"""Apply-side history works: bucket-state restore and checkpoint replay.

Copied from `stellar_core_tpu/historywork/apply_works.py` at commit
89bbd6f; carry a fix in either copy to the other. Kept: the per-ledger
prewarm pipeline (`_PrewarmPipeline`, `_pipeline_enabled`,
`_pipeline_submit`, `_range_triples`, the `apply.pipeline-stall` fault and
`_prewarm_redundant`), which runs only on the C verifier (name "cpu") with
the apply engine: there the checkpoint drain is redundant (the engine
verifies each close's candidates in one call of its own), and the
pipeline verifies ledger N+1's on a worker while ledger N applies. A
pipelined drain that fails is logged and dropped, as in the reference:
it only warmed the cache, and the close verifies the same pairs again
through the engine, where a failure fails the close. Kept with the close
cockpit (`ledger/apply_stats.py` and the root's `prefetch`): the
checkpoint's entry-cache prefetch (`_prefetch_checkpoint`, one batched
BucketDB pass per level on a bucket-backed root) and its one summary line
per applied checkpoint (`_log_checkpoint_summary`). On every
other verifier (the card's stacks among them) each checkpoint drains its
signatures through the app's verifier in one `prewarm_many` (and once
more after a signer-set change); a drain that raises (a card fault, or a
breaker that refuses it) fails the checkpoint's work, and the drain is
never re-run on the CPU. Deliberately different: a checkpoint that fails
to apply fails the catchup at once. `DownloadApplyTxsWork` and each checkpoint's
download-and-apply sequence are RETRY_NEVER, as stellar-core builds them
(`DownloadApplyTxsWork.cpp`); the reference's take the default of 5
retries each, so a diverged replay or a refused drain is attempted 36
times, each attempt re-parsing the checkpoint and re-collecting its
signatures, though none can succeed. Downloads keep their own retries.

Role parity: reference `src/catchup/ApplyBucketsWork.cpp` (stream a
downloaded bucket-list snapshot into the ledger, then adopt it as the
live BucketList), `src/catchup/ApplyCheckpointWork.cpp:79-244` (stream
headers+txsets of one checkpoint, closing one ledger per crank via
`ApplyLedgerWork` → `LedgerManager::closeLedger`), and
`src/catchup/DownloadApplyTxsWork.cpp:23-104` (a BatchWork that overlaps
checkpoint N+1's download with checkpoint N's apply).

Batch site (SURVEY.md §3.4): before replaying a checkpoint, every
(source-key, signature, payload) triple in its txsets is drained through
`BatchSigVerifier.prewarm_many` in one padded device batch, pre-warming
the verify cache so the synchronous per-tx checks during apply all hit.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from ..history.archive import HistoryArchive, category_path
from ..history.archive_state import HistoryArchiveState, has_level_dicts
from ..history.checkpoints import checkpoints_in_range, first_in_checkpoint
from ..util.log import get_logger
from ..util.tracing import app_span
from ..util.xdrstream import XDRInputFileStream
from ..work.basic_work import (FAILURE, RETRY_NEVER, RUNNING, SUCCESS,
                               BasicWork, State)
from ..work.work import BatchWork, ConditionalWork, WorkSequence
from ..xdr import LedgerHeaderHistoryEntry, TransactionHistoryEntry
from .works import GetAndUnzipRemoteFileWork

log = get_logger("History")


class ApplyBucketsWork(BasicWork):
    """Load the bucket snapshot named by a HAS into ledger state and
    fast-forward the LCL to that checkpoint's header.

    Reference parity: `catchup/ApplyBucketsWork.cpp` + the LCL reset in
    `CatchupWork::applyBucketsAtLedger`. Divergence checks: the restored
    bucket list's hash must equal the downloaded header's bucketListHash,
    else the archive state is corrupt."""

    def __init__(self, app, has: HistoryArchiveState,
                 header_entry: LedgerHeaderHistoryEntry) -> None:
        super().__init__(app.clock, "apply-buckets@%d"
                         % header_entry.header.ledgerSeq, RETRY_NEVER)
        self.app = app
        self.has = has
        self.header_entry = header_entry

    def on_run(self) -> State:
        from ..bucket.applicator import apply_buckets
        from ..bucket.bucket import Bucket
        from ..crypto.hashing import SHA256

        bm = self.app.bucket_manager
        lm = self.app.ledger_manager
        header = self.header_entry.header

        # order: level 0 curr, 0 snap, 1 curr, ... (newest first)
        ordered: List[Bucket] = []
        for lv in self.has.levels:
            for hh in (lv.curr, lv.snap):
                if hh == "0" * 64:
                    continue
                b = (bm.get_bucket_by_hash(bytes.fromhex(hh))
                     if bm is not None else None)
                if b is None:
                    log.warning("apply-buckets: missing bucket %s", hh[:8])
                    return FAILURE
                ordered.append(b)

        # validate BEFORE destroying local state: the snapshot's whole-list
        # hash must already match the header (pure computation over the
        # level hashes, no mutation)
        whole = SHA256()
        for lv in self.has.levels:
            lh = SHA256()
            lh.add(bytes.fromhex(lv.curr))
            lh.add(bytes.fromhex(lv.snap))
            whole.add(lh.finish())
        if whole.finish() != header.bucketListHash:
            log.warning("snapshot bucket list hash mismatch at %d — "
                        "refusing to touch local state", header.ledgerSeq)
            return FAILURE

        # the snapshot IS the state: drop anything local first, else
        # entries deleted on-network during the gap would survive as
        # phantoms (reference resets ledger state before bucket apply);
        # the invalidated flag blocks direct closes until the LCL
        # fast-forward below lands (cleared in set_last_closed_ledger)
        lm.entries_invalidated = True
        lm.ltx_root().clear_entries()
        n = apply_buckets(lm.ltx_root(), ordered)
        log.info("applied %d bucket entries at ledger %d", n,
                 header.ledgerSeq)

        if bm is not None:
            bm.assume_state(has_level_dicts(self.has), header.ledgerSeq,
                            header.ledgerVersion)

        lm.set_last_closed_ledger(header, self.header_entry.hash)
        lm._store_local_has()   # restart between here and the next close
        # must re-adopt THIS bucket list, not the pre-catchup one
        return SUCCESS


def checkpoint_verify_triples(frames, ltx) -> List[Tuple]:
    """Collect (key32, sig, contents-HASH) triples for a batch of tx
    frames — the whole-ledger/checkpoint drain of SURVEY.md §2.2. The
    message is the tx contents hash, exactly what SignatureChecker later
    verifies over (reference signs/verifies sha256(networkID‖envType‖tx),
    SignatureUtils.cpp:27-36), so the prewarmed cache entries are the ones
    the apply path hits. Signer sets (master + account signers of every
    tx/op source) resolve through ledger state, so multisig txs prewarm
    too; signers added mid-checkpoint are caught by the per-ledger
    incremental prewarm (only signers added within the SAME ledger fall
    back to the sync path)."""
    from ..transactions.transaction_frame import frames_sig_triples
    return frames_sig_triples(ltx, frames)


class _PrewarmPipeline:
    """Pipelined catchup: ledger N+1's signature verification
    overlaps ledger N's apply. The MAIN thread collects the candidate
    triples (ledger reads stay single-threaded); the worker only runs
    `verifier.prewarm_many` — pure crypto whose native batch call drops
    the GIL, so it genuinely runs underneath the (also GIL-free) native
    apply. A prewarm is cache-warming only: stale or extra triples can
    never change an accept/reject decision, the apply path re-derives
    candidates against live state."""

    def __init__(self, verifier) -> None:
        import queue
        from ..util.threads import spawn_worker
        self._verifier = verifier
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._thread = spawn_worker("catchup.prewarm-pipeline", self._run)

    def submit(self, seq: int, triples) -> None:
        del seq
        self._q.put(triples)

    def close(self) -> None:
        # cancel flag first: queued-but-unstarted batches are stale
        # work the worker must skip (a reset/abort mid-checkpoint would
        # otherwise leave it verifying a whole checkpoint for nothing)
        self._closed = True
        self._q.put(None)

    def _run(self) -> None:
        while True:
            triples = self._q.get()
            if triples is None or self._closed:
                return
            try:
                self._verifier.prewarm_many(triples)
            except Exception:  # cache warm only: the close verifies again
                log.warning("pipelined prewarm failed", exc_info=True)


class ApplyCheckpointWork(BasicWork):
    """Replay one checkpoint's ledgers through LedgerManager.close_ledger,
    one ledger per crank (reference ApplyCheckpointWork.cpp:244 →
    ApplyLedgerWork.cpp:22-24). First crank drains the checkpoint's
    signatures through the batch verifier; on the cpu+native path the
    checkpoint-wide drain is replaced by the per-ledger prewarm
    pipeline (ledger N+1 verifies while N applies)."""

    def __init__(self, app, download_dir: str, checkpoint: int,
                 first_seq: int, last_seq: int) -> None:
        super().__init__(app.clock, "apply-checkpoint %08x" % checkpoint,
                         RETRY_NEVER)
        self.app = app
        self.download_dir = download_dir
        self.checkpoint = checkpoint
        self.first_seq = first_seq
        self.last_seq = last_seq
        self._loaded = False
        self._headers: Dict[int, LedgerHeaderHistoryEntry] = {}
        self._txsets: Dict[int, object] = {}
        self._frames: Dict[int, object] = {}   # seq -> TxSetFrame
        self._next: int = first_seq
        self._sig_state_dirty = False   # a signer set changed mid-checkpoint
        self._prefetch_summary: Optional[dict] = None
        self._pipeline: Optional[_PrewarmPipeline] = None

    def on_reset(self) -> None:
        self._loaded = False
        self._headers.clear()
        self._txsets.clear()
        self._frames.clear()
        self._next = self.first_seq
        self._sig_state_dirty = False
        self._prefetch_summary = None
        self._close_pipeline()

    def _close_pipeline(self) -> None:
        if self._pipeline is not None:
            self._pipeline.close()
            self._pipeline = None

    def _finish(self, st: State) -> None:
        self._close_pipeline()
        super()._finish(st)

    # -- pipelined per-ledger prewarm ---------------------------------------
    def _pipeline_enabled(self) -> bool:
        """Per-ledger pipelining replaces the checkpoint-wide drain
        exactly when that drain is redundant (sync CPU backend + native
        engine): there the verify cost sits INSIDE each close, and the
        only way to take it off the replay clock is to overlap it with
        the previous ledger's apply."""
        return self._prewarm_redundant()

    def _range_triples(self, first: int, last: int):
        """Candidate triples for a ledger range, collected on the MAIN
        thread against current state (one ltx + one signer cache for
        the whole batch)."""
        frames = []
        for seq in range(first, last + 1):
            fr = self._frames.get(seq)
            if fr is not None:
                frames.extend(fr.frames)
        if not frames:
            return []
        from ..ledger.ledgertxn import LedgerTxn
        ltx = LedgerTxn(self.app.ledger_manager.ltx_root())
        try:
            return checkpoint_verify_triples(frames, ltx)
        finally:
            ltx.rollback()

    def _pipeline_submit(self, first: int, last: int) -> None:
        """Hand the range's signature verification to the pipeline
        worker; the closes that follow overlap it. A prewarm is
        opportunistic — whatever the worker hasn't finished when a
        close needs it, the engine verifies synchronously (sharded),
        so there is no join barrier anywhere. The
        `apply.pipeline-stall` fault degrades to sequential: the
        collection still happens, the verify runs inline right here."""
        from ..util.faults import check_faults
        metrics = getattr(self.app, "metrics", None)
        triples = self._range_triples(first, last)
        if not triples:
            return
        if check_faults(self.app, "apply.pipeline-stall"):
            if metrics is not None:
                metrics.new_meter("catchup.pipeline.stall").mark()
            self.app.sig_verifier.prewarm_many(triples)
            return
        if self._pipeline is None:
            self._pipeline = _PrewarmPipeline(self.app.sig_verifier)
        if metrics is not None:
            metrics.new_meter("catchup.pipeline.prewarm").mark()
        self._pipeline.submit(first, triples)

    def _load(self) -> bool:
        """Read and decode the checkpoint's ledger headers and transaction
        sets, under the span `catchup.load_files` (one a load, whoever
        calls it)."""
        with app_span(self.app, "catchup.load_files", cat="catchup",
                      checkpoint=self.checkpoint):
            lpath = os.path.join(self.download_dir,
                                 "ledger-%08x.xdr" % self.checkpoint)
            tpath = os.path.join(self.download_dir,
                                 "transactions-%08x.xdr" % self.checkpoint)
            if not os.path.exists(lpath):
                return False
            with XDRInputFileStream(lpath) as ins:
                for e in ins.read_all(LedgerHeaderHistoryEntry):
                    self._headers[e.header.ledgerSeq] = e
            if os.path.exists(tpath):
                with XDRInputFileStream(tpath) as ins:
                    for t in ins.read_all(TransactionHistoryEntry):
                        self._txsets[t.ledgerSeq] = t.txSet
            return True

    def _prewarm_redundant(self) -> bool:
        """The checkpoint prewarm exists to batch crypto into one device
        dispatch AND to pre-resolve signer sets in Python. With the
        native apply engine active it resolves signer sets in C and
        feeds the verifier per tx, and on the synchronous CPU backend
        batching buys nothing — the whole Python collection pass is then
        pure overhead on the replay clock."""
        verifier = getattr(self.app, "sig_verifier", None)
        if getattr(verifier, "name", "") != "cpu":
            return False
        lm = self.app.ledger_manager
        if not getattr(lm, "use_native_apply", True):
            return False
        from ..native import apply_engine
        return apply_engine() is not None

    def _prewarm_frames(self, frames) -> None:
        """Collect candidate triples against CURRENT ledger state and
        drain them through the batch verifier (cached triples are skipped
        inside prewarm_many — a fully-covered call dispatches nothing)."""
        verifier = getattr(self.app, "sig_verifier", None)
        if verifier is None or not frames or self._prewarm_redundant():
            return
        from ..ledger.ledgertxn import LedgerTxn
        # sig-batch prep (triple collection + signer-set resolution) and
        # the verify drain trace separately: prep is host CPU, the drain
        # is the backend-attributed phase
        with app_span(self.app, "catchup.sig_prep", cat="catchup",
                      frames=len(frames)):
            ltx = LedgerTxn(self.app.ledger_manager.ltx_root())
            try:
                triples = checkpoint_verify_triples(frames, ltx)
            finally:
                ltx.rollback()
        if triples:
            verifier.prewarm_many(triples)

    def _prewarm(self) -> None:
        """One device batch for the whole checkpoint's signatures."""
        from ..herder.txset import TxSetFrame
        net = self.app.config.network_id
        frames = []
        with app_span(self.app, "catchup.txset_parse", cat="catchup",
                      checkpoint=self.checkpoint) as psp:
            for seq in range(self.first_seq, self.last_seq + 1):
                ts = self._txsets.get(seq)
                if ts is None:
                    continue
                fr = TxSetFrame.from_wire(net, ts)
                self._frames[seq] = fr       # reused at apply: parse once
                for f in fr.frames:          # history wire is immutable:
                    f.freeze_signatures()    # skip per-serialize fp checks
                frames.extend(fr.frames)
            psp.set_tag("txs", len(frames))
        self._prewarm_frames(frames)
        if self._pipeline_enabled():
            # cpu+native: the whole checkpoint's signature verification
            # rides the pipeline worker underneath the apply loop
            self._pipeline_submit(self.first_seq, self.last_seq)
        self._prefetch_checkpoint(frames)
        log.debug("prewarmed checkpoint %08x (%d txs)",
                  self.checkpoint, len(frames))

    def _prefetch_checkpoint(self, frames) -> None:
        """Bulk-warm the root entry cache with the whole checkpoint's
        statically-knowable touched keys (the ledger.apply.prefetch.*
        coverage metrics via LedgerTxnRoot)."""
        root = self.app.ledger_manager.ltx_root()
        if not frames or not hasattr(root, "prefetch"):
            return
        from ..ledger.apply_stats import txset_prefetch_keys
        keys = txset_prefetch_keys(frames)
        # prefetch() returns only NEWLY loaded keys; coverage (resident
        # after the pass / requested, already-warm included) comes from
        # the stats aggregates it feeds — delta around the call
        stats = getattr(self.app.ledger_manager, "apply_stats", None)
        before = stats.prefetch_totals() if stats is not None else None
        loaded = root.prefetch(keys)
        covered = len(keys)
        if before is not None:
            after = stats.prefetch_totals()
            covered = after["cached"] - before["cached"]
        self._prefetch_summary = {
            "keys": len(keys), "covered": covered, "loaded": loaded}

    def _log_checkpoint_summary(self) -> None:
        """One line per applied checkpoint: prefetch coverage + the
        cumulative getPrefetchHitRate-parity hit rate."""
        stats = getattr(self.app.ledger_manager, "apply_stats", None)
        ps = self._prefetch_summary
        if stats is None or ps is None:
            return
        log.info(
            "checkpoint %08x applied: prefetch coverage %d/%d keys "
            "(%d newly loaded; hit-rate %.1f%% cumulative)",
            self.checkpoint, ps["covered"], ps["keys"], ps["loaded"],
            100.0 * stats.prefetch_hit_rate())

    @staticmethod
    def _mutates_signers(txset) -> bool:
        """Does any op in the set ADD verification pairs? Only a
        SET_OPTIONS carrying a signer does (flags/threshold/home-domain
        changes and master-weight edits don't: the master key is always
        a candidate; creations/merges only add/remove master keys)."""
        from ..xdr import OperationType
        for f in txset.frames:
            tx = getattr(f, "tx", None) or f.inner.tx
            for op in tx.operations:
                if op.body.disc == OperationType.SET_OPTIONS and \
                        op.body.value.signer is not None:
                    return True
        return False

    def _prewarm_ledger(self, txset) -> None:
        """Re-prewarm after a signer-set mutation: the whole-checkpoint
        prewarm resolved signer sets at checkpoint start, so signatures
        from signers added mid-checkpoint missed it, and each miss would
        otherwise dispatch a small padded device batch from inside
        check_signature. When the dirty flag flips, ALL remaining
        checkpoint frames re-collect against current state in ONE batch
        and the flag clears (a later mutation re-arms it) — the common
        no-mutation case skips collection entirely."""
        del txset
        if not self._sig_state_dirty:
            return
        self._sig_state_dirty = False
        if self._pipeline_enabled():
            # re-collect the remaining range against post-mutation state
            self._pipeline_submit(self._next, self.last_seq)
            return
        frames = []
        for seq in range(self._next, self.last_seq + 1):
            fr = self._frames.get(seq)
            if fr is not None:
                frames.extend(fr.frames)
        self._prewarm_frames(frames)

    def on_run(self) -> State:
        from ..herder.txset import TxSetFrame
        from ..ledger.ledger_manager import LedgerCloseData

        if not self._loaded:
            if not self._load():
                return FAILURE
            self._prewarm()
            self._loaded = True

        lm = self.app.ledger_manager
        if self._next > self.last_seq:
            self._log_checkpoint_summary()
            return SUCCESS
        seq = self._next
        if seq <= lm.last_closed_ledger_num():
            self._next += 1           # already applied (restart overlap)
            return RUNNING
        entry = self._headers.get(seq)
        if entry is None:
            log.warning("checkpoint %08x missing header %d",
                        self.checkpoint, seq)
            return FAILURE
        net = self.app.config.network_id
        txset = self._frames.get(seq)
        if txset is None:
            ts = self._txsets.get(seq)
            txset = (TxSetFrame.from_wire(net, ts) if ts is not None else
                     TxSetFrame(net, entry.header.previousLedgerHash, []))
        self._prewarm_ledger(txset)
        lcd = LedgerCloseData(seq, txset, entry.header.scpValue)
        with app_span(self.app, "catchup.apply_ledger", cat="catchup",
                      seq=seq, checkpoint=self.checkpoint):
            lm.close_ledger(lcd)
        if not self._sig_state_dirty and self._mutates_signers(txset):
            self._sig_state_dirty = True
        if lm.lcl_hash != entry.hash:
            log.error("replay diverged at ledger %d: %s != %s", seq,
                      lm.lcl_hash.hex()[:8], entry.hash.hex()[:8])
            return FAILURE
        self._next += 1
        if self._next > self.last_seq:
            self._log_checkpoint_summary()
            return SUCCESS
        return RUNNING


class DownloadApplyTxsWork(BatchWork):
    """Pipelines checkpoint downloads with strictly-ordered application
    (reference DownloadApplyTxsWork.cpp:35-104): up to `max_concurrent`
    checkpoints download in parallel while applies run in checkpoint
    order behind a ConditionalWork latch."""

    def __init__(self, app, archive: HistoryArchive, download_dir: str,
                 first_seq: int, last_seq: int,
                 max_concurrent: int = 4) -> None:
        super().__init__(app.clock, "download-apply-txs [%d..%d]"
                         % (first_seq, last_seq), max_concurrent,
                         max_retries=RETRY_NEVER)
        self.app = app
        self.archive = archive
        self.download_dir = download_dir
        self.first_seq = first_seq
        self.last_seq = last_seq
        freq = app.config.CHECKPOINT_FREQUENCY
        self._freq = freq
        self._checkpoints = list(checkpoints_in_range(first_seq, last_seq,
                                                      freq))
        self._idx = 0
        # apply gate: checkpoints apply strictly in order
        self._applied_up_to = first_seq - 1

    def do_reset(self) -> None:
        self._idx = 0
        self._applied_up_to = self.first_seq - 1

    def yield_more_work(self) -> Optional[BasicWork]:
        if self._idx >= len(self._checkpoints):
            return None
        c = self._checkpoints[self._idx]
        self._idx += 1
        lo = max(self.first_seq, first_in_checkpoint(c, self._freq))
        hi = min(self.last_seq, c)

        gets: List[BasicWork] = []
        for cat in ("ledger", "transactions"):
            local = os.path.join(self.download_dir,
                                 "%s-%08x.xdr" % (cat, c))
            if os.path.exists(local):
                continue              # verify phase already fetched it
            gets.append(GetAndUnzipRemoteFileWork(
                self.app, self.archive, category_path(cat, c, ".xdr.gz"),
                local))

        apply_work = ApplyCheckpointWork(self.app, self.download_dir, c,
                                         lo, hi)
        gate_lo = lo

        gated = ConditionalWork(
            self.clock, "apply-gate %08x" % c,
            lambda gate_lo=gate_lo: self._applied_up_to == gate_lo - 1,
            apply_work)

        apply_work.on_success = \
            lambda hi=hi: setattr(self, "_applied_up_to", hi)
        return WorkSequence(self.clock, "download-apply %08x" % c,
                            gets + [gated], max_retries=RETRY_NEVER)
