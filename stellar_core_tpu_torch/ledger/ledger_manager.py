"""LedgerManager: orders externalized values and closes ledgers.

Copied from `stellar_core_tpu/ledger/ledger_manager.py` at commit bb973b8;
carry a fix in either copy to the other. The close runs the Python fee
and apply phases. Left out, each with the module that drives it: the
close cockpit (`ApplyStats`, `ledger/apply_stats.py`, with the
entry-cache prefetch its `txset_prefetch_keys` feeds); the native apply
engine (`native_apply_txset`, `use_native_apply`,
`_native_covers_prefetch`); BucketDB (`_check_bucket_coverage` and the
re-attach in `set_last_closed_ledger`, and the detach in
`_restore_bucket_list`'s fallback); invariants; the close-meta stream
(`_emit_close_meta`); the slot timeline. Kept from the history and
catchup wiring: `load_last_known_ledger` (a restart over the SQL store
and the bucket directory), `_store_local_has` and `_restore_bucket_list`
(the local HAS in the persistent state), `maybe_queue_checkpoint` after
each close, and `catchup_trigger`, `entries_invalidated` and the
buffering of values in LM_CATCHING_UP_STATE, which `catchup/` and
`historywork/apply_works.py` drive. Deliberately different: a close uses
the app's `sig_verifier` and `batch_hasher` and raises TypeError without
either (the reference's frames fall back to a CpuSigVerifier and its
close hashes with hashlib when the app has no hasher).

Role parity: reference `src/ledger/LedgerManagerImpl.cpp`:
- valueExternalized (:410-490): apply in-order values, route gaps to catchup
- closeLedger (:522-728): bump seq → hash checks → sortForApply →
  processFeesSeqNums → applyTransactions → result hash → upgrades →
  ledgerClosed (bucket batch + header hash) → commit → publish queue
- startNewLedger / loadLastKnownLedger for genesis and restart.

Design note: the close checks signatures through the app's
BatchSigVerifier; the herder's validation (and catchup's replay) prewarms
the verify cache with a whole set's (or checkpoint's) signatures in one
device batch, so the per-tx checks here become cache hits.
"""

from __future__ import annotations

from itertools import chain

from ..bucket.bucket_manager import calculate_skip_values
from ..crypto.hashing import sha256
from ..herder.upgrades import Upgrades, UpgradeValidity
from ..ledger.ledgertxn import (
    InMemoryLedgerTxnRoot, LedgerTxn, LedgerTxnRoot, delta_to_changes,
)
from ..transactions.account_helpers import make_account_entry
from ..util.log import get_logger
from ..util.slow_execution import LogSlowExecution
from ..util.threads import main_thread_only
from ..util.tracing import app_span
from ..xdr import (
    LedgerHeader, LedgerKey, LedgerUpgrade, StellarValue, StellarValueExt,
    _Ext,
)

log = get_logger("Ledger")


def _be_u32(n: int) -> bytes:
    return n.to_bytes(4, "big")

GENESIS_LEDGER_SEQ = 1

# compiled structural copy (xdr/fastcodec.py) — close_ledger snapshots the
# previous header once per close
from ..xdr import fastcodec as _fastcodec  # noqa: E402
_copy_header_fast = _fastcodec.compile_copy(LedgerHeader)


class LedgerManagerState:
    LM_BOOTING_STATE = 0
    LM_SYNCED_STATE = 1
    LM_CATCHING_UP_STATE = 2


class LedgerCloseData:
    """One externalized slot worth of data (reference LedgerCloseData.h)."""

    def __init__(self, ledger_seq: int, tx_set, value: StellarValue) -> None:
        self.ledger_seq = ledger_seq
        self.tx_set = tx_set
        self.value = value


class LedgerManager:
    def __init__(self, app) -> None:
        self.app = app
        self.state = LedgerManagerState.LM_BOOTING_STATE
        cfg = app.config
        if cfg.DATABASE == "in-memory":
            self.root = InMemoryLedgerTxnRoot()
        else:
            self.root = LedgerTxnRoot(app.database)
        self.lcl_hash: bytes = b"\x00" * 32
        self.catchup_trigger = None  # set by CatchupManager wiring
        # True between a bucket-apply's state wipe and its successful LCL
        # fast-forward: no direct closes may run against half-built state
        self.entries_invalidated = False

    # -- genesis / restart --------------------------------------------------
    def start_new_ledger(self) -> None:
        cfg = self.app.config
        genesis = LedgerHeader(
            ledgerVersion=cfg.LEDGER_PROTOCOL_VERSION,
            previousLedgerHash=b"\x00" * 32,
            scpValue=StellarValue(txSetHash=b"\x00" * 32, closeTime=0,
                                  upgrades=[],
                                  ext=StellarValueExt(0, None)),
            txSetResultHash=b"\x00" * 32, bucketListHash=b"\x00" * 32,
            ledgerSeq=GENESIS_LEDGER_SEQ,
            totalCoins=cfg.GENESIS_TOTAL_COINS, feePool=0, inflationSeq=0,
            idPool=0, baseFee=cfg.TESTING_UPGRADE_DESIRED_FEE,
            baseReserve=cfg.TESTING_UPGRADE_RESERVE,
            maxTxSetSize=cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE,
            skipList=[b"\x00" * 32] * 4, ext=_Ext.v0())
        self.root.set_header(genesis)
        ltx = LedgerTxn(self.root)
        root_acc = self.app.network_root_key().public_key
        ltx.create(make_account_entry(
            root_acc, cfg.GENESIS_TOTAL_COINS, 0, GENESIS_LEDGER_SEQ))
        genesis_entries = [cur for (_k, _prev, cur) in ltx.get_delta()]
        ltx.commit()
        self.lcl_hash = sha256(genesis.to_xdr())
        self._store_header(genesis)
        # seed the bucket list with the genesis delta (reference
        # startNewLedger → ledgerClosed does the same addBatch): without
        # it the root account exists in SQL but in NO bucket, so
        # BucketDB-routed reads and bucket-apply catchup both
        # miss it. The genesis HEADER keeps bucketListHash = zero — it
        # was hashed before this batch, and every node (and every
        # catchup replay) seeds identically, so the chain from ledger 2
        # onward agrees fleet-wide.
        bm = self._bucket_manager()
        if bm is not None:
            bm.add_batch(GENESIS_LEDGER_SEQ, genesis.ledgerVersion,
                         genesis_entries, [], [])
            self._store_local_has()
        self.state = LedgerManagerState.LM_SYNCED_STATE
        log.info("started new ledger: genesis %s",
                 self.lcl_hash.hex()[:8])

    def load_last_known_ledger(self) -> bool:
        """Restore LCL from the database; returns False if no state."""
        db = getattr(self.app, "database", None)
        if db is None or self.app.config.DATABASE == "in-memory":
            return False
        row = db.execute(
            "SELECT ledgerhash, data FROM ledgerheaders ORDER BY "
            "ledgerseq DESC LIMIT 1").fetchone()
        if row is None:
            return False
        header = LedgerHeader.from_xdr(row[1])
        self.root.set_header(header)
        self.lcl_hash = bytes.fromhex(row[0])
        self.state = LedgerManagerState.LM_SYNCED_STATE
        self._restore_bucket_list()
        return True

    def set_last_closed_ledger(self, header: LedgerHeader,
                               ledger_hash: bytes) -> None:
        """Fast-forward the LCL to a verified downloaded header — the
        bucket-apply catchup path (reference CatchupWork sets LCL after
        ApplyBucketsWork; LedgerManagerImpl::setLastClosedLedger)."""
        assert sha256(header.to_xdr()) == ledger_hash, "header/hash mismatch"
        self.root.set_header(header)
        self.lcl_hash = ledger_hash
        self._store_header(header)
        self.entries_invalidated = False
        log.info("LCL set to %d (%s) from catchup", header.ledgerSeq,
                 ledger_hash.hex()[:8])

    # -- accessors ----------------------------------------------------------
    @property
    def lcl_header(self) -> LedgerHeader:
        return self.root.get_header()

    def last_closed_ledger_num(self) -> int:
        return self.lcl_header.ledgerSeq

    def ltx_root(self):
        return self.root

    def header(self) -> LedgerHeader:
        return self.root.get_header()

    def is_synced(self) -> bool:
        return self.state == LedgerManagerState.LM_SYNCED_STATE

    # -- externalization ----------------------------------------------------
    @main_thread_only
    def value_externalized(self, lcd: LedgerCloseData) -> None:
        lcl = self.last_closed_ledger_num()
        if self.state == LedgerManagerState.LM_CATCHING_UP_STATE:
            # mid-catchup every value is buffered, even in-order ones —
            # closing under a concurrent bucket apply would corrupt state
            # (reference LedgerManagerImpl.cpp:410-444)
            if self.catchup_trigger is not None:
                self.catchup_trigger(lcd)
            return
        if lcd.ledger_seq == lcl + 1:
            self.close_ledger(lcd)
        elif lcd.ledger_seq <= lcl:
            log.info("skipping already-applied ledger %d", lcd.ledger_seq)
        else:
            log.warning("ledger gap: got %d, lcl %d — catchup needed",
                        lcd.ledger_seq, lcl)
            self.state = LedgerManagerState.LM_CATCHING_UP_STATE
            if self.catchup_trigger is not None:
                self.catchup_trigger(lcd)

    # -- the close ----------------------------------------------------------
    @main_thread_only
    def close_ledger(self, lcd: LedgerCloseData) -> None:
        verifier = getattr(self.app, "sig_verifier", None)
        if verifier is None:
            raise TypeError("close_ledger needs the app's sig_verifier "
                            "(make_verifier(...), or CpuSigVerifier() for "
                            "the host)")
        hasher = getattr(self.app, "batch_hasher", None)
        if hasher is None:
            raise TypeError("close_ledger needs the app's batch_hasher "
                            "(make_hasher(...), or make_hasher(\"cpu\") for "
                            "the host)")
        header_prev = _copy_header_fast(self.lcl_header)
        assert lcd.ledger_seq == header_prev.ledgerSeq + 1, "non-sequential"
        assert lcd.tx_set.previous_ledger_hash == self.lcl_hash, \
            "txset based on wrong ledger"
        assert lcd.value.txSetHash == lcd.tx_set.get_contents_hash(
            hasher=hasher), "value/txset hash mismatch"

        metrics = getattr(self.app, "metrics", None)
        recorder = getattr(self.app, "flight_recorder", None)
        on_slow = (None if recorder is None else
                   lambda elapsed: recorder.dump(
                       "slow-close",
                       extra={"ledger_seq": lcd.ledger_seq,
                              "elapsed_s": elapsed}))
        db = getattr(self.app, "database", None)
        ltx = LedgerTxn(self.root)
        try:
            # split the close into apply-vs-SQL components (reference
            # DBTimeExcluder + LogSlowExecution, LedgerManagerImpl:524-528);
            # the timers record in `finally` so failed closes still
            # contribute samples
            import time as _time
            sql_before = db.total_query_seconds if db is not None else 0.0
            t0 = _time.perf_counter()
            try:
                with LogSlowExecution("ledger close", on_slow=on_slow), \
                        app_span(self.app, "ledger.close", cat="ledger",
                                 seq=lcd.ledger_seq,
                                 txs=len(lcd.tx_set.frames)):
                    self._close_ledger_in(ltx, lcd, header_prev, verifier,
                                          hasher)
            finally:
                if metrics is not None:
                    elapsed = _time.perf_counter() - t0
                    sql_spent = (db.total_query_seconds - sql_before) \
                        if db is not None else 0.0
                    metrics.new_timer("ledger.ledger.close").update(elapsed)
                    metrics.new_timer("ledger.ledger.close.sql").update(
                        sql_spent)
                    metrics.new_timer("ledger.ledger.close.apply").update(
                        max(0.0, elapsed - sql_spent))
            if metrics is not None:
                metrics.new_meter("ledger.transaction.apply").mark(
                    len(lcd.tx_set.frames))
                metrics.new_counter("ledger.ledger.num").set_count(
                    lcd.ledger_seq)
        except BaseException as e:
            if ltx._open:
                ltx.rollback()   # drop children too: no dangling state
            # black box for the postmortem: spans + metrics at the moment
            # of a failed close (KeyboardInterrupt/SystemExit excluded —
            # an operator ^C is not a crash)
            if recorder is not None and isinstance(e, Exception):
                recorder.dump("close-exception", exc=e,
                              extra={"ledger_seq": lcd.ledger_seq})
            raise

    def _close_ledger_in(self, ltx, lcd: LedgerCloseData,
                         header_prev: LedgerHeader, verifier,
                         hasher) -> None:
        header = ltx.load_header()
        header.ledgerSeq = lcd.ledger_seq
        header.previousLedgerHash = self.lcl_hash
        header.scpValue = lcd.value

        with app_span(self.app, "close.txset_sort", cat="ledger"):
            frames = lcd.tx_set.sort_for_apply()
            base_fee = lcd.tx_set.base_fee(header)

        with app_span(self.app, "close.apply", cat="ledger",
                      txs=len(frames)) as apply_sp:
            # phase 1: fees + seq nums for every tx, each in a nested
            # txn so the per-tx fee-processing changes become
            # txfeehistory meta (reference saves these
            # LedgerEntryChanges per tx)
            for f in frames:
                fee_ltx = LedgerTxn(ltx)
                try:
                    f.process_fee_seq_num(fee_ltx, base_fee)
                    f.fee_meta = delta_to_changes(fee_ltx.get_delta())
                    fee_ltx.commit()
                except BaseException:
                    if fee_ltx._open:
                        fee_ltx.rollback()
                    raise
            # phase 2: apply, collecting results
            for f in frames:
                f.apply(ltx, verifier)
            apply_sp.set_tag("apply_path", "python")
        # result hash in apply order, assembled from wire bytes:
        # TransactionResultSet XDR is count ‖ pairs, streamed through the
        # hash boundary so peak memory stays flat in the txset's size
        with app_span(self.app, "close.result_hash", cat="ledger"):
            chunks = chain((_be_u32(len(frames)),),
                           (f.result_pair_xdr() for f in frames))
            header.txSetResultHash = hasher.hash_stream(chunks,
                                                        site="result-set")

        # upgrades (after txs; reference LedgerManagerImpl.cpp:617-669):
        # a malformed or invalid upgrade in an externalized value fails
        # the whole close; valid upgrades each apply in a nested txn so
        # their entry changes land in meta + upgradehistory, and an
        # apply-time error skips that upgrade without aborting the close
        applied_upgrades = []   # (LedgerUpgrade, LedgerEntryChanges rows)
        max_version = getattr(getattr(self.app, "config", None),
                              "LEDGER_PROTOCOL_VERSION", 2**32 - 1)
        for i, raw in enumerate(lcd.value.upgrades):
            validity = Upgrades.validity_for_apply(raw, header, max_version)
            if validity == UpgradeValidity.XDR_INVALID:
                raise RuntimeError("unknown upgrade at index %d" % i)
            if validity == UpgradeValidity.INVALID:
                raise RuntimeError("invalid upgrade at index %d" % i)
            up = LedgerUpgrade.from_xdr(raw)
            up_ltx = LedgerTxn(ltx)
            try:
                Upgrades.apply_to(up_ltx, up)
                changes = delta_to_changes(up_ltx.get_delta())
                up_ltx.commit()
            except RuntimeError as e:
                if up_ltx._open:
                    up_ltx.rollback()
                log.error("exception during upgrade: %s", e)
                continue
            except BaseException:
                if up_ltx._open:
                    up_ltx.rollback()
                raise
            applied_upgrades.append((up, changes, i + 1))

        # bucket-list hash over the close's delta (content-addressed chain;
        # stands in the header exactly where the reference's
        # BucketList::getHash result goes). raw_keys=True: only DEAD
        # entries need a parsed LedgerKey (bucket dead keys)
        with app_span(self.app, "close.bucket_add", cat="ledger") as bsp:
            delta = ltx.get_delta(raw_keys=True)
            bl = self._bucket_manager()
            bsp.set_tag("entries", len(delta))
            if bl is not None:
                init_entries, live_entries, dead_keys = [], [], []
                for kb, prev, cur in delta:
                    if cur is None:
                        dead_keys.append(LedgerKey.from_xdr(kb))
                    elif prev is None:
                        init_entries.append(cur)
                    else:
                        live_entries.append(cur)
                bl.add_batch(header.ledgerSeq, header.ledgerVersion,
                             init_entries, live_entries, dead_keys)
                bl.snapshot_ledger(header)
            else:
                pairs = ((kb, cur.to_xdr() if cur is not None
                          else b"\xff" * 4)
                         for kb, _prev, cur in sorted(delta,
                                                      key=lambda t: t[0]))
                header.bucketListHash = hasher.hash_stream(chain(
                    (header_prev.bucketListHash,),
                    chain.from_iterable(pairs)))
                # skipList advances identically with or without a real
                # bucket list — it hangs off whatever stands in
                # bucketListHash
                calculate_skip_values(header)

        with app_span(self.app, "close.commit", cat="ledger"):
            ltx.commit()
        with app_span(self.app, "close.header_hash", cat="ledger"):
            self.lcl_hash = hasher.digest_one(
                self.root.get_header().to_xdr(), site="header")
        # state commitment (ledger/state_commitment.py): the
        # incremental Merkle root over the post-close bucket list, plus
        # a signed light-client checkpoint on its interval — O(changed
        # levels) per close via the entry-root cache
        sce = getattr(self.app, "state_commitment", None)
        if sce is not None and bl is not None:
            with app_span(self.app, "close.commitment", cat="ledger",
                          seq=lcd.ledger_seq) as msp:
                cp = sce.on_close(bl.bucket_list, lcd.ledger_seq,
                                  self.lcl_hash)
                if sce.root is not None:
                    msp.set_tag("root", sce.root.hex()[:16])
                if cp is not None:
                    msp.set_tag("checkpoint_seq", cp.ledger_seq)
        with app_span(self.app, "close.sql_commit", cat="ledger"):
            self._store_header(self.root.get_header())
            self._store_txs(lcd, frames)
            # after the in-memory commit, like txhistory: a close that
            # fails mid-upgrade must leave no pending history rows in the
            # sqlite transaction (a catchup retry would hit the PRIMARY
            # KEY)
            for up, changes, index in applied_upgrades:
                self._store_upgrade_history(lcd.ledger_seq, up, changes,
                                            index)
            self._store_local_has()
        hm = getattr(self.app, "history_manager", None)
        if hm is not None:
            hm.maybe_queue_checkpoint(self)
        log.debug("closed ledger %d (%d txs) hash %s", lcd.ledger_seq,
                  len(frames), self.lcl_hash.hex()[:8])

    def _bucket_manager(self):
        return getattr(self.app, "bucket_manager", None)

    def _store_local_has(self) -> None:
        """Persist the local bucket-list manifest so a restarted node can
        re-adopt its bucket files (reference keeps kHistoryArchiveState in
        PersistentState and assumeState()s it at startup)."""
        ps = getattr(self.app, "persistent_state", None)
        bm = self._bucket_manager()
        if ps is None or bm is None:
            return
        from ..history.archive_state import HistoryArchiveState
        has = HistoryArchiveState.from_bucket_list(
            self.lcl_header.ledgerSeq, bm.bucket_list)
        ps.set_state(ps.kHistoryArchiveState, has.to_json())

    def _restore_bucket_list(self) -> None:
        """Re-adopt the persisted bucket-list state after a restart
        (reference ApplicationImpl loadLastKnownLedger →
        BucketManagerImpl::assumeState)."""
        ps = getattr(self.app, "persistent_state", None)
        bm = self._bucket_manager()
        if ps is None or bm is None:
            return
        s = ps.get_state(ps.kHistoryArchiveState)
        if not s:
            return
        from ..history.archive_state import (
            HistoryArchiveState, has_level_dicts,
        )
        try:
            has = HistoryArchiveState.from_json(s)
            header = self.lcl_header
            bm.assume_state(has_level_dicts(has),
                            header.ledgerSeq, header.ledgerVersion)
            # the adopted list must hash to what the LCL header committed
            # to — a stale HAS (e.g. written before a bucket-apply catchup
            # fast-forwarded the LCL) silently forks the chain otherwise.
            # Exception: a node restarted AT genesis — the genesis header
            # predates the seeded genesis batch by construction (its
            # bucketListHash is the zero hash), so the seeded list is the
            # expected state, not a fork.
            at_genesis = (header.ledgerSeq == GENESIS_LEDGER_SEQ and
                          header.bucketListHash == b"\x00" * 32)
            if not at_genesis and bm.get_hash() != header.bucketListHash:
                raise ValueError(
                    "restored bucket list hash %s != header %s" %
                    (bm.get_hash().hex()[:16],
                     header.bucketListHash.hex()[:16]))
            log.info("restored bucket list at ledger %d from local HAS",
                     header.ledgerSeq)
        except Exception as e:  # corrupt/stale HAS or missing files:
            # degrade to an empty bucket list rather than failing startup
            # or running on wrong state (catchup heals)
            from ..bucket.bucket_list import BucketList
            bm.bucket_list = BucketList(bm._executor,
                                        adopt=bm.adopt_bucket)
            log.warning("bucket-list restore failed: %s — starting from "
                        "an empty bucket list until catchup heals it", e)

    def _store_upgrade_history(self, ledger_seq: int, up, changes,
                               index: int) -> None:
        """Reference Upgrades::storeUpgradeHistory — one row per applied
        upgrade, 1-indexed like txhistory, carrying the upgrade and its
        LedgerEntryChanges."""
        db = getattr(self.app, "database", None)
        if db is None:
            return
        from ..xdr import LedgerEntryChanges as _LEC
        from ..xdr.codec import xdr_bytes as _xb
        db.execute(
            "INSERT OR REPLACE INTO upgradehistory (ledgerseq, "
            "upgradeindex, upgrade, changes) VALUES (?,?,?,?)",
            (ledger_seq, index, up.to_xdr(), _xb(_LEC, changes)))

    # -- persistence --------------------------------------------------------
    def _store_header(self, header: LedgerHeader) -> None:
        db = getattr(self.app, "database", None)
        if db is None:
            return
        hb = header.to_xdr()
        db.execute(
            "INSERT OR REPLACE INTO ledgerheaders (ledgerhash, prevhash, "
            "bucketlisthash, ledgerseq, closetime, data) VALUES "
            "(?,?,?,?,?,?)",
            (sha256(hb).hex(),
             header.previousLedgerHash.hex(), header.bucketListHash.hex(),
             header.ledgerSeq, header.scpValue.closeTime, hb))
        db.commit()

    def _store_txs(self, lcd: LedgerCloseData, frames) -> None:
        db = getattr(self.app, "database", None)
        if db is None:
            return
        tx_rows, fee_rows = [], []
        for i, f in enumerate(frames):
            h = f.contents_hash().hex()
            tx_rows.append((h, lcd.ledger_seq, i, f.envelope_bytes(),
                            f.result_pair_xdr(), f.tx_meta_xdr()))
            fee_rows.append((h, lcd.ledger_seq, i, f.fee_meta_xdr()))
        db.executemany(
            "INSERT OR REPLACE INTO txhistory (txid, ledgerseq, "
            "txindex, txbody, txresult, txmeta) VALUES (?,?,?,?,?,?)",
            tx_rows)
        db.executemany(
            "INSERT OR REPLACE INTO txfeehistory (txid, ledgerseq, "
            "txindex, txchanges) VALUES (?,?,?,?)", fee_rows)
        db.commit()
