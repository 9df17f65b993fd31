"""TransactionFrame: validity checking, fee/sequence processing, apply.

Copied from `stellar_core_tpu/transactions/transaction_frame.py` at commit
89bbd6f; carry a fix in either copy to the other. Kept: the apply
engine's output on both frames (`set_native_apply_output`, the
`_native_result_b` / `_native_fee_b` / `_native_meta_b` fields it fills and
the lazy parses and byte accessors that read them) and the close cockpit's
`stats` argument of `apply` (`ledger/apply_stats.py`: per-op latency on
the Python path; the fee bump passes it to its inner frame). Deliberately
different: `check_valid`
and `apply`, of both frames, use the verifier they are given and raise
TypeError without one (the reference falls back to a CpuSigVerifier), and
`apply` lets a `SignatureVerifyError` (a verifier that failed, not a
signature) through instead of recording txINTERNAL_ERROR.

Role parity: reference `src/transactions/TransactionFrame.cpp`:
- checkValid (:594-629) / commonValid (:443-502): time bounds, seq number,
  fee floor, source existence, low-threshold signature check, fee balance.
- processFeeSeqNum (:505): charge fee into the fee pool, consume seq num.
- apply (:778-835): SignatureChecker over the contents hash, processSignatures
  (op-level sig checks up front), then per-op nested LedgerTxn apply with
  all-or-nothing rollback.
Plus FeeBumpTransactionFrame (reference FeeBumpTransactionFrame.cpp).

The SignatureChecker receives the injected BatchSigVerifier: with the
card's verifier every checkValid/apply becomes a batched device call site
(SURVEY.md hot callers #2/#3).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..crypto.hashing import sha256
from ..crypto.batch_verifier import BatchSigVerifier
from ..xdr import (
    EnvelopeType, FeeBumpTransactionEnvelope, LedgerKey, OperationResult,
    OperationResultCode, PublicKey, Transaction, TransactionEnvelope,
    TransactionResult, TransactionResultCode, TransactionResultPair,
    TransactionSignaturePayload, TransactionV1Envelope, _Ext,
)
from ..xdr.transaction import _TaggedTransaction, _TxResultResult
from .account_helpers import (
    ThresholdLevel, account_available_balance, account_threshold,
    account_master_weight, load_account,
)
from ..ledger.ledgertxn import delta_to_changes
from .operation_frame import make_operation_frame
from .signature_checker import SignatureChecker, SignatureVerifyError
from . import operations as _ops  # noqa: F401  (populates the op registry)
from . import offers as _offers   # noqa: F401


def _signer_keys_of(ltx, acc_id: bytes,
                    cache: Optional[dict] = None) -> frozenset:
    """Ed25519 signer-key set of one account: master key + account
    signers (reference SignatureChecker scans the same set). `cache`
    memoizes per account so batch collection over many frames loads and
    parses each account entry once."""
    if cache is not None:
        got = cache.get(acc_id)
        if got is not None:
            return got
    from ..xdr import SignerKeyType
    keys = {acc_id}  # master key; also the missing-account case
    entry = ltx.load_without_record(
        LedgerKey.account(PublicKey.ed25519(acc_id)))
    if entry is not None:
        for s in entry.data.value.signers:
            if s.key.disc == SignerKeyType.SIGNER_KEY_TYPE_ED25519:
                keys.add(s.key.value)
    out = frozenset(keys)
    if cache is not None:
        cache[acc_id] = out
    return out


def collect_sig_triples(ltx, account_ids, signatures,
                        contents_hash: bytes,
                        signer_cache: Optional[dict] = None
                        ) -> List[Tuple[bytes, bytes, bytes]]:
    """Hint-matching (ed25519-key, signature, contents-hash) pairs against
    the signer sets (master key + account signers) of `account_ids`.
    Shared by the tx and fee-bump frames' candidate_sig_triples — the
    collection half of TxSetFrame's two-phase prewarm."""
    keys = set()
    for acc_id in account_ids:
        keys |= _signer_keys_of(ltx, acc_id, signer_cache)
    out = []
    for ds in signatures:
        for kb in keys:
            if ds.hint == kb[-4:]:
                out.append((kb, ds.signature, contents_hash))
    return out


def frames_sig_triples(ltx, frames) -> List[Tuple[bytes, bytes, bytes]]:
    """Deduped candidate triples for a BATCH of frames — the shared
    collection step of both prewarm sites (TxSetFrame.check_or_trim and
    catchup's whole-checkpoint drain). One signer-set resolution per
    distinct account across the whole batch."""
    seen: dict = {}
    signer_cache: dict = {}
    for f in frames:
        for t in f.candidate_sig_triples(ltx, signer_cache):
            seen[t] = None
    return list(seen)


def _make_result(fee_charged: int, code: int,
                 op_results: Optional[List[OperationResult]] = None
                 ) -> TransactionResult:
    if code in (TransactionResultCode.txSUCCESS,
                TransactionResultCode.txFAILED):
        rr = _TxResultResult(code, op_results or [])
    else:
        rr = _TxResultResult(code, None)
    return TransactionResult(feeCharged=fee_charged, result=rr,
                             ext=_Ext.v0())


# commonValid failure codes reached BEFORE the sequence-number stage: a tx
# failing with one of these at apply does NOT consume its seq num
# (reference ValidationType kInvalid vs kInvalidUpdateSeqNum ladder,
# TransactionFrame.cpp:443-502)
_PRE_SEQ_FAILURES = frozenset((
    TransactionResultCode.txTOO_EARLY,
    TransactionResultCode.txTOO_LATE,
    TransactionResultCode.txMISSING_OPERATION,
    TransactionResultCode.txINSUFFICIENT_FEE,
    TransactionResultCode.txNO_ACCOUNT,
    TransactionResultCode.txBAD_SEQ,
))


class TransactionFrame:
    def __init__(self, network_id: bytes,
                 envelope: TransactionEnvelope) -> None:
        assert envelope.disc == EnvelopeType.ENVELOPE_TYPE_TX
        self.network_id = network_id
        self.envelope = envelope
        self.tx: Transaction = envelope.value.tx
        self.signatures = envelope.value.signatures
        self.op_frames = [make_operation_frame(op, self)
                          for op in self.tx.operations]
        self._result: Optional[TransactionResult] = _make_result(
            0, TransactionResultCode.txSUCCESS,
            [None] * len(self.op_frames))
        self._native_result_b: Optional[bytes] = None
        self._contents_hash: Optional[bytes] = None
        self._env_bytes: Optional[bytes] = None
        self._full_hash: Optional[bytes] = None
        self._env_sig_fp: tuple = ()
        self._sig_frozen = False
        self.op_metas: List[list] = []     # per-op LedgerEntryChanges
        self._fee_meta: list = []          # fee/seq processing changes
        self.tx_changes: list = []         # apply-time seq/signer changes
        self._native_meta_b: Optional[bytes] = None  # TransactionMeta XDR
        self._native_fee_b: Optional[bytes] = None   # LedgerEntryChanges

    # -- identity -----------------------------------------------------------
    @classmethod
    def make_from_wire(cls, network_id: bytes, env: TransactionEnvelope):
        if env.disc == EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
            return FeeBumpTransactionFrame(network_id, env)
        return cls(network_id, env)

    def source_account_id(self) -> PublicKey:
        return self.tx.sourceAccount.account_id

    def seq_account_id(self) -> PublicKey:
        """The account whose sequence number this envelope consumes —
        the queue/txset chain key (reference getSourceID; for fee bumps
        the INNER source, not the fee source)."""
        return self.source_account_id()

    def fee_account_id(self) -> PublicKey:
        """The account the fee is charged to (reference getFeeSourceID)."""
        return self.source_account_id()

    @property
    def seq_num(self) -> int:
        return self.tx.seqNum

    @property
    def fee_bid(self) -> int:
        return self.tx.fee

    def num_operations(self) -> int:
        return len(self.tx.operations)

    def signature_payload(self) -> bytes:
        p = TransactionSignaturePayload(
            networkId=self.network_id,
            taggedTransaction=_TaggedTransaction(
                EnvelopeType.ENVELOPE_TYPE_TX, self.tx))
        return p.to_xdr()

    def contents_hash(self) -> bytes:
        if self._contents_hash is None:
            self._contents_hash = sha256(self.signature_payload())
        return self._contents_hash

    def _sig_fingerprint(self) -> tuple:
        return tuple((ds.hint, ds.signature) for ds in self.signatures)

    def freeze_signatures(self) -> None:
        """Promise that this frame's signature list will never change
        (history-replay frames parsed from immutable wire): the
        envelope_bytes fingerprint re-check is skipped from now on. The
        fingerprint walk is ~20 tuple builds per call on the bench's
        multisig frames and replay serializes each frame several times
        per close."""
        self.envelope_bytes()   # prime the cache under the full check
        self._sig_frozen = True

    def envelope_bytes(self) -> bytes:
        """Canonical wire bytes of the signed envelope, cached —
        serialized once per frame for hashing, txset hashing, history
        rows, and flood messages. The cache is guarded by a fingerprint
        of the signature list (the one surface callers mutate directly,
        e.g. test harnesses and the fuzz corpus), so any signature change
        recomputes — unless freeze_signatures() declared the list
        immutable."""
        if self._sig_frozen and self._env_bytes is not None:
            return self._env_bytes
        fp = self._sig_fingerprint()
        if self._env_bytes is None or fp != self._env_sig_fp:
            self._env_bytes = self.envelope.to_xdr()
            self._full_hash = None
            self._env_sig_fp = fp
        return self._env_bytes

    def full_hash(self) -> bytes:
        """Hash of the whole signed envelope (identity in txsets)."""
        b = self.envelope_bytes()   # revalidates the signature fingerprint
        if self._full_hash is None:
            self._full_hash = sha256(b)
        return self._full_hash

    def invalidate_caches(self) -> None:
        """Drop every cached serialization/hash. Mutating any tx BODY
        field after first serialization (test/fuzz harnesses do this)
        must be followed by this call — the envelope_bytes fingerprint
        only tracks the signature list."""
        self._contents_hash = None
        self._env_bytes = None
        self._full_hash = None
        self._env_sig_fp = ()

    def add_signature(self, secret_key) -> None:
        """Sign the CONTENTS HASH (reference SignatureUtils::sign signs
        sha256(signature payload), not the raw payload)."""
        self._env_bytes = None
        self._full_hash = None
        self.signatures.append(
            secret_key.sign_decorated(self.contents_hash()))

    # -- batched signature collection ----------------------------------------
    def tx_meta(self):
        """TransactionMeta v1 for the last apply (reference txmeta column;
        downstream-consumer form — not part of any consensus hash)."""
        from ..xdr import OperationMeta, TransactionMeta, TransactionMetaV1
        if self._native_meta_b is not None:
            return TransactionMeta.from_xdr(self._native_meta_b)
        return TransactionMeta(1, TransactionMetaV1(
            txChanges=list(self.tx_changes),
            operations=[OperationMeta(changes=ch) for ch in self.op_metas]))

    def set_native_apply_output(self, result_b: bytes, fee_changes_b: bytes,
                                meta_b: bytes) -> None:
        """Install the apply engine's per-tx outputs (all XDR
        bytes): the TransactionResult, the fee-phase LedgerEntryChanges,
        and the TransactionMeta. Downstream consumers (result_pair,
        fee_meta rows, tx_meta) then behave exactly as after a Python
        apply — both meta parses are deferred until someone reads the
        object form, and the history writers take the bytes directly
        (fee_meta_xdr / tx_meta_xdr / result_pair_xdr), so the hot
        replay path never parses them at all."""
        self._result = None     # parsed lazily from _native_result_b
        self._native_result_b = result_b
        self._fee_meta = None
        self._native_fee_b = fee_changes_b
        self._native_meta_b = meta_b

    @property
    def result(self) -> TransactionResult:
        if self._result is None and self._native_result_b is not None:
            self._result = TransactionResult.from_xdr(
                self._native_result_b)
        return self._result

    @result.setter
    def result(self, r: TransactionResult) -> None:
        self._result = r
        self._native_result_b = None

    def result_pair_xdr(self) -> bytes:
        """TransactionResultPair wire bytes (transactionHash ‖ result) —
        the native engine's result bytes verbatim when it applied this
        tx, so the close's result-set hash and the txhistory row never
        parse or re-serialize the result on the replay fast path."""
        rb = self._native_result_b
        if rb is None:
            rb = self.result.to_xdr()
        return self.contents_hash() + rb

    @property
    def fee_meta(self) -> list:
        if self._fee_meta is None and self._native_fee_b is not None:
            from ..xdr import LedgerEntryChanges
            from ..xdr.codec import xdr_from
            self._fee_meta = xdr_from(LedgerEntryChanges,
                                      self._native_fee_b)
        return self._fee_meta

    @fee_meta.setter
    def fee_meta(self, changes: list) -> None:
        self._fee_meta = changes
        self._native_fee_b = None

    def fee_meta_xdr(self) -> bytes:
        """LedgerEntryChanges wire bytes of the fee phase — the native
        engine's output verbatim when it applied this tx."""
        if self._native_fee_b is not None:
            return self._native_fee_b
        from ..xdr import LedgerEntryChanges
        from ..xdr.codec import xdr_bytes
        return xdr_bytes(LedgerEntryChanges, self._fee_meta)

    def tx_meta_xdr(self) -> bytes:
        """TransactionMeta wire bytes of the last apply."""
        if self._native_meta_b is not None:
            return self._native_meta_b
        return self.tx_meta().to_xdr()

    def candidate_sig_triples(self, ltx, signer_cache: Optional[dict] = None
                              ) -> List[Tuple[bytes, bytes, bytes]]:
        """Every (ed25519-key, signature, contents-hash) pair a
        SignatureChecker over this tx could end up verifying: hint-matching
        pairs against the signer sets (master key + account signers) of the
        tx source and every op source. Used by TxSetFrame.check_or_trim's
        two-phase prewarm — one device dispatch for the whole set, then the
        per-tx walk completes off the warm verify cache (reference hot
        caller #3, TxSetFrame.cpp:277-359, batched for the device)."""
        accs = {self.source_account_id().key_bytes}
        for f in self.op_frames:
            accs.add(f.source_account_id().key_bytes)
        return collect_sig_triples(ltx, accs, self.signatures,
                                   self.contents_hash(), signer_cache)

    # -- fees ---------------------------------------------------------------
    def min_fee(self, header) -> int:
        return header.baseFee * max(1, self.num_operations())

    def fee_charged(self, header, base_fee: Optional[int] = None) -> int:
        """Effective fee: bid capped by per-op base fee (protocol >= 11
        semantics: charge baseFee per op, never more than bid)."""
        eff_base = base_fee if base_fee is not None else header.baseFee
        return min(self.fee_bid, eff_base * max(1, self.num_operations()))

    # -- validity -----------------------------------------------------------
    def _common_valid(self, checker: SignatureChecker, ltx,
                      current_seq: int, applying: bool) -> int:
        header = ltx.load_header()
        tb = self.tx.timeBounds
        if tb is not None:
            close_time = header.scpValue.closeTime
            if tb.minTime and close_time < tb.minTime:
                return TransactionResultCode.txTOO_EARLY
            if tb.maxTime and close_time > tb.maxTime:
                return TransactionResultCode.txTOO_LATE
        if not self.tx.operations:
            return TransactionResultCode.txMISSING_OPERATION
        if self.fee_bid < self.min_fee(header):
            return TransactionResultCode.txINSUFFICIENT_FEE
        src = load_account(ltx, self.source_account_id())
        if src is None:
            return TransactionResultCode.txNO_ACCOUNT
        acc = src.data.value
        if not applying or header.ledgerVersion >= 10:
            # pre-10 the sequence number was consumed when taking fees, so
            # the apply-time check is skipped; from v10 it is consumed
            # during apply and re-checked here (reference commonValid
            # TransactionFrame.cpp:462-475, isBadSeq:438)
            seq = current_seq if current_seq != 0 else acc.seqNum
            if seq == 2**63 - 1 or self.tx.seqNum != seq + 1:
                return TransactionResultCode.txBAD_SEQ
        if not self._check_signature(checker, acc, ThresholdLevel.LOW):
            return TransactionResultCode.txBAD_AUTH
        # fee must come from the AVAILABLE balance (net of reserve and
        # selling liabilities; reference commonValid + getAvailableBalance)
        if not applying and account_available_balance(header, acc) < \
                self.fee_charged(header):
            return TransactionResultCode.txINSUFFICIENT_BALANCE
        return TransactionResultCode.txSUCCESS

    def _check_signature(self, checker: SignatureChecker, acc,
                         level: int) -> bool:
        from ..xdr import Signer, SignerKey
        signers = list(acc.signers)
        mw = account_master_weight(acc)
        if mw > 0:
            signers.append(Signer(
                key=SignerKey.ed25519(acc.accountID.key_bytes), weight=mw))
        return checker.check_signature(signers,
                                       account_threshold(acc, level))

    def check_valid(self, ltx_parent, current_seq: int = 0,
                    verifier: Optional[BatchSigVerifier] = None) -> bool:
        """Full validity check against (a temporary child of) ltx_parent.
        Never mutates state. Reference TransactionFrame::checkValid:594."""
        from ..ledger.ledgertxn import LedgerTxn
        checker = SignatureChecker(self.contents_hash(), self.signatures,
                                   verifier)
        ltx = LedgerTxn(ltx_parent)
        try:
            code = self._common_valid(checker, ltx, current_seq, False)
            if code != TransactionResultCode.txSUCCESS:
                self.result = _make_result(0, code)
                return False
            ok = True
            op_results = []
            for f in self.op_frames:
                # op-level signature check happens at checkValid time too
                # (reference OperationFrame::checkValid with !forApply)
                if not f.check_signature(ltx, checker):
                    f.set_code(OperationResultCode.opBAD_AUTH)
                    ok = False
                elif not f.check_valid(ltx):
                    ok = False
                op_results.append(f.result)
            if not ok:
                self.result = _make_result(
                    self.fee_charged(ltx.load_header()),
                    TransactionResultCode.txFAILED, op_results)
                return False
            if not checker.check_all_signatures_used():
                self.result = _make_result(
                    0, TransactionResultCode.txBAD_AUTH_EXTRA)
                return False
            self.result = _make_result(
                self.fee_charged(ltx.load_header()),
                TransactionResultCode.txSUCCESS, op_results)
            return True
        finally:
            ltx.rollback()

    # -- fee & seq processing ------------------------------------------------
    def process_fee_seq_num(self, ltx, base_fee: Optional[int]) -> None:
        """Charge the fee and consume the sequence number (reference
        processFeeSeqNum:505). Runs for every tx in the set before any
        apply."""
        header = ltx.load_header()
        fee = self.fee_charged(header, base_fee)
        src = load_account(ltx, self.source_account_id())
        assert src is not None, "fee processing on missing account"
        acc = src.data.value
        fee = min(fee, max(0, acc.balance))
        acc.balance -= fee
        if header.ledgerVersion <= 9:
            # older protocols consumed the sequence number when taking
            # fees; from v10 it is consumed during apply (reference
            # processFeeSeqNum:530-538 vs processSeqNum:369-379)
            acc.seqNum = self.tx.seqNum
        header.feePool += fee
        self.result = _make_result(fee, TransactionResultCode.txSUCCESS,
                                   [None] * len(self.op_frames))

    def _process_seq_num(self, ltx) -> None:
        """Consume the sequence number during apply, protocol >= 10
        (reference processSeqNum:369-379); runs even when the tx itself
        fails post-seq-stage validation."""
        header = ltx.load_header()
        if header.ledgerVersion < 10:
            return
        src = load_account(ltx, self.source_account_id())
        assert src is not None, "seq processing on missing account"
        acc = src.data.value
        if acc.seqNum > self.tx.seqNum:
            raise RuntimeError("unexpected account state in seq processing")
        acc.seqNum = self.tx.seqNum

    # -- apply --------------------------------------------------------------
    def _remove_one_time_signer(self, ltx) -> None:
        """Consume this tx's pre-auth-tx signer: remove it from the tx
        source and every op source account the first time the tx reaches
        signature processing at apply (reference
        removeOneTimeSignerFromAllSourceAccounts:543-566; no-op at v7)."""
        from ..xdr import SignerKey
        from .account_helpers import change_subentries
        header = ltx.load_header()
        if header.ledgerVersion == 7:
            return
        target = SignerKey.pre_auth_tx(self.contents_hash())
        accounts = {self.source_account_id().key_bytes:
                    self.source_account_id()}
        for f in self.op_frames:
            sid = f.source_account_id()
            accounts[sid.key_bytes] = sid
        for sid in accounts.values():
            entry = load_account(ltx, sid)
            if entry is None:
                continue    # source removed by an earlier merge
            acc = entry.data.value
            signers = list(acc.signers)
            idx = next((i for i, s in enumerate(signers)
                        if s.key == target), None)
            if idx is not None:
                signers.pop(idx)
                acc.signers = signers
                change_subentries(header, entry, -1)

    def process_signatures(self, checker: SignatureChecker, ltx) -> bool:
        """Protocol >= 10: check every op's signatures before applying any
        (reference processSignatures:384). Win or lose, the tx's
        pre-auth-tx signer is consumed (reference :420). Pre-10 this
        phase does nothing — op sigs check during each op's apply, and
        one-time signers are removed only after ALL ops succeed."""
        if ltx.load_header().ledgerVersion < 10:
            return True
        ok = True
        for f in self.op_frames:
            if not f.check_signature(ltx, checker):
                f.set_code(OperationResultCode.opBAD_AUTH)
                ok = False
        self._remove_one_time_signer(ltx)
        if ok and not checker.check_all_signatures_used():
            self.result = _make_result(
                self.result.feeCharged,
                TransactionResultCode.txBAD_AUTH_EXTRA)
            return False
        if not ok:
            self.result = _make_result(
                self.result.feeCharged, TransactionResultCode.txFAILED,
                [f.result for f in self.op_frames])
        return ok

    def apply(self, ltx_parent,
              verifier: Optional[BatchSigVerifier] = None,
              stats=None) -> bool:
        """Apply under a child txn of ltx_parent; on any op failure roll back
        every op's effects (fees/seqnums were already consumed).
        Reference apply:778-835 / applyOperations:676.

        `stats` (ledger/apply_stats.py ApplyStats) attributes each op's
        apply latency to its wire type — the close cockpit's Python-path
        per-op histograms."""
        from ..ledger.ledgertxn import LedgerTxn
        checker = SignatureChecker(self.contents_hash(), self.signatures,
                                   verifier)
        self._native_meta_b = None   # this apply owns the meta again
        fee = self.result.feeCharged
        # phase 1 — tx-level txn: apply-time commonValid re-check (state
        # may have changed since nomination) against the SAME checker as
        # the per-op checks, plus the v10+ sequence-number consumption.
        # This txn COMMITS into the close even when the tx (or later, an
        # op) fails — a failed tx still burns its seq num (reference
        # apply:778-835, ltxTx commit :806).
        ltx_tx = LedgerTxn(ltx_parent)
        try:
            code = self._common_valid(checker, ltx_tx, 0, True)
            if code not in _PRE_SEQ_FAILURES:
                # validation got past the seq-num stage (reference
                # cv >= kInvalidUpdateSeqNum → processSeqNum)
                self._process_seq_num(ltx_tx)
            if code == TransactionResultCode.txSUCCESS:
                sigs_ok = self.process_signatures(checker, ltx_tx)
            else:
                sigs_ok = False
                if ltx_tx.load_header().ledgerVersion >= 13:
                    # v13 fast-fail consumes the pre-auth signer for ANY
                    # invalid tx (reference processSignatures:396-400 has
                    # no pre-seq exclusion)
                    self._remove_one_time_signer(ltx_tx)
            self.tx_changes = delta_to_changes(ltx_tx.get_delta())
            ltx_tx.commit()
        except SignatureVerifyError:
            if ltx_tx._open:
                ltx_tx.rollback()
            raise
        except Exception:
            self.result = _make_result(
                fee, TransactionResultCode.txINTERNAL_ERROR)
            self.tx_changes = []
            if ltx_tx._open:
                ltx_tx.rollback()   # never leave the nested txn
                # registered: the NEXT frame's LedgerTxn(parent) asserts
            return False
        if code != TransactionResultCode.txSUCCESS:
            self.result = _make_result(fee, code)
            return False
        if not sigs_ok:
            # process_signatures set the result
            return False
        # phase 2 — apply every op (even after a failure) inside nested
        # txns; the ops-level txn rolls back wholesale if any failed —
        # reference applyOperations semantics — while the committed seq
        # consumption above survives, including on internal errors
        ops_ltx = LedgerTxn(ltx_parent)
        try:
            ok = True
            op_results = []
            op_metas = []
            # pre-10 each op re-resolves its signature set against the
            # CURRENT state at its own apply (reference OperationFrame::
            # apply → checkSignature pre-10): an earlier op removing a
            # signer or lowering a weight invalidates later ops. From 10
            # the set resolved once in process_signatures above.
            pre10 = ops_ltx.load_header().ledgerVersion < 10
            if stats is not None:
                from ..ledger.apply_stats import op_type_name
                from ..util.timer import real_perf_counter
            for f in self.op_frames:
                # per-op attribution (stats): the op's whole handling —
                # signature resolution (pre-10), apply, delta
                # serialization, nested-txn commit/rollback — charges to
                # its wire type, mirroring the apply engine's table
                t_op = real_perf_counter() if stats is not None else 0.0
                op_ltx = LedgerTxn(ops_ltx)
                try:
                    if pre10 and not f.check_signature(op_ltx, checker):
                        f.set_code(OperationResultCode.opBAD_AUTH)
                        ok = False
                        op_metas.append([])
                        op_ltx.rollback()
                    elif f.apply(op_ltx):
                        op_metas.append(delta_to_changes(op_ltx.get_delta()))
                        op_ltx.commit()
                    else:
                        ok = False
                        op_metas.append([])
                        op_ltx.rollback()
                except Exception:
                    op_ltx.rollback()
                    raise
                if stats is not None:
                    stats.record_op(op_type_name(f.op.body.disc),
                                    seconds=real_perf_counter() - t_op,
                                    sample=True)
                op_results.append(f.result)
            self.op_metas = op_metas if ok else [[] for _ in op_results]
            if ok and ops_ltx.load_header().ledgerVersion < 10:
                # pre-10: signatures-used check + one-time signer removal
                # happen only after every op applied (reference
                # applyOperations:713-730, txChangesAfter)
                if not checker.check_all_signatures_used():
                    self.result = _make_result(
                        fee, TransactionResultCode.txBAD_AUTH_EXTRA)
                    ops_ltx.rollback()
                    return False
                self._remove_one_time_signer(ops_ltx)
            if ok:
                self.result = _make_result(
                    fee, TransactionResultCode.txSUCCESS, op_results)
                ops_ltx.commit()
            else:
                self.result = _make_result(
                    fee, TransactionResultCode.txFAILED, op_results)
                ops_ltx.rollback()
            return ok
        except SignatureVerifyError:
            if ops_ltx._open:
                ops_ltx.rollback()
            raise
        except Exception:
            self.result = _make_result(
                fee, TransactionResultCode.txINTERNAL_ERROR)
            if ops_ltx._open:
                ops_ltx.rollback()
            return False

    def result_pair(self) -> TransactionResultPair:
        return TransactionResultPair(transactionHash=self.contents_hash(),
                                     result=self.result)


class FeeBumpTransactionFrame:
    """Outer fee-bump envelope wrapping an inner v1 transaction
    (reference FeeBumpTransactionFrame.cpp)."""

    def __init__(self, network_id: bytes,
                 envelope: TransactionEnvelope) -> None:
        assert envelope.disc == EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP
        self.network_id = network_id
        self.envelope = envelope
        fb = envelope.value.tx
        self.fee_bump = fb
        self.signatures = envelope.value.signatures
        inner_env = TransactionEnvelope(
            EnvelopeType.ENVELOPE_TYPE_TX, fb.innerTx.value)
        self.inner = TransactionFrame(network_id, inner_env)
        self._result: Optional[TransactionResult] = _make_result(
            0, TransactionResultCode.txFEE_BUMP_INNER_SUCCESS)
        self._contents_hash: Optional[bytes] = None
        self._env_bytes: Optional[bytes] = None
        self._full_hash: Optional[bytes] = None
        self._env_sig_fp: tuple = ()
        self._sig_frozen = False
        self._fee_meta: list = []
        self._native_result_b: Optional[bytes] = None
        self._native_fee_b: Optional[bytes] = None
        self._native_meta_b: Optional[bytes] = None

    def set_native_apply_output(self, result_b: bytes, fee_changes_b: bytes,
                                meta_b: bytes) -> None:
        """Install the apply engine's per-tx outputs (all XDR
        bytes) — the fee-bump twin of TransactionFrame's installer. The
        result wraps the inner pair; the meta is the INNER tx's apply
        meta (tx_meta delegates to it on the Python path too)."""
        self._result = None
        self._native_result_b = result_b
        self._fee_meta = None
        self._native_fee_b = fee_changes_b
        self._native_meta_b = meta_b

    @property
    def result(self) -> TransactionResult:
        if self._result is None and self._native_result_b is not None:
            self._result = TransactionResult.from_xdr(
                self._native_result_b)
        return self._result

    @result.setter
    def result(self, r: TransactionResult) -> None:
        self._result = r
        self._native_result_b = None

    @property
    def fee_meta(self) -> list:
        if self._fee_meta is None and self._native_fee_b is not None:
            from ..xdr import LedgerEntryChanges
            from ..xdr.codec import xdr_from
            self._fee_meta = xdr_from(LedgerEntryChanges,
                                      self._native_fee_b)
        return self._fee_meta

    @fee_meta.setter
    def fee_meta(self, changes: list) -> None:
        self._fee_meta = changes
        self._native_fee_b = None

    @property
    def op_metas(self):
        return self.inner.op_metas

    def tx_meta(self):
        from ..xdr import TransactionMeta
        if self._native_meta_b is not None:
            return TransactionMeta.from_xdr(self._native_meta_b)
        return self.inner.tx_meta()

    def tx_meta_xdr(self) -> bytes:
        if self._native_meta_b is not None:
            return self._native_meta_b
        return self.inner.tx_meta_xdr()

    def fee_meta_xdr(self) -> bytes:
        if self._native_fee_b is not None:
            return self._native_fee_b
        from ..xdr import LedgerEntryChanges
        from ..xdr.codec import xdr_bytes
        return xdr_bytes(LedgerEntryChanges, self.fee_meta)

    def source_account_id(self) -> PublicKey:
        return self.fee_bump.feeSource.account_id

    def seq_account_id(self) -> PublicKey:
        """Chain key = the inner tx's source (whose seqNum is consumed),
        NOT the fee source (reference FeeBumpTransactionFrame::
        getSourceID returns the inner source)."""
        return self.inner.source_account_id()

    def fee_account_id(self) -> PublicKey:
        return self.fee_bump.feeSource.account_id

    @property
    def seq_num(self) -> int:
        return self.inner.seq_num

    @property
    def fee_bid(self) -> int:
        return self.fee_bump.fee

    def num_operations(self) -> int:
        return self.inner.num_operations() + 1

    def signature_payload(self) -> bytes:
        p = TransactionSignaturePayload(
            networkId=self.network_id,
            taggedTransaction=_TaggedTransaction(
                EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP, self.fee_bump))
        return p.to_xdr()

    def contents_hash(self) -> bytes:
        if self._contents_hash is None:
            self._contents_hash = sha256(self.signature_payload())
        return self._contents_hash

    def _sig_fingerprint(self) -> tuple:
        return (tuple((ds.hint, ds.signature) for ds in self.signatures),
                self.inner._sig_fingerprint())

    def freeze_signatures(self) -> None:
        self.inner.freeze_signatures()
        self.envelope_bytes()   # prime under the full check
        self._sig_frozen = True

    def result_pair_xdr(self) -> bytes:
        rb = self._native_result_b
        if rb is None:
            rb = self.result.to_xdr()
        return self.contents_hash() + rb

    def envelope_bytes(self) -> bytes:
        if self._sig_frozen and self._env_bytes is not None:
            return self._env_bytes
        fp = self._sig_fingerprint()
        if self._env_bytes is None or fp != self._env_sig_fp:
            self._env_bytes = self.envelope.to_xdr()
            self._full_hash = None
            self._env_sig_fp = fp
        return self._env_bytes

    def full_hash(self) -> bytes:
        b = self.envelope_bytes()
        if self._full_hash is None:
            self._full_hash = sha256(b)
        return self._full_hash

    def add_signature(self, secret_key) -> None:
        self._env_bytes = None
        self._full_hash = None
        self.signatures.append(
            secret_key.sign_decorated(self.contents_hash()))

    def candidate_sig_triples(self, ltx, signer_cache: Optional[dict] = None
                              ) -> List[Tuple[bytes, bytes, bytes]]:
        """Fee-bump outer signatures (fee source signers) + the inner tx's
        triples; see TransactionFrame.candidate_sig_triples."""
        out = collect_sig_triples(
            ltx, {self.source_account_id().key_bytes}, self.signatures,
            self.contents_hash(), signer_cache)
        out.extend(self.inner.candidate_sig_triples(ltx, signer_cache))
        return out

    def min_fee(self, header) -> int:
        return header.baseFee * self.num_operations()

    def fee_charged(self, header, base_fee: Optional[int] = None) -> int:
        eff_base = base_fee if base_fee is not None else header.baseFee
        return min(self.fee_bid, eff_base * self.num_operations())

    def _inner_pair(self):
        from ..xdr import InnerTransactionResultPair
        return InnerTransactionResultPair(
            transactionHash=self.inner.contents_hash(),
            result=self.inner.result)

    def _common_valid(self, checker: SignatureChecker, ltx,
                      applying: bool) -> int:
        """Outer-envelope checks shared by check_valid and apply
        (reference FeeBumpTransactionFrame::commonValid): protocol gate,
        fee floors, fee-source existence, LOW-threshold auth,
        all-signatures-used, and (when not applying) the fee-source
        balance."""
        header = ltx.load_header()
        if header.ledgerVersion < 13:
            # fee bumps are CAP-0015, protocol 13 (reference commonValid
            # → txNOT_SUPPORTED below)
            return TransactionResultCode.txNOT_SUPPORTED
        if self.fee_bid < self.min_fee(header) or \
                self.fee_bid < self.inner.fee_bid:
            return TransactionResultCode.txINSUFFICIENT_FEE
        src = load_account(ltx, self.source_account_id())
        if src is None:
            return TransactionResultCode.txNO_ACCOUNT
        acc = src.data.value
        from ..xdr import Signer, SignerKey
        signers = list(acc.signers)
        mw = account_master_weight(acc)
        if mw > 0:
            signers.append(Signer(
                key=SignerKey.ed25519(acc.accountID.key_bytes),
                weight=mw))
        if not checker.check_signature(
                signers, account_threshold(acc, ThresholdLevel.LOW)):
            return TransactionResultCode.txBAD_AUTH
        if not checker.check_all_signatures_used():
            return TransactionResultCode.txBAD_AUTH_EXTRA
        if not applying and account_available_balance(header, acc) < \
                self.fee_charged(header):
            return TransactionResultCode.txINSUFFICIENT_BALANCE
        return TransactionResultCode.txSUCCESS

    def check_valid(self, ltx_parent, current_seq: int = 0,
                    verifier=None) -> bool:
        from ..ledger.ledgertxn import LedgerTxn
        checker = SignatureChecker(self.contents_hash(), self.signatures,
                                   verifier)
        ltx = LedgerTxn(ltx_parent)
        try:
            code = self._common_valid(checker, ltx, False)
            if code != TransactionResultCode.txSUCCESS:
                self.result = _make_result(0, code)
                return False
        finally:
            ltx.rollback()
        if not self.inner.check_valid(ltx_parent, current_seq, verifier):
            self.result = _make_result(
                0, TransactionResultCode.txFEE_BUMP_INNER_FAILED)
            self.result.result = _TxResultResult(
                TransactionResultCode.txFEE_BUMP_INNER_FAILED,
                self._inner_pair())
            return False
        self.result = TransactionResult(
            feeCharged=0,
            result=_TxResultResult(
                TransactionResultCode.txFEE_BUMP_INNER_SUCCESS,
                self._inner_pair()),
            ext=_Ext.v0())
        return True

    def process_fee_seq_num(self, ltx, base_fee: Optional[int]) -> None:
        header = ltx.load_header()
        fee = self.fee_charged(header, base_fee)
        src = load_account(ltx, self.source_account_id())
        assert src is not None
        acc = src.data.value
        fee = min(fee, max(0, acc.balance))
        acc.balance -= fee
        header.feePool += fee
        # the inner seq num is NOT consumed here: fee bumps exist only at
        # protocol >= 13, where sequence numbers are consumed during the
        # inner tx's apply (reference FeeBumpTransactionFrame
        # processFeeSeqNum:343-367 charges the fee source only)
        self.result = TransactionResult(
            feeCharged=fee,
            result=_TxResultResult(
                TransactionResultCode.txFEE_BUMP_INNER_SUCCESS,
                self._inner_pair()),
            ext=_Ext.v0())

    def apply(self, ltx_parent, verifier=None, stats=None) -> bool:
        # re-check the OUTER envelope at apply like the reference
        # (FeeBumpTransactionFrame::apply → commonValid + processSignatures
        # over the outer signatures): fee-source auth may have changed
        # since validation, and every outer signature must be used
        from ..ledger.ledgertxn import LedgerTxn
        checker = SignatureChecker(self.contents_hash(), self.signatures,
                                   verifier)
        self._native_meta_b = None   # this apply owns the meta again
        ltx = LedgerTxn(ltx_parent)
        try:
            code = self._common_valid(checker, ltx, True)
            if code != TransactionResultCode.txSUCCESS:
                self.result = _make_result(self.result.feeCharged, code)
                return False
        finally:
            ltx.rollback()
        self.inner.result = _make_result(
            0, TransactionResultCode.txSUCCESS,
            [None] * len(self.inner.op_frames))
        ok = self.inner.apply(ltx_parent, verifier, stats=stats)
        code = (TransactionResultCode.txFEE_BUMP_INNER_SUCCESS if ok
                else TransactionResultCode.txFEE_BUMP_INNER_FAILED)
        self.result = TransactionResult(
            feeCharged=self.result.feeCharged,
            result=_TxResultResult(code, self._inner_pair()),
            ext=_Ext.v0())
        return ok

    def result_pair(self) -> TransactionResultPair:
        return TransactionResultPair(transactionHash=self.contents_hash(),
                                     result=self.result)
