"""OperationFrame: per-operation validity + apply logic.

Copied from `stellar_core_tpu/transactions/operation_frame.py` at commit
86c1c88; carry a fix in either copy to the other.

Role parity: reference `src/transactions/OperationFrame.{h,cpp}` — op-level
source account resolution, threshold-level signature check, doCheckValid
(ledger-independent) and doApply (against a LedgerTxn).
"""

from __future__ import annotations

from typing import Optional

from ..xdr import (
    LedgerKey, Operation, OperationResult, OperationResultCode, OperationType,
    PublicKey,
)
from .account_helpers import (
    ThresholdLevel, account_master_weight, account_threshold, load_account,
)
from .signature_checker import SignatureChecker


class OperationFrame:
    """Base class; subclasses implement do_check_valid/do_apply and may
    override threshold_level/needed_signers.

    The frame does not own its transaction (the reference's
    `TransactionFrame&`): it keeps only the parent's source account, its
    fallback source, so a transaction frame and its op frames form no
    cycle, and whoever holds the transaction frame holds its lifetime."""

    op_type: int = -1

    def __init__(self, op: Operation, parent_tx) -> None:
        self.op = op
        # the parent's (for a fee bump, the inner transaction's) source
        self._tx_source = parent_tx.tx.sourceAccount
        self.result: Optional[OperationResult] = None

    # -- source account -----------------------------------------------------
    def source_account_id(self) -> PublicKey:
        if self.op.sourceAccount is not None:
            return self.op.sourceAccount.account_id
        return self._tx_source.account_id

    # -- signature / threshold ----------------------------------------------
    def threshold_level(self) -> int:
        return ThresholdLevel.MEDIUM

    def check_signature(self, ltx, checker: SignatureChecker) -> bool:
        """Resolve the op source account and check its signers at the op's
        threshold level; ops on missing accounts need the raw key signature
        (reference OperationFrame::checkSignature)."""
        acc_id = self.source_account_id()
        entry = ltx.load_without_record(LedgerKey.account(acc_id))
        if entry is not None:
            acc = entry.data.value
            needed = account_threshold(acc, self.threshold_level())
            signers = list(acc.signers)
            mw = account_master_weight(acc)
            if mw > 0:
                from ..xdr import Signer, SignerKey
                signers.append(Signer(key=SignerKey.ed25519(acc_id.key_bytes),
                                      weight=mw))
            return checker.check_signature(signers, needed)
        # account does not exist: a valid signature from exactly that key
        from ..xdr import Signer, SignerKey
        return checker.check_signature(
            [Signer(key=SignerKey.ed25519(acc_id.key_bytes), weight=1)], 0)

    # -- validity / apply ---------------------------------------------------
    def set_code(self, code: int) -> bool:
        self.result = OperationResult(code, None)
        return False

    def set_inner(self, inner_code: int, payload=None) -> bool:
        """Record an inner (op-type-specific) result; success iff code 0."""
        from ..xdr import OperationInner
        arm_cls = OperationInner.xdr_arms[self.op_type][1]
        self.result = OperationResult.inner(
            self.op_type, arm_cls(inner_code, payload))
        return inner_code == 0

    def check_valid(self, ltx) -> bool:
        """Ledger-independent checks (amounts, codes). `ltx` gives header
        access for version gating only."""
        header = ltx.get_header()
        if not self.is_version_supported(header.ledgerVersion):
            # reference OperationFrame::checkValid → opNOT_SUPPORTED
            return self.set_code(OperationResultCode.opNOT_SUPPORTED)
        return self.do_check_valid(header)

    def apply(self, ltx) -> bool:
        # version gate holds at apply too: replayed history can reach
        # apply without this process having run checkValid
        if not self.is_version_supported(ltx.get_header().ledgerVersion):
            return self.set_code(OperationResultCode.opNOT_SUPPORTED)
        # the op source must exist AT APPLY (reference OperationFrame::
        # checkValid forApply arm, v8+): an earlier op in the same tx may
        # have merged it away — that fails THIS op, not the process
        if ltx.load_without_record(
                LedgerKey.account(self.source_account_id())) is None:
            return self.set_code(OperationResultCode.opNO_ACCOUNT)
        return self.do_apply(ltx)

    # subclass hooks
    def is_version_supported(self, ledger_version: int) -> bool:
        """Ops retired by protocol upgrades override this (reference
        OperationFrame::isVersionSupported)."""
        return True

    def do_check_valid(self, header) -> bool:
        raise NotImplementedError

    def do_apply(self, ltx) -> bool:
        raise NotImplementedError


_REGISTRY: dict[int, type] = {}


def register_op(cls):
    _REGISTRY[cls.op_type] = cls
    return cls


def make_operation_frame(op: Operation, parent_tx) -> OperationFrame:
    t = op.body.disc
    cls = _REGISTRY.get(t)
    if cls is None:
        raise ValueError("unsupported operation type %d" % t)
    return cls(op, parent_tx)
