"""Transaction, operation, and result types.

Copied from `stellar_core_tpu/xdr/transaction.py` at commit a7226ae; carry a
fix in either copy to the other.

Role parity: reference `src/xdr/Stellar-transaction.x` (14 operation types,
envelopes incl. fee bump, signature payload, results).
"""

from __future__ import annotations

from .basic import (
    AccountID, DecoratedSignature, EnvelopeType, Hash, MuxedAccount, String32,
    String64, DataValue, Uint256,
)
from .ledger_entries import (
    Asset, OfferEntry, Price, SequenceNumber, Signer, _Ext,
)
from .codec import (
    Int32, Int64, Opaque, OptionalT, Uint32, Uint64, VarArray, VarOpaque,
    XdrString, XdrStruct, XdrUnion, XdrError, Packer,
)


class OperationType:
    CREATE_ACCOUNT = 0
    PAYMENT = 1
    PATH_PAYMENT_STRICT_RECEIVE = 2
    MANAGE_SELL_OFFER = 3
    CREATE_PASSIVE_SELL_OFFER = 4
    SET_OPTIONS = 5
    CHANGE_TRUST = 6
    ALLOW_TRUST = 7
    ACCOUNT_MERGE = 8
    INFLATION = 9
    MANAGE_DATA = 10
    BUMP_SEQUENCE = 11
    MANAGE_BUY_OFFER = 12
    PATH_PAYMENT_STRICT_SEND = 13

    ALL = list(range(14))


class CreateAccountOp(XdrStruct):
    xdr_fields = [("destination", AccountID), ("startingBalance", Int64)]


class PaymentOp(XdrStruct):
    xdr_fields = [("destination", MuxedAccount), ("asset", Asset),
                  ("amount", Int64)]


class PathPaymentStrictReceiveOp(XdrStruct):
    xdr_fields = [
        ("sendAsset", Asset), ("sendMax", Int64),
        ("destination", MuxedAccount), ("destAsset", Asset),
        ("destAmount", Int64), ("path", VarArray(Asset, 5)),
    ]


class PathPaymentStrictSendOp(XdrStruct):
    xdr_fields = [
        ("sendAsset", Asset), ("sendAmount", Int64),
        ("destination", MuxedAccount), ("destAsset", Asset),
        ("destMin", Int64), ("path", VarArray(Asset, 5)),
    ]


class ManageSellOfferOp(XdrStruct):
    xdr_fields = [("selling", Asset), ("buying", Asset), ("amount", Int64),
                  ("price", Price), ("offerID", Int64)]


class ManageBuyOfferOp(XdrStruct):
    xdr_fields = [("selling", Asset), ("buying", Asset), ("buyAmount", Int64),
                  ("price", Price), ("offerID", Int64)]


class CreatePassiveSellOfferOp(XdrStruct):
    xdr_fields = [("selling", Asset), ("buying", Asset), ("amount", Int64),
                  ("price", Price)]


class SetOptionsOp(XdrStruct):
    xdr_fields = [
        ("inflationDest", OptionalT(AccountID)),
        ("clearFlags", OptionalT(Uint32)),
        ("setFlags", OptionalT(Uint32)),
        ("masterWeight", OptionalT(Uint32)),
        ("lowThreshold", OptionalT(Uint32)),
        ("medThreshold", OptionalT(Uint32)),
        ("highThreshold", OptionalT(Uint32)),
        ("homeDomain", OptionalT(String32)),
        ("signer", OptionalT(Signer)),
    ]


class ChangeTrustOp(XdrStruct):
    xdr_fields = [("line", Asset), ("limit", Int64)]


class AllowTrustAsset(XdrUnion):
    xdr_arms = {
        1: ("assetCode4", Opaque(4)),
        2: ("assetCode12", Opaque(12)),
    }


class AllowTrustOp(XdrStruct):
    xdr_fields = [("trustor", AccountID), ("asset", AllowTrustAsset),
                  ("authorize", Uint32)]


class ManageDataOp(XdrStruct):
    xdr_fields = [("dataName", String64), ("dataValue", OptionalT(DataValue))]


class BumpSequenceOp(XdrStruct):
    xdr_fields = [("bumpTo", SequenceNumber)]


class OperationBody(XdrUnion):
    xdr_arms = {
        OperationType.CREATE_ACCOUNT: ("createAccountOp", CreateAccountOp),
        OperationType.PAYMENT: ("paymentOp", PaymentOp),
        OperationType.PATH_PAYMENT_STRICT_RECEIVE:
            ("pathPaymentStrictReceiveOp", PathPaymentStrictReceiveOp),
        OperationType.MANAGE_SELL_OFFER: ("manageSellOfferOp", ManageSellOfferOp),
        OperationType.CREATE_PASSIVE_SELL_OFFER:
            ("createPassiveSellOfferOp", CreatePassiveSellOfferOp),
        OperationType.SET_OPTIONS: ("setOptionsOp", SetOptionsOp),
        OperationType.CHANGE_TRUST: ("changeTrustOp", ChangeTrustOp),
        OperationType.ALLOW_TRUST: ("allowTrustOp", AllowTrustOp),
        OperationType.ACCOUNT_MERGE: ("destination", MuxedAccount),
        OperationType.INFLATION: ("inflation", None),
        OperationType.MANAGE_DATA: ("manageDataOp", ManageDataOp),
        OperationType.BUMP_SEQUENCE: ("bumpSequenceOp", BumpSequenceOp),
        OperationType.MANAGE_BUY_OFFER: ("manageBuyOfferOp", ManageBuyOfferOp),
        OperationType.PATH_PAYMENT_STRICT_SEND:
            ("pathPaymentStrictSendOp", PathPaymentStrictSendOp),
    }


class Operation(XdrStruct):
    xdr_fields = [("sourceAccount", OptionalT(MuxedAccount)),
                  ("body", OperationBody)]


class MemoType:
    MEMO_NONE = 0
    MEMO_TEXT = 1
    MEMO_ID = 2
    MEMO_HASH = 3
    MEMO_RETURN = 4


class Memo(XdrUnion):
    xdr_arms = {
        MemoType.MEMO_NONE: ("none", None),
        MemoType.MEMO_TEXT: ("text", XdrString(28)),
        MemoType.MEMO_ID: ("id", Uint64),
        MemoType.MEMO_HASH: ("hash", Hash),
        MemoType.MEMO_RETURN: ("retHash", Hash),
    }

    @classmethod
    def none(cls) -> "Memo":
        return cls(MemoType.MEMO_NONE)


class TimeBounds(XdrStruct):
    xdr_fields = [("minTime", Uint64), ("maxTime", Uint64)]


MAX_OPS_PER_TX = 100


class Transaction(XdrStruct):
    xdr_fields = [
        ("sourceAccount", MuxedAccount),
        ("fee", Uint32),
        ("seqNum", SequenceNumber),
        ("timeBounds", OptionalT(TimeBounds)),
        ("memo", Memo),
        ("operations", VarArray(Operation, MAX_OPS_PER_TX)),
        ("ext", _Ext),
    ]


class TransactionV1Envelope(XdrStruct):
    xdr_fields = [("tx", Transaction),
                  ("signatures", VarArray(DecoratedSignature, 20))]


class _InnerTxEnvelope(XdrUnion):
    xdr_arms = {EnvelopeType.ENVELOPE_TYPE_TX: ("v1", TransactionV1Envelope)}


class FeeBumpTransaction(XdrStruct):
    xdr_fields = [
        ("feeSource", MuxedAccount),
        ("fee", Int64),
        ("innerTx", _InnerTxEnvelope),
        ("ext", _Ext),
    ]


class FeeBumpTransactionEnvelope(XdrStruct):
    xdr_fields = [("tx", FeeBumpTransaction),
                  ("signatures", VarArray(DecoratedSignature, 20))]


class TransactionEnvelope(XdrUnion):
    xdr_arms = {
        EnvelopeType.ENVELOPE_TYPE_TX: ("v1", TransactionV1Envelope),
        EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
            ("feeBump", FeeBumpTransactionEnvelope),
    }

    @classmethod
    def for_tx(cls, tx: Transaction,
               signatures: list | None = None) -> "TransactionEnvelope":
        return cls(EnvelopeType.ENVELOPE_TYPE_TX,
                   TransactionV1Envelope(tx=tx, signatures=signatures or []))


class _TaggedTransaction(XdrUnion):
    xdr_arms = {
        EnvelopeType.ENVELOPE_TYPE_TX: ("tx", Transaction),
        EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP: ("feeBump", FeeBumpTransaction),
    }


class TransactionSignaturePayload(XdrStruct):
    """What is actually signed: SHA256(networkId || tagged tx).

    Reference: TransactionFrame::getSignaturePayload role
    (src/transactions/TransactionFrame.cpp contents-hash construction).
    """
    xdr_fields = [("networkId", Hash), ("taggedTransaction", _TaggedTransaction)]


# --- Results ---------------------------------------------------------------

class ClaimOfferAtom(XdrStruct):
    xdr_fields = [
        ("sellerID", AccountID), ("offerID", Int64),
        ("assetSold", Asset), ("amountSold", Int64),
        ("assetBought", Asset), ("amountBought", Int64),
    ]


class SimplePaymentResult(XdrStruct):
    xdr_fields = [("destination", AccountID), ("asset", Asset),
                  ("amount", Int64)]


def _code_union(name: str, success_codes_with_payload: dict,
                default_void: bool = True):
    """Build an op-result union class: success arms may carry payloads; any
    other (negative) code is void."""
    cls = type(name, (XdrUnion,), {
        "xdr_arms": dict(success_codes_with_payload),
        "xdr_default": ("code", None) if default_void else None,
    })
    return cls


class ManageOfferSuccessResultOffer(XdrUnion):
    # MANAGE_OFFER_CREATED=0 / UPDATED=1 carry the offer; DELETED=2 void
    xdr_arms = {
        0: ("created", OfferEntry),
        1: ("updated", OfferEntry),
        2: ("deleted", None),
    }


class ManageOfferSuccessResult(XdrStruct):
    xdr_fields = [("offersClaimed", VarArray(ClaimOfferAtom)),
                  ("offer", ManageOfferSuccessResultOffer)]


class PathPaymentSuccess(XdrStruct):
    xdr_fields = [("offers", VarArray(ClaimOfferAtom)),
                  ("last", SimplePaymentResult)]


class InflationPayout(XdrStruct):
    xdr_fields = [("destination", AccountID), ("amount", Int64)]


CreateAccountResult = _code_union("CreateAccountResult", {0: ("success", None)})
PaymentResult = _code_union("PaymentResult", {0: ("success", None)})
PathPaymentStrictReceiveResult = _code_union(
    "PathPaymentStrictReceiveResult", {0: ("success", PathPaymentSuccess)})
PathPaymentStrictSendResult = _code_union(
    "PathPaymentStrictSendResult", {0: ("success", PathPaymentSuccess)})
ManageSellOfferResult = _code_union(
    "ManageSellOfferResult", {0: ("success", ManageOfferSuccessResult)})
ManageBuyOfferResult = _code_union(
    "ManageBuyOfferResult", {0: ("success", ManageOfferSuccessResult)})
SetOptionsResult = _code_union("SetOptionsResult", {0: ("success", None)})
ChangeTrustResult = _code_union("ChangeTrustResult", {0: ("success", None)})
AllowTrustResult = _code_union("AllowTrustResult", {0: ("success", None)})
AccountMergeResult = _code_union(
    "AccountMergeResult", {0: ("sourceAccountBalance", Int64)})
InflationResult = _code_union(
    "InflationResult", {0: ("payouts", VarArray(InflationPayout))})
ManageDataResult = _code_union("ManageDataResult", {0: ("success", None)})
BumpSequenceResult = _code_union("BumpSequenceResult", {0: ("success", None)})


class OperationInner(XdrUnion):
    xdr_arms = {
        OperationType.CREATE_ACCOUNT: ("createAccountResult", CreateAccountResult),
        OperationType.PAYMENT: ("paymentResult", PaymentResult),
        OperationType.PATH_PAYMENT_STRICT_RECEIVE:
            ("pathPaymentStrictReceiveResult", PathPaymentStrictReceiveResult),
        OperationType.MANAGE_SELL_OFFER:
            ("manageSellOfferResult", ManageSellOfferResult),
        OperationType.CREATE_PASSIVE_SELL_OFFER:
            ("createPassiveSellOfferResult", ManageSellOfferResult),
        OperationType.SET_OPTIONS: ("setOptionsResult", SetOptionsResult),
        OperationType.CHANGE_TRUST: ("changeTrustResult", ChangeTrustResult),
        OperationType.ALLOW_TRUST: ("allowTrustResult", AllowTrustResult),
        OperationType.ACCOUNT_MERGE: ("accountMergeResult", AccountMergeResult),
        OperationType.INFLATION: ("inflationResult", InflationResult),
        OperationType.MANAGE_DATA: ("manageDataResult", ManageDataResult),
        OperationType.BUMP_SEQUENCE: ("bumpSequenceResult", BumpSequenceResult),
        OperationType.MANAGE_BUY_OFFER:
            ("manageBuyOfferResult", ManageBuyOfferResult),
        OperationType.PATH_PAYMENT_STRICT_SEND:
            ("pathPaymentStrictSendResult", PathPaymentStrictSendResult),
    }


class OperationResultCode:
    opINNER = 0
    opBAD_AUTH = -1
    opNO_ACCOUNT = -2
    opNOT_SUPPORTED = -3
    opTOO_MANY_SUBENTRIES = -4
    opEXCEEDED_WORK_LIMIT = -5


class OperationResult(XdrUnion):
    xdr_arms = {OperationResultCode.opINNER: ("tr", OperationInner)}
    xdr_default = ("code", None)

    @classmethod
    def inner(cls, op_type: int, inner_result) -> "OperationResult":
        return cls(OperationResultCode.opINNER,
                   OperationInner(op_type, inner_result))


class TransactionResultCode:
    txFEE_BUMP_INNER_SUCCESS = 1
    txSUCCESS = 0
    txFAILED = -1
    txTOO_EARLY = -2
    txTOO_LATE = -3
    txMISSING_OPERATION = -4
    txBAD_SEQ = -5
    txBAD_AUTH = -6
    txINSUFFICIENT_BALANCE = -7
    txNO_ACCOUNT = -8
    txINSUFFICIENT_FEE = -9
    txBAD_AUTH_EXTRA = -10
    txINTERNAL_ERROR = -11
    txNOT_SUPPORTED = -12
    txFEE_BUMP_INNER_FAILED = -13


class InnerTransactionResultPair(XdrStruct):
    # forward-declared; fields patched after TransactionResult defined
    xdr_fields = []


class _TxResultResult(XdrUnion):
    xdr_arms = {
        TransactionResultCode.txSUCCESS: ("results", VarArray(OperationResult)),
        TransactionResultCode.txFAILED: ("results", VarArray(OperationResult)),
        TransactionResultCode.txFEE_BUMP_INNER_SUCCESS:
            ("innerResultPair", InnerTransactionResultPair),
        TransactionResultCode.txFEE_BUMP_INNER_FAILED:
            ("innerResultPair", InnerTransactionResultPair),
    }
    xdr_default = ("code", None)


class TransactionResult(XdrStruct):
    xdr_fields = [
        ("feeCharged", Int64),
        ("result", _TxResultResult),
        ("ext", _Ext),
    ]

    @property
    def code(self) -> int:
        return self.result.disc

    @property
    def op_results(self):
        if self.result.disc in (TransactionResultCode.txSUCCESS,
                                TransactionResultCode.txFAILED):
            return self.result.value
        return []


InnerTransactionResultPair.xdr_fields = [
    ("transactionHash", Hash),
    ("result", TransactionResult),
]


class TransactionResultPair(XdrStruct):
    xdr_fields = [("transactionHash", Hash), ("result", TransactionResult)]


class TransactionResultSet(XdrStruct):
    xdr_fields = [("results", VarArray(TransactionResultPair))]
