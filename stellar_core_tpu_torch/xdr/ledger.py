"""Ledger header, close values, upgrades, history entries, meta.

Copied from `stellar_core_tpu/xdr/ledger.py` at commit 05e2f75; carry a fix
in either copy to the other.

Role parity: reference `src/xdr/Stellar-ledger.x`.
"""

from __future__ import annotations

from .basic import Hash, NodeID, Signature, UpgradeType, Value
from .ledger_entries import LedgerEntry, LedgerKey, _Ext
from .transaction import (
    TransactionEnvelope, TransactionResultPair, OperationResult,
)
from .codec import (
    FixedArray, Int64, Uint32, Uint64, VarArray, XdrStruct, XdrUnion,
)


class LedgerCloseValueSignature(XdrStruct):
    xdr_fields = [("nodeID", NodeID), ("signature", Signature)]


class StellarValueExt(XdrUnion):
    STELLAR_VALUE_BASIC = 0
    STELLAR_VALUE_SIGNED = 1
    xdr_arms = {
        0: ("basic", None),
        1: ("lcValueSignature", LedgerCloseValueSignature),
    }


class StellarValue(XdrStruct):
    """The value SCP agrees on per slot: (txset hash, closeTime, upgrades).

    Reference: Stellar-ledger.x StellarValue; built in
    HerderImpl::triggerNextLedger (reference `src/herder/HerderImpl.cpp:743`).
    """
    MAX_UPGRADES = 6
    xdr_fields = [
        ("txSetHash", Hash),
        ("closeTime", Uint64),
        ("upgrades", VarArray(UpgradeType, 6)),
        ("ext", StellarValueExt),
    ]


class LedgerHeader(XdrStruct):
    xdr_fields = [
        ("ledgerVersion", Uint32),
        ("previousLedgerHash", Hash),
        ("scpValue", StellarValue),
        ("txSetResultHash", Hash),
        ("bucketListHash", Hash),
        ("ledgerSeq", Uint32),
        ("totalCoins", Int64),
        ("feePool", Int64),
        ("inflationSeq", Uint32),
        ("idPool", Uint64),
        ("baseFee", Uint32),
        ("baseReserve", Uint32),
        ("maxTxSetSize", Uint32),
        ("skipList", FixedArray(Hash, 4)),
        ("ext", _Ext),
    ]


class LedgerUpgradeType:
    LEDGER_UPGRADE_VERSION = 1
    LEDGER_UPGRADE_BASE_FEE = 2
    LEDGER_UPGRADE_MAX_TX_SET_SIZE = 3
    LEDGER_UPGRADE_BASE_RESERVE = 4


class LedgerUpgrade(XdrUnion):
    xdr_arms = {
        LedgerUpgradeType.LEDGER_UPGRADE_VERSION: ("newLedgerVersion", Uint32),
        LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE: ("newBaseFee", Uint32),
        LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            ("newMaxTxSetSize", Uint32),
        LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE: ("newBaseReserve", Uint32),
    }


class TransactionSet(XdrStruct):
    xdr_fields = [
        ("previousLedgerHash", Hash),
        ("txs", VarArray(TransactionEnvelope)),
    ]


class LedgerHeaderHistoryEntry(XdrStruct):
    xdr_fields = [("hash", Hash), ("header", LedgerHeader), ("ext", _Ext)]


class TransactionHistoryEntry(XdrStruct):
    xdr_fields = [("ledgerSeq", Uint32), ("txSet", TransactionSet),
                  ("ext", _Ext)]


class TransactionHistoryResultEntry(XdrStruct):
    from .transaction import TransactionResultSet as _TRS
    xdr_fields = [("ledgerSeq", Uint32), ("txResultSet", _TRS), ("ext", _Ext)]


# --- Ledger entry change meta ---------------------------------------------

class LedgerEntryChangeType:
    LEDGER_ENTRY_CREATED = 0
    LEDGER_ENTRY_UPDATED = 1
    LEDGER_ENTRY_REMOVED = 2
    LEDGER_ENTRY_STATE = 3


class LedgerEntryChange(XdrUnion):
    xdr_arms = {
        LedgerEntryChangeType.LEDGER_ENTRY_CREATED: ("created", LedgerEntry),
        LedgerEntryChangeType.LEDGER_ENTRY_UPDATED: ("updated", LedgerEntry),
        LedgerEntryChangeType.LEDGER_ENTRY_REMOVED: ("removed", LedgerKey),
        LedgerEntryChangeType.LEDGER_ENTRY_STATE: ("state", LedgerEntry),
    }


LedgerEntryChanges = VarArray(LedgerEntryChange)


class OperationMeta(XdrStruct):
    xdr_fields = [("changes", LedgerEntryChanges)]


class TransactionMetaV1(XdrStruct):
    xdr_fields = [("txChanges", LedgerEntryChanges),
                  ("operations", VarArray(OperationMeta))]


class TransactionMeta(XdrUnion):
    xdr_arms = {1: ("v1", TransactionMetaV1)}


# --- Ledger close meta (reference src/xdr/Stellar-ledger.x:282-320) --------
# The full per-close record streamed to downstream consumers (Horizon-style
# ingestion) via METADATA_OUTPUT_STREAM.

class TransactionResultMeta(XdrStruct):
    xdr_fields = [
        ("result", TransactionResultPair),
        ("feeProcessing", LedgerEntryChanges),
        ("txApplyProcessing", TransactionMeta),
    ]


class UpgradeEntryMeta(XdrStruct):
    xdr_fields = [
        ("upgrade", LedgerUpgrade),
        ("changes", LedgerEntryChanges),
    ]


class LedgerCloseMetaV0(XdrStruct):
    from .scp import SCPHistoryEntry as _SHE
    xdr_fields = [
        ("ledgerHeader", LedgerHeaderHistoryEntry),
        ("txSet", TransactionSet),
        # in apply order, one entry per tx: result + fee-processing
        # changes + full apply meta
        ("txProcessing", VarArray(TransactionResultMeta)),
        ("upgradesProcessing", VarArray(UpgradeEntryMeta)),
        ("scpInfo", VarArray(_SHE)),
    ]


class LedgerCloseMeta(XdrUnion):
    xdr_arms = {0: ("v0", LedgerCloseMetaV0)}

    @classmethod
    def v0(cls, value) -> "LedgerCloseMeta":
        return cls(0, value)


# --- Bucket entries (reference src/xdr/Stellar-ledger.x:148-182) -----------

class BucketEntryType:
    """METAENTRY sorts first in buckets; INITENTRY = created (protocol>=11),
    LIVEENTRY = updated, DEADENTRY = tombstone."""
    METAENTRY = -1
    LIVEENTRY = 0
    DEADENTRY = 1
    INITENTRY = 2


class BucketMetadata(XdrStruct):
    """First entry of every bucket at protocol >= 11; records the protocol
    version used to create/merge the bucket."""
    xdr_fields = [("ledgerVersion", Uint32), ("ext", _Ext)]


class BucketEntry(XdrUnion):
    xdr_arms = {
        BucketEntryType.LIVEENTRY: ("liveEntry", LedgerEntry),
        BucketEntryType.INITENTRY: ("liveEntry", LedgerEntry),
        BucketEntryType.DEADENTRY: ("deadEntry", LedgerKey),
        BucketEntryType.METAENTRY: ("metaEntry", BucketMetadata),
    }

    @classmethod
    def live(cls, e: LedgerEntry) -> "BucketEntry":
        return cls(BucketEntryType.LIVEENTRY, e)

    @classmethod
    def init(cls, e: LedgerEntry) -> "BucketEntry":
        return cls(BucketEntryType.INITENTRY, e)

    @classmethod
    def dead(cls, k: LedgerKey) -> "BucketEntry":
        return cls(BucketEntryType.DEADENTRY, k)

    @classmethod
    def meta(cls, ledger_version: int) -> "BucketEntry":
        return cls(BucketEntryType.METAENTRY,
                   BucketMetadata(ledgerVersion=ledger_version,
                                  ext=_Ext.v0()))
