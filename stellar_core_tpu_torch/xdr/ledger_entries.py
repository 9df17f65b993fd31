"""Ledger entry types: accounts, trustlines, offers, data.

Copied from `stellar_core_tpu/xdr/ledger_entries.py` at commit 588326f;
carry a fix in either copy to the other.

Role parity: reference `src/xdr/Stellar-ledger-entries.x`.
"""

from __future__ import annotations

from .basic import AccountID, Hash, String32, String64, DataValue, SignerKey
from .codec import (
    Int32, Int64, Opaque, OptionalT, Uint32, Uint64, VarArray, XdrStruct,
    XdrUnion, XdrError,
)


class AssetType:
    ASSET_TYPE_NATIVE = 0
    ASSET_TYPE_CREDIT_ALPHANUM4 = 1
    ASSET_TYPE_CREDIT_ALPHANUM12 = 2


class AssetAlphaNum4(XdrStruct):
    xdr_fields = [("assetCode", Opaque(4)), ("issuer", AccountID)]


class AssetAlphaNum12(XdrStruct):
    xdr_fields = [("assetCode", Opaque(12)), ("issuer", AccountID)]


class Asset(XdrUnion):
    xdr_arms = {
        AssetType.ASSET_TYPE_NATIVE: ("native", None),
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("alphaNum4", AssetAlphaNum4),
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("alphaNum12", AssetAlphaNum12),
    }

    @classmethod
    def native(cls) -> "Asset":
        return cls(AssetType.ASSET_TYPE_NATIVE)

    @classmethod
    def credit(cls, code: str, issuer: AccountID) -> "Asset":
        raw = code.encode("ascii")
        if not 1 <= len(raw) <= 12:
            raise XdrError("bad asset code %r" % code)
        if len(raw) <= 4:
            return cls(AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
                       AssetAlphaNum4(assetCode=raw.ljust(4, b"\x00"),
                                      issuer=issuer))
        return cls(AssetType.ASSET_TYPE_CREDIT_ALPHANUM12,
                   AssetAlphaNum12(assetCode=raw.ljust(12, b"\x00"),
                                   issuer=issuer))

    @property
    def is_native(self) -> bool:
        return self.disc == AssetType.ASSET_TYPE_NATIVE

    @property
    def issuer(self):
        return None if self.is_native else self.value.issuer

    @property
    def code(self) -> str:
        if self.is_native:
            return "XLM"
        return self.value.assetCode.rstrip(b"\x00").decode("ascii", "replace")


class Price(XdrStruct):
    xdr_fields = [("n", Int32), ("d", Int32)]


Thresholds = Opaque(4)
SequenceNumber = Int64


class Signer(XdrStruct):
    xdr_fields = [("key", SignerKey), ("weight", Uint32)]


class AccountFlags:
    AUTH_REQUIRED_FLAG = 0x1
    AUTH_REVOCABLE_FLAG = 0x2
    AUTH_IMMUTABLE_FLAG = 0x4
    MASK_ACCOUNT_FLAGS = 0x7


class _Ext(XdrUnion):
    """Common empty-v0 extension point."""
    xdr_arms = {0: ("v0", None)}

    @classmethod
    def v0(cls) -> "_Ext":
        return cls(0)


class Liabilities(XdrStruct):
    """Protocol >= 10 balance encumbrance (reference
    Stellar-ledger-entries.x Liabilities): `buying` reserves room below
    the balance/limit ceiling, `selling` reserves balance above the
    floor — both maintained by open offers."""
    xdr_fields = [("buying", Int64), ("selling", Int64)]


class AccountEntryExtensionV1(XdrStruct):
    xdr_fields = [("liabilities", Liabilities), ("ext", _Ext)]


class AccountEntryExt(XdrUnion):
    xdr_arms = {0: ("v0", None), 1: ("v1", AccountEntryExtensionV1)}

    @classmethod
    def v0(cls) -> "AccountEntryExt":
        return cls(0)


class TrustLineEntryExtensionV1(XdrStruct):
    xdr_fields = [("liabilities", Liabilities), ("ext", _Ext)]


class TrustLineEntryExt(XdrUnion):
    xdr_arms = {0: ("v0", None), 1: ("v1", TrustLineEntryExtensionV1)}

    @classmethod
    def v0(cls) -> "TrustLineEntryExt":
        return cls(0)


class AccountEntry(XdrStruct):
    MAX_SIGNERS = 20
    xdr_fields = [
        ("accountID", AccountID),
        ("balance", Int64),
        ("seqNum", SequenceNumber),
        ("numSubEntries", Uint32),
        ("inflationDest", OptionalT(AccountID)),
        ("flags", Uint32),
        ("homeDomain", String32),
        ("thresholds", Thresholds),
        ("signers", VarArray(Signer, 20)),
        ("ext", AccountEntryExt),
    ]


class TrustLineFlags:
    AUTHORIZED_FLAG = 1
    # protocol 13 (CAP-0018): may keep existing offers/liabilities but
    # not send/receive payments or post new offers
    AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG = 2
    # either auth level — keeps/releases/executes EXISTING liabilities
    AUTH_LEVELS_MASK = 1 | 2
    MASK_TRUSTLINE_FLAGS = 1
    MASK_TRUSTLINE_FLAGS_V13 = 3


class TrustLineEntry(XdrStruct):
    xdr_fields = [
        ("accountID", AccountID),
        ("asset", Asset),
        ("balance", Int64),
        ("limit", Int64),
        ("flags", Uint32),
        ("ext", TrustLineEntryExt),
    ]


class OfferEntryFlags:
    PASSIVE_FLAG = 1


class OfferEntry(XdrStruct):
    xdr_fields = [
        ("sellerID", AccountID),
        ("offerID", Int64),
        ("selling", Asset),
        ("buying", Asset),
        ("amount", Int64),
        ("price", Price),
        ("flags", Uint32),
        ("ext", _Ext),
    ]


class DataEntry(XdrStruct):
    xdr_fields = [
        ("accountID", AccountID),
        ("dataName", String64),
        ("dataValue", DataValue),
        ("ext", _Ext),
    ]


class LedgerEntryType:
    ACCOUNT = 0
    TRUSTLINE = 1
    OFFER = 2
    DATA = 3


class LedgerEntryData(XdrUnion):
    xdr_arms = {
        LedgerEntryType.ACCOUNT: ("account", AccountEntry),
        LedgerEntryType.TRUSTLINE: ("trustLine", TrustLineEntry),
        LedgerEntryType.OFFER: ("offer", OfferEntry),
        LedgerEntryType.DATA: ("data", DataEntry),
    }


class LedgerEntry(XdrStruct):
    xdr_fields = [
        ("lastModifiedLedgerSeq", Uint32),
        ("data", LedgerEntryData),
        ("ext", _Ext),
    ]


# --- LedgerKey -------------------------------------------------------------

class LedgerKeyAccount(XdrStruct):
    xdr_fields = [("accountID", AccountID)]


class LedgerKeyTrustLine(XdrStruct):
    xdr_fields = [("accountID", AccountID), ("asset", Asset)]


class LedgerKeyOffer(XdrStruct):
    xdr_fields = [("sellerID", AccountID), ("offerID", Int64)]


class LedgerKeyData(XdrStruct):
    xdr_fields = [("accountID", AccountID), ("dataName", String64)]


class LedgerKey(XdrUnion):
    xdr_arms = {
        LedgerEntryType.ACCOUNT: ("account", LedgerKeyAccount),
        LedgerEntryType.TRUSTLINE: ("trustLine", LedgerKeyTrustLine),
        LedgerEntryType.OFFER: ("offer", LedgerKeyOffer),
        LedgerEntryType.DATA: ("data", LedgerKeyData),
    }

    @classmethod
    def account(cls, acc: AccountID) -> "LedgerKey":
        return cls(LedgerEntryType.ACCOUNT, LedgerKeyAccount(accountID=acc))

    @classmethod
    def trustline(cls, acc: AccountID, asset: Asset) -> "LedgerKey":
        return cls(LedgerEntryType.TRUSTLINE,
                   LedgerKeyTrustLine(accountID=acc, asset=asset))

    @classmethod
    def offer(cls, seller: AccountID, offer_id: int) -> "LedgerKey":
        return cls(LedgerEntryType.OFFER,
                   LedgerKeyOffer(sellerID=seller, offerID=offer_id))

    @classmethod
    def data(cls, acc: AccountID, name: str) -> "LedgerKey":
        return cls(LedgerEntryType.DATA,
                   LedgerKeyData(accountID=acc, dataName=name))


def ledger_entry_key(entry: LedgerEntry) -> LedgerKey:
    """The identity key of an entry (reference: LedgerEntryKey in
    src/ledger/LedgerHashUtils.h role)."""
    d = entry.data
    t = d.disc
    if t == LedgerEntryType.ACCOUNT:
        return LedgerKey.account(d.value.accountID)
    if t == LedgerEntryType.TRUSTLINE:
        return LedgerKey.trustline(d.value.accountID, d.value.asset)
    if t == LedgerEntryType.OFFER:
        return LedgerKey.offer(d.value.sellerID, d.value.offerID)
    if t == LedgerEntryType.DATA:
        return LedgerKey.data(d.value.accountID, d.value.dataName)
    raise XdrError("bad entry type %d" % t)


def ledger_key_sort_key(key: LedgerKey):
    """Total order on ledger-entry identities matching the reference's
    field-wise LedgerEntryIdCmp (src/bucket/LedgerCmp.h:27-87): type first,
    then the identifying fields. dataName compares as a raw byte string
    (C++ std::string order), NOT as XDR (which is length-prefixed)."""
    t = key.disc
    v = key.value
    if t == LedgerEntryType.ACCOUNT:
        return (t, v.accountID.to_xdr())
    if t == LedgerEntryType.TRUSTLINE:
        return (t, v.accountID.to_xdr(), v.asset.to_xdr())
    if t == LedgerEntryType.OFFER:
        return (t, v.sellerID.to_xdr(), v.offerID)
    if t == LedgerEntryType.DATA:
        name = v.dataName
        if isinstance(name, str):
            name = name.encode()
        return (t, v.accountID.to_xdr(), name)
    raise XdrError("bad key type %d" % t)
