"""Basic XDR types shared by every layer.

Copied from `stellar_core_tpu/xdr/basic.py` at commit a7226ae; carry a fix
in either copy to the other.

Role parity: reference `src/xdr/Stellar-types.x` (PublicKey, SignerKey,
Signature, Hash, NodeID, HMAC/Curve25519 wrappers).
"""

from __future__ import annotations

from .codec import (
    EnumT, FixedArray, Opaque, OptionalT, Uint32, Uint64, Int32, Int64,
    VarArray, VarOpaque, XdrString, XdrStruct, XdrUnion,
)

Hash = Opaque(32)
Uint256 = Opaque(32)
Signature = VarOpaque(64)
SignatureHint = Opaque(4)
Curve25519Public = Opaque(32)
Curve25519Secret = Opaque(32)
HmacSha256Key = Opaque(32)
HmacSha256Mac = Opaque(32)


class CryptoKeyType:
    KEY_TYPE_ED25519 = 0
    KEY_TYPE_PRE_AUTH_TX = 1
    KEY_TYPE_HASH_X = 2
    KEY_TYPE_MUXED_ED25519 = 0x100


class PublicKeyType:
    PUBLIC_KEY_TYPE_ED25519 = 0


class SignerKeyType:
    SIGNER_KEY_TYPE_ED25519 = 0
    SIGNER_KEY_TYPE_PRE_AUTH_TX = 1
    SIGNER_KEY_TYPE_HASH_X = 2


class PublicKey(XdrUnion):
    xdr_arms = {PublicKeyType.PUBLIC_KEY_TYPE_ED25519: ("ed25519", Uint256)}

    @classmethod
    def ed25519(cls, raw32: bytes) -> "PublicKey":
        return cls(PublicKeyType.PUBLIC_KEY_TYPE_ED25519, raw32)

    @property
    def key_bytes(self) -> bytes:
        return self.value


# Node identity and account identity are both ed25519 public keys.
NodeID = PublicKey
AccountID = PublicKey


class SignerKey(XdrUnion):
    xdr_arms = {
        SignerKeyType.SIGNER_KEY_TYPE_ED25519: ("ed25519", Uint256),
        SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX: ("preAuthTx", Uint256),
        SignerKeyType.SIGNER_KEY_TYPE_HASH_X: ("hashX", Uint256),
    }

    @classmethod
    def ed25519(cls, raw32: bytes) -> "SignerKey":
        return cls(SignerKeyType.SIGNER_KEY_TYPE_ED25519, raw32)

    @classmethod
    def pre_auth_tx(cls, h: bytes) -> "SignerKey":
        return cls(SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX, h)

    @classmethod
    def hash_x(cls, h: bytes) -> "SignerKey":
        return cls(SignerKeyType.SIGNER_KEY_TYPE_HASH_X, h)


class MuxedAccount(XdrUnion):
    """Account reference in transactions; may carry a 64-bit sub-account id."""

    xdr_arms = {
        CryptoKeyType.KEY_TYPE_ED25519: ("ed25519", Uint256),
        CryptoKeyType.KEY_TYPE_MUXED_ED25519: ("med25519", None),  # patched below
    }

    @classmethod
    def from_account_id(cls, acc: PublicKey) -> "MuxedAccount":
        return cls(CryptoKeyType.KEY_TYPE_ED25519, acc.key_bytes)

    @property
    def account_id(self) -> PublicKey:
        if self.disc == CryptoKeyType.KEY_TYPE_ED25519:
            return PublicKey.ed25519(self.value)
        return PublicKey.ed25519(self.value.ed25519)


class MuxedAccountMed25519(XdrStruct):
    xdr_fields = [("id", Uint64), ("ed25519", Uint256)]


MuxedAccount.xdr_arms[CryptoKeyType.KEY_TYPE_MUXED_ED25519] = (
    "med25519", MuxedAccountMed25519)


class DecoratedSignature(XdrStruct):
    xdr_fields = [("hint", SignatureHint), ("signature", Signature)]


String32 = XdrString(32)
String64 = XdrString(64)
DataValue = VarOpaque(64)
UpgradeType = VarOpaque(128)
Value = VarOpaque(2**20)  # SCP opaque value


class EnvelopeType:
    ENVELOPE_TYPE_SCP = 1
    ENVELOPE_TYPE_TX = 2
    ENVELOPE_TYPE_AUTH = 3
    ENVELOPE_TYPE_SCPVALUE = 4
    ENVELOPE_TYPE_TX_FEE_BUMP = 5
    ENVELOPE_TYPE_OP_ID = 6
