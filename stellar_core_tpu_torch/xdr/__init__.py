"""XDR layer: canonical wire/hash format and the full message vocabulary.

Copied (the package's exports) from `stellar_core_tpu/xdr/__init__.py` at
commit 05e2f75; carry a fix in either copy to the other.

Role parity: reference `src/xdr/*.x` + xdrpp codegen (layer 1 in SURVEY.md §1).
"""

from .codec import (
    Bool, EnumT, FixedArray, Int32, Int64, Opaque, OptionalT, Packer,
    Uint32, Uint64, Unpacker, VarArray, VarOpaque, XdrError, XdrString,
    XdrStruct, XdrUnion, xdr_bytes, xdr_from,
)
from .basic import (
    AccountID, CryptoKeyType, Curve25519Public, Curve25519Secret,
    DecoratedSignature, EnvelopeType, Hash, HmacSha256Key, HmacSha256Mac,
    MuxedAccount, MuxedAccountMed25519, NodeID, PublicKey, PublicKeyType,
    Signature, SignatureHint, SignerKey, SignerKeyType, String32, String64,
    DataValue, Uint256, UpgradeType, Value,
)
from .ledger_entries import (
    AccountEntry, AccountEntryExt, AccountEntryExtensionV1, AccountFlags,
    Asset, AssetAlphaNum4, AssetAlphaNum12,
    AssetType, DataEntry, LedgerEntry, LedgerEntryData, LedgerEntryType,
    LedgerKey, LedgerKeyAccount, LedgerKeyData, LedgerKeyOffer,
    LedgerKeyTrustLine, Liabilities, OfferEntry, OfferEntryFlags, Price,
    SequenceNumber, Signer, TrustLineEntry, TrustLineEntryExt,
    TrustLineEntryExtensionV1, TrustLineFlags, ledger_entry_key,
    ledger_key_sort_key, _Ext,
)
from .transaction import (
    AllowTrustAsset, AllowTrustOp, BumpSequenceOp, ChangeTrustOp,
    ClaimOfferAtom, CreateAccountOp, CreatePassiveSellOfferOp,
    FeeBumpTransaction, FeeBumpTransactionEnvelope, InflationPayout,
    ManageBuyOfferOp, ManageDataOp, ManageOfferSuccessResult,
    ManageOfferSuccessResultOffer, ManageSellOfferOp, MAX_OPS_PER_TX, Memo,
    MemoType, Operation, OperationBody, OperationInner, OperationResult,
    OperationResultCode, OperationType, PathPaymentStrictReceiveOp,
    PathPaymentStrictSendOp, PathPaymentSuccess, PaymentOp, SetOptionsOp,
    SimplePaymentResult, TimeBounds, Transaction, TransactionEnvelope,
    TransactionResult, TransactionResultCode, TransactionResultPair,
    TransactionResultSet, TransactionSignaturePayload, TransactionV1Envelope,
    InnerTransactionResultPair,
    CreateAccountResult, PaymentResult, PathPaymentStrictReceiveResult,
    PathPaymentStrictSendResult, ManageSellOfferResult, ManageBuyOfferResult,
    SetOptionsResult, ChangeTrustResult, AllowTrustResult, AccountMergeResult,
    InflationResult, ManageDataResult, BumpSequenceResult,
)
from .ledger import (
    BucketEntry, BucketEntryType, BucketMetadata,
    LedgerCloseMeta, LedgerCloseMetaV0,
    LedgerCloseValueSignature, LedgerEntryChange, LedgerEntryChangeType,
    LedgerEntryChanges, LedgerHeader, LedgerHeaderHistoryEntry, LedgerUpgrade,
    LedgerUpgradeType, OperationMeta, StellarValue, StellarValueExt,
    TransactionHistoryEntry, TransactionHistoryResultEntry, TransactionMeta,
    TransactionMetaV1, TransactionResultMeta, TransactionSet,
    UpgradeEntryMeta,
)
from .scp import (
    LedgerSCPMessages, SCPBallot, SCPEnvelope, SCPHistoryEntry,
    SCPHistoryEntryV0, SCPNomination, SCPPledges, SCPPrepare, SCPConfirm,
    SCPExternalize, SCPQuorumSet, SCPStatement, SCPStatementType,
)
from .overlay import (
    Auth, AuthCert, AuthenticatedMessage, AuthenticatedMessageV0, DontHave,
    Error, ErrorCode, Hello, IPAddr, MessageType, PeerAddress, PeerStats,
    SignedSurveyRequestMessage, SignedSurveyResponseMessage,
    StellarMessage, SurveyMessageCommandType, SurveyRequestMessage,
    SurveyResponseMessage, TopologyResponseBody, EncryptedBody,
)
