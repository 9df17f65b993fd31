"""Overlay (p2p) message vocabulary.

Copied from `stellar_core_tpu/xdr/overlay.py` at commit a7226ae; carry a fix
in either copy to the other.

Role parity: reference `src/xdr/Stellar-overlay.x:179-216` (StellarMessage,
AuthenticatedMessage, Hello/Auth handshake, peers, DontHave, survey).
"""

from __future__ import annotations

from .basic import (
    Curve25519Public, Hash, HmacSha256Mac, NodeID, Signature, Uint256,
)
from .ledger import TransactionSet
from .scp import SCPEnvelope, SCPQuorumSet
from .transaction import TransactionEnvelope
from .codec import (
    EnumT, Int32, Opaque, Uint32, Uint64, VarArray, VarOpaque, XdrString,
    XdrStruct, XdrUnion,
)


class ErrorCode:
    ERR_MISC = 0
    ERR_DATA = 1
    ERR_CONF = 2
    ERR_AUTH = 3
    ERR_LOAD = 4


class Error(XdrStruct):
    xdr_fields = [("code", Int32), ("msg", XdrString(100))]


class AuthCert(XdrStruct):
    """Hourly X25519 session cert signed by the node's ed25519 identity key.
    Reference: src/overlay/PeerAuth.cpp:19-34."""
    xdr_fields = [
        ("pubkey", Curve25519Public),
        ("expiration", Uint64),
        ("sig", Signature),
    ]


class Hello(XdrStruct):
    xdr_fields = [
        ("ledgerVersion", Uint32),
        ("overlayVersion", Uint32),
        ("overlayMinVersion", Uint32),
        ("networkID", Hash),
        ("versionStr", XdrString(100)),
        ("listeningPort", Int32),
        ("peerID", NodeID),
        ("cert", AuthCert),
        ("nonce", Uint256),
    ]


class Auth(XdrStruct):
    xdr_fields = [("unused", Int32)]


class IPAddr(XdrUnion):
    IPv4 = 0
    IPv6 = 1
    xdr_arms = {0: ("ipv4", Opaque(4)), 1: ("ipv6", Opaque(16))}


class PeerAddress(XdrStruct):
    xdr_fields = [("ip", IPAddr), ("port", Uint32), ("numFailures", Uint32)]


class MessageType:
    ERROR_MSG = 0
    AUTH = 2
    DONT_HAVE = 3
    GET_PEERS = 4
    PEERS = 5
    GET_TX_SET = 6
    TX_SET = 7
    TRANSACTION = 8
    GET_SCP_QUORUMSET = 9
    SCP_QUORUMSET = 10
    SCP_MESSAGE = 11
    GET_SCP_STATE = 12
    HELLO = 13
    SURVEY_REQUEST = 14
    SURVEY_RESPONSE = 15


class DontHave(XdrStruct):
    xdr_fields = [("type", Int32), ("reqHash", Uint256)]


class SurveyMessageCommandType:
    SURVEY_TOPOLOGY = 0


class SurveyRequestMessage(XdrStruct):
    xdr_fields = [
        ("surveyorPeerID", NodeID),
        ("surveyedPeerID", NodeID),
        ("ledgerNum", Uint32),
        ("encryptionKey", Curve25519Public),
        ("commandType", Int32),
    ]


class SignedSurveyRequestMessage(XdrStruct):
    xdr_fields = [("requestSignature", Signature),
                  ("request", SurveyRequestMessage)]


EncryptedBody = VarOpaque(64000)


class SurveyResponseMessage(XdrStruct):
    xdr_fields = [
        ("surveyorPeerID", NodeID),
        ("surveyedPeerID", NodeID),
        ("ledgerNum", Uint32),
        ("commandType", Int32),
        ("encryptedBody", EncryptedBody),
    ]


class SignedSurveyResponseMessage(XdrStruct):
    xdr_fields = [("responseSignature", Signature),
                  ("response", SurveyResponseMessage)]


class PeerStats(XdrStruct):
    xdr_fields = [
        ("id", NodeID),
        ("versionStr", XdrString(100)),
        ("messagesRead", Uint64),
        ("messagesWritten", Uint64),
        ("bytesRead", Uint64),
        ("bytesWritten", Uint64),
        ("secondsConnected", Uint64),
    ]


class TopologyResponseBody(XdrStruct):
    xdr_fields = [
        ("inboundPeers", VarArray(PeerStats, 25)),
        ("outboundPeers", VarArray(PeerStats, 25)),
        ("totalInboundPeerCount", Uint32),
        ("totalOutboundPeerCount", Uint32),
    ]


class StellarMessage(XdrUnion):
    xdr_arms = {
        MessageType.ERROR_MSG: ("error", Error),
        MessageType.HELLO: ("hello", Hello),
        MessageType.AUTH: ("auth", Auth),
        MessageType.DONT_HAVE: ("dontHave", DontHave),
        MessageType.GET_PEERS: ("getPeers", None),
        MessageType.PEERS: ("peers", VarArray(PeerAddress, 100)),
        MessageType.GET_TX_SET: ("txSetHash", Uint256),
        MessageType.TX_SET: ("txSet", TransactionSet),
        MessageType.TRANSACTION: ("transaction", TransactionEnvelope),
        MessageType.GET_SCP_QUORUMSET: ("qSetHash", Uint256),
        MessageType.SCP_QUORUMSET: ("qSet", SCPQuorumSet),
        MessageType.SCP_MESSAGE: ("envelope", SCPEnvelope),
        MessageType.GET_SCP_STATE: ("getSCPLedgerSeq", Uint32),
        MessageType.SURVEY_REQUEST:
            ("signedSurveyRequestMessage", SignedSurveyRequestMessage),
        MessageType.SURVEY_RESPONSE:
            ("signedSurveyResponseMessage", SignedSurveyResponseMessage),
    }


class AuthenticatedMessageV0(XdrStruct):
    """seq + HMAC-SHA256(seq ‖ msg). Reference: src/overlay/Peer.cpp:436-439."""
    xdr_fields = [
        ("sequence", Uint64),
        ("message", StellarMessage),
        ("mac", HmacSha256Mac),
    ]


class AuthenticatedMessage(XdrUnion):
    xdr_arms = {0: ("v0", AuthenticatedMessageV0)}
