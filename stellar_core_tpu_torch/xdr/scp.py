"""SCP wire types: statements, envelopes, quorum sets.

Copied from `stellar_core_tpu/xdr/scp.py` at commit a7226ae; carry a fix in
either copy to the other.

Role parity: reference `src/xdr/Stellar-SCP.x`.
"""

from __future__ import annotations

from .basic import Hash, NodeID, Signature, Value
from .codec import Uint32, Uint64, VarArray, XdrStruct, XdrUnion


class SCPBallot(XdrStruct):
    xdr_fields = [("counter", Uint32), ("value", Value)]


class SCPStatementType:
    SCP_ST_PREPARE = 0
    SCP_ST_CONFIRM = 1
    SCP_ST_EXTERNALIZE = 2
    SCP_ST_NOMINATE = 3


class SCPNomination(XdrStruct):
    xdr_fields = [
        ("quorumSetHash", Hash),
        ("votes", VarArray(Value)),
        ("accepted", VarArray(Value)),
    ]


class SCPPrepare(XdrStruct):
    from .codec import OptionalT as _Opt
    xdr_fields = [
        ("quorumSetHash", Hash),
        ("ballot", SCPBallot),
        ("prepared", _Opt(SCPBallot)),
        ("preparedPrime", _Opt(SCPBallot)),
        ("nC", Uint32),
        ("nH", Uint32),
    ]


class SCPConfirm(XdrStruct):
    xdr_fields = [
        ("ballot", SCPBallot),
        ("nPrepared", Uint32),
        ("nCommit", Uint32),
        ("nH", Uint32),
        ("quorumSetHash", Hash),
    ]


class SCPExternalize(XdrStruct):
    xdr_fields = [
        ("commit", SCPBallot),
        ("nH", Uint32),
        ("commitQuorumSetHash", Hash),
    ]


class SCPPledges(XdrUnion):
    xdr_arms = {
        SCPStatementType.SCP_ST_PREPARE: ("prepare", SCPPrepare),
        SCPStatementType.SCP_ST_CONFIRM: ("confirm", SCPConfirm),
        SCPStatementType.SCP_ST_EXTERNALIZE: ("externalize", SCPExternalize),
        SCPStatementType.SCP_ST_NOMINATE: ("nominate", SCPNomination),
    }


class SCPStatement(XdrStruct):
    xdr_fields = [
        ("nodeID", NodeID),
        ("slotIndex", Uint64),
        ("pledges", SCPPledges),
    ]


class SCPEnvelope(XdrStruct):
    xdr_fields = [("statement", SCPStatement), ("signature", Signature)]


class SCPQuorumSet(XdrStruct):
    """Recursive quorum set: threshold over validators + inner sets."""
    xdr_fields = []  # patched below for self-reference


SCPQuorumSet.xdr_fields = [
    ("threshold", Uint32),
    ("validators", VarArray(NodeID)),
    ("innerSets", VarArray(SCPQuorumSet)),
]


class SCPHistoryEntryV0(XdrStruct):
    xdr_fields = [
        ("quorumSets", VarArray(SCPQuorumSet)),
        ("ledgerMessages", XdrStruct),  # patched below
    ]


class LedgerSCPMessages(XdrStruct):
    xdr_fields = [("ledgerSeq", Uint32), ("messages", VarArray(SCPEnvelope))]


SCPHistoryEntryV0.xdr_fields = [
    ("quorumSets", VarArray(SCPQuorumSet)),
    ("ledgerMessages", LedgerSCPMessages),
]


class SCPHistoryEntry(XdrUnion):
    xdr_arms = {0: ("v0", SCPHistoryEntryV0)}
