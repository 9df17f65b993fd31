"""Slot: one consensus round = nomination + ballot protocol instances.

Copied from `stellar_core_tpu/scp/slot.py` at commit a6220d9; carry a
fix in either copy to the other. Nothing is left out.

Role parity: reference `src/scp/Slot.{h,cpp}:121` — envelope dispatch,
quorum-set resolution from statements, statement-to-envelope signing,
externalization bookkeeping.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..xdr import (
    SCPEnvelope, SCPQuorumSet, SCPStatement, SCPStatementType,
)
from .ballot import BallotProtocol
from .nomination import NominationProtocol

# slot-timeline event per statement type: "first time we saw <phase>
# from <sender>" (dedup per sender keeps the journal bounded while
# preserving first-arrival times for fleet flood-latency attribution)
_SEEN_EVENT = {
    SCPStatementType.SCP_ST_NOMINATE: "nominate.seen",
    SCPStatementType.SCP_ST_PREPARE: "prepare.seen",
    SCPStatementType.SCP_ST_CONFIRM: "confirm.seen",
    SCPStatementType.SCP_ST_EXTERNALIZE: "externalize.seen",
}


class Slot:
    def __init__(self, slot_index: int, scp) -> None:
        self.slot_index = slot_index
        self.scp = scp
        self.nomination = NominationProtocol(self)
        self.ballot = BallotProtocol(self)
        self.fully_validated = scp.local_node.is_validator
        self.got_v_blocking = False

    # -- envelope plumbing --------------------------------------------------
    def create_envelope(self, st: SCPStatement) -> SCPEnvelope:
        env = SCPEnvelope(statement=st, signature=b"")
        self.scp.driver.sign_envelope(env)
        return env

    def process_envelope(self, envelope: SCPEnvelope,
                         is_self: bool = False) -> int:
        st = envelope.statement
        assert st.slotIndex == self.slot_index
        own = is_self or \
            st.nodeID.key_bytes == self.scp.local_node.node_id.key_bytes
        tl = getattr(self.scp.driver, "timeline", None)
        if tl is not None and not own:
            # a flood echo of our own statement is not a peer arrival
            tl.record(self.slot_index, _SEEN_EVENT[st.pledges.disc],
                      node=st.nodeID.key_bytes.hex(), dedupe=True)
        ss = getattr(self.scp.driver, "scp_stats", None)
        if ss is not None:
            # consensus cockpit: count EVERY peer arrival —
            # the timeline above dedups to first-arrivals, the cockpit's
            # envelopes-per-slot baseline must see the full flood
            from .scp_stats import STATEMENT_KIND
            ss.envelope_received(self.slot_index,
                                 STATEMENT_KIND[st.pledges.disc],
                                 st.nodeID.key_bytes.hex(), is_self=own)
        if st.pledges.disc == SCPStatementType.SCP_ST_NOMINATE:
            return self.nomination.process_envelope(envelope)
        return self.ballot.process_envelope(envelope, is_self)

    def set_state_from_envelope(self, envelope: SCPEnvelope) -> None:
        st = envelope.statement
        if st.nodeID.key_bytes != self.scp.local_node.node_id.key_bytes or \
                st.slotIndex != self.slot_index:
            return  # not our own persisted state; ignore
        if st.pledges.disc == SCPStatementType.SCP_ST_NOMINATE:
            self.nomination.set_state_from_envelope(envelope)
        else:
            self.ballot.set_state_from_envelope(envelope)

    # -- quorum sets --------------------------------------------------------
    def get_quorum_set_from_statement(
            self, st: SCPStatement) -> Optional[SCPQuorumSet]:
        t = st.pledges.disc
        if t == SCPStatementType.SCP_ST_EXTERNALIZE:
            h = st.pledges.value.commitQuorumSetHash
        elif t == SCPStatementType.SCP_ST_NOMINATE:
            h = st.pledges.value.quorumSetHash
        elif t == SCPStatementType.SCP_ST_PREPARE:
            h = st.pledges.value.quorumSetHash
        else:
            h = st.pledges.value.quorumSetHash
        return self.scp.driver.get_qset(h)

    # -- actions ------------------------------------------------------------
    def nominate(self, value: bytes, previous_value: bytes,
                 timed_out: bool = False) -> bool:
        return self.nomination.nominate(value, previous_value, timed_out)

    def bump_state(self, value: bytes, force: bool) -> bool:
        return self.ballot.bump_state(value, force)

    def stop_nomination(self) -> None:
        self.nomination.stop_nomination()

    def get_latest_composite_candidate(self) -> Optional[bytes]:
        return self.nomination.latest_composite

    # -- introspection ------------------------------------------------------
    def get_latest_messages_send(self) -> List[SCPEnvelope]:
        out = []
        if self.nomination.last_envelope is not None:
            out.append(self.nomination.last_envelope)
        if self.ballot.last_envelope_emit is not None:
            out.append(self.ballot.last_envelope_emit)
        return out

    def get_current_state(self) -> List[SCPEnvelope]:
        """All latest envelopes known for this slot (for SCP state
        re-broadcast)."""
        out = list(self.nomination.latest_nominations.values())
        out.extend(self.ballot.latest_envelopes.values())
        return out

    def externalized_value(self) -> Optional[bytes]:
        return self.ballot.externalized_value()

    def get_json_info(self) -> dict:
        return {
            "index": self.slot_index,
            "nomination": self.nomination.get_json_info(),
            "ballot": self.ballot.get_json_info(),
        }
