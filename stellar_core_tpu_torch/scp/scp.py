"""SCP facade: slot registry + envelope entry point.

Copied from `stellar_core_tpu/scp/scp.py` at commit a09415e; carry a fix
in either copy to the other. Nothing is left out.

Role parity: reference `src/scp/SCP.{h,cpp}:30-77` — receiveEnvelope,
nominate, slot GC, state introspection/JSON, restore from persisted
envelopes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..util.threads import main_thread_only
from ..xdr import NodeID, SCPEnvelope, SCPQuorumSet
from .ballot import BallotProtocol
from .driver import SCPDriver
from .local_node import LocalNode
from .slot import Slot


class SCP:
    class EnvelopeState:
        INVALID = BallotProtocol.EnvelopeState.INVALID
        VALID = BallotProtocol.EnvelopeState.VALID
        # signature verify in flight on the batch backend; resolution is
        # delivered via the recv_scp_envelope on_verified callback
        PENDING = 2

    def __init__(self, driver: SCPDriver, node_id: NodeID,
                 is_validator: bool, qset: SCPQuorumSet) -> None:
        self.driver = driver
        self.local_node = LocalNode(node_id, is_validator, qset)
        self.known_slots: Dict[int, Slot] = {}

    # -- slots --------------------------------------------------------------
    def get_slot(self, idx: int, create: bool = True) -> Optional[Slot]:
        s = self.known_slots.get(idx)
        if s is None and create:
            s = Slot(idx, self)
            self.known_slots[idx] = s
        return s

    def purge_slots(self, max_slot_index: int) -> None:
        """Drop slots below max_slot_index (reference purgeSlots)."""
        for idx in [i for i in self.known_slots if i < max_slot_index]:
            del self.known_slots[idx]

    # -- protocol entry points ----------------------------------------------
    @main_thread_only
    def receive_envelope(self, envelope: SCPEnvelope) -> int:
        return self.get_slot(
            envelope.statement.slotIndex).process_envelope(envelope)

    @main_thread_only
    def nominate(self, slot_index: int, value: bytes,
                 previous_value: bytes) -> bool:
        assert self.local_node.is_validator
        return self.get_slot(slot_index).nominate(value, previous_value)

    def stop_nomination(self, slot_index: int) -> None:
        s = self.get_slot(slot_index, False)
        if s:
            s.stop_nomination()

    def update_local_quorum_set(self, qset: SCPQuorumSet) -> None:
        self.local_node.update_quorum_set(qset)

    # -- introspection ------------------------------------------------------
    def get_latest_messages_send(self, slot_index: int) -> List[SCPEnvelope]:
        s = self.get_slot(slot_index, False)
        return s.get_latest_messages_send() if s else []

    def get_current_state(self, slot_index: int) -> List[SCPEnvelope]:
        s = self.get_slot(slot_index, False)
        return s.get_current_state() if s else []

    def get_externalizing_state(self, slot_index: int) -> List[SCPEnvelope]:
        s = self.get_slot(slot_index, False)
        if s is None:
            return []
        return [e for e in s.get_current_state()]

    @main_thread_only
    def set_state_from_envelope(self, envelope: SCPEnvelope) -> None:
        """Restore persisted state (reference setStateFromEnvelope)."""
        self.get_slot(envelope.statement.slotIndex).set_state_from_envelope(
            envelope)

    def empty(self) -> bool:
        return not self.known_slots

    def get_json_info(self, limit: int = 2) -> dict:
        idxs = sorted(self.known_slots)[-limit:]
        return {str(i): self.known_slots[i].get_json_info() for i in idxs}
