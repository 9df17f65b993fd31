"""NominationProtocol: federated nomination of candidate values.

Copied from `stellar_core_tpu/scp/nomination.py` at commit a6220d9;
carry a fix in either copy to the other. Nothing is left out.

Role parity: reference `src/scp/NominationProtocol.{h,cpp}:337` — leader
election by weighted hash per round, vote/accept federated voting over
values, candidate confirmation feeding the ballot protocol via
combineCandidates.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..xdr import (
    SCPEnvelope, SCPNomination, SCPPledges, SCPStatement, SCPStatementType,
)
from .local_node import LocalNode, all_nodes_of


class NominationProtocol:
    def __init__(self, slot) -> None:
        self.slot = slot
        self.round_number = 0
        self.votes: Set[bytes] = set()
        self.accepted: Set[bytes] = set()
        self.candidates: Set[bytes] = set()
        self.latest_nominations: Dict[bytes, SCPEnvelope] = {}
        self.last_envelope: Optional[SCPEnvelope] = None
        self.round_leaders: Set[bytes] = set()
        self.nomination_started = False
        self.latest_composite: Optional[bytes] = None
        self.previous_value: bytes = b""

    def _driver(self):
        return self.slot.scp.driver

    def _journal(self, event: str, **tags) -> None:
        """First occurrence of a nomination milestone (own vote, value
        accepted, candidate confirmed) into the slot timeline."""
        tl = getattr(self.slot.scp.driver, "timeline", None)
        if tl is not None:
            tl.record(self.slot.slot_index, event, dedupe=True, **tags)

    def _local(self) -> LocalNode:
        return self.slot.scp.local_node

    def _qset_of(self, st: SCPStatement):
        return self.slot.get_quorum_set_from_statement(st)

    # ------------------------------------------------------------ leaders
    def update_round_leaders(self) -> None:
        local = self._local()
        qset = local.qset
        leaders: Set[bytes] = set()
        top_priority = 0
        nodes = all_nodes_of(qset)
        nodes.add(local.node_id.key_bytes)
        for nb in sorted(nodes):
            w = LocalNode.get_node_weight(nb, qset) \
                if nb != local.node_id.key_bytes else 2**64 - 1
            if w == 0:
                continue
            from ..xdr import PublicKey
            nid = PublicKey.ed25519(nb)
            gi = self._driver().compute_hash_node(
                self.slot.slot_index, self.previous_value, False,
                self.round_number, nid)
            if gi >= w:
                continue  # not eligible this round
            prio = self._driver().compute_hash_node(
                self.slot.slot_index, self.previous_value, True,
                self.round_number, nid)
            if prio > top_priority:
                top_priority = prio
                leaders = {nb}
            elif prio == top_priority:
                leaders.add(nb)
        if not leaders:
            leaders = {local.node_id.key_bytes}
        # leaders ACCUMULATE across rounds (reference updateRoundLeaders):
        # a new round adds its leader without forgetting previous ones
        self.round_leaders |= leaders

    # ------------------------------------------------------------- intake
    @staticmethod
    def is_sane(st: SCPStatement) -> bool:
        nom = st.pledges.value
        if not nom.votes and not nom.accepted:
            return False
        return (sorted(nom.votes) == list(nom.votes) and
                len(set(nom.votes)) == len(nom.votes) and
                sorted(nom.accepted) == list(nom.accepted) and
                len(set(nom.accepted)) == len(nom.accepted))

    def _is_newer(self, st: SCPStatement, old: SCPStatement) -> bool:
        a, b = st.pledges.value, old.pledges.value
        return (set(b.votes) <= set(a.votes) and
                set(b.accepted) <= set(a.accepted) and
                (len(a.votes) > len(b.votes) or
                 len(a.accepted) > len(b.accepted)))

    def process_envelope(self, envelope: SCPEnvelope) -> int:
        from .ballot import BallotProtocol
        st = envelope.statement
        nb = st.nodeID.key_bytes
        if not self.is_sane(st):
            return BallotProtocol.EnvelopeState.INVALID
        old = self.latest_nominations.get(nb)
        if old is not None and not self._is_newer(st, old.statement):
            return BallotProtocol.EnvelopeState.INVALID
        self.latest_nominations[nb] = envelope
        if not self.nomination_started:
            return BallotProtocol.EnvelopeState.VALID
        from .driver import ValidationLevel
        modified = False
        new_candidates = False
        # echo a round leader's BEST new value (reference
        # getNewValueFromNomination — one value per message, highest
        # value-hash among those we don't already vote for)
        if nb in self.round_leaders:
            v = self._pick_leader_value(envelope)
            if v is not None:
                self.votes.add(v)
                self._journal("nominate.vote", round=self.round_number)
                self._driver().nominating_value(self.slot.slot_index, v)
                modified = True
        # federated voting on each known value
        for v in self._all_known_values():
            if v in self.accepted:
                continue
            if self._federated_accept_value(v):
                lvl = self._driver().validate_value(
                    self.slot.slot_index, v, True)
                if lvl != ValidationLevel.FULLY_VALIDATED:
                    alt = self._driver().extract_valid_value(
                        self.slot.slot_index, v)
                    if alt is None:
                        continue
                    v = alt
                self.accepted.add(v)
                self.votes.add(v)
                self._journal("nominate.accept",
                              accepted=len(self.accepted))
                modified = True
        for v in sorted(self.accepted):
            if v in self.candidates:
                continue
            if self._federated_ratify_value(v):
                self.candidates.add(v)
                self._journal("nominate.candidate",
                              candidates=len(self.candidates))
                new_candidates = True
        if modified:
            self._emit_nomination()
        if new_candidates:
            self.latest_composite = self._driver().combine_candidates(
                self.slot.slot_index, sorted(self.candidates))
            if self.latest_composite is not None:
                self._driver().updated_candidate_value(
                    self.slot.slot_index, self.latest_composite)
                self.slot.bump_state(self.latest_composite, force=False)
        return BallotProtocol.EnvelopeState.VALID

    def _all_known_values(self) -> List[bytes]:
        out: Set[bytes] = set(self.votes)
        for env in self.latest_nominations.values():
            nom = env.statement.pledges.value
            out.update(nom.votes)
            out.update(nom.accepted)
        return sorted(out)

    def _federated_accept_value(self, v: bytes) -> bool:
        def accepted_pred(st: SCPStatement) -> bool:
            return v in st.pledges.value.accepted

        def votes_pred(st: SCPStatement) -> bool:
            return v in st.pledges.value.votes
        local = self._local()
        if LocalNode.is_v_blocking_filter(
                local.qset, self.latest_nominations.values(),
                accepted_pred):
            return True
        return LocalNode.is_quorum(
            local.qset, self.latest_nominations, self._qset_of,
            lambda st: votes_pred(st) or accepted_pred(st))

    def _federated_ratify_value(self, v: bytes) -> bool:
        return LocalNode.is_quorum(
            self._local().qset, self.latest_nominations, self._qset_of,
            lambda st: v in st.pledges.value.accepted)

    # ------------------------------------------------------------ nominate
    def nominate(self, value: bytes, previous_value: bytes,
                 timed_out: bool = False) -> bool:
        from .driver import SCPTimerID
        if timed_out and not self.nomination_started:
            return False
        self.nomination_started = True
        self.previous_value = previous_value
        self.round_number += 1
        ss = getattr(self._driver(), "scp_stats", None)
        if ss is not None:
            # consensus cockpit: round count per slot; a
            # timed_out re-entry is a nomination-timer-driven round
            ss.nomination_round(self.slot.slot_index, self.round_number,
                                timed_out)
        self.update_round_leaders()
        modified = False
        if self._local().node_id.key_bytes in self.round_leaders:
            if value not in self.votes:
                self.votes.add(value)
                self._journal("nominate.vote", round=self.round_number)
                modified = True
            self._driver().nominating_value(self.slot.slot_index, value)
        # regardless of own leadership, adopt the best new value from every
        # round leader we have heard from (reference nominate)
        for nb in self.round_leaders:
            env = self.latest_nominations.get(nb)
            if env is not None:
                v = self._pick_leader_value(env)
                if v is not None:  # _pick skips values already voted
                    self.votes.add(v)
                    self._driver().nominating_value(self.slot.slot_index, v)
                    modified = True
        # re-arm next round
        timeout = self._driver().compute_timeout(self.round_number)
        self._driver().setup_timer(
            self.slot.slot_index, SCPTimerID.NOMINATION, timeout,
            lambda: self.nominate(value, previous_value, True))
        if modified:
            self._emit_nomination()
        return modified

    def _pick_leader_value(self, env: SCPEnvelope) -> Optional[bytes]:
        """Highest value-hash among the leader's votes (reference
        getNewValueFromNomination)."""
        from .driver import ValidationLevel
        nom = env.statement.pledges.value
        best, best_h = None, -1
        for v in list(nom.votes) + list(nom.accepted):
            lvl = self._driver().validate_value(self.slot.slot_index, v,
                                                True)
            if lvl != ValidationLevel.FULLY_VALIDATED:
                v2 = self._driver().extract_valid_value(
                    self.slot.slot_index, v)
                if v2 is None:
                    continue
                v = v2
            if v in self.votes:
                continue  # only NEW values (reference :472-491)
            h = self._driver().compute_value_hash(
                self.slot.slot_index, self.previous_value,
                self.round_number, v)
            if h >= best_h:  # ties: later (higher) value wins (reference)
                best, best_h = v, h
        return best

    def stop_nomination(self) -> None:
        self.nomination_started = False

    def _emit_nomination(self) -> None:
        from .ballot import BallotProtocol
        local = self._local()
        st = SCPStatement(
            nodeID=local.node_id, slotIndex=self.slot.slot_index,
            pledges=SCPPledges(
                SCPStatementType.SCP_ST_NOMINATE,
                SCPNomination(quorumSetHash=local.qset_hash,
                              votes=sorted(self.votes),
                              accepted=sorted(self.accepted))))
        env = self.slot.create_envelope(st)
        if self.process_envelope(env) == BallotProtocol.EnvelopeState.VALID:
            if self.last_envelope is None or self._is_newer(
                    st, self.last_envelope.statement):
                self.last_envelope = env
                if local.is_validator:
                    self._driver().emit_envelope(env)

    def set_state_from_envelope(self, envelope) -> None:
        """Restore persisted nomination state (reference
        setStateFromEnvelope)."""
        if self.nomination_started:
            raise RuntimeError("cannot set state after nomination started")
        st = envelope.statement
        self.latest_nominations[st.nodeID.key_bytes] = envelope
        nom = st.pledges.value
        for a in nom.accepted:
            self.accepted.add(a)
        for v in nom.votes:
            self.votes.add(v)
        self.last_envelope = envelope

    def get_json_info(self) -> dict:
        return {
            "roundnumber": self.round_number,
            "started": self.nomination_started,
            "votes": len(self.votes),
            "accepted": len(self.accepted),
            "candidates": len(self.candidates),
        }
