"""SCPDriver: the abstract callback surface binding SCP to its host.

Copied from `stellar_core_tpu/scp/driver.py` at commit 94afec1; carry a
fix in either copy to the other. Nothing is left out: the trace hooks
emit against the port's `util/tracing.py` and journal into the port's
`util/slot_timeline.py`.

Role parity: reference `src/scp/SCPDriver.h:66-236` — value validation and
combination, quorum-set lookup, envelope signing/verification/emission,
timers, externalization notification, and hash functions for nomination
leader election. Herder is the sole production subclass; tests mock it.
"""

from __future__ import annotations

import struct
from enum import Enum
from typing import Optional

from ..crypto.hashing import sha256
from ..xdr import SCPEnvelope, SCPQuorumSet, NodeID, Value


class ValidationLevel(Enum):
    INVALID = 0
    FULLY_VALIDATED = 1
    MAYBE_VALID = 2


class SCPTimerID:
    NOMINATION = 0
    BALLOT = 1


class SCPDriver:
    # span tracer (util/tracing.py). When attached (Herder wires the
    # application's), the protocol notification hooks below emit instant
    # events so a Chrome-trace of a round shows nomination/ballot
    # progression between the close spans. None (the default) keeps
    # standalone/test drivers silent.
    tracer = None
    # per-slot event journal (util/slot_timeline.py). When attached, the
    # same hooks (plus the envelope-seen sites in scp/slot.py and the
    # vote/accept sites in scp/nomination.py) journal the slot's
    # consensus progression for the fleet aggregator — always on, unlike
    # the tracer.
    timeline = None
    # consensus cockpit (scp/scp_stats.py). When attached
    # (Herder wires the application's), the envelope sites in
    # scp/slot.py, the round hooks in scp/nomination.py and
    # scp/ballot.py, and the timer plumbing in herder/herder.py feed
    # per-slot phase/round/envelope attribution. None keeps
    # standalone/test drivers cockpit-free.
    scp_stats = None

    def _trace_instant(self, name: str, slot_index: int, **tags) -> None:
        from ..util.tracing import tracer_instant
        tracer_instant(self.tracer, name, cat="scp", slot=slot_index,
                       **tags)
        tl = self.timeline
        if tl is not None:
            tl.record(slot_index, name, dedupe=True, **tags)

    # -- values -------------------------------------------------------------
    def validate_value(self, slot_index: int, value: bytes,
                       nomination: bool) -> ValidationLevel:
        return ValidationLevel.MAYBE_VALID

    def extract_valid_value(self, slot_index: int,
                            value: bytes) -> Optional[bytes]:
        return None

    def combine_candidates(self, slot_index: int,
                           candidates: list) -> Optional[bytes]:
        raise NotImplementedError

    # -- envelopes ----------------------------------------------------------
    def sign_envelope(self, envelope: SCPEnvelope) -> None:
        raise NotImplementedError

    def emit_envelope(self, envelope: SCPEnvelope) -> None:
        raise NotImplementedError

    # -- quorum sets --------------------------------------------------------
    def get_qset(self, qset_hash: bytes) -> Optional[SCPQuorumSet]:
        raise NotImplementedError

    # -- timers -------------------------------------------------------------
    def setup_timer(self, slot_index: int, timer_id: int, timeout: float,
                    cb) -> None:
        raise NotImplementedError

    def compute_timeout(self, round_number: int) -> int:
        """Linear backoff capped (reference computeTimeout: min(round, cap)
        seconds with cap 30 * 60? — reference uses 1s per round up to
        MAX_TIMEOUT_SECONDS=30*60). Whole seconds, like the reference's
        std::chrono::seconds — SCP pacing stays on integer arithmetic
        (FL1)."""
        return min(round_number, 30 * 60)

    # -- notifications (optional hooks; base emits trace instants so any
    # subclass calling super() keeps round/ballot timing visible) ----------
    def value_externalized(self, slot_index: int, value: bytes) -> None:
        # no instant here: Herder overrides this and emits the richer
        # "scp.externalize" event (with nominate→externalize latency);
        # a base-class event would just be a dead near-duplicate
        pass

    def nominating_value(self, slot_index: int, value: bytes) -> None:
        self._trace_instant("scp.nominating", slot_index)

    def updated_candidate_value(self, slot_index: int,
                                value: bytes) -> None:
        self._trace_instant("scp.candidate_updated", slot_index)

    def started_ballot_protocol(self, slot_index: int, ballot) -> None:
        self._trace_instant("scp.ballot.start", slot_index,
                            counter=getattr(ballot, "counter", None))

    def accepted_ballot_prepared(self, slot_index: int, ballot) -> None:
        self._trace_instant("scp.ballot.accept_prepared", slot_index,
                            counter=getattr(ballot, "counter", None))

    def confirmed_ballot_prepared(self, slot_index: int, ballot) -> None:
        self._trace_instant("scp.ballot.confirm_prepared", slot_index,
                            counter=getattr(ballot, "counter", None))

    def accepted_commit(self, slot_index: int, ballot) -> None:
        self._trace_instant("scp.ballot.accept_commit", slot_index,
                            counter=getattr(ballot, "counter", None))

    def ballot_did_hear_from_quorum(self, slot_index: int, ballot) -> None:
        self._trace_instant("scp.ballot.heard_quorum", slot_index,
                            counter=getattr(ballot, "counter", None))

    # -- hashing for nomination leader election -----------------------------
    HASH_N = 1
    HASH_P = 2
    HASH_K = 3

    def compute_hash_node(self, slot_index: int, prev: bytes,
                          is_priority: bool, round_number: int,
                          node_id: NodeID) -> int:
        h = sha256(struct.pack(">Q", slot_index) + prev +
                   struct.pack(">II", self.HASH_P if is_priority
                               else self.HASH_N, round_number) +
                   node_id.key_bytes)
        return int.from_bytes(h[:8], "big")

    def compute_value_hash(self, slot_index: int, prev: bytes,
                           round_number: int, value: bytes) -> int:
        h = sha256(struct.pack(">Q", slot_index) + prev +
                   struct.pack(">II", self.HASH_K, round_number) + value)
        return int.from_bytes(h[:8], "big")
