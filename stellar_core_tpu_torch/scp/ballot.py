"""BallotProtocol: PREPARE → CONFIRM → EXTERNALIZE federated voting.

Copied from `stellar_core_tpu/scp/ballot.py` at commit a6220d9; carry a
fix in either copy to the other. Nothing is left out.

Role parity: reference `src/scp/BallotProtocol.{h,cpp}` (2,244 lines; state
machine entry points attemptAcceptPrepared / attemptConfirmPrepared /
attemptAcceptCommit / attemptConfirmCommit, BallotProtocol.h:183-200).
Implemented from the SCP internet-draft semantics:

- a ballot is (counter, value); ballots totally ordered lexicographically,
  "compatible" = same value.
- PREPARE statement (b, p, p', nC, nH): votes prepare(b); accepts
  prepare(p) and prepare(p'); votes commit(counters [nC, nH], b.value)
  when nC > 0.
- CONFIRM statement (b, nPrepared, nCommit, nH): accepts
  prepare((nPrepared, b.value)); votes commit([nCommit, ∞), b.value);
  accepts commit([nCommit, nH], b.value).
- EXTERNALIZE statement (commit, nH): accepts commit([commit.counter, ∞)),
  accepts prepare((∞, commit.value)).

federated-accept(stmt-votes, stmt-accepts) = v-blocking set accepts, OR a
quorum votes-or-accepts. federated-ratify = quorum accepts.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from ..xdr import (
    SCPBallot, SCPConfirm, SCPEnvelope, SCPExternalize, SCPPledges,
    SCPPrepare, SCPStatement, SCPStatementType, Value,
)
from .local_node import LocalNode

UINT32_MAX = 2**32 - 1

Ballot = Tuple[int, bytes]  # (counter, value)


def _bt(b: SCPBallot) -> Ballot:
    return (b.counter, b.value)


def _mk(b: Ballot) -> SCPBallot:
    return SCPBallot(counter=b[0], value=b[1])


def compatible(a: Ballot, b: Ballot) -> bool:
    return a[1] == b[1]


def less_and_compatible(a: Ballot, b: Ballot) -> bool:
    return a <= b and compatible(a, b)


def less_and_incompatible(a: Ballot, b: Ballot) -> bool:
    return a <= b and not compatible(a, b)


class SCPPhase:
    PREPARE = 0
    CONFIRM = 1
    EXTERNALIZE = 2


class BallotProtocol:
    def __init__(self, slot) -> None:
        self.slot = slot
        self.phase = SCPPhase.PREPARE
        self.b: Optional[Ballot] = None          # current ballot
        self.p: Optional[Ballot] = None          # prepared
        self.pp: Optional[Ballot] = None         # prepared prime
        self.c: Optional[Ballot] = None          # commit (low)
        self.h: Optional[Ballot] = None          # high
        self.value_override: Optional[bytes] = None
        self.latest_envelopes: Dict[bytes, SCPEnvelope] = {}
        self.last_envelope: Optional[SCPEnvelope] = None
        self.last_envelope_emit: Optional[SCPEnvelope] = None
        self.heard_from_quorum = False
        self.current_message_level = 0

    # ------------------------------------------------------------------ util
    def _driver(self):
        return self.slot.scp.driver

    def _journal_phase(self, phase_name: str, **tags) -> None:
        """Ballot phase transitions (PREPARE→CONFIRM→EXTERNALIZE) into
        the per-slot timeline (util/slot_timeline.py)."""
        tl = getattr(self.slot.scp.driver, "timeline", None)
        if tl is not None:
            tl.record(self.slot.slot_index, "ballot.phase." + phase_name,
                      dedupe=True, **tags)

    def _local(self) -> LocalNode:
        return self.slot.scp.local_node

    def _qset_of(self, st: SCPStatement):
        return self.slot.get_quorum_set_from_statement(st)

    # -------------------------------------------------- statement predicates
    @staticmethod
    def statement_ballot_counter(st: SCPStatement) -> int:
        t = st.pledges.disc
        if t == SCPStatementType.SCP_ST_PREPARE:
            return st.pledges.value.ballot.counter
        if t == SCPStatementType.SCP_ST_CONFIRM:
            return st.pledges.value.ballot.counter
        return UINT32_MAX  # EXTERNALIZE

    @staticmethod
    def is_statement_sane(st: SCPStatement, is_self: bool) -> bool:
        t = st.pledges.disc
        if t == SCPStatementType.SCP_ST_PREPARE:
            p = st.pledges.value
            b, pr, ppr = _bt(p.ballot), p.prepared, p.preparedPrime
            if not (is_self or b[0] > 0):
                return False
            if pr is not None and ppr is not None:
                if not (_bt(ppr) < _bt(pr) and
                        not compatible(_bt(ppr), _bt(pr))):
                    return False
            if ppr is not None and pr is None:
                return False
            if p.nH > 0 and (pr is None or p.nH > pr.counter):
                return False
            if p.nC > 0 and not (p.nH > 0 and b[0] >= p.nH >= p.nC):
                return False
            return True
        if t == SCPStatementType.SCP_ST_CONFIRM:
            c = st.pledges.value
            return (c.ballot.counter > 0 and c.nH <= c.ballot.counter and
                    c.nCommit <= c.nH)
        if t == SCPStatementType.SCP_ST_EXTERNALIZE:
            e = st.pledges.value
            return e.commit.counter > 0 and e.nH >= e.commit.counter
        return False

    # "st accepts prepare(ballot)"
    @staticmethod
    def has_prepared_ballot(ballot: Ballot, st: SCPStatement) -> bool:
        t = st.pledges.disc
        if t == SCPStatementType.SCP_ST_PREPARE:
            p = st.pledges.value
            return ((p.prepared is not None and
                     less_and_compatible(ballot, _bt(p.prepared))) or
                    (p.preparedPrime is not None and
                     less_and_compatible(ballot, _bt(p.preparedPrime))))
        if t == SCPStatementType.SCP_ST_CONFIRM:
            c = st.pledges.value
            prepared = (c.nPrepared, c.ballot.value)
            return less_and_compatible(ballot, prepared)
        e = st.pledges.value
        return compatible(ballot, (0, e.commit.value))

    # "st votes prepare(ballot)" (vote-or-accept)
    @staticmethod
    def votes_prepared(ballot: Ballot, st: SCPStatement) -> bool:
        t = st.pledges.disc
        if t == SCPStatementType.SCP_ST_PREPARE:
            p = st.pledges.value
            return (less_and_compatible(ballot, _bt(p.ballot)) or
                    BallotProtocol.has_prepared_ballot(ballot, st))
        if t == SCPStatementType.SCP_ST_CONFIRM:
            c = st.pledges.value
            return compatible(ballot, (0, c.ballot.value))
        e = st.pledges.value
        return compatible(ballot, (0, e.commit.value))

    # commit interval predicates for value v over [lo, hi]
    @staticmethod
    def accepts_commit(v: bytes, lo: int, hi: int,
                       st: SCPStatement) -> bool:
        t = st.pledges.disc
        if t == SCPStatementType.SCP_ST_CONFIRM:
            c = st.pledges.value
            return (c.ballot.value == v and
                    c.nCommit <= lo and hi <= c.nH)
        if t == SCPStatementType.SCP_ST_EXTERNALIZE:
            e = st.pledges.value
            return e.commit.value == v and e.commit.counter <= lo
        return False

    @staticmethod
    def votes_commit(v: bytes, lo: int, hi: int, st: SCPStatement) -> bool:
        t = st.pledges.disc
        if t == SCPStatementType.SCP_ST_PREPARE:
            p = st.pledges.value
            return (p.ballot.value == v and p.nC > 0 and
                    p.nC <= lo and hi <= p.nH)
        if t == SCPStatementType.SCP_ST_CONFIRM:
            c = st.pledges.value
            return c.ballot.value == v and c.nCommit <= lo
        e = st.pledges.value
        return e.commit.value == v and e.commit.counter <= lo

    # ------------------------------------------------------ federated voting
    def _federated_accept(self, votes_pred: Callable, accepted_pred) -> bool:
        local = self._local()
        if LocalNode.is_v_blocking_filter(
                local.qset, self.latest_envelopes.values(), accepted_pred):
            return True

        def vote_or_accept(st: SCPStatement) -> bool:
            return votes_pred(st) or accepted_pred(st)
        return LocalNode.is_quorum(
            local.qset, self.latest_envelopes, self._qset_of,
            vote_or_accept)

    def _federated_ratify(self, accepted_pred: Callable) -> bool:
        return LocalNode.is_quorum(
            self._local().qset, self.latest_envelopes, self._qset_of,
            accepted_pred)

    # --------------------------------------------------------------- intake
    class EnvelopeState:
        INVALID = 0
        VALID = 1

    def process_envelope(self, envelope: SCPEnvelope, is_self: bool) -> int:
        st = envelope.statement
        nb = st.nodeID.key_bytes
        if not self.is_statement_sane(st, is_self):
            return self.EnvelopeState.INVALID
        old = self.latest_envelopes.get(nb)
        if old is not None and not self._is_newer(st, old.statement):
            return self.EnvelopeState.INVALID
        if not is_self and not self._validate_values(st):
            return self.EnvelopeState.INVALID
        self.latest_envelopes[nb] = envelope
        self.advance_slot(st)
        return self.EnvelopeState.VALID

    @staticmethod
    def _is_newer(st: SCPStatement, old: SCPStatement) -> bool:
        tn, to = st.pledges.disc, old.pledges.disc
        if tn != to:
            order = {SCPStatementType.SCP_ST_PREPARE: 0,
                     SCPStatementType.SCP_ST_CONFIRM: 1,
                     SCPStatementType.SCP_ST_EXTERNALIZE: 2}
            return order[tn] > order[to]
        if tn == SCPStatementType.SCP_ST_PREPARE:
            a, b = st.pledges.value, old.pledges.value
            key_a = (_bt(a.ballot),
                     _bt(a.prepared) if a.prepared else (0, b""),
                     _bt(a.preparedPrime) if a.preparedPrime else (0, b""),
                     a.nH)
            key_b = (_bt(b.ballot),
                     _bt(b.prepared) if b.prepared else (0, b""),
                     _bt(b.preparedPrime) if b.preparedPrime else (0, b""),
                     b.nH)
            return key_a > key_b
        if tn == SCPStatementType.SCP_ST_CONFIRM:
            a, b = st.pledges.value, old.pledges.value
            ka = (_bt(a.ballot), a.nPrepared, a.nCommit, a.nH)
            kb = (_bt(b.ballot), b.nPrepared, b.nCommit, b.nH)
            return ka > kb
        return False  # EXTERNALIZE statements are final

    def _validate_values(self, st: SCPStatement) -> bool:
        from .driver import ValidationLevel
        values = set()
        t = st.pledges.disc
        if t == SCPStatementType.SCP_ST_PREPARE:
            p = st.pledges.value
            if p.ballot.counter:
                values.add(p.ballot.value)
            if p.prepared is not None:
                values.add(p.prepared.value)
        elif t == SCPStatementType.SCP_ST_CONFIRM:
            values.add(st.pledges.value.ballot.value)
        else:
            values.add(st.pledges.value.commit.value)
        for v in values:
            lvl = self._driver().validate_value(self.slot.slot_index, v,
                                                False)
            if lvl == ValidationLevel.INVALID:
                return False
        return True

    # -------------------------------------------------------------- bumping
    def bump_state(self, value: bytes, force: bool = True,
                   counter: Optional[int] = None) -> bool:
        """Move to ballot (counter, value) — reference bumpState. The value
        is overridden by value_override once a confirmed-prepared /
        accepted-commit value is locked in."""
        if counter is None:
            if not force and self.b is not None:
                return False
            counter = 1 if self.b is None else self.b[0] + 1
        if self.phase not in (SCPPhase.PREPARE, SCPPhase.CONFIRM):
            return False
        new_b = (counter, self.value_override
                 if self.value_override is not None else value)
        updated = self._update_current_value(new_b)
        if updated:
            self._emit_current_statement()
            self._check_heard_from_quorum()
        return updated

    def _update_current_value(self, ballot: Ballot) -> bool:
        if self.phase not in (SCPPhase.PREPARE, SCPPhase.CONFIRM):
            return False
        updated = False
        if self.b is None:
            updated = True
        else:
            # never change the value once committed to one
            if self.c is not None and not compatible(self.c, ballot):
                return False
            if self.b < ballot:
                updated = True
            elif self.b > ballot:
                return False  # never go backwards
        if updated:
            self._bump_to_ballot(ballot, True)
        return updated

    def _bump_to_ballot(self, ballot: Ballot, check: bool) -> None:
        assert self.phase != SCPPhase.EXTERNALIZE
        if check:
            assert self.b is None or ballot >= self.b
        got_bumped = self.b is None or self.b[0] != ballot[0]
        if self.b is None:
            self._driver().started_ballot_protocol(
                self.slot.slot_index, _mk(ballot))
        self.b = ballot
        if got_bumped:
            # a new counter starts a new "heard from quorum" round
            self.heard_from_quorum = False
            ss = getattr(self._driver(), "scp_stats", None)
            if ss is not None:
                # consensus cockpit: ballot-round inflation
                # (counter climb) per slot
                ss.ballot_bumped(self.slot.slot_index, ballot[0])

    def abandon_ballot(self, n: int = 0) -> bool:
        """Timer fired or v-blocking ahead: move to a higher counter with
        the best known value (reference abandonBallot)."""
        v = self.slot.get_latest_composite_candidate()
        if not v and self.b is not None:
            v = self.b[1]
        if not v:
            return False
        if n == 0:
            return self.bump_state(v, True)
        return self.bump_state(v, True, n)

    # ------------------------------------------------------- advance engine
    def advance_slot(self, hint: SCPStatement) -> None:
        """One pass of the protocol steps, in whitepaper order. State
        changes re-enter via self-processing in _emit_current_statement;
        the emitted envelope is consolidated: only the LATEST statement is
        sent, once, when the outermost advance pass unwinds (reference
        advanceSlot/sendLatestEnvelope — this is why cascaded transitions
        produce exactly one wire message)."""
        self.current_message_level += 1
        if self.current_message_level >= 50:
            raise RuntimeError("maximum number of transitions reached")
        did = self.attempt_accept_prepared(hint)
        did = self.attempt_confirm_prepared(hint) or did
        did = self.attempt_accept_commit(hint) or did
        did = self.attempt_confirm_commit(hint) or did
        if self.current_message_level == 1:
            did_bump = True
            while did_bump:
                did_bump = self._attempt_bump()
                did = did_bump or did
            self._check_heard_from_quorum()
        self.current_message_level -= 1
        if did:
            self._send_latest_envelope()

    # prepare candidates: ballots from the hint, intersected downward with
    # everything nodes have claimed (reference getPrepareCandidates)
    def _prepare_candidates(self, hint: SCPStatement) -> List[Ballot]:
        hint_ballots: Set[Ballot] = set()
        t = hint.pledges.disc
        if t == SCPStatementType.SCP_ST_PREPARE:
            p = hint.pledges.value
            hint_ballots.add(_bt(p.ballot))
            if p.prepared is not None:
                hint_ballots.add(_bt(p.prepared))
            if p.preparedPrime is not None:
                hint_ballots.add(_bt(p.preparedPrime))
        elif t == SCPStatementType.SCP_ST_CONFIRM:
            c = hint.pledges.value
            hint_ballots.add((c.nPrepared, c.ballot.value))
            hint_ballots.add((UINT32_MAX, c.ballot.value))
        else:
            e = hint.pledges.value
            hint_ballots.add((UINT32_MAX, e.commit.value))

        out: Set[Ballot] = set()
        for top in hint_ballots:
            val = top[1]
            for env in self.latest_envelopes.values():
                st = env.statement
                tt = st.pledges.disc
                if tt == SCPStatementType.SCP_ST_PREPARE:
                    pp_ = st.pledges.value
                    if less_and_compatible(_bt(pp_.ballot), top):
                        out.add(_bt(pp_.ballot))
                    if pp_.prepared is not None and \
                            less_and_compatible(_bt(pp_.prepared), top):
                        out.add(_bt(pp_.prepared))
                    if pp_.preparedPrime is not None and \
                            less_and_compatible(_bt(pp_.preparedPrime), top):
                        out.add(_bt(pp_.preparedPrime))
                elif tt == SCPStatementType.SCP_ST_CONFIRM:
                    cc = st.pledges.value
                    if compatible(top, _bt(cc.ballot)):
                        out.add(top)
                        if cc.nPrepared < top[0]:
                            out.add((cc.nPrepared, val))
                else:
                    ee = st.pledges.value
                    if compatible(top, _bt(ee.commit)):
                        out.add(top)
        return sorted(out, reverse=True)

    def attempt_accept_prepared(self, hint: SCPStatement) -> bool:
        if self.phase not in (SCPPhase.PREPARE, SCPPhase.CONFIRM):
            return False
        for cand in self._prepare_candidates(hint):
            if self.phase == SCPPhase.CONFIRM:
                # can only augment the prepared interval around the commit
                if not (self.p is not None and
                        less_and_compatible(self.p, cand)):
                    continue
            if self.pp is not None and cand <= self.pp:
                continue  # would help neither p nor p'
            if self.p is not None and less_and_compatible(cand, self.p):
                continue  # already covered by p
            if self._federated_accept(
                    lambda st, c=cand: self.votes_prepared(c, st),
                    lambda st, c=cand: self.has_prepared_ballot(c, st)):
                return self._set_accept_prepared(cand)
        return False

    def _set_accept_prepared(self, ballot: Ballot) -> bool:
        did = self._set_prepared(ballot)
        # an accepted-prepared ballot above h and incompatible with it
        # aborts the pending commit votes
        if self.c is not None and self.h is not None:
            if (self.p is not None and
                    less_and_incompatible(self.h, self.p)) or \
                    (self.pp is not None and
                     less_and_incompatible(self.h, self.pp)):
                assert self.phase == SCPPhase.PREPARE
                self.c = None
                did = True
        if did:
            self._driver().accepted_ballot_prepared(self.slot.slot_index,
                                                    _mk(ballot))
            self._emit_current_statement()
        return did

    def _set_prepared(self, ballot: Ballot) -> bool:
        did = False
        if self.p is not None:
            if self.p < ballot:
                if not compatible(self.p, ballot):
                    self.pp = self.p  # displaced p becomes p'
                self.p = ballot
                did = True
            elif self.p > ballot:
                if self.pp is None or (self.pp < ballot and
                                       not compatible(self.p, ballot)):
                    self.pp = ballot
                    did = True
        else:
            self.p = ballot
            did = True
        return did

    def attempt_confirm_prepared(self, hint: SCPStatement) -> bool:
        if self.phase != SCPPhase.PREPARE or self.p is None:
            return False
        candidates = self._prepare_candidates(hint)
        new_h = None
        idx = 0
        for i, cand in enumerate(candidates):
            if self.h is not None and self.h >= cand:
                break  # can't raise h
            if self._federated_ratify(
                    lambda st, c=cand: self.has_prepared_ballot(c, st)):
                new_h = cand
                idx = i
                break
        if new_h is None:
            return False
        # extend downward to the lowest ratified c >= b (step 3), unless a
        # commit is already set or h is aborted by p/p'
        new_c: Optional[Ballot] = None
        b = self.b if self.b is not None else (0, b"")
        if self.c is None and \
                (self.p is None or
                 not less_and_incompatible(new_h, self.p)) and \
                (self.pp is None or
                 not less_and_incompatible(new_h, self.pp)):
            for cand in candidates[idx:]:
                if cand < b:
                    break
                if not less_and_compatible(cand, new_h):
                    continue
                if self._federated_ratify(
                        lambda st, c=cand: self.has_prepared_ballot(c, st)):
                    new_c = cand
                else:
                    break
        return self._set_confirm_prepared(new_c, new_h)

    def _set_confirm_prepared(self, new_c: Optional[Ballot],
                              new_h: Ballot) -> bool:
        did = False
        self.value_override = new_h[1]
        # c/h only move while we're on a compatible ballot
        if self.b is None or compatible(self.b, new_h):
            if self.h is None or new_h > self.h:
                self.h = new_h
                did = True
            if new_c is not None:
                assert self.c is None
                self.c = new_c
                did = True
            if did:
                self._driver().confirmed_ballot_prepared(
                    self.slot.slot_index, _mk(new_h))
        # always perform step (8) with the computed h
        did = self._update_current_if_needed(new_h) or did
        if did:
            self._emit_current_statement()
        return did

    def _update_current_if_needed(self, h: Ballot) -> bool:
        if self.b is None or self.b < h:
            self._bump_to_ballot(h, True)
            return True
        return False

    # commit boundaries for statements compatible with ballot's value
    def _commit_boundaries(self, ballot: Ballot) -> List[int]:
        out: Set[int] = set()
        v = ballot[1]
        for env in self.latest_envelopes.values():
            st = env.statement
            t = st.pledges.disc
            if t == SCPStatementType.SCP_ST_PREPARE:
                p = st.pledges.value
                if p.ballot.value == v and p.nC:
                    out.add(p.nC)
                    out.add(p.nH)
            elif t == SCPStatementType.SCP_ST_CONFIRM:
                c = st.pledges.value
                if c.ballot.value == v:
                    out.add(c.nCommit)
                    out.add(c.nH)
            else:
                e = st.pledges.value
                if e.commit.value == v:
                    out.add(e.commit.counter)
                    out.add(e.nH)
                    out.add(UINT32_MAX)  # externalize accepts [c, ∞)
        return sorted(out)

    def _find_extended_interval(self, ballot: Ballot, pred) -> Optional[
            Tuple[int, int]]:
        """Largest [lo, hi] over the boundary grid where pred holds,
        scanning from the top (reference findExtendedInterval)."""
        best: Optional[Tuple[int, int]] = None
        for bval in reversed(self._commit_boundaries(ballot)):
            if best is None:
                cand = (bval, bval)
            elif bval > best[1]:
                continue
            else:
                cand = (bval, best[1])
            if pred(cand[0], cand[1]):
                best = cand
            elif best is not None:
                break
        return best

    @staticmethod
    def _hint_commit_ballot(hint: SCPStatement) -> Optional[Ballot]:
        """(nH, value) the hint pushes toward committing; None if none."""
        t = hint.pledges.disc
        if t == SCPStatementType.SCP_ST_PREPARE:
            p = hint.pledges.value
            if p.nC == 0:
                return None
            return (p.nH, p.ballot.value)
        if t == SCPStatementType.SCP_ST_CONFIRM:
            c = hint.pledges.value
            return (c.nH, c.ballot.value)
        e = hint.pledges.value
        return (e.nH, e.commit.value)

    def attempt_accept_commit(self, hint: SCPStatement) -> bool:
        if self.phase not in (SCPPhase.PREPARE, SCPPhase.CONFIRM):
            return False
        ballot = self._hint_commit_ballot(hint)
        if ballot is None:
            return False
        if self.phase == SCPPhase.CONFIRM and \
                not compatible(ballot, self.h):
            return False
        v = ballot[1]

        def pred(lo: int, hi: int) -> bool:
            return self._federated_accept(
                lambda st: self.votes_commit(v, lo, hi, st),
                lambda st: self.accepts_commit(v, lo, hi, st))

        interval = self._find_extended_interval(ballot, pred)
        if interval is None or interval[0] == 0:
            return False  # reference rejects lo=0 (nCommit=0 statements)
        lo, hi = interval
        if self.phase == SCPPhase.CONFIRM and hi <= self.h[0]:
            return False  # nothing gained
        return self._set_accept_commit((lo, v), (hi, v))

    def _set_accept_commit(self, c: Ballot, h: Ballot) -> bool:
        did = False
        self.value_override = h[1]
        if self.h != h or self.c != c:
            self.c = c
            self.h = h
            did = True
        if self.phase == SCPPhase.PREPARE:
            self.phase = SCPPhase.CONFIRM
            self._journal_phase("confirm", counter=h[0])
            if self.b is not None and not less_and_compatible(h, self.b):
                self._bump_to_ballot(h, False)
            self.pp = None
            did = True
        if did:
            self._update_current_if_needed(self.h)
            self._driver().accepted_commit(self.slot.slot_index, _mk(h))
            self._emit_current_statement()
        return did

    def attempt_confirm_commit(self, hint: SCPStatement) -> bool:
        if self.phase != SCPPhase.CONFIRM or \
                self.h is None or self.c is None:
            return False
        if hint.pledges.disc == SCPStatementType.SCP_ST_PREPARE:
            return False
        ballot = self._hint_commit_ballot(hint)
        if ballot is None or not compatible(ballot, self.c):
            return False
        v = ballot[1]

        def pred(lo: int, hi: int) -> bool:
            return self._federated_ratify(
                lambda st: self.accepts_commit(v, lo, hi, st))

        interval = self._find_extended_interval(ballot, pred)
        if interval is None or interval[0] == 0:
            return False  # reference rejects lo=0
        lo, hi = interval
        return self._set_confirm_commit((lo, v), (hi, v))

    def _set_confirm_commit(self, c: Ballot, h: Ballot) -> bool:
        self.c = c
        self.h = h
        self._update_current_if_needed(h)
        self.phase = SCPPhase.EXTERNALIZE
        self._journal_phase("externalize", counter=c[0])
        self._emit_current_statement()
        self.slot.stop_nomination()
        self._driver().value_externalized(self.slot.slot_index, c[1])
        return True

    def _attempt_bump(self) -> bool:
        """A v-blocking set is strictly ahead → jump to the minimal counter
        at which that stops being true (reference attemptBump)."""
        if self.phase not in (SCPPhase.PREPARE, SCPPhase.CONFIRM):
            return False
        local_counter = self.b[0] if self.b is not None else 0

        def vblocking_ahead_of(n: int) -> bool:
            return LocalNode.is_v_blocking_filter(
                self._local().qset, self.latest_envelopes.values(),
                lambda st, n=n: self.statement_ballot_counter(st) > n)

        if not vblocking_ahead_of(local_counter):
            return False
        counters = sorted({self.statement_ballot_counter(e.statement)
                           for e in self.latest_envelopes.values()
                           if self.statement_ballot_counter(e.statement)
                           > local_counter})
        for n in counters:
            if not vblocking_ahead_of(n):
                return self.abandon_ballot(n)
        return False

    # ------------------------------------------------------ timers / quorum
    def _check_heard_from_quorum(self) -> None:
        """Reference semantics (BallotProtocol.cpp:2163-2213): a node has
        "heard from quorum" when a quorum is at-or-past its ballot counter —
        PREPARE statements filter by counter, CONFIRM/EXTERNALIZE always
        count (their counters only move forward). The ballot timer starts
        only on the not-heard → heard transition and is cancelled when the
        quorum falls behind (local counter bumped) or on EXTERNALIZE."""
        if self.b is None:
            return
        bn = self.b[0]

        def pred(st: SCPStatement) -> bool:
            if st.pledges.disc == SCPStatementType.SCP_ST_PREPARE:
                return bn <= st.pledges.value.ballot.counter
            return True
        if LocalNode.is_quorum(self._local().qset, self.latest_envelopes,
                               self._qset_of, pred):
            was = self.heard_from_quorum
            self.heard_from_quorum = True
            if not was:
                self._driver().ballot_did_hear_from_quorum(
                    self.slot.slot_index, _mk(self.b))
                if self.phase != SCPPhase.EXTERNALIZE:
                    self._start_timer()
            if self.phase == SCPPhase.EXTERNALIZE:
                self._stop_timer()
        else:
            self.heard_from_quorum = False
            self._stop_timer()

    def _start_timer(self) -> None:
        from .driver import SCPTimerID
        timeout = self._driver().compute_timeout(self.b[0])
        self._driver().setup_timer(
            self.slot.slot_index, SCPTimerID.BALLOT, timeout,
            self._on_timeout)

    def _stop_timer(self) -> None:
        from .driver import SCPTimerID
        self._driver().setup_timer(
            self.slot.slot_index, SCPTimerID.BALLOT, 0.0, None)

    def _on_timeout(self) -> None:
        self.abandon_ballot(0)

    # ------------------------------------------------------------- emission
    def _make_statement(self) -> SCPStatement:
        local = self._local()
        qh = local.qset_hash
        if self.phase == SCPPhase.PREPARE:
            pl = SCPPledges(
                SCPStatementType.SCP_ST_PREPARE,
                SCPPrepare(
                    quorumSetHash=qh,
                    ballot=_mk(self.b) if self.b else SCPBallot(
                        counter=0, value=b""),
                    prepared=_mk(self.p) if self.p else None,
                    preparedPrime=_mk(self.pp) if self.pp else None,
                    nC=self.c[0] if self.c else 0,
                    nH=self.h[0] if self.h else 0))
        elif self.phase == SCPPhase.CONFIRM:
            pl = SCPPledges(
                SCPStatementType.SCP_ST_CONFIRM,
                SCPConfirm(ballot=_mk(self.b),
                           nPrepared=self.p[0],
                           nCommit=self.c[0], nH=self.h[0],
                           quorumSetHash=qh))
        else:
            pl = SCPPledges(
                SCPStatementType.SCP_ST_EXTERNALIZE,
                SCPExternalize(commit=_mk(self.c), nH=self.h[0],
                               commitQuorumSetHash=qh))
        return SCPStatement(nodeID=local.node_id,
                            slotIndex=self.slot.slot_index, pledges=pl)

    def _emit_current_statement(self) -> None:
        """Record the new statement and process it as our own (re-entering
        advance_slot). The envelope is only SENT when the outermost advance
        pass unwinds — see advance_slot."""
        st = self._make_statement()
        env = self.slot.create_envelope(st)
        can_emit = self.b is not None
        own = self.latest_envelopes.get(self._local().node_id.key_bytes)
        if own is not None and own.statement.to_xdr() == st.to_xdr():
            return  # same statement; h.value can differ while h.n doesn't
        if self.process_envelope(env, is_self=True) != \
                self.EnvelopeState.VALID:
            # The statement total order is (type, b, p, p', h) — it does not
            # cover nC. A c-only update (e.g. confirm-prepared sets c after
            # an incompatible-b pass already emitted the same (b,p,p',h))
            # ties in that order. The reference's own test vectors require
            # the new commit vote to be visible to subsequent quorum math in
            # the same cascade, so record it for ourselves; it is never sent
            # (last_envelope keeps the strict order), and a genuinely
            # regressed statement is a protocol bug.
            if own is not None and self.is_statement_sane(st, True) and \
                    not self._is_newer(own.statement, st):
                self.latest_envelopes[
                    self._local().node_id.key_bytes] = env
                return
            raise RuntimeError("moved to a bad state (ballot protocol)")
        if can_emit and (self.last_envelope is None or
                         self._is_newer(st, self.last_envelope.statement)):
            self.last_envelope = env
            self._send_latest_envelope()

    def _send_latest_envelope(self) -> None:
        if self.current_message_level == 0 and \
                self.last_envelope is not None and self.slot.fully_validated:
            if self.last_envelope_emit is not self.last_envelope:
                self.last_envelope_emit = self.last_envelope
                if self._local().is_validator:
                    self._driver().emit_envelope(self.last_envelope)

    def set_state_from_envelope(self, envelope: SCPEnvelope) -> None:
        """Restore persisted own state directly (reference
        setStateFromEnvelope) — no federated processing, just the statement
        fields back into b/p/p'/c/h and the phase."""
        if self.b is not None:
            raise RuntimeError(
                "cannot set state after starting ballot protocol")
        st = envelope.statement
        self.latest_envelopes[st.nodeID.key_bytes] = envelope
        self.last_envelope = envelope
        self.last_envelope_emit = envelope
        t = st.pledges.disc
        if t == SCPStatementType.SCP_ST_PREPARE:
            p = st.pledges.value
            b = _bt(p.ballot)
            self._bump_to_ballot(b, True)
            if p.prepared is not None:
                self.p = _bt(p.prepared)
            if p.preparedPrime is not None:
                self.pp = _bt(p.preparedPrime)
            if p.nH:
                self.h = (p.nH, b[1])
            if p.nC:
                self.c = (p.nC, b[1])
            self.phase = SCPPhase.PREPARE
        elif t == SCPStatementType.SCP_ST_CONFIRM:
            c = st.pledges.value
            v = c.ballot.value
            self._bump_to_ballot(_bt(c.ballot), True)
            self.p = (c.nPrepared, v)
            self.h = (c.nH, v)
            self.c = (c.nCommit, v)
            self.phase = SCPPhase.CONFIRM
        else:
            e = st.pledges.value
            v = e.commit.value
            self._bump_to_ballot((UINT32_MAX, v), True)
            self.p = (UINT32_MAX, v)
            self.h = (e.nH, v)
            self.c = _bt(e.commit)
            self.phase = SCPPhase.EXTERNALIZE

    # --------------------------------------------------------------- state
    def get_json_info(self) -> dict:
        phase_names = {0: "PREPARE", 1: "CONFIRM", 2: "EXTERNALIZE"}
        return {
            "phase": phase_names[self.phase],
            "ballot": {"counter": self.b[0]} if self.b else None,
            "prepared": {"counter": self.p[0]} if self.p else None,
            "heard": self.heard_from_quorum,
        }

    def externalized_value(self) -> Optional[bytes]:
        if self.phase == SCPPhase.EXTERNALIZE:
            return self.c[1]
        return None
