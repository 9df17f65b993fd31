"""Herder: binds SCP to the ledger.

Role parity: reference `src/herder/HerderImpl.{h,cpp}` +
`HerderSCPDriver.{h,cpp}`:
- slot = ledger sequence, value = XDR StellarValue(txset hash, closeTime,
  upgrades)
- envelope signature verify/sign (verifyEnvelope HerderImpl.cpp:1474 —
  batch-verify hot caller #1, routed through the injected BatchSigVerifier)
- tracking / not-tracking state machine with a consensus-stuck watchdog
  (herder/readme.md)
- triggerNextLedger (HerderImpl.cpp:743-832): queue → txset → trim →
  surge → nominate
- valueExternalized: persist SCP history, hand LedgerCloseData to the
  ledger manager, update the tx queue, re-arm the trigger timer.

Copied from `stellar_core_tpu/herder/herder.py` at commit 94afec1; carry
a fix in either copy to the other. Nothing is left out. It reaches
overlay as the reference does, through `getattr(app, "overlay_manager")`:
`broadcast_message`, `random_authenticated_peers`, `ledger_closed` and
`stats.record_envelope` are live on the port's `overlay/OverlayManager`
(a test's relay object may still stand in for it). An application may
install an `out_of_sync_recovery` hook, which overrides the herder's own
recovery path, as in the reference (`tests/test_torch_node.py` runs
both). Deliberately different: the herder needs the app's
`sig_verifier` and raises TypeError without one (the reference's
envelope and admission checks fall back to a CpuSigVerifier), and a
failed drain fails the envelope or the admission with nothing verified
on the CPU; and `validate_value` checks a nominated txset against the
LCL once per (LCL hash, txset hash), keeping the verdict in
`HerderSCPDriver.txset_valid_cache` as stellar-core's HerderSCPDriver
keeps its txset validity cache, where the reference checks it again at
each nomination that carries it: under load on the async verify stack
those checks outran the nomination timers and stalled consensus for
100 s and more (ROADMAP Queue 3 item 11). Kept from the reference's
design and slow: each envelope that arrives uncached is flushed on its
own (`recv_scp_envelope`), one verify launch per envelope; and a
nominated value's signature is checked through `PubKeyUtils.verify_sig`,
on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..crypto.hashing import sha256
from ..scp.driver import SCPDriver, ValidationLevel
from ..scp.scp import SCP
from ..util.cache import RandomEvictionCache
from ..util.log import get_logger
from ..util.threads import main_thread_only
from ..util.timer import VirtualTimer
from ..util.tracing import app_span
from ..xdr import (
    EnvelopeType, LedgerCloseValueSignature, LedgerUpgrade, SCPEnvelope,
    SCPQuorumSet, SCPStatementType, StellarValue, StellarValueExt, Uint32,
    Uint64, Packer,
)
from ..ledger.ledger_manager import LedgerCloseData
from .pending_envelopes import PendingEnvelopes, statement_qset_hash
from .tx_queue import TransactionQueue, TxQueueResult
from .txset import TxSetFrame, _xor
from .upgrades import Upgrades

log = get_logger("Herder")

TXSET_VALID_CACHE_SIZE = 1000


class HerderState:
    HERDER_SYNCING_STATE = 0
    HERDER_TRACKING_STATE = 1


class HerderSCPDriver(SCPDriver):
    """SCPDriver bound to a Herder (reference HerderSCPDriver.cpp)."""

    def __init__(self, herder: "Herder") -> None:
        self.herder = herder
        # SCPDriver trace hooks (scp/driver.py) emit ballot/nomination
        # instants against the application tracer, and journal the same
        # progression into the per-slot timeline (always on)
        self.tracer = getattr(herder.app, "tracer", None)
        self.timeline = getattr(herder.app, "slot_timeline", None)
        # consensus cockpit: the envelope/round hook sites in scp/
        # read this attribute off the driver (Herder builds it first)
        self.scp_stats = getattr(herder, "scp_stats", None)
        # a nominated txset's verdict against the LCL, by (LCL hash,
        # txset hash): the LCL fixes the state it is checked against
        self.txset_valid_cache = RandomEvictionCache(TXSET_VALID_CACHE_SIZE)

    # -- envelope signing ----------------------------------------------------
    def _envelope_sign_bytes(self, st) -> bytes:
        p = Packer()
        p.put(self.herder.app.config.network_id)
        Uint32.pack(p, EnvelopeType.ENVELOPE_TYPE_SCP)
        p.put(st.to_xdr())
        return sha256(p.bytes())

    def sign_envelope(self, envelope: SCPEnvelope) -> None:
        sk = self.herder.app.config.NODE_SEED
        envelope.signature = sk.sign(
            self._envelope_sign_bytes(envelope.statement))

    def emit_envelope(self, envelope: SCPEnvelope) -> None:
        self.herder.emit_envelope(envelope)

    # -- values --------------------------------------------------------------
    def _check_close_time(self, sv: StellarValue, slot_index: int) -> bool:
        lm = self.herder.app.ledger_manager
        lcl = lm.lcl_header
        if slot_index == lcl.ledgerSeq + 1:
            if sv.closeTime <= lcl.scpValue.closeTime:
                return False
        # reject implausible future close times (reference: MAX_TIME_SLIP)
        now = self.herder.app.clock.system_now()
        if sv.closeTime > now + 60:
            return False
        return True

    def validate_value(self, slot_index: int, value: bytes,
                       nomination: bool) -> ValidationLevel:
        try:
            sv = StellarValue.from_xdr(value)
        except Exception:
            return ValidationLevel.INVALID
        if sv.ext.disc == StellarValueExt.STELLAR_VALUE_SIGNED:
            # signed values are nomination-only, and the embedded
            # signature must verify (reference validateValueHelper:203)
            if not nomination or \
                    not self.herder.verify_stellar_value_signature(sv):
                return ValidationLevel.INVALID
        if not self._check_close_time(sv, slot_index):
            return ValidationLevel.INVALID
        lm = self.herder.app.ledger_manager
        if slot_index != lm.lcl_header.ledgerSeq + 1:
            # not the slot we can fully validate against
            return ValidationLevel.MAYBE_VALID
        lclh = lm.lcl_header
        if (not nomination or lclh.ledgerVersion < 11) and \
                sv.ext.disc != 0:
            # ballot protocol (and pre-11 entirely) only supports BASIC
            return ValidationLevel.INVALID
        if nomination and lclh.ledgerVersion >= 11 and \
                sv.ext.disc != StellarValueExt.STELLAR_VALUE_SIGNED:
            # v11+ requires SIGNED for nomination (reference :327-334)
            return ValidationLevel.INVALID
        txset = self.herder.pending.get_tx_set(sv.txSetHash)
        if txset is None:
            return ValidationLevel.MAYBE_VALID
        if nomination:
            if txset.previous_ledger_hash != lm.lcl_hash:
                return ValidationLevel.INVALID
            key = (lm.lcl_hash, sv.txSetHash)
            ok = self.txset_valid_cache.maybe_get(key)
            if ok is None:
                ltx_root = lm.ltx_root()
                ok, _removed = txset.check_or_trim(
                    ltx_root, self.herder.verifier, trim=False)
                self.txset_valid_cache.put(key, ok)
            if not ok:
                return ValidationLevel.INVALID
        if not self._upgrades_valid(sv, nomination):
            return ValidationLevel.INVALID
        return ValidationLevel.FULLY_VALIDATED

    def _upgrades_valid(self, sv: StellarValue, nomination: bool) -> bool:
        """Reference HerderSCPDriver::validateValue:390-414: every upgrade
        must be apply-valid (within OUR supported protocol), strictly
        type-ordered, and — when nominating — match an armed local
        parameter, so foreign upgrades are voted down and stripped by
        extract_valid_value but still applied once externalized."""
        lm = self.herder.app.ledger_manager
        cfg = self.herder.app.config
        last_type = None
        for raw in sv.upgrades:
            if not Upgrades.is_valid_for_apply(
                    raw, lm.lcl_header, cfg.LEDGER_PROTOCOL_VERSION):
                return False
            if nomination and not self.herder.upgrades.is_valid_for_nomination(
                    raw, lm.lcl_header, lm.lcl_header.scpValue.closeTime):
                return False
            t = LedgerUpgrade.from_xdr(raw).disc
            if last_type is not None and last_type >= t:
                return False
            last_type = t
        return True

    def extract_valid_value(self, slot_index: int,
                            value: bytes) -> Optional[bytes]:
        try:
            sv = StellarValue.from_xdr(value)
        except Exception:
            return None
        lm = self.herder.app.ledger_manager
        cfg = self.herder.app.config
        # strip upgrades we would not nominate ourselves (reference
        # extractValidValue:450 runs isValid in nomination mode: foreign
        # or stale upgrades drop out, the rest of the value survives)
        upgrades = [
            u for u in sv.upgrades
            if Upgrades.is_valid_for_apply(
                u, lm.lcl_header, cfg.LEDGER_PROTOCOL_VERSION)
            and self.herder.upgrades.is_valid_for_nomination(
                u, lm.lcl_header, lm.lcl_header.scpValue.closeTime)]
        sv2 = StellarValue(txSetHash=sv.txSetHash, closeTime=sv.closeTime,
                           upgrades=upgrades, ext=sv.ext)
        v2 = sv2.to_xdr()
        if self.validate_value(slot_index, v2, True) == \
                ValidationLevel.FULLY_VALIDATED:
            return v2
        return None

    def combine_candidates(self, slot_index: int,
                           candidates: List[bytes]) -> Optional[bytes]:
        """Best LCL-based txset by (size, total fees from v11, xored-hash
        tiebreak), max closeTime, per-type max of upgrades (reference
        HerderSCPDriver::combineCandidates:608 + compareTxSets +
        lessThanXored)."""
        best_sv: Optional[StellarValue] = None
        max_close = 0
        merged_upgrades: Dict[int, bytes] = {}
        candidates_hash = bytes(32)
        parsed: List[StellarValue] = []
        from ..xdr import LedgerUpgrade
        for raw in candidates:
            try:
                sv = StellarValue.from_xdr(raw)
            except Exception:
                continue
            candidates_hash = _xor(candidates_hash, sha256(raw))
            max_close = max(max_close, sv.closeTime)
            for u in sv.upgrades:
                try:
                    up = LedgerUpgrade.from_xdr(u)
                except Exception:
                    continue
                cur = merged_upgrades.get(up.disc)
                if cur is None or u > cur:
                    merged_upgrades[up.disc] = u
            parsed.append(sv)

        lm = self.herder.app.ledger_manager
        header = lm.lcl_header

        def xored(h: bytes) -> bytes:
            # salting the tiebreak with the candidates hash keeps the
            # winner unpredictable across rounds (reference lessThanXored)
            return _xor(h, candidates_hash)

        usable = []
        for sv in parsed:
            txset = self.herder.pending.get_tx_set(sv.txSetHash)
            if txset is not None and \
                    txset.previous_ledger_hash == lm.lcl_hash:
                fees = txset.total_fees(header)
                usable.append(((txset.size_for_cap(header), fees,
                                xored(sv.txSetHash)), sv))
        if usable:
            best_sv = max(usable, key=lambda t: t[0])[1]
        elif parsed:
            # no candidate txset is known/LCL-based (fetch still in
            # flight): converge on the highest xored hash
            best_sv = max(parsed, key=lambda sv: xored(sv.txSetHash))
        if best_sv is None:
            return None
        out = StellarValue(
            txSetHash=best_sv.txSetHash, closeTime=max_close,
            upgrades=[merged_upgrades[k] for k in sorted(merged_upgrades)],
            ext=StellarValueExt(0, None))
        return out.to_xdr()

    # -- infrastructure ------------------------------------------------------
    def get_qset(self, qset_hash: bytes) -> Optional[SCPQuorumSet]:
        return self.herder.pending.get_quorum_set(qset_hash)

    def setup_timer(self, slot_index: int, timer_id: int, timeout: float,
                    cb) -> None:
        self.herder.setup_scp_timer(slot_index, timer_id, timeout, cb)

    def compute_timeout(self, round_number: int) -> int:
        return min(round_number, 30 * 60)

    def value_externalized(self, slot_index: int, value: bytes) -> None:
        self.herder.value_externalized(slot_index, value)

    def ballot_did_hear_from_quorum(self, slot_index, ballot) -> None:
        super().ballot_did_hear_from_quorum(slot_index, ballot)
        self.herder.track_heartbeat()


class Herder:
    # how far ahead of the current slot envelopes are accepted
    # (overridable via Config.LEDGER_VALIDITY_BRACKET)
    LEDGER_VALIDITY_BRACKET = 100
    # cadence of the self-healing poll while out of sync (app-clock
    # seconds; virtual in tests/simulation)
    OUT_OF_SYNC_RECOVERY_INTERVAL = 2.0
    # newest out-of-bracket externalize-hint slots retained while syncing
    MAX_EXT_HINT_SLOTS = 32

    def __init__(self, app) -> None:
        self.app = app
        cfg = app.config
        if getattr(app, "sig_verifier", None) is None:
            raise TypeError("Herder needs the app's sig_verifier "
                            "(make_verifier); it never verifies on the "
                            "CPU by itself")
        self.verifier = app.sig_verifier
        # consensus cockpit: per-slot phase/round/envelope
        # attribution + quorum health, built BEFORE the driver so the
        # driver's hook sites see it (docs/observability.md
        # #consensus-cockpit)
        from ..scp.local_node import all_nodes_of
        from ..scp.scp_stats import ScpStats
        self.scp_stats = ScpStats(
            metrics=getattr(app, "metrics", None),
            tracer=getattr(app, "tracer", None),
            now_fn=app.clock.now,
            self_id=cfg.node_id().key_bytes.hex(),
            timeline=getattr(app, "slot_timeline", None))
        self.scp_stats.set_quorum(
            nb.hex() for nb in all_nodes_of(cfg.QUORUM_SET))
        self.scp_driver = HerderSCPDriver(self)
        self.scp = SCP(self.scp_driver, cfg.node_id(),
                       cfg.NODE_IS_VALIDATOR, cfg.QUORUM_SET)
        self.pending = PendingEnvelopes(self)
        # tx-lifecycle cockpit: submit → queue → include →
        # externalize → apply latency attribution on the app clock,
        # wired before the queue so eviction/expiry outcomes land in the
        # same funnel (docs/observability.md#overlay-cockpit)
        from .tx_lifecycle import TxLifecycle
        self.tx_lifecycle = TxLifecycle(
            metrics=getattr(app, "metrics", None),
            tracer=getattr(app, "tracer", None),
            now_fn=app.clock.now)
        self.tx_queue = TransactionQueue(
            app.ledger_manager, cfg.TRANSACTION_QUEUE_PENDING_DEPTH,
            cfg.TRANSACTION_QUEUE_BAN_DEPTH, cfg.POOL_LEDGER_MULTIPLIER,
            self.verifier, metrics=getattr(app, "metrics", None),
            lifecycle=self.tx_lifecycle)
        # ingress admission tier: per-source rate classes +
        # bounded intake in FRONT of the queue, so overload sheds before
        # paying signature validation (docs/robustness.md#ingress--overload)
        self.ingress = None
        self.last_retry_after: Optional[float] = None
        if cfg.INGRESS_ENABLED:
            from ..crypto import strkey
            from .ingress import TxIngress
            self.ingress = TxIngress(
                metrics=getattr(app, "metrics", None),
                now_fn=app.clock.now,
                faults=getattr(app, "faults", None),
                classes=cfg.INGRESS_CLASSES,
                priority=[strkey.decode_public_key(a)
                          for a in cfg.INGRESS_PRIORITY_ACCOUNTS],
                untrusted=[strkey.decode_public_key(a)
                           for a in cfg.INGRESS_UNTRUSTED_ACCOUNTS],
                intake_depth=cfg.INGRESS_INTAKE_DEPTH,
                max_sources=cfg.INGRESS_MAX_SOURCES,
                async_intake=cfg.INGRESS_ASYNC_INTAKE,
                sink=self._queue_tx,
                shed_cb=lambda h: self.tx_lifecycle.outcome(h, "shed"))
        self.upgrades = Upgrades()
        self.state = HerderState.HERDER_SYNCING_STATE
        self.tracking_slot: Optional[int] = None
        self._scp_timers: Dict[Tuple[int, int], VirtualTimer] = {}
        self.trigger_timer = VirtualTimer(app.clock)
        self.stuck_timer = VirtualTimer(app.clock)
        # self-healing recovery (out_of_sync_recovery): poll timer,
        # episode start stamp (None = not recovering), episode counter,
        # and the buffer of externalize statements seen for slots beyond
        # the validity bracket — the evidence of where the network is
        self.LEDGER_VALIDITY_BRACKET = getattr(
            cfg, "LEDGER_VALIDITY_BRACKET", self.LEDGER_VALIDITY_BRACKET)
        self.out_of_sync_timer = VirtualTimer(app.clock)
        self.recovery_started_at: Optional[float] = None
        self.recoveries = 0
        self._recovery_counted = False
        self._ext_hints: Dict[int, set] = {}
        self.ledger_close_meta = None
        # register own qset
        q = cfg.QUORUM_SET
        self.pending.add_quorum_set(sha256(q.to_xdr()), q)
        # transitive quorum map (reference QuorumTracker)
        from .quorum_intersection import QuorumTracker
        self.quorum_tracker = QuorumTracker(
            cfg.node_id(), lambda: self.app.config.QUORUM_SET)
        self._nominate_started: dict = {}
        self.last_quorum_intersection: Optional[dict] = None
        # in-flight background intersection check (reference
        # QuorumMapIntersectionState): the main loop owns these fields;
        # the worker thread only reads `checker` via its own reference
        self._qic_checker = None      # live QuorumIntersectionChecker
        self._qic_thread = None
        self.quorum_check_recalculating = False

    # -- state machine -------------------------------------------------------
    def bootstrap(self) -> None:
        """FORCE_SCP start (reference Herder::bootstrap)."""
        cfg = self.app.config
        assert cfg.FORCE_SCP
        self.set_tracking(self.app.ledger_manager.last_closed_ledger_num())
        self.app.ledger_manager.state = 1  # synced
        if not cfg.MANUAL_CLOSE:
            self._arm_trigger_timer()

    def update_upgrades_status(self) -> None:
        """Status line while upgrade parameters are armed (reference
        HerderImpl upgrades status, :843-860)."""
        from ..util.status_manager import StatusCategory
        sm = getattr(self.app, "status_manager", None)
        if sm is None:
            return
        p = self.upgrades.params
        armed = {k: v for k, v in p.to_json().items()
                 if k != "time" and v is not None}
        if armed:
            sm.set_status_message(
                StatusCategory.REQUIRES_UPGRADES,
                "Armed with network upgrades: %s" % armed)
        else:
            sm.remove_status_message(StatusCategory.REQUIRES_UPGRADES)

    def set_tracking(self, slot: int) -> None:
        was_recovering = self.recovery_started_at is not None
        self.state = HerderState.HERDER_TRACKING_STATE
        self.tracking_slot = slot
        if was_recovering:
            # a recovery episode ends the moment consensus tracks again:
            # stop the poll, stamp time-to-tracking (the scenario suite's
            # headline recovery number), and journal the moment
            dt = max(0.0, self.app.clock.now() - self.recovery_started_at)
            self.recovery_started_at = None
            self._recovery_counted = False
            self.out_of_sync_timer.cancel()
            m = self._metrics()
            if m is not None:
                m.new_meter("herder.recovery.resumed").mark()
                m.new_timer("herder.recovery.time-to-tracking").update(dt)
            tl = getattr(self.app, "slot_timeline", None)
            if tl is not None:
                tl.record(slot, "recovery.tracked", dedupe=True,
                          time_to_tracking_s=round(dt, 6))
            log.info("consensus sync recovered at slot %d after %.3fs",
                     slot, dt)
        self.track_heartbeat()

    def track_heartbeat(self) -> None:
        cfg = self.app.config
        self.stuck_timer.expires_from_now(
            cfg.CONSENSUS_STUCK_TIMEOUT_SECONDS)
        self.stuck_timer.async_wait(self._lost_sync)

    def _lost_sync(self) -> None:
        log.warning("lost consensus sync (stuck timer fired)")
        m = self._metrics()
        if m is not None:
            m.new_meter("herder.recovery.lost-sync").mark()
        # SCP-stall flight dump: the spans/metrics leading into the stall
        # are the evidence that outlives the wedge (a stalled relay
        # once went unexplained for a round)
        recorder = getattr(self.app, "flight_recorder", None)
        if recorder is not None:
            recorder.dump("scp-stall",
                          extra={"tracking_slot": self.tracking_slot,
                                 "state": "syncing"})
        self.state = HerderState.HERDER_SYNCING_STATE
        tl = getattr(self.app, "slot_timeline", None)
        if tl is not None:
            tl.record(self.current_slot(), "recovery.lost-sync",
                      dedupe=True)
        # one anchor per recovery episode: the
        # clock stamp lands HERE, at the same moment the journal's
        # `recovery.lost-sync` record does, so time-to-tracking and the
        # timeline measure the same episode. The first poll used to
        # stamp it a poll-dispatch later — the two surfaces disagreed by
        # that skew. Episode COUNTING stays with the default poll path
        # (an app-installed hook overrides recovery, not the anchor).
        if self.recovery_started_at is None:
            self.recovery_started_at = self.app.clock.now()
        # an app-installed hook still overrides (test/operator hook
        # contract); the default is the real self-healing path below
        hook = getattr(self.app, "out_of_sync_recovery", None)
        if hook is not None:
            hook()
        else:
            self.out_of_sync_recovery()

    # -- self-healing recovery -------------------------------------
    def _note_externalize_hint(self, envelope: SCPEnvelope) -> None:
        """Remember EXTERNALIZE statements for slots beyond the validity
        bracket instead of dropping them blind: they are the evidence of
        where the network is when we are far behind. Only statements from
        transitive-quorum nodes WITH a valid envelope signature count —
        hints steer catchup and the recovery loop, so one forged envelope
        claiming an absurd slot under a quorum member's id must not
        poison network_tracked_slot — and the buffer holds the newest
        MAX_EXT_HINT_SLOTS slots."""
        st = envelope.statement
        if st.pledges.disc != SCPStatementType.SCP_ST_EXTERNALIZE:
            return
        if not self.quorum_tracker.is_node_definitely_in_quorum(st.nodeID):
            return
        slot, node_key = st.slotIndex, st.nodeID.key_bytes
        if node_key in self._ext_hints.get(slot, ()):
            return   # already counted: no repeat verify work
        fut = self.verifier.enqueue(
            st.nodeID, envelope.signature,
            self.scp_driver._envelope_sign_bytes(st))

        def done(ok: bool) -> None:
            if not ok:
                log.debug("bad signature on externalize hint for slot %d",
                          slot)
                return
            self._ext_hints.setdefault(slot, set()).add(node_key)
            while len(self._ext_hints) > self.MAX_EXT_HINT_SLOTS:
                del self._ext_hints[min(self._ext_hints)]

        if fut.done():
            done(fut.result())
        else:
            fut.add_done_callback(done)

    def network_tracked_slot(self) -> Optional[int]:
        """Best estimate of the slot the network currently externalizes:
        max over (a) buffered out-of-bracket externalize hints, (b)
        EXTERNALIZE statements sitting in live SCP slots, (c) ledgers the
        catchup manager has buffered. None = no evidence."""
        best: Optional[int] = None
        if self._ext_hints:
            best = max(self._ext_hints)
        for idx in sorted(self.scp.known_slots, reverse=True):
            if best is not None and idx <= best:
                break
            for env in self.scp.known_slots[idx].get_current_state():
                if env.statement.pledges.disc == \
                        SCPStatementType.SCP_ST_EXTERNALIZE:
                    best = idx if best is None else max(best, idx)
                    break
        cm = getattr(self.app, "catchup_manager", None)
        if cm is not None:
            mb = cm.max_buffered_seq()
            if mb is not None:
                best = mb if best is None else max(best, mb)
        return best

    @main_thread_only
    def out_of_sync_recovery(self) -> None:
        """The self-healing path (reference HerderImpl::outOfSyncRecovery
        + getMoreSCPState): on each poll while not tracking, shed SCP
        state for slots that can no longer close, locate the network's
        tracked slot from buffered externalize evidence, solicit fresh
        SCP state from a few peers, and — when the gap needs history —
        trigger catchup through the CatchupWork/ArchivePool machinery.
        Tracking resumes via set_tracking when a slot externalizes."""
        if self.state == HerderState.HERDER_TRACKING_STATE:
            return
        m = self._metrics()
        clock = self.app.clock
        if self.recovery_started_at is None:
            # direct invocation (tests, operator): no _lost_sync ran, so
            # the episode anchors at the first poll
            self.recovery_started_at = clock.now()
        first = not self._recovery_counted
        if first:
            self._recovery_counted = True
            self.recoveries += 1
        if m is not None:
            m.new_meter("herder.recovery.attempt").mark()
        cur = self.current_slot()
        net_slot = self.network_tracked_slot()

        # 1. shed stale SCP slots: anything below the open slot can never
        # close anymore, and dropping it speeds envelope processing
        stale = [s for s in self.scp.known_slots if s < max(1, cur - 1)]
        if stale:
            keep_from = max(1, cur - 1)
            self.scp.purge_slots(keep_from)
            self.pending.erase_below(keep_from)
            if m is not None:
                m.new_counter("herder.recovery.purged-slots").inc(
                    len(stale))

        # 2. solicit current SCP state from a few random peers (reference
        # getMoreSCPState): a partitioned-and-healed node re-learns the
        # live slots without waiting for the next natural flood
        overlay = getattr(self.app, "overlay_manager", None)
        asked = 0
        if overlay is not None and \
                hasattr(overlay, "random_authenticated_peers"):
            from ..xdr import MessageType, StellarMessage
            for peer in overlay.random_authenticated_peers(3):
                peer.send_message(StellarMessage(
                    MessageType.GET_SCP_STATE, max(0, cur - 1)))
                asked += 1
        if m is not None and asked:
            m.new_meter("herder.recovery.scp-state-request").mark(asked)

        # 3. the ledger gap needs history: run catchup via the existing
        # CatchupWork/ArchivePool machinery (multi-archive failover and
        # all — docs/robustness.md#archive-domain)
        cm = getattr(self.app, "catchup_manager", None)
        hm = getattr(self.app, "history_manager", None)
        triggered = False
        if net_slot is not None and net_slot > cur and cm is not None \
                and not cm.catchup_running() and hm is not None \
                and hm.readable_archive() is not None:
            if cm.start_catchup() is not None:
                triggered = True
                if m is not None:
                    m.new_meter("herder.recovery.catchup-triggered").mark()

        tl = getattr(self.app, "slot_timeline", None)
        if tl is not None:
            tl.record(cur, "recovery.attempt",
                      net_slot=net_slot, catchup=triggered)
        if first:
            recorder = getattr(self.app, "flight_recorder", None)
            if recorder is not None:
                # recovery-correlated dump: the state of the node at the
                # moment self-healing started (rate-limited per reason)
                recorder.dump("out-of-sync-recovery",
                              extra={"net_slot": net_slot,
                                     "current_slot": cur,
                                     "catchup_triggered": triggered,
                                     "ext_hint_slots":
                                         sorted(self._ext_hints)[-8:]})
        log.info("out-of-sync recovery: slot %d, network at %s, "
                 "purged %d stale slots, asked %d peers, catchup=%s",
                 cur, net_slot, len(stale), asked, triggered)

        # 4. keep polling until tracking resumes
        self.out_of_sync_timer.expires_from_now(
            self.OUT_OF_SYNC_RECOVERY_INTERVAL)
        self.out_of_sync_timer.async_wait(self.out_of_sync_recovery)

    # -- signed close values (v11+) ------------------------------------------
    def _stellar_value_sign_bytes(self, sv: StellarValue) -> bytes:
        """networkID ‖ ENVELOPE_TYPE_SCPVALUE ‖ txSetHash ‖ closeTime
        (reference signStellarValue/verifyStellarValueSignature,
        HerderImpl.cpp:1498-1516). The signature deliberately excludes
        upgrades so extractValidValue can strip them."""
        p = Packer()
        p.put(self.app.config.network_id)
        Uint32.pack(p, EnvelopeType.ENVELOPE_TYPE_SCPVALUE)
        p.put(sv.txSetHash)
        Uint64.pack(p, sv.closeTime)
        return p.bytes()

    def sign_stellar_value(self, sv: StellarValue) -> None:
        sk = self.app.config.NODE_SEED
        sv.ext = StellarValueExt(
            StellarValueExt.STELLAR_VALUE_SIGNED,
            LedgerCloseValueSignature(
                nodeID=sk.public_key,
                signature=sk.sign(self._stellar_value_sign_bytes(sv))))

    def verify_stellar_value_signature(self, sv: StellarValue) -> bool:
        from ..crypto.keys import PubKeyUtils
        lcs = sv.ext.value
        return PubKeyUtils.verify_sig(
            lcs.nodeID, lcs.signature, self._stellar_value_sign_bytes(sv))

    def current_slot(self) -> int:
        return self.app.ledger_manager.last_closed_ledger_num() + 1

    # -- transaction intake --------------------------------------------------
    def _metrics(self):
        return getattr(self.app, "metrics", None)

    def recv_transaction(self, frame) -> int:
        """HOT CALLER #2 via TransactionQueue.try_add → checkValid.
        The ingress tier decides first: a throttled or shed
        tx returns TRY_AGAIN_LATER *before* any signature validation is
        paid, with `last_retry_after` carrying the hint `cmd_tx`
        surfaces to the submitter."""
        m = self._metrics()
        if m is not None:
            m.new_meter("herder.tx.received").mark()
        # lifecycle stamp: submit at entry, queue on admission — the
        # submit→queue stage is the admission (signature-check) cost. A
        # re-flooded duplicate must not clobber the original's stamps.
        h = frame.full_hash()
        fresh = self.tx_lifecycle.submit(h)
        self.last_retry_after = None
        ing = self.ingress
        if ing is not None:
            from . import ingress as _ing
            decision, retry_after = ing.admit(frame, tx_hash=h,
                                              fresh=fresh)
            if decision in (_ing.THROTTLE, _ing.SHED):
                if fresh:
                    self.tx_lifecycle.outcome(
                        h, "shed" if decision == _ing.SHED
                        else "throttled")
                self.last_retry_after = retry_after
                return TxQueueResult.ADD_STATUS_TRY_AGAIN_LATER
            if decision == _ing.PARKED:
                # accepted into the bounded intake; the pump delivers it
                # to the queue at the next trigger (optimistic PENDING —
                # open-loop submitters treat it as accepted)
                return TxQueueResult.ADD_STATUS_PENDING
        status = self._queue_tx(frame, h, fresh)
        if status == TxQueueResult.ADD_STATUS_TRY_AGAIN_LATER:
            # pool-side backpressure (source limit / fee floor): a close
            # drains the pool, so that is the honest retry horizon
            self.last_retry_after = \
                self.app.config.EXPECTED_LEDGER_CLOSE_TIME
        return status

    def _queue_tx(self, frame, h: bytes, fresh: bool) -> int:
        """Queue-admission tail shared by the direct path and the
        ingress intake pump."""
        status = self.tx_queue.try_add(frame)
        if status == TxQueueResult.ADD_STATUS_PENDING:
            self.tx_lifecycle.queued(h)
        elif fresh and status != TxQueueResult.ADD_STATUS_DUPLICATE:
            self.tx_lifecycle.outcome(h, "rejected")
        if status == 0:
            m = self._metrics()
            if m is not None:
                m.new_meter("herder.tx.accepted").mark()
        return status

    # -- SCP envelope intake -------------------------------------------------
    @main_thread_only
    def recv_scp_envelope(self, envelope: SCPEnvelope,
                          on_verified=None) -> int:
        """HOT CALLER #1. The signature verify is enqueued on the batch
        backend; with an async backend (cuda/cuda-async) verifies accumulate
        across envelopes into one device dispatch and complete on the main
        loop (the PendingEnvelopes 'verifying' state — async analog of the
        reference's fetch-before-feed buffering). `on_verified(ok)` fires
        when the decision lands (immediately on the sync backend). The
        span `herder.recv_scp_envelope` covers the whole call: the
        verify's enqueue, a sync backend's flush and `on_verified`."""
        with app_span(self.app, "herder.recv_scp_envelope", cat="scp",
                      slot=envelope.statement.slotIndex) as sp:
            state = self._recv_scp_envelope(envelope, on_verified)
            sp.set_tag("state", state)
            return state

    def _recv_scp_envelope(self, envelope: SCPEnvelope,
                           on_verified) -> int:
        m = self._metrics()
        if m is not None:
            m.new_meter("scp.envelope.receive").mark()
        st = envelope.statement
        slot = st.slotIndex
        cur = self.current_slot()
        if slot < max(1, cur - 1) or \
                slot > cur + self.LEDGER_VALIDITY_BRACKET:
            if slot > cur:
                # too far ahead to process, but not to learn from: an
                # externalize statement up there is recovery's evidence
                # of where the network is (out_of_sync_recovery)
                self._note_externalize_hint(envelope)
            return SCP.EnvelopeState.INVALID
        # in-quorum filtering: envelopes from nodes outside the local
        # TRANSITIVE quorum are discarded — they can't affect consensus
        # and dropping them here also saves their signature verifies
        # (reference PendingEnvelopes::recvSCPEnvelope "not in quorum",
        # PendingEnvelopes.cpp:268-273; HerderTests "In quorum filtering")
        if not self.quorum_tracker.is_node_definitely_in_quorum(st.nodeID):
            log.debug("dropping envelope from %s (not in quorum)",
                      st.nodeID.value.hex()[:8])
            return SCP.EnvelopeState.INVALID
        eh = sha256(envelope.to_xdr())
        if not self.pending.begin_verify(envelope, eh):
            # duplicate (processed / discarded / already verifying)
            return SCP.EnvelopeState.INVALID
        # envelope pipeline latency: receive → verify →
        # herder process, app-clock stamped, attributed to the verify
        # backend — the envelope-verify cost ROADMAP item 3's BLS
        # tradeoff study needs on the same axis as bandwidth
        ostats = getattr(getattr(self.app, "overlay_manager", None),
                         "stats", None)
        t_recv = self.app.clock.now()
        fut = self.verifier.enqueue(
            st.nodeID, envelope.signature,
            self.scp_driver._envelope_sign_bytes(st))

        def done(ok: bool) -> None:
            if not ok:
                log.debug("bad envelope signature")
            t_verified = self.app.clock.now()
            self.pending.finish_verify(envelope, ok, eh)
            if ostats is not None:
                ostats.record_envelope(
                    t_verified - t_recv,
                    self.app.clock.now() - t_verified,
                    getattr(self.verifier, "name", "none"), ok)
            if on_verified is not None:
                on_verified(ok)

        if fut.done():
            done(fut.result())
            return (SCP.EnvelopeState.VALID if fut.result()
                    else SCP.EnvelopeState.INVALID)
        fut.add_done_callback(done)
        # batch backends: make sure a dispatch happens even outside the
        # app crank loop (flush coalesces: one dispatch per burst)
        self.verifier.flush()
        if fut.done():
            return (SCP.EnvelopeState.VALID if fut.result()
                    else SCP.EnvelopeState.INVALID)
        return SCP.EnvelopeState.PENDING

    def envelope_ready(self, envelope: SCPEnvelope) -> None:
        """Called by PendingEnvelopes when deps are present."""
        self._update_quorum_tracker(envelope)
        self.scp.receive_envelope(envelope)

    def _update_quorum_tracker(self, envelope: SCPEnvelope) -> None:
        """Keep the transitive quorum map current (reference
        HerderImpl::updateTransitiveQuorum via QuorumTracker::expand,
        rebuilding from the qset cache when expansion fails)."""
        from .pending_envelopes import statement_qset_hash
        st = envelope.statement
        qh = statement_qset_hash(st)
        qset = self.pending.get_quorum_set(qh)
        if qset is None:
            return
        if not self.quorum_tracker.expand(st.nodeID, qset):
            known = {st.nodeID.key_bytes: qset}
            self.quorum_tracker.rebuild(
                lambda node_id: known.get(node_id.key_bytes) or
                self._lookup_node_qset(node_id))

    def _lookup_node_qset(self, node_id):
        """Best-effort qset lookup for rebuild: latest SCP statement this
        node has seen from `node_id` names its qset hash."""
        from .pending_envelopes import statement_qset_hash
        for slot in self.scp.known_slots.values():
            for env in slot.get_current_state():
                if env.statement.nodeID.to_xdr() == node_id.to_xdr():
                    return self.pending.get_quorum_set(
                        statement_qset_hash(env.statement))
        return None

    def check_quorum_intersection(self, critical: bool = False) -> dict:
        """Run the intersection checker over the transitive quorum map
        (reference HerderImpl::checkAndMaybeReanalyzeQuorumMap); with
        critical=True also search for intersection-critical groups
        (reference getIntersectionCriticalGroups)."""
        from .quorum_intersection import QuorumIntersectionChecker
        qmap = self.quorum_tracker.get_quorum()
        checker = QuorumIntersectionChecker(qmap)
        out = self._run_intersection_check(checker, qmap, critical)
        self.last_quorum_intersection = out
        return out

    @staticmethod
    def _run_intersection_check(checker, qmap, critical: bool) -> dict:
        """The computation itself — safe on any thread (touches only the
        checker and the snapshotted qmap). Raises InterruptedError when
        the main loop sets checker.interrupted."""
        from .quorum_intersection import intersection_critical_groups_strkey
        ok = checker.network_enjoys_quorum_intersection()
        out = {
            "node_count": checker.n,
            "intersection": ok,
            "quorums_seen": checker.quorums_seen,
        }
        if checker.last_split is not None:
            out["last_good_split"] = [
                [x.hex() for x in side] for side in checker.last_split]
        if critical:
            # share the checker's interrupt flag with every throwaway
            # checker the criticality scan builds, so a shutdown-time
            # interrupt lands mid-scan too, not just mid-enumeration
            out["intersection_critical"] = \
                intersection_critical_groups_strkey(qmap, parent=checker)
        return out

    def start_quorum_intersection_check(self, critical: bool = False) -> bool:
        """Kick the intersection check onto a worker thread so a slow
        enumeration never stalls ledger close (reference
        checkAndMaybeReanalyzeQuorumMap posts the checker to a background
        thread and keeps mRecalculating state). Returns False if a check
        is already in flight. The result lands in
        last_quorum_intersection via post_to_main on a later crank."""
        import threading
        from .quorum_intersection import QuorumIntersectionChecker
        if self.quorum_check_recalculating:
            return False
        qmap = dict(self.quorum_tracker.get_quorum())
        checker = QuorumIntersectionChecker(qmap)
        self._qic_checker = checker
        self.quorum_check_recalculating = True
        clock = self.app.clock

        def work() -> None:
            try:
                out = self._run_intersection_check(checker, qmap, critical)
            except InterruptedError:
                out = {"node_count": checker.n, "interrupted": True}
            except Exception as e:   # never kill the process from a worker
                out = {"node_count": checker.n, "error": str(e)}

            def install() -> None:
                self.last_quorum_intersection = out
                self.quorum_check_recalculating = False
                self._qic_checker = None
            clock.post_to_main(install)

        self._qic_thread = threading.Thread(
            target=work, name="quorum-intersection", daemon=True)
        self._qic_thread.start()
        return True

    def interrupt_quorum_intersection(self) -> None:
        """Ask an in-flight background check to bail at its next branch
        (reference HerderImpl.cpp:140-144: shutdown sets mInterruptFlag
        to avoid a long pause joining worker threads). Safe to call with
        no check running."""
        checker = self._qic_checker
        if checker is not None:
            checker.interrupted = True

    def recv_tx_set(self, h: bytes, txset: TxSetFrame) -> bool:
        if txset.get_contents_hash(
                hasher=getattr(self.app, "batch_hasher", None)) != h:
            return False
        tl = getattr(self.app, "slot_timeline", None)
        if tl is not None and txset.previous_ledger_hash == \
                self.app.ledger_manager.lcl_hash:
            # journal only txsets actually pinned to the OPEN slot
            # (previous_ledger_hash == LCL): a late fetch for an
            # already-closed slot must not be misfiled under the next
            # one. Dedupe by hash, not sender — two competing nominated
            # txsets are two distinct fetch records.
            tl.record(self.current_slot(), "txset.fetched", dedupe=True,
                      dedupe_key=h.hex(),
                      hash=h.hex()[:8], txs=len(txset.frames))
        self.pending.add_tx_set(h, txset)
        return True

    def recv_scp_quorum_set(self, h: bytes, qset: SCPQuorumSet) -> bool:
        if sha256(qset.to_xdr()) != h:
            return False
        self.pending.add_quorum_set(h, qset)
        return True

    def emit_envelope(self, envelope: SCPEnvelope) -> None:
        # persist our pledges BEFORE they hit the wire: a crash mid-slot
        # must not forget ballots other nodes may hold us to (reference
        # persistSCPState in emitEnvelope, HerderImpl.cpp:302)
        m = self._metrics()
        if m is not None:
            m.new_meter("scp.envelope.emit").mark()
        # consensus cockpit: our half of the O(n²) flood baseline
        from ..scp.scp_stats import STATEMENT_KIND
        st = envelope.statement
        self.scp_stats.envelope_sent(st.slotIndex,
                                     STATEMENT_KIND[st.pledges.disc])
        self.persist_latest_scp_state(envelope.statement.slotIndex)
        overlay = getattr(self.app, "overlay_manager", None)
        if overlay is not None:
            from ..xdr import MessageType, StellarMessage
            overlay.broadcast_message(
                StellarMessage(MessageType.SCP_MESSAGE, envelope), False)

    # -- nomination ----------------------------------------------------------
    @main_thread_only
    def trigger_next_ledger(self, ledger_seq_to_trigger: int) -> None:
        lm = self.app.ledger_manager
        cfg = self.app.config
        lcl = lm.lcl_header
        slot = lcl.ledgerSeq + 1
        if ledger_seq_to_trigger != slot:
            log.debug("stale trigger for %d (slot %d)",
                      ledger_seq_to_trigger, slot)
            return
        with app_span(self.app, "herder.trigger", cat="scp",
                      slot=slot) as tsp:
            if self.ingress is not None:
                # drain the bounded intake (priority class first) into
                # the queue so this trigger's txset sees parked txs
                self.ingress.pump()
            txset = self.tx_queue.to_txset(lm.lcl_hash, cfg.network_id)
            removed = txset.trim_invalid(lm.ltx_root(), self.verifier)
            if removed:
                self.tx_queue.ban([f.full_hash() for f in removed])
            txset.surge_pricing_filter(lcl)
            tsp.set_tag("txs", len(txset.frames))
            h = txset.get_contents_hash(
                hasher=getattr(self.app, "batch_hasher", None))
            self.pending.add_tx_set(h, txset)
            # lifecycle stamp: txset inclusion at nomination (the slot's
            # externalized set may differ; missed stages backfill)
            self.tx_lifecycle.included(
                [f.full_hash() for f in txset.frames])

        close_time = max(self.app.clock.system_now(),
                         lcl.scpValue.closeTime + 1)
        upgrades = self.upgrades.create_upgrades_for(lcl, close_time)
        value = StellarValue(txSetHash=h, closeTime=close_time,
                             upgrades=upgrades,
                             ext=StellarValueExt(0, None))
        if lcl.ledgerVersion >= 11:
            # v11+ nominates SIGNED values (reference signStellarValue,
            # HerderImpl.cpp:828,1508: sig over networkID ‖
            # ENVELOPE_TYPE_SCPVALUE ‖ txSetHash ‖ closeTime)
            self.sign_stellar_value(value)
        prev = lcl.scpValue.to_xdr()
        self._nominate_started[slot] = self.app.clock.now()
        m = self._metrics()
        if m is not None:
            m.new_meter("scp.value.nominated").mark()
        tl = getattr(self.app, "slot_timeline", None)
        if tl is not None:
            tl.record(slot, "nominate.trigger", dedupe=True,
                      txs=len(txset.frames))
        self.scp.nominate(slot, value.to_xdr(), prev)

    def _arm_trigger_timer(self) -> None:
        cfg = self.app.config
        seconds = 0.001 if cfg.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING \
            else cfg.EXPECTED_LEDGER_CLOSE_TIME
        slot = self.current_slot()
        self.trigger_timer.expires_from_now(seconds)
        self.trigger_timer.async_wait(
            lambda: self.trigger_next_ledger(slot))

    # -- externalization -----------------------------------------------------
    def slot_latency_anchor(self, slot_index: int) -> Optional[float]:
        """THE slot-latency anchor (
        docs/observability.md#slot-latency-anchor): the slot's
        `nominate.trigger` timeline stamp, falling back to the in-memory
        nomination-start clock when no journal is attached. The
        timeline's externalize tag, ScpStats' phase wall, and the
        recovery telemetry all measure slot latency from this one
        definition."""
        tl = getattr(self.app, "slot_timeline", None)
        if tl is not None:
            ev = tl.first(slot_index, "nominate.trigger")
            if ev is not None:
                return ev["t"]
        return self._nominate_started.get(slot_index)

    @main_thread_only
    def value_externalized(self, slot_index: int, value: bytes) -> None:
        t0 = self.slot_latency_anchor(slot_index)
        self._nominate_started.pop(slot_index, None)
        self._nominate_started = {
            s: t for s, t in self._nominate_started.items()
            if s > slot_index}   # drop stale never-externalized slots
        m = self._metrics()
        lat = (max(0.0, self.app.clock.now() - t0)
               if t0 is not None else None)
        if m is not None:
            m.new_meter("scp.value.externalized").mark()
            if lat is not None:
                # reference scp.timing.externalized: nomination-start →
                # externalize latency per slot
                m.new_timer("scp.timing.externalized").update(lat)
        tracer = getattr(self.app, "tracer", None)
        if tracer is not None and tracer.enabled:
            # round timing rides as a tag: the latency is measured on the
            # app clock, not the tracer clock, so it can't be a span
            tracer.instant("scp.externalize", cat="scp", slot=slot_index,
                           **({} if lat is None else
                              {"nominate_to_externalize_s": round(lat, 6)}))
        tl = getattr(self.app, "slot_timeline", None)
        if tl is not None:
            tl.record(slot_index, "externalize", dedupe=True,
                      **({} if lat is None else
                         {"nominate_to_externalize_s": round(lat, 6)}))
        # consensus cockpit: derive phase latencies from the stamps the
        # timeline just completed, latch the slot's round/envelope/lag
        # attribution (must run AFTER the `externalize` record above)
        self.scp_stats.slot_externalized(slot_index)
        sv = StellarValue.from_xdr(value)
        txset = self.pending.get_tx_set(sv.txSetHash)
        assert txset is not None, "externalized unknown txset"
        self.set_tracking(slot_index)
        self.persist_latest_scp_state(slot_index)
        self.save_scp_history(slot_index)

        # lifecycle stamps around the close: externalize before, apply
        # after the ledger manager returns — externalize→apply is the
        # local close cost the funnel separates from consensus latency
        tx_hashes = [f.full_hash() for f in txset.frames]
        self.tx_lifecycle.externalized(tx_hashes)
        lm = self.app.ledger_manager
        lcd = LedgerCloseData(slot_index, txset, sv)
        lm.value_externalized(lcd)
        if lm.last_closed_ledger_num() >= slot_index:
            self.tx_lifecycle.applied(tx_hashes, slot_index)
        else:
            # buffered into a catchup gap: the close happens later via
            # replay — don't fabricate an apply stamp now
            for h in tx_hashes:
                self.tx_lifecycle.outcome(h, "deferred")

        # disarm upgrade parameters that just externalized or whose
        # scheduled time expired (reference HerderImpl::valueExternalized →
        # Upgrades::removeUpgrades; stale nodes must not keep pushing)
        if self.upgrades.remove_applied_and_expired(
                sv.upgrades, sv.closeTime):
            log.info("upgrades: armed parameters now %s",
                     self.upgrades.params.to_json())
        self.update_upgrades_status()

        # tx queue maintenance
        self.tx_queue.remove_applied(list(txset.frames))
        self.tx_queue.shift()
        if self.ingress is not None:
            # a close drains the pool: reset per-source inflight windows
            # and reap fully-refilled bucket states
            self.ingress.ledger_closed()
        if m is not None:
            m.new_counter("herder.pending-ops.count").set_count(
                self.tx_queue.size_ops())

        # GC old slots + pending state + overlay flood records
        keep_from = max(1, slot_index -
                        self.app.config.MAX_SLOTS_TO_REMEMBER + 1)
        self.scp.purge_slots(keep_from)
        self.pending.erase_below(keep_from)
        # externalize hints at-or-below the closed slot are consumed
        self._ext_hints = {s: v for s, v in self._ext_hints.items()
                           if s > slot_index}
        overlay = getattr(self.app, "overlay_manager", None)
        if overlay is not None and hasattr(overlay, "ledger_closed"):
            overlay.ledger_closed(slot_index)
        self.scp_stats.slot_closed(slot_index)

        if not self.app.config.MANUAL_CLOSE:
            self._arm_trigger_timer()

    # -- SCP timers ----------------------------------------------------------
    def setup_scp_timer(self, slot_index: int, timer_id: int,
                        timeout: float, cb) -> None:
        key = (slot_index, timer_id)
        t = self._scp_timers.get(key)
        if t is None:
            t = VirtualTimer(self.app.clock)
            self._scp_timers[key] = t
        t.cancel()
        ss = self.scp_stats
        if cb is None:
            ss.timer_cancelled(slot_index, timer_id)
            return
        # consensus cockpit: attribute every fire to (timer, round) —
        # arming over a pending schedule counts the implicit cancel
        ss.timer_armed(slot_index, timer_id)

        def fired() -> None:
            ss.timer_fired(slot_index, timer_id)
            cb()

        t.expires_from_now(timeout)
        t.async_wait(fired)

    # -- persistence ---------------------------------------------------------
    def save_scp_history(self, slot_index: int) -> None:
        """Write the slot's SCP envelopes + quorum sets to the history
        tables feeding checkpoint publication (reference
        HerderPersistence::saveSCPHistory, called from
        HerderImpl::valueExternalized at HerderImpl.cpp:183)."""
        db = getattr(self.app, "database", None)
        if db is None:
            return
        from ..crypto.hashing import sha256
        from .pending_envelopes import statement_qset_hash
        envs = self.scp.get_externalizing_state(slot_index)
        db.execute("DELETE FROM scphistory WHERE ledgerseq = ?",
                   (slot_index,))
        for env in envs:
            db.execute(
                "INSERT INTO scphistory (nodeid, ledgerseq, envelope) "
                "VALUES (?, ?, ?)",
                (env.statement.nodeID.key_bytes.hex(), slot_index,
                 env.to_xdr()))
            qh = statement_qset_hash(env.statement)
            qset = self.pending.qsets.get(qh)
            if qset is None and self.app.config.QUORUM_SET is not None:
                local = self.app.config.QUORUM_SET
                if sha256(local.to_xdr()) == qh:
                    qset = local
            if qset is not None:
                db.execute(
                    "INSERT OR REPLACE INTO scpquorums "
                    "(qsethash, lastledgerseq, qset) VALUES (?, ?, ?)",
                    (qh.hex(), slot_index, qset.to_xdr()))
        db.commit()

    def persist_latest_scp_state(self, slot_index: int) -> None:
        db = getattr(self.app, "database", None)
        if db is None:
            return
        import base64
        envs = self.scp.get_latest_messages_send(slot_index)
        blob = b"".join(len(e.to_xdr()).to_bytes(4, "big") + e.to_xdr()
                        for e in envs)
        db.set_state("scphistory", base64.b64encode(blob).decode())
        db.commit()

    def restore_scp_state(self) -> None:
        db = getattr(self.app, "database", None)
        if db is None:
            return
        import base64
        raw = db.get_state("scphistory")
        if not raw:
            return
        blob = base64.b64decode(raw)
        i = 0
        while i + 4 <= len(blob):
            n = int.from_bytes(blob[i:i + 4], "big")
            i += 4
            try:
                env = SCPEnvelope.from_xdr(blob[i:i + n])
                self.scp.set_state_from_envelope(env)
            except Exception as e:
                # persisted-state corruption loses one envelope, not the
                # restart; log it so an operator can see the decay (E1)
                log.warning("discarding corrupt persisted SCP envelope "
                            "at offset %d: %s", i, e)
            i += n

    # -- introspection -------------------------------------------------------
    def get_json_info(self) -> dict:
        return {
            "you": self.app.config.NODE_SEED.strkey_public(),
            "state": ("tracking" if self.state ==
                      HerderState.HERDER_TRACKING_STATE else "syncing"),
            "slot": self.tracking_slot,
            "queue_ops": self.tx_queue.size_ops(),
            "recovery": {
                "recovering": self.recovery_started_at is not None,
                "recoveries": self.recoveries,
                "network_tracked_slot": self.network_tracked_slot(),
            },
            "scp": self.scp.get_json_info(),
            "transitive": {
                "node_count": len(self.quorum_tracker.get_quorum()),
                "intersection": self.last_quorum_intersection,
                "recalculating": self.quorum_check_recalculating,
            },
        }
