"""CatchupManager: online recovery — buffer externalized ledgers while a
CatchupWork heals the gap, then drain the buffer.

Copied from `stellar_core_tpu/catchup/catchup_manager.py` at commit
378eae4; carry a fix in either copy to the other. A buffered close that
fails is logged and leaves the node catching up, as in the reference; a
card fault inside it shows in the verifier's own meters and flight dumps.

Role parity: reference `src/catchup/CatchupManagerImpl.cpp:79-140`
(`processLedger` buffers `LedgerCloseData` keyed by seq, trims below the
LCL, starts catchup at checkpoint boundaries) and
`CatchupWork.cpp:296-305` (`ApplyBufferedLedgersWork` drains the buffer
after the work DAG completes).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..util.log import get_logger
from .catchup_work import CatchupWork
from .range import CatchupConfiguration

log = get_logger("History")


class CatchupManager:
    def __init__(self, app) -> None:
        self.app = app
        self._buffered: Dict[int, object] = {}   # seq -> LedgerCloseData
        self._work: Optional[CatchupWork] = None
        self.catchups_started = 0
        self.catchups_succeeded = 0
        self.catchups_failed = 0
        # wire the gap trigger
        app.ledger_manager.catchup_trigger = self.process_ledger

    # -- externalized-value entry point (reference processLedger) ------------
    def process_ledger(self, lcd) -> None:
        from ..ledger.ledger_manager import LedgerManagerState
        lm = self.app.ledger_manager
        lcl = lm.last_closed_ledger_num()
        if lcd.ledger_seq <= lcl:
            return
        if lcd.ledger_seq == lcl + 1 and not self.catchup_running() \
                and not getattr(lm, "entries_invalidated", False):
            # contiguous and no work in flight: close directly, even while
            # nominally catching up (reference CatchupManagerImpl closes
            # the next ledger and exits catchup when the buffer drains) —
            # this also keeps archive-less nodes alive
            if self._close_one(lcd) and self._drain_buffer() \
                    and not self._buffered:
                lm.state = LedgerManagerState.LM_SYNCED_STATE
            self._update_catchup_status()
            return
        self._buffered[lcd.ledger_seq] = lcd
        self._trim_buffer()
        if self._work is None or self._work.is_done():
            self.start_catchup()
        self._update_catchup_status()

    def _update_catchup_status(self) -> None:
        """Rolled-up catchup progress line (reference CatchupManagerImpl::
        logAndUpdateCatchupStatus:180-206)."""
        from ..util.status_manager import StatusCategory
        sm = getattr(self.app, "status_manager", None)
        if sm is None:
            return
        if self.catchup_running() or self._buffered:
            lcl = self.app.ledger_manager.last_closed_ledger_num()
            sm.set_status_message(
                StatusCategory.HISTORY_CATCHUP,
                "Catching up from ledger %d: buffered %d externalized "
                "ledgers" % (lcl, len(self._buffered)))
        else:
            sm.remove_status_message(StatusCategory.HISTORY_CATCHUP)

    def buffered_count(self) -> int:
        return len(self._buffered)

    def max_buffered_seq(self) -> Optional[int]:
        """Highest externalized ledger buffered — one of the recovery
        path's network-tracked-slot signals (Herder.network_tracked_slot)."""
        return max(self._buffered) if self._buffered else None

    def catchup_running(self) -> bool:
        return self._work is not None and not self._work.is_done()

    # -- catchup lifecycle ---------------------------------------------------
    def start_catchup(self,
                      config: Optional[CatchupConfiguration] = None,
                      on_done=None) -> Optional[CatchupWork]:
        hm = getattr(self.app, "history_manager", None)
        if hm is None or hm.readable_archive() is None:
            log.warning("catchup needed but no readable archive configured")
            return None
        if config is None:
            cfg = self.app.config
            if cfg.CATCHUP_COMPLETE:
                config = CatchupConfiguration.complete()
            elif cfg.CATCHUP_RECENT > 0:
                config = CatchupConfiguration.recent(cfg.CATCHUP_RECENT)
            else:
                config = CatchupConfiguration.minimal()
        self.catchups_started += 1
        trusted = self._consensus_anchor()
        self._work = CatchupWork(self.app, config, trusted_hash=trusted)

        def done(state) -> None:
            from ..work.basic_work import State
            if state == State.SUCCESS:
                self.catchups_succeeded += 1
                ok = self._drain_buffer()
                self._check_gap_closed(drained_ok=ok)
            else:
                self.catchups_failed += 1
                log.warning("catchup failed; will retry on next gap")
            self._update_catchup_status()
            if on_done is not None:
                on_done(state)

        self.app.work_scheduler.schedule_work(self._work, done)
        return self._work

    def _consensus_anchor(self):
        """The oldest buffered externalized value pins the archive chain:
        its txset's previousLedgerHash IS the consensus hash of ledger
        seq-1, so a forged archive cannot graft a fake chain under real
        SCP traffic (reference anchors catchup at the trigger ledger's
        consensus hash)."""
        if not self._buffered:
            return None
        seq = min(self._buffered)
        lcd = self._buffered[seq]
        prev = getattr(lcd.tx_set, "previous_ledger_hash", None)
        return (seq - 1, prev) if prev is not None else None

    # -- buffered-ledger drain (reference ApplyBufferedLedgersWork) ----------
    def _close_one(self, lcd) -> bool:
        """Close one ledger; on failure log loudly, stay catching-up, and
        never let the exception kill the caller's crank loop (reference:
        prevHash divergence is fatal-loud, LedgerManagerImpl.cpp:463-468)."""
        from ..ledger.ledger_manager import LedgerManagerState
        lm = self.app.ledger_manager
        try:
            lm.close_ledger(lcd)
            return True
        except Exception as e:
            log.error("ledger %d failed to close: %s — discarding and "
                      "staying in catchup", lcd.ledger_seq, e)
            lm.state = LedgerManagerState.LM_CATCHING_UP_STATE
            return False

    def _drain_buffer(self) -> bool:
        """Apply contiguous buffered ledgers; False if a close failed."""
        lm = self.app.ledger_manager
        self._trim_buffer()
        while True:
            nxt = lm.last_closed_ledger_num() + 1
            lcd = self._buffered.pop(nxt, None)
            if lcd is None:
                return True
            if not self._close_one(lcd):
                return False

    def _trim_buffer(self) -> None:
        lcl = self.app.ledger_manager.last_closed_ledger_num()
        for seq in [s for s in self._buffered if s <= lcl]:
            del self._buffered[seq]
        # bound the buffer: keep only the newest window (older ledgers are
        # in — or will be in — the archive; reference keeps a bounded
        # buffered-ledger window)
        cap = max(4 * self.app.config.CHECKPOINT_FREQUENCY, 128)
        if len(self._buffered) > cap:
            for seq in sorted(self._buffered)[:len(self._buffered) - cap]:
                del self._buffered[seq]

    def _check_gap_closed(self, drained_ok: bool = True) -> bool:
        """After a catchup + drain: if buffered ledgers remain beyond a
        hole, go around again (reference: catchup restarts until the node
        reconnects with the live stream)."""
        from ..ledger.ledger_manager import LedgerManagerState
        lm = self.app.ledger_manager
        if not drained_ok:
            return False
        if self._buffered:
            # a hole below min(buffered) isn't in the archive yet; stay in
            # catching-up state — the next externalized ledger re-triggers
            # catchup once the archive has published past the hole
            log.info("gap remains after catchup (lcl %d, %d buffered)",
                     lm.last_closed_ledger_num(), len(self._buffered))
            lm.state = LedgerManagerState.LM_CATCHING_UP_STATE
            return False
        lm.state = LedgerManagerState.LM_SYNCED_STATE
        return True
