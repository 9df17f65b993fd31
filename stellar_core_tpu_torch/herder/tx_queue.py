"""TransactionQueue: the pending transaction pool.

Copied from `stellar_core_tpu/herder/tx_queue.py` at commit 94afec1;
carry a fix in either copy to the other. Nothing is left out.
Deliberately different: the queue needs a verifier and raises TypeError
without one (the reference's admission check falls back to a
CpuSigVerifier), and a failed drain fails the admission with nothing
verified on the CPU.

Role parity: reference `src/herder/TransactionQueue.{h,cpp}:25-227`:
- per-account chains sorted by sequence number
- age-based expiry: txs not included within pendingDepth (4) ledgers are
  dropped and banned for banDepth (10) ledgers
- replace-by-fee requires >= 10x the old fee (FEE_MULTIPLIER)
- pool cap: maxTxSetSize * poolLedgerMultiplier ops
- tryAdd runs full checkValid — batch-verify hot caller #2
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..ledger.ledgertxn import LedgerTxn
from ..util.log import get_logger
from ..util.threads import main_thread_only
from .txset import TxSetFrame

log = get_logger("Herder")


class TxQueueResult:
    ADD_STATUS_PENDING = 0
    ADD_STATUS_DUPLICATE = 1
    ADD_STATUS_ERROR = 2
    ADD_STATUS_TRY_AGAIN_LATER = 3
    ADD_STATUS_FILTERED = 4


class TransactionQueue:
    FEE_MULTIPLIER = 10

    def __init__(self, ledger_access, pending_depth: int = 4,
                 ban_depth: int = 10, pool_ledger_multiplier: int = 2,
                 verifier=None, metrics=None, lifecycle=None) -> None:
        """ledger_access: object exposing .ltx_root() and .header()."""
        if verifier is None:
            raise TypeError("TransactionQueue needs a verifier "
                            "(make_verifier); it never verifies on the "
                            "CPU by itself")
        self._ledger = ledger_access
        self.pending_depth = pending_depth
        self.ban_depth = ban_depth
        self.pool_multiplier = pool_ledger_multiplier
        self.verifier = verifier
        self.metrics = metrics
        # tx-lifecycle cockpit: evict/expire/ban/replace
        # outcomes complete the submit→apply funnel
        self.lifecycle = lifecycle
        # account -> list[frame] sorted by seq; ages are PER ACCOUNT
        # (reference AccountState.mAge: ledgers since the account last
        # had a tx applied — the whole chain expires together)
        self._pending: Dict[bytes, List[object]] = {}
        self._ages: Dict[bytes, int] = {}
        self._known_hashes: Dict[bytes, bytes] = {}  # full hash -> acc
        self._banned: List[set] = [set() for _ in range(ban_depth)]
        # running fee-bid total per FEE source (reference per-account
        # mTotalFees): O(1) admission checks instead of pool scans
        self._fee_totals: Dict[bytes, int] = {}

    def _note_add(self, frame) -> None:
        k = frame.fee_account_id().key_bytes
        self._fee_totals[k] = self._fee_totals.get(k, 0) + frame.fee_bid

    def _note_outcome(self, frame, kind: str) -> None:
        if self.lifecycle is not None:
            self.lifecycle.outcome(frame.full_hash(), kind)

    def _note_remove(self, frame) -> None:
        k = frame.fee_account_id().key_bytes
        left = self._fee_totals.get(k, 0) - frame.fee_bid
        if left > 0:
            self._fee_totals[k] = left
        else:
            self._fee_totals.pop(k, None)

    # -- queries ------------------------------------------------------------
    def size_ops(self) -> int:
        return sum(f.num_operations() for chain in self._pending.values()
                   for f in chain)

    def is_banned(self, tx_hash: bytes) -> bool:
        return any(tx_hash in b for b in self._banned)

    def pool_cap_ops(self) -> int:
        return self._ledger.header().maxTxSetSize * self.pool_multiplier

    # -- add ----------------------------------------------------------------
    @main_thread_only
    def try_add(self, frame) -> int:
        h = frame.full_hash()
        if h in self._known_hashes:
            return TxQueueResult.ADD_STATUS_DUPLICATE
        if self.is_banned(h):
            return TxQueueResult.ADD_STATUS_TRY_AGAIN_LATER
        acc = frame.seq_account_id().key_bytes
        chain = self._pending.get(acc, [])
        # replace-by-fee: same seqnum present?
        replace_idx = None
        for i, f in enumerate(chain):
            if f.seq_num == frame.seq_num:
                if frame.fee_bid < f.fee_bid * self.FEE_MULTIPLIER:
                    return TxQueueResult.ADD_STATUS_ERROR
                replace_idx = i
                break
        # sequence continuity: must extend the chain (or replace)
        cur_seq = self._account_seq(acc)
        if replace_idx is None and \
                frame.seq_num != cur_seq + 1 + len(chain):
            return TxQueueResult.ADD_STATUS_ERROR

        # pool-cap check with surge eviction: a replacement frees its own
        # ops, so it must not count them twice. Victims are only SELECTED
        # here (a hopeless low bid bounces before costing any signature
        # verifies); the eviction COMMITS after the frame proves valid —
        # an invalid tx must never flush honest pending txs for free
        need = self.size_ops() + frame.num_operations() - self.pool_cap_ops()
        if replace_idx is not None:
            need -= chain[replace_idx].num_operations()
        victims = self._surge_victims(frame, need) if need > 0 else []
        if victims is None:
            return TxQueueResult.ADD_STATUS_TRY_AGAIN_LATER

        # full validity check against current ledger — hot verify site
        ltx = LedgerTxn(self._ledger.ltx_root())
        try:
            if getattr(self.verifier, "wants_prewarm", False):
                # ONE batched dispatch for every candidate signature pair
                # of this tx; the per-signer walk inside check_valid then
                # completes off the warm verify cache (hot caller #2,
                # batched the device way — same gate as txset.py's
                # check_or_trim). Required for async backends: their
                # enqueue futures complete on the main loop, never inside
                # a synchronous admission call.
                self.verifier.prewarm_many(frame.candidate_sig_triples(ltx))
            seq_base = frame.seq_num - 1
            if not frame.check_valid(ltx, seq_base, self.verifier):
                return TxQueueResult.ADD_STATUS_ERROR
            # the fee source must cover this full fee BID on top of every
            # bid it already sponsors in the pool (reference
            # TransactionQueue.cpp:196-205 accumulates fee bids; fee
            # source != seq account for fee bumps). A replacement nets
            # out the bid of the tx it replaces.
            header = ltx.load_header()
            fee_acc = frame.fee_account_id().key_bytes
            pending_fees = self._fee_totals.get(fee_acc, 0) + frame.fee_bid
            if replace_idx is not None:
                old = chain[replace_idx]
                if old.fee_account_id().key_bytes == fee_acc:
                    pending_fees -= old.fee_bid
            from ..xdr import LedgerKey, PublicKey
            from ..transactions.account_helpers import (
                account_available_balance,
            )
            entry = ltx.load_without_record(
                LedgerKey.account(PublicKey.ed25519(fee_acc)))
            if entry is None or account_available_balance(
                    header, entry.data.value) < pending_fees:
                return TxQueueResult.ADD_STATUS_ERROR
        finally:
            ltx.rollback()

        if victims:
            self._surge_evict(victims, frame)
        if replace_idx is not None:
            old = chain[replace_idx]
            del self._known_hashes[old.full_hash()]
            # ban the replaced tx directly — ban() would drop the chain
            # tail, but later txs still chain off the replacement
            self._banned[0].add(old.full_hash())
            self._note_remove(old)
            self._note_outcome(old, "replaced")
            chain[replace_idx] = frame
        else:
            chain.append(frame)
            chain.sort(key=lambda f: f.seq_num)
        self._pending[acc] = chain
        self._ages.setdefault(acc, 0)
        self._known_hashes[h] = acc
        self._note_add(frame)
        return TxQueueResult.ADD_STATUS_PENDING

    def _surge_victims(self, frame, need):
        """Pool saturated: pick the lowest-fee-rate pending txs whose
        eviction would admit a strictly better bid (reference
        TransactionQueue::canFitWithEviction role; the surge
        scenario). Only chain TAILS are eligible — an inner eviction
        would break the account's sequence continuity — and a victim
        qualifies only when the incoming fee-per-op strictly beats its
        own. Selection does NOT mutate the pool: None means the incoming
        bid cannot fit even with eviction (nothing is shed for a tx that
        bounces anyway); a list means evicting exactly those tails frees
        `need` ops."""
        # fee rates compared as integer cross-products (a/b < c/d ⇔
        # a*d < c*b for positive denominators) — eviction order is
        # consensus-visible, so no float division here (FL1)
        in_fee = frame.fee_bid
        in_ops = max(1, frame.num_operations())
        own = frame.seq_account_id().key_bytes
        # per-account count of not-yet-selected tail positions: one chain
        # can donate several tails, deepest-first
        tails = {acc: len(chain) for acc, chain in self._pending.items()}
        victims = []
        while need > 0:
            victim_acc = None
            victim_fee, victim_ops = in_fee, in_ops
            victim_tail = None
            for acc, chain in self._pending.items():
                if acc == own or tails[acc] == 0:
                    continue
                tail = chain[tails[acc] - 1]
                t_fee = tail.fee_bid
                t_ops = max(1, tail.num_operations())
                if t_fee * victim_ops < victim_fee * t_ops:
                    victim_acc, victim_tail = acc, tail
                    victim_fee, victim_ops = t_fee, t_ops
            if victim_acc is None:
                return None
            tails[victim_acc] -= 1
            victims.append((victim_acc, victim_tail))
            need -= victim_tail.num_operations()
        return victims

    def _surge_evict(self, victims, frame) -> None:
        """Commit a `_surge_victims` selection: runs only after the
        incoming frame passed full validation, so an invalid tx can never
        flush honest pending txs. Evicted txs are NOT banned: they may be
        resubmitted once the surge clears."""
        m = self.metrics
        for acc, tail in victims:
            chain = self._pending[acc]
            popped = chain.pop()
            assert popped is tail, "pool mutated between select and evict"
            self._known_hashes.pop(popped.full_hash(), None)
            self._note_remove(popped)
            self._note_outcome(popped, "evicted")
            if m is not None:
                m.new_meter("herder.tx-queue.surge-evicted").mark()
            log.debug("surge-evicted tx %s (fee %d over %d op(s) "
                      "underbids %d over %d)",
                      popped.full_hash().hex()[:8],
                      popped.fee_bid, max(1, popped.num_operations()),
                      frame.fee_bid, max(1, frame.num_operations()))
            if not chain:
                self._pending.pop(acc, None)
                self._ages.pop(acc, None)

    def _account_seq(self, acc: bytes) -> int:
        from ..xdr import LedgerKey, PublicKey
        e = self._ledger.ltx_root().get_entry(
            LedgerKey.account(PublicKey.ed25519(acc)))
        return e.data.value.seqNum if e is not None else 0

    # -- ledger-close maintenance -------------------------------------------
    def remove_applied(self, frames: List) -> None:
        for f in frames:
            h = f.full_hash()
            acc = self._known_hashes.pop(h, None)
            if acc is None:
                # also drop any pending tx with same (acc, seq<=applied)
                acc = f.seq_account_id().key_bytes
            chain = self._pending.get(acc)
            if not chain:
                continue
            new_chain = [g for g in chain if g.seq_num > f.seq_num]
            for g in chain:
                if g.seq_num <= f.seq_num:
                    self._note_remove(g)
                    if g.full_hash() != h:
                        self._known_hashes.pop(g.full_hash(), None)
                        # a chain-mate invalidated by the applied tx's
                        # seq advance (the applied tx itself finalizes
                        # via TxLifecycle.applied)
                        self._note_outcome(g, "dropped")
            if new_chain:
                self._pending[acc] = new_chain
                # the account saw a tx applied this ledger: age resets
                self._ages[acc] = 0
            else:
                self._pending.pop(acc, None)
                self._ages.pop(acc, None)

    def shift(self) -> None:
        """Age every account one ledger; an account reaching
        pending_depth has its WHOLE chain banned at once (reference
        shift: per-account mAge, TransactionQueue.cpp:490-530)."""
        self._banned.pop()
        self._banned.insert(0, set())
        for acc in list(self._pending):
            age = self._ages.get(acc, 0) + 1
            if age >= self.pending_depth:
                for f in self._pending[acc]:
                    self._banned[0].add(f.full_hash())
                    self._known_hashes.pop(f.full_hash(), None)
                    self._note_remove(f)
                    self._note_outcome(f, "expired")
                self._pending.pop(acc, None)
                self._ages.pop(acc, None)
            else:
                self._ages[acc] = age

    def ban(self, hashes: List[bytes]) -> None:
        """Ban the listed txs AND drop them from the pool; everything
        chained after a banned tx in its account's chain no longer has a
        valid seq position, so it is dropped and banned too (reference
        TransactionQueue::ban bans the matched tx and its tail)."""
        hs = set(hashes)
        self._banned[0].update(hs)
        # _known_hashes maps hash -> account: jump straight to the one
        # affected chain instead of scanning the whole pool
        for h in hashes:
            acc = self._known_hashes.get(h)
            if acc is None:
                continue
            chain = self._pending.get(acc)
            if not chain:
                continue
            cut = next((i for i, f in enumerate(chain)
                        if f.full_hash() in hs), None)
            if cut is None:
                continue
            for f in chain[cut:]:
                self._banned[0].add(f.full_hash())
                self._known_hashes.pop(f.full_hash(), None)
                self._note_remove(f)
                self._note_outcome(f, "banned")
            if cut:
                self._pending[acc] = chain[:cut]
            else:
                self._pending.pop(acc, None)
                self._ages.pop(acc, None)

    # -- txset construction ---------------------------------------------------
    def to_txset(self, lcl_hash: bytes, network_id: bytes) -> TxSetFrame:
        frames = [f for chain in self._pending.values()
                  for f in chain]
        return TxSetFrame(network_id, lcl_hash, frames)
