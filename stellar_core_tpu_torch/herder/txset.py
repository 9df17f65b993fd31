"""TxSetFrame: the content of a consensus value.

Copied from `stellar_core_tpu/herder/txset.py` at commit 637fb91; carry a
fix in either copy to the other.

Role parity: reference `src/herder/TxSetFrame.{h,cpp}`:
- canonical order: sort by full envelope hash (TxSetFrame.cpp:61)
- apply order: per-account sequence order, accounts interleaved by a
  hash-XOR shuffle so apply order isn't gameable (TxSetFrame.cpp:101-148)
- surge pricing: when over capacity, keep the highest fee-per-op txs
  (TxSetFrame.cpp:150-275)
- validity: per-tx checkValid + per-account seq chains + fee balance
  (checkOrTrim, TxSetFrame.cpp:277-359) — a batch-verify hot caller
- contents hash: SHA256(previousLedgerHash ‖ sorted envelopes)
  (TxSetFrame.cpp:418-434)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..ledger.ledgertxn import LedgerTxn
from ..transactions.transaction_frame import (
    FeeBumpTransactionFrame, TransactionFrame,
)
from ..xdr import TransactionEnvelope, TransactionSet

AnyFrame = object  # TransactionFrame | FeeBumpTransactionFrame


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


class TxSetFrame:
    def __init__(self, network_id: bytes, previous_ledger_hash: bytes,
                 frames: Optional[List[AnyFrame]] = None) -> None:
        self.network_id = network_id
        self.previous_ledger_hash = previous_ledger_hash
        self.frames: List[AnyFrame] = list(frames or [])
        self._hash: Optional[bytes] = None

    @classmethod
    def from_wire(cls, network_id: bytes,
                  xdr_set: TransactionSet) -> "TxSetFrame":
        frames = [TransactionFrame.make_from_wire(network_id, env)
                  for env in xdr_set.txs]
        return cls(network_id, xdr_set.previousLedgerHash, frames)

    def to_wire(self) -> TransactionSet:
        return TransactionSet(
            previousLedgerHash=self.previous_ledger_hash,
            txs=[f.envelope for f in self.sorted_for_hash()])

    # -- ordering -----------------------------------------------------------
    def sorted_for_hash(self) -> List[AnyFrame]:
        return sorted(self.frames, key=lambda f: f.full_hash())

    @staticmethod
    def _chains_by_seq_account(frames) -> Dict[bytes, List[AnyFrame]]:
        """Per-account chains keyed by the sequence-owning account, each
        chain in seqNum order — shared by apply ordering, surge pricing,
        and validation."""
        by_acc: Dict[bytes, List[AnyFrame]] = {}
        for f in frames:
            by_acc.setdefault(f.seq_account_id().key_bytes, []).append(f)
        for chain in by_acc.values():
            chain.sort(key=lambda f: f.seq_num)
        return by_acc

    def sort_for_apply(self) -> List[AnyFrame]:
        """Deterministic shuffled apply order: group per source account in
        seq order, then round-robin accounts ordered by
        (account_id XOR set_hash)."""
        by_acc = self._chains_by_seq_account(self.sorted_for_hash())
        h = self.get_contents_hash()
        order = sorted(by_acc, key=lambda acc: _xor(acc, h))
        out: List[AnyFrame] = []
        queues = {acc: list(chain) for acc, chain in by_acc.items()}
        while queues:
            for acc in list(order):
                chain = queues.get(acc)
                if not chain:
                    queues.pop(acc, None)
                    continue
                out.append(chain.pop(0))
        return out

    # -- size / fees --------------------------------------------------------
    def size_ops(self) -> int:
        return sum(f.num_operations() for f in self.frames)

    def size_txs(self) -> int:
        return len(self.frames)

    # largest op count one tx can carry (reference MAX_OPS_PER_TX)
    MAX_OPS_PER_TX = 100

    @staticmethod
    def _cap_units(f: AnyFrame, header) -> int:
        """Capacity unit: OPERATIONS from protocol 11, whole TRANSACTIONS
        before (reference TxSetFrame::size, TxSetFrame.cpp:449-453)."""
        return max(1, f.num_operations()) if header.ledgerVersion >= 11 \
            else 1

    def size_for_cap(self, header) -> int:
        return sum(self._cap_units(f, header) for f in self.frames)

    def base_fee(self, header) -> Optional[int]:
        """Per-set effective base fee (reference getBaseFee
        TxSetFrame.cpp:466-495): from protocol 11, when the set is within
        MAX_OPS_PER_TX of capacity, every tx pays the LOWEST
        ceil(feeBid/numOps) bid in the set; otherwise (and always pre-11)
        the protocol base fee applies (returned as None)."""
        if header.ledgerVersion < 11:
            return None
        ops = 0
        lowest = None
        for f in self.frames:
            n = max(1, f.num_operations())
            ops += n
            bid = -(-f.fee_bid // n)  # ROUND_UP
            if lowest is None or bid < lowest:
                lowest = bid
        cutoff = max(0, header.maxTxSetSize - self.MAX_OPS_PER_TX)
        if ops > cutoff and lowest is not None:
            return lowest
        return None

    def total_fees(self, header) -> int:
        """Σ feeCharged at this set's effective base fee from protocol 11;
        pre-11 the full fee bids (reference TxSetFrame::getTotalFees,
        used by combineCandidates' tiebreak)."""
        if header.ledgerVersion < 11:
            return sum(f.fee_bid for f in self.frames)
        bf = self.base_fee(header)
        return sum(f.fee_charged(header, bf) for f in self.frames)

    def _fee_rate_key(self, f: AnyFrame, header) -> Tuple:
        # higher fee per OPERATION first regardless of protocol (reference
        # SurgeCompare, TxSetFrame.cpp:150-186); tie-break by full hash
        return (f.fee_bid * 2**32 // max(1, f.num_operations()),
                f.full_hash())

    def surge_pricing_filter(self, header) -> None:
        """Trim to maxTxSetSize units keeping highest fee-per-unit, whole
        account chains at a time (reference surgePricingFilter)."""
        max_ops = header.maxTxSetSize
        if self.size_for_cap(header) <= max_ops:
            return
        by_acc = self._chains_by_seq_account(self.frames)
        # a chain's priority is its lowest fee-rate tx (can't include later
        # txs without earlier ones)
        included: List[AnyFrame] = []
        ops_used = 0
        chains = list(by_acc.values())
        # greedy: repeatedly take the head tx with best fee rate
        heads = [(c, 0) for c in chains]
        import heapq
        heap = []
        for ci, (c, idx) in enumerate(heads):
            f = c[0]
            heapq.heappush(
                heap, (tuple(-x if isinstance(x, int) else x
                             for x in self._fee_rate_key(f, header)[:1]) +
                       (f.full_hash(),), ci, 0))
        heads_idx = [0] * len(chains)
        while heap:
            _, ci, idx = heapq.heappop(heap)
            if idx != heads_idx[ci]:
                continue
            f = chains[ci][idx]
            if ops_used + self._cap_units(f, header) > max_ops:
                break
            included.append(f)
            ops_used += self._cap_units(f, header)
            heads_idx[ci] += 1
            if heads_idx[ci] < len(chains[ci]):
                nf = chains[ci][heads_idx[ci]]
                heapq.heappush(
                    heap,
                    (tuple(-x if isinstance(x, int) else x
                           for x in self._fee_rate_key(nf, header)[:1]) +
                     (nf.full_hash(),), ci, heads_idx[ci]))
        self.frames = included
        self._hash = None

    # -- validity -----------------------------------------------------------
    def check_or_trim(self, ltx_parent, verifier=None,
                      trim: bool = False) -> Tuple[bool, List[AnyFrame]]:
        """Validate every tx (seq chains per account, checkValid, whole-
        chain fee balance). trim=True removes invalid txs (and their
        dependents); returns (all_valid, trimmed)."""
        removed: List[AnyFrame] = []
        self._prewarm_signatures(ltx_parent, verifier)
        by_acc = self._chains_by_seq_account(self.frames)
        keep: List[AnyFrame] = []
        for acc, chain in sorted(by_acc.items()):
            ltx = LedgerTxn(ltx_parent)
            try:
                from ..xdr import LedgerKey, PublicKey
                acc_entry = ltx.load_without_record(
                    LedgerKey.account(PublicKey.ed25519(acc)))
                if acc_entry is None:
                    removed.extend(chain)
                    continue
                cur_seq = acc_entry.data.value.seqNum
                chain_ok: List[AnyFrame] = []
                bad = False
                for f in chain:
                    if bad or not f.check_valid(ltx, cur_seq, verifier):
                        removed.append(f)
                        bad = True  # later txs have broken seq chain
                        continue
                    cur_seq = f.seq_num
                    chain_ok.append(f)
                keep.extend(chain_ok)
            finally:
                ltx.rollback()
        # whole-set fee balance per FEE SOURCE (reference accountFeeMap
        # keyed by getFeeSourceID — for fee bumps the sponsor, which can
        # differ from the seq account; reference TxSetFrame.cpp:325-356)
        keep = self._check_fee_balances(ltx_parent, keep, removed)
        if trim:
            self.frames = keep
            self._hash = None
            return (not removed), removed
        return (not removed), removed

    def _check_fee_balances(self, ltx_parent, keep: List[AnyFrame],
                            removed: List[AnyFrame]) -> List[AnyFrame]:
        """Drop every tx whose fee source cannot cover the SUM of fees it
        sponsors across the set."""
        from ..transactions.account_helpers import (
            account_available_balance,
        )
        from ..xdr import LedgerKey, PublicKey
        ltx = LedgerTxn(ltx_parent)
        try:
            header = ltx.load_header()
            fees: Dict[bytes, int] = {}
            for f in keep:
                k = f.fee_account_id().key_bytes
                fees[k] = fees.get(k, 0) + f.fee_charged(header)
            bad_sources = set()
            for k, total in fees.items():
                entry = ltx.load_without_record(
                    LedgerKey.account(PublicKey.ed25519(k)))
                if entry is None or account_available_balance(
                        header, entry.data.value) < total:
                    bad_sources.add(k)
            if not bad_sources:
                return keep
            out = []
            broken_chains: Dict[bytes, int] = {}  # seq acc -> first bad seq
            for f in keep:
                if f.fee_account_id().key_bytes in bad_sources:
                    removed.append(f)
                    k = f.seq_account_id().key_bytes
                    broken_chains[k] = min(
                        broken_chains.get(k, f.seq_num), f.seq_num)
                else:
                    out.append(f)
            if broken_chains:
                # later-seq txs of a broken chain can no longer apply
                out2 = []
                for f in out:
                    k = f.seq_account_id().key_bytes
                    if k in broken_chains and                             f.seq_num > broken_chains[k]:
                        removed.append(f)
                    else:
                        out2.append(f)
                out = out2
            return out
        finally:
            ltx.rollback()

    def _prewarm_signatures(self, ltx_parent, verifier) -> None:
        """Two-phase validation (batch-verify hot caller #3): collect every
        hint-matching signature triple for the WHOLE set and verify them in
        one device dispatch; the per-tx walk below then completes entirely
        off the warm verify cache. Reference walks tx-by-tx
        (TxSetFrame.cpp:277-359); batching is the device's reshape."""
        if verifier is None or not getattr(verifier, "wants_prewarm", False):
            return
        if len(self.frames) <= 1:
            return
        from ..transactions.transaction_frame import frames_sig_triples
        ltx = LedgerTxn(ltx_parent)
        try:
            triples = frames_sig_triples(ltx, self.frames)
        finally:
            ltx.rollback()
        if triples:
            verifier.prewarm_many(triples)

    def trim_invalid(self, ltx_parent, verifier=None) -> List[AnyFrame]:
        _, removed = self.check_or_trim(ltx_parent, verifier, trim=True)
        return removed

    def check_valid(self, ltx_parent, verifier=None) -> bool:
        ok, _ = self.check_or_trim(ltx_parent, verifier, trim=False)
        return ok

    # -- hashing ------------------------------------------------------------
    def get_contents_hash(self, hasher=None) -> bytes:
        """SHA256(previousLedgerHash ‖ sorted envelopes), streamed as
        one whole-txset digest through the bounded-join stream path
        (crypto/batch_hasher.stream_digest) — identical bytes
        to the incremental-context path, one C-level update per ~1 MiB
        of envelopes instead of one Python call per tx. Callers with an
        app context (herder intake, the close's value check) pass the
        app's BatchHasher so the computation lands in the hash cockpit
        under the `txset` site; cache hits never re-attribute."""
        if self._hash is None:
            from itertools import chain
            chunks = chain(
                (self.previous_ledger_hash,),
                (f.envelope_bytes() for f in self.sorted_for_hash()))
            if hasher is not None:
                self._hash = hasher.hash_stream(chunks, site="txset")
            else:
                from ..crypto.batch_hasher import stream_digest
                self._hash = stream_digest(chunks)
        return self._hash
