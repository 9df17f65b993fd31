"""PendingEnvelopes: buffer SCP envelopes until dependencies arrive.

Copied from `stellar_core_tpu/herder/pending_envelopes.py` at commit
a09415e; carry a fix in either copy to the other. Nothing is left out.
Its fetchers are injected (`set_fetchers`): the port's
`overlay/OverlayManager` wires its two `ItemFetcher`s in, and a caller
without overlay may satisfy missing txsets and quorum sets itself, as the
reference's loopback simulation does.

Role parity: reference `src/herder/PendingEnvelopes.{h,cpp}:26-153` —
per-slot state sets (discarded/fetching/ready/processed), LRU caches of
txsets and quorum sets, two ItemFetchers (txset, qset), QuorumTracker
feeding.  The fetch transport is injected (overlay ItemFetcher in a full
node; direct delivery in simulation).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from ..crypto.hashing import sha256
from ..util.cache import RandomEvictionCache
from ..util.log import get_logger
from ..xdr import SCPEnvelope, SCPQuorumSet, SCPStatementType

log = get_logger("Herder")


def statement_txset_hashes(st) -> List[bytes]:
    """TxSet hashes referenced by a statement's StellarValue payloads."""
    from ..xdr import StellarValue
    values = []
    t = st.pledges.disc
    p = st.pledges.value
    if t == SCPStatementType.SCP_ST_NOMINATE:
        values = list(p.votes) + list(p.accepted)
    elif t == SCPStatementType.SCP_ST_PREPARE:
        if p.ballot.counter:
            values.append(p.ballot.value)
        if p.prepared is not None:
            values.append(p.prepared.value)
        if p.preparedPrime is not None:
            values.append(p.preparedPrime.value)
    elif t == SCPStatementType.SCP_ST_CONFIRM:
        values.append(p.ballot.value)
    else:
        values.append(p.commit.value)
    out = []
    for v in values:
        try:
            sv = StellarValue.from_xdr(v)
            out.append(sv.txSetHash)
        except Exception as e:
            # a peer can pledge arbitrary bytes; an unparseable value
            # simply names no txset to fetch — but say so (E1: no silent
            # swallows in consensus code)
            log.debug("ignoring unparseable StellarValue in statement: %s", e)
    return out


def statement_qset_hash(st) -> bytes:
    t = st.pledges.disc
    if t == SCPStatementType.SCP_ST_EXTERNALIZE:
        return st.pledges.value.commitQuorumSetHash
    return st.pledges.value.quorumSetHash


class PendingEnvelopes:
    QSET_CACHE_SIZE = 10000
    TXSET_CACHE_SIZE = 10000

    def __init__(self, herder,
                 fetch_txset: Optional[Callable[[bytes], None]] = None,
                 fetch_qset: Optional[Callable[[bytes], None]] = None
                 ) -> None:
        self.herder = herder
        self.fetch_txset_fn = fetch_txset
        self.fetch_qset_fn = fetch_qset
        self.txsets: Dict[bytes, object] = {}
        self.qsets: Dict[bytes, SCPQuorumSet] = {}
        # slot -> list of envelopes waiting on deps
        self.fetching: Dict[int, List[SCPEnvelope]] = {}
        self.processed: Dict[int, Set[bytes]] = {}
        self.discarded: Dict[int, Set[bytes]] = {}
        # slot -> envelope hashes whose signature verify is in flight on
        # the batch backend (async analog of "fetching": buffered until
        # the device batch completes on the main loop)
        self.verifying: Dict[int, Set[bytes]] = {}

    def set_fetchers(self, fetch_txset, fetch_qset) -> None:
        self.fetch_txset_fn = fetch_txset
        self.fetch_qset_fn = fetch_qset

    # -- caches -------------------------------------------------------------
    def add_tx_set(self, h: bytes, txset) -> None:
        self.txsets[h] = txset
        self._retry_fetching()

    def add_quorum_set(self, h: bytes, qset: SCPQuorumSet) -> None:
        self.qsets[h] = qset
        self._retry_fetching()

    def get_tx_set(self, h: bytes):
        return self.txsets.get(h)

    def get_quorum_set(self, h: bytes) -> Optional[SCPQuorumSet]:
        return self.qsets.get(h)

    # -- intake -------------------------------------------------------------
    def _missing_deps(self, env: SCPEnvelope) -> List[tuple]:
        missing = []
        st = env.statement
        qh = statement_qset_hash(st)
        if qh not in self.qsets:
            missing.append(("qset", qh))
        for th in statement_txset_hashes(st):
            if th not in self.txsets:
                missing.append(("txset", th))
        return missing

    def begin_verify(self, env: SCPEnvelope,
                     eh: Optional[bytes] = None) -> bool:
        """Enter the 'verifying' state. False when the envelope is already
        known (processed / discarded / verify in flight) — callers skip
        re-verification and re-flooding."""
        slot = env.statement.slotIndex
        eh = eh or sha256(env.to_xdr())
        if eh in self.processed.get(slot, set()) or \
                eh in self.discarded.get(slot, set()) or \
                eh in self.verifying.get(slot, set()):
            return False
        self.verifying.setdefault(slot, set()).add(eh)
        return True

    def finish_verify(self, env: SCPEnvelope, ok: bool,
                      eh: Optional[bytes] = None) -> bool:
        """Resolve a verify: promote to the normal intake path or discard."""
        slot = env.statement.slotIndex
        eh = eh or sha256(env.to_xdr())
        vs = self.verifying.get(slot)
        if vs is not None:
            vs.discard(eh)
            if not vs:
                del self.verifying[slot]
        if not ok:
            self.discarded.setdefault(slot, set()).add(eh)
            return False
        return self.recv_scp_envelope(env, eh)

    def recv_scp_envelope(self, env: SCPEnvelope,
                          eh: Optional[bytes] = None) -> bool:
        """Returns True if the envelope became ready (delivered to SCP
        queue); False if buffered/discarded."""
        slot = env.statement.slotIndex
        eh = eh or sha256(env.to_xdr())
        if eh in self.processed.get(slot, set()) or \
                eh in self.discarded.get(slot, set()):
            return False
        missing = self._missing_deps(env)
        if missing:
            self.fetching.setdefault(slot, []).append(env)
            for kind, h in missing:
                # the envelope rides along so trackers know which slots
                # still depend on the item (ItemFetcher GC keys off it)
                if kind == "qset" and self.fetch_qset_fn:
                    self.fetch_qset_fn(h, env)
                elif kind == "txset" and self.fetch_txset_fn:
                    self.fetch_txset_fn(h, env)
            return False
        self.processed.setdefault(slot, set()).add(eh)
        self.herder.envelope_ready(env)
        return True

    def _retry_fetching(self) -> None:
        for slot in sorted(self.fetching):
            still: List[SCPEnvelope] = []
            for env in self.fetching[slot]:
                if self._missing_deps(env):
                    still.append(env)
                else:
                    eh = sha256(env.to_xdr())
                    self.processed.setdefault(slot, set()).add(eh)
                    self.herder.envelope_ready(env)
            if still:
                self.fetching[slot] = still
            else:
                del self.fetching[slot]

    def discard_envelope(self, env: SCPEnvelope) -> None:
        slot = env.statement.slotIndex
        self.discarded.setdefault(slot, set()).add(sha256(env.to_xdr()))

    # -- GC -----------------------------------------------------------------
    def erase_below(self, slot: int) -> None:
        for d in (self.fetching, self.processed, self.discarded,
                  self.verifying):
            for s in [s for s in d if s < slot]:
                del d[s]
