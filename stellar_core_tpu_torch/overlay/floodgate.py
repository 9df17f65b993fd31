"""Floodgate: de-duplicated gossip flooding.

Copied from `stellar_core_tpu/overlay/floodgate.py` at commit 93d3a3a;
carry a fix in either copy to the other. Nothing is left out.

Role parity: reference `src/overlay/Floodgate.{h,cpp}:38-107` — a record
per flooded message (SHA256 of its XDR) tracking which peers already have
it; broadcast sends to every authenticated peer not in the set; records are
garbage-collected by the ledger seq they were added at.
"""

from __future__ import annotations

from typing import Dict, Set

from ..crypto.hashing import sha256
from ..util.log import get_logger
from ..xdr import StellarMessage

log = get_logger("Overlay")


class _FloodRecord:
    __slots__ = ("ledger_seq", "message", "peers_told", "dupes")

    def __init__(self, ledger_seq: int, message: StellarMessage) -> None:
        self.ledger_seq = ledger_seq
        self.message = message
        self.peers_told: Set[str] = set()
        self.dupes = 0        # duplicate receipts (flood-layer waste)


class Floodgate:
    def __init__(self) -> None:
        self._map: Dict[bytes, _FloodRecord] = {}
        self._shutting_down = False
        # wire cockpit: dedup accounting — unique vs
        # duplicate receipts feed the flood duplication ratio, broadcast
        # fanout feeds its histogram (installed by OverlayManager)
        self.stats = None
        # propagation cockpit: causal hop records — recv
        # hops stamped per add_record receipt (first vs redundant edge,
        # in lockstep with record_flood so the two cockpits reconcile),
        # send hops per broadcast fanout, origin markers when this node
        # is the broadcaster (installed by OverlayManager; None = off)
        self.prop = None

    @staticmethod
    def msg_id(msg: StellarMessage) -> bytes:
        return sha256(msg.to_xdr())

    def add_record(self, msg: StellarMessage, from_peer_id: str,
                   ledger_seq: int, from_hex: str = "") -> bool:
        """Note an incoming flooded message; returns False if seen before
        (reference Floodgate::addRecord). `from_hex` (sender node-id
        hex) attributes the receipt as a propagation hop."""
        if self._shutting_down:
            return False
        raw = msg.to_xdr()
        h = sha256(raw)
        rec = self._map.get(h)
        unique = rec is None
        if unique:
            rec = _FloodRecord(ledger_seq, msg)
            self._map[h] = rec
        else:
            rec.dupes += 1
        rec.peers_told.add(from_peer_id)
        if self.stats is not None:
            self.stats.record_flood(unique=unique)
        if self.prop is not None and from_hex:
            self.prop.record_recv_hop(h, from_hex, len(raw), msg.disc,
                                      unique, ledger_seq)
        return unique

    def broadcast(self, msg: StellarMessage, force: bool, peers: Dict,
                  ledger_seq: int) -> int:
        """Send to every authenticated peer not already told; returns the
        number sent (reference Floodgate::broadcast, Floodgate.cpp:81-107)."""
        if self._shutting_down:
            return 0
        raw = msg.to_xdr()
        h = sha256(raw)
        rec = self._map.get(h)
        if rec is None:
            # no receipt preceded this broadcast: this node originated
            # the message — the relay tree's root
            rec = _FloodRecord(ledger_seq, msg)
            self._map[h] = rec
            if self.prop is not None:
                self.prop.record_origin(h, len(raw), msg.disc, ledger_seq)
        n = 0
        for pid, peer in list(peers.items()):
            if pid in rec.peers_told:
                continue
            peer.send_message(msg)
            rec.peers_told.add(pid)
            n += 1
            if self.prop is not None and peer.peer_id is not None:
                self.prop.record_send_hop(
                    h, peer.peer_id.key_bytes.hex(), len(raw), msg.disc,
                    ledger_seq)
        if self.stats is not None:
            self.stats.record_broadcast(n)
        return n

    def forget_record(self, msg: StellarMessage) -> None:
        self._map.pop(self.msg_id(msg), None)

    def clear_below(self, ledger_seq: int, keep: int = 2) -> None:
        """GC records older than `keep` ledgers (reference
        Floodgate::clearBelow)."""
        cutoff = ledger_seq - keep
        for h in [h for h, r in self._map.items() if r.ledger_seq < cutoff]:
            del self._map[h]

    def shutdown(self) -> None:
        self._shutting_down = True
        self._map.clear()

    def size(self) -> int:
        return len(self._map)
