"""LoadManager: per-peer cost accounting and load shedding.

Copied from `stellar_core_tpu/overlay/load_manager.py` at commit d7c5801;
carry a fix in either copy to the other. Nothing is left out.

Role parity: reference `src/overlay/LoadManager.{h,cpp}` — each peer
accumulates a cost vector (main-thread time, bytes sent/received); when
the node is overloaded the costliest peer is dropped ("the least
deserving"). Accounting contexts wrap message processing.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ..util.log import get_logger

log = get_logger("Overlay")


class PeerCosts:
    __slots__ = ("time_spent", "bytes_send", "bytes_recv", "msgs_send",
                 "msgs_recv")

    def __init__(self) -> None:
        self.time_spent = 0.0
        self.bytes_send = 0
        self.bytes_recv = 0
        self.msgs_send = 0
        self.msgs_recv = 0

    def to_json(self) -> dict:
        return {"time": round(self.time_spent, 6),
                "bytes_send": self.bytes_send,
                "bytes_recv": self.bytes_recv,
                "msgs_send": self.msgs_send,
                "msgs_recv": self.msgs_recv}


class LoadManager:
    def __init__(self, app) -> None:
        self.app = app
        self._costs: Dict[bytes, PeerCosts] = {}
        self.peers_shed = 0

    def peer_costs(self, peer_key: bytes) -> PeerCosts:
        c = self._costs.get(peer_key)
        if c is None:
            c = PeerCosts()
            self._costs[peer_key] = c
        return c

    def forget(self, peer_key: bytes) -> None:
        self._costs.pop(peer_key, None)

    # -- accounting context (reference LoadManager::PeerContext) -------------
    class PeerContext:
        def __init__(self, lm: "LoadManager", peer_key: bytes) -> None:
            self._lm = lm
            self._key = peer_key
            self._t0 = 0.0

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            c = self._lm.peer_costs(self._key)
            c.time_spent += time.perf_counter() - self._t0
            c.msgs_recv += 1
            return False

    def context(self, peer_key: bytes) -> "LoadManager.PeerContext":
        return LoadManager.PeerContext(self, peer_key)

    def record_bytes(self, peer_key: bytes, sent: int, received: int
                     ) -> None:
        c = self.peer_costs(peer_key)
        c.bytes_send += sent
        c.bytes_recv += received

    def record_sent(self, peer_key: bytes, nbytes: int) -> None:
        """One outbound message to `peer_key` (Peer.send_message) — the
        send-path twin of the receive accounting, so the cost vector and
        `_worst_peer_key` see both directions."""
        c = self.peer_costs(peer_key)
        c.bytes_send += nbytes
        c.msgs_send += 1

    def totals(self) -> dict:
        """Both-direction byte/message totals across every tracked peer
        (SurveyManager.get_stats + the fleet aggregate surface these)."""
        out = {"bytes_send": 0, "bytes_recv": 0,
               "msgs_send": 0, "msgs_recv": 0}
        for c in self._costs.values():
            out["bytes_send"] += c.bytes_send
            out["bytes_recv"] += c.bytes_recv
            out["msgs_send"] += c.msgs_send
            out["msgs_recv"] += c.msgs_recv
        return out

    # -- shedding ------------------------------------------------------------
    def _worst_peer_key(self) -> Optional[bytes]:
        worst, worst_cost = None, -1.0
        for key, c in self._costs.items():
            cost = c.time_spent + (c.bytes_recv + c.bytes_send) * 1e-9
            if cost > worst_cost:
                worst, worst_cost = key, cost
        return worst

    def maybe_shed_excess_load(self, overlay) -> bool:
        """Drop the costliest authenticated peer when over capacity
        (reference maybeShedExcessLoad, gated on TARGET+extra)."""
        cfg = self.app.config
        limit = cfg.TARGET_PEER_CONNECTIONS + max(
            0, cfg.MAX_ADDITIONAL_PEER_CONNECTIONS)
        if overlay.get_authenticated_peers_count() <= limit:
            return False
        key = self._worst_peer_key()
        if key is None:
            return False
        p = overlay.get_peer(key)
        if p is None:
            self.forget(key)
            return False
        log.info("shedding excess load: dropping %s",
                 key.hex()[:8] if isinstance(key, bytes) else key)
        self.peers_shed += 1
        p.drop("load shed")
        return True

    def get_json_info(self) -> dict:
        return {k.hex()[:16] if isinstance(k, bytes) else str(k):
                c.to_json() for k, c in self._costs.items()}
