"""FloodControl: per-peer token-bucket rate limiting on flooded messages.

Copied from `stellar_core_tpu/overlay/flood_control.py` at commit 02f8fbd;
carry a fix in either copy to the other. Nothing is left out.

Role parity: the reference's overlay survives envelope floods mostly by
luck (Floodgate dedup + LoadManager shedding); the committee-consensus
study (PAPERS.md, arXiv:2302.00418) shows envelope-flood cost is THE
scaling wall at large quorums, and DSig (2406.07215) only holds its
throughput claims under sustained adversarial load. This module makes
flood defense a first-class operating mode:

- every flooded message (TRANSACTION / SCP_MESSAGE) consumes one token
  from the sending peer's bucket; the bucket refills at
  `FLOOD_RATE_LIMIT_PER_PEER` msgs/s (app clock — virtual in tests) up
  to `FLOOD_RATE_BURST`;
- a message arriving on an empty bucket is dropped before any
  processing or relay (`overlay.flood.rate-limited` meter) and adds one
  point to the peer's ban score;
- a ban score reaching `FLOOD_BAN_SCORE_THRESHOLD` escalates into the
  existing `BanManager` (`overlay.flood.ban` meter): the node id is
  banned persistently and the connection dropped;
- ban scores halve on every ledger close, so a briefly-bursty honest
  peer decays back to zero instead of ratcheting toward a ban.

The `overlay.flood-limit` fault site forces the limited path for one
message — the deterministic way to exercise accounting and escalation
without an actual flood (docs/robustness.md#fault-points).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..util.faults import check_faults
from ..util.log import get_logger

log = get_logger("Overlay")


class _PeerFloodState:
    __slots__ = ("tokens", "last_refill", "ban_score", "limited", "banned")

    def __init__(self, tokens: float, now: float) -> None:
        self.tokens = tokens
        self.last_refill = now
        self.ban_score = 0.0
        self.limited = 0
        self.banned = False


class FloodControl:
    def __init__(self, app) -> None:
        self.app = app
        cfg = app.config
        self.rate = float(cfg.FLOOD_RATE_LIMIT_PER_PEER)   # <= 0 disables
        self.burst = float(cfg.FLOOD_RATE_BURST)
        self.ban_threshold = int(cfg.FLOOD_BAN_SCORE_THRESHOLD)
        self.faults = getattr(app, "faults", None)
        self._peers: Dict[bytes, _PeerFloodState] = {}

    def _metrics(self):
        return getattr(self.app, "metrics", None)

    def _state(self, key: bytes, now: float) -> _PeerFloodState:
        st = self._peers.get(key)
        if st is None:
            st = self._peers[key] = _PeerFloodState(self.burst, now)
        return st

    def _refill(self, st: _PeerFloodState, now: float) -> None:
        if self.rate > 0:
            st.tokens = min(self.burst,
                            st.tokens + (now - st.last_refill) * self.rate)
        st.last_refill = now

    def limited(self, peer) -> bool:
        """Consume one token for a flooded message from `peer`; True when
        the message must be dropped (bucket empty or fault-forced). Ban
        escalation happens here: the caller only sees the drop."""
        forced = check_faults(self, "overlay.flood-limit")
        if self.rate <= 0 and not forced:
            return False
        if peer.peer_id is None:
            return False
        key = peer.peer_id.to_xdr()
        now = self.app.clock.now()
        st = self._state(key, now)
        self._refill(st, now)
        if st.tokens >= 1.0 and not forced:
            st.tokens -= 1.0
            return False
        st.limited += 1
        st.ban_score += 1.0
        m = self._metrics()
        if m is not None:
            m.new_meter("overlay.flood.rate-limited").mark()
        self._maybe_ban(st, peer)
        return True

    def note_backpressure(self, peer) -> None:
        """A relayed tx the ingress tier threw back (TRY_AGAIN_LATER): the peer is pushing load past our admission
        capacity. Scores a fraction of a ban point, so a peer that
        relays nothing but sheddable load escalates exactly like a
        flooder — while an occasional backpressured relay decays away
        at the per-close halving."""
        if peer.peer_id is None:
            return
        now = self.app.clock.now()
        st = self._state(peer.peer_id.to_xdr(), now)
        st.ban_score += 0.25
        m = self._metrics()
        if m is not None:
            m.new_meter("overlay.flood.backpressure").mark()
        self._maybe_ban(st, peer)

    def _maybe_ban(self, st: _PeerFloodState, peer) -> None:
        if st.banned or self.ban_threshold <= 0 or \
                st.ban_score < self.ban_threshold:
            return
        st.banned = True
        m = self._metrics()
        if m is not None:
            m.new_meter("overlay.flood.ban").mark()
        log.warning("peer %s exceeded flood ban score (%d limited "
                    "messages): banning", peer.id_str(), st.limited)
        overlay = getattr(self.app, "overlay_manager", None)
        if overlay is not None:
            overlay.ban_manager.ban_node(peer.peer_id)
        peer.drop("flooding (rate limit exceeded)")

    def ledger_closed(self) -> None:
        """Decay: ban scores halve per close, idle states are reaped."""
        for key in list(self._peers):
            st = self._peers[key]
            st.ban_score /= 2.0
            if st.ban_score < 0.5:
                st.ban_score = 0.0
                if st.limited == 0 and st.tokens >= self.burst:
                    del self._peers[key]

    def forget(self, key: bytes) -> None:
        self._peers.pop(key, None)

    def score(self, peer_key: bytes) -> float:
        st = self._peers.get(peer_key)
        return st.ban_score if st is not None else 0.0

    def to_json(self) -> dict:
        return {
            "rate_per_s": self.rate,
            "burst": self.burst,
            "ban_threshold": self.ban_threshold,
            "peers": {
                key.hex()[:16]: {
                    "tokens": round(st.tokens, 2),
                    "ban_score": round(st.ban_score, 2),
                    "limited": st.limited,
                    "banned": st.banned,
                }
                for key, st in self._peers.items()
            },
        }
