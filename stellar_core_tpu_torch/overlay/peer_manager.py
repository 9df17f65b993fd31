"""PeerManager / BanManager: persistent peer book and node bans.

Copied from `stellar_core_tpu/overlay/peer_manager.py` at commit 378eae4;
carry a fix in either copy to the other. Nothing is left out. The peer and
ban tables live in the port's `app.database`.

Role parity: reference `src/overlay/PeerManager.{h,cpp}` (peers table with
numFailures/nextAttempt backoff and preferred/outbound/inbound types,
PeerManager::getPeersToSend), `RandomPeerSource`, and
`src/overlay/BanManagerImpl.cpp` (bans keyed by node id, stored in DB).
"""

from __future__ import annotations

import socket as _socket
from typing import Dict, List, Optional, Tuple

from ..util import rnd
from ..util.log import get_logger
from ..xdr import IPAddr, PeerAddress, PublicKey

log = get_logger("Overlay")

MAX_FAILURES = 10
# decorrelated-jitter reconnect backoff (docs/robustness.md): delay_k is
# uniform in [BASE, 3 * delay_{k-1}] capped — reconnect attempts from many
# nodes that lost the same peer spread out instead of storming it in sync
RECONNECT_BACKOFF_BASE = 2.0
RECONNECT_BACKOFF_CAP = 120.0


def parse_peer_address(s: str, default_port: int = 11625
                       ) -> Tuple[str, int]:
    """"host[:port]" → (host, port)."""
    if ":" in s:
        host, port = s.rsplit(":", 1)
        return host, int(port)
    return s, default_port


def to_xdr_address(host: str, port: int, num_failures: int = 0
                   ) -> PeerAddress:
    try:
        raw = _socket.inet_aton(host)
    except OSError:
        raw = b"\x7f\x00\x00\x01"
    return PeerAddress(ip=IPAddr(IPAddr.IPv4, raw), port=port,
                       numFailures=num_failures)


def from_xdr_address(pa: PeerAddress) -> Tuple[str, int]:
    if pa.ip.disc == IPAddr.IPv4:
        return _socket.inet_ntoa(pa.ip.value), pa.port
    return ("::", pa.port)


class PeerRecord:
    __slots__ = ("host", "port", "num_failures", "next_attempt",
                 "preferred", "outbound", "last_backoff")

    def __init__(self, host: str, port: int) -> None:
        self.host = host
        self.port = port
        self.num_failures = 0
        self.next_attempt = 0.0
        self.preferred = False
        self.outbound = False
        self.last_backoff = 0.0


class PeerManager:
    def __init__(self, app) -> None:
        self.app = app
        self._peers: Dict[Tuple[str, int], PeerRecord] = {}
        cfg = app.config
        for s in cfg.KNOWN_PEERS:
            self.ensure_exists(*parse_peer_address(s, cfg.PEER_PORT))
        for s in cfg.PREFERRED_PEERS:
            rec = self.ensure_exists(*parse_peer_address(s, cfg.PEER_PORT))
            rec.preferred = True
        self._load_db()

    # -- persistence ---------------------------------------------------------
    def _db(self):
        return getattr(self.app, "database", None)

    def _load_db(self) -> None:
        db = self._db()
        if db is None:
            return
        try:
            rows = db.execute(
                "SELECT ip, port, numfailures FROM peers").fetchall()
        except Exception:
            return
        for host, port, nf in rows:
            rec = self.ensure_exists(host, port)
            rec.num_failures = nf

    def store(self) -> None:
        db = self._db()
        if db is None:
            return
        for rec in self._peers.values():
            db.execute(
                "INSERT OR REPLACE INTO peers (ip, port, numfailures) "
                "VALUES (?,?,?)", (rec.host, rec.port, rec.num_failures))
        db.commit()

    # -- book ----------------------------------------------------------------
    def ensure_exists(self, host: str, port: int) -> PeerRecord:
        key = (host, port)
        rec = self._peers.get(key)
        if rec is None:
            rec = PeerRecord(host, port)
            self._peers[key] = rec
        return rec

    def on_connect_failure(self, host: str, port: int) -> None:
        rec = self.ensure_exists(host, port)
        rec.num_failures += 1
        # exponential backoff with decorrelated jitter: the growth comes
        # from tripling the PREVIOUS delay, the desynchronization from the
        # uniform draw (deterministic under the seeded global RNG)
        prev = rec.last_backoff or RECONNECT_BACKOFF_BASE
        delay = min(RECONNECT_BACKOFF_CAP,
                    rnd.g_random.uniform(RECONNECT_BACKOFF_BASE,
                                         prev * 3.0))
        rec.last_backoff = delay
        rec.next_attempt = self.app.clock.now() + delay
        m = getattr(self.app, "metrics", None)
        if m is not None:
            m.new_meter("overlay.connection.failure").mark()

    def on_connect_success(self, host: str, port: int) -> None:
        rec = self.ensure_exists(host, port)
        rec.num_failures = 0
        rec.next_attempt = 0.0
        rec.last_backoff = 0.0
        rec.outbound = True

    def candidates_to_connect(self, n: int,
                              exclude: List[Tuple[str, int]]
                              ) -> List[PeerRecord]:
        now = self.app.clock.now()
        ex = set(exclude)
        cands = [r for r in self._peers.values()
                 if (r.host, r.port) not in ex and r.next_attempt <= now
                 and r.num_failures < MAX_FAILURES]
        # preferred first, then fewest failures, randomized within class
        rnd.g_random.shuffle(cands)
        cands.sort(key=lambda r: (not r.preferred, r.num_failures))
        return cands[:n]

    def recv_peers(self, addrs) -> None:
        for pa in addrs:
            host, port = from_xdr_address(pa)
            if port > 0:
                self.ensure_exists(host, port)

    def peers_to_send(self, n: int) -> List[PeerAddress]:
        recs = [r for r in self._peers.values()
                if r.num_failures < MAX_FAILURES]
        rnd.g_random.shuffle(recs)
        return [to_xdr_address(r.host, r.port, r.num_failures)
                for r in recs[:n]]

    def size(self) -> int:
        return len(self._peers)


class BanManager:
    """Reference src/overlay/BanManagerImpl.cpp."""

    def __init__(self, app) -> None:
        self.app = app
        self._banned: set = set()
        db = getattr(app, "database", None)
        if db is not None:
            try:
                for (nodeid,) in db.execute(
                        "SELECT nodeid FROM bans").fetchall():
                    self._banned.add(nodeid)
            except Exception:
                pass

    def ban_node(self, node_id: PublicKey) -> None:
        key = node_id.to_xdr().hex()
        if key in self._banned:
            return
        self._banned.add(key)
        db = getattr(self.app, "database", None)
        if db is not None:
            db.execute("INSERT OR REPLACE INTO bans (nodeid) VALUES (?)",
                       (key,))
            db.commit()

    def unban_node(self, node_id: PublicKey) -> None:
        key = node_id.to_xdr().hex()
        self._banned.discard(key)
        db = getattr(self.app, "database", None)
        if db is not None:
            db.execute("DELETE FROM bans WHERE nodeid = ?", (key,))
            db.commit()

    def unban_all(self) -> int:
        """Lift every ban (admin `bans?action=unban_all`); returns how
        many were lifted."""
        n = len(self._banned)
        self._banned.clear()
        db = getattr(self.app, "database", None)
        if db is not None:
            db.execute("DELETE FROM bans")
            db.commit()
        return n

    def is_banned(self, node_id: PublicKey) -> bool:
        return node_id.to_xdr().hex() in self._banned

    def banned(self) -> List[str]:
        return sorted(self._banned)
