"""OverlayManager: the p2p mesh controller.

Copied from `stellar_core_tpu/overlay/overlay_manager.py` at commit
02f8fbd; carry a fix in either copy to the other. Nothing is left out.
`main/application.py` builds it after the node's herder and starts it
unless RUN_STANDALONE.

Role parity: reference `src/overlay/OverlayManagerImpl.{h,cpp}` — owns the
listening door, the pending/authenticated peer sets, the periodic tick that
tops connections up to TARGET_PEER_CONNECTIONS (OverlayManagerImpl.cpp:497),
the Floodgate (broadcastMessage :891, recvFloodedMsg :878), the two
ItemFetchers wired into the Herder's PendingEnvelopes, PeerManager and
BanManager. Transport-agnostic: real TCP via TCPReactor/TCPDoor, or
loopback pipes inside a Simulation.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..util import rnd
from ..util.log import get_logger
from ..util.timer import VirtualTimer
from ..xdr import DontHave, MessageType, StellarMessage
from .floodgate import Floodgate
from .item_fetcher import ItemFetcher
from .peer import Peer, PeerState
from .peer_auth import PeerAuth, PeerRole
from .peer_manager import BanManager, PeerManager
from .transport import LoopbackTransport, TCPDoor, TCPReactor, TCPTransport

log = get_logger("Overlay")

TICK_SECONDS = 2.0


class OverlayManager:
    def __init__(self, app) -> None:
        self.app = app
        self.peer_auth = PeerAuth(app)
        self.peer_manager = PeerManager(app)
        self.ban_manager = BanManager(app)
        # wire cockpit: ONE aggregation shared by Peer frame
        # accounting, Floodgate dedup, the Herder's envelope pipeline
        # and the tick's queue-depth gauge — constructed before any peer
        # so the first frame is already attributed
        # (docs/observability.md#overlay-cockpit)
        from .overlay_stats import OverlayStats
        self.stats = OverlayStats(
            metrics=getattr(app, "metrics", None),
            tracer=getattr(app, "tracer", None),
            now_fn=app.clock.now)
        # propagation cockpit: causal hop records + per-peer
        # usefulness, fed by the Floodgate (recv/send hops, origins) and
        # the Peer MAC-layer duplicate branch; None when the operator
        # runs the propagation-disabled control leg
        # (docs/observability.md#propagation-cockpit)
        self.prop_stats = None
        if getattr(app.config, "PROPAGATION_STATS_ENABLED", True):
            from .propagation_stats import PropagationStats
            self.prop_stats = PropagationStats(
                metrics=getattr(app, "metrics", None),
                tracer=getattr(app, "tracer", None),
                now_fn=app.clock.now,
                self_id=app.config.node_id().key_bytes.hex())
        self.floodgate = Floodgate()
        self.floodgate.stats = self.stats
        self.floodgate.prop = self.prop_stats
        from .flood_control import FloodControl
        self.flood_control = FloodControl(app)
        # hash-keyed peer registry: id_key (nodeid xdr) -> Peer
        self.pending_peers: List[Peer] = []
        self.authenticated_peers: Dict[bytes, Peer] = {}
        self.tx_set_fetcher = ItemFetcher(
            self, lambda h: StellarMessage(MessageType.GET_TX_SET, h))
        self.qset_fetcher = ItemFetcher(
            self, lambda h: StellarMessage(MessageType.GET_SCP_QUORUMSET, h))
        from .survey_manager import SurveyManager
        self.survey_manager = SurveyManager(app, self)
        from .load_manager import LoadManager
        self.load_manager = LoadManager(app)
        self._reactor: Optional[TCPReactor] = None
        self._door: Optional[TCPDoor] = None
        self._tick_timer = VirtualTimer(app.clock)
        self._shutting_down = False
        self._wire_herder_fetchers()

    # -- herder wiring -------------------------------------------------------
    def _wire_herder_fetchers(self) -> None:
        # PendingEnvelopes buffers envelopes and re-feeds them itself when
        # items arrive; the fetchers only drive the ask-a-peer loop.
        herder = getattr(self.app, "herder", None)
        if herder is not None and hasattr(herder, "pending"):
            herder.pending.set_fetchers(self.tx_set_fetcher.fetch,
                                        self.qset_fetcher.fetch)

    def item_fetched_txset(self, item_hash: bytes) -> None:
        self.tx_set_fetcher.recv(item_hash, lambda env: None)

    def item_fetched_qset(self, item_hash: bytes) -> None:
        self.qset_fetcher.recv(item_hash, lambda env: None)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        cfg = self.app.config
        if not cfg.RUN_STANDALONE:
            self._reactor = TCPReactor(self.app.clock)
            self._reactor.start()
            self._door = TCPDoor(self._reactor, cfg.PEER_PORT,
                                 self._on_inbound_connection)
            if self._door.port != cfg.PEER_PORT:
                cfg.PEER_PORT = self._door.port
        self._arm_tick()

    def shutdown(self) -> None:
        self._shutting_down = True
        self._tick_timer.cancel()
        self.floodgate.shutdown()
        for p in list(self.authenticated_peers.values()) + \
                list(self.pending_peers):
            p.transport.close()
        self.authenticated_peers.clear()
        self.pending_peers.clear()
        if self._door is not None:
            self._door.close()
        if self._reactor is not None:
            self._reactor.stop()
        self.peer_manager.store()

    # -- tick ----------------------------------------------------------------
    def _arm_tick(self) -> None:
        if self._shutting_down:
            return
        self._tick_timer.expires_from_now(TICK_SECONDS)
        self._tick_timer.async_wait(self.tick)

    def tick(self) -> None:
        """Maintain target connections, drop stragglers
        (reference OverlayManagerImpl::tick, :497)."""
        if self._shutting_down:
            return
        cfg = self.app.config
        now = self.app.clock.now()
        # drop peers that never authenticated in time
        for p in list(self.pending_peers):
            if now - p.connected_at > cfg.PEER_AUTHENTICATION_TIMEOUT:
                p.drop("auth timeout")
        for p in list(self.authenticated_peers.values()):
            # keepalive ping at half-timeout so a quiet-but-healthy link
            # refreshes both sides' read clocks; drop only when BOTH
            # directions have been silent past the timeout (reference
            # Peer idle-timer semantics)
            if now - p.last_write > cfg.PEER_TIMEOUT / 2:
                p.send_message(StellarMessage(MessageType.GET_PEERS, None))
            if now - p.last_read > cfg.PEER_TIMEOUT and \
                    now - p.last_write > cfg.PEER_TIMEOUT:
                p.drop("idle timeout")
            elif now - p.last_read > cfg.PEER_STRAGGLER_TIMEOUT:
                # our pings keep last_write fresh; a peer that answers
                # nothing for the straggler window is dead or stuck
                p.drop("straggling (no reads)")
            elif p.transport.oldest_unsent_age() > \
                    cfg.PEER_STRAGGLER_TIMEOUT:
                # a peer that won't drain our writes can't keep up
                # (reference Peer::idleTimerExpired straggler branch)
                p.drop("straggling (cannot keep up)")
        missing = cfg.TARGET_PEER_CONNECTIONS - self.num_connections()
        if missing > 0 and self._reactor is not None:
            exclude = [(p.address[0], p.remote_listening_port)
                       for p in self.authenticated_peers.values()
                       if p.address]
            # a dial still mid-handshake must not be re-dialed
            exclude += [p.address for p in self.pending_peers if p.address]
            for rec in self.peer_manager.candidates_to_connect(
                    missing, exclude):
                # strict mode would reject a non-preferred peer right
                # after its handshake anyway — dialing it would redial
                # every tick forever (the policy drop happens post-auth,
                # outside the connect-failure backoff)
                if cfg.PREFERRED_PEERS_ONLY and not rec.preferred:
                    continue
                self.connect_to(rec.host, rec.port)
        self.load_manager.maybe_shed_excess_load(self)
        # send-queue pressure gauges: total queued-but-unsent bytes and
        # how many peers have a backlog (TCP transports; loopback pipes
        # have no queue and report 0)
        total, backlogged = self.send_queue_depth()
        self.stats.set_queue_depth(total, backlogged)
        self._arm_tick()

    def num_connections(self) -> int:
        return len(self.pending_peers) + len(self.authenticated_peers)

    def send_queue_depth(self) -> tuple:
        """(total queued-but-unsent bytes, peers with a backlog) across
        every connection — the cockpit's send-queue pressure signal."""
        total = 0
        backlogged = 0
        for p in list(self.authenticated_peers.values()) + \
                list(self.pending_peers):
            t = p.transport
            qb = getattr(t, "_wqueue_bytes",
                         getattr(getattr(t, "inner", None),
                                 "_wqueue_bytes", 0)) or 0
            total += qb
            backlogged += qb > 0
        return total, backlogged

    # -- connections ---------------------------------------------------------
    def connect_to(self, host: str, port: int) -> Optional[Peer]:
        if self._reactor is None:
            return None
        try:
            t = TCPTransport.connect(self._reactor, host, port)
        except OSError as e:
            log.debug("connect to %s:%d failed: %s", host, port, e)
            self.peer_manager.on_connect_failure(host, port)
            return None
        self._apply_transport_limits(t)
        peer = Peer(self.app, self, t, PeerRole.WE_CALLED_REMOTE,
                    address=(host, port))
        self.pending_peers.append(peer)
        # the dial is async (non-blocking connect): success is recorded
        # when the peer authenticates, failure when it closes pre-auth
        # (accept_authenticated_peer / remove_peer), keeping the
        # peer-table backoff accurate
        peer.connect_handshake()
        return peer

    def _apply_transport_limits(self, t) -> None:
        cfg = self.app.config
        t.max_batch_write_count = cfg.MAX_BATCH_WRITE_COUNT
        t.max_batch_write_bytes = cfg.MAX_BATCH_WRITE_BYTES
        t.send_queue_limit_bytes = cfg.PEER_SEND_QUEUE_LIMIT_BYTES
        # overflow drops are counted, and the overlay.send-overflow
        # fault site can force them deterministically
        t.metrics = getattr(self.app, "metrics", None)
        t.faults = getattr(self.app, "faults", None)

    def _on_inbound_connection(self, transport, addr) -> None:
        if self.num_connections() >= \
                self.app.config.MAX_PENDING_CONNECTIONS + \
                self.app.config.TARGET_PEER_CONNECTIONS:
            transport.close()
            return
        self._apply_transport_limits(transport)
        peer = Peer(self.app, self, transport, PeerRole.REMOTE_CALLED_US,
                    address=(addr[0], addr[1]))
        self.pending_peers.append(peer)

    def add_loopback_peer(self, transport: LoopbackTransport,
                          outbound: bool, address=None) -> Peer:
        """Attach one end of an in-process pipe as a peer (simulation)."""
        role = (PeerRole.WE_CALLED_REMOTE if outbound
                else PeerRole.REMOTE_CALLED_US)
        peer = Peer(self.app, self, transport, role, address=address)
        self.pending_peers.append(peer)
        if outbound:
            peer.connect_handshake()
        return peer

    def _preferred_key_set(self) -> frozenset:
        """PREFERRED_PEER_KEYS strkeys decoded once (invalid entries are
        logged once and skipped)."""
        cfg_keys = tuple(self.app.config.PREFERRED_PEER_KEYS)
        if getattr(self, "_pref_keys_src", None) != cfg_keys:
            from ..crypto import strkey
            decoded = []
            for s in cfg_keys:
                try:
                    decoded.append(strkey.decode_public_key(s))
                except Exception:
                    log.warning("ignoring invalid PREFERRED_PEER_KEYS "
                                "entry %r", s)
            self._pref_keys_src = cfg_keys
            self._pref_keys = frozenset(decoded)
        return self._pref_keys

    def is_preferred(self, peer: Peer) -> bool:
        """Preferred by configured address or by node key (reference
        OverlayManagerImpl::isPreferred). Inbound peers match on their
        LISTENING port from HELLO, not the ephemeral socket port."""
        if peer.address is not None:
            for port in (peer.address[1], peer.remote_listening_port):
                rec = self.peer_manager._peers.get((peer.address[0], port))
                if rec is not None and rec.preferred:
                    return True
        if peer.peer_id is not None and \
                peer.peer_id.key_bytes in self._preferred_key_set():
            return True
        return False

    def accept_authenticated_peer(self, peer: Peer) -> bool:
        """Handshake finished: move pending → authenticated
        (reference moveToAuthenticated/acceptAuthenticatedPeer)."""
        # the transport + handshake worked: whatever happens next (ban,
        # duplicate-connection tiebreak, policy rejection) must NOT count
        # toward the connect-failure backoff
        peer.ever_authenticated = True
        key = peer.peer_id.to_xdr()
        if self.ban_manager.is_banned(peer.peer_id):
            peer.drop("banned")
            return False
        # connection policy (reference acceptAuthenticatedPeer:178-215):
        # preferred peers always win a slot — evicting a non-preferred
        # victim at capacity — and strict mode rejects everyone else.
        # Capacity matches the load manager's shedding limit: target
        # plus the operator's additional inbound headroom.
        cfg = self.app.config
        max_auth = cfg.TARGET_PEER_CONNECTIONS + \
            max(0, cfg.MAX_ADDITIONAL_PEER_CONNECTIONS)
        if self.is_preferred(peer):
            if len(self.authenticated_peers) >= max_auth and \
                    self.authenticated_peers.get(key) is None:
                for vk, victim in list(self.authenticated_peers.items()):
                    if not self.is_preferred(victim):
                        log.info("evicting non-preferred peer %s for "
                                 "preferred %s", victim.id_str(),
                                 peer.id_str())
                        victim.drop("preferred peer selected instead")
                        break
        elif cfg.PREFERRED_PEERS_ONLY or \
                (len(self.authenticated_peers) >= max_auth and
                 self.authenticated_peers.get(key) is None):
            peer.drop("peer rejected")
            return False
        existing = self.authenticated_peers.get(key)
        if existing is not None and existing is not peer:
            # One connection per node id. Simultaneous connects create one
            # in each direction; both sides must pick the SAME survivor or
            # they keep killing each other's link. Tiebreak: keep the
            # connection initiated by the smaller node id.
            we_called_survives = self.app.config.node_id().to_xdr() < key
            new_is_survivor = (
                existing.role != peer.role and
                (peer.role == PeerRole.WE_CALLED_REMOTE) == we_called_survives)
            if not new_is_survivor:
                peer.drop("duplicate connection")
                return False
            existing.drop("duplicate connection (tiebreak)")
        if peer in self.pending_peers:
            self.pending_peers.remove(peer)
        self.authenticated_peers[key] = peer
        if peer.role == PeerRole.WE_CALLED_REMOTE and peer.address:
            self.peer_manager.on_connect_success(*peer.address)
        m = getattr(self.app, "metrics", None)
        if m is not None:
            m.new_meter("overlay.connection.authenticated").mark()
            m.new_counter("overlay.connection.count").set_count(
                len(self.authenticated_peers))
        log.debug("peer %s authenticated (%d total)", peer.id_str(),
                  len(self.authenticated_peers))
        return True

    def remove_peer(self, peer: Peer) -> None:
        if peer in self.pending_peers:
            self.pending_peers.remove(peer)
        if peer.role == PeerRole.WE_CALLED_REMOTE and peer.address and \
                not peer.ever_authenticated:
            # an outbound dial that died before authenticating (incl.
            # async connect failures) counts toward the backoff
            self.peer_manager.on_connect_failure(*peer.address)
        if peer.peer_id is not None:
            key = peer.peer_id.to_xdr()
            if self.authenticated_peers.get(key) is peer:
                del self.authenticated_peers[key]
                self.load_manager.forget(key)
                self.flood_control.forget(key)

    # -- registry views ------------------------------------------------------
    def authenticated_peer_ids(self) -> List[bytes]:
        return list(self.authenticated_peers.keys())

    def get_peer(self, key: bytes) -> Optional[Peer]:
        return self.authenticated_peers.get(key)

    def random_authenticated_peers(self, n: int = 0) -> List[Peer]:
        peers = list(self.authenticated_peers.values())
        rnd.g_random.shuffle(peers)
        return peers[:n] if n else peers

    def get_authenticated_peers_count(self) -> int:
        return len(self.authenticated_peers)

    # -- flooding ------------------------------------------------------------
    def _current_ledger_seq(self) -> int:
        return self.app.ledger_manager.last_closed_ledger_num()

    def flood_rate_limited(self, peer: Peer) -> bool:
        """Token-bucket admission for one flooded message from `peer`
        (overlay/flood_control.py): True = drop it before any processing
        or relay. Escalation (ban score → BanManager + peer drop) happens
        inside the flood controller."""
        return self.flood_control.limited(peer)

    def flood_backpressure(self, peer: Peer) -> None:
        """The ingress tier shed/throttled a tx this peer relayed
       : score it fractionally toward the flood ban so
        sustained useless relay escalates, without punishing one-offs."""
        self.flood_control.note_backpressure(peer)

    def recv_flooded_msg(self, msg: StellarMessage, peer: Peer) -> bool:
        """Returns False if this flooded message was seen before."""
        return self.floodgate.add_record(
            msg, peer.peer_id.to_xdr(), self._current_ledger_seq(),
            from_hex=peer.peer_id.key_bytes.hex())

    def broadcast_message(self, msg: StellarMessage,
                          force: bool = False) -> int:
        m = getattr(self.app, "metrics", None)
        if m is not None:
            m.new_meter("overlay.message.broadcast").mark()
        return self.floodgate.broadcast(
            msg, force, self.authenticated_peers,
            self._current_ledger_seq())

    def forget_flooded_msg(self, msg: StellarMessage) -> None:
        self.floodgate.forget_record(msg)

    def ledger_closed(self, ledger_seq: int) -> None:
        # per-slot bandwidth attribution: bytes moved since the previous
        # close belong to this slot (fleet view sums them across nodes)
        self.stats.slot_closed(ledger_seq)
        if self.prop_stats is not None:
            # prune propagation hop rings below the checkpoint window
            # (explicit memory bound)
            self.prop_stats.slot_closed(ledger_seq)
        self.floodgate.clear_below(ledger_seq)
        self.flood_control.ledger_closed()
        self.tx_set_fetcher.stop_fetching_below(ledger_seq)
        self.qset_fetcher.stop_fetching_below(ledger_seq)

    # -- fetch plumbing ------------------------------------------------------
    def recv_dont_have(self, peer: Peer, dh: DontHave) -> None:
        if dh.type == MessageType.TX_SET:
            self.tx_set_fetcher.doesnt_have(dh.reqHash, peer.peer_id.to_xdr())
        elif dh.type == MessageType.SCP_QUORUMSET:
            self.qset_fetcher.doesnt_have(dh.reqHash, peer.peer_id.to_xdr())

    # -- introspection -------------------------------------------------------
    def get_peers_info(self) -> dict:
        def one(p: Peer) -> dict:
            return {
                "id": p.id_str(), "address": str(p.address),
                "version": p.remote_version_str,
                "olver": p.remote_overlay_version,
                "in": p.messages_read, "out": p.messages_written,
            }
        return {
            "authenticated_count": len(self.authenticated_peers),
            "pending_count": len(self.pending_peers),
            "authenticated": [one(p)
                              for p in self.authenticated_peers.values()],
            # per-peer flood-defense state (token levels, ban scores)
            "flood": self.flood_control.to_json(),
        }
