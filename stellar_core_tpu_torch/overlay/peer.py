"""Peer: the overlay protocol state machine over an abstract transport.

Copied from `stellar_core_tpu/overlay/peer.py` at commit 02f8fbd; carry a
fix in either copy to the other. Nothing is left out. An SCP_MESSAGE goes
to `herder.recv_scp_envelope` and is relayed only when `on_verified(ok)`
says the node's verifier passed it; on the port's card stacks a verify
that misses the process's cache is a launch on the card, so the card sits
on every hop of an envelope's flood. A TRANSACTION goes through `herder.recv_transaction` (the tx queue's
admission verify) and is relayed only on status 0. A verify that raises is
not retried on the CPU: the frame is not relayed and the peer is dropped,
as any error in dispatch drops it.

Role parity: reference `src/overlay/Peer.{h,cpp}` — handshake
(Hello ↔ Hello, Auth ↔ Auth), per-message HMAC with monotonically
increasing sequence numbers (Peer.cpp:436-439 send, :514 verify), and the
message dispatch switch (Peer.cpp:529-790) routing transactions and SCP
traffic into the Herder and serving GET_TX_SET / GET_SCP_QUORUMSET /
GET_PEERS / GET_SCP_STATE requests.

Transports: LoopbackTransport (in-process pipes with fault injection,
reference overlay/test/LoopbackPeer.h) and TCPTransport (real sockets,
reference TCPPeer.cpp). Both deliver whole XDR frames.
"""

from __future__ import annotations

from typing import Optional

from ..crypto.hashing import hmac_sha256, hmac_sha256_verify, sha256
from ..util import rnd
from ..util.log import get_logger
from ..xdr import (
    Auth, AuthenticatedMessage, AuthenticatedMessageV0, DontHave, Error,
    ErrorCode, Hello, MessageType, PeerAddress, SCPQuorumSet, StellarMessage,
)
from .peer_auth import PeerRole

log = get_logger("Overlay")


class PeerState:
    CONNECTING = 0
    CONNECTED = 1
    GOT_HELLO = 2
    GOT_AUTH = 3
    CLOSING = 4


class Peer:
    def __init__(self, app, overlay, transport,
                 role: int, address: Optional[tuple] = None) -> None:
        self.app = app
        self.overlay = overlay
        self.transport = transport
        self.role = role
        self.address = address            # (host, port) when known
        self.state = (PeerState.CONNECTING if role == PeerRole.WE_CALLED_REMOTE
                      else PeerState.CONNECTED)
        self.peer_id = None               # remote NodeID (PublicKey)
        self.remote_overlay_version = 0
        self.remote_version_str = ""
        self.remote_listening_port = 0
        self.local_nonce = rnd.rand_bytes(32)
        self.remote_nonce = b""
        self.send_mac_key = b""
        self.recv_mac_key = b""
        self.send_mac_seq = 0
        self.recv_mac_seq = 0
        self.last_read = app.clock.now()
        self.last_write = app.clock.now()
        self.last_empty_write = app.clock.now()
        self.messages_read = 0
        self.messages_written = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.connected_at = app.clock.now()
        self.dropped = False
        self.ever_authenticated = False
        # wire cockpit: per-message-type byte accounting on
        # both directions (docs/observability.md#overlay-cockpit)
        self._stats = getattr(overlay, "stats", None)
        # propagation cockpit: MAC-layer duplicate frames of
        # flooded types are redundant edges too — recorded here so
        # injected transport duplicates land in the same edge class the
        # Floodgate attributes (docs/observability.md#propagation-cockpit)
        self._prop = getattr(overlay, "prop_stats", None)
        # the last authenticated frame, for MAC-layer duplicate
        # detection (ChaosTransport overlay.duplicate injection)
        self._last_frame_seq: Optional[int] = None
        self._last_frame_mac = b""
        transport.on_frame = self._on_frame
        transport.on_closed = self._on_closed

    # -- identity ------------------------------------------------------------
    def id_str(self) -> str:
        if self.peer_id is not None:
            from ..crypto import strkey
            return strkey.encode_public_key(self.peer_id.value)[:8]
        return "peer@%s" % (self.address,)

    def is_authenticated(self) -> bool:
        return self.state == PeerState.GOT_AUTH

    # -- lifecycle -----------------------------------------------------------
    def connect_handshake(self) -> None:
        """Outbound side: transport is up, start with Hello."""
        self.state = PeerState.CONNECTED
        self.send_hello()

    def drop(self, reason: str = "", send_error: Optional[int] = None) -> None:
        if self.dropped:
            return
        if send_error is not None and self.state >= PeerState.CONNECTED:
            try:
                self.send_message(StellarMessage(
                    MessageType.ERROR_MSG,
                    Error(code=send_error, msg=reason[:100])))
            except Exception:
                pass
        self.dropped = True
        self.state = PeerState.CLOSING
        if reason:
            log.debug("dropping peer %s: %s", self.id_str(), reason)
        self.transport.close()
        self.overlay.remove_peer(self)

    def _on_closed(self) -> None:
        if not self.dropped:
            self.dropped = True
            self.state = PeerState.CLOSING
            self.overlay.remove_peer(self)

    # -- send path -----------------------------------------------------------
    def send_message(self, msg: StellarMessage) -> None:
        if self.dropped:
            return
        t = msg.disc
        if t in (MessageType.HELLO, MessageType.ERROR_MSG):
            am = AuthenticatedMessageV0(sequence=0, message=msg,
                                        mac=b"\x00" * 32)
        else:
            seq = self.send_mac_seq
            self.send_mac_seq += 1
            import struct
            mac = hmac_sha256(self.send_mac_key,
                              struct.pack(">Q", seq) + msg.to_xdr())
            am = AuthenticatedMessageV0(sequence=seq, message=msg, mac=mac)
        raw = AuthenticatedMessage(0, am).to_xdr()
        self.bytes_written += len(raw)
        self.messages_written += 1
        self.last_write = self.app.clock.now()
        key = self.peer_id.key_bytes if self.peer_id is not None else None
        if self._stats is not None:
            self._stats.record_send(t, len(raw), key)
        if self.peer_id is not None:
            # sent bytes feed the same per-peer cost vector the receive
            # path already feeds (reference LoadManager symmetry)
            self.overlay.load_manager.record_sent(
                self.peer_id.to_xdr(), len(raw))
        self.transport.send_frame(raw)

    def send_hello(self) -> None:
        cfg = self.app.config
        auth = self.overlay.peer_auth
        hello = Hello(
            ledgerVersion=cfg.LEDGER_PROTOCOL_VERSION,
            overlayVersion=cfg.OVERLAY_PROTOCOL_VERSION,
            overlayMinVersion=cfg.OVERLAY_PROTOCOL_MIN_VERSION,
            networkID=cfg.network_id,
            versionStr=cfg.VERSION_STR,
            listeningPort=cfg.PEER_PORT,
            peerID=cfg.node_id(),
            cert=auth.get_auth_cert(),
            nonce=self.local_nonce)
        self.send_message(StellarMessage(MessageType.HELLO, hello))

    def send_auth(self) -> None:
        self.send_message(StellarMessage(MessageType.AUTH, Auth(unused=0)))

    def send_dont_have(self, msg_type: int, item_hash: bytes) -> None:
        self.send_message(StellarMessage(
            MessageType.DONT_HAVE,
            DontHave(type=msg_type, reqHash=item_hash)))

    def send_peers(self) -> None:
        addrs = self.overlay.peer_manager.peers_to_send(50)
        if addrs:
            self.send_message(StellarMessage(MessageType.PEERS, addrs))

    # -- receive path --------------------------------------------------------
    def _on_frame(self, raw: bytes) -> None:
        if self.dropped:
            return
        self.bytes_read += len(raw)
        self.messages_read += 1
        self.last_read = self.app.clock.now()
        try:
            am = AuthenticatedMessage.from_xdr(raw)
        except Exception:
            if self._stats is not None:
                self._stats.record_recv(
                    None, len(raw),
                    self.peer_id.key_bytes if self.peer_id else None)
            self.drop("malformed frame")
            return
        v0 = am.value
        msg = v0.message
        t = msg.disc
        if self._stats is not None:
            self._stats.record_recv(
                t, len(raw),
                self.peer_id.key_bytes if self.peer_id else None)
        if t not in (MessageType.HELLO, MessageType.ERROR_MSG):
            if self.state < PeerState.GOT_HELLO:
                self.drop("message before handshake")
                return
            import struct
            data = struct.pack(">Q", v0.sequence) + msg.to_xdr()
            if v0.sequence != self.recv_mac_seq or not hmac_sha256_verify(
                    self.recv_mac_key, data, v0.mac):
                # a byte-identical replay of the PREVIOUS frame is a
                # transport-level duplicate (ChaosTransport
                # overlay.duplicate, or a duplicating network) — count
                # it into the duplication ratio and drop the FRAME, not
                # the link (the MAC chain proves it's a copy, not a
                # forgery)
                if v0.sequence == self._last_frame_seq and \
                        v0.mac == self._last_frame_mac and \
                        hmac_sha256_verify(self.recv_mac_key, data, v0.mac):
                    flooded = t in (MessageType.TRANSACTION,
                                    MessageType.SCP_MESSAGE)
                    if self._stats is not None:
                        self._stats.record_duplicate_frame(
                            t, flooded=flooded)
                    if self._prop is not None and flooded and \
                            self.peer_id is not None:
                        # the duplicate never reaches the Floodgate (the
                        # frame is dropped here), so stamp its redundant
                        # edge directly — wasted bytes attributed to the
                        # replaying peer
                        raw_msg = msg.to_xdr()
                        self._prop.record_recv_hop(
                            sha256(raw_msg), self.peer_id.key_bytes.hex(),
                            len(raw_msg), t, False,
                            self.app.ledger_manager.last_closed_ledger_num())
                    return
                self.drop("unexpected MAC/sequence",
                          send_error=ErrorCode.ERR_AUTH)
                return
            self._last_frame_seq = v0.sequence
            self._last_frame_mac = v0.mac
            self.recv_mac_seq += 1
        try:
            if self.peer_id is not None:
                # per-peer cost accounting (reference LoadManager contexts)
                lm = self.overlay.load_manager
                with lm.context(self.peer_id.to_xdr()):
                    self._dispatch(msg)
                lm.record_bytes(self.peer_id.to_xdr(), 0, len(raw))
            else:
                self._dispatch(msg)
        except Exception as e:       # noqa: BLE001 — peer input is hostile
            log.warning("error handling %d from %s: %s", t, self.id_str(), e)
            self.drop("internal error handling message")

    def _dispatch(self, msg: StellarMessage) -> None:
        t = msg.disc
        if t == MessageType.HELLO:
            self._recv_hello(msg.value)
            return
        if t == MessageType.ERROR_MSG:
            log.debug("peer %s sent error %d: %s", self.id_str(),
                      msg.value.code, msg.value.msg)
            self.drop("peer error")
            return
        if t == MessageType.AUTH:
            self._recv_auth()
            return
        if not self.is_authenticated():
            self.drop("message before auth", send_error=ErrorCode.ERR_AUTH)
            return
        herder = self.app.herder
        if t == MessageType.DONT_HAVE:
            self.overlay.recv_dont_have(self, msg.value)
        elif t == MessageType.GET_PEERS:
            self.send_peers()
        elif t == MessageType.PEERS:
            self.overlay.peer_manager.recv_peers(msg.value)
        elif t == MessageType.GET_TX_SET:
            ts = herder.pending.get_tx_set(msg.value)
            if ts is not None:
                self.send_message(StellarMessage(MessageType.TX_SET,
                                                 ts.to_wire()))
            else:
                self.send_dont_have(MessageType.TX_SET, msg.value)
        elif t == MessageType.TX_SET:
            from ..herder.txset import TxSetFrame
            frame = TxSetFrame.from_wire(self.app.config.network_id,
                                         msg.value)
            h = frame.get_contents_hash()
            herder.recv_tx_set(h, frame)
            self.overlay.item_fetched_txset(h)
        elif t == MessageType.TRANSACTION:
            if self.overlay.flood_rate_limited(self):
                # over the per-peer flood rate: dropped before any
                # validation or relay (docs/robustness.md#flood-control)
                return
            self.overlay.recv_flooded_msg(msg, self)
            from ..transactions.transaction_frame import TransactionFrame
            frame = TransactionFrame.make_from_wire(
                self.app.config.network_id, msg.value)
            status = herder.recv_transaction(frame)
            if status == 0:
                self.overlay.broadcast_message(msg)
            elif status == 3:
                # ingress backpressure on a relayed tx: not relayed
                # further, and the sender scores a fractional flood-ban
                # point (docs/robustness.md#ingress--overload)
                self.overlay.flood_backpressure(self)
        elif t == MessageType.GET_SCP_QUORUMSET:
            q = self._lookup_qset(msg.value)
            if q is not None:
                self.send_message(StellarMessage(MessageType.SCP_QUORUMSET, q))
            else:
                self.send_dont_have(MessageType.SCP_QUORUMSET, msg.value)
        elif t == MessageType.SCP_QUORUMSET:
            h = sha256(msg.value.to_xdr())
            herder.recv_scp_quorum_set(h, msg.value)
            self.overlay.item_fetched_qset(h)
        elif t == MessageType.SCP_MESSAGE:
            if self.overlay.flood_rate_limited(self):
                return
            self.overlay.recv_flooded_msg(msg, self)
            # only relay envelopes that verified (reference Peer.cpp
            # rebroadcasts unless the herder discarded the envelope); with
            # an async batch backend the flood is deferred until the
            # device batch completes on the main loop
            herder.recv_scp_envelope(
                msg.value,
                on_verified=lambda ok:
                    self.overlay.broadcast_message(msg) if ok else None)
        elif t == MessageType.GET_SCP_STATE:
            self._send_scp_state(msg.value)
        elif t in (MessageType.SURVEY_REQUEST, MessageType.SURVEY_RESPONSE):
            sm = getattr(self.overlay, "survey_manager", None)
            if sm is not None:
                sm.relay_or_process(msg, self)
        else:
            self.drop("unexpected message type %d" % t)

    def _lookup_qset(self, h: bytes) -> Optional[SCPQuorumSet]:
        herder = self.app.herder
        q = herder.pending.get_quorum_set(h)
        if q is not None:
            return q
        local = self.app.config.QUORUM_SET
        if local is not None and sha256(local.to_xdr()) == h:
            return local
        return None

    def _send_scp_state(self, ledger_seq: int) -> None:
        """Send our SCP state for slots >= seq (reference
        HerderImpl::sendSCPStateToPeer)."""
        herder = self.app.herder
        sent = 0
        for slot_index in sorted(herder.scp.known_slots):
            if ledger_seq and slot_index < ledger_seq:
                continue
            for env in herder.scp.get_current_state(slot_index):
                self.send_message(StellarMessage(MessageType.SCP_MESSAGE,
                                                 env))
                sent += 1
                if sent > 100:
                    return

    # -- handshake -----------------------------------------------------------
    def _recv_hello(self, hello: Hello) -> None:
        if self.state >= PeerState.GOT_HELLO:
            self.drop("duplicate HELLO")
            return
        cfg = self.app.config
        auth = self.overlay.peer_auth
        if hello.networkID != cfg.network_id:
            self.drop("wrong network", send_error=ErrorCode.ERR_CONF)
            return
        if hello.overlayVersion < cfg.OVERLAY_PROTOCOL_MIN_VERSION or \
                hello.overlayMinVersion > cfg.OVERLAY_PROTOCOL_VERSION:
            self.drop("incompatible overlay version",
                      send_error=ErrorCode.ERR_CONF)
            return
        if hello.peerID == cfg.node_id():
            self.drop("connecting to self", send_error=ErrorCode.ERR_CONF)
            return
        if not auth.verify_remote_cert(hello.peerID, hello.cert):
            self.drop("bad auth cert", send_error=ErrorCode.ERR_AUTH)
            return
        if self.overlay.ban_manager.is_banned(hello.peerID):
            self.drop("banned", send_error=ErrorCode.ERR_CONF)
            return
        self.peer_id = hello.peerID
        self.remote_nonce = hello.nonce
        self.remote_overlay_version = hello.overlayVersion
        self.remote_version_str = hello.versionStr
        self.remote_listening_port = hello.listeningPort
        we_called = (self.role == PeerRole.WE_CALLED_REMOTE)
        self.send_mac_key = auth.get_sending_mac_key(
            hello.cert.pubkey, self.local_nonce, self.remote_nonce, we_called)
        self.recv_mac_key = auth.get_receiving_mac_key(
            hello.cert.pubkey, self.local_nonce, self.remote_nonce, we_called)
        self.state = PeerState.GOT_HELLO
        if self.role == PeerRole.REMOTE_CALLED_US:
            self.send_hello()
        else:
            self.send_auth()

    def _recv_auth(self) -> None:
        if self.state != PeerState.GOT_HELLO:
            self.drop("AUTH out of order", send_error=ErrorCode.ERR_MISC)
            return
        self.state = PeerState.GOT_AUTH
        if self.role == PeerRole.REMOTE_CALLED_US:
            self.send_auth()
        if not self.overlay.accept_authenticated_peer(self):
            return
        self.send_message(StellarMessage(MessageType.GET_PEERS, None))
        # pull the peer's current SCP state so a late joiner (or a network
        # whose first nominations flooded into the void) catches up
        # (reference Peer.cpp sendGetScpState on auth completion)
        try:
            lcl = self.app.ledger_manager.last_closed_ledger_num()
        except Exception:
            lcl = 0                  # node not started yet: ask for all
        self.send_message(StellarMessage(MessageType.GET_SCP_STATE, lcl))
