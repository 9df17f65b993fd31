"""SurveyManager: authenticated network-topology survey.

Copied from `stellar_core_tpu/overlay/survey_manager.py` at commit d7c5801;
carry a fix in either copy to the other. Nothing is left out. Request and
response signatures are checked on the host through
`PubKeyUtils.verify_sig`, as the reference does; the sealed boxes go
through crypto/curve25519.py. The `getsurveyresult` admin command is
`main/command_handler.py`'s.

Role parity: reference `src/overlay/SurveyManager.{h,cpp}` +
`SurveyMessageLimiter.cpp` — a surveyor broadcasts ed25519-signed
SURVEY_REQUEST messages naming one surveyed node each, carrying an
ephemeral curve25519 key; the surveyed node verifies, rate-limits,
encrypts its peer-topology stats to that key (sealed box), signs, and
broadcasts the SURVEY_RESPONSE back. Requests/responses are relayed by
flood, so surveys work across multi-hop topologies. Results accumulate
on the surveyor and are served via the `getsurveyresult` admin command.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..crypto.curve25519 import (curve25519_derive_public,
                                 curve25519_random_secret, curve25519_seal,
                                 curve25519_unseal)
from ..crypto.hashing import sha256
from ..crypto.keys import PubKeyUtils
from ..util.log import get_logger
from ..util.timer import VirtualTimer
from ..xdr import (MessageType, PeerStats, PublicKey,
                   SignedSurveyRequestMessage, SignedSurveyResponseMessage,
                   StellarMessage, SurveyMessageCommandType,
                   SurveyRequestMessage, SurveyResponseMessage,
                   TopologyResponseBody)

log = get_logger("Overlay")

SURVEY_THROTTLE = 0.5          # delay between backlog sends (s)
MAX_REQUESTS_PER_LEDGER = 10   # limiter: per-surveyor request budget


class SurveyManager:
    def __init__(self, app, overlay) -> None:
        self.app = app
        self.overlay = overlay
        self._timer = VirtualTimer(app.clock)
        self.running = False
        self._backlog: List[PublicKey] = []
        self._surveyed: Set[bytes] = set()
        self._secret: Optional[bytes] = None     # ephemeral x25519
        self.results: Dict[str, dict] = {}
        self.bad_responses = 0
        # limiter state: surveyor id -> requests seen this ledger
        self._limiter: Dict[bytes, int] = {}
        self._limiter_ledger = 0

    # -- surveyor side -------------------------------------------------------
    def start_survey(self, duration: float = 60.0) -> None:
        """Begin a survey of the whole known overlay (reference
        startSurvey; `surveytopology` admin command)."""
        if not self.running:
            self._secret = curve25519_random_secret()
            self.results = {}
            self._surveyed = set()
            self.running = True
        old = getattr(self, "_stop_timer", None)
        if old is not None:
            old.cancel()        # re-issue extends the deadline
        seen = set()
        for key in self.overlay.authenticated_peer_ids():
            p = self.overlay.get_peer(key)
            if p is not None and p.peer_id is not None and \
                    p.peer_id.key_bytes not in seen:
                seen.add(p.peer_id.key_bytes)
                self.add_node_to_backlog(p.peer_id)
        self._pump()
        stop_timer = VirtualTimer(self.app.clock)
        stop_timer.expires_from_now(duration)
        stop_timer.async_wait(self.stop_survey)
        self._stop_timer = stop_timer

    def add_node_to_backlog(self, node_id: PublicKey) -> None:
        if node_id.key_bytes == self._self_id().key_bytes:
            return
        if node_id.key_bytes not in self._surveyed:
            self._backlog.append(node_id)

    def stop_survey(self) -> None:
        self.running = False
        self._backlog = []

    def _self_id(self) -> PublicKey:
        return self.app.config.node_id()

    def _pump(self) -> None:
        """Send one backlogged request per throttle tick (reference
        topOffRequests)."""
        if not self.running or not self._backlog:
            return
        node = self._backlog.pop(0)
        if node.key_bytes not in self._surveyed:
            self._surveyed.add(node.key_bytes)
            self._send_request(node)
        self._timer.expires_from_now(SURVEY_THROTTLE)
        self._timer.async_wait(self._pump)

    def _send_request(self, node: PublicKey) -> None:
        req = SurveyRequestMessage(
            surveyorPeerID=self._self_id(),
            surveyedPeerID=node,
            ledgerNum=self.app.ledger_manager.last_closed_ledger_num(),
            encryptionKey=curve25519_derive_public(self._secret),
            commandType=SurveyMessageCommandType.SURVEY_TOPOLOGY)
        sig = self.app.config.NODE_SEED.sign(self._request_sign_bytes(req))
        msg = StellarMessage(
            MessageType.SURVEY_REQUEST,
            SignedSurveyRequestMessage(requestSignature=sig, request=req))
        self.overlay.broadcast_message(msg, force=True)

    def _request_sign_bytes(self, req: SurveyRequestMessage) -> bytes:
        return sha256(self.app.config.network_id + b"survey-request" +
                      req.to_xdr())

    def _response_sign_bytes(self, rsp: SurveyResponseMessage) -> bytes:
        return sha256(self.app.config.network_id + b"survey-response" +
                      rsp.to_xdr())

    # -- relay / process (both sides) ----------------------------------------
    def relay_or_process(self, msg: StellarMessage, peer) -> None:
        """Entry from Peer message dispatch; flood-dedup, verify, then
        answer if we are the target, else relay (reference
        relayOrProcessRequest/Response)."""
        if not self.overlay.recv_flooded_msg(msg, peer):
            return              # duplicate copy: already handled/relayed
        if msg.disc == MessageType.SURVEY_REQUEST:
            self._on_request(msg)
        else:
            self._on_response(msg)

    def _limiter_ok(self, surveyor: PublicKey) -> bool:
        lcl = self.app.ledger_manager.last_closed_ledger_num()
        if lcl != self._limiter_ledger:
            self._limiter_ledger = lcl
            self._limiter = {}
        n = self._limiter.get(surveyor.key_bytes, 0)
        self._limiter[surveyor.key_bytes] = n + 1
        return n < MAX_REQUESTS_PER_LEDGER

    def _on_request(self, msg: StellarMessage) -> None:
        signed: SignedSurveyRequestMessage = msg.value
        req = signed.request
        if not PubKeyUtils.verify_sig(req.surveyorPeerID,
                                      signed.requestSignature,
                                      self._request_sign_bytes(req)):
            self.bad_responses += 1
            return
        if req.surveyedPeerID.key_bytes != self._self_id().key_bytes:
            self.overlay.broadcast_message(msg)      # relay on
            return
        # budget consumed only by verified requests addressed to us
        # (reference SurveyMessageLimiter records after validation)
        if not self._limiter_ok(req.surveyorPeerID):
            return
        body = self._build_topology_body()
        sealed = curve25519_seal(req.encryptionKey, body.to_xdr())
        rsp = SurveyResponseMessage(
            surveyorPeerID=req.surveyorPeerID,
            surveyedPeerID=self._self_id(),
            ledgerNum=req.ledgerNum,
            commandType=SurveyMessageCommandType.SURVEY_TOPOLOGY,
            encryptedBody=sealed)
        sig = self.app.config.NODE_SEED.sign(self._response_sign_bytes(rsp))
        self.overlay.broadcast_message(
            StellarMessage(MessageType.SURVEY_RESPONSE,
                           SignedSurveyResponseMessage(
                               responseSignature=sig, response=rsp)),
            force=True)

    def _on_response(self, msg: StellarMessage) -> None:
        signed: SignedSurveyResponseMessage = msg.value
        rsp = signed.response
        if not PubKeyUtils.verify_sig(rsp.surveyedPeerID,
                                      signed.responseSignature,
                                      self._response_sign_bytes(rsp)):
            self.bad_responses += 1
            return
        if rsp.surveyorPeerID.key_bytes != self._self_id().key_bytes:
            self.overlay.broadcast_message(msg)      # relay on
            return
        if self._secret is None:
            return
        try:
            body = TopologyResponseBody.from_xdr(
                curve25519_unseal(self._secret, rsp.encryptedBody))
        except Exception:
            self.bad_responses += 1
            return
        self._record_result(rsp.surveyedPeerID, body)

    # -- topology assembly ---------------------------------------------------
    def _peer_stats(self, p) -> PeerStats:
        return PeerStats(
            id=p.peer_id or PublicKey.ed25519(b"\x00" * 32),
            versionStr=(p.remote_version_str or
                        self.app.config.VERSION_STR)[:100],
            messagesRead=p.messages_read,
            messagesWritten=p.messages_written,
            bytesRead=p.bytes_read,
            bytesWritten=p.bytes_written,
            secondsConnected=int(
                max(0.0, self.app.clock.now() -
                    getattr(p, "connected_at", self.app.clock.now()))))

    def _build_topology_body(self) -> TopologyResponseBody:
        inbound, outbound = [], []
        for key in self.overlay.authenticated_peer_ids():
            p = self.overlay.get_peer(key)
            if p is None:
                continue
            from .peer import PeerRole
            (outbound if p.role == PeerRole.WE_CALLED_REMOTE
             else inbound).append(self._peer_stats(p))
        return TopologyResponseBody(
            inboundPeers=inbound[:25], outboundPeers=outbound[:25],
            totalInboundPeerCount=len(inbound),
            totalOutboundPeerCount=len(outbound))

    def _record_result(self, node: PublicKey,
                       body: TopologyResponseBody) -> None:
        def stats(ps: PeerStats) -> dict:
            return {"nodeId": ps.id.key_bytes.hex(),
                    "version": ps.versionStr,
                    "messagesRead": ps.messagesRead,
                    "messagesWritten": ps.messagesWritten,
                    "bytesRead": ps.bytesRead,
                    "bytesWritten": ps.bytesWritten,
                    "secondsConnected": ps.secondsConnected}

        self.results[node.key_bytes.hex()] = {
            "inboundPeers": [stats(x) for x in body.inboundPeers],
            "outboundPeers": [stats(x) for x in body.outboundPeers],
            "totalInbound": body.totalInboundPeerCount,
            "totalOutbound": body.totalOutboundPeerCount,
        }
        # walk outward: newly-learned peers join the backlog
        if self.running:
            for ps in list(body.inboundPeers) + list(body.outboundPeers):
                if ps.id.key_bytes != b"\x00" * 32:
                    self.add_node_to_backlog(ps.id)
            self._pump()

    def get_results(self) -> dict:
        return {"surveyInProgress": self.running,
                "badResponses": self.bad_responses,
                "topology": self.results}

    def get_stats(self) -> dict:
        """Compact survey health for the fleet aggregate (util/fleet.py):
        enough to see, across N nodes at once, who surveyed whom and who
        dropped responses — without shipping full topologies."""
        out = {"running": self.running,
               "surveyed": len(self._surveyed),
               "results": len(self.results),
               "backlog": len(self._backlog),
               "bad_responses": self.bad_responses}
        # both-direction bandwidth totals (LoadManager now accounts the
        # send path too): the fleet aggregate's
        # survey block carries who moved how many bytes each way
        lm = getattr(self.overlay, "load_manager", None)
        if lm is not None:
            out.update(lm.totals())
        return out
