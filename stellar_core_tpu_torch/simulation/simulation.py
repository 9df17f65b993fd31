"""Simulation: N full Application nodes in one process, virtual time.

Copied from `stellar_core_tpu/simulation/simulation.py` at commit 378eae4;
carry a fix in either copy to the other. Nothing is left out.

One deliberate difference: `Simulation(mode, network_passphrase,
backend="cuda-resilient")`. `add_node` sets SIG_VERIFY_BACKEND and
HASH_BACKEND from `backend` before the node's `cfg_tweak` runs (so a tweak
may still name another stack, such as "cuda-async"), and the port's
`Config()` names the card's stacks too: a fleet built with no backend
named is a fleet of card nodes, each with its own verifier and hasher on
the card, and building one raises where there is no card. There is no
CPU fallback; the CPU runs only where `backend="cpu"` (or a tweak) names
it. "cuda-async", which has no hashing counterpart, hashes on
"cuda-resilient", as `Config.test_config` does. The card is reached only
through each node's `app.sig_verifier` and `app.batch_hasher`.

Role parity: reference `src/simulation/Simulation.{h,cpp}:27-111` — each
node has its own VirtualClock + Application; nodes connect over loopback
pipes (OVER_LOOPBACK) or real TCP (OVER_TCP); tests crank all nodes in
lock-step deterministic time and assert haveAllExternalized.

The loopback transport delivers StellarMessages directly between herders
(message-level loopback); the TCP mode uses the real overlay layer.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..crypto.hashing import sha256
from ..crypto.keys import SecretKey
from ..main.application import Application
from ..main.config import Config
from ..util.log import get_logger
from ..util.timer import ClockMode, VirtualClock
from ..xdr import (
    MessageType, PublicKey, SCPQuorumSet, StellarMessage,
)

log = get_logger("LoadGen")


class LoopbackChannel:
    """Symmetric message pipe between two nodes with optional fault
    injection (reference overlay/test/LoopbackPeer.h:24-94 damage knobs)."""

    def __init__(self, sim: "Simulation", a: str, b: str) -> None:
        self.sim = sim
        self.ends = (a, b)
        self.drop_probability = 0.0
        self.damage_probability = 0.0
        # deterministic geographic one-way delay (virtual seconds on the
        # RECEIVING node's clock) — fed by Simulation.apply_latency_matrix
        self.latency_s = 0.0
        self.enabled = True

    def send(self, from_node: str, msg: StellarMessage) -> None:
        if not self.enabled:
            return
        from ..util import rnd
        if self.drop_probability and \
                rnd.g_random.random() < self.drop_probability:
            return
        raw = msg.to_xdr()
        if self.damage_probability and \
                rnd.g_random.random() < self.damage_probability:
            b = bytearray(raw)
            b[rnd.g_random.randrange(len(b))] ^= 0xFF
            raw = bytes(b)
        to = self.ends[0] if from_node == self.ends[1] else self.ends[1]
        node = self.sim.nodes[to]
        if node.stopped:
            return
        if self.latency_s > 0:
            from ..util.timer import VirtualTimer
            t = VirtualTimer(node.app.clock)
            t.expires_from_now(self.latency_s)
            t.async_wait(lambda: self.sim._deliver(to, from_node, raw))
        else:
            node.app.clock.post(
                lambda: self.sim._deliver(to, from_node, raw))


class SimNode:
    def __init__(self, name: str, app: Application) -> None:
        self.name = name
        self.app = app
        self.channels: List[LoopbackChannel] = []
        self.stopped = False
        # preserved across restarts (restart_node rebuilds the app)
        self.cfg_tweak = None


class Simulation:
    # Message-level loopback: herders wired directly (fastest; default for
    # protocol-focused tests).
    OVER_LOOPBACK = 0
    # Full overlay stack over in-process pipes: real Peer handshake, HMAC,
    # flood, item fetch (reference Simulation OVER_LOOPBACK with
    # LoopbackPeer, simulation/Simulation.h:30-34).
    OVER_PEERS = 1

    def __init__(self, mode: int = OVER_LOOPBACK,
                 network_passphrase: str = "(sct) simulation network",
                 backend: str = "cuda-resilient") -> None:
        self.mode = mode
        self.network_passphrase = network_passphrase
        # every node's verify and hash stacks (main/config.py's names)
        self.backend = backend
        self.nodes: Dict[str, SimNode] = {}
        self._chaos_links: Dict[tuple, tuple] = {}
        # (a, b, chaos) per connect_peers call — restart_node rewires from
        # this record after the old transports died with the old app
        self._peer_links: List[tuple] = []
        # seeded geographic latency matrix (simulation/geography.py);
        # applied to every existing and future link when set
        self.latency_matrix = None

    # -- topology -----------------------------------------------------------
    def add_node(self, secret: SecretKey, qset: SCPQuorumSet,
                 name: Optional[str] = None,
                 cfg_tweak: Optional[Callable[[Config], None]] = None
                 ) -> SimNode:
        name = name or secret.strkey_public()[:5]
        cfg = Config()
        cfg.NETWORK_PASSPHRASE = self.network_passphrase
        cfg.NODE_SEED = secret
        # sim node name flows into flight-recorder filenames and the
        # fleet aggregator's process lanes
        cfg.NODE_NAME = name
        cfg.NODE_IS_VALIDATOR = True
        cfg.QUORUM_SET = qset
        cfg.UNSAFE_QUORUM = True
        cfg.RUN_STANDALONE = True   # no real overlay sockets
        cfg.FORCE_SCP = True
        cfg.MANUAL_CLOSE = False
        cfg.DATABASE = "in-memory"
        cfg.INVARIANT_CHECKS = [".*"]
        cfg.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = True
        cfg.SIG_VERIFY_BACKEND = self.backend
        cfg.HASH_BACKEND = ("cuda-resilient" if self.backend == "cuda-async"
                            else self.backend)
        if cfg_tweak:
            cfg_tweak(cfg)
        clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        app = Application(clock, cfg)
        node = SimNode(name, app)
        node.cfg_tweak = cfg_tweak
        self.nodes[name] = node
        if self.mode == Simulation.OVER_LOOPBACK:
            self._wire_loopback_shim(node)
        return node

    def _wire_loopback_shim(self, node: SimNode) -> None:
        # message-loopback broadcast shim standing in for OverlayManager;
        # detach the real manager's item fetchers or their trackers
        # would keep re-arming timers against a manager with no peers
        node.app.overlay_manager = _SimOverlayShim(self, node.name)
        node.app.herder.pending.set_fetchers(None, None)

    def connect(self, a: str, b: str):
        if self.mode == Simulation.OVER_PEERS:
            return self.connect_peers(a, b)
        ch = LoopbackChannel(self, a, b)
        if self.latency_matrix is not None:
            self.latency_matrix.ensure(a)
            self.latency_matrix.ensure(b)
            ch.latency_s = self.latency_matrix.latency_s(a, b)
        self.nodes[a].channels.append(ch)
        self.nodes[b].channels.append(ch)
        return ch

    def connect_peers(self, a: str, b: str, chaos: bool = False):
        """Real overlay connection over an in-process pipe: `a` plays the
        initiator (WE_CALLED_REMOTE). With chaos=True each end is wrapped
        in a ChaosTransport driven by its own app's fault injector
        (overlay.drop/delay/duplicate/reorder sites + hard partition),
        registered under `self._chaos_links[(a, b)]`."""
        if (a, b, chaos) not in self._peer_links:
            self._peer_links.append((a, b, chaos))
        return self._wire_peer_link(a, b, chaos)

    def reconnect_peers(self, a: str, b: str, chaos: bool = False):
        """Tear down any stale Peer pair between `a` and `b` and wire a
        fresh link (fresh handshake, fresh MAC chain). A ChaosTransport
        partition eats frames while the per-message HMAC sequence keeps
        advancing on the sender, so a healed link is cryptographically
        dead — exactly like a real partition killing TCP connections.
        Reality redials; simulations reconnect explicitly."""
        app_a = self.nodes[a].app
        app_b = self.nodes[b].app
        for app, other in ((app_a, app_b), (app_b, app_a)):
            om = app.overlay_manager
            peer = om.get_peer(other.config.node_id().to_xdr())
            if peer is not None:
                peer.drop("partition healed: reconnecting")
        return self.connect_peers(a, b, chaos)

    def _wire_peer_link(self, a: str, b: str, chaos: bool):
        from ..overlay.transport import ChaosTransport, LoopbackTransport
        app_a = self.nodes[a].app
        app_b = self.nodes[b].app
        # each end is owned by (and delivers onto the clock of) one app
        ta, tb = LoopbackTransport.pair(app_a.clock, app_b.clock)
        if self.latency_matrix is not None and not chaos:
            # geographic delay needs the ChaosTransport wrapper (it owns
            # the per-frame delay timer); wrap even non-chaos links
            chaos = True
        if chaos:
            ta = ChaosTransport(ta, app_a.clock,
                                faults=getattr(app_a, "faults", None))
            tb = ChaosTransport(tb, app_b.clock,
                                faults=getattr(app_b, "faults", None))
            self._chaos_links[tuple(sorted((a, b)))] = (ta, tb)
            if self.latency_matrix is not None:
                self.latency_matrix.ensure(a)
                self.latency_matrix.ensure(b)
                lat = self.latency_matrix.latency_s(a, b)
                ta.link_delay_s = lat
                tb.link_delay_s = lat
        app_b.overlay_manager.add_loopback_peer(tb, outbound=False,
                                                address=(a, 0))
        app_a.overlay_manager.add_loopback_peer(ta, outbound=True,
                                                address=(b, 0))
        return ta, tb

    # -- geography -----------------------------------------------------------
    def apply_latency_matrix(self, matrix) -> None:
        """Install a seeded per-link latency matrix
        (simulation/geography.LatencyMatrix): every existing link gets
        its deterministic one-way delay now, and links wired later
        (add_late_node, restart_node) inherit theirs on creation."""
        self.latency_matrix = matrix
        for name in self.nodes:
            matrix.ensure(name)
        if self.mode == Simulation.OVER_LOOPBACK:
            seen = set()
            for node in self.nodes.values():
                for ch in node.channels:
                    key = tuple(sorted(ch.ends))
                    if key in seen:
                        continue
                    seen.add(key)
                    ch.latency_s = matrix.latency_s(*ch.ends)
        else:
            for (a, b), pair in self._chaos_links.items():
                lat = matrix.latency_s(a, b)
                for t in pair:
                    t.link_delay_s = lat

    # -- chaos ---------------------------------------------------------------
    def set_partition(self, a: str, b: str, on: bool = True) -> None:
        """Sever (or heal) the a<->b link in either simulation mode — the
        chaos soak's partition-and-heal scenario."""
        if self.mode == Simulation.OVER_PEERS:
            link = self._chaos_links.get(tuple(sorted((a, b))))
            assert link is not None, \
                "partition needs connect_peers(..., chaos=True)"
            for t in link:
                t.set_partitioned(on)
            return
        for ch in self.nodes[a].channels:
            if set(ch.ends) == {a, b}:
                ch.enabled = not on

    def heal_partition(self, a: str, b: str) -> None:
        self.set_partition(a, b, on=False)

    def start_all_nodes(self) -> None:
        for node in self.nodes.values():
            if not node.stopped:
                node.app.start()

    # -- node lifecycle ----------------------------------------------------
    def stop_node(self, name: str) -> None:
        """Kill one node mid-run: its links go dark, its clock stops, the
        Application shuts down. Persistent state (a file-backed DATABASE /
        BUCKET_DIR_PATH) survives for restart_node; an in-memory node
        restarts from genesis."""
        node = self.nodes[name]
        if node.stopped:
            return
        node.stopped = True
        for ch in node.channels:
            ch.enabled = False
        if self.mode == Simulation.OVER_PEERS:
            # chaos wrappers of dead links must not linger: set_partition
            # after a restart should find the NEW link's wrappers
            for key in [k for k in self._chaos_links if name in k]:
                del self._chaos_links[key]
        node.app.stop()
        node.app.clock.stop()
        log.info("sim node %s stopped at lcl %d", name,
                 node.app.ledger_manager.last_closed_ledger_num())

    def _max_virtual_time(self) -> float:
        return max((n.app.clock.now() for n in self.nodes.values()),
                   default=0.0)

    def restart_node(self, name: str) -> SimNode:
        """Bring a stopped node back: a FRESH Application over the same
        Config (same NODE_SEED, DATABASE, BUCKET_DIR_PATH, HISTORY), a new
        virtual clock fast-forwarded to the fleet's time (the close-time
        drift guard must not reject live values), links rewired. With a
        file-backed DATABASE the node resumes from its persisted LCL and
        rejoins via the Herder's out-of-sync recovery + catchup under
        live traffic."""
        node = self.nodes[name]
        assert node.stopped, "restart_node on a running node"
        cfg = node.app.config
        had_buckets = node.app.bucket_manager is not None
        clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        clock.set_virtual_time(self._max_virtual_time())
        app = Application(clock, cfg)
        if had_buckets:
            app.enable_buckets()
        node.app = app
        node.stopped = False
        if self.mode == Simulation.OVER_LOOPBACK:
            self._wire_loopback_shim(node)
            for ch in node.channels:
                ch.enabled = True
        else:
            for (a, b, chaos) in self._peer_links:
                if name in (a, b) and not self.nodes[
                        b if a == name else a].stopped:
                    self._wire_peer_link(a, b, chaos)
        app.start()
        log.info("sim node %s restarted at lcl %d (fleet time %.3f)",
                 name, app.ledger_manager.last_closed_ledger_num(),
                 clock.now())
        return node

    def add_late_node(self, secret: SecretKey, qset: SCPQuorumSet,
                      name: Optional[str] = None,
                      cfg_tweak: Optional[Callable[[Config], None]] = None,
                      connect_to: Optional[List[str]] = None) -> SimNode:
        """Join a node to an already-running network: clock fast-forwarded
        to fleet time, linked to `connect_to` (default: every running
        node), started last so its first act is catching up under live
        traffic."""
        node = self.add_node(secret, qset, name=name, cfg_tweak=cfg_tweak)
        node.app.clock.set_virtual_time(self._max_virtual_time())
        if self.latency_matrix is not None:
            self.latency_matrix.ensure(node.name)
        peers = connect_to if connect_to is not None else [
            n for n in self.nodes
            if n != node.name and not self.nodes[n].stopped]
        for other in peers:
            self.connect(node.name, other)
        node.app.start()
        return node

    # -- message routing ----------------------------------------------------
    def broadcast_from(self, name: str, msg: StellarMessage) -> None:
        for ch in self.nodes[name].channels:
            ch.send(name, msg)

    def _deliver(self, to: str, frm: str, raw: bytes) -> None:
        if self.nodes[to].stopped:
            return  # delivery raced a node stop
        try:
            msg = StellarMessage.from_xdr(raw)
        except Exception:
            return  # damaged message dropped at decode
        app = self.nodes[to].app
        t = msg.disc
        if t == MessageType.SCP_MESSAGE:
            env = msg.value
            # deliver txset dependencies on demand via direct lookup
            app.herder.recv_scp_envelope(env)
            self._satisfy_deps(to, frm, env)
            app.overlay_manager.rebroadcast(msg, frm)
        elif t == MessageType.TRANSACTION:
            from ..transactions.transaction_frame import TransactionFrame
            frame = TransactionFrame.make_from_wire(
                app.config.network_id, msg.value)
            app.herder.recv_transaction(frame)
            app.overlay_manager.rebroadcast(msg, frm)
        elif t == MessageType.TX_SET:
            from ..herder.txset import TxSetFrame
            ts = TxSetFrame.from_wire(app.config.network_id, msg.value)
            app.herder.recv_tx_set(ts.get_contents_hash(), ts)
        elif t == MessageType.SCP_QUORUMSET:
            q = msg.value
            app.herder.recv_scp_quorum_set(sha256(q.to_xdr()), q)

    def _satisfy_deps(self, to: str, frm: str, env) -> None:
        """Loopback dependency resolution: pull missing txsets/qsets
        straight from the sending node's herder caches."""
        to_app = self.nodes[to].app
        frm_app = self.nodes[frm].app
        from ..herder.pending_envelopes import (
            statement_qset_hash, statement_txset_hashes,
        )
        st = env.statement
        qh = statement_qset_hash(st)
        if to_app.herder.pending.get_quorum_set(qh) is None:
            q = frm_app.herder.pending.get_quorum_set(qh)
            if q is not None:
                to_app.herder.recv_scp_quorum_set(qh, q)
        for th in statement_txset_hashes(st):
            if to_app.herder.pending.get_tx_set(th) is None:
                ts = frm_app.herder.pending.get_tx_set(th)
                if ts is not None:
                    to_app.herder.recv_tx_set(th, ts)

    # -- cranking -----------------------------------------------------------
    def crank_all_nodes(self, rounds: int = 1) -> int:
        n = 0
        for _ in range(rounds):
            for node in list(self.nodes.values()):
                if not node.stopped:
                    n += node.app.clock.crank(False)
        return n

    def crank_until(self, pred: Callable[[], bool],
                    max_rounds: int = 5000) -> bool:
        for _ in range(max_rounds):
            if pred():
                return True
            if self.crank_all_nodes(1) == 0:
                # idle: advance every clock to its next timer
                pass
        return pred()

    def have_all_externalized(self, seq: int) -> bool:
        """Every RUNNING node has closed >= seq (stopped nodes are by
        definition behind; churn scenarios assert on the survivors, then
        on the restarted node once it heals)."""
        return all(n.app.ledger_manager.last_closed_ledger_num() >= seq
                   for n in self.nodes.values() if not n.stopped)

    # -- fleet observability (util/fleet.py) --------------------------------
    def fleet(self):
        """FleetAggregator over every node: merged Chrome trace (one
        lane per node) + per-slot cross-node stats. In-process nodes
        share one perf_counter, so no rebasing is needed here."""
        from ..util.fleet import FleetAggregator
        agg = FleetAggregator()
        for name, node in self.nodes.items():
            if not node.stopped:
                agg.add_app(name, node.app)
        return agg

    def merged_chrome_trace(self) -> dict:
        return self.fleet().merged_chrome_trace()

    def fleet_stats(self) -> dict:
        return self.fleet().fleet_stats()

    def stop_all_nodes(self) -> None:
        for n in self.nodes.values():
            if not n.stopped:
                n.app.stop()


class _SimOverlayShim:
    """Minimal OverlayManager stand-in for loopback simulations: floods
    with dedup (reference Floodgate role)."""

    def __init__(self, sim: Simulation, name: str) -> None:
        self.sim = sim
        self.name = name
        self._seen: set = set()

    def broadcast_message(self, msg: StellarMessage,
                          force: bool = False) -> None:
        h = sha256(msg.to_xdr())
        if h in self._seen and not force:
            return
        self._seen.add(h)
        self.sim.broadcast_from(self.name, msg)

    def rebroadcast(self, msg: StellarMessage, exclude: str) -> None:
        h = sha256(msg.to_xdr())
        if h in self._seen:
            return
        self._seen.add(h)
        for ch in self.sim.nodes[self.name].channels:
            to = ch.ends[0] if self.name == ch.ends[1] else ch.ends[1]
            if to != exclude:
                ch.send(self.name, msg)

    def start(self) -> None:
        pass

    def shutdown(self) -> None:
        pass
