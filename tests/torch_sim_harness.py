"""The reference `Simulation`'s surface over port nodes, and an overlay
network of herder nodes for `chip_smoke.py`.

`simulation/` is not ported yet (ROADMAP Queue 1 item 9); this module is a
stand-in that goes when it is. `Simulation` follows
`stellar_core_tpu/simulation/simulation.py:84-206` and `:250-436`: each
node is the port's `Application` (verifying and hashing on the CPU) on
its own virtual clock,
joined either by the real overlay over in-process pipes (`OVER_PEERS`:
`LoopbackTransport` pairs, wrapped in `ChaosTransport` when asked, each
end attached with `OverlayManager.add_loopback_peer`) or by
message-level loopback channels that hand messages to the herders
(`OVER_LOOPBACK`). `topologies.core` is `simulation/topologies.py:22-40`.
The mirrored tests' sources name these where they name the reference's
(`SIM_SUBS`, for `torch_mirror_harness.Mirror`'s `subs`).

`OverlayNet` is `torch_herder_harness.Relay`'s network with the relay
taken out: its nodes (`make_port_node`'s, on whatever verifier and hasher
they were handed) each get an `OverlayManager` and reach each other only
over authenticated loopback peers (`link`), so every envelope, transaction,
txset and quorum set crosses as HMAC'd frames through the floodgate and
the item fetchers. It keeps the relay's crank (each node's ready work,
then its verifier's flush; the clocks moved together only when nothing
runs and no verify is under way) and its slot and hash helpers. It
imports only the port, so `chip_smoke.py` can use it where the JAX package
is absent.
"""

import os
import sys
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_herder_harness import Node, Relay  # noqa: E402

from stellar_core_tpu_torch.crypto.hashing import sha256  # noqa: E402
from stellar_core_tpu_torch.crypto.keys import SecretKey  # noqa: E402
from stellar_core_tpu_torch.main.application import Application  # noqa: E402,E501
from stellar_core_tpu_torch.main.config import Config  # noqa: E402
from stellar_core_tpu_torch.overlay.overlay_manager import (  # noqa: E402
    OverlayManager,
)
from stellar_core_tpu_torch.overlay.transport import (  # noqa: E402
    ChaosTransport, LoopbackTransport,
)
from stellar_core_tpu_torch.util import rnd  # noqa: E402
from stellar_core_tpu_torch.util.timer import (  # noqa: E402
    ClockMode, VirtualClock,
)
from stellar_core_tpu_torch.xdr import (  # noqa: E402
    MessageType, SCPQuorumSet, StellarMessage,
)

# the `Mirror` source rewrites that give a reference test's port side
# this module's Simulation and topologies
SIM_SUBS = (
    (r"from stellar_core_tpu_torch\.simulation\.simulation import "
     r"Simulation", "from torch_sim_harness import Simulation"),
    (r"from stellar_core_tpu_torch\.simulation import topologies",
     "from torch_sim_harness import topologies"),
)


def link(app_a, app_b, chaos: bool = False):
    """One authenticated overlay link over an in-process pipe: `app_a`
    dials (WE_CALLED_REMOTE), each end owned by and delivering onto its
    own app's clock; with `chaos` each end is wrapped in a ChaosTransport
    driven by its app's fault injector. Returns the two ends."""
    ta, tb = LoopbackTransport.pair(app_a.clock, app_b.clock)
    if chaos:
        ta = ChaosTransport(ta, app_a.clock,
                            faults=getattr(app_a, "faults", None))
        tb = ChaosTransport(tb, app_b.clock,
                            faults=getattr(app_b, "faults", None))
    name_a = getattr(app_a.config, "NODE_NAME", "") or "a"
    name_b = getattr(app_b.config, "NODE_NAME", "") or "b"
    app_b.overlay_manager.add_loopback_peer(tb, outbound=False,
                                            address=(name_a, 0))
    app_a.overlay_manager.add_loopback_peer(ta, outbound=True,
                                            address=(name_b, 0))
    return ta, tb


class LoopbackChannel:
    """Symmetric message pipe between two nodes with optional fault
    injection (reference overlay/test/LoopbackPeer.h:24-94 damage knobs)."""

    def __init__(self, sim: "Simulation", a: str, b: str) -> None:
        self.sim = sim
        self.ends = (a, b)
        self.drop_probability = 0.0
        self.damage_probability = 0.0
        self.enabled = True

    def send(self, from_node: str, msg: StellarMessage) -> None:
        if not self.enabled:
            return
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
        node.app.clock.post(lambda: self.sim._deliver(to, from_node, raw))


class SimNode:
    def __init__(self, name: str, app: Application) -> None:
        self.name = name
        self.app = app
        self.channels: List[LoopbackChannel] = []
        self.stopped = False
        self.cfg_tweak = None


class Simulation:
    OVER_LOOPBACK = 0
    OVER_PEERS = 1

    def __init__(self, mode: int = OVER_LOOPBACK,
                 network_passphrase: str = "(sct) simulation network"
                 ) -> None:
        self.mode = mode
        self.network_passphrase = network_passphrase
        self.nodes: Dict[str, SimNode] = {}
        self._chaos_links: Dict[tuple, tuple] = {}
        self._peer_links: List[tuple] = []

    # -- topology -----------------------------------------------------------
    def add_node(self, secret: SecretKey, qset: SCPQuorumSet,
                 name: Optional[str] = None,
                 cfg_tweak: Optional[Callable[[Config], None]] = None
                 ) -> SimNode:
        name = name or secret.strkey_public()[:5]
        cfg = Config()
        cfg.NETWORK_PASSPHRASE = self.network_passphrase
        cfg.NODE_SEED = secret
        cfg.NODE_NAME = name
        cfg.NODE_IS_VALIDATOR = True
        cfg.QUORUM_SET = qset
        cfg.RUN_STANDALONE = True
        cfg.FORCE_SCP = True
        cfg.MANUAL_CLOSE = False
        cfg.DATABASE = "in-memory"
        cfg.INVARIANT_CHECKS = [".*"]
        cfg.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = True
        # the reference's defaults; the port's Config names the card
        cfg.SIG_VERIFY_BACKEND = cfg.HASH_BACKEND = "cpu"
        if cfg_tweak:
            cfg_tweak(cfg)
        app = Application(VirtualClock(ClockMode.VIRTUAL_TIME), cfg)
        node = SimNode(name, app)
        node.cfg_tweak = cfg_tweak
        self.nodes[name] = node
        if self.mode == Simulation.OVER_LOOPBACK:
            self._wire_loopback_shim(node)
        return node

    def _wire_loopback_shim(self, node: SimNode) -> None:
        node.app.overlay_manager = _SimOverlayShim(self, node.name)
        node.app.herder.pending.set_fetchers(None, None)

    def connect(self, a: str, b: str):
        if self.mode == Simulation.OVER_PEERS:
            return self.connect_peers(a, b)
        ch = LoopbackChannel(self, a, b)
        self.nodes[a].channels.append(ch)
        self.nodes[b].channels.append(ch)
        return ch

    def connect_peers(self, a: str, b: str, chaos: bool = False):
        """Real overlay connection over an in-process pipe (`link`);
        with chaos=True the pair is registered for `set_partition`."""
        if (a, b, chaos) not in self._peer_links:
            self._peer_links.append((a, b, chaos))
        return self._wire_peer_link(a, b, chaos)

    def reconnect_peers(self, a: str, b: str, chaos: bool = False):
        """Drop any stale Peer pair between `a` and `b` and wire a fresh
        link (fresh handshake, fresh MAC chain)."""
        app_a = self.nodes[a].app
        app_b = self.nodes[b].app
        for app, other in ((app_a, app_b), (app_b, app_a)):
            peer = app.overlay_manager.get_peer(
                other.config.node_id().to_xdr())
            if peer is not None:
                peer.drop("partition healed: reconnecting")
        return self.connect_peers(a, b, chaos)

    def _wire_peer_link(self, a: str, b: str, chaos: bool):
        ta, tb = link(self.nodes[a].app, self.nodes[b].app, chaos)
        if chaos:
            self._chaos_links[tuple(sorted((a, b)))] = (ta, tb)
        return ta, tb

    # -- chaos ---------------------------------------------------------------
    def set_partition(self, a: str, b: str, on: bool = True) -> None:
        if self.mode == Simulation.OVER_PEERS:
            pair = self._chaos_links.get(tuple(sorted((a, b))))
            assert pair is not None, \
                "partition needs connect_peers(..., chaos=True)"
            for t in pair:
                t.set_partitioned(on)
            return
        for ch in self.nodes[a].channels:
            if set(ch.ends) == {a, b}:
                ch.enabled = not on

    def heal_partition(self, a: str, b: str) -> None:
        self.set_partition(a, b, on=False)

    # -- node lifecycle -----------------------------------------------------
    def start_all_nodes(self) -> None:
        for node in self.nodes.values():
            if not node.stopped:
                node.app.start()

    def stop_node(self, name: str) -> None:
        node = self.nodes[name]
        if node.stopped:
            return
        node.stopped = True
        for ch in node.channels:
            ch.enabled = False
        for key in [k for k in self._chaos_links if name in k]:
            del self._chaos_links[key]
        node.app.stop()
        node.app.clock.stop()

    def restart_node(self, name: str) -> SimNode:
        """A fresh Application over the stopped node's Config, its clock
        fast-forwarded to the fleet's time, its links rewired."""
        node = self.nodes[name]
        assert node.stopped, "restart_node on a running node"
        clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        clock.set_virtual_time(max(n.app.clock.now()
                                   for n in self.nodes.values()))
        node.app = Application(clock, node.app.config)
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
        node.app.start()
        return node

    def stop_all_nodes(self) -> None:
        for n in self.nodes.values():
            if not n.stopped:
                n.app.stop()

    # -- message routing (OVER_LOOPBACK) -------------------------------------
    def broadcast_from(self, name: str, msg: StellarMessage) -> None:
        for ch in self.nodes[name].channels:
            ch.send(name, msg)

    def _deliver(self, to: str, frm: str, raw: bytes) -> None:
        if self.nodes[to].stopped:
            return
        try:
            msg = StellarMessage.from_xdr(raw)
        except Exception:
            return  # damaged message dropped at decode
        app = self.nodes[to].app
        t = msg.disc
        if t == MessageType.SCP_MESSAGE:
            app.herder.recv_scp_envelope(msg.value)
            self._satisfy_deps(to, frm, msg.value)
            app.overlay_manager.rebroadcast(msg, frm)
        elif t == MessageType.TRANSACTION:
            from stellar_core_tpu_torch.transactions.transaction_frame \
                import TransactionFrame
            app.herder.recv_transaction(TransactionFrame.make_from_wire(
                app.config.network_id, msg.value))
            app.overlay_manager.rebroadcast(msg, frm)

    def _satisfy_deps(self, to: str, frm: str, env) -> None:
        from stellar_core_tpu_torch.herder.pending_envelopes import (
            statement_qset_hash, statement_txset_hashes,
        )
        to_h = self.nodes[to].app.herder
        frm_h = self.nodes[frm].app.herder
        st = env.statement
        qh = statement_qset_hash(st)
        if to_h.pending.get_quorum_set(qh) is None:
            q = frm_h.pending.get_quorum_set(qh)
            if q is not None:
                to_h.recv_scp_quorum_set(qh, q)
        for th in statement_txset_hashes(st):
            if to_h.pending.get_tx_set(th) is None:
                ts = frm_h.pending.get_tx_set(th)
                if ts is not None:
                    to_h.recv_tx_set(th, ts)

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
            self.crank_all_nodes(1)
        return pred()

    def have_all_externalized(self, seq: int) -> bool:
        return all(n.app.ledger_manager.last_closed_ledger_num() >= seq
                   for n in self.nodes.values() if not n.stopped)

    # -- fleet observability (util/fleet.py) --------------------------------
    def fleet(self):
        from stellar_core_tpu_torch.util.fleet import FleetAggregator
        agg = FleetAggregator()
        for name, node in self.nodes.items():
            if not node.stopped:
                agg.add_app(name, node.app)
        return agg

    def merged_chrome_trace(self) -> dict:
        return self.fleet().merged_chrome_trace()

    def fleet_stats(self) -> dict:
        return self.fleet().fleet_stats()


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


def _keys(n: int, tag: bytes) -> List[SecretKey]:
    return [SecretKey.from_seed(sha256(tag + bytes([i])))
            for i in range(n)]


def _core(n: int, threshold: int,
          passphrase: str = "(sct) simulation network",
          mode: int = Simulation.OVER_LOOPBACK,
          cfg_tweak=None) -> Simulation:
    """Fully-connected core of n validators all trusting each other."""
    sim = Simulation(mode=mode, network_passphrase=passphrase)
    keys = _keys(n, b"core")
    qset = SCPQuorumSet(threshold=threshold,
                        validators=[k.public_key for k in keys],
                        innerSets=[])
    names = [sim.add_node(k, qset, cfg_tweak=cfg_tweak).name for k in keys]
    for i in range(n):
        for j in range(i + 1, n):
            sim.connect(names[i], names[j])
    return sim


topologies = SimpleNamespace(core=_core)


# ----------------------------------------------------------- OverlayNet

class OverlayNet(Relay):
    """`Relay`'s network over the real overlay (see the module
    docstring). `envelopes` lists every SCP envelope a node originated
    (sender index, slot, XDR bytes), as the relay's does."""

    def __init__(self, network_id: bytes) -> None:
        super().__init__(network_id)
        self.links = []

    def join(self, name, app, **_kw) -> Node:
        node = Node(self, name, app, *self._package())
        app.overlay_manager = OverlayManager(app)
        om = app.overlay_manager
        idx = len(self.nodes)
        self_id = app.config.node_id()
        broadcast = om.broadcast_message

        def broadcast_message(msg, force=False):
            if msg.disc == MessageType.SCP_MESSAGE and \
                    msg.value.statement.nodeID == self_id:
                raw = msg.value.to_xdr()
                if raw not in node.sent:
                    node.sent.add(raw)
                    self.envelopes.append(
                        (idx, msg.value.statement.slotIndex, raw))
            return broadcast(msg, force)

        om.broadcast_message = broadcast_message
        self.nodes.append(node)
        return node

    @staticmethod
    def _package():
        from stellar_core_tpu_torch import xdr as X
        from stellar_core_tpu_torch.herder.txset import TxSetFrame
        from stellar_core_tpu_torch.transactions.transaction_frame import (
            TransactionFrame,
        )
        return X, TxSetFrame, TransactionFrame

    def link(self, i: int, j: int):
        """Node i dials node j over an in-process pipe."""
        self.links.append((i, j))
        return link(self.nodes[i].app, self.nodes[j].app)

    def authenticated(self) -> bool:
        """Every link authenticated on both ends, and no peer pending."""
        for i, j in self.links:
            for a, b in ((i, j), (j, i)):
                p = self.peer(a, b)
                if p is None or not p.is_authenticated():
                    return False
        return not any(n.app.overlay_manager.pending_peers
                       for n in self.nodes)

    def submit(self, first: int, blob: bytes) -> int:
        """A transaction envelope's bytes submitted at node `first`, as
        `Application.submit_transaction` does: its herder's
        `recv_transaction`, and a flood through its overlay when that
        accepts it (status 0). Returns the status."""
        node = self.nodes[first]
        X = node.X
        frame = node.TransactionFrame.make_from_wire(
            self.network_id, X.TransactionEnvelope.from_xdr(blob))
        status = node.app.herder.recv_transaction(frame)
        if status == 0:
            node.app.overlay_manager.broadcast_message(
                X.StellarMessage(X.MessageType.TRANSACTION, frame.envelope),
                False)
        return status

    def peer(self, i: int, j: int):
        """Node i's authenticated peer for node j."""
        key = self.nodes[j].app.config.node_id().to_xdr()
        return self.nodes[i].app.overlay_manager.get_peer(key)

    def stop(self) -> None:
        for node in self.nodes:
            node.app.overlay_manager.shutdown()

