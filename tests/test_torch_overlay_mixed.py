"""A mixed network over the real overlay: two reference validators (the
JAX package's `Simulation` in peer mode) and two port validators (the
port's own `simulation/simulation.py` `Simulation`, on the CPU), each
quorum 3 of the 4.

Every pair of validators is joined by an in-process pipe whose two ends
belong to the two nodes' own packages: each end is its package's
`LoopbackTransport`, and the pair is joined through `other`, which both
packages only duck-type, so nothing but frame bytes crosses between them
(`overlay/transport.py:58-125` in either package). Each end is attached
with its own `OverlayManager.add_loopback_peer`, so every link runs the
full Hello/Auth handshake across packages: X25519 through the
reference's `curve25519` on one side and the port's on the other, the
same MAC keys on both ends. Three ledgers externalize with the same
header hash on all four nodes at every height; a transaction submitted at
a port node applies on the reference nodes, and one submitted at a
reference node applies on the port nodes. The relay-based mixed quorum
of `tests/test_torch_herder.py` stays beside this one. Tolerance: none.
"""

from stellar_core_tpu import xdr as RX
from stellar_core_tpu.crypto.hashing import sha256
from stellar_core_tpu.crypto.keys import SecretKey as RSecretKey
from stellar_core_tpu.overlay.transport import (
    LoopbackTransport as RLoopback,
)
from stellar_core_tpu.simulation.simulation import (
    Simulation as RSimulation,
)
from stellar_core_tpu.testing import AppLedgerAdapter as RAdapter
from stellar_core_tpu_torch import xdr as PX
from stellar_core_tpu_torch.crypto.keys import SecretKey as PSecretKey  # noqa: E501
from stellar_core_tpu_torch.testing import AppLedgerAdapter as PAdapter  # noqa: E501
from stellar_core_tpu_torch.overlay.transport import (
    LoopbackTransport as PLoopback,
)
from stellar_core_tpu_torch.simulation.simulation import (
    Simulation as PSimulation,
)

PASSPHRASE = "(sct) mixed overlay network"


def _network():
    seeds = [sha256(b"mixed-overlay-%d" % i) for i in range(4)]
    rsim = RSimulation(RSimulation.OVER_PEERS, PASSPHRASE)
    psim = PSimulation(PSimulation.OVER_PEERS, PASSPHRASE, backend="cpu")
    rkeys = [RSecretKey.from_seed(s) for s in seeds]
    pkeys = [PSecretKey.from_seed(s) for s in seeds]
    rq = RX.SCPQuorumSet(threshold=3, innerSets=[],
                         validators=[k.public_key for k in rkeys])
    pq = PX.SCPQuorumSet(threshold=3, innerSets=[],
                         validators=[k.public_key for k in pkeys])
    nodes = [rsim.add_node(rkeys[0], rq, name="r0"),
             rsim.add_node(rkeys[1], rq, name="r1"),
             psim.add_node(pkeys[2], pq, name="p2"),
             psim.add_node(pkeys[3], pq, name="p3")]
    for i in range(4):
        for j in range(i + 1, 4):
            a, b = nodes[i], nodes[j]
            ta = (RLoopback if i < 2 else PLoopback)(a.app.clock)
            tb = (RLoopback if j < 2 else PLoopback)(b.app.clock)
            ta.other, tb.other = tb, ta
            b.app.overlay_manager.add_loopback_peer(
                tb, outbound=False, address=(a.name, 0))
            a.app.overlay_manager.add_loopback_peer(
                ta, outbound=True, address=(b.name, 0))
    return rsim, psim, nodes


def _crank_until(sims, pred, rounds: int = 40000) -> bool:
    for _ in range(rounds):
        if pred():
            return True
        for sim in sims:
            sim.crank_all_nodes(1)
    return pred()


def _record_hashes(nodes) -> dict:
    """seq -> {node name: ledger hash}, filled by every close."""
    seen: dict = {}
    for node in nodes:
        lm = node.app.ledger_manager
        orig = lm.value_externalized

        def value_externalized(lcd, lm=lm, orig=orig, name=node.name):
            orig(lcd)
            seen.setdefault(lcd.ledger_seq, {})[name] = lm.lcl_hash

        lm.value_externalized = value_externalized
    return seen


def _everywhere(nodes, key_bytes: bytes):
    """True when every node's ledger holds the account, read with the
    node's own package."""
    def pred():
        for i, n in enumerate(nodes):
            X = RX if i < 2 else PX
            key = X.LedgerKey.account(X.PublicKey.ed25519(key_bytes))
            if n.app.ledger_manager.ltx_root().get_entry(key) is None:
                return False
        return True
    return pred


def test_mixed_overlay_network_agrees_and_carries_transactions():
    rsim, psim, nodes = _network()
    sims = (rsim, psim)
    hashes = _record_hashes(nodes)
    for sim in sims:
        sim.start_all_nodes()

    def all_authenticated():
        return all(n.app.overlay_manager.get_authenticated_peers_count()
                   == 3 for n in nodes)

    assert _crank_until(sims, all_authenticated, 2000)
    for n in nodes:
        om = n.app.overlay_manager
        assert not om.pending_peers
        for p in om.authenticated_peers.values():
            # the two ends of every link, in two packages, agree on keys
            other = next(m for m in nodes
                         if m.app.config.node_id().key_bytes
                         == p.peer_id.key_bytes)
            back = other.app.overlay_manager.get_peer(
                n.app.config.node_id().to_xdr())
            assert p.send_mac_key == back.recv_mac_key
            assert p.recv_mac_key == back.send_mac_key

    def closed(seq):
        return lambda: all(
            n.app.ledger_manager.last_closed_ledger_num() >= seq
            for n in nodes)

    assert _crank_until(sims, closed(4))
    for seq in range(2, 5):
        assert len(hashes[seq]) == 4
        assert len(set(hashes[seq].values())) == 1, (seq, hashes[seq])

    # a transaction at a port node applies at the reference nodes
    p2 = nodes[2]
    proot = PAdapter(p2.app).root_account()
    alice = PSecretKey.from_seed(sha256(b"mixed-alice"))
    frame = proot.tx([proot.op_create_account(alice.public_key, 10 ** 9)])
    assert p2.app.submit_transaction(frame) == 0
    assert _crank_until(sims, _everywhere(nodes, alice.public_key.key_bytes))

    # and one at a reference node applies at the port nodes
    r0 = nodes[0]
    rroot = RAdapter(r0.app).root_account()
    bob = RSecretKey.from_seed(sha256(b"mixed-bob"))
    frame = rroot.tx([rroot.op_create_account(bob.public_key, 10 ** 9)])
    assert r0.app.submit_transaction(frame) == 0
    assert _crank_until(sims, _everywhere(nodes, bob.public_key.key_bytes))

    top = min(n.app.ledger_manager.last_closed_ledger_num() for n in nodes)
    for seq in range(2, top + 1):
        assert len(set(hashes[seq].values())) == 1, (seq, hashes[seq])
    for sim in sims:
        sim.stop_all_nodes()
