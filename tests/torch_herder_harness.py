"""A network of herder nodes in one process, and a relay that stands in
for overlay.

The relay now stands beside the port's real overlay (`overlay/`):
`chip_smoke.py`'s S1 keeps it, so its numbers stand beside O1's, and the
relay-based mixed quorum of `tests/test_torch_herder.py` uses it; O1
does not. O1's `OverlayNet`, at the end of this module, is the relay's
network with the relay taken out: its nodes (`make_port_node`'s, on
whatever verifier and hasher they were handed) each get an
`OverlayManager` and reach each other only over authenticated loopback
peers (`link`), so every envelope, transaction, txset and quorum set
crosses as HMAC'd frames through the floodgate and the item fetchers. It
keeps the relay's crank (each node's ready work, then its verifier's
flush; the clocks moved together only when nothing runs and no verify is
under way) and its slot and hash helpers.

A port node is `torch_catchup_harness.make_port_app`'s namespace app (its
own `LedgerManager` over sqlite, a `BucketManager`, a
`StateCommitmentEngine`, the verifier and hasher it is handed) with a
`Herder` on it. The herder reaches overlay only through
`app.overlay_manager`; the `Relay` puts itself there and, like the
reference's loopback simulation (`stellar_core_tpu/simulation/
simulation.py:369-387`):

- encodes every message a node broadcasts to XDR bytes, floods it once
  (a node's repeat of a message it already sent is dropped, as a
  floodgate drops it) and posts the bytes to every other node's clock;
- decodes them there with the receiving node's own package, so nodes of
  both packages can share a quorum, and hands an envelope to
  `Herder.recv_scp_envelope`;
- satisfies the txsets and quorum sets an envelope names from the
  sender's `herder.pending`, the txsets as XDR bytes too;
- submits a transaction's envelope bytes to one node's
  `recv_transaction` and floods them to every other node's.

The relay's crank runs each node's ready work without moving its clock
(`crank_ready`), then flushes the node's verifier, as `Application.crank`
does; only when no node has work and no verify is queued or in flight
does it move every clock together to the earliest timer of the network,
so a timer never fires while a message or a verify that would have beaten
it is still under way. It imports only the port, so `chip_smoke.py` and
the `cuda`-marked tests can use it where the JAX package is absent.
"""

import time
from collections import Counter

from torch_catchup_harness import make_port_app, stop

from stellar_core_tpu_torch import testing as T
from stellar_core_tpu_torch import xdr as PX
from stellar_core_tpu_torch.crypto.hashing import sha256
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.herder.herder import Herder
from stellar_core_tpu_torch.herder.pending_envelopes import (
    statement_qset_hash, statement_txset_hashes,
)
from stellar_core_tpu_torch.herder.txset import TxSetFrame
from stellar_core_tpu_torch.main.config import Config
from stellar_core_tpu_torch.overlay.overlay_manager import OverlayManager
from stellar_core_tpu_torch.overlay.transport import (
    ChaosTransport, LoopbackTransport,
)
from stellar_core_tpu_torch.transactions.transaction_frame import (
    TransactionFrame,
)
from stellar_core_tpu_torch.util.slot_timeline import SlotTimeline

def node_seed(i: int) -> SecretKey:
    return SecretKey.from_seed(sha256(b"herder-node-%d" % i))


def tier1_qset(X, keys, orgs: int, per_org: int):
    """Pubnet's tier-1 shape over `keys` (orgs x per_org validators, in
    order): an inner set of 2 of each organisation's 3 (a simple
    majority of `per_org` in general), and (2 * orgs + 2) // 3 of the
    organisations (`tests/test_quorum_intersection.py`'s
    `_pubnet_like`)."""
    inner = [X.SCPQuorumSet(threshold=per_org // 2 + 1,
                            validators=list(keys[o * per_org:
                                                 (o + 1) * per_org]),
                            innerSets=[])
             for o in range(orgs)]
    return X.SCPQuorumSet(threshold=(2 * orgs + 2) // 3, validators=[],
                          innerSets=inner)


def flat_qset(X, keys, threshold: int):
    return X.SCPQuorumSet(threshold=threshold, validators=list(keys),
                          innerSets=[])


def node_config(i: int, qset, force_scp: bool,
                max_tx_set_size: int) -> Config:
    """A validator's Config: node seed `i`, the quorum set, manual closes
    (the caller triggers every slot, as `Application.manual_close`
    does), accelerated time, and the genesis max txset size."""
    cfg = Config()
    cfg.NODE_SEED = node_seed(i)
    cfg.QUORUM_SET = qset
    cfg.NODE_IS_VALIDATOR = True
    cfg.FORCE_SCP = force_scp
    cfg.MANUAL_CLOSE = True
    cfg.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = True
    cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE = max_tx_set_size
    return cfg


def make_port_node(bucket_dir, cfg: Config, verifier, hasher, metrics=None):
    """A started port node with a herder and the always-on slot journal
    (64 slots, as the reference's Application keeps); FORCE_SCP
    bootstraps it, as `Application.start` does. `verifier` may be a
    callable that builds the node's verifier from its app (an async stack
    needs the node's clock)."""
    app = make_port_app(bucket_dir, config=cfg, hasher=hasher,
                        metrics=metrics,
                        verifier=None if callable(verifier) else verifier)
    if callable(verifier):
        app.sig_verifier = verifier(app)
    app.slot_timeline = SlotTimeline(now_fn=app.clock.now, max_slots=64)
    app.herder = Herder(app)
    if cfg.FORCE_SCP:
        app.herder.bootstrap()
    return app


class Node:
    """One member of the relay's network: its app and the package it
    decodes with (`X`, `TxSetFrame`, `TransactionFrame`), and, per slot,
    the externalized value and the perf-counter seconds at which the
    herder was handed it and at which its close returned."""

    def __init__(self, relay, name, app, X, TxSetFrame, TransactionFrame):
        self.relay, self.name, self.app = relay, name, app
        self.X, self.TxSetFrame = X, TxSetFrame
        self.TransactionFrame = TransactionFrame
        self.externalized, self.t_ext, self.t_closed = {}, {}, {}
        self.sent = set()
        herder = app.herder
        orig = herder.value_externalized

        def value_externalized(slot_index, value):
            self.t_ext[slot_index] = time.perf_counter()
            self.externalized[slot_index] = bytes(value)
            orig(slot_index, value)
            self.t_closed[slot_index] = time.perf_counter()

        herder.value_externalized = value_externalized

    # -- the overlay surface the herder reaches ---------------------------
    def broadcast_message(self, msg, force: bool = False) -> None:
        self.relay.broadcast(self, msg)


class Relay:
    def __init__(self, network_id: bytes) -> None:
        self.network_id = network_id
        self.nodes = []
        # every SCP envelope flooded: (sender index, slot, XDR bytes)
        self.envelopes = []
        self.advances = 0

    def join(self, name, app, X=PX, TxSetFrame=TxSetFrame,
             TransactionFrame=TransactionFrame) -> Node:
        node = Node(self, name, app, X, TxSetFrame, TransactionFrame)
        app.overlay_manager = node
        app.herder.pending.set_fetchers(None, None)
        self.nodes.append(node)
        return node

    # -- messages ----------------------------------------------------------
    def broadcast(self, sender: Node, msg) -> None:
        raw = msg.to_xdr()
        h = sha256(raw)
        if h in sender.sent:
            return
        sender.sent.add(h)
        idx = self.nodes.index(sender)
        if msg.disc == sender.X.MessageType.SCP_MESSAGE:
            self.envelopes.append((idx, msg.value.statement.slotIndex,
                                   msg.value.to_xdr()))
        for to in self.nodes:
            if to is not sender:
                to.app.clock.post(
                    lambda to=to, raw=raw: self._deliver(to, sender, raw))

    def _deliver(self, to: Node, frm: Node, raw: bytes) -> None:
        msg = to.X.StellarMessage.from_xdr(raw)
        if msg.disc == to.X.MessageType.SCP_MESSAGE:
            to.app.herder.recv_scp_envelope(msg.value)
            self._satisfy_deps(to, frm, msg.value)
        elif msg.disc == to.X.MessageType.TRANSACTION:
            to.app.herder.recv_transaction(
                to.TransactionFrame.make_from_wire(self.network_id,
                                                   msg.value))

    def deliver_envelope(self, to: Node, frm: Node, raw: bytes) -> int:
        """Hand one envelope's XDR bytes to `to`, as if `frm` sent it
        (a forged envelope, for instance); returns the herder's
        EnvelopeState."""
        env = to.X.SCPEnvelope.from_xdr(raw)
        got = to.app.herder.recv_scp_envelope(env)
        self._satisfy_deps(to, frm, env)
        return got

    def _satisfy_deps(self, to: Node, frm: Node, env) -> None:
        """The quorum set and txsets `env` names, from the sender's
        pending caches, crossing as XDR bytes."""
        st = env.statement
        qh = statement_qset_hash(st)
        if to.app.herder.pending.get_quorum_set(qh) is None:
            q = frm.app.herder.pending.get_quorum_set(qh)
            if q is not None:
                to.app.herder.recv_scp_quorum_set(
                    qh, to.X.SCPQuorumSet.from_xdr(q.to_xdr()))
        for th in statement_txset_hashes(st):
            if to.app.herder.pending.get_tx_set(th) is None:
                ts = frm.app.herder.pending.get_tx_set(th)
                if ts is not None:
                    wire = to.X.TransactionSet.from_xdr(
                        ts.to_wire().to_xdr())
                    to.app.herder.recv_tx_set(
                        th, to.TxSetFrame.from_wire(self.network_id, wire))

    def submit(self, first: int, blob: bytes) -> list:
        """A transaction envelope's bytes submitted to node `first`'s
        `recv_transaction`, then flooded to every other node's; the
        statuses in node order."""
        order = self.nodes[first:] + self.nodes[:first]
        got = {}
        for node in order:
            frame = node.TransactionFrame.make_from_wire(
                self.network_id, node.X.TransactionEnvelope.from_xdr(blob))
            got[node.name] = node.app.herder.recv_transaction(frame)
        return [got[n.name] for n in self.nodes]

    # -- cranking ----------------------------------------------------------
    def step(self) -> int:
        n = 0
        for node in self.nodes:
            n += node.app.clock.crank_ready()
            # Application.crank: flush what the crank's handlers enqueued
            node.app.sig_verifier.flush()
        return n

    def verifies_under_way(self) -> bool:
        for node in self.nodes:
            v = node.app.sig_verifier
            if v.pending() or getattr(v, "_inflight", False):
                return True
        return False

    def _advance(self) -> bool:
        """Every clock to the network's earliest live timer."""
        nxt = None
        for node in self.nodes:
            live = [e.when for e in node.app.clock._timers
                    if not e.cancelled]
            if live:
                t = min(live)
                nxt = t if nxt is None else min(nxt, t)
        if nxt is None:
            return False
        for node in self.nodes:
            c = node.app.clock
            c.set_virtual_time(max(c.now(), nxt))
        self.advances += 1
        return True

    def settle(self) -> None:
        """Run every node's ready work, and wait out every verify in
        flight, without moving a clock."""
        while self.step() or self.verifies_under_way():
            time.sleep(0)

    def crank_until(self, pred, max_advances: int = 200,
                    timeout_s: float = 600.0) -> bool:
        deadline = time.perf_counter() + timeout_s
        advances = 0
        while not pred():
            if time.perf_counter() > deadline:
                return False
            if self.step():
                continue
            if self.verifies_under_way():
                time.sleep(0.0002)
                continue
            if advances >= max_advances or not self._advance():
                return pred()
            advances += 1
        return True

    # -- a slot ------------------------------------------------------------
    def trigger(self, seq: int) -> float:
        """Every node's `trigger_next_ledger(seq)` (the manual close);
        returns the perf-counter seconds of the first trigger."""
        t0 = time.perf_counter()
        for node in self.nodes:
            node.app.herder.trigger_next_ledger(seq)
        return t0

    def all_closed(self, seq: int) -> bool:
        return all(n.app.ledger_manager.last_closed_ledger_num() >= seq
                   for n in self.nodes)

    def close_slot(self, seq: int, max_advances: int = 200) -> dict:
        """Trigger slot `seq` on every node and crank until every node
        has closed it. Returns the slot's seconds from the first trigger
        to the last externalize and to the last close, and the envelopes
        flooded for it, the late ones too (`settle`)."""
        e0 = len(self.envelopes)
        t0 = self.trigger(seq)
        ok = self.crank_until(lambda: self.all_closed(seq), max_advances)
        if ok:
            # the slot's late envelopes too, before anything else runs
            self.settle()
        if not ok:
            raise RuntimeError("slot %d did not close on every node (%s)"
                               % (seq, [n.app.ledger_manager
                                        .last_closed_ledger_num()
                                        for n in self.nodes]))
        values = {n.externalized[seq] for n in self.nodes}
        if len(values) != 1:
            raise RuntimeError("slot %d externalized %d values"
                               % (seq, len(values)))
        return {"seq": seq,
                "externalize_s": max(n.t_ext[seq] for n in self.nodes) - t0,
                "close_s": max(n.t_closed[seq] for n in self.nodes) - t0,
                "envelopes": len(self.envelopes) - e0}

    def hashes(self, node: Node) -> tuple:
        """(lcl hash, bucket-list hash, commitment root) of a node."""
        app = node.app
        return (app.ledger_manager.lcl_hash,
                app.bucket_manager.get_hash(),
                app.state_commitment.root)


def value_sig_triples(relay) -> set:
    """The (key, signature, message) triples of the signed values that
    the relayed nominations carry: what `HerderSCPDriver.validate_value`
    checks on the host (`PubKeyUtils.verify_sig`, as the reference
    does)."""
    herder = relay.nodes[0].app.herder
    out = set()
    for _i, _slot, raw in relay.envelopes:
        st = PX.SCPEnvelope.from_xdr(raw).statement
        if st.pledges.disc != PX.SCPStatementType.SCP_ST_NOMINATE:
            continue
        nom = st.pledges.value
        for v in list(nom.votes) + list(nom.accepted):
            sv = PX.StellarValue.from_xdr(v)
            if sv.ext.disc == PX.StellarValueExt.STELLAR_VALUE_SIGNED:
                lcs = sv.ext.value
                out.add((lcs.nodeID.key_bytes, lcs.signature,
                         herder._stellar_value_sign_bytes(sv)))
    return out


class Sites:
    """Launch attribution by call site: `wrap(obj, attr, site)` counts,
    for each call, the growth of `count()` that no nested wrapped call
    claimed."""

    def __init__(self, count) -> None:
        self.count = count
        self.by_site = Counter()
        self._stack = []

    def wrap(self, obj, attr: str, site: str) -> None:
        orig = getattr(obj, attr)

        def wrapped(*a, **kw):
            c0 = self.count()
            self._stack.append(0)
            try:
                return orig(*a, **kw)
            finally:
                inner = self._stack.pop()
                total = self.count() - c0
                self.by_site[site] += total - inner
                if self._stack:
                    self._stack[-1] += total

        setattr(obj, attr, wrapped)


class Traffic:
    """`replay_bench`'s senders (bench.py:339-468) built with the port's
    TestAccount against one node's ledger: `senders` senders, each armed
    with `sigs - 1` extra signers and a medium threshold of `sigs`, every
    key from SecretKey.from_seed; every `corrupt_every`-th payment (0 for
    none) carries one corrupted signature. Transactions come out as
    envelope XDR bytes."""

    def __init__(self, lm, network_id: bytes, root_sk, senders: int,
                 sigs: int, corrupt_every: int = 0) -> None:
        from stellar_core_tpu_torch.xdr import LedgerKey

        class Shim:
            def header(self):
                return lm.root.get_header()

            def seq_num(self, account_id):
                e = lm.root.get_entry(LedgerKey.account(account_id))
                return e.data.value.seqNum if e is not None else 0

        shim = Shim()
        shim.network_id = network_id
        self.root = T.TestAccount(shim, root_sk)
        self.senders = [T.TestAccount(shim, SecretKey.from_seed(
            bytes([7, i & 0xFF] + [11] * 30))) for i in range(senders)]
        self.extra = [[SecretKey.from_seed(bytes([201 + j, i & 0xFF]
                                                 + [7] * 30))
                       for j in range(sigs - 1)] for i in range(senders)]
        self.corrupt_every = corrupt_every
        self.corrupted = set()
        self.k = 0

    def fund(self) -> list:
        r = self.root
        return [r.tx([r.op_create_account(s.account_id, 10 ** 10)
                      for s in self.senders]).envelope_bytes()]

    def arm(self) -> list:
        return [s.tx([s.op_add_signer(k.public_key.key_bytes) for k in ks]
                     + [s.op_set_options(med=len(ks) + 1)]).envelope_bytes()
                for s, ks in zip(self.senders, self.extra)]

    def payments(self, rnd: int) -> list:
        """One payment to the root from every sender, signed by all its
        keys; the amount varies by round so that a rejected payment's
        successor, which reuses its sequence number, has another hash."""
        out = []
        for s, ks in zip(self.senders, self.extra):
            f = s.tx([s.op_payment(self.root.account_id, 1000 + rnd)],
                     extra_signers=ks)
            self.k += 1
            if self.corrupt_every and self.k % self.corrupt_every == 0:
                ds = f.signatures[self.k % len(f.signatures)]
                ds.signature = ds.signature[:9] + bytes(
                    [ds.signature[9] ^ 0x10]) + ds.signature[10:]
                self.corrupted.add(f.full_hash())
            out.append(f.envelope_bytes())
        return out


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


# ----------------------------------------------------------- OverlayNet

class OverlayNet(Relay):
    """`Relay`'s network over the real overlay (see the module
    docstring; `chip_smoke.py`'s O1). `envelopes` lists every SCP
    envelope a node originated (sender index, slot, XDR bytes), as the
    relay's does."""

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
            if msg.disc == PX.MessageType.SCP_MESSAGE and \
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

