"""Fuzz harness: mutated-XDR smoke fuzzing of the two untrusted intake
surfaces.

Copied from `stellar_core_tpu/main/fuzz.py` at commit 1d24590; carry a fix
in either copy to the other. Nothing is left out.

Deliberately different:

- Every entry point takes `backend` (default "cuda-resilient", the card's
  stack; `main/config.py`'s names). `fuzz_tx`, `gen_input` and `run_one`'s
  tx mode build their `TestLedger` on `make_verifier(backend)`;
  `fuzz_overlay` and `run_one`'s overlay mode build their
  `topologies.core(2, 2, mode=OVER_PEERS)` nets on it, so the live
  authenticated peers verify each envelope on the card. Without a card
  and with no CPU named they raise; none falls back to the CPU.
- `built`, where a caller passes a list, collects what each run built
  that owns a verifier (a `TestLedger`, or each node's `Application`), so
  the command line can report the run's launches after it.

While a run fuzzes, `transactions/signature_checker.set_fuzzing_mode`
makes every signature check pass without a verify (reference
`SignatureChecker.cpp:33-35`), so the fuzzer gets past crypto. As in the
reference, `fuzz_tx` sets it around its fuzzing loop (after its corpus is
built) and `run_one` around its whole run, each clearing it in a
`finally`, so the flag is off after every run, one that raises included;
`fuzz_overlay` never sets it. The flag reaches only transaction signature
checks: an SCP envelope's signature is verified by the node's verifier
whatever the flag says.

Role parity: reference AFL harness `src/test/FuzzerImpl.cpp` with `tx` and
`overlay` modes (docs/fuzzing.md; CLI gen-fuzz/fuzz,
CommandLine.cpp:1086-1087). This is an in-process mutational fuzzer
(AFL itself is not part of this stack): deterministic PRNG, byte flips /
truncations / splices over a seed corpus of valid messages, asserting the
node never throws on hostile bytes — malformed input must be REJECTED,
not crash.

Invariant on both paths: every exception type escaping the parse/dispatch
boundary is a bug; XDR decode errors are expected and counted.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ..crypto.batch_verifier import make_verifier
from ..crypto.keys import SecretKey
from ..transactions.signature_checker import set_fuzzing_mode
from ..xdr import TransactionEnvelope


def _mutate(r: random.Random, data: bytes) -> bytes:
    buf = bytearray(data)
    for _ in range(r.randint(1, 8)):
        op = r.randrange(5)
        if not buf:
            buf = bytearray(r.randbytes(r.randint(1, 64)))
            continue
        if op == 0:      # bit flip
            buf[r.randrange(len(buf))] ^= 1 << r.randrange(8)
        elif op == 1:    # byte set
            buf[r.randrange(len(buf))] = r.randrange(256)
        elif op == 2:    # truncate
            buf = buf[:r.randrange(len(buf)) + 1]
        elif op == 3:    # insert junk
            i = r.randrange(len(buf) + 1)
            buf[i:i] = r.randbytes(r.randint(1, 16))
        else:            # interesting 32-bit value splice
            v = r.choice([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
            i = r.randrange(max(1, len(buf) - 3))
            buf[i:i + 4] = v.to_bytes(4, "big")
    return bytes(buf)


def _tx_corpus(led, root) -> List[bytes]:
    """Valid signed envelopes whose source accounts EXIST on the fuzz
    ledger, so unmutated inputs reach apply (and mutated ones exercise
    checkValid/fee/seq/apply, not just the missing-account early-out)."""
    alice = root.create(10**9)
    sponsor = root.create(10**9)
    sk = SecretKey.from_seed(b"\x21" * 32)
    frames = [
        alice.tx([alice.op_payment(root.account_id, 1234)], seq=alice.next_seq()),
        alice.tx([alice.op_create_account(sk.public_key, 10**8)],
                 seq=alice.next_seq()),
        alice.tx([alice.op_manage_data("k", b"v"),
                  alice.op_payment(root.account_id, 1)],
                 seq=alice.next_seq()),
    ]
    # fee-bump envelope: the outer-union decode path mutates differently
    from ..transactions.transaction_frame import FeeBumpTransactionFrame
    from ..xdr import (EnvelopeType, FeeBumpTransaction,
                       FeeBumpTransactionEnvelope, _Ext)
    from ..xdr.transaction import _InnerTxEnvelope
    inner = alice.tx([alice.op_payment(root.account_id, 9)],
                     seq=alice.next_seq())
    fb = FeeBumpTransaction(
        feeSource=sponsor.muxed, fee=1000,
        innerTx=_InnerTxEnvelope(EnvelopeType.ENVELOPE_TYPE_TX,
                                 inner.envelope.value),
        ext=_Ext.v0())
    bump = FeeBumpTransactionFrame(led.network_id, TransactionEnvelope(
        EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP,
        FeeBumpTransactionEnvelope(tx=fb, signatures=[])))
    bump.add_signature(sponsor.sk)
    frames.append(bump)
    return [f.envelope.to_xdr() for f in frames]


def _test_ledger(backend: str, built: Optional[list]):
    """A `TestLedger` verifying on `backend`'s stack, collected in
    `built` where given."""
    from ..testing import TestLedger
    led = TestLedger(verifier=make_verifier(backend))
    if built is not None:
        built.append(led)
    return led


def _overlay_net(backend: str, built: Optional[list]):
    """A started 2-node OVER_PEERS net on `backend`'s stacks, its nodes'
    apps collected in `built` where given."""
    from ..simulation import topologies
    from ..simulation.simulation import Simulation
    sim = topologies.core(2, 2, mode=Simulation.OVER_PEERS,
                          backend=backend)
    if built is not None:
        built.extend(n.app for n in sim.nodes.values())
    sim.start_all_nodes()
    return sim


def fuzz_tx(iterations: int = 10000, seed: int = 1,
            backend: str = "cuda-resilient",
            built: Optional[list] = None) -> Dict[str, int]:
    """Mutated envelope XDR → decode → frame → checkValid+apply on a test
    ledger (reference TransactionFuzzer role)."""
    from ..testing import TestAccount, root_secret_key
    from ..transactions.transaction_frame import TransactionFrame

    r = random.Random(seed)
    led = _test_ledger(backend, built)
    root = TestAccount(led, root_secret_key())
    corpus = _tx_corpus(led, root)
    stats = {"iterations": 0, "decode_rejects": 0, "frame_rejects": 0,
             "applied": 0}
    set_fuzzing_mode(True)
    try:
        for i in range(iterations):
            stats["iterations"] += 1
            if i % 64 == 0:
                # periodically refresh the corpus with a currently-valid
                # payment so the full fee/seq/apply path stays reachable as
                # the fuzz ledger's sequence numbers advance — but never
                # evict the fee-bump seed (last slot), which covers the
                # outer-union decode path
                corpus[i // 64 % (len(corpus) - 1)] = root.tx(
                    [root.op_payment(root.account_id, 1)]).envelope.to_xdr()
            raw = _mutate(r, r.choice(corpus))
            try:
                env = TransactionEnvelope.from_xdr(raw)
            except Exception:
                stats["decode_rejects"] += 1
                continue
            try:
                frame = TransactionFrame.make_from_wire(led.network_id, env)
            except Exception:
                stats["frame_rejects"] += 1
                continue
            # apply_frame runs checkValid + fee/seq + apply with invariants;
            # any uncaught exception here is a crash finding
            if led.apply_frame(frame):
                stats["applied"] += 1
    finally:
        set_fuzzing_mode(False)
    return stats


def _overlay_corpus(sim, peer) -> tuple:
    """(raw wire frames, StellarMessage XDR blobs) captured from an
    authenticated peer's live traffic."""
    frames: List[bytes] = []
    msgs: List[bytes] = []
    orig_send = peer.transport.send_frame
    orig_dispatch = peer._dispatch

    def cap_send(raw: bytes) -> None:
        frames.append(raw)
        orig_send(raw)

    def cap_dispatch(msg) -> None:
        msgs.append(msg.to_xdr())
        orig_dispatch(msg)

    peer.transport.send_frame = cap_send
    peer._dispatch = cap_dispatch
    sim.crank_all_nodes(300)
    peer.transport.send_frame = orig_send
    peer._dispatch = orig_dispatch
    return frames or [b"\x00" * 40], msgs or [b"\x00" * 12]


def fuzz_overlay(iterations: int = 10000, seed: int = 1,
                 backend: str = "cuda-resilient",
                 built: Optional[list] = None) -> Dict[str, int]:
    """Mutated frames into Peer._on_frame on a live authenticated overlay
    connection (reference OverlayFuzzer role): bad MACs, bad XDR, bad
    lengths — the peer may drop, but the node must not throw."""
    r = random.Random(seed)
    sim = _overlay_net(backend, built)
    assert sim.crank_until(
        lambda: all(
            n.app.overlay_manager.get_authenticated_peers_count() >= 1
            for n in sim.nodes.values()), 30000)
    from ..xdr import StellarMessage

    names = list(sim.nodes)
    node = sim.nodes[names[0]]
    om = node.app.overlay_manager
    peer = list(om.authenticated_peers.values())[0]
    frames, msgs = _overlay_corpus(sim, peer)
    stats = {"iterations": 0, "dropped_reconnects": 0, "net_rebuilds": 0,
             "msg_parse_rejects": 0, "handler_errors": 0}

    def rebuild_net():
        nonlocal sim, node, om
        sim = _overlay_net(backend, built)
        sim.crank_until(
            lambda: all(
                n.app.overlay_manager.get_authenticated_peers_count() >= 1
                for n in sim.nodes.values()), 30000)
        names[:] = list(sim.nodes)
        node = sim.nodes[names[0]]
        om = node.app.overlay_manager

    def reconnect() -> bool:
        sim.connect_peers(names[0], names[1])
        sim.crank_until(lambda: bool(om.authenticated_peers), 30000)
        if not om.authenticated_peers:
            # connection state wedged (e.g. stale same-id tiebreak husks
            # after many hostile drops): start a fresh 2-node net
            stats["net_rebuilds"] += 1
            rebuild_net()
        return bool(om.authenticated_peers)

    for i in range(iterations):
        stats["iterations"] += 1
        if i % 8 == 0:
            # frame layer: hostile bytes at the wire — MAC/parse must
            # reject and _on_frame must never raise
            raw = _mutate(r, r.choice(frames))
            peer._on_frame(raw)
            sim.crank_all_nodes(2)
        else:
            # message layer: a well-MAC'd but hostile StellarMessage —
            # the production catch in _on_frame turns handler errors into
            # drops; here we count them (each is a weak-validation signal)
            blob = _mutate(r, r.choice(msgs))
            try:
                msg = StellarMessage.from_xdr(blob)
            except Exception:
                stats["msg_parse_rejects"] += 1
                continue
            try:
                peer._dispatch(msg)
            except Exception:
                stats["handler_errors"] += 1
            sim.crank_all_nodes(2)
        if not om.authenticated_peers:
            stats["dropped_reconnects"] += 1
            if not reconnect():
                break
            peer = list(om.authenticated_peers.values())[0]
    return stats


# -- single-input entry points (reference AFL `fuzz`/`gen-fuzz` contract) ---

def gen_input(mode: str, seed: int = 1,
              backend: str = "cuda-resilient") -> bytes:
    """Produce one mutated corpus input file's bytes (reference
    `gen-fuzz`)."""
    r = random.Random(seed)
    if mode == "tx":
        from ..testing import TestAccount, root_secret_key
        led = _test_ledger(backend, None)
        root = TestAccount(led, root_secret_key())
        return _mutate(r, r.choice(_tx_corpus(led, root)))
    from ..xdr import MessageType, StellarMessage
    msg = StellarMessage(MessageType.GET_SCP_QUORUMSET, b"\x00" * 32)
    return _mutate(r, msg.to_xdr())


def run_one(mode: str, data: bytes, backend: str = "cuda-resilient",
            built: Optional[list] = None) -> Dict[str, int]:
    """Run ONE fuzz input and exit (reference `fuzz` single-input AFL
    contract): decode + dispatch; any escape of the parse boundary is a
    crash finding (exception propagates)."""
    stats = {"iterations": 1, "decode_rejects": 0, "applied": 0,
             "handler_errors": 0}
    set_fuzzing_mode(True)
    try:
        if mode == "tx":
            from ..testing import TestAccount, root_secret_key
            from ..transactions.transaction_frame import TransactionFrame
            led = _test_ledger(backend, built)
            root = TestAccount(led, root_secret_key())
            try:
                env = TransactionEnvelope.from_xdr(data)
                frame = TransactionFrame.make_from_wire(
                    led.network_id, env)
            except Exception:
                stats["decode_rejects"] += 1
                return stats
            if led.apply_frame(frame):
                stats["applied"] += 1
            return stats
        # overlay: decode then DISPATCH through a live authenticated peer,
        # mirroring fuzz_overlay's message-layer path so a crash found
        # there reproduces from its input file
        from ..xdr import StellarMessage
        try:
            msg = StellarMessage.from_xdr(data)
        except Exception:
            stats["decode_rejects"] += 1
            return stats
        sim = _overlay_net(backend, built)
        assert sim.crank_until(
            lambda: all(
                n.app.overlay_manager.get_authenticated_peers_count() >= 1
                for n in sim.nodes.values()), 30000)
        node = sim.nodes[list(sim.nodes)[0]]
        peer = list(node.app.overlay_manager
                    .authenticated_peers.values())[0]
        try:
            peer._dispatch(msg)
        except Exception:
            stats["handler_errors"] += 1
        sim.crank_all_nodes(5)
        return stats
    finally:
        set_fuzzing_mode(False)
