"""The port's herder (`stellar_core_tpu_torch/herder/`) and the modules
around it held against the JAX package's.

- The reference's own cases, each run on both packages from one source
  (`torch_mirror_harness.Mirror`), every call that carries a decision
  recorded on both sides and the two records equal: `tests/
  test_tx_queue.py` and `test_surge_pricing.py` (each admission's
  status, each txset built, surged or trimmed, by full hash), every case
  of `test_quorum_intersection.py` (each checker's verdict, quorums seen
  and split, each tracker expansion, each critical-group scan), of
  `test_ingress.py` (each admission decision and retry hint, each pump,
  each `to_json`) and of `test_slot_timeline.py` (each record's outcome,
  each journal read with its perf-counter stamps left out). Their
  Application cases (the background quorum checks, `tight_app`, the
  standalone node's journal, the loopback simulation) run on the port's
  own `main/application.py` and `simulation/`, on the CPU
  (`torch_sim_harness.SIM_SUBS`). The reference's verifier-less
  queues and sets get the C verifier on both sides (the port's raise
  without one).
- Twin networks: four reference herder nodes (the reference's
  `Application`) and four port herder nodes, same seeds, same 3-of-4
  quorum, the same transactions as bytes, each network over the relay of
  `torch_herder_harness.py`, five slots: the envelopes flooded (XDR
  bytes, in order), the values externalized, each node's header,
  bucket-list and commitment hashes, SCP history rows, and the public
  read-outs of `ScpStats`, `TxLifecycle`, `TxIngress`, `SlotTimeline`
  and `PendingEnvelopes` equal node for node.
- A mixed quorum: two reference and two port nodes in one 3-of-4 quorum,
  envelopes, transactions, txsets and quorum sets crossing as XDR bytes,
  five slots with a few transactions: every node's hashes equal at every
  height, and each slot's SCP history rows hold the same envelope bytes
  on both packages.
- No fallback: the herder and the queue raise TypeError without a
  verifier, and a failing drain fails the envelope and the admission
  with nothing verified on the CPU.
- The txset validity cache, a deliberate difference (ROADMAP Queue 3
  item 11): over the twin networks' slots each port node checks a
  nominated txset against its LCL once, where the reference checks it
  again at each nomination that carries it, and both externalize the
  same values.
"""

import hashlib
import os
import sys

import pytest

import stellar_core_tpu.xdr as RX
import stellar_core_tpu_torch.xdr as PX
from stellar_core_tpu.crypto.keys import SecretKey as RSecretKey
from stellar_core_tpu.herder.txset import TxSetFrame as RTxSetFrame
from stellar_core_tpu.main.application import Application as RApplication
from stellar_core_tpu.main.config import Config as RConfig
from stellar_core_tpu.transactions.transaction_frame import (
    TransactionFrame as RTransactionFrame,
)
from stellar_core_tpu.util.timer import (
    ClockMode as RClockMode, VirtualClock as RVirtualClock,
)
from stellar_core_tpu_torch.crypto import keys as PK
from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
from stellar_core_tpu_torch.crypto.batch_verifier import (
    CpuSigVerifier, CudaSigVerifier,
)
from stellar_core_tpu_torch.herder.herder import Herder
from stellar_core_tpu_torch.herder.tx_queue import (
    TransactionQueue, TxQueueResult,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_herder_harness as H  # noqa: E402
from torch_mirror_harness import Mirror, record_calls  # noqa: E402
from torch_sim_harness import SIM_SUBS  # noqa: E402

# --------------------------------------------------------------- mirrors

VERIFIER_SUBS = (
    (r"(?m)^import pytest$",
     "import pytest\nfrom {pkg}.crypto.batch_verifier import "
     "CpuSigVerifier"),
    (r"verifier=None", "verifier=CpuSigVerifier()"),
    (r"TransactionQueue\(_LM\(led\)\)",
     "TransactionQueue(_LM(led), verifier=CpuSigVerifier())"),
    (r"(check_or_trim\([^,]+,\s*)None", r"\1CpuSigVerifier()"),
    (r"TestLedger\(\)", "TestLedger(verifier=CpuSigVerifier())"),
    (r"TestLedger\(ledger_version=",
     "TestLedger(verifier=CpuSigVerifier(), ledger_version="),
)


def _hashes(frames) -> list:
    return [f.full_hash() for f in frames]


def _record_txq(pkg, log):
    tq = __import__(pkg + ".herder.tx_queue", fromlist=["x"])
    ts = __import__(pkg + ".herder.txset", fromlist=["x"])
    return record_calls(log, [
        (tq.TransactionQueue, "try_add", lambda out, q, f: (
            out, f.full_hash())),
        (tq.TransactionQueue, "to_txset", lambda out, *a: _hashes(
            out.frames)),
        (tq.TransactionQueue, "ban", lambda out, q, hs: list(hs)),
        (ts.TxSetFrame, "surge_pricing_filter", lambda out, s, h: _hashes(
            s.frames)),
        (ts.TxSetFrame, "check_or_trim", lambda out, *a, **kw: (
            out[0], _hashes(out[1]))),
    ])


def _split(s) -> list:
    return [sorted(x.hex() for x in side) for side in s] if s else None


def _record_qi(pkg, log):
    qi = __import__(pkg + ".herder.quorum_intersection", fromlist=["x"])
    return record_calls(log, [
        (qi.QuorumIntersectionChecker, "network_enjoys_quorum_intersection",
         lambda out, c: (out, c.quorums_seen, _split(c.last_split))),
        (qi.QuorumTracker, "expand", lambda out, t, n, q: (
            out, sorted(k.hex() for k in t.get_quorum()))),
        (qi, "intersection_critical_groups", lambda out, *a, **kw: sorted(
            sorted(x.hex() for x in g) for g in out)),
    ])


def _record_ingress(pkg, log):
    ing = __import__(pkg + ".herder.ingress", fromlist=["x"])
    return record_calls(log, [
        (ing.TxIngress, "admit_source", lambda out, *a, **kw: out),
        (ing.TxIngress, "pump", lambda out, *a, **kw: out),
        (ing.TxIngress, "to_json", lambda out, *a: out),
    ])


def _no_pc(evs) -> list:
    return [{k: v for k, v in e.items() if k != "pc"} for e in evs]


def _record_timeline(pkg, log):
    st = __import__(pkg + ".util.slot_timeline", fromlist=["x"])
    return record_calls(log, [
        (st.SlotTimeline, "record", lambda out, *a, **kw: (out, a[1:],
                                                            kw)),
        (st.SlotTimeline, "events", lambda out, *a: _no_pc(out)),
        (st.SlotTimeline, "first", lambda out, *a: _no_pc(
            [out] if out else [])),
    ])


TXQ = Mirror(("test_tx_queue.py", "test_surge_pricing.py"),
             patch=_record_txq, subs=VERIFIER_SUBS)
# the Application cases (a standalone node, `tight_app`, the simulation
# case) run on the port's own Application and `simulation/`, on the CPU
QI = Mirror(("test_quorum_intersection.py",), patch=_record_qi,
            port_subs=SIM_SUBS)
ING = Mirror(("test_ingress.py",), patch=_record_ingress,
             port_subs=SIM_SUBS)
TL = Mirror(("test_slot_timeline.py",), patch=_record_timeline)
MIRRORS = {
    "txq": (TXQ, TXQ.cases()),
    "qi": (QI, QI.cases()),
    "ingress": (ING, ING.cases()),
    "timeline": (TL, TL.cases()),
}
MIRROR_CASES = [(k, c) for k, (_m, cs) in MIRRORS.items() for c in cs]


def test_mirrored_cases_collected():
    n = {k: len(cs) for k, (_m, cs) in MIRRORS.items()}
    assert n == {"txq": 21, "qi": 20, "ingress": 15, "timeline": 10}


@pytest.mark.parametrize("which,case", MIRROR_CASES,
                         ids=["%s-%s" % (k, Mirror.case_id(c))
                              for k, c in MIRROR_CASES])
def test_port_equals_reference(which, case, tmp_path):
    mirror = MIRRORS[which][0]
    ref = mirror.run("ref", case, {"tmp_path": tmp_path / "ref"})
    port = mirror.run("port", case, {"tmp_path": tmp_path / "port"})
    assert port == ref


# ------------------------------------------------------------- networks

MAX_TX_SET = 1000
SLOTS = range(2, 7)          # fund, arm, three slots of payments


def ref_node(relay, i: int, qset_xdr: bytes, tmp_path, force: bool):
    """A reference herder node: the reference's Application over sqlite,
    wired to `relay` as the loopback simulation wires one."""
    cfg = RConfig()
    cfg.NODE_SEED = RSecretKey.from_seed(H.node_seed(i).seed)
    cfg.QUORUM_SET = RX.SCPQuorumSet.from_xdr(qset_xdr)
    cfg.NODE_IS_VALIDATOR = True
    cfg.RUN_STANDALONE = True
    cfg.FORCE_SCP = force
    cfg.MANUAL_CLOSE = True
    cfg.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = True
    cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE = MAX_TX_SET
    cfg.DATABASE = "sqlite3://:memory:"
    app = RApplication(RVirtualClock(RClockMode.VIRTUAL_TIME), cfg)
    app.enable_buckets(str(tmp_path / ("ref-%d" % i)))
    app.start()
    return relay.join("ref%d" % i, app, RX, RTxSetFrame, RTransactionFrame)


def port_node(relay, i: int, qset_xdr: bytes, tmp_path, force: bool,
              verifier=None):
    cfg = H.node_config(i, PX.SCPQuorumSet.from_xdr(qset_xdr), force,
                        MAX_TX_SET)
    app = H.make_port_node(tmp_path / ("port-%d" % i), cfg,
                           verifier or CpuSigVerifier(), make_hasher("cpu"))
    return relay.join("port%d" % i, app)


def qset_xdr(n: int, threshold: int) -> bytes:
    keys = [H.node_seed(i).public_key for i in range(n)]
    return H.flat_qset(PX, keys, threshold).to_xdr()


def network(kinds: str, tmp_path, made: list):
    """A relay over nodes of the kinds named ("r" reference, "p" port),
    node 0 forcing SCP, all in one 3-of-4 (or n-1-of-n) quorum; appended
    to `made` for `stop_networks`."""
    q = qset_xdr(len(kinds), len(kinds) - 1)
    relay = H.Relay(H.node_config(0, None, False, 0).network_id)
    made.append(relay)
    for i, k in enumerate(kinds):
        (ref_node if k == "r" else port_node)(relay, i, q, tmp_path,
                                              i == 0)
    return relay


@pytest.fixture
def networks():
    """The relays a test builds; their nodes' merge pools, subprocess
    runners and databases stopped after it."""
    made = []
    yield made
    for relay in made:
        for n in relay.nodes:
            if n.X is PX:
                H.stop(n.app)
            else:
                n.app.process_manager.shutdown()
                n.app.bucket_manager.shutdown()
                n.app.database.close()


def port_traffic(relay):
    node = next(n for n in relay.nodes if n.X is PX)
    return H.Traffic(node.app.ledger_manager, relay.network_id,
                     node.app.network_root_key(), senders=4, sigs=2,
                     corrupt_every=5)


def slot_blobs(tr, seq: int) -> list:
    return tr.fund() if seq == 2 else tr.arm() if seq == 3 \
        else tr.payments(seq)


def scp_rows(node, seq: int) -> list:
    db = node.app.database
    return sorted(r[0] for r in db.execute(
        "SELECT envelope FROM scphistory WHERE ledgerseq = ?", (seq,)))


def qset_rows(node) -> list:
    return sorted(tuple(r) for r in node.app.database.execute(
        "SELECT qsethash, lastledgerseq, qset FROM scpquorums"))


def readouts(node) -> dict:
    """The public read-outs of a node's herder modules, with the slot
    journal's perf-counter stamps left out."""
    h = node.app.herder
    tl = node.app.slot_timeline.to_json()
    for evs in tl["slots"].values():
        for e in evs:
            e.pop("pc", None)
    return {"scp_stats": h.scp_stats.to_json(),
            "lifecycle": h.tx_lifecycle.to_json(),
            "ingress": h.ingress.to_json(),
            "timeline": tl,
            "herder": h.get_json_info(),
            "pending": pending_state(h.pending)}


def pending_state(p) -> dict:
    out = {"txsets": sorted(p.txsets), "qsets": sorted(p.qsets),
           "fetching": {s: [e.to_xdr() for e in es]
                        for s, es in sorted(p.fetching.items())}}
    for k in ("processed", "discarded", "verifying"):
        out[k] = {s: sorted(v) for s, v in sorted(getattr(p, k).items())}
    return out


def forged(raw: bytes) -> bytes:
    """An envelope's XDR with one byte of its signature (the tail)
    flipped."""
    return raw[:-5] + bytes([raw[-5] ^ 0x01]) + raw[-4:]


def test_twin_networks_equal(tmp_path, networks):
    """Four reference nodes and four port nodes, the same transactions:
    the same envelopes in the same order, the same values, hashes, SCP
    history rows and read-outs, node for node."""
    ref = network("rrrr", tmp_path / "r", networks)
    port = network("pppp", tmp_path / "p", networks)
    tr = port_traffic(port)
    for seq in SLOTS:
        for k, blob in enumerate(slot_blobs(tr, seq)):
            assert ref.submit(k % 4, blob) == port.submit(k % 4, blob)
        r, p = ref.close_slot(seq), port.close_slot(seq)
        assert r["envelopes"] == p["envelopes"] > 0
        if seq == 4:
            # a forged copy of node 0's last envelope, to nodes 1 and 2:
            # both packages refuse it on its signature
            bad = forged(port.envelopes[-1][2])
            assert port.envelopes[-1] == ref.envelopes[-1]
            for net in (ref, port):
                for i in (1, 2):
                    got = net.deliver_envelope(net.nodes[i], net.nodes[0],
                                               bad)
                    assert got == 0     # SCP.EnvelopeState.INVALID
                    assert hashlib.sha256(bad).digest() in \
                        net.nodes[i].app.herder.pending.discarded[4]
        for a, b in zip(ref.nodes, port.nodes):
            assert a.externalized[seq] == b.externalized[seq]
            assert ref.hashes(a) == port.hashes(b)
            assert scp_rows(a, seq) == scp_rows(b, seq)
    assert ref.envelopes == port.envelopes
    assert ref.advances == port.advances
    for a, b in zip(ref.nodes, port.nodes):
        assert qset_rows(a) == qset_rows(b)
        assert readouts(a) == readouts(b)


def test_mixed_quorum(tmp_path, networks):
    """Two reference and two port nodes in one 3-of-4 quorum: every
    node's hashes equal at every height and every transaction decided
    alike; and each node's SCP history rows for a slot are the envelope
    bytes that the node in its place writes in an all-reference network
    run beside it on the same transactions."""
    relay = network("rprp", tmp_path / "m", networks)
    ref = network("rrrr", tmp_path / "r", networks)
    tr = port_traffic(relay)
    for seq in SLOTS:
        for k, blob in enumerate(slot_blobs(tr, seq)):
            got = relay.submit(k % 4, blob)
            assert len(set(got)) == 1 and ref.submit(k % 4, blob) == got
        relay.close_slot(seq)
        ref.close_slot(seq)
        assert len({relay.hashes(n) for n in relay.nodes}) == 1
        for a, b in zip(relay.nodes, ref.nodes):
            assert relay.hashes(a) == ref.hashes(b)
            assert scp_rows(a, seq) == scp_rows(b, seq) != []
    assert relay.envelopes == ref.envelopes
    assert tr.corrupted
    assert relay.nodes[1].app.ledger_manager.last_closed_ledger_num() == 6


# ------------------------------------------------------------ no fallback

class _Lm:
    """The ledger surface a TransactionQueue reads, over a TestLedger."""

    def __init__(self, led):
        self._led = led

    def ltx_root(self):
        return self._led.root

    def header(self):
        return self._led.header()


class DrainFailed(RuntimeError):
    pass


def failing_card(sent: list) -> CudaSigVerifier:
    """The card's verifier on the host whose every drain fails, keeping
    the triples it was sent."""
    v = CudaSigVerifier(device="cpu")

    def verify_many(triples):
        sent.extend(triples)
        raise DrainFailed("injected drain failure")

    v.verify_many = verify_many
    return v


@pytest.fixture
def cpu_verifies(monkeypatch):
    """Every triple the C verifier is asked to decide."""
    got = []
    raw, raw_batch = PK.raw_verify, PK.raw_verify_batch
    monkeypatch.setattr(PK, "raw_verify",
                        lambda k, s, m: got.append((k, s, m)) or raw(k, s,
                                                                     m))
    monkeypatch.setattr(PK, "raw_verify_batch",
                        lambda t: got.extend(t) or raw_batch(t))
    return got


def count_nomination_checks(monkeypatch, mod_herder, mod_txset) -> dict:
    """(node's LCL root, LCL hash, txset hash) -> the txset checks that a
    package's `HerderSCPDriver.validate_value` made in nomination mode."""
    counts, inside = {}, []
    validate = mod_herder.HerderSCPDriver.validate_value
    check = mod_txset.TxSetFrame.check_or_trim

    def counted_validate(self, slot_index, value, nomination):
        inside.append(nomination)
        try:
            return validate(self, slot_index, value, nomination)
        finally:
            inside.pop()

    def counted_check(self, ltx_parent, verifier=None, trim=False):
        if inside and inside[-1]:
            k = (id(ltx_parent), self.previous_ledger_hash,
                 self.get_contents_hash())
            counts[k] = counts.get(k, 0) + 1
        return check(self, ltx_parent, verifier, trim)

    monkeypatch.setattr(mod_herder.HerderSCPDriver, "validate_value",
                        counted_validate)
    monkeypatch.setattr(mod_txset.TxSetFrame, "check_or_trim",
                        counted_check)
    return counts


def test_nominated_txset_checked_once(tmp_path, networks, monkeypatch):
    """Each port node checks a nominated txset against its LCL once
    (`HerderSCPDriver.txset_valid_cache`); the reference checks it again
    at each nomination that carries it. The values externalized are the
    same."""
    import stellar_core_tpu.herder.herder as RH
    import stellar_core_tpu.herder.txset as RT
    import stellar_core_tpu_torch.herder.herder as PH
    import stellar_core_tpu_torch.herder.txset as PT
    ref_checks = count_nomination_checks(monkeypatch, RH, RT)
    port_checks = count_nomination_checks(monkeypatch, PH, PT)
    ref = network("rrrr", tmp_path / "r", networks)
    port = network("pppp", tmp_path / "p", networks)
    tr = port_traffic(port)
    for seq in SLOTS:
        for k, blob in enumerate(slot_blobs(tr, seq)):
            assert ref.submit(k % 4, blob) == port.submit(k % 4, blob)
        ref.close_slot(seq)
        port.close_slot(seq)
        for a, b in zip(ref.nodes, port.nodes):
            assert a.externalized[seq] == b.externalized[seq]
    assert port_checks and set(port_checks.values()) == {1}
    assert len(ref_checks) == len(port_checks)
    assert sum(ref_checks.values()) > sum(port_checks.values())


def test_herder_and_queue_raise_without_verifier(tmp_path):
    from stellar_core_tpu_torch.testing import TestLedger
    cfg = H.node_config(0, PX.SCPQuorumSet.from_xdr(qset_xdr(1, 1)), True,
                        MAX_TX_SET)
    app = H.make_port_node(tmp_path, cfg, CpuSigVerifier(),
                           make_hasher("cpu"))
    app.sig_verifier = None
    try:
        with pytest.raises(TypeError):
            Herder(app)
    finally:
        H.stop(app)
    led = TestLedger(verifier=CpuSigVerifier())
    with pytest.raises(TypeError):
        TransactionQueue(_Lm(led), verifier=None)


def test_failed_drain_fails_the_envelope(tmp_path, cpu_verifies,
                                         networks):
    """A node whose drain fails (node 1, the first to receive node 0's
    envelopes): the envelope's intake raises, and nothing it sent to the
    card is verified on the CPU."""
    PK.flush_verify_cache()
    q = qset_xdr(4, 3)
    relay = H.Relay(H.node_config(0, None, False, 0).network_id)
    networks.append(relay)
    sent = []
    for i in range(4):
        port_node(relay, i, q, tmp_path, i == 0,
                  verifier=failing_card(sent) if i == 1 else None)
    with pytest.raises(DrainFailed):
        relay.close_slot(2)
    assert sent and not set(sent) & set(cpu_verifies)
    assert relay.nodes[1].app.ledger_manager.last_closed_ledger_num() == 1


def test_failed_drain_fails_the_admission(cpu_verifies):
    from stellar_core_tpu_torch.testing import (
        TestAccount, TestLedger, root_secret_key,
    )
    PK.flush_verify_cache()
    led = TestLedger(verifier=CpuSigVerifier())
    root = TestAccount(led, root_secret_key())
    a = root.create(10 ** 10)
    f = a.tx([a.op_payment(root.account_id, 100)])
    del cpu_verifies[:]
    sent = []
    q = TransactionQueue(_Lm(led), verifier=failing_card(sent))
    with pytest.raises(DrainFailed):
        q.try_add(f)
    assert sent and not cpu_verifies and q.size_ops() == 0
    # the same transaction through the card's plain version is admitted
    q2 = TransactionQueue(_Lm(led), verifier=CudaSigVerifier(device="cpu"))
    assert q2.try_add(f) == TxQueueResult.ADD_STATUS_PENDING
    assert not cpu_verifies
