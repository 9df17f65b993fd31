"""The traffic generators: the same seed gives the same inputs, every seed
the same sizes, and the port decodes what they write to the same bytes."""

import json
import os

import pytest

from portbench.kinds import checkpoint, scp
from portbench.run import find_cell, load_benchmark
from portbench.yardstick import xdr as X

SEEDS = (7, 2 ** 31 + 11, -3)


def _cell(root, workload):
    _cell, config, traffic = find_cell(root, load_benchmark(root), workload)
    return config, traffic


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as fh:
            out[name] = fh.read()
    return out


def test_checkpoint_is_deterministic_per_seed(small_root, tmp_path):
    config, traffic = _cell(small_root, "catchup-verify.pubnet")
    got = []
    for i, seed in enumerate(SEEDS + (SEEDS[0],)):
        d = tmp_path / ("g%d" % i)
        d.mkdir()
        inp = checkpoint.generate(config, traffic, seed, str(d))
        got.append((_files(str(d)), inp))
    first, again = got[0], got[-1]
    assert first[0] == again[0]
    assert first[1].triples == again[1].triples
    assert first[1].accounts == again[1].accounts
    sizes = {(len(inp.triples), len(inp.corrupted),
              tuple(len(b) for b in files.values()))
             for files, inp in got}
    assert len(sizes) == 1, sizes
    assert len({tuple(files.values()) for files, _inp in got}) == len(SEEDS)
    per_ledger = sum(traffic["corrupt_per_ledger"].values())
    assert len(first[1].corrupted) == \
        per_ledger * config["checkpoint_frequency"]
    assert first[1].n_txs == \
        config["checkpoint_frequency"] * config["max_tx_set_operations"]


def test_checkpoint_must_end_a_checkpoint(small_root, tmp_path):
    config, traffic = _cell(small_root, "catchup-verify.pubnet")
    traffic["checkpoint"] += 1
    with pytest.raises(ValueError):
        checkpoint.generate(config, traffic, 7, str(tmp_path))


def test_scp_is_deterministic_per_seed(small_root):
    config, traffic = _cell(small_root, "scp-bursts.tier1")
    runs = [scp.generate(config, traffic, s, 12.0) for s in SEEDS]
    again = scp.generate(config, traffic, SEEDS[0], 12.0)
    assert [e.xdr for e in runs[0].window] == [e.xdr for e in again.window]
    assert [e.due for e in runs[0].window] == [e.due for e in again.window]
    n = config["orgs"] * config["validators_per_org"]
    for inp in runs:
        slots = {}
        for e in inp.window:
            slots.setdefault(e.slot, []).append(e)
        # slots at 0, 5 and 10 s, each whole within a second
        assert [len(v) for v in slots.values()] == [6 * n] * 3
        bad = [sum(not e.good for e in v) for v in slots.values()]
        assert bad[:2] == [f + traffic["s_plus_l_per_slot"] +
                           traffic["mixed_order_per_slot"]
                           for f in traffic["bit_flips_per_slot"]]
        assert len({e.xdr for e in inp.window}) == len(inp.window)
    assert len({runs[i].window[0].xdr for i in range(len(SEEDS))}) == \
        len(SEEDS)
    # every seed meets the same network: the same arrival times
    assert len({tuple(e.due for e in inp.window) for inp in runs}) == 1


def test_scp_arrivals_follow_the_quorum(small_root):
    """Each validator sends a step once it has heard the step before from
    a quorum, so no step is sent before the one before it reached a
    quorum, and this node hears each envelope a link's latency later."""
    config, traffic = _cell(small_root, "scp-bursts.tier1")
    lat = scp.link_latencies(config)
    n = config["orgs"] * config["validators_per_org"]
    assert len(lat) == n + 1
    lo, hi = config["latency"]["intra_ms"][0], config["latency"]["inter_ms"][1]
    assert all(lo / 1e3 <= lat[i][j] <= hi / 1e3 and lat[i][j] == lat[j][i]
               for i in range(n + 1) for j in range(i))
    sent = scp.send_times(config, len(traffic["steps"]), lat)
    assert sent[0] == [0.0] * n
    for prev, nxt in zip(sent, sent[1:]):
        assert all(b >= a for a, b in zip(prev, nxt))
        # no validator moves on before some quorum could have heard it
        assert min(nxt) >= min(prev) + lo / 1e3
    inp = scp.generate(config, traffic, 3, 5.0)
    assert sorted(e.due for e in inp.window) == sorted(
        t + lat[v][n] for row in sent for v, t in enumerate(row))


def test_the_port_decodes_the_generated_bytes(small_root, tmp_path):
    from stellar_core_tpu_torch.util.xdrstream import XDRInputFileStream
    from stellar_core_tpu_torch.xdr import (LedgerEntry,
                                            LedgerHeaderHistoryEntry,
                                            SCPEnvelope, SCPQuorumSet,
                                            TransactionHistoryEntry)
    config, traffic = _cell(small_root, "catchup-verify.pubnet")
    inp = checkpoint.generate(config, traffic, 5, str(tmp_path))
    for b in inp.accounts:
        assert LedgerEntry.from_xdr(b).to_xdr() == b
    for name, t in (("ledger", LedgerHeaderHistoryEntry),
                    ("transactions", TransactionHistoryEntry)):
        path = str(tmp_path / ("%s-%08x.xdr" % (name, inp.checkpoint)))
        with open(path, "rb") as fh:
            raw = fh.read()
        with XDRInputFileStream(path) as ins:
            vals = list(ins.read_all(t))
        assert len(vals) == config["checkpoint_frequency"]
        assert b"".join(X.record(v.to_xdr()) for v in vals) == raw
    config, traffic = _cell(small_root, "scp-bursts.tier1")
    sinp = scp.generate(config, traffic, 5, 6.0)
    assert SCPQuorumSet.from_xdr(sinp.quorum_set).to_xdr() == \
        sinp.quorum_set
    for e in sinp.window[:50]:
        assert SCPEnvelope.from_xdr(e.xdr).to_xdr() == e.xdr


def test_expected_triples_are_the_ports_candidates(small_root, tmp_path):
    """The reference's candidate rule, worked out from the generator's own
    signer sets, gives the set the port's collection gives."""
    from stellar_core_tpu_torch.herder.txset import TxSetFrame
    from stellar_core_tpu_torch.ledger.ledgertxn import (
        InMemoryLedgerTxnRoot, LedgerTxn)
    from stellar_core_tpu_torch.transactions.transaction_frame import \
        frames_sig_triples
    from stellar_core_tpu_torch.util.xdrstream import XDRInputFileStream
    from stellar_core_tpu_torch.xdr import LedgerEntry, LedgerHeader, \
        TransactionHistoryEntry
    config, traffic = _cell(small_root, "catchup-verify.pubnet")
    inp = checkpoint.generate(config, traffic, 9, str(tmp_path))
    root = InMemoryLedgerTxnRoot(LedgerHeader.from_xdr(X.ledger_header(
        inp.first - 1, b"\x00" * 32, b"\x00" * 32, 0, b"\x00" * 32,
        b"\x00" * 32, 10 ** 17, 0, 1000)))
    ltx = LedgerTxn(root)
    for b in inp.accounts:
        ltx.create(LedgerEntry.from_xdr(b))
    ltx.commit()
    path = str(tmp_path / ("transactions-%08x.xdr" % inp.checkpoint))
    frames = []
    with XDRInputFileStream(path) as ins:
        for t in ins.read_all(TransactionHistoryEntry):
            frames += TxSetFrame.from_wire(inp.network_id, t.txSet).frames
    ltx = LedgerTxn(root)
    got = frames_sig_triples(ltx, frames)
    ltx.rollback()
    assert len(got) == len(set(got))
    assert set(got) == set(inp.triples)


@pytest.mark.parametrize("name", ["pubnet-catchup", "pubnet-tier1-watcher"])
def test_configs_state_their_deployment(name):
    from portbench.tests.conftest import REPO
    with open(os.path.join(REPO, "portbench", "configs",
                           name + ".json")) as fh:
        blob = json.load(fh)
    for key in ("name", "source", "assumed", "guarantees",
                "network_passphrase", "verify_backend"):
        assert blob.get(key), key
    for key in ("reduced", "protocol_version", "node_is_validator"):
        assert key in blob, key
    assert blob["name"] == name
    bench = load_benchmark(REPO)
    entry = {c["name"]: c for c in bench["configs"]}[name]
    assert entry["source"] == blob["source"]
    assert sorted(entry["reduced"]) == sorted(blob["reduced"])


def test_the_node_takes_the_configurations_settings(small_root, tmp_path):
    """The protocol version and the validator flag a configuration states
    are the node's."""
    from portbench import core
    config, _traffic = _cell(small_root, "catchup-verify.pubnet")
    config.update(protocol_version=12, node_is_validator=True)
    app = core.build_node(config, b"\x07" * 32, str(tmp_path), "cpu")
    try:
        assert app.ledger_manager.lcl_header.ledgerVersion == 12
        assert app.config.NODE_IS_VALIDATOR is True
    finally:
        core.stop_node(app)
