"""The port's LedgerManager closes held against the JAX package's.

Two LedgerManagers, one of each package, each over sqlite `:memory:` (or
the in-memory root) with a BucketManager on a directory of its own and a
StateCommitmentEngine (a checkpoint every 4 closes), start from the same
genesis and close the same values. The reference closes through its
Python fee and apply phases, and, in the `native` cases, through its C
apply engine; the port closes through its Python phases, and, in the
`port-native` cases, through its copy of that engine (`native/applyc.c`),
held at every close against the reference's engine and, by a third
manager, the reference's Python phases. Every transaction is built and
signed once, by the port's `TestAccount`; each side parses the wire bytes into its own frames, runs
the herder's `TxSetFrame.trim_invalid` with its own verifier and closes a
`StellarValue` over the trimmed set through `value_externalized`.

The 18 closes create the bench's senders and roles, arm 20-signature and
2-signature multisig, set up an authorised credit asset, then carry the
multisig and standard payment mixes (`replay_bench`, `bench.py`) with
every operation type of its `_StandardMix` (trust lines, allow-trust,
offers crossed by a buy offer and two path payments, account data, bump
sequence, an account merge, a fee bump, a payment to a muxed account),
transactions with a corrupted signature (which `trim_invalid` removes on
both sides) and one value that carries fee and reserve upgrades.

After every close, equal with no tolerance: the removed transactions,
`lcl_hash`, the sorted ledger entries, each transaction's result pair,
fee meta and tx meta (XDR, in apply order), the bucket-list hash and the
state commitment root.
"""

from types import SimpleNamespace

import pytest

import stellar_core_tpu.xdr as RX
import stellar_core_tpu_torch.xdr as PX
from stellar_core_tpu import testing as RT
from stellar_core_tpu.bucket.bucket_manager import (
    BucketManager as RBucketManager,
)
from stellar_core_tpu.crypto.batch_hasher import make_hasher as r_make_hasher
from stellar_core_tpu.crypto.batch_verifier import (
    CpuSigVerifier as RCpuSigVerifier,
)
from stellar_core_tpu.crypto.keys import SecretKey as RSecretKey
from stellar_core_tpu.database.database import Database as RDatabase
from stellar_core_tpu.herder.txset import TxSetFrame as RTxSetFrame
from stellar_core_tpu.ledger import ledger_manager as RLM
from stellar_core_tpu.ledger import state_commitment as RSC
from stellar_core_tpu.native import apply_engine
from stellar_core_tpu.transactions.transaction_frame import (
    TransactionFrame as RTransactionFrame,
)
from stellar_core_tpu_torch import testing as T
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.herder.txset import TxSetFrame
from stellar_core_tpu_torch.ledger import ledger_manager as PLM
from stellar_core_tpu_torch.transactions.transaction_frame import (
    TransactionFrame,
)

from torch_close_harness import (
    CORRUPT_EVERY, MULTISIG, NET, PORT, Shim, Workload, close_one, config,
    engine_candidates, engine_launches, make_port_side, observe,
)

import torch_threads  # noqa: F401  (one intra-op thread a worker)

REF = SimpleNamespace(X=RX, TransactionFrame=RTransactionFrame,
                      TxSetFrame=RTxSetFrame,
                      LedgerCloseData=RLM.LedgerCloseData)


def make_ref_side(bucket_dir: str, database: str, native: bool = False):
    """The reference's LedgerManager app, as make_port_side builds the
    port's; `native` lets its C apply engine run the closes."""
    cfg = config(RSecretKey, database)
    app = SimpleNamespace(
        config=cfg, network_root_key=RT.root_secret_key,
        sig_verifier=RCpuSigVerifier(), batch_hasher=r_make_hasher("cpu"),
        bucket_manager=RBucketManager(bucket_dir, background_merges=False),
        database=None if database == "in-memory" else RDatabase(),
        metrics=None, tracer=None, flight_recorder=None)
    app.state_commitment = RSC.StateCommitmentEngine(app)
    lm = RLM.LedgerManager(app)
    lm.use_native_apply = native
    lm.start_new_ledger()
    return lm


def run_closes(port_lm, ref_lm, on_close=None, third=None) -> dict:
    """Close the schedule on both sides (and on `third`, a reference
    manager, where given), comparing every close."""
    w = Workload(port_lm)
    n = trimmed = applied = 0
    codes = set()
    for build, ups in w.schedule():
        frames = build()
        blobs = [f.envelope_bytes() for f in frames]
        want_removed = sorted(h for h in (f.contents_hash() for f in frames)
                              if h in w.corrupted)
        p_removed, p_frames = close_one(port_lm, PORT, blobs,
                                        [u for u in ups])
        r_removed, r_frames = close_one(ref_lm, REF, blobs,
                                        [u for u in ups])
        assert p_removed == r_removed == want_removed, n
        po, ro = observe(port_lm, p_frames), observe(ref_lm, r_frames)
        for k in po:
            assert po[k] == ro[k], (n, k)
        if third is not None:
            t_removed, t_frames = close_one(third, REF, blobs,
                                            [u for u in ups])
            assert t_removed == want_removed, n
            to = observe(third, t_frames)
            for k in po:
                assert po[k] == to[k], (n, k)
        if on_close is not None:
            on_close(n, port_lm, p_frames)
        trimmed += len(p_removed)
        applied += len(p_frames)
        codes.update(f.result.result.disc for f in p_frames)
        n += 1
    return {"closes": n, "trimmed": trimmed, "applied": applied,
            "codes": codes, "header": port_lm.lcl_header}


@pytest.mark.parametrize("database", ["sqlite3://:memory:", "in-memory"])
@pytest.mark.parametrize("engine", [
    "python",
    pytest.param("native", marks=pytest.mark.skipif(
        apply_engine() is None, reason="the reference's C apply engine "
        "did not build here")),
    pytest.param("port-native", marks=pytest.mark.skipif(
        apply_engine() is None, reason="the reference's C apply engine "
        "did not build here")),
])
def test_closes_match_reference(tmp_path, engine, database):
    port = make_port_side(str(tmp_path / "port"), database)
    port.use_native_apply = engine == "port-native"
    ref = make_ref_side(str(tmp_path / "ref"), database,
                        native=engine != "python")
    third = None
    if engine == "port-native":
        third = make_ref_side(str(tmp_path / "ref-py"), database)
    assert port.lcl_hash == ref.lcl_hash
    paths = []
    got = run_closes(port, ref, third=third,
                     on_close=lambda n, lm, fr: paths.append(
                         lm.last_apply_path))
    # the engine ran every close of the schedule (none bails on it)
    assert set(paths) == {"native" if engine == "port-native"
                          else "python"}
    assert got["closes"] == 18
    # 13 one-signature txs and every 3rd of the 52 multisig payments
    assert got["trimmed"] == 13 + 13 * MULTISIG // CORRUPT_EVERY
    assert got["applied"] > 200
    h = got["header"]
    assert h.baseFee == 150 and h.baseReserve == 4_000_000
    # the closes reached success and failure results, and the fee bump
    assert {PX.TransactionResultCode.txSUCCESS,
            PX.TransactionResultCode.txFEE_BUMP_INNER_SUCCESS} <= \
        got["codes"]
    sce = port.app.state_commitment
    assert sce.root == sce.from_scratch_root(
        port.app.bucket_manager.bucket_list)
    assert sorted(sce.checkpoints) == sorted(
        ref.app.state_commitment.checkpoints)
    if database != "in-memory":
        rows = port.app.database.execute(
            "SELECT COUNT(*) FROM txhistory").fetchone()[0]
        assert rows == got["applied"]
        assert port.app.database.execute(
            "SELECT COUNT(*) FROM upgradehistory").fetchone()[0] == 2
    for lm in (port, ref) + ((third,) if third is not None else ()):
        lm.app.bucket_manager.shutdown()


def derived_checks(lm, twin, verifier, blobs, prewarm: bool) -> dict:
    """One close on the port side whose verifier is the card's stack (here
    its plain version on the host), the twin closing the same blobs:
    validation dispatches one prewarm batch when the set holds two or more
    transactions, and the close after it none; without the prewarm (the
    verify cache flushed between validation and close) the close
    dispatches once per transaction, at its first signature check, on the
    Python path, and, through the apply engine, once per 8,192 of the
    engine's candidates the cache does not hold (`engine_launches`).
    Expected counts come from the transactions and the state alone."""
    from stellar_core_tpu_torch.crypto import keys as K
    X = PX
    frames = [TransactionFrame.make_from_wire(
        NET, X.TransactionEnvelope.from_xdr(b)) for b in blobs]
    ts = TxSetFrame(NET, lm.lcl_hash, frames)
    K.flush_verify_cache()
    d0 = verifier.batches_dispatched
    removed = ts.trim_invalid(lm.ltx_root(), verifier)
    validate = verifier.batches_dispatched - d0
    assert validate == (1 if len(frames) > 1 else len(frames))
    assert not removed
    if not prewarm:
        K.flush_verify_cache()
    header = lm.root.get_header()
    value = X.StellarValue(txSetHash=ts.get_contents_hash(),
                           closeTime=header.scpValue.closeTime + 5,
                           upgrades=[], ext=X.StellarValueExt(0, None))
    if lm.use_native_apply:
        want = engine_launches(engine_candidates(lm.root,
                                                 ts.sort_for_apply()))
        assert want == (0 if prewarm else 1)
    else:
        want = 0 if prewarm else len(frames)
    d0 = verifier.batches_dispatched
    lm.value_externalized(PLM.LedgerCloseData(header.ledgerSeq + 1, ts,
                                              value))
    closing = verifier.batches_dispatched - d0
    assert closing == want
    assert lm.last_apply_path == ("native" if lm.use_native_apply
                                  else "python")
    r_removed, r_frames = close_one(twin, REF, blobs)
    assert not r_removed
    po = observe(lm, ts.sort_for_apply())
    ro = observe(twin, r_frames)
    for k in po:
        assert po[k] == ro[k], k
    return {"validate": validate, "close": closing}


def test_prewarmed_and_cold_closes_dispatch_as_derived(tmp_path):
    """The Python path's counts: the port's close pinned to its Python
    phases."""
    cold_close_dispatches(tmp_path, native=False, want_cold=2)


def test_engine_cold_close_dispatches_once(tmp_path):
    """Through the apply engine a cold close of two multisig payments
    dispatches once (the engine's one `prewarm_many` per close), not once
    per transaction."""
    cold_close_dispatches(tmp_path, native=True, want_cold=1)


def cold_close_dispatches(tmp_path, native: bool, want_cold: int) -> None:
    from stellar_core_tpu_torch.crypto.batch_verifier import CudaSigVerifier
    port = make_port_side(str(tmp_path / "port"), "sqlite3://:memory:")
    port.use_native_apply = native
    ref = make_ref_side(str(tmp_path / "ref"), "sqlite3://:memory:")
    shim = Shim(port)
    root = T.TestAccount(shim, T.root_secret_key())
    users = [T.TestAccount(shim, SecretKey.from_seed(bytes([60 + i]) * 32))
             for i in range(2)]
    signers = [[SecretKey.from_seed(bytes([80 + 4 * i + j]) * 32)
                for j in range(3)] for i in range(2)]
    # the accounts and their signers, closed on the host's verifier (each
    # set built against the state the close before it left)
    for build in (lambda: [root.tx([root.op_create_account(
                      u.account_id, 10 ** 9) for u in users])],
                  lambda: [u.tx([u.op_add_signer(k.public_key.key_bytes)
                                 for k in ks] + [u.op_set_options(med=4)])
                           for u, ks in zip(users, signers)]):
        blobs = [f.envelope_bytes() for f in build()]
        for lm, pkg in ((port, PORT), (ref, REF)):
            assert close_one(lm, pkg, blobs)[0] == []

    def pay(amount):
        return [u.tx([u.op_payment(root.account_id, amount)],
                     extra_signers=ks).envelope_bytes()
                for u, ks in zip(users, signers)]

    # then the card's verifier, here its plain version
    v = port.app.sig_verifier = CudaSigVerifier(device="cpu")
    assert derived_checks(port, ref, v, pay(5), True) == {
        "validate": 1, "close": 0}
    assert derived_checks(port, ref, v, pay(6), False) == {
        "validate": 1, "close": want_cold}
    for lm in (port, ref):
        lm.app.bucket_manager.shutdown()


@pytest.mark.parametrize("database", ["sqlite3://:memory:", "in-memory"])
def test_apply_buckets_matches_reference(tmp_path, database):
    """Catchup's bucket apply (`bucket/applicator.py`) of a bucket list
    with live, init and dead entries over several levels, into each
    package's root: the same entries, the same count, and a
    BucketApplicator's chunked walk over one bucket agrees with it."""
    import numpy as np
    from stellar_core_tpu.bucket.applicator import (
        apply_buckets as r_apply_buckets,
    )
    from stellar_core_tpu.ledger.ledgertxn import (
        InMemoryLedgerTxnRoot as RMem, LedgerTxnRoot as RSql,
    )
    from stellar_core_tpu_torch.bucket import (
        BucketApplicator, BucketManager, apply_buckets,
    )
    from stellar_core_tpu_torch.database.database import Database
    from stellar_core_tpu_torch.ledger.ledgertxn import (
        InMemoryLedgerTxnRoot, LedgerTxnRoot,
    )
    from stellar_core_tpu_torch.testing import entries as TE
    rng = np.random.default_rng(5)
    mgr = BucketManager(None, background_merges=False)
    live = []
    for seq in range(1, 40):
        fresh = [b.value for b in TE.bucket_entries(TE.unique_offer_ids(
            TE.entry_records(rng, 30), first=1 + 30 * seq))]
        ups, deads = [], []
        if live:
            for i in rng.choice(len(live), 6, replace=False).tolist():
                e = PX.LedgerEntry.from_xdr(live[i].to_xdr())
                e.lastModifiedLedgerSeq = seq
                live[i] = e
                ups.append(e)
            for i in sorted(rng.choice(len(live), 3, replace=False)
                            .tolist(), reverse=True):
                deads.append(PX.ledger_entry_key(live.pop(i)))
            ups = [e for e in ups if all(
                PX.ledger_entry_key(e).to_xdr() != k.to_xdr()
                for k in deads)]
        live += fresh
        mgr.add_batch(seq, 13, fresh, ups, deads)
    buckets = [b for lev in mgr.bucket_list.levels
               for b in (lev.curr, lev.snap)]
    header = T.genesis_header()
    if database == "in-memory":
        port, ref = InMemoryLedgerTxnRoot(header), RMem(
            RX.LedgerHeader.from_xdr(header.to_xdr()))
    else:
        port = LedgerTxnRoot(Database(), header)
        ref = RSql(RDatabase(), RX.LedgerHeader.from_xdr(header.to_xdr()))
    from stellar_core_tpu.bucket.bucket import Bucket as RBucket
    r_buckets = [RBucket([RX.BucketEntry.from_xdr(e.to_xdr())
                          for e in b.entries]) for b in buckets]
    n = apply_buckets(port, buckets)
    assert n == r_apply_buckets(ref, r_buckets)
    want = sorted(e.to_xdr() for e in live)
    assert sorted(e.to_xdr() for e in port.all_entries()) == want
    assert sorted(e.to_xdr() for e in ref.all_entries()) == want
    assert port.count_entries() == len(live)
    # one bucket through the chunked applicator: its live entries land
    big = max(buckets, key=lambda b: len(b.payload_entries()))
    single = InMemoryLedgerTxnRoot(T.genesis_header())
    app = BucketApplicator(single, big, chunk_size=7)
    steps = 0
    while app:
        app.advance()
        steps += 1
    assert steps == -(-len(big.payload_entries()) // 7) > 1
    assert single.count_entries() == sum(
        1 for e in big.payload_entries()
        if e.disc != PX.BucketEntryType.DEADENTRY)
