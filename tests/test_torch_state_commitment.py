"""The port's state-commitment entry roots against the JAX package's.

- `merkle_root`, `merkle_path` and `merkle_climb` equal the reference's for
  every size from 0 to 33 and every index.
- `entry_root(records)` over the XDR records of a real JAX `Bucket`
  (built by `Bucket.fresh` from accounts, trustlines, offers, data entries
  and tombstones) equals `StateCommitmentEngine.entry_root(bucket)`, with
  `CpuBatchHasher` and `CudaBatchHasher(device="cpu")`; without a hasher
  it raises rather than hash on the host.
- The entry bodies that `chip_smoke.py`'s generator writes
  (`testing/entries.py`) equal the reference codec's and the port codec's
  `entry_record(e)[4:]` byte for byte for each kind and every signer
  count, so its leaf-length table is the codec's; `bucket_entries` decodes
  them into the port's `BucketEntry` objects and `canonical_order` puts
  them in the bucket order `bucket_entry_sort_key` gives.
- The engine, as the cases of `tests/test_state_commitment.py:41-107` run
  against the port: the Merkle round trip with a wrong sibling, the
  40-ledger random churn through a real `BucketList` with the incremental
  root equal to `from_scratch_root` after every ledger, and the entry-root
  cache hits; the port's engine on `make_hasher("cpu")` and on
  `CudaBatchHasher(device="cpu")` (the plain kernel).
- A differential: the same churn through the reference's and the port's
  `BucketList` + engine gives identical roots on every ledger, identical
  checkpoint payloads and signatures (ed25519 signing is deterministic),
  identical proof JSON, and cross acceptance (each side's
  `light_client_verify` accepts the other's proofs and rejects tampered
  ones); `commitment.sign-fail` skips the same interval on both, with the
  port's meter, fault count and flight dump; an engine without a hasher
  raises.
Tolerance: none.
"""

import json
import random
from types import SimpleNamespace

import numpy as np
import pytest

import stellar_core_tpu.xdr as X
from stellar_core_tpu.bucket.bucket import Bucket, entry_record
from stellar_core_tpu.crypto.hashing import sha256 as jax_sha256
from stellar_core_tpu.ledger import state_commitment as JC
from stellar_core_tpu_torch.crypto.batch_hasher import (
    CpuBatchHasher, CudaBatchHasher, make_hasher,
)
from stellar_core_tpu_torch.crypto.hashing import SHA256, sha256
from stellar_core_tpu_torch.ledger import state_commitment as TC
from stellar_core_tpu_torch.testing import entries as TE
import stellar_core_tpu_torch.xdr as PX
from stellar_core_tpu_torch.bucket.bucket import (
    bucket_entry_sort_key as port_sort_key, entry_record as port_entry_record,
)

import torch_threads  # noqa: F401  (one intra-op thread a worker)

PROTO = 13


# --- merkle algebra ---------------------------------------------------------

def test_prefixes_equal_the_reference():
    assert (TC.ENTRY_LEAF_PREFIX, TC.NODE_PREFIX, TC.BUCKET_LEAF_PREFIX,
            TC.ZERO_HASH) == (JC.ENTRY_LEAF_PREFIX, JC.NODE_PREFIX,
                              JC.BUCKET_LEAF_PREFIX, JC.ZERO_HASH)


def test_hashing_equals_the_reference():
    assert sha256(b"abc") == jax_sha256(b"abc")
    assert SHA256().add(b"a").add(b"bc").finish() == jax_sha256(b"abc")


@pytest.mark.parametrize("n", range(34))
def test_merkle_helpers_equal_the_reference(n):
    leaves = [sha256(bytes([i, n])) for i in range(n)]
    root = TC.merkle_root(leaves)
    assert root == JC.merkle_root(leaves)
    for i in range(n):
        path = TC.merkle_path(leaves, i)
        assert path == JC.merkle_path(leaves, i), (n, i)
        assert TC.merkle_climb(leaves[i], path) == root
        assert JC.merkle_climb(leaves[i], path) == root


# --- entry roots over a real bucket ----------------------------------------

def _pk(rng) -> X.PublicKey:
    return X.PublicKey.ed25519(rng.bytes(32))


def _ref_entry(kind: str, keys, n_signers: int = 0) -> X.LedgerEntry:
    """The reference codec's entry of `kind` with testing/entries.py's
    scalar fields and these 32-byte keys."""
    pk = [X.PublicKey.ed25519(k) for k in keys]
    asset = X.Asset.credit(TE.ASSET_CODE.decode(), pk[-1])
    if kind in ("account", "account_signers"):
        data = X.LedgerEntryData(X.LedgerEntryType.ACCOUNT, X.AccountEntry(
            accountID=pk[0], balance=TE.BALANCE, seqNum=TE.SEQ_NUM,
            numSubEntries=n_signers, inflationDest=None, flags=0,
            homeDomain="", thresholds=TE.THRESHOLDS,
            signers=[X.Signer(key=X.SignerKey.ed25519(k), weight=1)
                     for k in keys[1:]],
            ext=X.AccountEntryExt.v0()))
    elif kind == "trustline":
        data = X.LedgerEntryData(X.LedgerEntryType.TRUSTLINE,
                                 X.TrustLineEntry(
                                     accountID=pk[0], asset=asset,
                                     balance=TE.BALANCE, limit=TE.LIMIT,
                                     flags=1,
                                     ext=X.TrustLineEntryExt.v0()))
    elif kind == "offer":
        data = X.LedgerEntryData(X.LedgerEntryType.OFFER, X.OfferEntry(
            sellerID=pk[0], offerID=TE.OFFER_ID, selling=asset,
            buying=X.Asset.native(), amount=TE.AMOUNT,
            price=X.Price(n=TE.PRICE[0], d=TE.PRICE[1]), flags=0,
            ext=X._Ext.v0()))
    else:
        data = X.LedgerEntryData(X.LedgerEntryType.DATA, X.DataEntry(
            accountID=pk[0], dataName=TE.DATA_NAME.decode(),
            dataValue=keys[1], ext=X._Ext.v0()))
    return X.LedgerEntry(lastModifiedLedgerSeq=TE.LAST_MODIFIED, data=data,
                         ext=X._Ext.v0())


def _cases():
    for kind in TE.KINDS[:4]:
        yield kind, 0
    for s in range(1, TE.MAX_SIGNERS + 1):
        yield "account_signers", s


@pytest.mark.parametrize("kind,n_signers", list(_cases()),
                         ids=lambda v: str(v))
def test_entry_bodies_equal_the_reference_codec(kind, n_signers):
    rng = np.random.default_rng(n_signers + 7 * TE.KINDS.index(kind))
    keys = [rng.bytes(32) for _ in range(TE.n_keys(kind, n_signers))]
    ref = entry_record(X.BucketEntry.live(_ref_entry(kind, keys,
                                                     n_signers)))[4:]
    assert TE.entry_body(kind, keys, n_signers) == ref
    port = PX.BucketEntry.from_xdr(ref)
    assert port_entry_record(port)[4:] == ref == port.to_xdr()
    table = TE.leaf_lengths()[kind]
    want = table[n_signers] if n_signers else table
    assert want == len(TC.ENTRY_LEAF_PREFIX + ref)


def test_generated_records_follow_the_table_and_mix():
    lengths = TE.leaf_lengths()
    allowed = {v for k, v in lengths.items() if k != "account_signers"}
    allowed |= set(lengths["account_signers"].values())
    recs = TE.entry_records(np.random.default_rng(0), 4000)
    assert len(recs) == 4000
    seen = [1 + len(r) for r in recs]
    assert set(seen) <= allowed
    assert seen.count(lengths["account"]) > 2000
    assert recs == TE.entry_records(np.random.default_rng(0), 4000)
    assert len(set(recs)) == len(recs), "key slots are filled"


@pytest.fixture(scope="module")
def bucket():
    rng = np.random.default_rng(11)
    inits = [_ref_entry("account", [rng.bytes(32)]) for _ in range(40)]
    inits += [_ref_entry("trustline", [rng.bytes(32), rng.bytes(32)])
              for _ in range(20)]
    lives = [_ref_entry("offer", [rng.bytes(32), rng.bytes(32)])
             for _ in range(10)]
    lives += [_ref_entry("data", [rng.bytes(32), rng.bytes(32)])
              for _ in range(5)]
    lives.append(_ref_entry("account_signers",
                            [rng.bytes(32) for _ in range(21)], 20))
    deads = [X.LedgerKey.account(_pk(rng)) for _ in range(4)]
    return Bucket.fresh(PROTO, inits, lives, deads)


@pytest.mark.parametrize("hasher", ["cpu", "cuda-on-cpu"])
def test_entry_root_equals_the_engine(bucket, hasher):
    records = [entry_record(e)[4:] for e in bucket.entries]
    assert len(records) == 81     # META + 80 entries
    engine = JC.StateCommitmentEngine(SimpleNamespace(metrics=None,
                                                      config=None))
    want = engine.entry_root(bucket)
    h = {"cpu": CpuBatchHasher(),
         "cuda-on-cpu": CudaBatchHasher(device="cpu")}[hasher]
    assert TC.entry_leaves(records, h) == engine._entry_leaves(bucket)
    assert TC.entry_root(records, h) == want
    if hasher == "cuda-on-cpu":
        assert h.batches == 2 and h.oversize_msgs == 0   # two drains


def test_entry_root_needs_a_hasher(bucket):
    records = [entry_record(e)[4:] for e in bucket.entries]
    with pytest.raises(TypeError):
        TC.entry_leaves(records)       # no silent hashing on the host
    with pytest.raises(TypeError):
        TC.entry_root(records)


def test_entry_root_of_no_entries_is_the_zero_hash():
    assert TC.entry_root([], CpuBatchHasher()) == TC.ZERO_HASH
    assert TC.entry_root([], CudaBatchHasher(device="cpu")) == TC.ZERO_HASH


def test_bucket_entries_in_canonical_order():
    recs = TE.entry_records(np.random.default_rng(3), 3000)
    order = TE.canonical_order(recs)
    es = TE.bucket_entries([recs[i] for i in order])
    assert [e.to_xdr() for e in es] == [recs[i] for i in order]
    keys = [port_sort_key(e) for e in es]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    ref = [X.BucketEntry.from_xdr(recs[i]) for i in order]
    from stellar_core_tpu.bucket.bucket import bucket_entry_sort_key
    assert sorted(ref, key=bucket_entry_sort_key) == ref
    with pytest.raises(ValueError):
        TE.canonical_order(recs[:5] + recs[:1])


# --- the engine: the cases of tests/test_state_commitment.py ---------------

NET = b"\x4e" * 32
SEED = bytes(range(32))
HASHERS = {"cpu": lambda: make_hasher("cpu"),
           "cuda-on-cpu": lambda: CudaBatchHasher(device="cpu")}


def port_acct(i: int, balance: int = 10 ** 9) -> PX.LedgerEntry:
    """The port's twin of the reference's make_account_entry(key,
    balance, 0, 1)."""
    acc = PX.AccountEntry(
        accountID=PX.PublicKey.ed25519(i.to_bytes(32, "big")),
        balance=balance, seqNum=0, numSubEntries=0, inflationDest=None,
        flags=0, homeDomain="", thresholds=bytes([1, 0, 0, 0]), signers=[],
        ext=PX.AccountEntryExt.v0())
    return PX.LedgerEntry(
        lastModifiedLedgerSeq=1,
        data=PX.LedgerEntryData(PX.LedgerEntryType.ACCOUNT, acc),
        ext=PX._Ext.v0())


def port_acct_key(i: int) -> PX.LedgerKey:
    return PX.LedgerKey.account(PX.PublicKey.ed25519(i.to_bytes(32, "big")))


def ref_acct(i: int, balance: int = 10 ** 9) -> X.LedgerEntry:
    from stellar_core_tpu.transactions.account_helpers import \
        make_account_entry
    return make_account_entry(X.PublicKey.ed25519(i.to_bytes(32, "big")),
                              balance, 0, 1)


def ref_acct_key(i: int) -> X.LedgerKey:
    return X.LedgerKey.account(X.PublicKey.ed25519(i.to_bytes(32, "big")))


def port_engine(hasher="cpu", interval=None, **app) -> TC.StateCommitmentEngine:
    cfg = None
    if interval is not None:
        from stellar_core_tpu_torch.crypto.keys import SecretKey
        cfg = SimpleNamespace(NODE_SEED=SecretKey(SEED), network_id=NET,
                              STATE_CHECKPOINT_INTERVAL=interval)
    app.setdefault("metrics", None)
    return TC.StateCommitmentEngine(SimpleNamespace(
        config=cfg, batch_hasher=HASHERS[hasher](), **app))


def ref_engine(interval=None, **app) -> JC.StateCommitmentEngine:
    cfg = None
    if interval is not None:
        from stellar_core_tpu.crypto.keys import SecretKey
        cfg = SimpleNamespace(NODE_SEED=SecretKey(SEED), network_id=NET,
                              STATE_CHECKPOINT_INTERVAL=interval)
    app.setdefault("metrics", None)
    return JC.StateCommitmentEngine(SimpleNamespace(config=cfg, **app))


def test_merkle_roundtrip_every_size_and_index():
    for n in (1, 2, 3, 4, 5, 7, 8, 22, 33):
        leaves = [sha256(bytes([i, n])) for i in range(n)]
        root = TC.merkle_root(leaves)
        for i in range(n):
            path = TC.merkle_path(leaves, i)
            assert TC.merkle_climb(leaves[i], path) == root, (n, i)
            if path:
                bad = [dict(st) for st in path]
                bad[0]["h"] = sha256(b"evil").hex()
                assert TC.merkle_climb(leaves[i], bad) != root


def test_merkle_empty_commits_to_zero():
    assert TC.merkle_root([]) == b"\x00" * 32


def churn_batches(seed: int = 0x5C7C, ledgers: int = 40):
    """The churn of tests/test_state_commitment.py: (ledger, init ids,
    live ids, dead ids) per close, from one seeded stream."""
    r = random.Random(seed)
    live_ids: set = set()
    next_id = 1
    out = []
    for ledger in range(1, ledgers + 1):
        inits, lives, deads = [], [], []
        batch_ids: set = set()
        for _ in range(r.randint(1, 3)):
            inits.append(next_id)
            live_ids.add(next_id)
            batch_ids.add(next_id)
            next_id += 1
        for i in sorted(live_ids - batch_ids)[:2]:
            if r.randint(0, 1):
                lives.append(i)
                batch_ids.add(i)
        if len(live_ids) > 4 and r.randint(0, 2) == 0:
            gone = sorted(live_ids)[0]
            if gone not in batch_ids:
                live_ids.discard(gone)
                deads.append(gone)
        out.append((ledger, inits, lives, deads))
    return out


def _port_batch(ledger, inits, lives, deads):
    return ([port_acct(i) for i in inits],
            [port_acct(i, 10 ** 9 + ledger) for i in lives],
            [port_acct_key(i) for i in deads])


def _ref_batch(ledger, inits, lives, deads):
    return ([ref_acct(i) for i in inits],
            [ref_acct(i, 10 ** 9 + ledger) for i in lives],
            [ref_acct_key(i) for i in deads])


def _commit_all(bl):
    bl.resolve_all_futures()
    for lev in bl.levels:
        lev.commit()


@pytest.mark.parametrize("hasher", sorted(HASHERS))
def test_incremental_root_matches_oracle_under_random_churn(hasher):
    from stellar_core_tpu_torch.bucket.bucket_list import BucketList
    bl = BucketList()
    eng = port_engine(hasher)
    for ledger, *ids in churn_batches():
        bl.add_batch(ledger, PROTO, *_port_batch(ledger, *ids))
        _commit_all(bl)
        got = eng.update_root(bl)
        assert got == eng.from_scratch_root(bl), \
            "divergence at ledger %d" % ledger


def test_entry_root_cache_hits_on_unchanged_buckets():
    from stellar_core_tpu_torch.bucket.bucket_list import BucketList
    bl = BucketList()
    eng = port_engine("cuda-on-cpu")
    bl.add_batch(1, PROTO, [port_acct(1)], [], [])
    eng.update_root(bl)
    misses_before = len(eng._entry_roots)
    batches = eng.app.batch_hasher.batches
    eng.update_root(bl)
    assert len(eng._entry_roots) == misses_before
    assert eng.app.batch_hasher.batches == batches     # nothing re-hashed


def test_engine_needs_a_hasher():
    from stellar_core_tpu_torch.bucket.bucket_list import BucketList
    bl = BucketList()
    bl.add_batch(1, PROTO, [port_acct(1)], [], [])
    eng = TC.StateCommitmentEngine(SimpleNamespace(metrics=None,
                                                   config=None))
    with pytest.raises(TypeError):
        eng.update_root(bl)
    assert eng.from_scratch_root(bl) == \
        port_engine().update_root(bl)          # the oracle needs none


# --- the differential: the reference's engine against the port's -----------

def _tamper_cases(proof, cp):
    bad = json.loads(json.dumps(proof))
    bad["entry"] = bad["entry"][:-2] + (
        "00" if bad["entry"][-2:] != "00" else "01")
    yield bad, cp, NET
    if proof["entry_path"]:
        bad2 = json.loads(json.dumps(proof))
        bad2["entry_path"][0]["h"] = "11" * 32
        yield bad2, cp, NET
    forged = dict(cp)
    forged["signature"] = ("%02x" % (int(cp["signature"][:2], 16) ^ 1)) \
        + cp["signature"][2:]
    yield proof, forged, NET
    yield proof, cp, b"\x42" * 32


@pytest.mark.parametrize("hasher", sorted(HASHERS))
def test_engines_equal_the_reference(hasher):
    from stellar_core_tpu.bucket.bucket_list import BucketList as RefList
    from stellar_core_tpu_torch.bucket.bucket_list import BucketList
    rbl, pbl = RefList(), BucketList()
    reng, peng = ref_engine(interval=5), port_engine(hasher, interval=5)
    for ledger, *ids in churn_batches():
        rbl.add_batch(ledger, PROTO, *_ref_batch(ledger, *ids))
        pbl.add_batch(ledger, PROTO, *_port_batch(ledger, *ids))
        hh = sha256(b"header %d" % ledger)
        rcp = reng.on_close(rbl, ledger, hh)
        pcp = peng.on_close(pbl, ledger, hh)
        assert peng.root == reng.root, ledger
        assert pbl.get_hash() == rbl.get_hash()
        assert (pcp is None) == (rcp is None)
        if pcp is not None:
            assert pcp.to_json() == rcp.to_json()
            assert TC.checkpoint_sign_payload(
                NET, ledger, hh, pcp.merkle_root) == \
                JC.checkpoint_sign_payload(NET, ledger, hh, rcp.merkle_root)
    assert peng.root == peng.from_scratch_root(pbl)
    assert sorted(peng.checkpoints) == sorted(reng.checkpoints) == \
        [5, 10, 15, 20, 25, 30, 35, 40]
    assert peng.checkpoint(20) == reng.checkpoint(20)
    cp = peng.checkpoint()
    proved = 0
    for i in range(1, 80):
        pp = peng.prove_entry(port_acct_key(i))
        rp = reng.prove_entry(ref_acct_key(i))
        assert pp == rp, i
        if pp is None:
            continue
        proved += 1
        assert TC.light_client_verify(pp, cp, NET) == (True, "ok")
        assert JC.light_client_verify(pp, cp, NET) == (True, "ok")
        assert TC.light_client_verify(rp, reng.checkpoint(), NET) == \
            (True, "ok")
        for args in _tamper_cases(pp, cp):
            assert not TC.light_client_verify(*args)[0]
            assert TC.light_client_verify(*args) == \
                JC.light_client_verify(*args)
    assert proved > 20
    dead = [i for _l, _a, _b, deads in churn_batches() for i in deads]
    assert dead and all(peng.prove_entry(port_acct_key(i)) is None
                        for i in dead)


def test_sign_fail_skips_the_interval(tmp_path):
    from stellar_core_tpu.bucket.bucket_list import BucketList as RefList
    from stellar_core_tpu.util.faults import FaultInjector as RefFaults
    from stellar_core_tpu.util.metrics import MetricsRegistry as RefMetrics
    from stellar_core_tpu_torch.bucket.bucket_list import BucketList
    from stellar_core_tpu_torch.util.faults import FaultInjector
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.tracing import FlightRecorder, Tracer
    m, rm = MetricsRegistry(), RefMetrics()
    faults, rfaults = FaultInjector(metrics=m), RefFaults(metrics=rm)
    for f in (faults, rfaults):
        f.configure("commitment.sign-fail", probability=1.0, count=1)
    rec = FlightRecorder(Tracer(), m, out_dir=str(tmp_path))
    peng = port_engine("cpu", interval=4, metrics=m, faults=faults,
                       flight_recorder=rec)
    reng = ref_engine(interval=4, metrics=rm, faults=rfaults)
    rbl, pbl = RefList(), BucketList()
    for ledger, *ids in churn_batches(ledgers=12):
        rbl.add_batch(ledger, PROTO, *_ref_batch(ledger, *ids))
        pbl.add_batch(ledger, PROTO, *_port_batch(ledger, *ids))
        hh = sha256(b"h%d" % ledger)
        pcp, rcp = peng.on_close(pbl, ledger, hh), reng.on_close(rbl, ledger,
                                                                   hh)
        assert (pcp and pcp.to_json()) == (rcp and rcp.to_json())
    assert sorted(peng.checkpoints) == sorted(reng.checkpoints) == [8, 12]
    got = m.to_json()
    assert got["commitment.sign-fail"]["count"] == 1
    assert got["fault.injected.commitment.sign-fail"]["count"] == 1
    assert got["commitment.checkpoint.emitted"]["count"] == 2
    assert rec.dumps == 1 and "checkpoint-sign-fail" in rec.last_path
    with open(rec.last_path) as fh:
        assert json.load(fh)["extra"]["ledger_seq"] == 4
