"""The port's state-commitment entry roots against the JAX package's.

- `merkle_root`, `merkle_path` and `merkle_climb` equal the reference's for
  every size from 0 to 33 and every index.
- `entry_root(records)` over the XDR records of a real JAX `Bucket`
  (built by `Bucket.fresh` from accounts, trustlines, offers, data entries
  and tombstones) equals `StateCommitmentEngine.entry_root(bucket)`, with
  `CpuBatchHasher` and `CudaBatchHasher(device="cpu")`; without a hasher
  it raises rather than hash on the host.
- The entry bodies that `chip_smoke.py`'s generator writes
  (`testing/entries.py`) equal the reference codec's
  `entry_record(e)[4:]` byte for byte for each kind and every signer
  count, so its leaf-length table is the codec's.
Tolerance: none.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import stellar_core_tpu.xdr as X
from stellar_core_tpu.bucket.bucket import Bucket, entry_record
from stellar_core_tpu.crypto.hashing import sha256 as jax_sha256
from stellar_core_tpu.ledger import state_commitment as JC
from stellar_core_tpu_torch.crypto.batch_hasher import (
    CpuBatchHasher, CudaBatchHasher,
)
from stellar_core_tpu_torch.crypto.hashing import SHA256, sha256
from stellar_core_tpu_torch.ledger import state_commitment as TC
from stellar_core_tpu_torch.testing import entries as TE

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
