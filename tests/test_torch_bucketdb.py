"""The port's BucketDB (`bucket/bucket_index.py`, its hooks in the bucket
manager and the SQL root's bucket routing) held against the JAX
package's.

Every case of `tests/test_bucketdb.py` (20) runs on both packages from
the reference's own source (`torch_mirror_harness.Mirror`), the port's
node being its own `main/application.py`. Every point read
(`BucketDB.lookup`: key, served, entry bytes), every batched prefetch
(`prefetch_batch`), every index BucketDB builds or loads (the SHA-256 of
its sidecar bytes), and every read outcome and index build, load and
load failure the cockpit counts (`BucketDbStats`) are recorded on both
sides, and the two records are equal, in order (each side's bucket
merges run on the closing thread here, so that the index builds happen in
the data's order, not the merge workers'). Port-only: the port's `BucketIndex.to_bytes` equals the
reference's for the same buckets, and each package loads the other's
sidecar; `lookup` and `prefetch_batch` answer the same for every key of a
seeded bucket list (live, tombstoned and absent keys) on both packages.
Key fingerprints stay one `hashlib` SHA-256 per key on the host, as the
reference's. Tolerance: none.
"""

import contextlib
import hashlib
import os
import random
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mirror_harness import Mirror, record_calls  # noqa: E402



@contextlib.contextmanager
def _inline_merges(pkg):
    """Each side's bucket merges run on the closing thread, so the order
    of index builds and the set of buckets indexed by the end of a case
    are the data's, not the merge workers' timing."""
    bm = __import__(pkg + ".bucket.bucket_manager", fromlist=["x"])
    init = bm.BucketManager.__init__

    def inline(self, *a, **kw):
        kw["background_merges"] = False
        init(self, *a, **kw)

    bm.BucketManager.__init__ = inline
    try:
        yield
    finally:
        bm.BucketManager.__init__ = init


@contextlib.contextmanager
def _record_bucketdb(pkg, log):
    bi = __import__(pkg + ".bucket.bucket_index", fromlist=["x"])
    with _inline_merges(pkg), record_calls(log, [
        (bi.BucketDB, "lookup", lambda out, db, kb: (kb, out)),
        (bi.BucketDB, "prefetch_batch",
         lambda out, db, kbs: (out[0], sorted(out[1].items()))),
        (bi.BucketDB, "_load_or_build", lambda out, db, b: hashlib.sha256(
            out.to_bytes()).hexdigest()),
        (bi.BucketDbStats, "record_read",
         lambda out, s, outcome, probes, nbytes=0: (outcome, list(probes),
                                                    nbytes)),
        (bi.BucketDbStats, "record_build", lambda out, s, secs: "build"),
        (bi.BucketDbStats, "record_load", lambda out, s, secs: "load"),
        (bi.BucketDbStats, "record_load_failure", lambda out, s: "fail"),
        (bi.BucketDbStats, "record_sql_fallback", lambda out, s: "sql"),
    ]):
        yield


MIRROR = Mirror(("test_bucketdb.py",), patch=_record_bucketdb)
CASES = MIRROR.cases()
# the cases that read no bucket list through BucketDB
NO_READS = ("test_in_memory_db_root_not_attached",
            "test_prefetched_set_is_lru_bounded",
            "test_bloom_contains_every_added_key_and_reports_density",
            "test_index_sidecar_roundtrip_and_corruption",
            "test_index_offsets_match_the_on_disk_file",
            "test_index_build_lookup_and_tombstones",
            "test_endpoint_without_buckets")


def test_mirrors_eighteen_cases():
    """All twenty, since the port has its admin endpoint."""
    assert len(CASES) == 20


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    sides = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        sides[side] = MIRROR.run(side, case, {"tmp_path": d})
    assert sides["port"] == sides["ref"]
    _f, name, _i = case
    if name not in NO_READS:
        assert any(k == "lookup" or k == "prefetch_batch"
                   for k, _v in sides["ref"]), "no BucketDB read"


# ------------------------------------------------------------ port-only

def _pkgs():
    import stellar_core_tpu as R
    import stellar_core_tpu_torch as P
    return {"ref": R.__name__, "port": P.__name__}


def _mod(pkg, name):
    return __import__(pkg + "." + name, fromlist=["x"])


def _seeded_entries(seed: int, n: int):
    """`n` accounts, trust lines and data entries of seeded keys and
    values, as LedgerEntry XDR (either package decodes them)."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.transactions.account_helpers import (
        make_account_entry,
    )
    rnd = random.Random(seed)
    out = []
    issuer = X.PublicKey.ed25519(sha256(b"bucketdb-issuer"))
    for i in range(n):
        pk = X.PublicKey.ed25519(sha256(b"bucketdb-%d-%d" % (seed, i)))
        kind = rnd.randrange(3)
        if kind == 0:
            e = make_account_entry(pk, rnd.randint(1, 10**12),
                                   rnd.randint(0, 10**6), 1)
        elif kind == 1:
            e = X.LedgerEntry(
                lastModifiedLedgerSeq=rnd.randint(1, 100),
                data=X.LedgerEntryData(
                    X.LedgerEntryType.TRUSTLINE,
                    X.TrustLineEntry(
                        accountID=pk, asset=X.Asset.credit("USD", issuer),
                        balance=rnd.randint(0, 10**6), limit=10**9,
                        flags=1, ext=X.TrustLineEntryExt(0, None))),
                ext=X._Ext.v0())
        else:
            e = X.LedgerEntry(
                lastModifiedLedgerSeq=rnd.randint(1, 100),
                data=X.LedgerEntryData(
                    X.LedgerEntryType.DATA,
                    X.DataEntry(accountID=pk, dataName="k%d" % i,
                                dataValue=rnd.randbytes(rnd.randint(1, 64)),
                                ext=X._Ext.v0())),
                ext=X._Ext.v0())
        out.append(e.to_xdr())
    return out


def _fresh_bucket(pkg, live_blobs, dead_key_blobs, protocol=13):
    X = _mod(pkg, "xdr")
    B = _mod(pkg, "bucket.bucket")
    live = [X.LedgerEntry.from_xdr(b) for b in live_blobs]
    dead = [X.LedgerKey.from_xdr(b) for b in dead_key_blobs]
    return B.Bucket.fresh(protocol, [], live, dead)


def _dead_keys(blobs):
    from stellar_core_tpu_torch import xdr as X
    return [X.ledger_entry_key(X.LedgerEntry.from_xdr(b)).to_xdr()
            for b in blobs]


@pytest.mark.parametrize("bits", [10, 4])
def test_sidecar_bytes_equal_and_cross_load(bits, tmp_path):
    """The same bucket (live entries and tombstones) indexes to the same
    sidecar bytes on both packages, and each package loads the other's
    sidecar to the same keys, offsets, lengths and bloom bits."""
    live = _seeded_entries(7, 300)
    dead = _dead_keys(_seeded_entries(8, 40))
    idx, raw, hashes = {}, {}, {}
    for side, pkg in _pkgs().items():
        b = _fresh_bucket(pkg, live, dead)
        idx[side] = _mod(pkg, "bucket.bucket_index").BucketIndex.build(
            b, bits_per_key=bits)
        raw[side] = idx[side].to_bytes()
        idx[side].save(str(tmp_path / ("%s.idx" % side)))
        hashes[side] = b.get_hash()
    assert hashes["port"] == hashes["ref"]
    assert raw["port"] == raw["ref"]
    assert len(idx["ref"]) == 340
    for side, pkg in _pkgs().items():
        other = "ref" if side == "port" else "port"
        BI = _mod(pkg, "bucket.bucket_index").BucketIndex
        got = BI.load(str(tmp_path / ("%s.idx" % other)),
                      expected_hash=hashes[other])
        want = idx[other]
        assert got.keys == want.keys and got.offsets == want.offsets
        assert got.lengths == want.lengths
        assert got.ordinals == want.ordinals
        assert bytes(got.bloom.bits) == bytes(want.bloom.bits)
        assert got.to_bytes() == raw[other]


class _ListManager:
    """A bucket manager's `bucket_list` over adopted buckets, for a
    BucketDB of either package."""

    def __init__(self, pkg, bucket_dir, batches):
        BM = _mod(pkg, "bucket.bucket_manager")
        X = _mod(pkg, "xdr")
        self.bm = BM.BucketManager(str(bucket_dir), background_merges=False)
        for seq, (init, live, dead) in enumerate(batches, start=2):
            self.bm.add_batch(
                seq, 13, [X.LedgerEntry.from_xdr(b) for b in init],
                [X.LedgerEntry.from_xdr(b) for b in live],
                [X.LedgerKey.from_xdr(b) for b in dead])


def test_lookup_equal_for_every_key_of_a_seeded_list(tmp_path):
    """Forty seeded closes (creations, updates, deletions) into each
    package's bucket list: every key ever written, every key deleted and
    absent keys read the same through both packages' `lookup` and
    `prefetch_batch`, the served bytes those of the last write, a
    tombstone and an absent key both None."""
    rnd = random.Random(4321)
    pool = _seeded_entries(11, 400)
    from stellar_core_tpu_torch import xdr as X
    keys = [X.ledger_entry_key(X.LedgerEntry.from_xdr(b)).to_xdr()
            for b in pool]
    state, batches, written = {}, [], set()
    for _ in range(40):
        init, live, dead = [], [], []
        for i in rnd.sample(range(len(pool)), 25):
            kb = keys[i]
            if kb in state and rnd.random() < 0.3:
                dead.append(kb)
                del state[kb]
                continue
            e = X.LedgerEntry.from_xdr(pool[i])
            e.lastModifiedLedgerSeq = len(batches) + 2
            (live if kb in state else init).append(e.to_xdr())
            state[kb] = e.to_xdr()
            written.add(kb)
        batches.append((init, live, dead))
    absent = [X.LedgerKey.account(X.PublicKey.ed25519(
        hashlib.sha256(b"absent-%d" % i).digest())).to_xdr()
        for i in range(50)]
    probe = sorted(written) + absent
    answers = {}
    for side, pkg in _pkgs().items():
        lm = _ListManager(pkg, tmp_path / side, batches)
        db = lm.bm.bucketdb
        point = [db.lookup(kb) for kb in probe]
        served, batch = db.prefetch_batch(probe)
        answers[side] = (lm.bm.get_hash(), point, served,
                         [batch[kb] for kb in probe])
        lm.bm.shutdown()
    assert answers["port"] == answers["ref"]
    _h, point, served, batch = answers["port"]
    assert served
    for kb, (ok, blob), b2 in zip(probe, point, batch):
        assert ok and blob == b2 == state.get(kb)
    assert sum(1 for kb in written if kb not in state) > 0
