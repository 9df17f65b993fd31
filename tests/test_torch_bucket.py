"""The port's bucket layer (`stellar_core_tpu_torch.bucket`) against the
JAX package's.

- The cases of `tests/test_bucket.py` that need no `Application` and no
  ledgertxn (its lines 34-249 and 302-456), run against the port: level
  arithmetic, the spill schedule through a real list, merge lifecycle
  semantics, manager adoption, GC and `assume_state`, shadowing, a single
  entry bubbling down, and the skip list. Left out, because the port has
  neither layer yet: `test_apply_buckets_restores_state` (the applicator
  writes through ledgertxn) and `test_skip_list_nonzero_in_closed_headers`
  (it closes ledgers through the reference's Application).
- A differential: the same seeded batches (accounts, trustlines, offers,
  data entries of `testing/entries.py`, with updates and tombstones, and a
  pre-12 protocol run with shadows) through the reference's and the port's
  `BucketList` give identical bucket hashes, level hashes and
  `BucketList.get_hash()` after every ledger, and identical bucket files.
- State carried across: bucket files written by the reference's
  `BucketManager` for a churned list are restored by the port's
  `assume_state` from that directory, with the same `get_hash()`, the
  same commitment root and the same proofs, and both lists stay equal
  over further closes.
The reference's accounts come from its `make_account_entry`; the port's
side builds the same entries from its own XDR classes (`make_account_entry`
below), and a test holds the two byte for byte. Tolerance: none.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

import stellar_core_tpu.xdr as RX
import stellar_core_tpu_torch.xdr as X
from stellar_core_tpu.bucket import BucketManager as RefBucketManager
from stellar_core_tpu.bucket.bucket_list import BucketList as RefBucketList
from stellar_core_tpu.crypto.keys import SecretKey as RefSecretKey
from stellar_core_tpu.ledger import state_commitment as JC
from stellar_core_tpu.testing import genesis_header as ref_genesis_header
from stellar_core_tpu.transactions.account_helpers import (
    make_account_entry as ref_make_account_entry,
)
from stellar_core_tpu_torch.bucket import (
    Bucket, BucketManager, K_NUM_LEVELS, level_half, level_should_spill,
    level_size, mask, merge_buckets, oldest_ledger_in_curr,
    oldest_ledger_in_snap, size_of_curr, size_of_snap,
)
from stellar_core_tpu_torch.bucket.bucket import bucket_entry_sort_key
from stellar_core_tpu_torch.bucket.bucket_list import BucketList
from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ledger import state_commitment as TC
from stellar_core_tpu_torch.testing import entries as TE

PROTO = 13


def make_account_entry(account_id, balance: int, seq_num: int,
                       last_modified: int = 0) -> X.LedgerEntry:
    """The port's twin of the reference's
    `transactions/account_helpers.make_account_entry`."""
    acc = X.AccountEntry(
        accountID=account_id, balance=balance, seqNum=seq_num,
        numSubEntries=0, inflationDest=None, flags=0, homeDomain="",
        thresholds=bytes([1, 0, 0, 0]), signers=[],
        ext=X.AccountEntryExt.v0())
    return X.LedgerEntry(
        lastModifiedLedgerSeq=last_modified,
        data=X.LedgerEntryData(X.LedgerEntryType.ACCOUNT, acc),
        ext=X._Ext.v0())


def acct(i: int) -> X.LedgerEntry:
    key = X.PublicKey.ed25519(i.to_bytes(32, "big"))
    return make_account_entry(key, 10 ** 9, 0, 1)


def acct_key(i: int) -> X.LedgerKey:
    return X.LedgerKey.account(X.PublicKey.ed25519(i.to_bytes(32, "big")))


def ref_acct(i: int) -> RX.LedgerEntry:
    key = RX.PublicKey.ed25519(i.to_bytes(32, "big"))
    return ref_make_account_entry(key, 10 ** 9, 0, 1)


def test_account_helper_equals_the_reference():
    for i in (0, 1, 77, 2 ** 40):
        assert acct(i).to_xdr() == ref_acct(i).to_xdr()
    pk = X.PublicKey.ed25519(b"\x05" * 32)
    rpk = RX.PublicKey.ed25519(b"\x05" * 32)
    assert make_account_entry(pk, 9, 3, 4).to_xdr() == \
        ref_make_account_entry(rpk, 9, 3, 4).to_xdr()


# --- level arithmetic -------------------------------------------------------

def test_level_sizes_match_reference_table():
    assert [level_size(i) for i in range(4)] == [4, 16, 64, 256]
    assert level_size(10) == 0x400000
    assert [level_half(i) for i in range(4)] == [2, 8, 32, 128]


def test_level_should_spill_series():
    for lv, at in [(0, [2, 4, 6]), (1, [8, 16, 24]), (2, [32, 64, 96]),
                   (3, [128, 256, 384])]:
        for ledger in at:
            assert level_should_spill(ledger, lv)
        assert not level_should_spill(at[0] + 1, lv)
    assert not level_should_spill(1 << 22, K_NUM_LEVELS - 1)


def test_sizes_partition_the_ledger_range():
    for ledger in list(range(1, 300)) + [1000, 4096, 65536, 100000]:
        total = sum(size_of_curr(ledger, lv) + size_of_snap(ledger, lv)
                    for lv in range(K_NUM_LEVELS))
        assert total == ledger, ledger


def test_oldest_ledger_relations():
    for ledger in (1, 2, 7, 8, 9, 63, 64, 65, 257, 1025):
        prev_oldest = ledger + 1
        for lv in range(K_NUM_LEVELS):
            for size, oldest in (
                    (size_of_curr(ledger, lv),
                     oldest_ledger_in_curr(ledger, lv)),
                    (size_of_snap(ledger, lv),
                     oldest_ledger_in_snap(ledger, lv))):
                if size == 0:
                    assert oldest == 0xFFFFFFFF
                    continue
                assert oldest + size == prev_oldest
                prev_oldest = oldest


def test_level_arithmetic_equals_the_reference():
    from stellar_core_tpu.bucket import bucket_list as RL
    for ledger in list(range(1, 600)) + [4095, 4096, 65536, 100001]:
        for lv in range(K_NUM_LEVELS):
            assert (size_of_curr(ledger, lv), size_of_snap(ledger, lv),
                    oldest_ledger_in_curr(ledger, lv),
                    oldest_ledger_in_snap(ledger, lv),
                    level_should_spill(ledger, lv),
                    mask(ledger, level_half(lv))) == (
                RL.size_of_curr(ledger, lv), RL.size_of_snap(ledger, lv),
                RL.oldest_ledger_in_curr(ledger, lv),
                RL.oldest_ledger_in_snap(ledger, lv),
                RL.level_should_spill(ledger, lv),
                RL.mask(ledger, RL.level_half(lv)))


# --- simulated list accuracy ------------------------------------------------

def test_bucket_list_sizeof_accuracy():
    mgr = BucketManager(background_merges=False)
    bl = mgr.bucket_list
    for ledger in range(1, 130):
        bl.add_batch(ledger, PROTO, [acct(ledger)], [], [])
        bl.resolve_all_futures()
        assert len(bl.get_level(0).curr.payload_entries()) == \
            size_of_curr(ledger, 0)
        assert len(bl.get_level(0).snap.payload_entries()) == \
            size_of_snap(ledger, 0)
        total = sum(len(lev.curr.payload_entries()) +
                    len(lev.snap.payload_entries())
                    for lev in bl.levels)
        assert total == ledger


def test_bucket_list_counts_with_committed_levels():
    mgr = BucketManager(background_merges=False)
    bl = mgr.bucket_list
    n = 64
    for ledger in range(1, n + 1):
        bl.add_batch(ledger, PROTO, [acct(ledger)], [], [])
        bl.resolve_all_futures()
    assert len(bl.get_level(0).curr.payload_entries()) == \
        size_of_curr(n, 0)
    assert len(bl.get_level(0).snap.payload_entries()) == \
        size_of_snap(n, 0)
    h1 = bl.get_hash()
    bl.add_batch(n + 1, PROTO, [acct(n + 1)], [], [])
    assert bl.get_hash() != h1


# --- merge semantics --------------------------------------------------------

def test_fresh_bucket_sorted_with_meta():
    b = Bucket.fresh(PROTO, [acct(3), acct(1)], [acct(2)], [acct_key(9)])
    entries = b.entries
    assert entries[0].disc == X.BucketEntryType.METAENTRY
    assert entries[0].value.ledgerVersion == PROTO
    keys = [bucket_entry_sort_key(e) for e in entries[1:]]
    assert keys == sorted(keys)
    assert len(entries) == 5


def test_fresh_bucket_pre11_demotes_init():
    b = Bucket.fresh(10, [acct(1)], [], [])
    assert all(e.disc != X.BucketEntryType.METAENTRY for e in b.entries)
    assert b.entries[0].disc == X.BucketEntryType.LIVEENTRY


def test_fresh_bucket_rejects_duplicates():
    with pytest.raises(ValueError):
        Bucket.fresh(PROTO, [acct(1)], [acct(1)], [])


def test_merge_newer_wins():
    e_old = acct(1)
    e_new = acct(1)
    e_new.data.value.balance = 777
    old = Bucket.fresh(PROTO, [], [e_old], [])
    new = Bucket.fresh(PROTO, [], [e_new], [])
    m = merge_buckets(old, new)
    assert len(m.payload_entries()) == 1
    assert m.payload_entries()[0].value.data.value.balance == 777


def test_merge_init_plus_dead_annihilates():
    old = Bucket.fresh(PROTO, [acct(1)], [], [])
    new = Bucket.fresh(PROTO, [], [], [acct_key(1)])
    m = merge_buckets(old, new)
    assert len(m.payload_entries()) == 0
    assert m.is_empty()


def test_merge_dead_plus_init_becomes_live():
    old = Bucket.fresh(PROTO, [], [], [acct_key(1)])
    new = Bucket.fresh(PROTO, [acct(1)], [], [])
    m = merge_buckets(old, new)
    [e] = m.payload_entries()
    assert e.disc == X.BucketEntryType.LIVEENTRY


def test_merge_init_plus_live_stays_init():
    e2 = acct(1)
    e2.data.value.balance = 55
    old = Bucket.fresh(PROTO, [acct(1)], [], [])
    new = Bucket.fresh(PROTO, [], [e2], [])
    m = merge_buckets(old, new)
    [e] = m.payload_entries()
    assert e.disc == X.BucketEntryType.INITENTRY
    assert e.value.data.value.balance == 55


def test_merge_drop_dead_at_bottom_level():
    old = Bucket.fresh(PROTO, [], [acct(1)], [])
    new = Bucket.fresh(PROTO, [], [], [acct_key(1), acct_key(2)])
    m = merge_buckets(old, new, keep_dead_entries=False)
    assert len(m.payload_entries()) == 0


def test_merge_keeps_tombstones_on_upper_levels():
    old = Bucket.fresh(PROTO, [], [acct(1)], [])
    new = Bucket.fresh(PROTO, [], [], [acct_key(1)])
    m = merge_buckets(old, new, keep_dead_entries=True)
    [e] = m.payload_entries()
    assert e.disc == X.BucketEntryType.DEADENTRY


def test_merge_protocol_version_is_max_of_inputs():
    old = Bucket.fresh(12, [acct(1)], [], [])
    new = Bucket.fresh(PROTO, [acct(2)], [], [])
    m = merge_buckets(old, new)
    assert m.get_version() == PROTO
    with pytest.raises(ValueError):
        merge_buckets(old, new, max_protocol_version=12)


# --- manager ----------------------------------------------------------------

def test_bucket_manager_adoption_and_file_roundtrip(tmp_path):
    mgr = BucketManager(str(tmp_path), background_merges=False)
    b = mgr.adopt_bucket(Bucket.fresh(PROTO, [acct(1), acct(2)], [], []))
    assert b.path and os.path.exists(b.path)
    again = Bucket.read_from(b.path)
    assert again.get_hash() == b.get_hash()
    assert mgr.get_bucket_by_hash(b.get_hash()) is b
    b2 = mgr.adopt_bucket(Bucket.fresh(PROTO, [acct(1), acct(2)], [], []))
    assert b2 is b


def test_bucket_manager_gc(tmp_path):
    mgr = BucketManager(str(tmp_path), background_merges=False)
    stray = mgr.adopt_bucket(Bucket.fresh(PROTO, [acct(99)], [], []))
    for ledger in range(1, 10):
        mgr.add_batch(ledger, PROTO, [acct(ledger)], [], [])
    mgr.bucket_list.resolve_all_futures()
    path = stray.path
    dropped = mgr.forget_unreferenced_buckets()
    assert dropped >= 1
    assert not os.path.exists(path)
    for lv in mgr.bucket_list.levels:
        if not lv.curr.is_empty():
            assert mgr.get_bucket_by_hash(lv.curr.get_hash()) is not None


def test_assume_state_restores_hash(tmp_path):
    mgr = BucketManager(str(tmp_path), background_merges=False)
    for ledger in range(1, 24):
        mgr.add_batch(ledger, PROTO, [acct(ledger)], [], [])
    mgr.bucket_list.resolve_all_futures()
    want = mgr.get_hash()
    levels = [{"curr": lv.curr.get_hash(), "snap": lv.snap.get_hash()}
              for lv in mgr.bucket_list.levels]

    mgr2 = BucketManager(str(tmp_path), background_merges=False)
    mgr2.assume_state(levels, 23, PROTO)
    mgr2.bucket_list.resolve_all_futures()
    assert mgr2.get_hash() == want


def test_add_batch_is_main_thread_only(tmp_path):
    import threading
    from stellar_core_tpu_torch.util import threads
    mgr = BucketManager(background_merges=False)
    errs = []
    threads.arm()
    try:
        def off_main():
            try:
                mgr.add_batch(1, PROTO, [acct(1)], [], [])
            except threads.ThreadDisciplineError as e:
                errs.append(e)
        t = threading.Thread(target=off_main)
        t.start()
        t.join()
        mgr.add_batch(1, PROTO, [acct(1)], [], [])     # the bound thread
    finally:
        threads.disarm()
    assert len(errs) == 1
    assert "BucketManager.add_batch" in threads.MAIN_THREAD_REGISTRY


# --- list-level structural behaviors ----------------------------------------

def _account_entry(i, balance):
    sk = SecretKey.from_seed(bytes([i & 0xFF]) + b"\x51" * 31)
    return make_account_entry(X.PublicKey.ed25519(sk.public_key), balance, 1)


def _contains_key(bucket, entry):
    want = X.ledger_entry_key(entry).to_xdr()
    for e in bucket.payload_entries():
        if e.disc == X.BucketEntryType.DEADENTRY:
            if e.value.to_xdr() == want:
                return True
        elif X.ledger_entry_key(e.value).to_xdr() == want:
            return True
    return False


@pytest.mark.parametrize("version", [9, 13])
def test_hot_entries_shadowing_stays_in_top_levels(version):
    bl = BucketList()
    alice = _account_entry(1, 100)
    bob = _account_entry(2, 100)
    total = 400
    deep_sunk = False
    for i in range(1, total + 1):
        alice.data.value.balance += 1
        bob.data.value.balance += 1
        bl.add_batch(i, version, [], [alice, bob], [])
        if i % 100 == 0:
            for j in (0, 1):
                lev = bl.get_level(j)
                assert _contains_key(lev.curr, alice) or \
                    _contains_key(lev.snap, alice)
                assert _contains_key(lev.curr, bob) or \
                    _contains_key(lev.snap, bob)
            for j in range(2, K_NUM_LEVELS):
                lev = bl.get_level(j)
                has = _contains_key(lev.curr, alice) or \
                    _contains_key(lev.snap, alice)
                if version < 12 or j > 5:
                    assert not has, (version, i, j)
                elif has:
                    deep_sunk = True
    if version >= 12:
        assert deep_sunk


@pytest.mark.parametrize("version", [9, 13])
def test_single_entry_bubbling_up(version):
    bl = BucketList()
    e = _account_entry(3, 777)
    bl.add_batch(1, version, [], [e], [])
    for i in range(2, 300):
        bl.add_batch(i, version, [], [], [])
        for j in range(K_NUM_LEVELS):
            lev = bl.get_level(j)
            if lev.next.is_live():
                lev.next.resolve()
            n_curr = len(lev.curr.payload_entries())
            n_snap = len(lev.snap.payload_entries())
            covers = False
            for size, oldest in (
                    (size_of_curr(i, j), oldest_ledger_in_curr(i, j)),
                    (size_of_snap(i, j), oldest_ledger_in_snap(i, j))):
                if size and oldest <= 1 < oldest + size:
                    covers = True
            if covers:
                assert n_curr + n_snap == 1, (version, i, j)
            else:
                assert n_curr == 0 and n_snap == 0, (version, i, j)


# --- skip list --------------------------------------------------------------

def _header_at(seq: int, blh: bytes) -> X.LedgerHeader:
    h = X.LedgerHeader.from_xdr(ref_genesis_header().to_xdr())
    h.ledgerSeq = seq
    h.bucketListHash = blh
    return h


def test_skip_list_reference_port():
    from stellar_core_tpu_torch.bucket.bucket_manager import (
        SKIP_1, SKIP_2, calculate_skip_values,
    )
    zero = b"\x00" * 32
    blh = bytes(range(32))

    h = _header_at(5, blh)
    calculate_skip_values(h)
    assert h.skipList == [zero] * 4

    h.ledgerSeq = SKIP_1
    calculate_skip_values(h)
    assert h.skipList == [blh, zero, zero, zero]

    blh2 = bytes(range(1, 33))
    h.ledgerSeq = SKIP_1 * 2
    h.bucketListHash = blh2
    calculate_skip_values(h)
    assert h.skipList == [blh2, zero, zero, zero]

    h.ledgerSeq = SKIP_1 * 2 + 1
    h.bucketListHash = blh
    calculate_skip_values(h)
    assert h.skipList == [blh2, zero, zero, zero]

    h.ledgerSeq = SKIP_2 + SKIP_1
    blh3 = bytes(range(2, 34))
    h.bucketListHash = blh3
    calculate_skip_values(h)
    assert h.skipList == [blh3, blh2, zero, zero]

    h2 = _header_at(SKIP_2, blh)
    h2.skipList = [blh2, zero, zero, zero]
    calculate_skip_values(h2)
    assert h2.skipList == [blh, zero, zero, zero]


def test_skip_list_deep_cascade():
    from stellar_core_tpu_torch.bucket.bucket_manager import (
        SKIP_1, SKIP_2, calculate_skip_values,
    )
    from stellar_core_tpu_torch.crypto.hashing import sha256
    zero = b"\x00" * 32
    h = _header_at(0, zero)
    h.skipList = [zero] * 4
    expect = [zero] * 4
    for seq in range(1, SKIP_2 * 2 + SKIP_1 + 1):
        blh = sha256(b"blh%d" % seq)
        h.ledgerSeq = seq
        h.bucketListHash = blh
        calculate_skip_values(h)
        if seq % SKIP_1 == 0:
            v = seq - SKIP_1
            if v > 0 and v % SKIP_2 == 0:
                expect[1] = expect[0]
            expect[0] = blh
        assert h.skipList == expect, seq


def test_snapshot_ledger_equals_the_reference():
    from stellar_core_tpu.bucket.bucket_manager import \
        calculate_skip_values as ref_calc
    from stellar_core_tpu_torch.bucket.bucket_manager import (
        SKIP_1, SKIP_2, SKIP_3, calculate_skip_values,
    )
    rh = ref_genesis_header()
    h = X.LedgerHeader.from_xdr(rh.to_xdr())
    for seq in list(range(SKIP_1, SKIP_2 * 3, SKIP_1)) + [
            SKIP_3 + SKIP_2 + SKIP_1]:
        blh = seq.to_bytes(32, "big")
        rh.ledgerSeq = h.ledgerSeq = seq
        rh.bucketListHash = h.bucketListHash = blh
        ref_calc(rh)
        calculate_skip_values(h)
        assert h.to_xdr() == rh.to_xdr(), seq


# --- the differential: the same batches through both lists -----------------

class Churn:
    """Seeded close batches of `testing/entries.py` entries (all five
    kinds) with updates and tombstones, built as XDR bodies once and
    decoded by each package's codec."""

    def __init__(self, seed: int, ledgers: int, per_ledger: int = 6):
        rng = np.random.default_rng(seed)
        self.batches = []
        live = []                     # bodies of live entries
        for seq in range(1, ledgers + 1):
            inits = TE.entry_records(rng, int(rng.integers(1, per_ledger)))
            n_up = min(len(live), int(rng.integers(0, 4)))
            n_dead = min(len(live) - n_up, int(rng.integers(0, 2)))
            pick = rng.choice(len(live), n_up + n_dead, replace=False) \
                if n_up + n_dead else []
            picked = [live[i] for i in pick]
            ups = [_bump(b, seq) for b in picked[:n_up]]
            deads = picked[n_up:]
            for i in sorted(pick, reverse=True):
                live.pop(int(i))
            live += inits + ups
            self.batches.append((seq, inits, ups, deads))

    def run(self, pkg, add_batch, proto=PROTO):
        """Feed every batch to `add_batch(seq, proto, inits, lives,
        deads)` in `pkg`'s own objects; yields after each ledger."""
        def entry(body):
            return pkg.BucketEntry.from_xdr(body).value
        for seq, inits, ups, deads in self.batches:
            add_batch(seq, proto, [entry(b) for b in inits],
                      [entry(b) for b in ups],
                      [pkg.ledger_entry_key(entry(b)) for b in deads])
            yield seq


def _bump(body: bytes, seq: int) -> bytes:
    """The same entry with lastModifiedLedgerSeq = seq (bytes 4..8 of a
    LIVEENTRY body)."""
    return body[:4] + seq.to_bytes(4, "big") + body[8:]


def _bucket_hashes(bl):
    return [(lev.curr.get_hash(), lev.snap.get_hash(), lev.get_hash())
            for lev in bl.levels]


@pytest.mark.parametrize("proto", [9, 11, PROTO])
def test_bucket_lists_equal_the_reference(proto):
    churn = Churn(seed=proto, ledgers=70)
    ref, port = RefBucketList(), BucketList()
    for _a, _b in zip(churn.run(RX, ref.add_batch, proto),
                      churn.run(X, port.add_batch, proto)):
        assert _bucket_hashes(port) == _bucket_hashes(ref), _a
        assert port.get_hash() == ref.get_hash()
    ref.resolve_all_futures()
    port.resolve_all_futures()
    for rl, pl in zip(ref.levels, port.levels):
        assert pl.next.is_live() == rl.next.is_live()
        if pl.next.is_live():
            assert pl.next.resolve().get_hash() == \
                rl.next.resolve().get_hash()


def test_bucket_files_equal_the_reference(tmp_path):
    churn = Churn(seed=5, ledgers=40)
    ref = RefBucketManager(str(tmp_path / "ref"), background_merges=False)
    port = BucketManager(str(tmp_path / "port"), background_merges=False)
    for _ in zip(churn.run(RX, ref.add_batch), churn.run(X, port.add_batch)):
        pass
    assert port.get_hash() == ref.get_hash()

    def files(d):     # bucket files; the reference adds BucketDB sidecars
        return sorted(n for n in os.listdir(tmp_path / d)
                      if n.endswith(".xdr"))
    names = files("ref")
    assert names == files("port") and names
    for n in names:
        assert (tmp_path / "ref" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes(), n
    assert port.forget_unreferenced_buckets() == \
        ref.forget_unreferenced_buckets()
    assert files("ref") == files("port")


def test_background_merges_equal_synchronous():
    churn = Churn(seed=8, ledgers=70)
    sync, bg = BucketManager(background_merges=False), \
        BucketManager(background_merges=True)
    try:
        for _ in zip(churn.run(X, sync.add_batch),
                     churn.run(X, bg.add_batch)):
            assert bg.get_hash() == sync.get_hash()
    finally:
        bg.shutdown()


# --- state carried across: the reference's files, the port's assume_state --

NET = b"\x4e" * 32
SEED = bytes(range(32))


def _levels(bl):
    out = []
    for lev in bl.levels:
        d = {"curr": lev.curr.get_hash(), "snap": lev.snap.get_hash()}
        if lev.next.is_live():
            d["next_output"] = lev.next.resolve().get_hash()
        out.append(d)
    return out


def test_assume_state_from_the_reference_files(tmp_path):
    churn = Churn(seed=21, ledgers=90)
    ref = RefBucketManager(str(tmp_path), background_merges=False)
    churn.batches = churn.batches[:75]
    for _ in churn.run(RX, ref.add_batch):
        pass
    ref.bucket_list.resolve_all_futures()
    levels = _levels(ref.bucket_list)
    assert any("next_output" in d for d in levels)

    port = BucketManager(str(tmp_path / "."), background_merges=False)
    port.assume_state(levels, 75, PROTO)
    assert port.get_hash() == ref.get_hash()
    assert _bucket_hashes(port.bucket_list) == _bucket_hashes(ref.bucket_list)

    # the same commitment root and the same proofs
    cfg = SimpleNamespace(network_id=NET, STATE_CHECKPOINT_INTERVAL=1)
    jeng = JC.StateCommitmentEngine(SimpleNamespace(
        metrics=None, config=SimpleNamespace(NODE_SEED=RefSecretKey(SEED),
                                             **vars(cfg))))
    teng = TC.StateCommitmentEngine(SimpleNamespace(
        metrics=None, batch_hasher=make_hasher("cpu"),
        config=SimpleNamespace(NODE_SEED=SecretKey(SEED), **vars(cfg))))
    hh = b"\x11" * 32
    jcp = jeng.on_close(ref.bucket_list, 75, hh)
    tcp = teng.on_close(port.bucket_list, 75, hh)
    assert teng.root == jeng.root == teng.from_scratch_root(port.bucket_list)
    assert tcp.to_json() == jcp.to_json()
    keys = []
    for lev in ref.bucket_list.levels:
        for b in (lev.curr, lev.snap):
            for e in b.payload_entries()[:3]:
                keys.append(e.value if e.disc == 1 else
                            RX.ledger_entry_key(e.value))
    assert len(keys) > 10
    for k in keys:
        jp = jeng.prove_entry(k)
        tp = teng.prove_entry(X.LedgerKey.from_xdr(k.to_xdr()))
        assert tp == jp
        if tp is not None:
            assert TC.light_client_verify(tp, tcp.to_json(), NET) == \
                (True, "ok")

    # and both lists stay equal over the remaining closes
    rest = Churn(seed=21, ledgers=90)
    rest.batches = rest.batches[75:]
    for _ in zip(rest.run(RX, ref.add_batch), rest.run(X, port.add_batch)):
        assert port.get_hash() == ref.get_hash()
