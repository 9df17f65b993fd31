"""The port's history publish and catchup held against the JAX package's.

The publisher is the reference's (`tests/test_catchup.py`'s `make_app`
plus `close_ledgers_with_traffic`, checkpoints of 8 ledgers), once per
module: it closes 19 ledgers, a payment in most, and publishes
checkpoints 7 and 15 to a local-directory archive. Port nodes
(`tests/torch_catchup_harness.py`: sqlite, a bucket directory, the C
verifier and `make_hasher("cpu")`) catch up from that archive, complete,
minimal and online from a gap with buffered values; every header the
port stores equals the reference publisher's `ledgerheaders` row, and
the bucket-list hash and the account rows equal a reference node's at
the same ledger. A port publisher closes the reference publisher's own
values (rebuilt from its SQL) and publishes: its ledger, transactions
and results files equal the reference's once decompressed, as do the
bucket lists its HAS names and their files, and a reference node catches
up from it. Corrupt archives and a wrong trusted anchor fail the catchup
on both packages. Tolerance: none.
"""

import gzip
import os
import shutil

import pytest

from stellar_core_tpu.catchup import (
    CatchupConfiguration as RCatchupConfiguration,
    calculate_catchup_range as r_range,
)
from stellar_core_tpu.catchup.catchup_work import CatchupWork as RCatchupWork
from stellar_core_tpu.crypto import keys as RK
from stellar_core_tpu.crypto.batch_verifier import (
    CpuSigVerifier as RCpuSigVerifier,
)
from stellar_core_tpu.history import checkpoints as RC
from stellar_core_tpu.work.basic_work import State as RState
from stellar_core_tpu_torch.catchup import (
    CatchupConfiguration, calculate_catchup_range,
)
from stellar_core_tpu_torch.catchup.catchup_work import CatchupWork
from stellar_core_tpu_torch.crypto import keys as K
from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
from stellar_core_tpu_torch.history import checkpoints as C
from stellar_core_tpu_torch.history.archive import category_path
from stellar_core_tpu_torch.history.archive_state import HistoryArchiveState
from stellar_core_tpu_torch.ledger.ledger_manager import LedgerManagerState
from stellar_core_tpu_torch.work.basic_work import State

from test_catchup import (
    FREQ, close_ledgers_with_traffic, make_app, run_work as r_run_work,
)
from torch_catchup_harness import (
    account_rows, close_values, crank_until, header_hashes, lcd_from_db,
    make_port_app, run_work, stop,
)

TIP = 2 * FREQ - 1          # the archive's last checkpoint
TOP = 2 * FREQ + 3          # the publisher's LCL


# ---------------------------------------------------------------- arithmetic

def test_checkpoint_arithmetic_matches_reference():
    for freq in (8, 64):
        for ledger in range(1, 4 * freq):
            assert C.checkpoint_containing(ledger, freq) == \
                RC.checkpoint_containing(ledger, freq)
            assert C.is_last_in_checkpoint(ledger, freq) == \
                RC.is_last_in_checkpoint(ledger, freq)
            assert list(C.checkpoints_in_range(ledger, 3 * freq, freq)) == \
                list(RC.checkpoints_in_range(ledger, 3 * freq, freq))
        for c in range(freq - 1, 4 * freq, freq):
            assert C.first_in_checkpoint(c, freq) == \
                RC.first_in_checkpoint(c, freq)
    # the reference test's own values
    assert C.checkpoint_containing(64, 64) == 127
    assert C.first_in_checkpoint(127, 64) == 64
    assert list(C.checkpoints_in_range(1, 130, 64)) == [63, 127, 191]


def _plan(r):
    return (r.apply_buckets, r.apply_buckets_at, r.replay_first,
            r.replay_last, r.replay_count())


@pytest.mark.parametrize("mode", ["complete", "minimal", "recent"])
def test_catchup_range_matches_reference(mode):
    """Every (lcl, target) pair below three checkpoints of 64 plans the
    same bucket-apply point and replay range in both packages, and the
    reference tests' cases hold."""
    count = {"complete": 2**32 - 1, "minimal": 0, "recent": 10}[mode]
    for lcl in range(1, 200, 3):
        for to in range(lcl + 1, 200, 5):
            got = calculate_catchup_range(
                lcl, CatchupConfiguration(to, count), 64)
            want = r_range(lcl, RCatchupConfiguration(to, count), 64)
            assert _plan(got) == _plan(want), (lcl, to)
    if mode == "complete":
        r = calculate_catchup_range(1, CatchupConfiguration(100, count), 64)
        assert not r.apply_buckets and (r.replay_first, r.replay_last) == \
            (2, 100)
    elif mode == "minimal":
        r = calculate_catchup_range(1, CatchupConfiguration(127, 0), 64)
        assert r.apply_buckets and r.apply_buckets_at == 127
        assert r.replay_count() == 0
        r = calculate_catchup_range(1, CatchupConfiguration(100, 0), 64)
        assert (r.apply_buckets_at, r.replay_first, r.replay_last) == \
            (63, 64, 100)
    else:
        r = calculate_catchup_range(120, CatchupConfiguration(127, 10), 64)
        assert not r.apply_buckets
        assert (r.replay_first, r.replay_last) == (121, 127)


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def publisher(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("publisher")
    archive_root = tmp / "archive"
    os.makedirs(archive_root)
    app = make_app(tmp, 0, archive_root)
    close_ledgers_with_traffic(app, TOP)
    app.crank_until(lambda: app.history_manager.publish_queue() == [],
                    max_cranks=5000)
    assert app.history_manager.published_checkpoints == 2
    yield app, archive_root
    app.stop()


def port_node(tmp_path, name, archive_root, **kw):
    return make_port_app(tmp_path / name, archives=[("test", archive_root)],
                         freq=FREQ, **kw)


def ref_node(tmp_path, n, archive_root):
    return make_app(tmp_path, n, archive_root, writable=False)


def copy_archive(archive_root, tmp_path):
    dst = tmp_path / "archive-copy"
    shutil.copytree(archive_root, dst)
    return dst


def flip_gz(path, offset):
    raw = bytearray(gzip.decompress(path.read_bytes()))
    raw[offset] ^= 0xFF
    path.write_bytes(gzip.compress(bytes(raw)))


def assert_chain(port_app, ref_db, lo, hi):
    """Every header the port stored in [lo, hi] equals the reference's."""
    got = header_hashes(port_app.database, lo, hi)
    want = header_hashes(ref_db, lo, hi)
    assert len(got) == hi - lo + 1 and got == want


# ---------------------------------------------------------------- catchup

@pytest.mark.parametrize("mode", ["complete", "minimal"])
def test_port_catches_up_from_reference_archive(publisher, tmp_path, mode):
    ref_pub, archive_root = publisher
    cfg = {"complete": CatchupConfiguration.complete,
           "minimal": CatchupConfiguration.minimal}[mode]()
    b = port_node(tmp_path, "port", archive_root)
    replayed = []
    close = b.ledger_manager.close_ledger

    def recording_close(lcd):
        close(lcd)
        replayed.append((lcd.ledger_seq, b.ledger_manager.lcl_hash.hex()))

    b.ledger_manager.close_ledger = recording_close
    work = b.catchup_manager.start_catchup(cfg)
    assert run_work(b, work) == State.SUCCESS
    lm = b.ledger_manager
    assert lm.last_closed_ledger_num() == TIP and lm.is_synced()
    want = header_hashes(ref_pub.database, 1, TIP)
    # each replayed close's lcl_hash is the publisher's, ledger by ledger
    assert replayed == [(s, want[s]) for s in
                        range(2 if mode == "complete" else TIP + 1,
                              TIP + 1)]
    if mode == "complete":
        assert_chain(b, ref_pub.database, 1, TIP)
    assert lm.lcl_hash.hex() == want[TIP]
    assert b.bucket_manager.get_hash() == lm.lcl_header.bucketListHash
    # the reference's node at the same ledger, by the same route
    r = ref_node(tmp_path, 7, archive_root)
    rcfg = {"complete": RCatchupConfiguration.complete,
            "minimal": RCatchupConfiguration.minimal}[mode]()
    rwork = r.catchup_manager.start_catchup(rcfg)
    assert r_run_work(r, rwork) == RState.SUCCESS
    assert r.bucket_manager.get_hash() == b.bucket_manager.get_hash()
    assert account_rows(b.database) == account_rows(r.database)
    # the commitment over the caught-up list (computed afresh after a
    # bucket-apply) equals the reference engine's
    assert b.state_commitment.update_root(b.bucket_manager.bucket_list) == \
        r.state_commitment.update_root(r.bucket_manager.bucket_list)
    stop(b)


def test_port_online_catchup_with_buffered_ledgers(publisher, tmp_path):
    """Values after a gap buffer, catchup heals from the archive, then the
    buffer drains to the publisher's LCL."""
    ref_pub, archive_root = publisher
    b = port_node(tmp_path, "port", archive_root)
    cm, lm = b.catchup_manager, b.ledger_manager
    net = b.config.network_id
    for seq in range(TIP + 1, TOP + 1):
        lm.value_externalized(lcd_from_db(ref_pub.database, net, seq))
    assert lm.state == LedgerManagerState.LM_CATCHING_UP_STATE
    assert cm.buffered_count() == TOP - TIP
    assert cm.catchup_running()
    assert crank_until(b, lambda: not cm.catchup_running())
    assert lm.last_closed_ledger_num() == TOP and lm.is_synced()
    assert cm.buffered_count() == 0
    # minimal by default: buckets at 15, then the four buffered closes
    assert_chain(b, ref_pub.database, TIP, TOP)
    assert b.bucket_manager.get_hash() == \
        ref_pub.bucket_manager.get_hash()
    assert account_rows(b.database) == account_rows(ref_pub.database)
    stop(b)


def test_corrupt_archive_fails_catchup_on_both(publisher, tmp_path):
    """A flipped byte in a published ledger file fails chain verification
    on the port and the reference alike, before any ledger applies."""
    _ref_pub, archive_root = publisher
    bad = copy_archive(archive_root, tmp_path)
    flip_gz(bad / category_path("ledger", FREQ - 1, ".xdr.gz"), 40)
    b = port_node(tmp_path, "port", bad)
    work = b.catchup_manager.start_catchup(CatchupConfiguration.complete())
    assert run_work(b, work) == State.FAILURE
    assert b.ledger_manager.last_closed_ledger_num() == 1
    r = ref_node(tmp_path, 4, bad)
    rwork = r.catchup_manager.start_catchup(
        RCatchupConfiguration.complete())
    assert r_run_work(r, rwork) == RState.FAILURE
    assert r.ledger_manager.last_closed_ledger_num() == 1
    stop(b)


def test_trusted_anchor_on_both(publisher, tmp_path):
    """A consensus anchor that does not match the archive's chain fails
    the catchup before any state is touched; the matching one passes."""
    ref_pub, archive_root = publisher
    wrong = (TIP, b"\x13" * 32)
    b = port_node(tmp_path, "port", archive_root)
    work = CatchupWork(b, CatchupConfiguration.complete(),
                       trusted_hash=wrong)
    b.work_scheduler.schedule_work(work)
    assert run_work(b, work) == State.FAILURE
    assert b.ledger_manager.last_closed_ledger_num() == 1
    r = ref_node(tmp_path, 6, archive_root)
    rwork = RCatchupWork(r, RCatchupConfiguration.complete(),
                         trusted_hash=wrong)
    r.work_scheduler.schedule_work(rwork)
    assert r_run_work(r, rwork) == RState.FAILURE
    assert r.ledger_manager.last_closed_ledger_num() == 1
    right = (TIP, bytes.fromhex(header_hashes(ref_pub.database, TIP,
                                              TIP)[TIP]))
    c = port_node(tmp_path, "port-c", archive_root)
    work = CatchupWork(c, CatchupConfiguration.complete(),
                       trusted_hash=right)
    c.work_scheduler.schedule_work(work)
    assert run_work(c, work) == State.SUCCESS
    assert c.ledger_manager.last_closed_ledger_num() == TIP
    stop(b)
    stop(c)


# ------------------------------------------------- the port as publisher

CATEGORIES = ("ledger", "transactions", "results")


def test_reference_catches_up_from_port_archive(publisher, tmp_path):
    """A port node closes the reference publisher's values and publishes
    them: the files equal the reference's archive decompressed, and a
    reference node catches up from the port's archive. The SCP category
    is left out of the comparison: the port has no herder, so its
    `scphistory` table is empty."""
    ref_pub, ref_root = publisher
    port_root = tmp_path / "port-archive"
    os.makedirs(port_root)
    p = make_port_app(tmp_path / "pub", archives=[("test", port_root)],
                      writable=True, freq=FREQ)
    close_values(p, ref_pub.database, TOP)
    assert crank_until(p, lambda: p.history_manager.publish_queue() == [])
    assert p.history_manager.published_checkpoints == 2
    for c in (FREQ - 1, TIP):
        for cat in CATEGORIES:
            rel = category_path(cat, c, ".xdr.gz")
            assert gzip.decompress((port_root / rel).read_bytes()) == \
                gzip.decompress((ref_root / rel).read_bytes()), (c, cat)
        rel = category_path("history", c, ".json")
        got = HistoryArchiveState.from_json((port_root / rel).read_text())
        want = HistoryArchiveState.from_json((ref_root / rel).read_text())
        assert got.current_ledger == want.current_ledger == c
        assert [(lv.curr, lv.snap) for lv in got.levels] == \
            [(lv.curr, lv.snap) for lv in want.levels]
        for lv in got.levels:
            for hh in (lv.curr, lv.snap):
                if hh == "0" * 64:
                    continue
                rel = "bucket/%s/%s/%s/bucket-%s.xdr.gz" % (
                    hh[0:2], hh[2:4], hh[4:6], hh)
                assert gzip.decompress((port_root / rel).read_bytes()) == \
                    gzip.decompress((ref_root / rel).read_bytes())
    for mode in ("complete", "minimal"):
        r = make_app(tmp_path / mode, 8, port_root, writable=False)
        rwork = r.catchup_manager.start_catchup(
            getattr(RCatchupConfiguration, mode)())
        assert r_run_work(r, rwork) == RState.SUCCESS
        assert r.ledger_manager.last_closed_ledger_num() == TIP
        assert r.ledger_manager.lcl_hash.hex() == \
            header_hashes(p.database, TIP, TIP)[TIP]
    stop(p)


# ------------------------------------------------- the checkpoint drain

class OneLevelCount:
    """Counts the signatures a verifier decides, at the verifier's level
    only: the triples its `verify_many` receives (the prewarm's drains),
    and the cache misses its `enqueue` decides one by one (the apply
    path's checks). Mixed into each package's CpuSigVerifier."""

    def reset_counts(self, keys):
        self.keys = keys
        self.drained = []
        self.apply_misses = 0

    def verify_many(self, triples):
        self.drained.extend(triples)
        return super().verify_many(triples)

    def enqueue(self, key, sig, msg):
        ck = self.keys._cache_key(key.key_bytes, sig, msg)
        with self.keys._cache_lock:
            if ck not in self.keys._verify_cache:
                self.apply_misses += 1
        return super().enqueue(key, sig, msg)


class PortCounting(OneLevelCount, CpuSigVerifier):
    pass


class RefCounting(OneLevelCount, RCpuSigVerifier):
    pass


@pytest.mark.parametrize("side", ["port", "reference"])
def test_checkpoint_drain_verifies_each_triple_once(publisher, tmp_path,
                                                    side):
    """The one-level mirror of `test_catchup.py::
    test_prewarm_batches_checkpoint_sigs`. Catchup drains each
    checkpoint's signatures through `prewarm_many` (one `verify_many` of
    the misses); every distinct triple reaches `verify_many` exactly
    once, and the replayed closes decide none themselves (their checks
    all hit the cache).

    The reference test counts at two levels: it wraps both
    `keys.raw_verify` and `keys.raw_verify_batch`, and where the
    `cryptography` package is importable the reference's
    `raw_verify_batch` (`crypto/keys.py:137-157`) falls through to
    `raw_verify` once per triple, so each triple counts twice and the
    test fails (28 == 14 here). The reference itself verifies each
    triple once, as its case here shows."""
    _ref_pub, archive_root = publisher
    if side == "port":
        v, keys = PortCounting(), K
        node = port_node(tmp_path, "port", archive_root, verifier=v)
        # the port's C verifier with its apply engine skips the
        # checkpoint drain too (`_prewarm_redundant`): pin the Python
        # apply path the drain feeds, as on the reference side
        node.ledger_manager.use_native_apply = False
    else:
        v, keys = RefCounting(), RK
        node = ref_node(tmp_path, 5, archive_root)
        node.sig_verifier = v
        # the reference's CPU backend with its C apply engine skips the
        # checkpoint drain (`_prewarm_redundant`); pin the Python apply
        # path the drain feeds, as the reference test does
        node.ledger_manager.use_native_apply = False
    keys.flush_verify_cache()
    v.reset_counts(keys)
    work = node.catchup_manager.start_catchup(
        (CatchupConfiguration if side == "port"
         else RCatchupConfiguration).complete())
    ok = run_work(node, work) if side == "port" else r_run_work(node, work)
    assert ok.name == "SUCCESS"
    assert node.ledger_manager.last_closed_ledger_num() == TIP
    assert len(v.drained) > 1
    assert len(v.drained) == len(set(v.drained))
    assert v.apply_misses == 0
    if side == "port":
        stop(node)


class RaisingVerifier(CpuSigVerifier):
    """A verifier whose checkpoint drain fails, as a card's does when the
    device faults or its breaker refuses the drain."""

    drains = 0

    def prewarm_many(self, triples):
        self.drains += 1
        raise RuntimeError("drain failed on the card")


def test_failed_drain_fails_catchup_without_cpu_verify(publisher, tmp_path,
                                                       monkeypatch):
    """A checkpoint drain that raises fails the catchup with the LCL
    unchanged: nothing is verified on the CPU instead, and the checkpoint
    is not attempted again."""
    _ref_pub, archive_root = publisher
    calls = []
    monkeypatch.setattr(K, "raw_verify",
                        lambda *a: calls.append(1) or True)
    monkeypatch.setattr(K, "raw_verify_batch",
                        lambda t: calls.append(len(t)) or [True] * len(t))
    K.flush_verify_cache()
    v = RaisingVerifier()
    b = port_node(tmp_path, "port", archive_root, verifier=v)
    # the drain under test is the checkpoint's, which the C verifier with
    # the apply engine skips (`_prewarm_redundant`): pin the Python apply
    b.ledger_manager.use_native_apply = False
    work = b.catchup_manager.start_catchup(CatchupConfiguration.complete())
    assert run_work(b, work) == State.FAILURE
    assert b.ledger_manager.last_closed_ledger_num() == 1
    assert calls == []
    # a failed checkpoint is not retried: the drain ran once (the
    # reference's parents retry it 6 x 6 times)
    assert v.drains == 1
    assert b.catchup_manager.catchups_failed == 1
    stop(b)


def test_port_engine_catchup_through_pipeline(publisher, tmp_path):
    """A complete catchup on the C verifier with the port's apply engine:
    the checkpoint drains are skipped (`_prewarm_redundant`), each
    checkpoint's signatures go through the prewarm pipeline's worker,
    every replayed close with transactions runs in the engine, and the
    node ends equal to the publisher, as does a second node pinned to
    the Python apply."""
    ref_pub, archive_root = publisher
    want = header_hashes(ref_pub.database, 1, TIP)
    nodes = {}
    for native in (True, False):
        b = port_node(tmp_path, "port-%s" % native, archive_root)
        b.ledger_manager.use_native_apply = native
        paths = []
        close = b.ledger_manager.close_ledger

        def recording_close(lcd, close=close, b=b, paths=paths):
            close(lcd)
            if lcd.tx_set.frames:
                paths.append(b.ledger_manager.last_apply_path)

        b.ledger_manager.close_ledger = recording_close
        work = b.catchup_manager.start_catchup(
            CatchupConfiguration.complete())
        assert run_work(b, work) == State.SUCCESS
        lm = b.ledger_manager
        assert lm.last_closed_ledger_num() == TIP
        assert lm.lcl_hash.hex() == want[TIP]
        assert_chain(b, ref_pub.database, 1, TIP)
        assert paths and set(paths) == {"native" if native else "python"}
        pipelined = b.metrics.to_json().get("catchup.pipeline.prewarm")
        if native:
            # one submission per checkpoint, at least
            assert pipelined and pipelined["count"] >= 2
        else:
            assert pipelined is None
        nodes[native] = b
    assert account_rows(nodes[True].database) == \
        account_rows(nodes[False].database)
    assert nodes[True].bucket_manager.get_hash() == \
        nodes[False].bucket_manager.get_hash()
    for b in nodes.values():
        stop(b)
