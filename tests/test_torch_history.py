"""The port's history layer: the publish/catchup matrix, restart and the
status lines, held against the JAX package's.

The values come from a reference node (`tests/test_catchup.py`'s
`make_app` plus `close_ledgers_with_traffic`, checkpoints of 8 ledgers),
once per module: 44 ledgers with a payment in most. Port nodes
(`tests/torch_catchup_harness.py`) externalize those values, publish to
local-directory archives of their own and catch up from them; every
ledger a port node reaches carries the reference node's hash.

Mirrored from `tests/test_history_matrix.py`: the stalled publish, the
publish queue across a restart, the pristine queued HAS, multiple
archives, publish/catchup alternation with a stall, the prefix and
recent targets, the second gap, the protocol change mid-archive, the
corrupt bucket and the tampered header.
`test_initialize_existing_history_store_fails`, which drives
`main/commandline.py`'s `new-hist`, runs in `test_torch_app_cases.py`.
From `tests/test_restart_continuity.py`:
`test_restart_resumes_chain_and_state`, and the stale local HAS that
restarts on an empty bucket list (`_restore_bucket_list`'s fallback);
`test_restart_preserves_scp_state_rows` needs the herder. From
`tests/test_status_manager.py`: its first two tests, on both packages;
the third needs the herder's upgrades and the `info` endpoint.
"""

import gzip
import logging
import os

import pytest

from stellar_core_tpu.catchup import (
    CatchupConfiguration as RCatchupConfiguration,
)
from stellar_core_tpu.herder.upgrades import UpgradeParameters
from stellar_core_tpu.util import status_manager as r_status
from stellar_core_tpu.work.basic_work import State as RState
from stellar_core_tpu_torch.bucket.bucket_list import BucketList
from stellar_core_tpu_torch.catchup import CatchupConfiguration
from stellar_core_tpu_torch.history.archive import category_path
from stellar_core_tpu_torch.history.archive_state import HistoryArchiveState
from stellar_core_tpu_torch.util import status_manager as p_status
from stellar_core_tpu_torch.work.basic_work import State

from test_catchup import (
    FREQ, close_ledgers_with_traffic, make_app, run_work as r_run_work,
)
from torch_catchup_harness import (
    account_rows, close_values, crank_until, header_hashes, lcd_from_db,
    make_port_app, run_work, stop,
)

SOURCE_TOP = 5 * FREQ + 4


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """The reference node whose values the port nodes externalize."""
    tmp = tmp_path_factory.mktemp("source")
    root = tmp / "archive"
    os.makedirs(root)
    app = make_app(tmp, 0, root)
    close_ledgers_with_traffic(app, SOURCE_TOP)
    yield app
    app.stop()


def node(tmp_path, name, archives, writable=True, **kw):
    roots = [(n, r) for n, r in archives]
    for _n, r in roots:
        os.makedirs(r, exist_ok=True)
    return make_port_app(tmp_path / name, archives=roots, writable=writable,
                         freq=FREQ, **kw)


def drain_publishes(app):
    assert crank_until(app, lambda: app.history_manager.publish_queue()
                       == [])


def break_archive_puts(app, name="test"):
    arch = app.history_manager.archives[name]
    saved = arch.put_tmpl
    arch.put_tmpl = "false"          # every put now exits 1
    return saved


def well_known(root):
    return HistoryArchiveState.from_json(
        (root / ".well-known" / "stellar-history.json").read_text())


def catch_up(app, cfg):
    work = app.catchup_manager.start_catchup(cfg)
    assert work is not None
    return run_work(app, work)


def src_hash(source, seq):
    return header_hashes(source.database, seq, seq)[seq]


# ---------------------------------------------------------------- publish

def test_stalled_publish_retries_then_succeeds(source, tmp_path):
    root = tmp_path / "archive"
    a = node(tmp_path, "a", [("test", root)])
    saved = break_archive_puts(a)
    close_values(a, source.database, FREQ + 2)
    assert crank_until(a, lambda: a.history_manager.failed_publishes > 0)
    assert a.history_manager.publish_queue() == [FREQ - 1]
    assert a.history_manager.published_checkpoints == 0
    a.history_manager.archives["test"].put_tmpl = saved
    a.history_manager.publish_queued_history()
    assert a.history_manager.publish_queue() == []
    assert a.history_manager.published_checkpoints == 1
    assert (root / ".well-known" / "stellar-history.json").exists()
    stop(a)


def test_publish_queue_persists_across_restart(source, tmp_path):
    root = tmp_path / "archive"
    db_file = str(tmp_path / "node.db")
    a = node(tmp_path, "a", [("test", root)], db_file=db_file)
    break_archive_puts(a)
    close_values(a, source.database, FREQ + 2)
    assert crank_until(a, lambda: a.history_manager.failed_publishes > 0)
    assert a.history_manager.publish_queue() == [FREQ - 1]
    stop(a)
    # the same SQL file and bucket directory with a healthy archive: the
    # start publishes the queued checkpoint
    a2 = node(tmp_path, "a", [("test", root)], db_file=db_file)
    drain_publishes(a2)
    assert a2.ledger_manager.last_closed_ledger_num() == FREQ + 2
    assert well_known(root).current_ledger == FREQ - 1
    stop(a2)


def test_queued_has_stays_pristine_until_publish(source, tmp_path):
    root = tmp_path / "archive"
    a = node(tmp_path, "a", [("test", root)])
    saved = break_archive_puts(a)
    close_values(a, source.database, 2 * FREQ + 3)
    assert crank_until(a, lambda: len(a.history_manager.publish_queue())
                       == 2)
    queued = {seq: a.history_manager._queued_has(seq)
              for seq in a.history_manager.publish_queue()}
    a.history_manager.archives["test"].put_tmpl = saved
    a.history_manager.publish_queued_history()
    assert a.history_manager.publish_queue() == []
    for seq, has0 in queued.items():
        got = HistoryArchiveState.from_json(
            (root / category_path("history", seq, ".json")).read_text())
        assert got.current_ledger == seq == has0.current_ledger
        assert got.bucket_hashes() == has0.bucket_hashes()
    stop(a)


def test_publish_to_multiple_archives(source, tmp_path):
    root1, root2 = tmp_path / "arch1", tmp_path / "arch2"
    a = node(tmp_path, "a", [("test", root1), ("backup", root2)])
    close_values(a, source.database, FREQ + 2)
    drain_publishes(a)
    for root in (root1, root2):
        assert (root / ".well-known" / "stellar-history.json").exists()
        assert (root / category_path("ledger", FREQ - 1, ".xdr.gz")).exists()
    b = node(tmp_path, "b", [("test", root2)], writable=False)
    assert catch_up(b, CatchupConfiguration.complete()) == State.SUCCESS
    assert b.ledger_manager.last_closed_ledger_num() == FREQ - 1
    assert b.ledger_manager.lcl_hash.hex() == src_hash(source, FREQ - 1)
    stop(a)
    stop(b)


# ---------------------------------------------------------------- catchup

def test_publish_catchup_alternation_with_stall(source, tmp_path):
    root = tmp_path / "archive"
    a = node(tmp_path, "a", [("test", root)])
    close_values(a, source.database, FREQ + 2)
    drain_publishes(a)
    b = node(tmp_path, "b", [("test", root)], writable=False)
    for _round in range(2):
        assert catch_up(b, CatchupConfiguration.complete()) == \
            State.SUCCESS
        tip = a.history_manager.published_checkpoints * FREQ - 1
        assert b.ledger_manager.last_closed_ledger_num() == tip
        assert b.ledger_manager.lcl_hash.hex() == src_hash(source, tip)
        close_values(a, source.database,
                     a.ledger_manager.last_closed_ledger_num() + FREQ)
        drain_publishes(a)
    # stall: A keeps closing but its puts fail, so the archive freezes
    b_lcl = b.ledger_manager.last_closed_ledger_num()
    break_archive_puts(a)
    has = well_known(root)
    close_values(a, source.database,
                 a.ledger_manager.last_closed_ledger_num() + 2 * FREQ)
    crank_until(a, lambda: a.history_manager.failed_publishes > 0)
    assert well_known(root).current_ledger == has.current_ledger
    work = b.catchup_manager.start_catchup(CatchupConfiguration.complete())
    if work is not None:
        run_work(b, work)
    assert b_lcl <= b.ledger_manager.last_closed_ledger_num() <= \
        has.current_ledger
    stop(a)
    stop(b)


@pytest.fixture
def three_checkpoints(source, tmp_path):
    root = tmp_path / "archive"
    a = node(tmp_path, "a", [("test", root)])
    close_values(a, source.database, 3 * FREQ + 2)
    drain_publishes(a)
    yield a, root
    stop(a)


def test_catchup_to_prefix_target(source, tmp_path, three_checkpoints):
    _a, root = three_checkpoints
    target = 2 * FREQ - 1
    b = node(tmp_path, "b", [("test", root)], writable=False)
    assert catch_up(b, CatchupConfiguration(to_ledger=target)) == \
        State.SUCCESS
    assert b.ledger_manager.last_closed_ledger_num() == target
    assert header_hashes(b.database, 1, target) == \
        header_hashes(source.database, 1, target)
    stop(b)


def test_catchup_recent_replays_only_suffix(source, tmp_path,
                                            three_checkpoints):
    _a, root = three_checkpoints
    tip = 3 * FREQ - 1
    b = node(tmp_path, "b", [("test", root)], writable=False)
    assert catch_up(b, CatchupConfiguration.recent(FREQ)) == State.SUCCESS
    assert b.ledger_manager.last_closed_ledger_num() == tip
    assert b.ledger_manager.lcl_hash.hex() == src_hash(source, tip)
    replayed = [r[0] for r in b.database.execute(
        "SELECT DISTINCT ledgerseq FROM txhistory ORDER BY ledgerseq")]
    assert replayed and min(replayed) >= 2 * FREQ
    assert header_hashes(b.database, 2 * FREQ, tip) == \
        header_hashes(source.database, 2 * FREQ, tip)
    stop(b)


def test_second_gap_triggers_second_catchup(source, tmp_path):
    root = tmp_path / "archive"
    a = node(tmp_path, "a", [("test", root)])
    close_values(a, source.database, FREQ + 2)
    drain_publishes(a)
    b = node(tmp_path, "b", [("test", root)], writable=False)
    assert catch_up(b, CatchupConfiguration.complete()) == State.SUCCESS
    first_lcl = b.ledger_manager.last_closed_ledger_num()
    assert b.catchup_manager.catchups_succeeded == 1
    # A moves past two more checkpoints; B hears only its latest close
    close_values(a, source.database, first_lcl + 2 * FREQ)
    drain_publishes(a)
    a_tip = a.ledger_manager.last_closed_ledger_num()
    b.ledger_manager.value_externalized(
        lcd_from_db(a.database, b.config.network_id, a_tip))
    assert b.catchup_manager.catchup_running()
    assert crank_until(b, lambda: b.ledger_manager.last_closed_ledger_num()
                       >= a_tip)
    assert b.ledger_manager.last_closed_ledger_num() == a_tip
    assert b.ledger_manager.lcl_hash.hex() == src_hash(source, a_tip)
    assert b.catchup_manager.catchups_succeeded == 2
    stop(a)
    stop(b)


@pytest.fixture(scope="module")
def upgraded_source(tmp_path_factory):
    """A reference node whose base fee rises to 250 mid-checkpoint."""
    tmp = tmp_path_factory.mktemp("upgraded")
    root = tmp / "archive"
    os.makedirs(root)
    app = make_app(tmp, 0, root)
    close_ledgers_with_traffic(app, FREQ - 2)
    p = UpgradeParameters()
    p.upgrade_time = 0
    p.base_fee = 250
    app.herder.upgrades.set_parameters(p)
    close_ledgers_with_traffic(app, 2 * FREQ + 2)
    assert app.ledger_manager.lcl_header.baseFee == 250
    yield app
    app.stop()


def test_protocol_transition_mid_archive_replays(upgraded_source,
                                                 tmp_path):
    """A base-fee upgrade lands mid-archive: the port closes it, publishes
    it, and a port catchup replays it to the reference's hash."""
    src = upgraded_source
    root = tmp_path / "archive"
    a = node(tmp_path, "a", [("test", root)])
    close_values(a, src.database, 2 * FREQ + 2)
    drain_publishes(a)
    tip = 2 * FREQ - 1
    b = node(tmp_path, "b", [("test", root)], writable=False)
    assert catch_up(b, CatchupConfiguration.complete()) == State.SUCCESS
    assert b.ledger_manager.last_closed_ledger_num() == tip
    assert header_hashes(b.database, 1, tip) == \
        header_hashes(src.database, 1, tip)
    assert b.ledger_manager.lcl_header.baseFee == 250
    stop(a)
    stop(b)


def _victim_bucket(root):
    has = well_known(root)
    files = [root / "bucket" / h[0:2] / h[2:4] / h[4:6] /
             ("bucket-%s.xdr.gz" % h) for h in has.bucket_hashes()]
    return max((f for f in files if f.exists()),
               key=lambda p: p.stat().st_size)


def test_corrupt_bucket_fails_minimal_catchup(source, tmp_path):
    root = tmp_path / "archive"
    a = node(tmp_path, "a", [("test", root)])
    close_values(a, source.database, 2 * FREQ + 2)
    drain_publishes(a)
    victim = _victim_bucket(root)
    raw = bytearray(gzip.decompress(victim.read_bytes()))
    raw[len(raw) // 2] ^= 0xFF
    victim.write_bytes(gzip.compress(bytes(raw)))
    b = node(tmp_path, "b", [("test", root)], writable=False)
    assert catch_up(b, CatchupConfiguration.minimal()) == State.FAILURE
    assert b.ledger_manager.last_closed_ledger_num() <= 1
    # the reference's node refuses the port's corrupted archive too
    r = make_app(tmp_path / "ref", 1, root, writable=False)
    rwork = r.catchup_manager.start_catchup(RCatchupConfiguration.minimal())
    assert r_run_work(r, rwork) == RState.FAILURE
    assert r.ledger_manager.last_closed_ledger_num() <= 1
    stop(a)
    stop(b)


def test_tampered_mid_chain_header_fails_verification(source, tmp_path):
    root = tmp_path / "archive"
    a = node(tmp_path, "a", [("test", root)])
    close_values(a, source.database, 2 * FREQ + 2)
    drain_publishes(a)
    victim = root / category_path("ledger", FREQ - 1, ".xdr.gz")
    raw = bytearray(gzip.decompress(victim.read_bytes()))
    raw[40] ^= 0x01
    victim.write_bytes(gzip.compress(bytes(raw)))
    b = node(tmp_path, "b", [("test", root)], writable=False)
    assert catch_up(b, CatchupConfiguration.complete()) == State.FAILURE
    assert b.ledger_manager.last_closed_ledger_num() <= 1
    stop(a)
    stop(b)


# ---------------------------------------------------------------- restart

def test_restart_resumes_chain_and_state(source, tmp_path):
    """A node stopped mid-run resumes from its SQL store and bucket
    directory at the same LCL, state and bucket list, and keeps closing
    on the same hash chain."""
    db_file = str(tmp_path / "node.db")
    a = node(tmp_path, "a", [], db_file=db_file)
    close_values(a, source.database, 8)
    lcl, lcl_hash = a.ledger_manager.last_closed_ledger_num(), \
        a.ledger_manager.lcl_hash
    rows, bl_hash = account_rows(a.database), a.bucket_manager.get_hash()
    root = a.state_commitment.root
    stop(a)

    a2 = node(tmp_path, "a", [], db_file=db_file)
    lm = a2.ledger_manager
    assert lm.last_closed_ledger_num() == lcl and lm.lcl_hash == lcl_hash
    assert a2.bucket_manager.get_hash() == bl_hash == \
        lm.lcl_header.bucketListHash
    assert account_rows(a2.database) == rows
    assert a2.state_commitment.update_root(
        a2.bucket_manager.bucket_list) == root
    close_values(a2, source.database, lcl + 3)
    hashes = header_hashes(a2.database, 1, lcl + 3)
    assert hashes == header_hashes(source.database, 1, lcl + 3)
    chain = a2.database.execute(
        "SELECT ledgerseq, ledgerhash, prevhash FROM ledgerheaders "
        "ORDER BY ledgerseq").fetchall()
    by_seq = {r[0]: r for r in chain}
    for seq in range(2, lcl + 4):
        assert by_seq[seq][2] == by_seq[seq - 1][1], seq
    stop(a2)


def test_restart_over_stale_has_starts_empty_bucket_list(source, tmp_path):
    """A local HAS that does not hash to the LCL header's bucket list
    (here one written four ledgers earlier) is refused with a warning:
    the node restarts at its LCL on an empty bucket list rather than on
    wrong state."""
    db_file = str(tmp_path / "node.db")
    a = node(tmp_path, "a", [], db_file=db_file)
    close_values(a, source.database, 4)
    ps = a.persistent_state
    stale = ps.get_state(ps.kHistoryArchiveState)
    close_values(a, source.database, 8)
    ps.set_state(ps.kHistoryArchiveState, stale)
    lcl_hash = a.ledger_manager.lcl_hash
    stop(a)
    warnings = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    logger = logging.getLogger("stellar.Ledger")
    logger.addHandler(handler)
    try:
        a2 = node(tmp_path, "a", [], db_file=db_file)
    finally:
        logger.removeHandler(handler)
    assert a2.ledger_manager.last_closed_ledger_num() == 8
    assert a2.ledger_manager.lcl_hash == lcl_hash
    assert a2.bucket_manager.get_hash() == BucketList().get_hash()
    assert any(w.startswith("bucket-list restore failed: restored bucket "
                            "list hash") for w in warnings), warnings
    stop(a2)


# ---------------------------------------------------------------- status

@pytest.mark.parametrize("pkg", [p_status, r_status],
                         ids=["port", "reference"])
def test_status_set_get_remove(pkg):
    Cat = pkg.StatusCategory
    sm = pkg.StatusManager()
    assert len(sm) == 0
    assert sm.get_status_message(Cat.NTP) == ""
    sm.set_status_message(Cat.NTP, "clock skewed")
    sm.set_status_message(Cat.HISTORY_PUBLISH, "publishing 2")
    assert len(sm) == 2
    assert sm.get_status_message(Cat.NTP) == "clock skewed"
    sm.set_status_message(Cat.NTP, "clock fine")  # overwrite
    assert sm.get_status_message(Cat.NTP) == "clock fine"
    assert len(sm) == 2
    sm.remove_status_message(Cat.NTP)
    assert sm.get_status_message(Cat.NTP) == ""
    sm.remove_status_message(Cat.NTP)  # idempotent
    assert len(sm) == 1
    assert sm.to_list() == ["publishing 2"]


@pytest.mark.parametrize("pkg", [p_status, r_status],
                         ids=["port", "reference"])
def test_status_iteration_in_category_order(pkg):
    sm = pkg.StatusManager()
    sm.set_status_message(pkg.StatusCategory.REQUIRES_UPGRADES, "armed")
    sm.set_status_message(pkg.StatusCategory.HISTORY_CATCHUP,
                          "catching up")
    assert sm.to_list() == ["catching up", "armed"]


def test_catchup_status_line_while_catching_up(source, tmp_path):
    """The catchup's status line is set while values buffer and removed
    once the node is synced, as the reference's CatchupManager does."""
    root = tmp_path / "archive"
    a = node(tmp_path, "a", [("test", root)])
    close_values(a, source.database, FREQ + 2)
    drain_publishes(a)
    b = node(tmp_path, "b", [("test", root)], writable=False)
    for seq in range(FREQ, FREQ + 3):
        b.ledger_manager.value_externalized(
            lcd_from_db(a.database, b.config.network_id, seq))
    line = b.status_manager.get_status_message(
        p_status.StatusCategory.HISTORY_CATCHUP)
    assert line == "Catching up from ledger 1: buffered 3 externalized " \
        "ledgers"
    assert crank_until(b, lambda: not b.catchup_manager.catchup_running())
    assert b.ledger_manager.is_synced()
    assert b.ledger_manager.last_closed_ledger_num() == FREQ + 2
    assert b.status_manager.to_list() == []
    stop(a)
    stop(b)
