"""A port node for the history and catchup tests, assembled as the
reference's `Application` wires one (`main/application.py`, not ported):
one of each manager the ledger, history and catchup layers reach through
the app. It imports only the port, so the `cuda`-marked tests can use it
where the JAX package is absent.
"""

import time
from types import SimpleNamespace

from stellar_core_tpu_torch.bucket.bucket_manager import BucketManager
from stellar_core_tpu_torch.catchup.catchup_manager import CatchupManager
from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
from stellar_core_tpu_torch.crypto.hashing import sha256
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.database.database import Database
from stellar_core_tpu_torch.herder.txset import TxSetFrame
from stellar_core_tpu_torch.history.archive import HistoryArchive
from stellar_core_tpu_torch.history.history_manager import HistoryManager
from stellar_core_tpu_torch.ledger.ledger_manager import (
    LedgerCloseData, LedgerManager,
)
from stellar_core_tpu_torch.ledger.state_commitment import (
    StateCommitmentEngine,
)
from stellar_core_tpu_torch.main.config import Config
from stellar_core_tpu_torch.main.persistent_state import PersistentState
from stellar_core_tpu_torch.process.process_manager import ProcessManager
from stellar_core_tpu_torch.util.faults import FaultInjector
from stellar_core_tpu_torch.util.metrics import MetricsRegistry
from stellar_core_tpu_torch.util.status_manager import StatusManager
from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
from stellar_core_tpu_torch.transactions.transaction_frame import (
    TransactionFrame,
)
from stellar_core_tpu_torch.work.scheduler import WorkScheduler
from stellar_core_tpu_torch.xdr import LedgerHeader, TransactionEnvelope


def archive_config(archives, writable: bool) -> dict:
    """Config.HISTORY for local-directory archives [(name, root)]."""
    out = {}
    for name, root in archives:
        arch = HistoryArchive.local_dir(name, str(root))
        d = {"get": arch.get_tmpl, "mkdir": arch.mkdir_tmpl}
        if writable:
            d["put"] = arch.put_tmpl
        out[name] = d
    return out


def make_port_app(bucket_dir, n: int = 0, archives=(), writable=False,
                  freq: int = 64, db_file=None, verifier=None,
                  hasher=None, faults=None, metrics=None, tracer=None,
                  flight_recorder=None, config=None,
                  background_merges=True):
    """A started port node: `Config.test_config(n)` over sqlite (a file
    when `db_file` is named, else `:memory:`), buckets in `bucket_dir`,
    the given archives, and the verifier and hasher it is handed (the
    C verifier and `make_hasher("cpu")` when none is). Like
    `Application.start`, it restores the last known ledger from the SQL
    store and the bucket directory, or starts a new one, then publishes
    any queued checkpoint."""
    cfg = config or Config.test_config(n)
    cfg.DATABASE = "sqlite3://%s" % (db_file or ":memory:")
    cfg.CHECKPOINT_FREQUENCY = freq
    cfg.HISTORY = archive_config(archives, writable)
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    metrics = metrics if metrics is not None else \
        MetricsRegistry(now_fn=clock.now)
    db = Database(db_file or ":memory:", metrics)
    app = SimpleNamespace(
        clock=clock, config=cfg, database=db,
        persistent_state=PersistentState(db), metrics=metrics,
        tracer=tracer, flight_recorder=flight_recorder,
        faults=faults if faults is not None else FaultInjector(),
        sig_verifier=verifier or CpuSigVerifier(),
        batch_hasher=hasher or make_hasher("cpu"),
        bucket_manager=BucketManager(str(bucket_dir),
                                     background_merges=background_merges),
        status_manager=StatusManager(),
        network_root_key=lambda: SecretKey.from_seed(
            sha256(cfg.network_id)))
    app.state_commitment = StateCommitmentEngine(app)
    app.ledger_manager = LedgerManager(app)
    app.work_scheduler = WorkScheduler(clock)
    app.process_manager = ProcessManager(clock,
                                         cfg.MAX_CONCURRENT_SUBPROCESSES)
    app.history_manager = HistoryManager(app)
    app.catchup_manager = CatchupManager(app)

    def crank(block: bool = False) -> int:
        # Application.crank: flush the verifies the crank's handlers
        # enqueued
        got = clock.crank(block)
        app.sig_verifier.flush()
        return got

    app.crank = crank
    lm = app.ledger_manager
    if not lm.load_last_known_ledger():
        lm.start_new_ledger()
    app.history_manager.publish_queued_history()
    return app


def crank_until(app, pred, timeout_s: float = 120.0) -> bool:
    """Crank until `pred()`: the archive's commands run as subprocesses,
    so an idle crank waits a little for their exit events instead of
    spinning."""
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            return False
        if not app.crank(False):
            time.sleep(0.0005)
    return True


def run_work(app, work, timeout_s: float = 120.0):
    assert crank_until(app, work.is_done, timeout_s), \
        "work did not finish"
    return work.state


def stop(app) -> None:
    app.process_manager.shutdown()
    app.bucket_manager.shutdown()
    app.history_manager.publish_queue_dir.remove()
    app.database.close()


def lcd_from_db(db, network_id: bytes, seq: int) -> LedgerCloseData:
    """The value a node externalized for `seq`, rebuilt from its SQL
    store (either package's: the schema is one) as the port's
    LedgerCloseData (the reference tests' `make_lcd_from_db`)."""
    hrow = db.execute("SELECT data FROM ledgerheaders WHERE ledgerseq = ?",
                      (seq,)).fetchone()
    header = LedgerHeader.from_xdr(hrow[0])
    frames = [TransactionFrame.make_from_wire(
        network_id, TransactionEnvelope.from_xdr(r[0]))
        for r in db.execute("SELECT txbody FROM txhistory WHERE "
                            "ledgerseq = ? ORDER BY txindex",
                            (seq,)).fetchall()]
    ts = TxSetFrame(network_id, header.previousLedgerHash, frames)
    return LedgerCloseData(seq, ts, header.scpValue)


def close_values(app, src_db, upto: int) -> None:
    """Externalize the source node's values after the LCL through
    `upto`, one by one, as consensus hands them to the node."""
    lm = app.ledger_manager
    net = app.config.network_id
    for seq in range(lm.last_closed_ledger_num() + 1, upto + 1):
        lm.value_externalized(lcd_from_db(src_db, net, seq))
        assert lm.last_closed_ledger_num() == seq


def header_hashes(db, lo: int, hi: int) -> dict:
    return dict(db.execute(
        "SELECT ledgerseq, ledgerhash FROM ledgerheaders WHERE ledgerseq "
        "BETWEEN ? AND ? ORDER BY ledgerseq", (lo, hi)).fetchall())


def account_rows(db) -> list:
    return db.execute(
        "SELECT accountid, balance, seqnum, numsubentries, flags, "
        "lastmodified, entry FROM accounts ORDER BY accountid").fetchall()
