"""The reference's `Application` surface that its ledger-layer tests reach
(`stellar_core_tpu/main/application.py`; the port's comes with
`main/`, ROADMAP Queue 1 item 8), over a port node, and the reference's
`AppLedgerAdapter` over it.

`Application(clock, config)` builds what the reference's constructor
builds for the ledger, history and catchup layers: metrics, a tracer, a
fault injector armed from `config.FAULTS` (a table the port's Config does
not carry; a test sets it), the database of `config.DATABASE`, the C
verifier and the host hasher, the invariant manager and close-meta stream
(`torch_catchup_harness.invariants_and_stream`), the LedgerManager, the
state commitment, a Herder (manual closes, FORCE_SCP bootstrap), the work
scheduler, process manager, history and catchup managers, and the
port's `OverlayManager` after the herder, as the reference's constructor
builds it (`main/application.py:159-165`). A caller may hand it the
node's verifier and hasher (`verifier` may be a callable of the app, for
a stack that needs the node's clock); the tracer is enabled when the
config carries `TRACE_ENABLED` (a knob the port's Config does not carry;
a test sets it). `enable_buckets` is `torch_catchup_harness.
enable_buckets`; `start` starts overlay unless RUN_STANDALONE, `stop`
shuts it down, `submit_transaction` broadcasts an accepted transaction,
and `crank`, `crank_until` and `manual_close` do what the reference's
do; maintenance is not ported.
The mirrored tests' sources name this class where they name the
reference's (`APP_SUBS`, for `torch_mirror_harness.Mirror`'s `subs`).
"""

from stellar_core_tpu_torch.catchup.catchup_manager import CatchupManager
from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
from stellar_core_tpu_torch.crypto.hashing import sha256
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.database.database import Database
from stellar_core_tpu_torch.herder.herder import Herder
from stellar_core_tpu_torch.history.history_manager import HistoryManager
from stellar_core_tpu_torch.ledger.ledger_manager import LedgerManager
from stellar_core_tpu_torch.ledger.state_commitment import (
    StateCommitmentEngine,
)
from stellar_core_tpu_torch.main.persistent_state import PersistentState
from stellar_core_tpu_torch.overlay.overlay_manager import OverlayManager
from stellar_core_tpu_torch.process.process_manager import ProcessManager
from stellar_core_tpu_torch.testing import TestAccount
from stellar_core_tpu_torch.util.faults import FaultInjector
from stellar_core_tpu_torch.util.metrics import MetricsRegistry
from stellar_core_tpu_torch.util.slot_timeline import SlotTimeline
from stellar_core_tpu_torch.util.status_manager import StatusManager
from stellar_core_tpu_torch.util.tracing import Tracer
from stellar_core_tpu_torch.work.scheduler import WorkScheduler
from stellar_core_tpu_torch.xdr import (
    LedgerKey, MessageType, StellarMessage, TransactionResultCode,
)

import torch_catchup_harness as CH

# the `Mirror` source rewrites that give a reference test's port side
# this module's Application and AppLedgerAdapter
APP_SUBS = (
    (r"from stellar_core_tpu_torch\.main\.application import Application",
     "from torch_app_harness import Application"),
    (r"from stellar_core_tpu_torch\.testing import AppLedgerAdapter",
     "from torch_app_harness import AppLedgerAdapter"),
)


class Faults(FaultInjector):
    """The port's injector with the reference's `clear`."""

    def clear(self, name=None) -> None:
        if name is None:
            self._sites.clear()
        else:
            self._sites.pop(name, None)


class Application:
    def __init__(self, clock, config, verifier=None, hasher=None) -> None:
        self.clock = clock
        self.config = cfg = config
        self.metrics = MetricsRegistry(now_fn=clock.now)
        self.status_manager = StatusManager()
        self.tracer = Tracer()
        if getattr(cfg, "TRACE_ENABLED", False):
            self.tracer.enable()
        self.flight_recorder = None
        self.slot_timeline = SlotTimeline(now_fn=clock.now, max_slots=64)
        self.faults = Faults(metrics=self.metrics, tracer=self.tracer)
        for site, d in getattr(cfg, "FAULTS", {}).items():
            self.faults.configure(
                site, probability=float(d.get("p", 1.0)),
                count=d.get("n"), after=int(d.get("after", 0)))
        if cfg.DATABASE == "in-memory":
            self.database = None
        elif cfg.DATABASE.startswith("sqlite3://"):
            self.database = Database(cfg.DATABASE[len("sqlite3://"):],
                                     self.metrics)
        else:
            self.database = Database(cfg.DATABASE, self.metrics)
        self.persistent_state = (PersistentState(self.database)
                                 if self.database else None)
        if callable(verifier):
            verifier = verifier(self)
        self.sig_verifier = verifier if verifier is not None \
            else CpuSigVerifier()
        self.batch_hasher = hasher if hasher is not None \
            else make_hasher("cpu")
        CH.invariants_and_stream(self)
        self.bucket_manager = None       # wired in enable_buckets()
        self.overlay_manager = None
        self.ledger_manager = LedgerManager(self)
        self.state_commitment = StateCommitmentEngine(self)
        if cfg.QUORUM_SET is None:
            cfg.QUORUM_SET = cfg.self_qset()
        self.herder = Herder(self)
        self.overlay_manager = OverlayManager(self)
        self.work_scheduler = WorkScheduler(clock)
        self.process_manager = ProcessManager(
            clock, cfg.MAX_CONCURRENT_SUBPROCESSES)
        self.history_manager = HistoryManager(self)
        self.catchup_manager = CatchupManager(self)

    def network_root_key(self) -> SecretKey:
        return SecretKey.from_seed(sha256(self.config.network_id))

    def enable_buckets(self, bucket_dir=None) -> None:
        CH.enable_buckets(self, bucket_dir)

    def start(self) -> None:
        lm = self.ledger_manager
        if not lm.load_last_known_ledger():
            lm.start_new_ledger()
        self.herder.restore_scp_state()
        if not self.config.RUN_STANDALONE:
            self.overlay_manager.start()
        self.history_manager.publish_queued_history()
        if self.config.FORCE_SCP and self.config.NODE_IS_VALIDATOR:
            self.herder.bootstrap()

    def crank(self, block: bool = False) -> int:
        n = self.clock.crank(block)
        self.sig_verifier.flush()
        return n

    def crank_until(self, pred, max_cranks: int = 100000) -> bool:
        for _ in range(max_cranks):
            if pred():
                return True
            self.crank(False)
        return pred()

    def stop(self) -> None:
        self.overlay_manager.shutdown()
        self.process_manager.shutdown()
        if self.bucket_manager is not None:
            self.bucket_manager.shutdown()
        if self.close_meta_stream is not None:
            self.close_meta_stream.close()

    def manual_close(self) -> None:
        assert self.config.MANUAL_CLOSE, "manualclose requires MANUAL_CLOSE"
        self.herder.trigger_next_ledger(
            self.ledger_manager.last_closed_ledger_num() + 1)
        while self.clock.crank_ready():
            pass

    def submit_transaction(self, frame) -> int:
        status = self.herder.recv_transaction(frame)
        if status == 0:
            self.overlay_manager.broadcast_message(
                StellarMessage(MessageType.TRANSACTION, frame.envelope),
                False)
        return status


class AppLedgerAdapter:
    """The reference's `testing.AppLedgerAdapter`: the TestLedger account
    surface over an Application, whose transactions go through the herder
    and are applied by manual closes."""

    def __init__(self, app) -> None:
        self.app = app
        self.network_id = app.config.network_id

    def header(self):
        return self.app.ledger_manager.lcl_header

    def _root(self):
        return self.app.ledger_manager.ltx_root()

    def balance(self, account_id) -> int:
        e = self._root().get_entry(LedgerKey.account(account_id))
        assert e is not None, "no such account"
        return e.data.value.balance

    def account_exists(self, account_id) -> bool:
        return self._root().get_entry(
            LedgerKey.account(account_id)) is not None

    def trust_balance(self, account_id, asset):
        e = self._root().get_entry(LedgerKey.trustline(account_id, asset))
        assert e is not None
        return e.data.value.balance

    def seq_num(self, account_id) -> int:
        e = self._root().get_entry(LedgerKey.account(account_id))
        return e.data.value.seqNum if e is not None else 0

    def apply_frame(self, frame) -> bool:
        if self.app.submit_transaction(frame) != 0:
            return False
        self.app.manual_close()
        return frame.result.code == TransactionResultCode.txSUCCESS

    def root_account(self) -> TestAccount:
        return TestAccount(self, self.app.network_root_key())
