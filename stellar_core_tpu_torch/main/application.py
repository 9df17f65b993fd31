"""Application: ownership and wiring of every subsystem.

Copied from `stellar_core_tpu/main/application.py` at commit 94afec1;
carry a fix in either copy to the other.

Deliberately different:

- The node's verifier and hasher come from the port's `make_verifier` and
  `make_hasher`, on SIG_VERIFY_BACKEND and HASH_BACKEND, whose defaults
  are the card's stacks ("cuda-resilient"; `main/config.py`): a node built
  from `Config()` verifies and hashes on the card, and its constructor
  raises where there is no card. No stack it builds falls back to the CPU
  unless "cpu-resilient" is named. The node's clock drives every stack
  ("cuda-async" needs it). There is no compile-cache directory: the
  kernels build into `_build.BUILD_DIR`.
- `start` warms the card's stacks where they have `warmup` (the verify
  kernel's planned buckets, the hash kernel's shapes) on their own
  threads, as the reference warms its XLA programs; `stop` saves the
  verifier's warmup plan beside the kernel build. `wait_for_warmups`
  joins those threads, so a caller that reads launch counts (a command
  that exits, the chip smoke) reads them whole.
- `stop` also shuts the bucket manager's merge workers down, so a
  stopped node leaves no merge running against its bucket directory.
- A database flagged by the `force-scp` command sets FORCE_SCP at `start`
  before the herder's bootstrap, which asserts that knob. The
  reference's `start` bootstraps on the flag with FORCE_SCP unset, so its
  `force-scp` followed by `run` dies on that assertion (ROADMAP Queue 3).

Role parity: reference `src/main/Application.h:127-219` /
`ApplicationImpl.cpp` — one Application owns one of each manager; the
managers interact only through the Application facade. start() mirrors
ApplicationImpl::start (ApplicationImpl.cpp:360-464): load LCL → restore
herder state → start overlay/maintenance → resume publishes → optional
FORCE_SCP bootstrap.
"""

from __future__ import annotations

from typing import Optional

from ..crypto.batch_verifier import make_verifier
from ..crypto.hashing import sha256
from ..crypto.keys import SecretKey
from ..database.database import Database
from ..invariant.invariants import InvariantManager
from ..ledger.ledger_manager import LedgerManager
from ..util.log import get_logger
from ..util.metrics import MetricsRegistry
from ..util.timer import ClockMode, VirtualClock
from .config import Config
from .persistent_state import PersistentState

log = get_logger("Ledger")


class AppState:
    APP_CREATED = 0
    APP_ACQUIRING_CONSENSUS = 1
    APP_SYNCED = 2
    APP_STOPPING = 3


class Application:
    def __init__(self, clock: VirtualClock, config: Config) -> None:
        self.clock = clock
        self.config = config
        self.state = AppState.APP_CREATED
        self.metrics = MetricsRegistry(now_fn=clock.now)
        from ..util.status_manager import StatusManager
        self.status_manager = StatusManager()

        # span tracer + flight recorder (util/tracing.py): constructed
        # before every subsystem so each can hold a direct reference;
        # disabled tracing costs one attribute check per span site
        from ..util.tracing import FlightRecorder, Tracer
        self.tracer = Tracer(capacity=config.TRACE_CAPACITY,
                             gc_spans=True)
        if config.TRACE_ENABLED:
            self.tracer.enable()
        self.flight_recorder = FlightRecorder(
            self.tracer, metrics=self.metrics,
            out_dir=config.FLIGHT_RECORDER_DIR or None,
            node_name=config.node_name(), now_fn=clock.now)

        # per-slot consensus event journal (util/slot_timeline.py):
        # always on (one dict append per event), fed by SCP/herder/ledger
        # hooks and merged fleet-wide by util/fleet.py
        from ..util.slot_timeline import SlotTimeline
        self.slot_timeline = SlotTimeline(
            now_fn=clock.now, max_slots=config.SLOT_TIMELINE_SLOTS)

        # node footprint census (util/footprint.py): every
        # bounded structure below registers and self-reports occupancy /
        # capacity — the per-node overhead table behind the admin
        # `footprint` endpoint and the --fleet-scale N-vs-RSS curve
        from ..util.footprint import BoundedStructRegistry
        self.footprint = BoundedStructRegistry(
            metrics=self.metrics, now_fn=clock.now,
            node_name=config.node_name())

        # fault injector (util/faults.py): armed from config and/or the
        # SCT_FAULTS env spec; every subsystem reaches it through
        # app.faults (or a direct reference installed below), and an
        # unconfigured injector is a dict miss per check
        import os as _os
        from ..util.faults import KNOWN_SITES, FaultInjector
        self.faults = FaultInjector(
            seed=int(_os.environ.get("SCT_FAULTS_SEED",
                                     config.FAULTS_SEED)),
            metrics=self.metrics, tracer=self.tracer)
        for site, d in config.FAULTS.items():
            if site not in KNOWN_SITES:
                # operator-facing like the env spec and the admin
                # endpoint: a typo'd config table must kill the node at
                # startup, not soak a chaos run fault-free
                raise ValueError(
                    "unknown fault site %r in FAULTS config; known "
                    "sites: %s" % (site, ", ".join(sorted(KNOWN_SITES))))
            self.faults.configure(
                site, probability=float(d.get("p", 1.0)),
                count=d.get("n"), after=int(d.get("after", 0)))
        env_spec = _os.environ.get("SCT_FAULTS")
        if env_spec:
            self.faults.configure_from_spec(env_spec)

        # database (None in pure in-memory test mode)
        if config.DATABASE == "in-memory":
            self.database: Optional[Database] = None
        elif config.DATABASE.startswith("sqlite3://"):
            self.database = Database(config.DATABASE[len("sqlite3://"):],
                                     self.metrics)
        else:
            self.database = Database(config.DATABASE, self.metrics)
        self.persistent_state = (PersistentState(self.database)
                                 if self.database else None)

        # signature-verify backend (config-gated; the card's boundary):
        # the card's stacks sit behind a circuit breaker with no CPU
        # fallback, and raise where there is no card
        self.sig_verifier = make_verifier(
            config.SIG_VERIFY_BACKEND, config.SIG_VERIFY_MAX_BATCH,
            clock=clock,
            metrics=self.metrics, tracer=self.tracer,
            faults=self.faults, flight_recorder=self.flight_recorder,
            breaker_threshold=config.SIG_VERIFY_BREAKER_THRESHOLD,
            breaker_cooldown=config.SIG_VERIFY_BREAKER_COOLDOWN)

        # batched SHA-256 boundary (crypto/batch_hasher.py): the hashing
        # twin of the verifier — config-gated device backend behind the
        # same breaker knobs, one HasherStats cockpit behind the admin
        # `hasher` endpoint
        from ..crypto.batch_hasher import make_hasher
        self.batch_hasher = make_hasher(
            config.HASH_BACKEND, clock=clock,
            metrics=self.metrics, tracer=self.tracer,
            faults=self.faults, flight_recorder=self.flight_recorder,
            breaker_threshold=config.SIG_VERIFY_BREAKER_THRESHOLD,
            breaker_cooldown=config.SIG_VERIFY_BREAKER_COOLDOWN)

        self.invariant_manager = InvariantManager(self.metrics)
        for pattern in config.INVARIANT_CHECKS:
            self.invariant_manager.enable(pattern)

        # downstream close-meta stream (reference METADATA_OUTPUT_STREAM,
        # LedgerManagerImpl.cpp:590,673-678): opened before the first
        # close so no record is ever skipped
        self.close_meta_stream = None
        if config.METADATA_OUTPUT_STREAM:
            from ..ledger.close_meta_stream import CloseMetaStream
            self.close_meta_stream = CloseMetaStream(
                config.METADATA_OUTPUT_STREAM)

        self.bucket_manager = None   # wired in enable_buckets()
        self.history_manager = None  # wired by history layer
        self.catchup_manager = None
        self.overlay_manager = None  # real OverlayManager unless simulated
        self.ledger_manager = LedgerManager(self)

        # state commitments (ledger/state_commitment.py):
        # incremental Merkle root over the bucket list + signed
        # light-client checkpoints; active once buckets are enabled
        from ..ledger.state_commitment import StateCommitmentEngine
        self.state_commitment = StateCommitmentEngine(self)

        from ..herder.herder import Herder
        if config.QUORUM_SET is None:
            config.QUORUM_SET = config.self_qset()
        self.herder = Herder(self)

        from ..overlay.overlay_manager import OverlayManager
        self.overlay_manager = OverlayManager(self)

        from ..work.scheduler import WorkScheduler
        self.work_scheduler = WorkScheduler(self.clock)
        from ..process.process_manager import ProcessManager
        self.process_manager = ProcessManager(
            self.clock, config.MAX_CONCURRENT_SUBPROCESSES)

        from ..history.history_manager import HistoryManager
        self.history_manager = HistoryManager(self)
        from ..catchup.catchup_manager import CatchupManager
        self.catchup_manager = CatchupManager(self)

        from .command_handler import CommandHandler
        self.command_handler = CommandHandler(self)
        from .maintainer import ExternalQueue, Maintainer
        self.external_queue = ExternalQueue(self)
        self.maintainer = Maintainer(self)

        # the stacks whose kernel warmup `start` began
        self._warming: list = []

        self._register_footprint()

    def _register_footprint(self) -> None:
        """Enroll every bounded structure in the footprint census.
        Names are LITERALS — the reference's M1 lint scanner catalogs
        each as `footprint.struct.<name>` against docs/metrics.md, so a
        new bounded structure can't join the census undocumented."""
        fp = self.footprint
        tl = self.slot_timeline
        fp.track_struct(
            "slot-timeline", "ring",
            lambda: tl.max_slots * tl.max_events_per_slot,
            lambda: sum(len(evs) for evs in tl._slots.values()),
            lambda: sum(len(evs) for evs in tl._slots.values()) * 160)
        lc = self.herder.tx_lifecycle
        fp.track_struct(
            "tx-lifecycle", "map",
            lambda: lc.MAX_TRACKED, lambda: len(lc._pending))
        ss = self.herder.scp_stats
        fp.track_struct(
            "scp-slots", "ring",
            lambda: ss.MAX_SLOTS, lambda: len(ss._slots))
        fp.track_struct(
            "scp-peers", "map",
            lambda: ss.MAX_PEERS, lambda: len(ss.peers))
        ing = self.herder.ingress
        if ing is not None:
            fp.track_struct(
                "ingress-intake", "deque",
                lambda: ing.intake_depth, lambda: ing._intake_total)
            fp.track_struct(
                "ingress-sources", "cache",
                lambda: ing._sources._max, lambda: len(ing._sources))
        ov = self.overlay_manager
        ps = getattr(ov, "prop_stats", None)
        if ps is not None:
            fp.track_struct(
                "prop-hashes", "lru",
                lambda: ps.MAX_HASHES, lambda: len(ps._hashes))
            fp.track_struct(
                "prop-peers", "map",
                lambda: ps.MAX_PEERS, lambda: len(ps.peers))
        cfg = self.config
        fp.track_struct(
            "send-queues", "bytes",
            lambda: cfg.PEER_SEND_QUEUE_LIMIT_BYTES *
            max(1, ov.num_connections()),
            lambda: ov.send_queue_depth()[0],
            lambda: ov.send_queue_depth()[0])
        from ..crypto import keys as _keys
        fp.track_struct(
            "verify-cache", "cache",
            lambda: _keys._verify_cache._max,
            lambda: len(_keys._verify_cache),
            lambda: len(_keys._verify_cache) * 96)
        root = self.ledger_manager.root
        cache = getattr(root, "_cache", None)
        if cache is not None:
            fp.track_struct(
                "entry-cache", "lru",
                lambda: cache._max, lambda: len(cache),
                lambda: len(cache) * 256)

        # -- B1 enrollments: every long-lived container the
        # bounded-memory dataflow rule flags is census-tracked here with
        # a declared budget, so growth past the budget surfaces as
        # `over_capacity` in soaks instead of silent RSS creep. Budgets
        # are vocabulary bounds (metric/op/outcome names) or generous
        # operational ceilings, not hard invariants of the code.
        pe = self.herder.pending
        fp.track_struct(
            "pending-txsets", "map",
            lambda: 4096, lambda: len(pe.txsets) + len(pe.qsets))
        fp.track_struct(
            "pending-slot-sets", "map",
            lambda: 16384,
            lambda: sum(len(s) for s in pe.processed.values()) +
            sum(len(s) for s in pe.discarded.values()))
        hd = self.herder
        fp.track_struct(
            "scp-timers", "map",
            # (slot, timer_id) keys; erase_below GC plus the validity
            # bracket bound how many slots hold live timers
            lambda: hd.LEDGER_VALIDITY_BRACKET * 8,
            lambda: len(hd._scp_timers))
        qt = self.herder.quorum_tracker
        fp.track_struct(
            "quorum-tracker", "map",
            lambda: 4096, lambda: len(qt._quorum))
        lc2 = self.herder.tx_lifecycle
        fp.track_struct(
            "tx-outcome-meters", "map",
            lambda: 64, lambda: len(lc2._m_outcome))
        st = self.ledger_manager.apply_stats
        fp.track_struct(
            "apply-meters", "map",
            lambda: 512,
            lambda: len(st._m_lookup) + len(st._m_op) +
            len(st._h_op) + len(st._g_level))
        mreg = self.metrics
        fp.track_struct(
            "metrics-registry", "map",
            lambda: 4096, lambda: len(mreg._metrics))
        fp.track_struct(
            "footprint-gauges", "map",
            lambda: fp.MAX_STRUCTS, lambda: len(fp._g_occ))
        fr = self.flight_recorder
        fp.track_struct(
            "flight-dump-marks", "map",
            lambda: 64, lambda: len(fr._last_dump_at))
        im = self.invariant_manager
        fp.track_struct(
            "invariants", "map",
            lambda: 64, lambda: len(im._registered))
        hm = self.history_manager
        fp.track_struct(
            "history-archives", "map",
            lambda: 64, lambda: len(hm.archives))
        ws = self.work_scheduler
        fp.track_struct(
            "work-roots", "list",
            lambda: 1024, lambda: len(ws._roots))
        ost = getattr(ov, "stats", None)
        if ost is not None:
            fp.track_struct(
                "overlay-type-meters", "map",
                lambda: 256,
                lambda: len(ost._m_type) + len(ost._t_backend))
        pm = getattr(ov, "peer_manager", None)
        if pm is not None:
            fp.track_struct(
                "peer-records", "map",
                lambda: 16384, lambda: len(pm._peers))
        sv = getattr(ov, "survey_manager", None)
        if sv is not None:
            fp.track_struct(
                "survey-state", "map",
                lambda: 16384,
                lambda: len(sv._limiter) + len(sv._surveyed) +
                len(sv.results))

    # -- identity ------------------------------------------------------------
    def network_root_key(self) -> SecretKey:
        """Deterministic genesis root key derived from the network id."""
        return SecretKey.from_seed(sha256(self.config.network_id))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        # kernel warmup on a background thread: the kernel is built and
        # every planned bucket launched before the first envelope could
        # land a build on the consensus path
        if self.config.SIG_VERIFY_WARMUP and \
                getattr(self.sig_verifier, "wants_prewarm", False):
            self.sig_verifier.warmup(wait=False)
            self._warming.append(self.sig_verifier)
        # the hash kernel warms beside the verify kernel: the same
        # no-build-on-consensus rule
        if self.config.SIG_VERIFY_WARMUP and \
                getattr(self.batch_hasher, "wants_warmup", False):
            self.batch_hasher.warmup(wait=False)
            self._warming.append(self.batch_hasher)
        lm = self.ledger_manager
        if not lm.load_last_known_ledger():
            lm.start_new_ledger()
        self.herder.restore_scp_state()
        if self.overlay_manager is not None and \
                not self.config.RUN_STANDALONE:
            self.overlay_manager.start()
        if self.history_manager is not None:
            self.history_manager.publish_queued_history()
        self.maintainer.start()
        if self.persistent_state is not None and \
                self.persistent_state.get_force_scp():
            # the `force-scp` command's flag starts SCP as FORCE_SCP does
            # (stellar-core reads kForceSCPOnNextLaunch into FORCE_SCP);
            # the herder's bootstrap asserts the config knob
            self.config.FORCE_SCP = True
        force = self.config.FORCE_SCP
        if force and self.config.NODE_IS_VALIDATOR:
            self.herder.bootstrap()
            self.state = AppState.APP_SYNCED
        else:
            self.state = AppState.APP_ACQUIRING_CONSENSUS

    def wait_for_warmups(self) -> None:
        """Wait for the warmups `start` began on the stacks' threads (a
        no-op where it began none)."""
        for stack in self._warming:
            stack.warmup(wait=True)

    def crank(self, block: bool = False) -> int:
        n = self.clock.crank(block)
        # dispatch any signature verifies accumulated during this crank's
        # handlers (coalesced: one device batch per burst; no-op when empty)
        self.sig_verifier.flush()
        return n

    def crank_until(self, pred, max_cranks: int = 100000) -> bool:
        # every crank path must flush the batch verifier: an enqueue site
        # that doesn't self-flush would otherwise never complete here
        for _ in range(max_cranks):
            if pred():
                return True
            self.crank(False)
        return pred()

    def stop(self) -> None:
        self.state = AppState.APP_STOPPING
        # persist the cockpit-derived warmup bucket plan beside the
        # kernel build: the next start warms only the buckets this run's
        # real traffic used. Best-effort no-op on CPU backends or when the
        # cockpit saw no traffic.
        save_plan = getattr(self.sig_verifier, "save_warmup_plan", None)
        if save_plan is not None:
            save_plan()
        # interrupt any background quorum-intersection enumeration first:
        # joining that worker can otherwise take minutes (reference
        # HerderImpl.cpp:140-144)
        if self.herder is not None:
            self.herder.interrupt_quorum_intersection()
        self.command_handler.stop_http()
        if self.overlay_manager is not None:
            self.overlay_manager.shutdown()
        self.process_manager.shutdown()
        if self.bucket_manager is not None:
            self.bucket_manager.shutdown()
        if self.close_meta_stream is not None:
            self.close_meta_stream.close()

    # -- operations ----------------------------------------------------------
    def manual_close(self) -> None:
        assert self.config.MANUAL_CLOSE, "manualclose requires MANUAL_CLOSE"
        self.herder.trigger_next_ledger(
            self.ledger_manager.last_closed_ledger_num() + 1)
        # drain immediate work without advancing virtual time (future SCP
        # round timers must not fire during a manual close)
        while self.clock.crank_ready():
            pass

    def submit_transaction(self, frame) -> int:
        status = self.herder.recv_transaction(frame)
        if status == 0 and self.overlay_manager is not None:
            from ..xdr import MessageType, StellarMessage
            self.overlay_manager.broadcast_message(
                StellarMessage(MessageType.TRANSACTION, frame.envelope),
                False)
        return status

    @property
    def load_generator(self):
        """Lazy singleton LoadGenerator (admin `generateload`, overload
        scenarios); constructed on first use so apps that never generate
        load pay nothing."""
        if not hasattr(self, "_load_generator"):
            from ..simulation.load_generator import LoadGenerator
            self._load_generator = LoadGenerator(self)
        return self._load_generator

    def enable_buckets(self, bucket_dir: Optional[str] = None) -> None:
        from ..bucket.bucket_index import BucketDbStats
        from ..bucket.bucket_manager import BucketManager
        lm = self.ledger_manager
        self.bucket_manager = BucketManager(
            bucket_dir or self.config.BUCKET_DIR_PATH,
            stats=lm.apply_stats,
            bucketdb_stats=BucketDbStats(metrics=self.metrics,
                                         tracer=self.tracer,
                                         now_fn=self.clock.now),
            faults=self.faults,
            bloom_bits_per_key=self.config.BUCKETDB_BLOOM_BITS_PER_KEY,
            # with reads pinned off nothing consumes the indexes: skip
            # the per-adopt build + sidecar write (lazy build remains)
            eager_index=self.config.BUCKETDB_READS)
        # route SQL-root point reads through BucketDB — only
        # when the bucket list will cover this root's whole entry state:
        # enabled BEFORE start() (genesis seeds the list / restart
        # restores it and detaches on mismatch). A mid-life enable over
        # pre-existing SQL state keeps SQL point reads.
        root = lm.root
        if self.config.BUCKETDB_READS and \
                hasattr(root, "attach_bucketdb") and root._header is None:
            root.attach_bucketdb(self.bucket_manager.bucketdb)

    # -- info ----------------------------------------------------------------
    def get_info(self) -> dict:
        lm = self.ledger_manager
        return {
            "build": self.config.VERSION_STR,
            "network": self.config.NETWORK_PASSPHRASE,
            "ledger": {
                "num": lm.last_closed_ledger_num(),
                "hash": lm.lcl_hash.hex(),
                "version": lm.lcl_header.ledgerVersion,
                "baseFee": lm.lcl_header.baseFee,
                "baseReserve": lm.lcl_header.baseReserve,
                "maxTxSetSize": lm.lcl_header.maxTxSetSize,
                "closeTime": lm.lcl_header.scpValue.closeTime,
            },
            "state": ("Synced!" if self.state == AppState.APP_SYNCED
                      else "Catching up"),
            # per-subsystem rolled-up status lines (reference
            # StatusManager → info "status" array)
            "status": self.status_manager.to_list(),
            "quorum": self.herder.get_json_info(),
        }
