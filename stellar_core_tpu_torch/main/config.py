"""Config: node configuration.

Copied from `stellar_core_tpu/main/config.py` at commit 02f8fbd; carry a
fix in either copy to the other. Kept: the knobs the port's ledger,
history, catchup, herder, SCP and overlay layers read (the network
passphrase, node seed and NODE_NAME, NODE_IS_VALIDATOR and QUORUM_SET, the
run modes RUN_STANDALONE, MANUAL_CLOSE and FORCE_SCP, the database, the
overlay's knobs with its protocol versions and VERSION_STR, the herder's
knobs, the transaction queue's depths and pool multiplier, the ingress
tier's INGRESS_* knobs, the genesis and testing-upgrade values,
ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING, HISTORY, CHECKPOINT_FREQUENCY,
CATCHUP_*, MAX_CONCURRENT_SUBPROCESSES, STATE_CHECKPOINT_INTERVAL, the
apply engine's NATIVE_PARALLEL_WORKERS, BucketDB's BUCKETDB_READS and
BUCKETDB_BLOOM_BITS_PER_KEY, INVARIANT_CHECKS, METADATA_OUTPUT_STREAM and
PROPAGATION_STATS_ENABLED), `network_id`, `node_id`, `node_name`,
`self_qset` and `test_config`. Left out, each with the module that reads
it and the ROADMAP Queue 1 item that brings it: `from_toml`, `validate`
(with UNSAFE_QUORUM and FAILURE_SAFETY), the home domain, the HTTP ports,
the bucket and temporary directories (`main/commandline.py`,
`main/command_handler.py` and `main/application.py`, which open a node's
files and endpoints, item 8); ARTIFICIALLY_GENERATE_LOAD_FOR_TESTING (the
load generator, item 9); the verify and hash backends, faults, tracing,
the slot timeline's size, the flight recorder and maintenance
(`main/application.py`, which builds them, item 8). Until those are
ported, the caller builds a node's verifier, hasher, tracer and recorder,
its bucket manager with BucketDB, its invariant manager and its close-meta
stream, and hands them to it.

Role parity: reference `src/main/Config.{h,cpp}`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..crypto.hashing import sha256
from ..crypto.keys import SecretKey
from ..xdr import PublicKey, SCPQuorumSet


class Config:
    # protocol
    LEDGER_PROTOCOL_VERSION = 13
    OVERLAY_PROTOCOL_VERSION = 12
    OVERLAY_PROTOCOL_MIN_VERSION = 10
    VERSION_STR = "stellar-core-tpu 0.1"

    def __init__(self) -> None:
        # identity / network
        self.NETWORK_PASSPHRASE = "(sct) testing network"
        self.NODE_SEED: Optional[SecretKey] = None
        self.NODE_IS_VALIDATOR = True
        # human-readable node name: the fleet view's lanes; defaults to
        # the strkey prefix (node_name())
        self.NODE_NAME = ""
        self.QUORUM_SET: Optional[SCPQuorumSet] = None

        # run modes
        self.RUN_STANDALONE = False
        self.MANUAL_CLOSE = False
        self.FORCE_SCP = False

        # catchup mode of a gap-triggered catchup (CatchupManager)
        self.CATCHUP_COMPLETE = False
        self.CATCHUP_RECENT = 0

        # database
        self.DATABASE = "sqlite3://:memory:"
        # BucketDB (bucket/bucket_index.py): serve SQL-root point reads
        # from bloom-filtered bucket indexes (SQL stays the write-behind
        # query index). False pins the SQL read path; BLOOM_BITS_PER_KEY
        # sizes the per-bucket filters (10 ≈ 1% false-positive rate at
        # optimal k).
        self.BUCKETDB_READS = True
        self.BUCKETDB_BLOOM_BITS_PER_KEY = 10

        # overlay
        self.PEER_PORT = 11625
        self.KNOWN_PEERS: List[str] = []
        self.PREFERRED_PEERS: List[str] = []
        self.TARGET_PEER_CONNECTIONS = 8
        self.MAX_PENDING_CONNECTIONS = 500
        # connection policy (reference Config.h PREFERRED_PEERS_ONLY /
        # PREFERRED_PEER_KEYS): preferred peers — by address or by strkey
        # node id — always win an authenticated slot (evicting a
        # non-preferred victim at capacity), and strict mode rejects
        # everyone else at authentication
        self.PREFERRED_PEERS_ONLY = False
        self.PREFERRED_PEER_KEYS: List[str] = []
        self.MAX_ADDITIONAL_PEER_CONNECTIONS = -1
        self.PEER_AUTHENTICATION_TIMEOUT = 2.0
        self.PEER_TIMEOUT = 30.0
        self.PEER_STRAGGLER_TIMEOUT = 120.0
        self.MAX_BATCH_WRITE_COUNT = 1024
        self.MAX_BATCH_WRITE_BYTES = 1024 * 1024
        # queued-but-unsent cap per peer; overflowing drops the connection
        self.PEER_SEND_QUEUE_LIMIT_BYTES = 32 * 1024 * 1024
        # per-peer flood-rate defense (overlay/flood_control.py): token
        # bucket of FLOOD_RATE_BURST messages refilling at
        # FLOOD_RATE_LIMIT_PER_PEER msgs/s on the app clock; <= 0
        # disables. A message over the limit is dropped unprocessed and
        # scores one ban point; FLOOD_BAN_SCORE_THRESHOLD points (scores
        # halve per ledger close) ban the peer via BanManager.
        self.FLOOD_RATE_LIMIT_PER_PEER = 500.0
        self.FLOOD_RATE_BURST = 5000
        self.FLOOD_BAN_SCORE_THRESHOLD = 500
        # propagation cockpit (overlay/propagation_stats.py): causal
        # hop records + per-peer usefulness; False turns it off
        self.PROPAGATION_STATS_ENABLED = True

        # herder
        self.EXPECTED_LEDGER_CLOSE_TIME = 5.0
        self.MAX_SLOTS_TO_REMEMBER = 12
        self.CONSENSUS_STUCK_TIMEOUT_SECONDS = 35.0
        # how far ahead of the current slot SCP envelopes are accepted;
        # beyond it only externalize hints are buffered (recovery path)
        self.LEDGER_VALIDITY_BRACKET = 100
        self.TRANSACTION_QUEUE_PENDING_DEPTH = 4
        self.TRANSACTION_QUEUE_BAN_DEPTH = 10
        self.POOL_LEDGER_MULTIPLIER = 2
        # ingress admission tier (herder/ingress.py): per-source
        # token-bucket rate classes in front of the TransactionQueue.
        # INGRESS_CLASSES maps a class name to {rate, burst,
        # max_inflight} overrides merged onto ingress.DEFAULT_CLASSES;
        # the *_ACCOUNTS lists pin strkey account ids to the priority /
        # untrusted classes. INGRESS_ASYNC_INTAKE parks admitted frames
        # in a bounded intake (INGRESS_INTAKE_DEPTH) drained
        # priority-first at each trigger; per-source bucket states are
        # capped at INGRESS_MAX_SOURCES.
        self.INGRESS_ENABLED = True
        self.INGRESS_ASYNC_INTAKE = False
        self.INGRESS_INTAKE_DEPTH = 512
        self.INGRESS_MAX_SOURCES = 65536
        self.INGRESS_CLASSES: Dict[str, dict] = {}
        self.INGRESS_PRIORITY_ACCOUNTS: List[str] = []
        self.INGRESS_UNTRUSTED_ACCOUNTS: List[str] = []

        # genesis / testing upgrades
        self.GENESIS_TOTAL_COINS = 10**17
        self.TESTING_UPGRADE_DESIRED_FEE = 100
        self.TESTING_UPGRADE_RESERVE = 5_000_000
        self.TESTING_UPGRADE_MAX_TX_SET_SIZE = 100
        self.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = False

        # history
        self.HISTORY: Dict[str, dict] = {}
        self.CHECKPOINT_FREQUENCY = 64

        # invariants (invariant/invariants.py): patterns of the names
        # checked on every close
        self.INVARIANT_CHECKS: List[str] = []

        # workers / process
        self.MAX_CONCURRENT_SUBPROCESSES = 16
        # apply engine (ledger/native_apply.py): conflict-graph parallel
        # close — disjoint tx clusters apply on worker threads inside the C
        # engine. Workers 0 = auto (min(16, cpu_count)); 1 pins the
        # serial engine.
        self.NATIVE_PARALLEL_WORKERS = 0

        # signed state-checkpoint cadence (ledger/state_commitment.py):
        # a StateCheckpoint {seq, header hash, Merkle root, node sig} is
        # emitted every N closes; <= 0 disables emission (the Merkle
        # root still updates incrementally)
        self.STATE_CHECKPOINT_INTERVAL = 8

        # downstream-consumer integration: stream one XDR LedgerCloseMeta
        # record per close to this path or "fd:N" (stellar-core's
        # METADATA_OUTPUT_STREAM); "" disables
        self.METADATA_OUTPUT_STREAM = ""

    @property
    def network_id(self) -> bytes:
        return sha256(self.NETWORK_PASSPHRASE.encode())

    def node_id(self) -> PublicKey:
        assert self.NODE_SEED is not None
        return self.NODE_SEED.public_key

    def node_name(self) -> str:
        """Display name: explicit NODE_NAME, else the strkey prefix the
        simulation layer also uses for node naming."""
        if self.NODE_NAME:
            return self.NODE_NAME
        if self.NODE_SEED is not None:
            return self.NODE_SEED.strkey_public()[:5]
        return "node"

    def self_qset(self) -> SCPQuorumSet:
        return SCPQuorumSet(threshold=1, validators=[self.node_id()],
                            innerSets=[])

    @classmethod
    def test_config(cls, n: int = 0) -> "Config":
        """Per-instance deterministic test config (reference getTestConfig,
        src/test/test.cpp:80-131): the reference's node seed for instance
        `n`, a 1-of-1 quorum of itself, manual closes with FORCE_SCP, an
        in-memory ledger, every invariant checked on every close, no
        overlay (RUN_STANDALONE) and the instance's peer port."""
        cfg = cls()
        cfg.NODE_SEED = SecretKey.from_seed(
            sha256(b"test-node-%d" % n))
        cfg.RUN_STANDALONE = True
        cfg.MANUAL_CLOSE = True
        cfg.FORCE_SCP = True
        cfg.DATABASE = "in-memory"
        cfg.QUORUM_SET = cfg.self_qset()
        cfg.INVARIANT_CHECKS = [".*"]
        cfg.PEER_PORT = 17000 + n
        return cfg
