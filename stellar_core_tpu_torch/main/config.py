"""Config: node configuration, parsed from TOML.

Copied from `stellar_core_tpu/main/config.py` at commit 02f8fbd; carry a
fix in either copy to the other. Left out: SIG_VERIFY_COMPILE_CACHE_DIR
(the XLA compile cache has no counterpart: the kernels build into
`_build.BUILD_DIR`), NATIVE_PARALLEL_APPLY and CATCHUP_PIPELINE (no
caller sets them; the apply engine and catchup's pipeline take their
defaults).

Deliberately different:

- The card by default. SIG_VERIFY_BACKEND and HASH_BACKEND default to
  "cuda-resilient": the card behind a breaker, with no CPU fallback (the
  reference defaults both to "cpu"). A node started with no backend named
  verifies and hashes on the card, or raises without one.
- `test_config(n, backend="cpu")` sets both knobs to `backend` (the
  reference sets SIG_VERIFY_BACKEND only); "cuda-async", which has no
  hashing counterpart, gives the hasher "cuda-resilient". The tests name
  the CPU explicitly.
- `from_toml` also reads the genesis values GENESIS_TOTAL_COINS and
  TESTING_UPGRADE_DESIRED_FEE / _RESERVE / _MAX_TX_SET_SIZE, as
  stellar-core's config file does: a node started from the command line
  must build the genesis of the network whose archive it catches up from.
  It reads ARTIFICIALLY_GENERATE_LOAD_FOR_TESTING too (stellar-core's
  config file carries it), so a `run` node can serve `generateload`.
- `validate` (which `from_toml` runs) refuses a backend name the port
  does not build; the reference's "tpu" and "tpu-async" are refused with
  an error that names their counterparts "cuda-resilient" and
  "cuda-async".

Role parity: reference `src/main/Config.{h,cpp}` (~80 knobs; TOML via
cpptoml with validators/quality levels). Python's stdlib tomllib replaces
cpptoml.
"""

from __future__ import annotations

try:
    import tomllib
except ImportError:       # Python < 3.11: the tomli backport is the
    import tomli as tomllib  # same parser under its pre-stdlib name
from typing import Dict, List, Optional

from ..crypto.hashing import sha256
from ..crypto.keys import SecretKey
from ..xdr import PublicKey, SCPQuorumSet


VERIFY_BACKENDS = ("cuda-resilient", "cuda-async", "cuda", "cpu",
                   "cpu-resilient")
HASH_BACKENDS = ("cuda-resilient", "cuda", "cpu", "cpu-resilient")
# the reference's TPU backend names and the port's counterparts
REFERENCE_BACKENDS = {
    "tpu": '"cuda-resilient" (or "cuda-async")',
    "tpu-async": '"cuda-async" (or "cuda-resilient")',
}


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
        self.NODE_HOME_DOMAIN = ""
        # human-readable node name: flight-recorder filenames, fleet
        # aggregation lanes; defaults to the strkey prefix (node_name())
        self.NODE_NAME = ""
        self.QUORUM_SET: Optional[SCPQuorumSet] = None
        self.UNSAFE_QUORUM = False
        self.FAILURE_SAFETY = -1

        # run modes
        self.RUN_STANDALONE = False
        self.MANUAL_CLOSE = False
        self.FORCE_SCP = False
        self.CATCHUP_COMPLETE = False
        self.CATCHUP_RECENT = 0

        # database / storage
        self.DATABASE = "sqlite3://:memory:"
        self.BUCKET_DIR_PATH = "buckets"
        self.TMP_DIR_PATH = "tmp"
        # BucketDB (bucket/bucket_index.py): serve SQL-root
        # point reads from bloom-filtered bucket indexes (SQL stays the
        # write-behind query index). False pins the legacy SQL read
        # path; BLOOM_BITS_PER_KEY sizes the per-bucket filters (10 ≈
        # 1% false-positive rate at optimal k).
        self.BUCKETDB_READS = True
        self.BUCKETDB_BLOOM_BITS_PER_KEY = 10

        # overlay
        self.PEER_PORT = 11625
        self.HTTP_PORT = 11626
        self.PUBLIC_HTTP_PORT = False
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
        # per-peer flood-rate defense (overlay/flood_control.py,
        # docs/robustness.md#flood-control): token bucket of
        # FLOOD_RATE_BURST messages refilling at
        # FLOOD_RATE_LIMIT_PER_PEER msgs/s on the app clock; <= 0
        # disables. A message over the limit is dropped unprocessed and
        # scores one ban point; FLOOD_BAN_SCORE_THRESHOLD points (scores
        # halve per ledger close) ban the peer via BanManager.
        self.FLOOD_RATE_LIMIT_PER_PEER = 500.0
        self.FLOOD_RATE_BURST = 5000
        self.FLOOD_BAN_SCORE_THRESHOLD = 500

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
        # ingress admission tier (herder/ingress.py,
        # docs/robustness.md#ingress--overload): per-source token-bucket
        # rate classes in front of the TransactionQueue. INGRESS_CLASSES
        # is a TOML table of class name -> {rate, burst, max_inflight}
        # overrides merged onto herder.ingress.DEFAULT_CLASSES; the
        # *_ACCOUNTS lists pin strkey account ids to the priority /
        # untrusted classes. INGRESS_ASYNC_INTAKE parks admitted frames
        # in a bounded intake (INGRESS_INTAKE_DEPTH) drained
        # priority-first at each trigger; per-source bucket states are
        # capped at INGRESS_MAX_SOURCES (bounded under 10^6 submitters).
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
        self.ARTIFICIALLY_GENERATE_LOAD_FOR_TESTING = False

        # history
        self.HISTORY: Dict[str, dict] = {}
        self.CHECKPOINT_FREQUENCY = 64

        # invariants
        self.INVARIANT_CHECKS: List[str] = []

        # workers / process
        self.WORKER_THREADS = 4
        self.MAX_CONCURRENT_SUBPROCESSES = 16

        # apply engine (ledger/native_apply.py): conflict-graph parallel
        # close — disjoint tx clusters apply on worker threads inside the C
        # engine. Workers 0 = auto (min(16, cpu_count)); 1 pins the
        # serial engine.
        self.NATIVE_PARALLEL_WORKERS = 0

        # signature-verify backend (crypto/batch_verifier.make_verifier):
        # "cuda-resilient" (default: the card behind a breaker, no CPU
        # fallback), "cuda-async" (the same under a threaded dispatcher on
        # the node's clock), "cuda" (the bare fleet), "cpu" (the C
        # verifier), "cpu-resilient" (the C verifier behind the breaker,
        # with a CPU fallback, for chaos runs without a card)
        self.SIG_VERIFY_BACKEND = "cuda-resilient"
        self.SIG_VERIFY_MAX_BATCH = 8192
        # build the kernel and launch every planned bucket at startup
        # (background thread) so no build lands on the consensus path
        self.SIG_VERIFY_WARMUP = True

        # device-dispatch circuit breaker (docs/robustness.md):
        # consecutive dispatch failures before the breaker opens (and
        # refuses drains on the card's stacks), and how long it stays
        # open before the half-open reprobe
        self.SIG_VERIFY_BREAKER_THRESHOLD = 3
        self.SIG_VERIFY_BREAKER_COOLDOWN = 30.0

        # batched SHA-256 boundary (crypto/batch_hasher.make_hasher):
        # "cuda-resilient" (default: the card behind a breaker, no CPU
        # fallback), "cuda" (bare), "cpu" (hashlib), "cpu-resilient"
        # (hashlib behind the breaker). The hasher shares the
        # SIG_VERIFY_BREAKER_* knobs — one device failure domain, one
        # operator surface.
        self.HASH_BACKEND = "cuda-resilient"
        # signed state-checkpoint cadence (ledger/state_commitment.py):
        # a StateCheckpoint {seq, header hash, Merkle root, node sig} is
        # emitted every N closes; <= 0 disables emission (the Merkle
        # root still updates incrementally for the admin endpoint)
        self.STATE_CHECKPOINT_INTERVAL = 8

        # fault injection (util/faults.py, docs/robustness.md): TOML table
        # of site name -> {p, n, after}; merged with the SCT_FAULTS env
        # spec ("site:p=0.5,n=3;site2") at Application construction.
        # FAULTS_SEED keys every site's deterministic schedule.
        self.FAULTS: Dict[str, dict] = {}
        self.FAULTS_SEED = 0

        # observability: span tracer (util/tracing.py). Enabled at
        # startup when True; always toggleable at runtime via the admin
        # `trace` endpoint. Capacity bounds the span ring buffer.
        self.TRACE_ENABLED = False
        self.TRACE_CAPACITY = 16384
        # per-slot consensus event journal (util/slot_timeline.py):
        # always on; bounds how many recent slots are retained
        self.SLOT_TIMELINE_SLOTS = 64
        # propagation cockpit (overlay/propagation_stats.py): causal
        # hop records + per-peer usefulness. On by default; False is the
        # control leg the flood scenario's overhead guard compares
        # against
        self.PROPAGATION_STATS_ENABLED = True
        # flight-recorder dump directory ("" = the SCT_FLIGHT_DIR env
        # override, else the system tempdir); dumps fire on unhandled
        # close exceptions and SCP-stall / slow-close watchdog triggers
        self.FLIGHT_RECORDER_DIR = ""

        # maintenance
        self.AUTOMATIC_MAINTENANCE_PERIOD = 359.0
        self.AUTOMATIC_MAINTENANCE_COUNT = 50000

        # downstream-consumer integration: stream one XDR LedgerCloseMeta
        # record per close to this path or "fd:N" (reference
        # Config.h:264 METADATA_OUTPUT_STREAM); "" disables
        self.METADATA_OUTPUT_STREAM = ""

    # -- derived ------------------------------------------------------------
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

    # -- loading ------------------------------------------------------------
    @classmethod
    def from_toml(cls, path_or_text: str,
                  is_path: bool = True) -> "Config":
        if is_path:
            with open(path_or_text, "rb") as f:
                data = tomllib.load(f)
        else:
            data = tomllib.loads(path_or_text)
        cfg = cls()
        simple_keys = [
            "NETWORK_PASSPHRASE", "NODE_IS_VALIDATOR", "NODE_HOME_DOMAIN",
            "RUN_STANDALONE", "MANUAL_CLOSE", "FORCE_SCP", "DATABASE",
            "BUCKET_DIR_PATH", "TMP_DIR_PATH", "PEER_PORT", "HTTP_PORT",
            "PUBLIC_HTTP_PORT", "KNOWN_PEERS", "PREFERRED_PEERS",
            "PREFERRED_PEERS_ONLY", "PREFERRED_PEER_KEYS",
            "TARGET_PEER_CONNECTIONS", "UNSAFE_QUORUM", "FAILURE_SAFETY",
            "EXPECTED_LEDGER_CLOSE_TIME", "MAX_SLOTS_TO_REMEMBER",
            "CONSENSUS_STUCK_TIMEOUT_SECONDS", "LEDGER_VALIDITY_BRACKET",
            "INVARIANT_CHECKS", "WORKER_THREADS",
            "MAX_CONCURRENT_SUBPROCESSES", "SIG_VERIFY_BACKEND",
            "SIG_VERIFY_MAX_BATCH", "TRACE_ENABLED", "TRACE_CAPACITY",
            "SLOT_TIMELINE_SLOTS", "PROPAGATION_STATS_ENABLED",
            "NODE_NAME",
            "FLIGHT_RECORDER_DIR", "CHECKPOINT_FREQUENCY",
            "CATCHUP_COMPLETE", "CATCHUP_RECENT",
            "PEER_TIMEOUT", "PEER_STRAGGLER_TIMEOUT",
            "MAX_BATCH_WRITE_COUNT", "MAX_BATCH_WRITE_BYTES",
            "PEER_SEND_QUEUE_LIMIT_BYTES", "METADATA_OUTPUT_STREAM",
            "FLOOD_RATE_LIMIT_PER_PEER", "FLOOD_RATE_BURST",
            "FLOOD_BAN_SCORE_THRESHOLD",
            "SIG_VERIFY_BREAKER_THRESHOLD", "SIG_VERIFY_BREAKER_COOLDOWN",
            "HASH_BACKEND", "STATE_CHECKPOINT_INTERVAL",
            "FAULTS_SEED",
            "BUCKETDB_READS", "BUCKETDB_BLOOM_BITS_PER_KEY",
            "INGRESS_ENABLED", "INGRESS_ASYNC_INTAKE",
            "INGRESS_INTAKE_DEPTH", "INGRESS_MAX_SOURCES",
            "INGRESS_PRIORITY_ACCOUNTS", "INGRESS_UNTRUSTED_ACCOUNTS",
            # the genesis values (stellar-core's config file carries them;
            # the reference's from_toml does not)
            "GENESIS_TOTAL_COINS", "TESTING_UPGRADE_DESIRED_FEE",
            "TESTING_UPGRADE_RESERVE", "TESTING_UPGRADE_MAX_TX_SET_SIZE",
            "ARTIFICIALLY_GENERATE_LOAD_FOR_TESTING",
        ]
        for k in simple_keys:
            if k in data:
                setattr(cfg, k, data[k])
        if "NODE_SEED" in data:
            cfg.NODE_SEED = SecretKey.from_strkey_seed(data["NODE_SEED"])
        if "QUORUM_SET" in data:
            cfg.QUORUM_SET = cls._parse_qset(data["QUORUM_SET"])
        if "HISTORY" in data:
            cfg.HISTORY = data["HISTORY"]
        if "FAULTS" in data:
            cfg.FAULTS = data["FAULTS"]
        if "INGRESS_CLASSES" in data:
            cfg.INGRESS_CLASSES = data["INGRESS_CLASSES"]
        cfg.validate()
        return cfg

    @staticmethod
    def _parse_qset(d: dict) -> SCPQuorumSet:
        from ..crypto import strkey
        validators = [PublicKey.ed25519(strkey.decode_public_key(v))
                      for v in d.get("VALIDATORS", [])]
        inner = [Config._parse_qset(i) for i in d.get("INNER_SETS", [])]
        n = len(validators) + len(inner)
        if "THRESHOLD_PERCENT" in d:   # reference config convention
            pct = int(d["THRESHOLD_PERCENT"])
            threshold = max(1, -(-n * pct // 100))  # ceil
        else:
            threshold = d.get("THRESHOLD", n)
        return SCPQuorumSet(threshold=threshold, validators=validators,
                            innerSets=inner)

    def validate(self) -> None:
        for knob, names in (("SIG_VERIFY_BACKEND", VERIFY_BACKENDS),
                            ("HASH_BACKEND", HASH_BACKENDS)):
            name = getattr(self, knob)
            if name in REFERENCE_BACKENDS:
                raise ValueError(
                    "%s = %r names a TPU backend; this build's "
                    "counterparts are %s" % (
                        knob, name, REFERENCE_BACKENDS[name]))
            if name not in names:
                raise ValueError("%s = %r is not one of %s"
                                 % (knob, name, ", ".join(names)))
        if self.NODE_IS_VALIDATOR and self.NODE_SEED is None:
            raise ValueError("validator requires NODE_SEED")
        if self.QUORUM_SET is not None and not self.UNSAFE_QUORUM:
            q = self.QUORUM_SET
            n = len(q.validators) + len(q.innerSets)
            if n > 0 and q.threshold < (n + 1) // 2:
                raise ValueError(
                    "quorum threshold below majority is unsafe; set "
                    "UNSAFE_QUORUM=true to override")

    @classmethod
    def test_config(cls, n: int = 0,
                    backend: str = "cpu") -> "Config":
        """Per-instance deterministic test config (reference getTestConfig,
        src/test/test.cpp:80-131): the reference's node seed for instance
        `n`, a 1-of-1 quorum of itself, manual closes with FORCE_SCP, an
        in-memory ledger, every invariant checked on every close, no
        overlay (RUN_STANDALONE), the instance's peer and HTTP ports, and
        both backends on `backend` (the CPU unless named)."""
        cfg = cls()
        cfg.NODE_SEED = SecretKey.from_seed(
            sha256(b"test-node-%d" % n))
        cfg.RUN_STANDALONE = True
        cfg.MANUAL_CLOSE = True
        cfg.FORCE_SCP = True
        cfg.UNSAFE_QUORUM = True
        cfg.DATABASE = "in-memory"
        cfg.QUORUM_SET = cfg.self_qset()
        cfg.INVARIANT_CHECKS = [".*"]
        cfg.SIG_VERIFY_BACKEND = backend
        cfg.HASH_BACKEND = ("cuda-resilient" if backend == "cuda-async"
                            else backend)
        cfg.PEER_PORT = 17000 + n
        cfg.HTTP_PORT = 18000 + n
        return cfg
