"""Config: node configuration.

Copied from `stellar_core_tpu/main/config.py` at commit 02f8fbd; carry a
fix in either copy to the other. Kept: the knobs the port's ledger,
history and catchup layers read (the network passphrase and node seed,
the database, the genesis and testing-upgrade values, HISTORY,
CHECKPOINT_FREQUENCY, CATCHUP_*, MAX_CONCURRENT_SUBPROCESSES,
STATE_CHECKPOINT_INTERVAL), `network_id` and `test_config`. Left out,
each with the module that reads it: `from_toml`, the node name, the
bucket and temporary directories (`main/commandline.py` and
`main/application.py`, which open a node's files); the quorum set, run
modes, overlay, herder and ingress knobs and `validate` (the herder, SCP
and overlay); BucketDB (`BUCKETDB_*`); invariants; the native apply
engine and the pipelined catchup (`NATIVE_PARALLEL_*`,
`CATCHUP_PIPELINE`); the verify and hash backends, faults, tracing, the
flight recorder, maintenance and the close-meta stream
(`main/application.py`, which builds them). Until those are ported, the
caller builds a node's verifier, hasher, tracer and recorder and hands
them to it.

Role parity: reference `src/main/Config.{h,cpp}`.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..crypto.hashing import sha256
from ..crypto.keys import SecretKey


class Config:
    # protocol
    LEDGER_PROTOCOL_VERSION = 13

    def __init__(self) -> None:
        # identity / network
        self.NETWORK_PASSPHRASE = "(sct) testing network"
        self.NODE_SEED: Optional[SecretKey] = None

        # catchup mode of a gap-triggered catchup (CatchupManager)
        self.CATCHUP_COMPLETE = False
        self.CATCHUP_RECENT = 0

        # database
        self.DATABASE = "sqlite3://:memory:"

        # genesis / testing upgrades
        self.GENESIS_TOTAL_COINS = 10**17
        self.TESTING_UPGRADE_DESIRED_FEE = 100
        self.TESTING_UPGRADE_RESERVE = 5_000_000
        self.TESTING_UPGRADE_MAX_TX_SET_SIZE = 100

        # history
        self.HISTORY: Dict[str, dict] = {}
        self.CHECKPOINT_FREQUENCY = 64

        # workers / process
        self.MAX_CONCURRENT_SUBPROCESSES = 16

        # signed state-checkpoint cadence (ledger/state_commitment.py):
        # a StateCheckpoint {seq, header hash, Merkle root, node sig} is
        # emitted every N closes; <= 0 disables emission (the Merkle
        # root still updates incrementally)
        self.STATE_CHECKPOINT_INTERVAL = 8

    @property
    def network_id(self) -> bytes:
        return sha256(self.NETWORK_PASSPHRASE.encode())

    @classmethod
    def test_config(cls, n: int = 0) -> "Config":
        """Per-instance deterministic test config (reference getTestConfig,
        src/test/test.cpp:80-131): the reference's node seed for instance
        `n` and an in-memory ledger."""
        cfg = cls()
        cfg.NODE_SEED = SecretKey.from_seed(
            sha256(b"test-node-%d" % n))
        cfg.DATABASE = "in-memory"
        return cfg
