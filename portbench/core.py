"""What every kind of traffic shares: the harness's spans, the port's node
built for a cell, the verifier's warmup plan, and the checks that decide
`correct`.

Nothing here reads the JAX package or its benchmark; the port is imported
inside the functions that build it, so that the registry and the
reference load without it.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class Spans:
    """The harness's own spans on the host clock (`time.perf_counter`):
    (name, start, end), in the order they closed."""

    def __init__(self) -> None:
        self.items: List[Tuple[str, float, float]] = []

    def span(self, name: str):
        return _Span(self, name)

    def summary(self) -> str:
        """"name s, name s, ..." in the order the spans closed."""
        return ", ".join("%s %.3f s" % (n, b - a) for (n, a, b) in self.items)


class _Span:
    __slots__ = ("spans", "name", "t0")

    def __init__(self, spans: Spans, name: str) -> None:
        self.spans = spans
        self.name = name

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.spans.items.append((self.name, self.t0, time.perf_counter()))
        return False


@dataclass
class Check:
    """One number compared, and the largest value that is correct."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a kind's window hands back to the harness."""
    attempted: int = 0
    failed: int = 0
    end_to_end: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    log_lines: List[str] = field(default_factory=list)


class GcPauses:
    """The interpreter's cyclic collections while it is entered: how many
    of each generation, and their seconds on the host clock."""

    def __enter__(self) -> "GcPauses":
        import gc
        self.count = [0, 0, 0]
        self.seconds = 0.0
        self._t0 = None
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> bool:
        import gc
        gc.callbacks.remove(self._cb)
        return False

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.count[info["generation"]] += 1
            self._t0 = None

    def summary(self) -> str:
        return "collections by generation %s, %.3f s" % (self.count,
                                                         self.seconds)


def seed_bytes(seed: int, label: str) -> bytes:
    """32 bytes drawn from the run's seed for one purpose."""
    return hashlib.sha256(("%d/%s" % (seed, label)).encode()).digest()


def set_warmup_plan(buckets: Optional[list]) -> None:
    """Replace the card verifier's autosaved warmup plan, which it keeps
    in the port's build directory inside the checkout, by the cell's
    buckets (or remove it), so that no earlier run's plan changes this
    one."""
    from stellar_core_tpu_torch import _build
    path = os.path.join(_build.BUILD_DIR, "warmup_buckets.json")
    try:
        os.remove(path)
    except FileNotFoundError:
        pass
    if buckets:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"version": 1, "buckets": list(buckets)}, fh)


def build_node(config: dict, node_seed: bytes, workdir: str, backend: str,
               quorum_set_xdr: Optional[bytes] = None):
    """A started port `Application` on an in-memory ledger, standalone,
    with the configuration's network, protocol version, validator flag and
    verify stack, its warmups finished. Its files go under `workdir`."""
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.main.application import Application
    from stellar_core_tpu_torch.main.config import Config
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    from stellar_core_tpu_torch.xdr import SCPQuorumSet

    cfg = Config()
    cfg.NETWORK_PASSPHRASE = config["network_passphrase"]
    cfg.LEDGER_PROTOCOL_VERSION = config["protocol_version"]
    cfg.NODE_SEED = SecretKey.from_seed(node_seed)
    cfg.NODE_IS_VALIDATOR = config["node_is_validator"]
    cfg.RUN_STANDALONE = True
    cfg.MANUAL_CLOSE = True
    cfg.DATABASE = "in-memory"
    cfg.INVARIANT_CHECKS = []
    cfg.BUCKET_DIR_PATH = os.path.join(workdir, "buckets")
    cfg.TMP_DIR_PATH = os.path.join(workdir, "tmp")
    cfg.FLIGHT_RECORDER_DIR = os.path.join(workdir, "flight")
    cfg.TRACE_CAPACITY = 1 << 20
    cfg.SIG_VERIFY_BACKEND = backend
    cfg.HASH_BACKEND = ("cuda-resilient" if backend.startswith("cuda")
                        else backend)
    if quorum_set_xdr is not None:
        cfg.QUORUM_SET = SCPQuorumSet.from_xdr(quorum_set_xdr)
    app = Application(VirtualClock(ClockMode.REAL_TIME), cfg)
    app.start()
    app.wait_for_warmups()
    return app


def stop_node(app) -> None:
    app.stop()
    app.wait_for_warmups()
