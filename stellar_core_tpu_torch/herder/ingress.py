"""TxIngress: admission control in front of the TransactionQueue
(the million-user front door).

Copied from `stellar_core_tpu/herder/ingress.py` at commit 02f8fbd;
carry a fix in either copy to the other. Nothing is left out. Its admin
surface (`ingress?action=...`) is `main/command_handler.py`'s.

Role parity: the reference absorbs submission overload inside the pool
(surge pricing + eviction) and per-peer flood buckets; DSig (PAPERS.md,
arXiv:2406.07215) argues datacenter-scale signature services live or die
on admission/backpressure discipline *in front of* the batch path, and
the EdDSA committee study (2302.00418) shows per-source load shaping is
what keeps verification batches well-formed under adversarial mixes.
This module is that front door:

- **Rate classes**: every source account maps to a class — `priority` /
  `default` / `untrusted` — each with a token-bucket `rate`/`burst` and
  a `max_inflight` cap (admissions per close window). Membership is
  config-declared (`INGRESS_PRIORITY_ACCOUNTS` / `_UNTRUSTED_ACCOUNTS`)
  and runtime-tunable (admin `ingress?action=set-class`), bounded at
  MAX_CLASS_OVERRIDES entries.
- **Per-source buckets** live in a RandomEvictionCache capped at
  `max_sources` entries, so 10^6 distinct submitters cost a fixed-size
  map, not 10^6 states (the soak test asserts this).
- **Decisions**: ADMIT (hand the frame to the queue), THROTTLE (the
  source's bucket or inflight cap is exhausted — `TRY_AGAIN_LATER` with
  a computed retry-after hint), SHED (overload: the bounded intake is
  full and the arrival does not outrank anything queued, or the
  `ingress.shed-storm` fault forced it). Shed/throttle land in the
  tx-lifecycle funnel as `herder.tx.outcome.shed` / `.throttled`.
- **Bounded async intake** (`async_intake`): admitted frames park in
  per-class deques (total depth capped) and drain in class-rank order
  on `pump()` — priority first, so a default/untrusted backlog can
  never starve the priority class. When the intake is full an arrival
  only enters by evicting the tail of the *worst-ranked* non-empty
  class strictly below it; otherwise the arrival itself is shed —
  lowest class first, always.
- Fault sites `ingress.admit-stall` (admission decision delayed: the
  caller is told to retry) and `ingress.shed-storm` (forced shed burst)
  make both degraded paths deterministically drivable
  (docs/robustness.md#fault-points).

Everything runs on the injected app clock (virtual in tests — sctlint
D1) and the cache's own seeded RNG (D2); metrics ride a private
registry when none is injected, keeping the `new_*` literals visible to
the M1 catalog scanner. Operator surface: docs/robustness.md
"Ingress & overload", metrics in docs/metrics.md, admin `ingress`
endpoint in docs/admin.md.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Optional, Tuple

from ..util.cache import RandomEvictionCache
from ..util.faults import check_faults
from ..util.log import get_logger
from ..util.metrics import MetricsRegistry
from ..util.timer import real_monotonic

log = get_logger("Herder")

# admission decisions
ADMIT = 0      # caller must hand the frame to TransactionQueue now
PARKED = 1     # accepted into the bounded async intake; pump() delivers
THROTTLE = 2   # per-source rate/inflight exceeded -> TRY_AGAIN_LATER
SHED = 3       # overload shed -> TRY_AGAIN_LATER

# class ranks: lower rank = better; shed order walks ranks downward
CLASS_RANKS = {"priority": 0, "default": 1, "untrusted": 2}

# the config-overridable class table. rate <= 0 means unlimited (the
# flood-control convention); the defaults are deliberately generous so
# a node that never configures ingress behaves exactly like one without
# it — admission only bites when an operator declares tighter classes.
DEFAULT_CLASSES: Dict[str, dict] = {
    "priority":  {"rate": 0.0,    "burst": 0.0,     "max_inflight": 0},
    "default":   {"rate": 5000.0, "burst": 100000.0, "max_inflight": 0},
    "untrusted": {"rate": 50.0,   "burst": 200.0,   "max_inflight": 1000},
}


class RateClass:
    __slots__ = ("name", "rank", "rate", "burst", "max_inflight")

    def __init__(self, name: str, rate: float, burst: float,
                 max_inflight: int) -> None:
        self.name = name
        self.rank = CLASS_RANKS[name]
        self.rate = float(rate)
        self.burst = float(burst)
        self.max_inflight = int(max_inflight)

    def to_json(self) -> dict:
        return {"rank": self.rank, "rate": self.rate, "burst": self.burst,
                "max_inflight": self.max_inflight}


class _SourceState:
    __slots__ = ("tokens", "last_refill", "inflight")

    def __init__(self, tokens: float, now: float) -> None:
        self.tokens = tokens
        self.last_refill = now
        self.inflight = 0


class TxIngress:
    """Admission layer; see module docstring."""

    # explicit class assignments are operator input; cap them so a
    # misbehaving driver cannot grow the override map without bound
    MAX_CLASS_OVERRIDES = 4096
    # floor for computed retry-after hints (seconds)
    MIN_RETRY_AFTER = 0.05
    # retry-after when the hint is not rate-derived (shed / stall):
    # "come back after roughly one close drains the backlog"
    DEFAULT_RETRY_AFTER = 1.0

    def __init__(self, metrics=None, now_fn=None, faults=None,
                 classes: Optional[Dict[str, dict]] = None,
                 priority=(), untrusted=(),
                 intake_depth: int = 512, max_sources: int = 65536,
                 async_intake: bool = False,
                 sink: Optional[Callable] = None,
                 shed_cb: Optional[Callable[[bytes], None]] = None) -> None:
        self._now = now_fn or real_monotonic
        # private registry when none is injected: direct constructions
        # (unit tests, the soak harness) stay app-free while every
        # registration below uses the new_* idiom the M1 scanner keys on
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(now_fn=self._now)
        self.faults = faults
        self.classes: Dict[str, RateClass] = {}
        for name, defaults in DEFAULT_CLASSES.items():
            spec = dict(defaults)
            spec.update((classes or {}).get(name, {}))
            self.classes[name] = RateClass(
                name, spec["rate"], spec["burst"], spec["max_inflight"])
        self._class_of: Dict[bytes, str] = {}
        for acct in priority:
            self.set_class(acct, "priority")
        for acct in untrusted:
            self.set_class(acct, "untrusted")
        self.intake_depth = int(intake_depth)
        self.async_intake = bool(async_intake)
        self._sink = sink
        self._shed_cb = shed_cb
        # per-source token buckets, bounded; the cache's own seeded RNG
        # keeps eviction deterministic (sctlint D2)
        self._sources: RandomEvictionCache = RandomEvictionCache(
            max(1, int(max_sources)))
        # bounded async intake: one FIFO per class, drained priority-first
        self._intake: Dict[str, deque] = {n: deque() for n in CLASS_RANKS}
        self._intake_total = 0
        self.last_retry_after: Optional[float] = None
        m = self.metrics
        self._m_admitted = m.new_meter("herder.ingress.admitted")
        self._m_parked = m.new_meter("herder.ingress.parked")
        self._m_throttled = m.new_meter("herder.ingress.throttled")
        self._m_shed = m.new_meter("herder.ingress.shed")
        self._m_pumped = m.new_meter("herder.ingress.pumped")
        self._g_depth = m.new_gauge("herder.ingress.intake-depth")
        self._g_sources = m.new_gauge("herder.ingress.sources")
        self.reset_counters()

    # -- class table ---------------------------------------------------------
    def set_class(self, account: bytes, class_name: str) -> None:
        """Pin `account` (32 raw key bytes) to a rate class; assigning
        "default" removes the override. The override map is bounded."""
        if class_name not in self.classes:
            raise ValueError("unknown ingress class %r (known: %s)"
                             % (class_name,
                                ", ".join(sorted(self.classes))))
        if class_name == "default":
            self._class_of.pop(account, None)
            return
        if account not in self._class_of and \
                len(self._class_of) >= self.MAX_CLASS_OVERRIDES:
            raise ValueError("ingress class override map is full "
                             "(%d entries)" % self.MAX_CLASS_OVERRIDES)
        self._class_of[account] = class_name

    def class_of(self, account: bytes) -> RateClass:
        return self.classes[self._class_of.get(account, "default")]

    # -- admission -----------------------------------------------------------
    def _state(self, account: bytes, rc: RateClass,
               now: float) -> _SourceState:
        st = self._sources.maybe_get(account)
        if st is None:
            st = _SourceState(rc.burst, now)
            self._sources.put(account, st)
        return st

    def _retry_after(self, rc: RateClass, st: _SourceState) -> float:
        if rc.rate <= 0:
            return self.DEFAULT_RETRY_AFTER
        deficit = max(0.0, 1.0 - st.tokens)
        return max(self.MIN_RETRY_AFTER,
                   round(deficit / rc.rate, 3) or self.MIN_RETRY_AFTER)

    def admit(self, frame, tx_hash: Optional[bytes] = None,
              fresh: bool = True) -> Tuple[int, Optional[float]]:
        """Admission decision for one frame. Returns (decision,
        retry_after): ADMIT means the caller must queue the frame now,
        PARKED means the bounded intake took it (`pump()` delivers),
        THROTTLE/SHED carry a retry-after hint for the submitter."""
        account = frame.source_account_id().key_bytes
        return self.admit_source(account, frame=frame, tx_hash=tx_hash,
                                 fresh=fresh)

    def admit_source(self, account: bytes, frame=None,
                     tx_hash: Optional[bytes] = None,
                     fresh: bool = True) -> Tuple[int, Optional[float]]:
        """Core admission on raw source-account bytes (the soak test
        drives this directly with synthetic keys)."""
        rc = self.class_of(account)
        now = self._now()
        st = self._state(account, rc, now)
        self._g_sources.set(len(self._sources))
        self.last_retry_after = None
        if check_faults(self, "ingress.shed-storm"):
            return self._shed(rc, "shed-storm")
        if check_faults(self, "ingress.admit-stall"):
            # the admission decision itself is delayed: tell the caller
            # to come back, without charging the source's bucket
            return self._throttle(rc, self.DEFAULT_RETRY_AFTER, "stall")
        if rc.rate > 0:
            st.tokens = min(rc.burst,
                            st.tokens + (now - st.last_refill) * rc.rate)
            st.last_refill = now
            if st.tokens < 1.0:
                return self._throttle(rc, self._retry_after(rc, st))
        if rc.max_inflight > 0 and st.inflight >= rc.max_inflight:
            return self._throttle(rc, self.DEFAULT_RETRY_AFTER,
                                  "inflight")
        if self.async_intake and self._sink is not None and \
                frame is not None:
            parked = self._park(rc, frame, tx_hash, fresh)
            if not parked:
                return self._shed(rc, "intake-full")
            if rc.rate > 0:
                st.tokens -= 1.0
            st.inflight += 1
            return (PARKED, None)
        if rc.rate > 0:
            st.tokens -= 1.0
        st.inflight += 1
        self._m_admitted.mark()
        self.counters[rc.name]["admitted"] += 1
        return (ADMIT, None)

    def _throttle(self, rc: RateClass, retry_after: float,
                  why: str = "rate") -> Tuple[int, float]:
        self._m_throttled.mark()
        self.counters[rc.name]["throttled"] += 1
        self.last_retry_after = retry_after
        log.debug("ingress throttled a %s-class tx (%s); retry in %.3fs",
                  rc.name, why, retry_after)
        return (THROTTLE, retry_after)

    def _shed(self, rc: RateClass, why: str) -> Tuple[int, float]:
        self._m_shed.mark()
        self.counters[rc.name]["shed"] += 1
        self.last_retry_after = self.DEFAULT_RETRY_AFTER
        log.debug("ingress shed a %s-class tx (%s)", rc.name, why)
        return (SHED, self.DEFAULT_RETRY_AFTER)

    # -- bounded async intake ------------------------------------------------
    def _park(self, rc: RateClass, frame, tx_hash, fresh) -> bool:
        """Park an admitted frame in its class FIFO. When the intake is
        at depth, the arrival only enters by shedding the tail of the
        worst-ranked non-empty class strictly below it (lowest class
        first, never the other way around)."""
        if self._intake_total >= self.intake_depth:
            victim_class = None
            for name in sorted(self.classes,
                               key=lambda n: -self.classes[n].rank):
                if self.classes[name].rank <= rc.rank:
                    break
                if self._intake[name]:
                    victim_class = name
                    break
            if victim_class is None:
                return False
            _, vh, vfresh = self._intake[victim_class].pop()
            self._intake_total -= 1
            self._m_shed.mark()
            self.counters[victim_class]["shed"] += 1
            if vfresh and vh is not None and self._shed_cb is not None:
                self._shed_cb(vh)
        self._intake[rc.name].append((frame, tx_hash, fresh))
        self._intake_total += 1
        self._m_parked.mark()
        self.counters[rc.name]["admitted"] += 1
        self._g_depth.set(self._intake_total)
        return True

    def pump(self, max_n: Optional[int] = None) -> int:
        """Drain up to `max_n` parked frames (all, when None) into the
        sink in class-rank order — priority first, so a lower-class
        backlog can never starve the priority class."""
        if self._sink is None or self._intake_total == 0:
            return 0
        budget = self._intake_total if max_n is None \
            else min(max_n, self._intake_total)
        pumped = 0
        for name in sorted(self.classes,
                           key=lambda n: self.classes[n].rank):
            q = self._intake[name]
            while q and pumped < budget:
                frame, tx_hash, fresh = q.popleft()
                self._intake_total -= 1
                pumped += 1
                self._sink(frame, tx_hash, fresh)
            if pumped >= budget:
                break
        if pumped:
            self._m_pumped.mark(pumped)
        self._g_depth.set(self._intake_total)
        return pumped

    def intake_depth_now(self) -> int:
        return self._intake_total

    # -- lifecycle hooks -----------------------------------------------------
    def ledger_closed(self) -> None:
        """A close drains the pool: reset the per-source inflight
        window (max_inflight caps admissions per close window) and reap
        sources whose buckets have fully refilled."""
        now = self._now()
        for key in self._sources.keys():
            st = self._sources.get(key)
            st.inflight = 0
            rc = self.class_of(key)
            if rc.rate > 0:
                st.tokens = min(rc.burst, st.tokens +
                                (now - st.last_refill) * rc.rate)
                st.last_refill = now
                if st.tokens >= rc.burst:
                    self._sources.erase(key)
            else:
                self._sources.erase(key)
        self._g_sources.set(len(self._sources))

    def reset_counters(self) -> None:
        self.counters: Dict[str, Dict[str, int]] = {
            n: {"admitted": 0, "throttled": 0, "shed": 0}
            for n in CLASS_RANKS}

    # -- introspection -------------------------------------------------------
    def to_json(self) -> dict:
        """The admin `ingress?action=status` blob."""
        return {
            "async_intake": self.async_intake,
            "intake": {"depth": self._intake_total,
                       "cap": self.intake_depth,
                       "per_class": {n: len(q)
                                     for n, q in self._intake.items()}},
            "sources": {"tracked": len(self._sources),
                        "cap": self._sources._max,
                        "evictions": self._sources.evictions},
            "classes": {n: rc.to_json()
                        for n, rc in sorted(self.classes.items())},
            "overrides": len(self._class_of),
            "counters": {n: dict(c)
                         for n, c in sorted(self.counters.items())},
        }
