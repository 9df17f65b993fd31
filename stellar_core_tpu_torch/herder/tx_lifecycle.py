"""TxLifecycle: end-to-end transaction latency attribution
(docs/observability.md#overlay-cockpit).

Copied from `stellar_core_tpu/herder/tx_lifecycle.py` at commit 02f8fbd;
carry a fix in either copy to the other. Nothing is left out.

Answers "how long does a user's transaction take from submit to
applied?" by stamping each locally-received transaction at four
boundaries, all on the injected app clock (sctlint D1 — virtual-clock
simulations stay deterministic):

    submit      Herder.recv_transaction entry (HTTP `tx` or overlay flood)
    queue       TransactionQueue.try_add admission (signature checks paid)
    include     txset construction at nomination (trigger_next_ledger)
    externalize the slot's value externalizing
    apply       the close completing for that slot

Consecutive stamps become the stage histograms
`herder.tx.latency.submit-to-queue` / `queue-to-include` /
`include-to-externalize` / `externalize-to-apply`, and
`herder.tx.latency.total` is computed as the SUM of the four stage
durations — the stages sum to total *by construction*, the same
sum-contract style as the close cockpit's `apply_breakdown`
(tools/bench_compare.py validates it in committed artifacts). A stage
that never happened locally (another node's txset won nomination, so
`include` was never stamped here) is backfilled at the next stamp and
contributes a zero-width stage, keeping the contract exact.

The funnel completes with per-tx outcomes (`herder.tx.outcome.<kind>`):
`applied`, `rejected` (admission failed), `replaced` (replace-by-fee),
`evicted` (surge eviction), `expired` (aged out of the pool), `banned`
(trimmed invalid), `dropped` (chain-mate invalidated by an applied tx),
`deferred` (externalized into a catchup gap), `untracked` (tracking-map
overflow), `shed` / `throttled` (the ingress tier refused it before
queue admission — herder/ingress.py). Only locally-observed
transactions are tracked, and the map is bounded at MAX_TRACKED
entries.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from ..util.metrics import MetricsRegistry
from ..util.threads import TrackedLock
from ..util.timer import real_monotonic

# stage index in the stamp vector -> stage metric segment
STAGES = ("submit-to-queue", "queue-to-include",
          "include-to-externalize", "externalize-to-apply")


class TxLifecycle:
    """Tx-lifecycle aggregation; see module docstring."""

    MAX_TRACKED = 8192

    def __init__(self, metrics=None, tracer=None, now_fn=None) -> None:
        self._now = now_fn or real_monotonic
        # a private registry when none is injected keeps direct
        # constructions (tests, harnesses) app-registry-free while
        # letting every registration below use the new_* idiom the M1
        # metric-catalog scanner keys on
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(now_fn=self._now)
        self.tracer = tracer
        self._lock = TrackedLock("herder.tx-lifecycle")
        m = self.metrics
        self._h_stage = {
            s: m.new_histogram("herder.tx.latency.%s" % s) for s in STAGES}
        self._h_total = m.new_histogram("herder.tx.latency.total")
        self._m_outcome: Dict[str, object] = {}
        self.reset()

    # -- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        """Zero the cumulative aggregates (admin
        `overlaystats?action=reset`; registry metrics keep their
        monotonic histories)."""
        with self._lock:
            # tx hash -> [t_submit, t_queue, t_include, t_ext] stamps
            self._pending: Dict[bytes, list] = {}
            self.stage_seconds: Dict[str, float] = {s: 0.0 for s in STAGES}
            self.total_seconds = 0.0
            self.applied_count = 0
            self.outcomes: Dict[str, int] = {}
            self.last_slot: Optional[dict] = None
            self._slot_outcomes: Dict[str, int] = {}

    # -- stamps --------------------------------------------------------------
    def submit(self, tx_hash: bytes) -> bool:
        """Stamp a tx at submission; False when the hash is already
        tracked (a re-flooded duplicate must not clobber the original
        stamps)."""
        now = self._now()
        shed = False
        with self._lock:
            if tx_hash in self._pending:
                return False
            if len(self._pending) >= self.MAX_TRACKED:
                # bounded: shed the oldest entry (insertion order)
                oldest = next(iter(self._pending))
                del self._pending[oldest]
                self._outcome_locked("untracked", 1)
                shed = True
            self._pending[tx_hash] = [now, None, None, None]
        if shed:
            self._outcome_meter("untracked").mark()
        return True

    def _stamp(self, tx_hash: bytes, idx: int) -> None:
        now = self._now()
        with self._lock:
            st = self._pending.get(tx_hash)
            if st is None:
                return
            if st[idx] is None:
                st[idx] = now
            # backfill skipped stages so every stage duration stays
            # defined (zero-width) and the sum contract holds
            for i in range(idx):
                if st[i] is None:
                    st[i] = st[idx]

    def queued(self, tx_hash: bytes) -> None:
        self._stamp(tx_hash, 1)

    def included(self, tx_hashes: Iterable[bytes]) -> None:
        for h in tx_hashes:
            self._stamp(h, 2)

    def externalized(self, tx_hashes: Iterable[bytes]) -> None:
        for h in tx_hashes:
            self._stamp(h, 3)

    # -- funnel outcomes -----------------------------------------------------
    def _outcome_meter(self, kind: str):
        m = self._m_outcome.get(kind)
        if m is None:
            m = self.metrics.new_meter("herder.tx.outcome.%s" % kind)
            self._m_outcome[kind] = m
        return m

    def _outcome_locked(self, kind: str, n: int = 1) -> None:
        self.outcomes[kind] = self.outcomes.get(kind, 0) + n
        self._slot_outcomes[kind] = self._slot_outcomes.get(kind, 0) + n

    def outcome(self, tx_hash: bytes, kind: str) -> bool:
        """Terminal outcome for a tracked tx (evicted/expired/...);
        no-op for hashes this node never tracked — remote txsets must
        not inflate the funnel."""
        with self._lock:
            if self._pending.pop(tx_hash, None) is None:
                return False
            self._outcome_locked(kind)
        self._outcome_meter(kind).mark()
        return True

    # -- completion ----------------------------------------------------------
    def applied(self, tx_hashes: Iterable[bytes], slot: int) -> int:
        """The close for `slot` committed: finalize every tracked tx in
        its txset — stage histograms, the by-construction total, and the
        per-slot funnel blob. Returns the number finalized."""
        now = self._now()
        finalized = 0
        with self._lock:
            for h in tx_hashes:
                st = self._pending.pop(h, None)
                if st is None:
                    continue
                stamps = list(st) + [now]
                # backfill any stage the local node never saw
                for i in range(len(stamps) - 2, -1, -1):
                    if stamps[i] is None:
                        stamps[i] = stamps[i + 1]
                durations = [max(0.0, stamps[i + 1] - stamps[i])
                             for i in range(len(STAGES))]
                total = 0.0
                for s, d in zip(STAGES, durations):
                    self._h_stage[s].update(d)
                    self.stage_seconds[s] += d
                    total += d
                # total is the SUM of the stage durations — the sum
                # contract is exact by construction, not approximate
                self._h_total.update(total)
                self.total_seconds += total
                self.applied_count += 1
                self._outcome_locked("applied")
                finalized += 1
            slot_funnel = dict(self._slot_outcomes)
            self._slot_outcomes = {}
            self.last_slot = {"slot": slot, **slot_funnel}
        if finalized:
            self._outcome_meter("applied").mark(finalized)
        if self.tracer is not None and self.tracer.enabled and finalized:
            self.tracer.instant("herder.tx.applied", cat="herder",
                                slot=slot, txs=finalized)
        return finalized

    # -- exports -------------------------------------------------------------
    def to_json(self) -> dict:
        """The admin `overlaystats` cockpit blob (tx-lifecycle half)."""
        total = self._h_total.snapshot()
        stage_p95 = {s: round(self._h_stage[s].snapshot()["p95"] * 1e3, 3)
                     for s in STAGES}
        with self._lock:
            return {
                "applied": self.applied_count,
                "pending_tracked": len(self._pending),
                "stage_seconds": {s: round(self.stage_seconds[s], 6)
                                  for s in STAGES},
                "total_seconds": round(self.total_seconds, 6),
                "stage_p95_ms": stage_p95,
                "total_ms": {"count": total["count"],
                             "p50": round(total["median"] * 1e3, 3),
                             "p95": round(total["p95"] * 1e3, 3),
                             "mean": round(total["mean"] * 1e3, 3)},
                "outcomes": dict(sorted(self.outcomes.items())),
                "last_slot": self.last_slot,
            }

    def fleet_json(self) -> dict:
        """Compact per-node export for the FleetAggregator: cumulative
        stage/total seconds (the sum contract travels with them) plus
        the total-latency reservoir in ms, so the fleet view can compute
        true cross-node percentiles instead of merging per-node ones."""
        with self._lock:
            count = self.applied_count
            stage = {s: round(self.stage_seconds[s], 9) for s in STAGES}
            total = round(self.total_seconds, 9)
            outcomes = dict(sorted(self.outcomes.items()))
        samples = [round(v * 1e3, 3) for v in self._h_total._samples]
        return {"count": count, "stage_seconds": stage,
                "total_seconds": total, "samples_ms": samples,
                "outcomes": outcomes}
