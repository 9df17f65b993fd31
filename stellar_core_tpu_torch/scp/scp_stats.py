"""ScpStats: the consensus cockpit's shared aggregation
(docs/observability.md#consensus-cockpit).

Copied from `stellar_core_tpu/scp/scp_stats.py` at commit a6220d9; carry
a fix in either copy to the other. Nothing is left out. Its readers
outside the port's herder are the admin `scpstats` endpoint and the
`health` rollup (`main/command_handler.py`) and `util/fleet.py`.

The seventh cockpit. Six cockpits aim every subsystem *except the one
the paper is about*: SCP itself had only the slot-timeline event
journal. This module turns those journaled stamps into attribution —

- **per-slot phase latencies** (nominate-trigger → first-candidate →
  prepare → confirm → externalize), DERIVED from the same stamps the
  slot timeline journals (`_phase_report` reads them back via
  `SlotTimeline.first`), so the cockpit and the journal reconcile by
  construction — there is one slot-latency definition, anchored at the
  `nominate.trigger` stamp (docs/observability.md#slot-latency-anchor);
- **nomination/ballot round counts** and **timer-fire attribution**:
  which timer (nomination vs ballot), which round it was armed for, and
  whether it fired or was cancelled/re-armed — ballot-round inflation
  and timer-fire storms are the stuck-slot smoke signals;
- **per-statement-type envelopes-per-slot** (sent AND received) — the
  committed O(n²) flood baseline that ROADMAP item 1's BLS aggregate
  quorum certificates must beat (EdDSA-vs-BLS committee study,
  PAPERS.md 2302.00418);
- **per-peer envelope lag**: each peer's first arrival for a slot
  relative to the slot-local first arrival — straggler attribution at
  the consensus layer;
- **quorum health**: validators missing entirely or behind by
  latest-seen ledger seq, and stuck-slot diagnosis naming WHICH
  quorum-slice members are absent from an open slot.

Pattern parity with the other cockpits (ApplyStats et al.): injected
app clock (`now_fn` — sctlint D1 holds, virtual-clock simulations stay
deterministic), private-registry default so direct constructions stay
app-registry-free while every registration uses the literal `new_*`
idiom the M1 scanner catalogs, TrackedLock, bounded per-slot ring,
`reset()` zeroing aggregates while registry metrics stay monotonic.

Consumers: admin `scpstats` endpoint (`to_json`, `?slot=N`,
`?action=reset`), the `health` rollup's consensus leg, the metrics
registry (`scp.*` → `sct_scp_*` in the Prometheus exposition), and the
fleet view (`fleet_json()` merged by util/fleet.py into fleet-wide
envelopes-per-slot — the `bench.py --fleet-scale` record).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Set

from ..history.checkpoints import checkpoint_containing, first_in_checkpoint
from ..util.metrics import MetricsRegistry
from ..util.threads import TrackedLock
from ..util.timer import real_monotonic
from ..xdr import SCPStatementType

# statement type -> short kind; the same vocabulary as the slot
# timeline's `<kind>.seen` events, so the two surfaces line up
STATEMENT_KIND = {
    SCPStatementType.SCP_ST_NOMINATE: "nominate",
    SCPStatementType.SCP_ST_PREPARE: "prepare",
    SCPStatementType.SCP_ST_CONFIRM: "confirm",
    SCPStatementType.SCP_ST_EXTERNALIZE: "externalize",
}
STATEMENT_KINDS = ("nominate", "prepare", "confirm", "externalize")

# SCPTimerID -> timer name (scp/driver.py: NOMINATION=0, BALLOT=1)
TIMER_NAMES = {0: "nomination", 1: "ballot"}

# phase -> (start stamp, end stamp) in the slot-timeline journal; the
# edges chain, so the phase durations telescope to exactly
# externalize - nominate.trigger when every stamp is present
PHASES = ("nominate", "prepare", "confirm", "externalize")
PHASE_EDGES = (
    ("nominate", "nominate.trigger", "nominate.candidate"),
    ("prepare", "nominate.candidate", "ballot.phase.confirm"),
    ("confirm", "ballot.phase.confirm", "ballot.phase.externalize"),
    ("externalize", "ballot.phase.externalize", "externalize"),
)


def _new_peer() -> dict:
    return {"lag_sum": 0.0, "lag_max": 0.0, "samples": 0,
            "latest_slot": 0}


class ScpStats:
    """Consensus-cockpit aggregation; see module docstring."""

    MAX_SLOTS = 64       # per-slot records retained (ring, like the timeline)
    MAX_PEERS = 256      # per-peer lag/latest-seen entries retained
    MAX_FIRES = 32       # timer-fire attributions retained per slot
    BEHIND_SLOTS = 2     # latest-seen lag before a validator is "behind"

    def __init__(self, metrics=None, tracer=None, now_fn=None,
                 self_id: Optional[str] = None, timeline=None) -> None:
        self._now = now_fn or real_monotonic
        # a private registry when none is injected keeps direct
        # constructions (tests, harnesses) app-registry-free while
        # letting every registration below use the new_* idiom the M1
        # metric-catalog scanner keys on
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(now_fn=self._now)
        self.tracer = tracer
        self.self_id = self_id or ""
        self.timeline = timeline
        self._lock = TrackedLock("scp.scp-stats")
        self.quorum_members: Set[str] = set()
        m = self.metrics
        self._t_phase = {p: m.new_timer("scp.phase.%s" % p)
                         for p in PHASES}
        self._t_wall = m.new_timer("scp.slot.wall")
        self._h_rounds = {k: m.new_histogram("scp.rounds.%s" % k)
                          for k in ("nomination", "ballot")}
        self._m_fired = {k: m.new_meter("scp.timer.%s.fired" % k)
                         for k in TIMER_NAMES.values()}
        self._m_cancelled = {k: m.new_meter("scp.timer.%s.cancelled" % k)
                             for k in TIMER_NAMES.values()}
        self._h_sent = {k: m.new_histogram("scp.envelopes.sent.%s" % k)
                        for k in STATEMENT_KINDS}
        self._h_recv = {k: m.new_histogram("scp.envelopes.recv.%s" % k)
                        for k in STATEMENT_KINDS}
        self._t_peer_lag = m.new_timer("scp.peer.lag")
        self._g_missing = m.new_gauge("scp.quorum.missing")
        self._g_behind = m.new_gauge("scp.quorum.behind")
        self._g_slots = m.new_gauge("scp.slots.tracked")
        self._m_pruned = m.new_meter("scp.slots.pruned")
        self.reset()

    # -- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        """Zero the aggregates (admin `scpstats?action=reset`; registry
        metrics keep their monotonic histories)."""
        with self._lock:
            # slot -> per-slot record (ring bounded at MAX_SLOTS)
            self._slots: "OrderedDict[int, dict]" = OrderedDict()
            self.peers: Dict[str, dict] = {}
            self.totals = {"sent": 0, "recv": 0,
                           "timer_fired": 0, "timer_cancelled": 0,
                           "pruned": 0, "dropped_slots": 0}
            # (slot, timer_id) -> round the pending timer was armed for
            self._pending_timers: Dict[tuple, int] = {}

    def set_quorum(self, members_hex) -> None:
        """Install the local quorum-slice membership (node-id hex) the
        health tracking diagnoses against; the local node is excluded
        (it cannot be absent from itself)."""
        self.quorum_members = set(members_hex) - {self.self_id}

    # -- per-slot record -----------------------------------------------------
    def _slot_locked(self, slot: int) -> Optional[dict]:
        rec = self._slots.get(slot)
        if rec is None:
            if len(self._slots) >= self.MAX_SLOTS:
                oldest = min(self._slots)
                if slot < oldest:
                    # a straggler for an already-evicted slot must not
                    # resurrect it (same rule as the timeline ring)
                    return None
                del self._slots[oldest]
                self.totals["dropped_slots"] += 1
            rec = self._slots[slot] = {
                "rounds": {"nomination": 0, "ballot": 0},
                "timers": {k: {"armed": 0, "fired": 0, "cancelled": 0}
                           for k in TIMER_NAMES.values()},
                "fires": [],
                "sent": {}, "recv": {},
                "first_t": None,       # slot-local first peer arrival
                "peer_first": {},      # peer -> its first arrival t
                "senders": set(),      # peers heard from for this slot
                "phases": None,
                "externalized": False,
            }
            self._g_slots.set(len(self._slots))
        return rec

    # -- round hooks (scp/nomination.py, scp/ballot.py) ----------------------
    def nomination_round(self, slot: int, round_number: int,
                         timed_out: bool) -> None:
        with self._lock:
            rec = self._slot_locked(slot)
            if rec is not None:
                r = rec["rounds"]
                r["nomination"] = max(r["nomination"], round_number)

    def ballot_bumped(self, slot: int, counter: int) -> None:
        if counter >= 0xFFFFFFFF:
            # the externalize bump sets the counter to the protocol's
            # "infinity" sentinel — that is phase progress, not a round
            return
        with self._lock:
            rec = self._slot_locked(slot)
            if rec is not None:
                r = rec["rounds"]
                r["ballot"] = max(r["ballot"], counter)

    # -- timer attribution (Herder.setup_scp_timer) --------------------------
    def _round_for_locked(self, rec: dict, timer_id: int) -> int:
        key = "nomination" if timer_id == 0 else "ballot"
        return rec["rounds"][key]

    def timer_armed(self, slot: int, timer_id: int) -> None:
        name = TIMER_NAMES.get(timer_id)
        if name is None:
            return
        cancelled = False
        with self._lock:
            rec = self._slot_locked(slot)
            if rec is None:
                return
            key = (slot, timer_id)
            if key in self._pending_timers:
                # re-armed before firing: the previous schedule was
                # cancelled (nomination re-arms per round)
                rec["timers"][name]["cancelled"] += 1
                self.totals["timer_cancelled"] += 1
                cancelled = True
            self._pending_timers[key] = self._round_for_locked(
                rec, timer_id)
            rec["timers"][name]["armed"] += 1
        if cancelled:
            self._m_cancelled[name].mark()

    def timer_cancelled(self, slot: int, timer_id: int) -> None:
        """Explicit cancel (setup_timer with cb=None); a no-op unless a
        timer was actually pending — cancelling an idle slot's timer is
        not an event."""
        name = TIMER_NAMES.get(timer_id)
        if name is None:
            return
        fire = False
        with self._lock:
            if self._pending_timers.pop((slot, timer_id), None) is None:
                return
            rec = self._slots.get(slot)
            if rec is not None:
                rec["timers"][name]["cancelled"] += 1
            self.totals["timer_cancelled"] += 1
            fire = True
        if fire:
            self._m_cancelled[name].mark()

    def timer_fired(self, slot: int, timer_id: int) -> None:
        name = TIMER_NAMES.get(timer_id)
        if name is None:
            return
        with self._lock:
            rnd = self._pending_timers.pop((slot, timer_id), None)
            rec = self._slots.get(slot)
            if rec is not None:
                rec["timers"][name]["fired"] += 1
                if len(rec["fires"]) < self.MAX_FIRES:
                    rec["fires"].append({"timer": name, "round": rnd})
            self.totals["timer_fired"] += 1
        self._m_fired[name].mark()

    # -- envelope accounting (Herder.emit_envelope, Slot.process_envelope) ---
    def envelope_sent(self, slot: int, kind: str) -> None:
        with self._lock:
            rec = self._slot_locked(slot)
            if rec is None:
                return
            rec["sent"][kind] = rec["sent"].get(kind, 0) + 1
            self.totals["sent"] += 1

    def envelope_received(self, slot: int, kind: str, peer: str,
                          is_self: bool = False) -> None:
        """Every peer envelope arrival for `slot` (NOT deduped — the
        timeline keeps first-arrivals only; the cockpit counts the full
        O(n²) flood the BLS quorum-certificate work must shrink).
        `is_self` skips our own emissions echoed back through the
        processing path."""
        if is_self:
            return
        t = self._now()
        with self._lock:
            rec = self._slot_locked(slot)
            if rec is None:
                return
            rec["recv"][kind] = rec["recv"].get(kind, 0) + 1
            self.totals["recv"] += 1
            if rec["first_t"] is None or t < rec["first_t"]:
                rec["first_t"] = t
            pf = rec["peer_first"]
            if peer not in pf and len(pf) < self.MAX_PEERS:
                pf[peer] = t
            if len(rec["senders"]) < self.MAX_PEERS:
                rec["senders"].add(peer)
            p = self.peers.get(peer)
            if p is None:
                if len(self.peers) >= self.MAX_PEERS:
                    return   # bounded: beyond the cap only totals count
                p = self.peers[peer] = _new_peer()
            p["latest_slot"] = max(p["latest_slot"], slot)

    # -- phase attribution (derived from the slot-timeline stamps) -----------
    def _phase_report(self, slot: int) -> Optional[dict]:
        """Phase latencies for `slot`, read back from the SAME stamps
        the slot timeline journaled — reconciliation between the
        cockpit and the journal is by construction, not by luck. A
        missing stamp (non-validator, restored slot) nulls the phases
        it bounds; `wall_s` is the canonical slot latency
        externalize - nominate.trigger (the unified anchor)."""
        tl = self.timeline
        if tl is None:
            return None
        stamps: Dict[str, float] = {}
        for _, start, end in PHASE_EDGES:
            for name in (start, end):
                if name not in stamps:
                    ev = tl.first(slot, name)
                    if ev is not None:
                        stamps[name] = ev["t"]
        phases: Dict[str, Optional[float]] = {}
        for name, start, end in PHASE_EDGES:
            if start in stamps and end in stamps:
                phases[name] = round(
                    max(0.0, stamps[end] - stamps[start]), 6)
            else:
                phases[name] = None
        wall = None
        if "nominate.trigger" in stamps and "externalize" in stamps:
            wall = round(max(
                0.0, stamps["externalize"] - stamps["nominate.trigger"]), 6)
        return {"phase_s": phases, "wall_s": wall,
                "stamps": {k: v for k, v in sorted(stamps.items())}}

    def slot_externalized(self, slot: int) -> None:
        """The slot externalized (Herder.value_externalized, after the
        timeline's `externalize` stamp lands): derive and latch the
        phase report, feed the round/envelope histograms, and settle
        per-peer lag against the slot-local first arrival."""
        report = self._phase_report(slot)
        with self._lock:
            rec = self._slot_locked(slot)
            if rec is None:
                return
            rec["externalized"] = True
            rec["phases"] = report
            nrounds = rec["rounds"]["nomination"]
            brounds = rec["rounds"]["ballot"]
            sent = dict(rec["sent"])
            recv = dict(rec["recv"])
            first = rec["first_t"]
            lags = {}
            if first is not None:
                for peer, t in rec["peer_first"].items():
                    lag = max(0.0, t - first)
                    lags[peer] = lag
                    p = self.peers.get(peer)
                    if p is not None:
                        p["lag_sum"] += lag
                        p["lag_max"] = max(p["lag_max"], lag)
                        p["samples"] += 1
        if report is not None:
            for name, v in report["phase_s"].items():
                if v is not None:
                    self._t_phase[name].update(v)
            if report["wall_s"] is not None:
                self._t_wall.update(report["wall_s"])
        self._h_rounds["nomination"].update(nrounds)
        self._h_rounds["ballot"].update(brounds)
        for k, n in sent.items():
            if k in self._h_sent:
                self._h_sent[k].update(n)
        for k, n in recv.items():
            if k in self._h_recv:
                self._h_recv[k].update(n)
        for lag in lags.values():
            self._t_peer_lag.update(lag)

    # -- quorum health -------------------------------------------------------
    def quorum_health(self, current_slot: int) -> dict:
        """Validators missing entirely (never heard from) or behind by
        latest-seen slot — the `health` rollup's quorum-gap signal."""
        with self._lock:
            missing = sorted(m for m in self.quorum_members
                             if m not in self.peers)
            behind = sorted(
                m for m in self.quorum_members
                if m in self.peers and
                self.peers[m]["latest_slot"] <
                current_slot - self.BEHIND_SLOTS)
        self._g_missing.set(len(missing))
        self._g_behind.set(len(behind))
        return {"members": len(self.quorum_members),
                "missing": missing, "behind": behind}

    def stuck_slots(self, current_slot: int,
                    include_open: bool = False) -> list:
        """Non-externalized slots the chain has moved past, each
        diagnosing WHICH quorum-slice members are absent — the names an
        operator chases when consensus stalls. `include_open` also
        inspects the current in-flight slot (pass it when the node has
        LOST sync — a healthy mid-nomination slot is not stuck)."""
        limit = current_slot if include_open else current_slot - 1
        out = []
        with self._lock:
            for slot in sorted(self._slots):
                rec = self._slots[slot]
                if rec["externalized"] or slot > limit:
                    continue
                absent = sorted(self.quorum_members - rec["senders"])
                out.append({"slot": slot, "absent": absent,
                            "heard_from": len(rec["senders"])})
        return out

    def health(self, current_slot: int,
               ballot_inflation_threshold: int = 3,
               include_open: bool = False) -> dict:
        """The consensus leg of the admin `health` rollup: stuck slots
        (with absent-member diagnosis), quorum gaps, and ballot-round
        inflation over the retained ring. `include_open` extends the
        stuck-slot sweep to the in-flight slot (set when out of sync)."""
        stuck = self.stuck_slots(current_slot, include_open=include_open)
        quorum = self.quorum_health(current_slot)
        with self._lock:
            worst_ballot = max(
                (rec["rounds"]["ballot"] for rec in self._slots.values()),
                default=0)
        return {
            "stuck_slots": stuck,
            "quorum": quorum,
            "ballot_rounds_worst": worst_ballot,
            "ballot_inflated": worst_ballot >= ballot_inflation_threshold,
        }

    # -- pruning (ledger_closed hook) ----------------------------------------
    def slot_closed(self, ledger_seq: int) -> None:
        """Prune per-slot records from before the current checkpoint's
        first slot (history/checkpoints.py) — the same explicit memory
        bound every cockpit ring observes."""
        cutoff = first_in_checkpoint(checkpoint_containing(ledger_seq))
        pruned = 0
        with self._lock:
            for s in [s for s in self._slots if s < cutoff]:
                del self._slots[s]
                pruned += 1
            for key in [k for k in self._pending_timers if k[0] < cutoff]:
                del self._pending_timers[key]
            self.totals["pruned"] += pruned
            self._g_slots.set(len(self._slots))
        if pruned:
            self._m_pruned.mark(pruned)

    # -- exports -------------------------------------------------------------
    def _slot_json_locked(self, slot: int, rec: dict) -> dict:
        return {
            "slot": slot,
            "externalized": rec["externalized"],
            "rounds": dict(rec["rounds"]),
            "timers": {k: dict(v) for k, v in rec["timers"].items()},
            "fires": [dict(f) for f in rec["fires"]],
            "envelopes": {"sent": dict(rec["sent"]),
                          "recv": dict(rec["recv"])},
            "heard_from": len(rec["senders"]),
            "phases": rec["phases"],
        }

    def slot_report(self, slot: int) -> Optional[dict]:
        """One slot's full attribution (admin `scpstats?slot=N`)."""
        with self._lock:
            rec = self._slots.get(slot)
            if rec is None:
                return None
            return self._slot_json_locked(slot, rec)

    def _peers_json_locked(self) -> dict:
        out = {}
        for pid, p in self.peers.items():
            n = p["samples"]
            out[pid] = {
                "latest_slot": p["latest_slot"],
                "lag_mean_ms": round(p["lag_sum"] / n * 1e3, 3) if n
                else None,
                "lag_max_ms": round(p["lag_max"] * 1e3, 3),
                "samples": n,
            }
        return out

    def to_json(self) -> dict:
        """The admin `scpstats` cockpit blob."""
        with self._lock:
            slots = {str(s): self._slot_json_locked(s, rec)
                     for s, rec in sorted(self._slots.items())}
            ext = [s for s, rec in self._slots.items()
                   if rec["externalized"]]
            last_ext = max(ext) if ext else None
            out = {
                "totals": dict(self.totals),
                "slots_tracked": len(self._slots),
                "last_externalized": last_ext,
                "slots": slots,
                "peers": self._peers_json_locked(),
            }
        wall = self._t_wall.snapshot()
        out["slot_wall_ms"] = {
            "count": wall["count"],
            "p50": round(wall["median"] * 1e3, 3),
            "p95": round(wall["p95"] * 1e3, 3),
        }
        out["phase_p95_ms"] = {
            p: round(self._t_phase[p].snapshot()["p95"] * 1e3, 3)
            for p in PHASES}
        return out

    def fleet_json(self) -> dict:
        """Compact per-node export the FleetAggregator merges into the
        fleet-wide envelopes-per-slot baseline (one shape for in-process
        `add_app` and HTTP `add_http` intake)."""
        with self._lock:
            return {
                "self": self.self_id,
                "totals": dict(self.totals),
                "slots": {str(s): {
                    "externalized": rec["externalized"],
                    "rounds": dict(rec["rounds"]),
                    "sent": dict(rec["sent"]),
                    "recv": dict(rec["recv"]),
                    "phases": rec["phases"],
                } for s, rec in sorted(self._slots.items())},
            }
