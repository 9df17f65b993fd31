"""OverlayStats: the wire cockpit's shared aggregation
(docs/observability.md#overlay-cockpit).

Copied from `stellar_core_tpu/overlay/overlay_stats.py` at commit d7c5801;
carry a fix in either copy to the other. Nothing is left out. Its `to_json`
also serves the admin `overlaystats` endpoint and the Prometheus rendering
(`main/command_handler.py`).

One instance per OverlayManager, shared by every layer that touches the
wire — `Peer` (per-message-type byte accounting on both directions,
duplicate-frame detection), `Floodgate` (flood dedup: unique vs
duplicate receipts, broadcast fanout), the Herder's envelope intake
(receive → signature-verify → herder-process pipeline latency, tagged
with the verify backend) and the overlay tick (send-queue depth). The
same aggregate objects feed four consumers:

- the admin `overlaystats` endpoint (`to_json`, `?action=reset`);
- the metrics registry (`overlay.*` names), which makes the whole
  cockpit scrapeable as `sct_overlay_*` via `metrics?format=prometheus`;
- the tracer: `overlay.envelope.pipeline` instants carry per-envelope
  verify/process latency + backend into Chrome traces and flight dumps;
- the fleet view: `fleet_json()` is the compact per-node export the
  FleetAggregator merges into per-slot fleet bandwidth totals and the
  `overlay_breakdown` block `bench.py --fleet` / `--scenario` emit
  (normalized by tools/bench_compare.py into direction-aware records —
  `flood_duplication_ratio` is the O(n²) waste ROADMAP item 3 wants to
  shrink, measured before the BLS aggregate-signature variant can be
  judged).

Clocks: every stamp and rate reads the injected app clock (`now_fn` =
clock.now via OverlayManager), so chaos soaks under a virtual clock
stay deterministic — there are no wall-clock reads here (sctlint D1).
Recording happens on the main loop only (the overlay delivers frames
via post_to_main); the lock still guards the aggregates because the
admin HTTP thread snapshots them via handle_command hops and direct
test access.

Duplication ratio: `duplicates / unique`, where a duplicate is either
a flooded message the Floodgate had already recorded (the flood-layer
O(n²) waste) or a verified duplicate FRAME delivered by the transport
(ChaosTransport `overlay.duplicate` injection; `Peer` detects these at
the MAC layer instead of dropping the link).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..util.metrics import MetricsRegistry
from ..util.threads import TrackedLock
from ..util.timer import real_monotonic
from ..xdr import MessageType

# MessageType value -> kebab-case metric segment ("scp-message").
# Bounded: the dynamic `overlay.recv.<type>.*` / `overlay.send.<type>.*`
# name space can never exceed the wire message types (+ "malformed").
MSG_TYPE_NAMES: Dict[int, str] = {
    v: k.lower().replace("_", "-")
    for k, v in vars(MessageType).items()
    if isinstance(v, int) and not k.startswith("_") and k.isupper()
}


def msg_type_name(msg_type) -> str:
    if msg_type is None:
        return "malformed"
    return MSG_TYPE_NAMES.get(msg_type, "unknown-%d" % msg_type)


def _new_dir_totals() -> dict:
    return {"recv_bytes": 0, "recv_msgs": 0, "send_bytes": 0,
            "send_msgs": 0}


class OverlayStats:
    """Wire-cockpit aggregation; see module docstring."""

    TOP_K = 8            # peers shown in the admin blob
    MAX_PEERS = 256      # per-peer attribution entries retained
    SLOT_WINDOW = 64     # per-slot bandwidth deltas retained

    def __init__(self, metrics=None, tracer=None, now_fn=None) -> None:
        self._now = now_fn or real_monotonic
        # a private registry when none is injected keeps direct
        # constructions (tests, harnesses) app-registry-free while
        # letting every registration below use the new_* idiom the M1
        # metric-catalog scanner keys on
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(now_fn=self._now)
        self.tracer = tracer
        self._lock = TrackedLock("overlay.overlay-stats")
        # fixed-name registry metrics, created eagerly so the Prometheus
        # export carries the full cockpit shape from the first scrape
        m = self.metrics
        self._m_funique = m.new_meter("overlay.flood.unique")
        self._m_fdup = m.new_meter("overlay.flood.duplicate")
        self._h_fanout = m.new_histogram("overlay.flood.fanout")
        self._m_dupframe = m.new_meter("overlay.recv.duplicate-frame")
        self._g_queue = m.new_gauge("overlay.send-queue.depth")
        self._g_queue_peers = m.new_gauge("overlay.send-queue.backlogged")
        self._t_verify = m.new_timer("overlay.envelope.verify-latency")
        self._t_process = m.new_timer("overlay.envelope.process-latency")
        self._m_erejected = m.new_meter("overlay.envelope.rejected")
        # per-message-type / per-backend metrics, resolved once — the
        # frame hot path must not pay a name format + registry lookup
        # per message (both name spaces are small and bounded)
        self._m_type: Dict[tuple, tuple] = {}
        self._t_backend: Dict[str, object] = {}
        self.reset()

    # -- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        """Zero the cumulative aggregates (admin
        `overlaystats?action=reset`; registry metrics keep their
        monotonic histories — Prometheus counters must never go
        backwards)."""
        with self._lock:
            self.totals = _new_dir_totals()
            self.by_type: Dict[str, dict] = {}
            self.peers: Dict[str, dict] = {}
            self.flood = {"unique": 0, "duplicates": 0, "broadcasts": 0,
                          "fanout_total": 0}
            self.envelope = {"count": 0, "rejected": 0,
                             "verify_seconds": 0.0, "process_seconds": 0.0,
                             "by_backend": {}}
            self.queue = {"bytes": 0, "backlogged": 0}
            self.per_slot: Dict[int, dict] = {}
            self._slot_base = _new_dir_totals()

    # -- per-message accounting ----------------------------------------------
    def _type_metrics(self, direction: str, name: str) -> tuple:
        key = (direction, name)
        mt = self._m_type.get(key)
        if mt is None:
            if direction == "recv":
                mt = (self.metrics.new_meter(
                          "overlay.recv.%s.count" % name),
                      self.metrics.new_histogram(
                          "overlay.recv.%s.bytes" % name))
            else:
                mt = (self.metrics.new_meter(
                          "overlay.send.%s.count" % name),
                      self.metrics.new_histogram(
                          "overlay.send.%s.bytes" % name))
            self._m_type[key] = mt
        return mt

    def _record_msg(self, direction: str, msg_type, nbytes: int,
                    peer_key: Optional[bytes]) -> None:
        name = msg_type_name(msg_type)
        meter, hist = self._type_metrics(direction, name)
        meter.mark()
        hist.update(nbytes)
        bkey = direction + "_bytes"
        mkey = direction + "_msgs"
        with self._lock:
            self.totals[bkey] += nbytes
            self.totals[mkey] += 1
            t = self.by_type.setdefault(name, _new_dir_totals())
            t[bkey] += nbytes
            t[mkey] += 1
            if peer_key is not None:
                pid = peer_key.hex()[:16]
                p = self.peers.get(pid)
                if p is None:
                    if len(self.peers) >= self.MAX_PEERS:
                        return   # bounded: new peers beyond the cap are
                        # not individually attributed (totals still count)
                    p = self.peers[pid] = _new_dir_totals()
                p[bkey] += nbytes
                p[mkey] += 1

    def record_recv(self, msg_type, nbytes: int,
                    peer_key: Optional[bytes] = None) -> None:
        """One inbound frame of `msg_type` (None = unparseable)."""
        self._record_msg("recv", msg_type, nbytes, peer_key)

    def record_send(self, msg_type, nbytes: int,
                    peer_key: Optional[bytes] = None) -> None:
        self._record_msg("send", msg_type, nbytes, peer_key)

    def record_duplicate_frame(self, msg_type, flooded: bool) -> None:
        """A transport-level duplicate frame detected at the MAC layer
        (ChaosTransport `overlay.duplicate` injection, or a genuinely
        duplicating network). Flooded types additionally count into the
        flood duplication ratio — injected duplicates must show up in
        the same waste number operators watch."""
        self._m_dupframe.mark()
        if flooded:
            self._m_fdup.mark()
            with self._lock:
                self.flood["duplicates"] += 1

    # -- flood dedup accounting (Floodgate hooks) ----------------------------
    def record_flood(self, unique: bool) -> None:
        """One flooded message through Floodgate.add_record: unique
        (first sight) or a duplicate receipt from another peer."""
        if unique:
            self._m_funique.mark()
        else:
            self._m_fdup.mark()
        with self._lock:
            self.flood["unique" if unique else "duplicates"] += 1

    def record_broadcast(self, fanout: int) -> None:
        """One Floodgate.broadcast: `fanout` peers actually sent to."""
        self._h_fanout.update(fanout)
        with self._lock:
            self.flood["broadcasts"] += 1
            self.flood["fanout_total"] += fanout

    def _duplication_ratio_locked(self) -> float:
        u = self.flood["unique"]
        return self.flood["duplicates"] / u if u else 0.0

    # -- envelope pipeline (Herder hook) -------------------------------------
    def record_envelope(self, verify_s: float, process_s: float,
                        backend: str, ok: bool) -> None:
        """One SCP envelope through the intake pipeline: receive →
        signature-verify (`verify_s`, app-clock) → herder process
        (`process_s`), attributed to the verify backend that served the
        stack (bounded backend name space)."""
        self._t_verify.update(verify_s)
        self._t_process.update(process_s)
        if not ok:
            self._m_erejected.mark()
        t = self._t_backend.get(backend)
        if t is None:
            t = self.metrics.new_timer(
                "overlay.envelope.verify-latency.%s" % backend)
            self._t_backend[backend] = t
        t.update(verify_s)
        with self._lock:
            e = self.envelope
            e["count"] += 1
            e["rejected"] += int(not ok)
            e["verify_seconds"] += verify_s
            e["process_seconds"] += process_s
            b = e["by_backend"].setdefault(
                backend, {"count": 0, "verify_seconds": 0.0})
            b["count"] += 1
            b["verify_seconds"] += verify_s
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant(
                "overlay.envelope.pipeline", cat="overlay",
                backend=backend, ok=ok,
                verify_s=round(verify_s, 6),
                process_s=round(process_s, 6))

    # -- send-queue pressure (overlay tick hook) -----------------------------
    def set_queue_depth(self, total_bytes: int, backlogged: int) -> None:
        self._g_queue.set(total_bytes)
        self._g_queue_peers.set(backlogged)
        with self._lock:
            self.queue["bytes"] = total_bytes
            self.queue["backlogged"] = backlogged

    # -- per-slot bandwidth (ledger_closed hook) -----------------------------
    def slot_closed(self, ledger_seq: int) -> None:
        """Attribute the bytes moved since the previous close to this
        slot — the per-slot fleet bandwidth series the FleetAggregator
        sums across nodes (bounded ring of SLOT_WINDOW slots)."""
        with self._lock:
            delta = {k: self.totals[k] - self._slot_base[k]
                     for k in self.totals}
            self._slot_base = dict(self.totals)
            self.per_slot[ledger_seq] = delta
            while len(self.per_slot) > self.SLOT_WINDOW:
                del self.per_slot[min(self.per_slot)]

    # -- exports -------------------------------------------------------------
    def _top_peers_locked(self) -> list:
        ranked = sorted(
            self.peers.items(),
            key=lambda kv: -(kv[1]["recv_bytes"] + kv[1]["send_bytes"]))
        return [{"peer": pid, **dict(t)} for pid, t in ranked[:self.TOP_K]]

    def to_json(self) -> dict:
        """The admin `overlaystats` cockpit blob (overlay half)."""
        verify = self._t_verify.snapshot()
        process = self._t_process.snapshot()
        with self._lock:
            return {
                "totals": dict(self.totals),
                "by_type": {n: dict(t)
                            for n, t in sorted(self.by_type.items())},
                "peers": {"tracked": len(self.peers),
                          "top": self._top_peers_locked()},
                "flood": {
                    "unique": self.flood["unique"],
                    "duplicates": self.flood["duplicates"],
                    "duplication_ratio": round(
                        self._duplication_ratio_locked(), 4),
                    "broadcasts": self.flood["broadcasts"],
                    "fanout_total": self.flood["fanout_total"],
                },
                "envelope": {
                    **{k: (round(v, 6) if isinstance(v, float) else v)
                       for k, v in self.envelope.items()
                       if k != "by_backend"},
                    "by_backend": {
                        n: {"count": b["count"],
                            "verify_seconds":
                                round(b["verify_seconds"], 6)}
                        for n, b in sorted(
                            self.envelope["by_backend"].items())},
                    "verify_p95_ms": round(verify["p95"] * 1e3, 3),
                    "process_p95_ms": round(process["p95"] * 1e3, 3),
                },
                "send_queue": dict(self.queue),
                "per_slot": {str(s): dict(d) for s, d in
                             sorted(self.per_slot.items())},
            }

    def fleet_json(self) -> dict:
        """Compact per-node export for the FleetAggregator (one shape
        for in-process `add_app` and HTTP `add_http` intake)."""
        with self._lock:
            return {
                "totals": dict(self.totals),
                "flood": {"unique": self.flood["unique"],
                          "duplicates": self.flood["duplicates"]},
                "per_slot": {str(s): dict(d) for s, d in
                             sorted(self.per_slot.items())},
            }
