"""PropagationStats: the propagation cockpit's shared aggregation
(docs/observability.md#propagation-cockpit).

Copied from `stellar_core_tpu/overlay/propagation_stats.py` at commit
93d3a3a; carry a fix in either copy to the other. Nothing is left out. Its
`to_json` also serves the admin `propagation` endpoint
(`main/command_handler.py`).

The sixth cockpit. Where OverlayStats answers "how many bytes moved",
this one answers "which edges moved them, and which were wasted": every
flooded message (SCP envelopes, tx broadcasts) is stamped into a causal
hop record as it crosses the node —

- a **recv hop** when a peer delivers it (OverlayManager.recv_flooded_msg
  and the Peer MAC-layer duplicate branch), classified *first delivery*
  (useful — the edge that actually propagated the message) or
  *redundant edge* (wasted bytes, attributed to the sending peer);
- a **send hop** per peer the Floodgate relays it to;
- an **origin** marker when this node is the broadcaster (Herder
  externalize / tx submission), the root the fleet-level relay-tree
  reconstruction hangs everything off.

Each hop carries `(from_peer, t, pc, first, bytes)` where `t` is the
injected app clock (virtual in tests — sctlint D1 holds) and `pc` the
shared `real_perf_counter` stamp routed through util/timer.py (the ONE
sanctioned escape hatch): in-process simulations share one perf_counter,
so cross-node hop latencies are directly comparable, and real fleets are
rebased on the externalize epochs by FleetAggregator exactly like the
slot-timeline stamps.

Consumers:

- admin `propagation` endpoint (`to_json`, `?hash=H` hop trace,
  `?peer=P` detail, `?action=reset`);
- the metrics registry (`overlay.prop.*` names → `sct_overlay_prop_*`
  in the Prometheus exposition);
- the fleet view: `fleet_json()` is what FleetAggregator merges by
  msg_hash into propagation trees (origin, first-delivery spanning
  tree, per-edge hop latency, redundant-edge overlay) and the
  `propagation` bench block;
- per-peer usefulness `firsts / (firsts + duplicates)` — the ranking
  the planned structured-relay "have"-filter will aim advert targets
  with (ROADMAP item 1).

Bounded: at most MAX_HASHES per-hash records (LRU), MAX_HOPS_PER_HASH
hops each, MAX_PEERS attributed peers; `slot_closed` prunes records
below the current checkpoint's first slot (history/checkpoints.py), so
a long-running node's rings never outgrow one checkpoint window.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

from ..history.checkpoints import checkpoint_containing, first_in_checkpoint
from ..util.metrics import MetricsRegistry
from ..util.threads import TrackedLock
from ..util.timer import real_monotonic, real_perf_counter
from .overlay_stats import msg_type_name


def _new_peer_score() -> dict:
    return {"firsts": 0, "duplicates": 0, "wasted_bytes": 0}


class PropagationStats:
    """Propagation-cockpit aggregation; see module docstring."""

    MAX_HASHES = 4096         # per-hash records retained (LRU)
    MAX_HOPS_PER_HASH = 256   # hop ring per record
    MAX_PEERS = 256           # per-peer usefulness entries retained
    TOP_K = 8                 # peers shown per ranking in the admin blob
    MIN_SAMPLES = 4           # deliveries before a peer is rankable

    def __init__(self, metrics=None, tracer=None, now_fn=None,
                 self_id: Optional[str] = None) -> None:
        self._now = now_fn or real_monotonic
        # a private registry when none is injected keeps direct
        # constructions (tests, harnesses) app-registry-free while
        # letting every registration below use the new_* idiom the M1
        # metric-catalog scanner keys on
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(now_fn=self._now)
        self.tracer = tracer
        self.self_id = self_id or ""
        self._lock = TrackedLock("overlay.propagation-stats")
        m = self.metrics
        # edge classes are the two-value bounded name space the
        # test_metrics_catalog drift guard covers as a dynamic prefix
        self._m_edge = {
            "first": m.new_meter("overlay.prop.edge.%s" % "first"),
            "duplicate": m.new_meter("overlay.prop.edge.%s" % "duplicate"),
        }
        self._c_wasted = m.new_counter("overlay.prop.wasted-bytes")
        self._m_pruned = m.new_meter("overlay.prop.pruned")
        self._g_hashes = m.new_gauge("overlay.prop.hashes")
        self._g_worst = m.new_gauge("overlay.prop.usefulness.worst")
        self.reset()

    # -- lifecycle -----------------------------------------------------------
    def reset(self) -> None:
        """Zero the aggregates (admin `propagation?action=reset`;
        registry metrics keep their monotonic histories)."""
        with self._lock:
            # msg_hash -> {"ledger_seq", "type", "origin", "firsts",
            #              "duplicates", "bytes", "hops": [hop...]}
            self._hashes: "OrderedDict[bytes, dict]" = OrderedDict()
            self.peers: Dict[str, dict] = {}
            self.totals = {"firsts": 0, "duplicates": 0,
                           "wasted_bytes": 0, "flood_bytes": 0,
                           "pruned": 0, "dropped_hops": 0}

    # -- hop recording -------------------------------------------------------
    def _record_locked(self, msg_hash: bytes, msg_type,
                       ledger_seq: int) -> dict:
        rec = self._hashes.get(msg_hash)
        if rec is None:
            rec = self._hashes[msg_hash] = {
                "ledger_seq": ledger_seq,
                "type": msg_type_name(msg_type),
                "origin": False,
                "firsts": 0, "duplicates": 0, "bytes": 0,
                "hops": [],
            }
            while len(self._hashes) > self.MAX_HASHES:
                self._hashes.popitem(last=False)
        else:
            self._hashes.move_to_end(msg_hash)
        return rec

    def _append_hop_locked(self, rec: dict, hop: dict) -> None:
        if len(rec["hops"]) >= self.MAX_HOPS_PER_HASH:
            self.totals["dropped_hops"] += 1
            return
        rec["hops"].append(hop)

    def record_recv_hop(self, msg_hash: bytes, from_peer: str, nbytes: int,
                        msg_type, first: bool, ledger_seq: int) -> None:
        """One flooded message delivered by `from_peer` (node-id hex):
        `first=True` is the useful edge that actually propagated it,
        `first=False` a redundant edge whose bytes are wasted and
        attributed to the sender. Exactly one call per
        Floodgate.add_record receipt, so firsts/duplicates summed over
        hop records reconcile with the flood duplication ratio."""
        cls = "first" if first else "duplicate"
        self._m_edge[cls].mark()
        if not first:
            self._c_wasted.inc(nbytes)
        with self._lock:
            rec = self._record_locked(msg_hash, msg_type, ledger_seq)
            self._append_hop_locked(rec, {
                "dir": "recv", "peer": from_peer,
                "t": round(self._now(), 6), "pc": real_perf_counter(),
                "first": first, "bytes": nbytes,
            })
            rec["firsts" if first else "duplicates"] += 1
            rec["bytes"] += nbytes
            self.totals["firsts" if first else "duplicates"] += 1
            self.totals["flood_bytes"] += nbytes
            if not first:
                self.totals["wasted_bytes"] += nbytes
            p = self.peers.get(from_peer)
            if p is None:
                if len(self.peers) >= self.MAX_PEERS:
                    self._g_hashes.set(len(self._hashes))
                    return   # bounded: beyond the cap only totals count
                p = self.peers[from_peer] = _new_peer_score()
            p["firsts" if first else "duplicates"] += 1
            if not first:
                p["wasted_bytes"] += nbytes
            self._g_hashes.set(len(self._hashes))

    def record_send_hop(self, msg_hash: bytes, to_peer: str, nbytes: int,
                        msg_type, ledger_seq: int) -> None:
        """One relay of a flooded message to `to_peer`
        (Floodgate.broadcast fanout)."""
        with self._lock:
            rec = self._record_locked(msg_hash, msg_type, ledger_seq)
            self._append_hop_locked(rec, {
                "dir": "send", "peer": to_peer,
                "t": round(self._now(), 6), "pc": real_perf_counter(),
                "bytes": nbytes,
            })
            self._g_hashes.set(len(self._hashes))

    def record_origin(self, msg_hash: bytes, nbytes: int, msg_type,
                      ledger_seq: int) -> None:
        """This node is the broadcaster of `msg_hash` — the relay tree's
        root (Floodgate.broadcast creating a record with no receipt)."""
        with self._lock:
            rec = self._record_locked(msg_hash, msg_type, ledger_seq)
            rec["origin"] = True
            self._append_hop_locked(rec, {
                "dir": "origin", "peer": self.self_id,
                "t": round(self._now(), 6), "pc": real_perf_counter(),
                "bytes": nbytes,
            })
            self._g_hashes.set(len(self._hashes))

    # -- usefulness ----------------------------------------------------------
    @staticmethod
    def _usefulness(score: dict) -> float:
        n = score["firsts"] + score["duplicates"]
        return score["firsts"] / n if n else 1.0

    def _ranked_locked(self) -> list:
        out = []
        for pid, s in self.peers.items():
            n = s["firsts"] + s["duplicates"]
            out.append({"peer": pid, "firsts": s["firsts"],
                        "duplicates": s["duplicates"],
                        "wasted_bytes": s["wasted_bytes"],
                        "deliveries": n,
                        "usefulness": round(self._usefulness(s), 4)})
        out.sort(key=lambda e: (-e["usefulness"], e["peer"]))
        return out

    def _worst_usefulness_locked(self) -> Optional[float]:
        vals = [self._usefulness(s) for s in self.peers.values()
                if s["firsts"] + s["duplicates"] >= self.MIN_SAMPLES]
        return min(vals) if vals else None

    # -- pruning (ledger_closed hook) ----------------------------------------
    def slot_closed(self, ledger_seq: int) -> None:
        """Prune hop records from before the current checkpoint's first
        slot — the explicit memory bound the `overlay.prop.pruned`
        meter and `overlay.prop.hashes` gauge watch — and refresh the
        worst-peer usefulness gauge off the hot path."""
        cutoff = first_in_checkpoint(checkpoint_containing(ledger_seq))
        pruned = 0
        with self._lock:
            for h in [h for h, r in self._hashes.items()
                      if r["ledger_seq"] < cutoff]:
                del self._hashes[h]
                pruned += 1
            self.totals["pruned"] += pruned
            self._g_hashes.set(len(self._hashes))
            worst = self._worst_usefulness_locked()
        if pruned:
            self._m_pruned.mark(pruned)
        if worst is not None:
            self._g_worst.set(round(worst, 4))

    # -- exports -------------------------------------------------------------
    def _hash_json_locked(self, h: bytes, rec: dict) -> dict:
        return {
            "hash": h.hex(),
            "ledger_seq": rec["ledger_seq"],
            "type": rec["type"],
            "origin": rec["origin"],
            "firsts": rec["firsts"],
            "duplicates": rec["duplicates"],
            "bytes": rec["bytes"],
            "hops": [dict(hop) for hop in rec["hops"]],
        }

    def hash_trace(self, hash_hex: str) -> Optional[dict]:
        """The full hop trace for one message (admin
        `propagation?hash=H`; H may be a unique hex prefix)."""
        with self._lock:
            for h, rec in self._hashes.items():
                if h.hex().startswith(hash_hex.lower()):
                    return self._hash_json_locked(h, rec)
        return None

    def peer_detail(self, peer: str) -> Optional[dict]:
        """One peer's usefulness score (admin `propagation?peer=P`; P
        may be a unique hex prefix of the node id)."""
        with self._lock:
            for pid, s in self.peers.items():
                if pid.startswith(peer.lower()):
                    n = s["firsts"] + s["duplicates"]
                    return {"peer": pid, **dict(s), "deliveries": n,
                            "usefulness": round(self._usefulness(s), 4)}
        return None

    def to_json(self) -> dict:
        """The admin `propagation` cockpit blob."""
        with self._lock:
            ranked = self._ranked_locked()
            worst = self._worst_usefulness_locked()
            fb = self.totals["flood_bytes"]
            return {
                "totals": dict(self.totals),
                "redundant_bandwidth_share": round(
                    self.totals["wasted_bytes"] / fb, 4) if fb else 0.0,
                "hashes": {"tracked": len(self._hashes),
                           "cap": self.MAX_HASHES},
                "peers": {
                    "tracked": len(self.peers),
                    "worst_usefulness": (round(worst, 4)
                                         if worst is not None else None),
                    "top": ranked[:self.TOP_K],
                    "bottom": ranked[-self.TOP_K:][::-1],
                },
            }

    def fleet_json(self) -> dict:
        """Compact per-node export the FleetAggregator merges by
        msg_hash into relay trees (one shape for in-process `add_app`
        and HTTP `add_http` intake)."""
        with self._lock:
            return {
                "self": self.self_id,
                "totals": dict(self.totals),
                "peers": {pid: dict(s) for pid, s in self.peers.items()},
                "hashes": {h.hex(): self._hash_json_locked(h, rec)
                           for h, rec in self._hashes.items()},
            }
