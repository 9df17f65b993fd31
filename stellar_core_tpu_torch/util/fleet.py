"""Fleet aggregation: N nodes' traces + slot timelines on one axis.

Copied from `stellar_core_tpu/util/fleet.py` at commit a6220d9; carry a fix
in either copy to the other. Nothing is left out. `add_http` reads a live
node's admin endpoints (`main/command_handler.py`), `add_app` a node in
the same process; a node's footprint census (`util/footprint.py`, which
`main/application.py` registers) rides along in both.

Role parity: none in the reference — operators eyeball N dashboards.
The committee-consensus measurement literature (arXiv:2302.00418, DSig
arXiv:2406.07215 in PAPERS.md) attributes commit latency fleet-wide:
propagation and stragglers dominate, per-node compute doesn't. This
module merges every node's span ring (util/tracing.py) and slot
timeline (util/slot_timeline.py) into

- one Chrome-trace JSON with one *process lane per node* (metadata
  `process_name` events), timeline events injected as instants — drop
  the file in chrome://tracing / Perfetto and read a slot across the
  quorum;
- per-slot fleet stats: externalize skew across nodes, flood latency
  from first sender to last receiver, straggler attribution, and
  slot-latency percentiles — what `bench.py --fleet` records as the
  `fleet` block.

Alignment: timeline events carry two stamps (util/slot_timeline.py) —
`t` (per-node app clock) and `pc` (`time.perf_counter()`). In-process
simulations share one perf_counter, so `pc` IS the fleet clock there.
Against live HTTP nodes each host's perf_counter has its own epoch;
the aggregator then rebases each node so its first externalize of the
earliest common slot lands at the same instant (`align="externalize"`),
which preserves intra-node deltas and makes skew read as dispersion
around that anchor — exact cross-host clock sync is explicitly out of
scope (NTP is assumed for wall-clock interpretation).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .metrics import Histogram

SEEN_SUFFIX = ".seen"


def _percentile(values: List[float], q: float) -> float:
    # one quantile semantics repo-wide: reuse the histogram pick
    return Histogram._pick(sorted(values), q)


class FleetAggregator:
    """Collects per-node observability exports and merges them.

    Nodes are added either in-process (`add_app`, the simulation path)
    or from a live admin API (`add_http`). Every node entry holds the
    same shape: name, node_id (hex), chrome trace dict, timeline JSON,
    optional survey stats — so the merge/stat code has one input form.
    """

    def __init__(self) -> None:
        self.nodes: List[dict] = []

    # -- intake --------------------------------------------------------------
    def add_app(self, name: str, app) -> None:
        survey = None
        om = getattr(app, "overlay_manager", None)
        sm = getattr(om, "survey_manager", None)
        if sm is not None:
            survey = sm.get_stats()
        # wire cockpit: per-node overlay bandwidth + tx
        # lifecycle in the same compact shape `overlaystats` serves
        # under its "fleet" field, so add_http stores identical input
        ostats = getattr(om, "stats", None)
        lc = getattr(getattr(app, "herder", None), "tx_lifecycle", None)
        overlay = None
        if ostats is not None or lc is not None:
            overlay = {
                "overlay": ostats.fleet_json()
                if ostats is not None else None,
                "tx": lc.fleet_json() if lc is not None else None,
            }
        # propagation cockpit: per-node causal hop records,
        # merged by msg_hash into relay trees below
        prop = getattr(om, "prop_stats", None)
        # consensus cockpit + footprint census: per-node
        # envelopes/rounds/phases and the bounded-structure census,
        # merged into the scp_summary / footprint_table blocks below
        ss = getattr(getattr(app, "herder", None), "scp_stats", None)
        fp = getattr(app, "footprint", None)
        self.nodes.append({
            "name": name,
            "node_id": app.config.node_id().key_bytes.hex(),
            "trace": app.tracer.to_chrome_trace(),
            "timeline": app.slot_timeline.to_json(),
            "survey": survey,
            "overlay": overlay,
            "propagation": prop.fleet_json() if prop is not None else None,
            "scp": ss.fleet_json() if ss is not None else None,
            "footprint": fp.fleet_json() if fp is not None else None,
        })

    def add_http(self, base_url: str, name: Optional[str] = None,
                 timeout: float = 5.0) -> None:
        """Aggregate a live node via its admin API: `timeline`,
        `trace?action=dump`, and `getsurveyresult`."""
        from urllib.request import urlopen

        def get(path: str) -> Optional[dict]:
            try:
                with urlopen(base_url.rstrip("/") + path,
                             timeout=timeout) as r:
                    return json.loads(r.read().decode())
            except Exception:
                return None

        tl = get("/timeline")
        if tl is None:
            raise RuntimeError("node %s: timeline endpoint unreachable"
                               % base_url)
        # same compact shape as add_app's get_stats() — the endpoint
        # carries it under "stats" precisely so both intake paths store
        # one input form
        survey = (get("/getsurveyresult") or {}).get("stats")
        self.nodes.append({
            "name": name or tl.get("node") or base_url,
            "node_id": tl.get("node_id"),
            "trace": get("/trace") or {"traceEvents": []},
            "timeline": tl,
            "survey": survey,
            # same compact shape as add_app stores (the endpoint carries
            # it under "fleet" precisely for this intake path)
            "overlay": (get("/overlaystats") or {}).get("fleet"),
            "propagation": (get("/propagation") or {}).get("fleet"),
            "scp": (get("/scpstats") or {}).get("fleet"),
            "footprint": get("/footprint"),
        })

    # -- cross-host alignment ------------------------------------------------
    def rebase_on_externalize(self) -> bool:
        """Live-node alignment: pick the earliest slot every node
        externalized, and shift each node's `pc` stamps (timeline AND
        span ring) so those externalize events coincide. Intra-node
        deltas are preserved; cross-node skew for *other* slots then
        reads as dispersion around the anchor. Returns False (no-op)
        when the nodes share no externalized slot."""
        per_node_ext: List[Dict[int, float]] = []
        for node in self.nodes:
            exts: Dict[int, float] = {}
            tl = node.get("timeline") or {}
            for slot_str, evs in tl.get("slots", {}).items():
                for ev in evs:
                    if ev["event"] == "externalize":
                        exts.setdefault(int(slot_str), ev["pc"])
            per_node_ext.append(exts)
        if not per_node_ext:
            return False
        common = set(per_node_ext[0])
        for exts in per_node_ext[1:]:
            common &= set(exts)
        if not common:
            return False
        anchor = min(common)
        anchors = [exts[anchor] for exts in per_node_ext]
        base = min(anchors)
        for node, at in zip(self.nodes, anchors):
            off = at - base
            if off == 0.0:
                continue
            tl = node.get("timeline") or {}
            for evs in tl.get("slots", {}).values():
                for ev in evs:
                    ev["pc"] -= off
            trace = node.get("trace") or {}
            for ev in trace.get("traceEvents", ()):
                if "ts" in ev:
                    ev["ts"] -= off * 1e6
            # propagation hop stamps ride the same per-node epoch
            prop = node.get("propagation") or {}
            for rec in (prop.get("hashes") or {}).values():
                for hop in rec.get("hops", ()):
                    hop["pc"] -= off
        return True

    # -- name resolution -----------------------------------------------------
    def _id_to_name(self) -> Dict[str, str]:
        return {n["node_id"]: n["name"] for n in self.nodes
                if n.get("node_id")}

    def resolve(self, node_id_hex: Optional[str]) -> str:
        if node_id_hex is None:
            return "?"
        return self._id_to_name().get(node_id_hex, node_id_hex[:8])

    # -- merged Chrome trace -------------------------------------------------
    def merged_chrome_trace(self) -> dict:
        """One process lane per node: every node's span-ring events get
        that node's pid, plus its timeline events injected as instant
        events (`timeline.<event>`, cat `slot`) so the consensus journal
        and the span view line up on one axis."""
        events: List[dict] = []
        dropped = 0
        id2name = self._id_to_name()
        for i, node in enumerate(self.nodes):
            events.append({"name": "process_name", "ph": "M", "pid": i,
                           "tid": 0, "args": {"name": node["name"]}})
            events.append({"name": "process_sort_index", "ph": "M",
                           "pid": i, "tid": 0, "args": {"sort_index": i}})
            trace = node.get("trace") or {}
            dropped += trace.get("dropped_spans", 0)
            for ev in trace.get("traceEvents", ()):
                ev = dict(ev)
                ev["pid"] = i
                events.append(ev)
            tl = node.get("timeline") or {}
            for slot_str, evs in sorted(tl.get("slots", {}).items(),
                                        key=lambda kv: int(kv[0])):
                for ev in evs:
                    args = {k: v for k, v in ev.items()
                            if k not in ("event", "pc")}
                    args["slot"] = int(slot_str)
                    if "node" in args:
                        args["node"] = id2name.get(
                            args["node"], (args["node"] or "?")[:8])
                    events.append({
                        "name": "timeline.%s" % ev["event"],
                        "cat": "slot", "ph": "i", "s": "t",
                        "ts": round(ev["pc"] * 1e6, 1),
                        "pid": i, "tid": 0, "args": args})
        # propagation flow events: every reconstructed
        # first-delivery edge becomes a Chrome flow arrow from the
        # sender's lane to the receiver's — one envelope's fan-out reads
        # as connected arrows across node lanes in Perfetto
        pid_of = {node["name"]: i for i, node in enumerate(self.nodes)}
        flow_id = 1
        for hh, tree in sorted(self.propagation_trees().items()):
            for e in tree["first_edges"]:
                if e["latency_s"] is None:
                    continue
                fp, tp = pid_of.get(e["from"]), pid_of.get(e["to"])
                if fp is None or tp is None:
                    continue
                args = {"hash": hh[:16], "slot": tree["ledger_seq"],
                        "from": e["from"], "to": e["to"]}
                name = "prop.%s" % tree["type"]
                events.append({
                    "name": name, "cat": "prop", "ph": "s", "id": flow_id,
                    "pid": fp, "tid": 0, "args": args,
                    "ts": round((e["pc"] - e["latency_s"]) * 1e6, 1)})
                events.append({
                    "name": name, "cat": "prop", "ph": "f", "bp": "e",
                    "id": flow_id, "pid": tp, "tid": 0, "args": args,
                    "ts": round(e["pc"] * 1e6, 1)})
                flow_id += 1
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "dropped_spans": dropped,
                "nodes": [n["name"] for n in self.nodes]}

    # -- per-slot fleet stats ------------------------------------------------
    def _slot_events(self) -> Dict[int, Dict[str, List[dict]]]:
        """slot -> node name -> that node's journal for the slot."""
        out: Dict[int, Dict[str, List[dict]]] = {}
        for node in self.nodes:
            tl = node.get("timeline") or {}
            for slot_str, evs in tl.get("slots", {}).items():
                out.setdefault(int(slot_str), {})[node["name"]] = list(evs)
        return out

    def fleet_stats(self) -> dict:
        """Per-slot cross-node stats + fleet summary percentiles.

        Per slot:
        - `externalize`: skew (max-min externalize `pc` across nodes),
          first/last node, straggler = last node with its lag;
        - `flood`: the earliest envelope-seen event names the first
          *sender* (flood origin); latency runs from that first arrival
          to the last arrival anywhere in the fleet;
        - `slot_latency_s`: first timeline activity anywhere -> last
          externalize anywhere — the whole-quorum slot cost.
        """
        by_slot = self._slot_events()
        id2name = self._id_to_name()
        slots: Dict[str, dict] = {}
        latencies: List[float] = []
        skews: List[float] = []
        stragglers: Dict[str, int] = {}
        for slot in sorted(by_slot):
            per_node = by_slot[slot]
            entry: dict = {}
            ext = {}
            first_pc = None
            for name, evs in per_node.items():
                for ev in evs:
                    pc = ev["pc"]
                    if first_pc is None or pc < first_pc:
                        first_pc = pc
                    if ev["event"] == "externalize" and name not in ext:
                        ext[name] = ev
            if ext:
                ordered = sorted(ext.items(), key=lambda kv: kv[1]["pc"])
                lo, hi = ordered[0], ordered[-1]
                skew = hi[1]["pc"] - lo[1]["pc"]
                entry["externalize"] = {
                    "nodes": len(ext), "skew_s": round(skew, 6),
                    "first": lo[0], "last": hi[0],
                    "straggler": hi[0], "lag_s": round(skew, 6),
                }
                full = len(ext) == len(self.nodes)
                if full and len(self.nodes) > 1:
                    skews.append(skew)
                    stragglers[hi[0]] = stragglers.get(hi[0], 0) + 1
                if first_pc is not None:
                    lat = hi[1]["pc"] - first_pc
                    entry["slot_latency_s"] = round(lat, 6)
                    # summary percentiles only over fully-observed slots:
                    # a slot some node's ring already evicted would feed
                    # a truncated latency and bias p50/p95 downward
                    if full:
                        latencies.append(lat)
            seen = []
            for name, evs in per_node.items():
                for ev in evs:
                    if ev["event"].endswith(SEEN_SUFFIX):
                        seen.append((ev["pc"], name, ev))
            if seen:
                seen.sort(key=lambda t: t[0])
                first = seen[0]
                last = seen[-1]
                entry["flood"] = {
                    "first_sender": id2name.get(
                        first[2].get("node"),
                        (first[2].get("node") or "?")[:8]),
                    "first_seen_by": first[1],
                    "last_seen_by": last[1],
                    "latency_s": round(last[0] - first[0], 6),
                    "arrivals": len(seen),
                }
            if entry:
                slots[str(slot)] = entry
        # per-slot fleet bandwidth: sum each node's per-slot byte deltas
        # (what a 50-100-node envelope-cost study reads per slot)
        for node in self.nodes:
            ov = (node.get("overlay") or {}).get("overlay") or {}
            for slot_str, delta in (ov.get("per_slot") or {}).items():
                entry = slots.get(slot_str)
                if entry is None:
                    continue
                bw = entry.setdefault(
                    "bandwidth", {"recv_bytes": 0, "send_bytes": 0,
                                  "recv_msgs": 0, "send_msgs": 0})
                for k in bw:
                    bw[k] += delta.get(k, 0)
        # per-slot propagation percentiles: hop records stamp
        # the LCL at receipt, so messages flooding slot N carry seq N-1
        prop = self.propagation_summary()
        if prop is not None:
            by_ledger: Dict[int, List[dict]] = {}
            for tree in self.propagation_trees().values():
                by_ledger.setdefault(
                    int(tree["ledger_seq"]), []).append(tree)
            for seq, ts_list in by_ledger.items():
                entry = slots.get(str(seq + 1))
                if entry is None:
                    continue
                lat = [e["latency_s"] for t in ts_list
                       for e in t["first_edges"]
                       if e["latency_s"] is not None]
                b = sum(t["bytes"] for t in ts_list)
                w = sum(t["wasted_bytes"] for t in ts_list)
                entry["propagation"] = {
                    "trees": len(ts_list),
                    "hop_latency_p50_ms": round(
                        _percentile(lat, 0.50) * 1e3, 3),
                    "hop_latency_p95_ms": round(
                        _percentile(lat, 0.95) * 1e3, 3),
                    "depth_max": max(t["depth"] for t in ts_list),
                    "redundant_share": round(w / b, 4) if b else 0.0,
                }
        out = {
            "nodes": [n["name"] for n in self.nodes],
            "slots": slots,
            "summary": {
                "slot_count": len(slots),
                "slot_latency_p50_s": round(
                    _percentile(latencies, 0.50), 6),
                "slot_latency_p95_s": round(
                    _percentile(latencies, 0.95), 6),
                "externalize_skew_p50_s": round(
                    _percentile(skews, 0.50), 6),
                "externalize_skew_p95_s": round(
                    _percentile(skews, 0.95), 6),
                "externalize_skew_max_s": round(
                    max(skews), 6) if skews else 0.0,
                "stragglers": stragglers,
            },
        }
        surveys = {n["name"]: n["survey"] for n in self.nodes
                   if n.get("survey")}
        if surveys:
            out["survey"] = surveys
        ob = self.overlay_breakdown()
        if ob is not None:
            out["summary"]["recv_bytes_total"] = ob["recv_bytes"]
            out["summary"]["send_bytes_total"] = ob["send_bytes"]
            out["summary"]["flood_duplication_ratio"] = \
                ob["flood"]["duplication_ratio"]
            out["summary"]["tx_latency_p50_ms"] = ob["tx_latency_ms"]["p50"]
            out["summary"]["tx_latency_p95_ms"] = ob["tx_latency_ms"]["p95"]
        if prop is not None:
            out["propagation"] = prop
            out["summary"]["hop_latency_p95_ms"] = \
                prop["hop_latency_p95_ms"]
            out["summary"]["redundant_bandwidth_share"] = \
                prop["redundant_bandwidth_share"]
        scp = self.scp_summary()
        if scp is not None:
            out["scp"] = scp
            out["summary"]["envelopes_per_slot"] = \
                scp["envelopes_per_slot"]
        fpt = self.footprint_table()
        if fpt is not None:
            out["footprint"] = fpt
            out["summary"]["per_node_rss_mb"] = fpt["per_node_rss_mb"]
        return out

    # -- consensus cockpit merge ----------------------------------
    def scp_summary(self) -> Optional[dict]:
        """Fleet-wide `scp` block for bench/scenario artifacts: the
        committed envelopes-per-slot baseline (fleet-wide receive count
        per externalized slot, averaged over slots every scp-reporting
        node observed — ROADMAP item 1's BLS quorum certificates must
        beat this number), the per-statement-type split, per-slot
        wall/phase latencies (the slowest node's, the fleet's real slot
        cost), and worst round counts. None when no node exported
        consensus-cockpit data."""
        reporting = [n for n in self.nodes if n.get("scp")]
        if not reporting:
            return None
        per_type: Dict[str, int] = {}
        sent_total = recv_total = 0
        slots: Dict[str, dict] = {}
        worst_rounds = {"nomination": 0, "ballot": 0}
        # slot -> [per-node slot records]; only slots EVERY reporting
        # node retains feed the envelopes-per-slot mean (a slot some
        # ring already pruned would undercount the fleet flood)
        by_slot: Dict[int, List[dict]] = {}
        for node in reporting:
            scp = node["scp"]
            t = scp.get("totals") or {}
            sent_total += t.get("sent", 0)
            recv_total += t.get("recv", 0)
            for slot_str, rec in (scp.get("slots") or {}).items():
                by_slot.setdefault(int(slot_str), []).append(rec)
                for k, v in (rec.get("recv") or {}).items():
                    per_type[k] = per_type.get(k, 0) + v
                r = rec.get("rounds") or {}
                for k in worst_rounds:
                    worst_rounds[k] = max(worst_rounds[k], r.get(k, 0))
        env_counts: List[float] = []
        for slot in sorted(by_slot):
            recs = by_slot[slot]
            ext = [r for r in recs if r.get("externalized")]
            if not ext:
                continue
            envelopes = sum(sum((r.get("recv") or {}).values())
                            for r in recs)
            walls = [r["phases"]["wall_s"] for r in recs
                     if r.get("phases") and
                     r["phases"].get("wall_s") is not None]
            entry = {"envelopes": envelopes,
                     "wall_s": round(max(walls), 6) if walls else None,
                     "nodes": len(recs)}
            phases: Dict[str, float] = {}
            for r in recs:
                for p, v in ((r.get("phases") or {}).get("phase_s")
                             or {}).items():
                    if v is not None:
                        phases[p] = max(phases.get(p, 0.0), v)
            if phases:
                entry["phase_s"] = {p: round(v, 6)
                                    for p, v in sorted(phases.items())}
            slots[str(slot)] = entry
            if len(recs) == len(reporting):
                env_counts.append(float(envelopes))
        return {
            "nodes": len(reporting),
            "envelopes_per_slot": round(
                sum(env_counts) / len(env_counts), 3) if env_counts
            else 0.0,
            "per_type": dict(sorted(per_type.items())),
            "sent_total": sent_total,
            "recv_total": recv_total,
            "rounds": worst_rounds,
            "slots": slots,
        }

    # -- footprint census merge -----------------------------------
    def footprint_table(self) -> Optional[dict]:
        """Per-node overhead table + the N-vs-RSS scaling signal for
        `bench.py --fleet-scale`: each node's process stats and every
        registered bounded structure's occupancy/capacity, plus fleet
        totals (`per_node_rss_mb` is the mean — in-process simulations
        share one process, so the sim driver overrides it with the
        measured RSS delta / N; against live HTTP nodes the per-node
        readings are real). None when no node exported a census."""
        reporting = [n for n in self.nodes if n.get("footprint")]
        if not reporting:
            return None
        per_node: Dict[str, dict] = {}
        rss = []
        over: Dict[str, list] = {}
        bytes_total = 0
        for node in reporting:
            fp = node["footprint"]
            proc = fp.get("process") or {}
            rss.append(proc.get("rss_mb", 0.0))
            bytes_total += fp.get("approx_bytes_total", 0)
            if fp.get("over_capacity"):
                over[node["name"]] = list(fp["over_capacity"])
            per_node[node["name"]] = {
                "process": proc,
                "approx_bytes_total": fp.get("approx_bytes_total", 0),
                "structs": {
                    name: {k: v for k, v in entry.items()
                           if k in ("kind", "occupancy", "capacity",
                                    "approx_bytes", "error")}
                    for name, entry in (fp.get("structs") or {}).items()},
            }
        return {
            "nodes": len(reporting),
            "per_node_rss_mb": round(sum(rss) / len(rss), 3),
            "rss_mb_max": round(max(rss), 3) if rss else 0.0,
            "approx_bytes_total": bytes_total,
            "over_capacity": over,
            "per_node": per_node,
        }

    # -- propagation trees ----------------------------------------
    MIN_USEFULNESS_SAMPLES = 4

    def propagation_trees(self) -> Dict[str, dict]:
        """Merge every node's causal hop records by msg_hash into relay
        trees: the origin node (the broadcaster), the first-delivery
        spanning tree (each node's parent = the peer that delivered the
        message first), per-edge hop latency (child first-delivery `pc`
        minus the parent's own first-delivery/origin `pc` — rebase the
        fleet first against live hosts), and the redundant-edge overlay
        (every duplicate receipt, with its wasted bytes). Keys are hash
        hex; `spanning` is True when every receiving node is reachable
        from the origin over first edges."""
        id2name = self._id_to_name()
        merged: Dict[str, dict] = {}
        for node in self.nodes:
            prop = node.get("propagation")
            if not prop:
                continue
            for hh, rec in (prop.get("hashes") or {}).items():
                m = merged.setdefault(hh, {
                    "per_node": {}, "type": rec.get("type"),
                    "ledger_seq": rec.get("ledger_seq", 0)})
                m["per_node"][node["name"]] = rec
        trees: Dict[str, dict] = {}
        for hh, m in merged.items():
            origin = None
            origin_pc = None
            first_pc: Dict[str, float] = {}
            first_parent: Dict[str, str] = {}
            red_edges: List[dict] = []
            firsts = dupes = 0
            bytes_total = wasted = 0
            for name, rec in m["per_node"].items():
                if rec.get("origin"):
                    origin = name
                for hop in rec.get("hops", ()):
                    d = hop.get("dir")
                    if d == "origin":
                        origin_pc = hop["pc"]
                    elif d == "recv":
                        src = id2name.get(hop.get("peer"),
                                          (hop.get("peer") or "?")[:8])
                        bytes_total += hop.get("bytes", 0)
                        if hop.get("first"):
                            firsts += 1
                            if name not in first_pc or \
                                    hop["pc"] < first_pc[name]:
                                first_pc[name] = hop["pc"]
                                first_parent[name] = src
                        else:
                            dupes += 1
                            wasted += hop.get("bytes", 0)
                            red_edges.append({
                                "from": src, "to": name,
                                "bytes": hop.get("bytes", 0)})
            first_edges = []
            for name in sorted(first_pc):
                parent = first_parent[name]
                ppc = origin_pc if parent == origin \
                    else first_pc.get(parent)
                first_edges.append({
                    "from": parent, "to": name,
                    "pc": first_pc[name],
                    "latency_s": (round(first_pc[name] - ppc, 9)
                                  if ppc is not None else None)})
            # BFS from the origin over first edges: per-node depth; the
            # tree depth IS the root's eccentricity
            children: Dict[str, list] = {}
            for e in first_edges:
                children.setdefault(e["from"], []).append(e["to"])
            depths = {origin: 0} if origin is not None else {}
            frontier = [origin] if origin is not None else []
            while frontier:
                nxt = []
                for p in frontier:
                    for c in children.get(p, ()):
                        if c not in depths:
                            depths[c] = depths[p] + 1
                            nxt.append(c)
                frontier = nxt
            depth = max(depths.values()) if depths else 0
            trees[hh] = {
                "type": m["type"], "ledger_seq": m["ledger_seq"],
                "origin": origin,
                "nodes": len(m["per_node"]),
                "firsts": firsts, "duplicates": dupes,
                "bytes": bytes_total, "wasted_bytes": wasted,
                "first_edges": first_edges,
                "redundant_edges": red_edges,
                "depth": depth,
                "spanning": origin is not None and
                len(depths) == len(first_pc) + 1,
            }
        return trees

    def propagation_summary(self) -> Optional[dict]:
        """Fleet-wide `propagation` block for bench/scenario artifacts
        (normalized by tools/bench_compare.py): hop-latency and
        tree-depth percentiles over the reconstructed trees, the
        redundant bandwidth share (wasted bytes / all flooded bytes —
        must reconcile with the flood duplication ratio), and the
        merged per-peer usefulness ranking whose bottom entries are the
        structured relay's first candidates to stop listening to. None
        when no node exported propagation data."""
        trees = self.propagation_trees()
        peers: Dict[str, dict] = {}
        flood_bytes = wasted_total = 0
        firsts_total = dupes_total = 0
        any_data = False
        for node in self.nodes:
            prop = node.get("propagation")
            if not prop:
                continue
            any_data = True
            t = prop.get("totals") or {}
            flood_bytes += t.get("flood_bytes", 0)
            wasted_total += t.get("wasted_bytes", 0)
            firsts_total += t.get("firsts", 0)
            dupes_total += t.get("duplicates", 0)
            for pid, s in (prop.get("peers") or {}).items():
                p = peers.setdefault(pid, {"firsts": 0, "duplicates": 0,
                                           "wasted_bytes": 0})
                for k in p:
                    p[k] += s.get(k, 0)
        if not any_data:
            return None
        id2name = self._id_to_name()
        ranked = []
        for pid, s in peers.items():
            n = s["firsts"] + s["duplicates"]
            ranked.append({
                "peer": id2name.get(pid, pid[:8]),
                "firsts": s["firsts"], "duplicates": s["duplicates"],
                "wasted_bytes": s["wasted_bytes"], "deliveries": n,
                "usefulness": round(s["firsts"] / n, 4) if n else 1.0})
        ranked.sort(key=lambda e: (-e["usefulness"], e["peer"]))
        scored = [e["usefulness"] for e in ranked
                  if e["deliveries"] >= self.MIN_USEFULNESS_SAMPLES]
        lat = [e["latency_s"] for t in trees.values()
               for e in t["first_edges"] if e["latency_s"] is not None]
        depths = [float(t["depth"]) for t in trees.values()
                  if t["origin"] is not None]
        return {
            "trees": len(trees),
            "hop_latency_p50_ms": round(_percentile(lat, 0.50) * 1e3, 3),
            "hop_latency_p95_ms": round(_percentile(lat, 0.95) * 1e3, 3),
            "tree_depth_p95": round(_percentile(depths, 0.95), 3),
            "firsts": firsts_total,
            "duplicates": dupes_total,
            "flood_bytes": flood_bytes,
            "wasted_bytes": wasted_total,
            "redundant_bandwidth_share": round(
                wasted_total / flood_bytes, 4) if flood_bytes else 0.0,
            "peers": {
                "worst_usefulness": (round(min(scored), 4)
                                     if scored else None),
                "bottom": ranked[-8:][::-1],
            },
        }

    # -- overlay breakdown ----------------------------------------
    def overlay_breakdown(self) -> Optional[dict]:
        """Fleet-wide `overlay_breakdown` block for bench/scenario
        artifacts (normalized by tools/bench_compare.py): summed
        bandwidth totals, flood dedup (duplication ratio = duplicate
        receipts / unique flooded messages — the O(n²) waste), and the
        tx-lifecycle latency whose stage seconds sum to total_seconds
        by construction. Tx percentiles are computed over the MERGED
        per-node total-latency reservoirs, not merged per-node
        percentiles. None when no node exported overlay data."""
        totals = {"recv_bytes": 0, "send_bytes": 0,
                  "recv_msgs": 0, "send_msgs": 0}
        unique = dupes = 0
        stage: Dict[str, float] = {}
        total_s = 0.0
        count = 0
        samples: List[float] = []
        outcomes: Dict[str, int] = {}
        any_data = False
        for node in self.nodes:
            data = node.get("overlay")
            if not data:
                continue
            ov = data.get("overlay")
            if ov:
                any_data = True
                for k in totals:
                    totals[k] += (ov.get("totals") or {}).get(k, 0)
                fl = ov.get("flood") or {}
                unique += fl.get("unique", 0)
                dupes += fl.get("duplicates", 0)
            tx = data.get("tx")
            if tx:
                any_data = True
                count += tx.get("count", 0)
                total_s += tx.get("total_seconds", 0.0)
                for s, v in (tx.get("stage_seconds") or {}).items():
                    stage[s] = stage.get(s, 0.0) + v
                samples.extend(tx.get("samples_ms") or ())
                for k, v in (tx.get("outcomes") or {}).items():
                    outcomes[k] = outcomes.get(k, 0) + v
        if not any_data:
            return None
        return {
            **totals,
            "flood": {
                "unique": unique, "duplicates": dupes,
                "duplication_ratio": round(
                    dupes / unique if unique else 0.0, 4),
            },
            "tx_latency_ms": {
                "count": count,
                "p50": round(_percentile(samples, 0.50), 3),
                "p95": round(_percentile(samples, 0.95), 3),
            },
            "stage_seconds": {s: round(v, 9)
                              for s, v in sorted(stage.items())},
            "total_seconds": round(total_s, 9),
            "outcomes": dict(sorted(outcomes.items())),
        }
