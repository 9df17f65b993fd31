"""The bench-record helpers the scenario lab calls.

The port's own copy of the functions of `tools/bench_compare.py` (commit
a6220d9) that `testing/scenarios.py` uses: `make_record`,
`overlay_breakdown_records`, `propagation_records` and
`validate_propagation`, `ingress_records` and `validate_ingress`, with
their helper `_num`. Carry a fix in either copy to the other. The
reference's scenario lab loads `tools/bench_compare.py` by its path
(`stellar_core_tpu/testing/scenarios.py:136-153`); the port imports
nothing under `tools/`, which is the reference's tooling. The records
stay inside the scenario's returned block: the port writes no bench
history.
"""

from __future__ import annotations

import math
from typing import List, Optional


def make_record(metric: str, unit: str, value, platform: str,
                direction: str, source: str,
                round_no: Optional[int] = None,
                at_unix: Optional[int] = None,
                commit: Optional[str] = None) -> dict:
    return {"metric": metric, "unit": unit, "value": value,
            "platform": platform, "direction": direction,
            "source": source, "round": round_no,
            "at_unix": at_unix, "commit": commit}


def _num(p: dict, key: str):
    v = p.get(key)
    if isinstance(v, bool) or not isinstance(v, (int, float)) or \
            not math.isfinite(v):
        return None
    return v


def overlay_breakdown_records(ob: dict, platform: str, source: str,
                              round_no=None, at_unix=None) -> List[dict]:
    """Normalize an `overlay_breakdown` block (the wire
    cockpit's fleet aggregate) into direction-aware records — the flood
    duplication ratio (the O(n²) flood waste ROADMAP item 3 wants to
    shrink) and the end-to-end tx latency gate against
    bench/history.jsonl exactly like every other metric. Latency
    records are only emitted when the run actually applied tracked
    transactions: a 0-valued p95 from an idle run must never become the
    committed best baseline."""
    out: List[dict] = []
    if not isinstance(ob, dict):
        return out
    fl = ob.get("flood")
    if isinstance(fl, dict) and _num(fl, "unique") and \
            _num(fl, "duplication_ratio") is not None:
        out.append(make_record("flood_duplication_ratio", "x",
                               fl["duplication_ratio"], platform, "lower",
                               source, round_no, at_unix))
    tx = ob.get("tx_latency_ms")
    if isinstance(tx, dict) and _num(tx, "count"):
        for q in ("p50", "p95"):
            v = _num(tx, q)
            if v is not None:
                out.append(make_record(
                    "tx_latency_total_%s_ms" % q, "ms", v, platform,
                    "lower", source, round_no, at_unix))
    return out


def propagation_records(pb: dict, platform: str, source: str,
                        round_no=None, at_unix=None) -> List[dict]:
    """Normalize a `propagation` block (the propagation
    cockpit's fleet-merged relay trees) into direction-aware records:
    hop latency and tree depth percentiles over the reconstructed
    first-delivery spanning trees (lower), the redundant bandwidth
    share — the fraction of flooded bytes that arrived as duplicate
    edges, the O(n²) waste a structured relay would reclaim (lower) —
    and the worst per-peer usefulness score (higher; a peer that only
    ever sends duplicates is pure overhead)."""
    out: List[dict] = []
    if not isinstance(pb, dict) or not _num(pb, "trees"):
        return out
    for key, metric, unit in (
            ("hop_latency_p50_ms", "prop_hop_latency_p50_ms", "ms"),
            ("hop_latency_p95_ms", "prop_hop_latency_p95_ms", "ms"),
            ("tree_depth_p95", "prop_tree_depth_p95", "hops"),
            ("redundant_bandwidth_share",
             "prop_redundant_bandwidth_share", "share")):
        v = _num(pb, key)
        if v is not None:
            out.append(make_record(metric, unit, v, platform, "lower",
                                   source, round_no, at_unix))
    peers = pb.get("peers")
    if isinstance(peers, dict):
        v = _num(peers, "worst_usefulness")
        if v is not None:
            out.append(make_record("prop_worst_peer_usefulness", "share",
                                   v, platform, "higher", source,
                                   round_no, at_unix))
    return out


def validate_propagation(pb, where: str = "", flood=None) -> List[str]:
    """Schema check for one `propagation` block (`check`/`--check`):
    hop/byte totals must be finite and non-negative, the recorded
    redundant share must actually be wasted/flooded bytes, percentiles
    must be ordered — and when the sibling wire cockpit's `flood` block
    is available, duplicates/firsts over the merged hop records must
    reconcile with its duplication ratio within 10% relative tolerance
    (both cockpits count the same Floodgate.add_record receipts, so a
    drift between them means hop attribution lost edges)."""
    errs: List[str] = []
    if not isinstance(pb, dict):
        return ["%s: propagation is not an object: %r" % (where, pb)]
    trees = pb.get("trees")
    if not isinstance(trees, int) or isinstance(trees, bool) or trees < 0:
        errs.append("%s: propagation.trees must be an int >= 0, got %r"
                    % (where, trees))
    vals = {}
    for key in ("firsts", "duplicates", "flood_bytes", "wasted_bytes"):
        v = _num(pb, key)
        if v is None or v < 0:
            errs.append("%s: propagation.%s must be a finite number "
                        ">= 0, got %r" % (where, key, pb.get(key)))
        vals[key] = v
    share = _num(pb, "redundant_bandwidth_share")
    if share is None or share < 0 or share > 1:
        errs.append("%s: propagation.redundant_bandwidth_share must be "
                    "in [0, 1], got %r"
                    % (where, pb.get("redundant_bandwidth_share")))
    elif vals.get("flood_bytes"):
        want = vals["wasted_bytes"] / vals["flood_bytes"]
        if abs(share - want) > max(1e-3, 0.01 * want):
            errs.append("%s: propagation.redundant_bandwidth_share %.4f "
                        "!= wasted/flooded bytes %.4f" % (where, share,
                                                          want))
    p50 = _num(pb, "hop_latency_p50_ms")
    p95 = _num(pb, "hop_latency_p95_ms")
    if p50 is None or p95 is None or p50 < 0 or p95 + 1e-9 < p50:
        errs.append("%s: propagation needs finite "
                    "0 <= hop_latency_p50_ms <= hop_latency_p95_ms, "
                    "got p50=%r p95=%r" % (where,
                                           pb.get("hop_latency_p50_ms"),
                                           pb.get("hop_latency_p95_ms")))
    depth = _num(pb, "tree_depth_p95")
    if depth is None or depth < 0:
        errs.append("%s: propagation.tree_depth_p95 must be a finite "
                    "number >= 0, got %r"
                    % (where, pb.get("tree_depth_p95")))
    peers = pb.get("peers")
    if isinstance(peers, dict):
        wu = peers.get("worst_usefulness")
        if wu is not None and (_num(peers, "worst_usefulness") is None or
                               wu < 0 or wu > 1):
            errs.append("%s: propagation.peers.worst_usefulness must be "
                        "in [0, 1] or null, got %r" % (where, wu))
    # cross-cockpit reconciliation against the wire cockpit's dedup
    # accounting (an acceptance gate)
    if isinstance(flood, dict) and vals.get("firsts"):
        r = _num(flood, "duplication_ratio")
        if r is not None and r >= 0:
            derived = vals["duplicates"] / vals["firsts"]
            if abs(derived - r) > max(0.05, 0.10 * r):
                errs.append(
                    "%s: propagation duplicates/firsts %.4f does not "
                    "reconcile with flood duplication_ratio %.4f within "
                    "10%% — hop records and flood dedup have drifted "
                    "apart" % (where, derived, r))
    return errs


def ingress_records(ib: dict, platform: str, source: str,
                    round_no=None, at_unix=None) -> List[dict]:
    """Normalize an `ingress` block (the admission-tier
    overload leg) into direction-aware records: priority-class goodput
    under overload (higher — the tier's whole point), the shed ratio
    (higher: under a fixed oversubscription, shedding MORE junk at
    admission is the desired behavior — a falling shed ratio means junk
    is leaking into the pool), applied-tx latency p95 (lower), and its
    ratio against the unloaded baseline (lower; the 2x acceptance
    gate)."""
    out: List[dict] = []
    if not isinstance(ib, dict) or not _num(ib, "decided"):
        return out
    pri = ib.get("priority")
    if isinstance(pri, dict):
        v = _num(pri, "goodput")
        if v is not None:
            out.append(make_record("ingress_priority_goodput", "share",
                                   v, platform, "higher", source,
                                   round_no, at_unix))
    for key, metric, unit, direction in (
            ("shed_ratio", "ingress_shed_ratio", "share", "higher"),
            ("tx_latency_p95_ms", "ingress_tx_latency_p95_ms", "ms",
             "lower"),
            ("p95_ratio", "ingress_p95_vs_unloaded_ratio", "x",
             "lower")):
        v = _num(ib, key)
        if v is not None:
            out.append(make_record(metric, unit, v, platform, direction,
                                   source, round_no, at_unix))
    return out


def validate_ingress(ib, where: str = "") -> List[str]:
    """Schema check for one `ingress` block (`check`/`--check`): the
    admission counters must be non-negative ints with the shed ratio
    actually shed/decided, priority goodput must be applied/submitted in
    [0, 1], the p95 ratio must be its own numerator/denominator, the
    intake/source occupancies must respect their declared caps (the
    bounded-memory acceptance gate travels with the artifact), and the
    lifecycle funnel's shed/throttled outcomes can never exceed the
    ingress tier's own decision counts (the funnel tracks first-seen
    txs only)."""
    errs: List[str] = []
    if not isinstance(ib, dict):
        return ["%s: ingress is not an object: %r" % (where, ib)]
    vals = {}
    for key in ("decided", "admitted", "throttled", "shed"):
        v = ib.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errs.append("%s: ingress.%s must be an int >= 0, got %r"
                        % (where, key, v))
            v = None
        vals[key] = v
    if None not in vals.values() and \
            vals["decided"] != vals["admitted"] + vals["throttled"] + \
            vals["shed"]:
        errs.append("%s: ingress.decided %d != admitted+throttled+shed %d"
                    % (where, vals["decided"],
                       vals["admitted"] + vals["throttled"] + vals["shed"]))
    ratio = _num(ib, "shed_ratio")
    if ratio is None or ratio < 0 or ratio > 1:
        errs.append("%s: ingress.shed_ratio must be in [0, 1], got %r"
                    % (where, ib.get("shed_ratio")))
    elif vals.get("decided"):
        want = vals["shed"] / vals["decided"] if vals.get("shed") \
            is not None else None
        if want is not None and abs(ratio - want) > max(1e-3, 0.01 * want):
            errs.append("%s: ingress.shed_ratio %.4f != shed/decided %.4f"
                        % (where, ratio, want))
    pri = ib.get("priority")
    if not isinstance(pri, dict):
        errs.append("%s: ingress.priority must be an object, got %r"
                    % (where, pri))
    else:
        sub, app = pri.get("submitted"), pri.get("applied")
        gp = _num(pri, "goodput")
        if not isinstance(sub, int) or not isinstance(app, int) or \
                isinstance(sub, bool) or isinstance(app, bool) or \
                sub < 0 or app < 0 or app > sub:
            errs.append("%s: ingress.priority needs ints "
                        "0 <= applied <= submitted, got %r/%r"
                        % (where, app, sub))
        elif gp is None or gp < 0 or gp > 1:
            errs.append("%s: ingress.priority.goodput must be in [0, 1], "
                        "got %r" % (where, pri.get("goodput")))
        elif sub and abs(gp - app / sub) > max(1e-3, 0.01 * (app / sub)):
            errs.append("%s: ingress.priority.goodput %.4f != "
                        "applied/submitted %.4f" % (where, gp, app / sub))
    p95 = _num(ib, "tx_latency_p95_ms")
    base = _num(ib, "unloaded_p95_ms")
    pr = _num(ib, "p95_ratio")
    if p95 is None or p95 < 0 or base is None or base <= 0 or \
            pr is None or pr < 0:
        errs.append("%s: ingress needs finite tx_latency_p95_ms >= 0, "
                    "unloaded_p95_ms > 0, p95_ratio >= 0; got %r/%r/%r"
                    % (where, ib.get("tx_latency_p95_ms"),
                       ib.get("unloaded_p95_ms"), ib.get("p95_ratio")))
    elif abs(pr - p95 / base) > max(0.01, 0.01 * pr):
        errs.append("%s: ingress.p95_ratio %.3f != p95/unloaded %.3f"
                    % (where, pr, p95 / base))
    # bounded-memory gate: occupancy <= cap for the intake and the
    # per-source tracking map
    for blk, occ_key in (("intake", "depth"), ("sources", "tracked")):
        sub = ib.get(blk)
        if not isinstance(sub, dict):
            errs.append("%s: ingress.%s must be an object, got %r"
                        % (where, blk, sub))
            continue
        occ, cap = _num(sub, occ_key), _num(sub, "cap")
        if occ is None or cap is None or occ < 0 or cap <= 0:
            errs.append("%s: ingress.%s needs finite %s >= 0 and cap > 0,"
                        " got %r/%r" % (where, blk, occ_key,
                                        sub.get(occ_key), sub.get("cap")))
        elif occ > cap:
            errs.append("%s: ingress.%s.%s %.0f exceeds its cap %.0f — "
                        "an unbounded queue in a committed artifact"
                        % (where, blk, occ_key, occ, cap))
    outcomes = ib.get("outcomes")
    if isinstance(outcomes, dict):
        for kind in ("shed", "throttled"):
            oc = outcomes.get(kind, 0)
            lim = vals.get(kind)
            if isinstance(oc, int) and lim is not None and oc > lim:
                errs.append("%s: lifecycle outcome %s=%d exceeds the "
                            "ingress %s count %d" % (where, kind, oc,
                                                     kind, lim))
    return errs
