"""Scenario lab: declarative robustness scenarios.

Copied from `stellar_core_tpu/testing/scenarios.py` at commit 02f8fbd;
carry a fix in either copy to the other. Nothing is left out.

Deliberately different:

- `run_scenario(name, seed, scale, workdir, backend="cuda-resilient")`
  and `run_suite(seed, scale, backend=...)` build every `Simulation` of a
  scenario on `backend` (`simulation/simulation.py`): the card's stacks
  unless the CPU is named, and a raise where there is no card. Each
  `run_<name>` takes the same `backend`.
- The bench records come from the port's `testing/bench_records.py`; the
  reference loads `tools/bench_compare.py` by its path, and the port
  imports nothing under `tools/`. A block's `records` keep the
  reference's fields and `source` strings, so a port block equals the
  reference's; the port writes them nowhere.

Each scenario composes the seeded fault injector, ChaosTransport and the
fleet observability stack with the node lifecycle
(Simulation.stop_node / restart_node / add_late_node), the Herder's
self-healing out-of-sync recovery, the overlay flood defense, the
tx-queue surge eviction and the ingress admission tier into one
deterministic, asserted run that returns a **fleet bench block**: slot
latency p50/p95, externalize skew, and scenario-specific numbers
(recovery time-to-tracking, flood latency ratio, surge evictions) plus
normalized `records` under scenario-specific platform keys
(`scenario-churn`, `scenario-flood`, ...).

Every schedule runs on seeded RNG streams and virtual app clocks only
(no wall clock, no unseeded randomness), so one (scenario, seed, scale)
triple replays identically, on the card as on the CPU. The one
exception is the checkpoint scenario's light-client verify timings
(`verify_p50_ms` / `verify_p95_ms` and the `scenario_checkpoint_verify_p95`
record), which read the host's clock.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Dict, List, Optional

from ..crypto.hashing import sha256
from ..crypto.keys import SecretKey
from ..history.archive import HistoryArchive
from ..main.config import Config
from ..simulation.geography import LatencyMatrix
from ..simulation.simulation import Simulation
from ..util import rnd
from ..util.log import get_logger
from ..xdr import (
    Memo, MessageType, MuxedAccount, SCPQuorumSet, StellarMessage,
    Transaction, TransactionEnvelope, _Ext,
)
from . import AppLedgerAdapter, TestAccount, bench_records

log = get_logger("LoadGen")


# --------------------------------------------------------------------------
# shared plumbing

def _record(metric: str, unit: str, value: float, platform: str,
            direction: str, source: str) -> dict:
    """One normalized bench record (tools/bench_compare.py schema)."""
    return {"metric": metric, "unit": unit, "value": value,
            "platform": platform, "direction": direction, "source": source,
            "round": None, "at_unix": None, "commit": None}


def _keys(n: int, tag: bytes, seed: int) -> List[SecretKey]:
    return [SecretKey.from_seed(sha256(tag + b"-%d-" % seed + bytes([i])))
            for i in range(n)]


def _clear_verify_cache() -> None:
    from ..crypto import keys as _keys_mod
    _keys_mod.flush_verify_cache()


def _header_hashes(app) -> Dict[int, str]:
    rows = app.database.execute(
        "SELECT ledgerseq, ledgerhash FROM ledgerheaders").fetchall()
    return dict(rows)


def _assert_header_equality(apps: List, min_common: int = 2) -> int:
    """Per-height header-hash equality across every app's DB; returns the
    number of common heights compared."""
    maps = [_header_hashes(a) for a in apps]
    common = set.intersection(*(set(m) for m in maps))
    assert len(common) >= min_common, \
        "too few common heights: %d" % len(common)
    for seq in sorted(common):
        hashes = {m[seq] for m in maps}
        assert len(hashes) == 1, "fork at ledger %d: %r" % (seq, hashes)
    return len(common)


def _fleet_block(agg) -> dict:
    """The fleet summary sub-block every scenario emits."""
    summary = agg.fleet_stats()["summary"]
    return {
        "slot_count": summary["slot_count"],
        "slot_latency_p50_ms": round(
            summary["slot_latency_p50_s"] * 1e3, 3),
        "slot_latency_p95_ms": round(
            summary["slot_latency_p95_s"] * 1e3, 3),
        "externalize_skew_p50_ms": round(
            summary["externalize_skew_p50_s"] * 1e3, 3),
        "externalize_skew_max_ms": round(
            summary["externalize_skew_max_s"] * 1e3, 3),
        "stragglers": summary["stragglers"],
    }


def _crank_until(sim: Simulation, pred: Callable[[], bool],
                 max_rounds: int, what: str) -> None:
    assert sim.crank_until(pred, max_rounds), \
        "scenario stalled waiting for %s: %r" % (
            what, {n: v.app.ledger_manager.last_closed_ledger_num()
                   for n, v in sim.nodes.items()})


def _common_records(name: str, fleet: dict, source: str) -> List[dict]:
    plat = "scenario-%s" % name
    return [
        _record("scenario_slot_latency_p95", "ms",
                fleet["slot_latency_p95_ms"], plat, "lower", source),
        _record("scenario_externalize_skew_max", "ms",
                fleet["externalize_skew_max_ms"], plat, "lower", source),
    ]


def _overlay_records(name: str, ob: Optional[dict],
                     source: str) -> List[dict]:
    """Direction-aware records from an `overlay_breakdown`: flood
    duplication ratio (lower = less O(n²) waste) and end-to-end tx
    latency p50/p95, by `bench_records` (which skips idle-run zeros)."""
    if ob is None:
        return []
    return bench_records.overlay_breakdown_records(
        ob, "scenario-%s" % name, source)


# --------------------------------------------------------------------------
# churn: kill / restart under load, rejoin via recovery + archive catchup

def run_churn(seed: int, scale: str, workdir: str,
              backend: str = "cuda-resilient") -> dict:
    """Churn soak: a 4-node fleet closes ledgers under payment load and
    publishes checkpoints; one tracking node is killed mid-run, the
    survivors advance past the victim's validity bracket, the victim
    restarts over its persisted DB/buckets, loses sync (stuck timer),
    and self-heals: externalize hints locate the network, recovery
    triggers CatchupWork against the archive, and tracking resumes —
    asserted per-height header-hash-equal with the survivors."""
    freq = 4
    bracket = 12
    cycles = 1 if scale == "tier1" else 2
    archive_root = os.path.join(workdir, "archive")
    os.makedirs(archive_root, exist_ok=True)

    def tweak_for(i: int):
        def tweak(cfg: Config) -> None:
            cfg.DATABASE = "sqlite3://%s" % os.path.join(
                workdir, "node%d.db" % i)
            cfg.BUCKET_DIR_PATH = os.path.join(workdir, "buckets-%d" % i)
            cfg.CHECKPOINT_FREQUENCY = freq
            cfg.LEDGER_VALIDITY_BRACKET = bracket
            cfg.CONSENSUS_STUCK_TIMEOUT_SECONDS = 2.0
            cfg.CATCHUP_COMPLETE = True   # replay every height: the
            # hash-equality assertion covers the victim's whole gap
            arch = HistoryArchive.local_dir("lab", archive_root)
            d = {"get": arch.get_tmpl, "mkdir": arch.mkdir_tmpl}
            if i == 0:
                d["put"] = arch.put_tmpl
            cfg.HISTORY = {"lab": d}
        return tweak

    sim = Simulation(Simulation.OVER_LOOPBACK, backend=backend)
    keys = _keys(4, b"churn", seed)
    qset = SCPQuorumSet(threshold=3,
                        validators=[k.public_key for k in keys],
                        innerSets=[])
    names = []
    for i, k in enumerate(keys):
        node = sim.add_node(k, qset, name="n%d" % i,
                            cfg_tweak=tweak_for(i))
        node.app.enable_buckets()
        names.append(node.name)
    for i in range(4):
        for j in range(i + 1, 4):
            sim.connect(names[i], names[j])
    sim.apply_latency_matrix(LatencyMatrix(names, "single-dc", seed))
    sim.start_all_nodes()
    victim_name = names[-1]
    n0 = sim.nodes[names[0]].app

    _crank_until(sim, lambda: sim.have_all_externalized(3), 40000,
                 "initial convergence")
    # payment load: a couple of funded accounts ping-ponging
    adapter = AppLedgerAdapter(n0)
    root = adapter.root_account()
    accounts = _keys(2, b"churn-acct", seed)
    n0.submit_transaction(root.tx(
        [root.op_create_account(k.public_key, 10**10) for k in accounts]))
    payers = [TestAccount(adapter, k) for k in accounts]
    pay_seq: Dict[bytes, int] = {}
    pump_state = {"lcl": 0}

    def pump_load(n_txs: int = 2) -> None:
        # throttled to one burst per closed ledger: steady load, not a
        # per-crank firehose
        lcl = n0.ledger_manager.last_closed_ledger_num()
        if lcl == pump_state["lcl"]:
            return
        pump_state["lcl"] = lcl
        for i in range(n_txs):
            p = payers[i % len(payers)]
            seqk = p.sk.seed
            try:
                seq = pay_seq.get(seqk) or p.next_seq()
                st = n0.submit_transaction(p.tx(
                    [p.op_payment(root.account_id, 100 + i)], seq=seq))
                if st == 0:
                    pay_seq[seqk] = seq + 1
                else:
                    pay_seq.pop(seqk, None)  # resync from the ledger
            except AssertionError:
                pay_seq.pop(seqk, None)   # account not yet created

    recovery_times: List[float] = []
    for cycle in range(cycles):
        victim = sim.nodes[victim_name]
        lcl_at_kill = victim.app.ledger_manager.last_closed_ledger_num()
        sim.stop_node(victim_name)
        # survivors advance past the victim's validity bracket AND past
        # the next checkpoint boundaries, pumping load the whole way
        down_target = lcl_at_kill + bracket + 2 * freq

        def survivors_ahead() -> bool:
            pump_load()
            return sim.have_all_externalized(down_target)
        _crank_until(sim, survivors_ahead, 120000,
                     "survivors past the bracket")
        # drain the publish queue so the archive covers the gap
        _crank_until(
            sim, lambda: n0.history_manager.publish_queue() == [],
            60000, "publish queue drain")

        sim.restart_node(victim_name)
        victim = sim.nodes[victim_name]
        h = victim.app.herder
        from ..herder.herder import HerderState

        def victim_recovered() -> bool:
            pump_load(1)
            return (h.recoveries >= 1 and
                    h.state == HerderState.HERDER_TRACKING_STATE and
                    victim.app.ledger_manager.last_closed_ledger_num() >=
                    down_target)
        _crank_until(sim, victim_recovered, 200000,
                     "victim recovery to TRACKING")
        mjson = victim.app.metrics.to_json()
        assert mjson["herder.recovery.lost-sync"]["count"] >= 1
        assert mjson["herder.recovery.attempt"]["count"] >= 1
        assert mjson["herder.recovery.catchup-triggered"]["count"] >= 1, \
            "recovery never routed through CatchupWork"
        ttt = mjson["herder.recovery.time-to-tracking"]
        assert ttt["count"] >= 1
        recovery_times.append(ttt["mean"])

    # everyone advances together after the final heal
    tip = max(v.app.ledger_manager.last_closed_ledger_num()
              for v in sim.nodes.values())
    _crank_until(sim, lambda: sim.have_all_externalized(tip + 2), 60000,
                 "post-recovery convergence")
    common = _assert_header_equality(
        [v.app for v in sim.nodes.values()], min_common=8)
    fleet = _fleet_block(sim.fleet())
    sim.stop_all_nodes()

    source = "bench.py --scenario churn"
    ttt_s = round(max(recovery_times), 6)
    records = _common_records("churn", fleet, source)
    records.append(_record("scenario_recovery_time_to_tracking", "s",
                           ttt_s, "scenario-churn", "lower", source))
    return {
        "metric": "scenario_churn", "unit": "ms",
        "value": fleet["slot_latency_p95_ms"],
        "platform": "scenario-churn",
        "scenario": "churn", "seed": seed, "scale": scale,
        "topology": {"nodes": 4, "threshold": 3, "mode": "loopback",
                     "profile": "single-dc",
                     "checkpoint_frequency": freq, "bracket": bracket},
        "fault_schedule": ["kill %s x%d, restart after bracket+2*freq "
                           "slots" % (victim_name, cycles)],
        "assertions": {
            "recovery_cycles": cycles,
            "recovery_time_to_tracking_s": ttt_s,
            "common_heights_hash_equal": common,
        },
        "fleet": fleet,
        "records": records,
    }


# --------------------------------------------------------------------------
# flood: adversarial envelope/tx flood vs the per-peer rate limiter

def _junk_tx_message(network_id: bytes, i: int) -> StellarMessage:
    """Distinct, cheap-to-reject flood payload: an unsigned payment from
    a nonexistent account (every honest node drops it at checkValid)."""
    from ..xdr import Asset, Operation, OperationBody, OperationType, \
        PaymentOp
    sk = SecretKey.from_seed(sha256(b"flood-src" + network_id))
    dst = SecretKey.from_seed(sha256(b"flood-dst" + network_id))
    op = Operation(sourceAccount=None, body=OperationBody(
        OperationType.PAYMENT,
        PaymentOp(destination=MuxedAccount.from_account_id(dst.public_key),
                  asset=Asset.native(), amount=1 + i)))
    t = Transaction(
        sourceAccount=MuxedAccount.from_account_id(sk.public_key),
        fee=100, seqNum=i + 1, timeBounds=None, memo=Memo.none(),
        operations=[op], ext=_Ext.v0())
    return StellarMessage(MessageType.TRANSACTION,
                          TransactionEnvelope.for_tx(t))


def run_flood(seed: int, scale: str, workdir: str,
              backend: str = "cuda-resilient") -> dict:
    """Adversarial flood: 3 honest validators plus one flooder peer over
    the real overlay stack. The baseline leg closes ledgers clean; the
    flood leg has the flooder spray distinct junk transactions until the
    per-peer token bucket caps it and ban-score escalation bans + drops
    it — honest slot latency p95 must stay within tolerance of the
    baseline."""
    slots = 6 if scale == "tier1" else 20
    burst_msgs = 60 if scale == "tier1" else 200

    def leg(flood_on: bool, prop_on: bool = True) -> dict:
        rnd.reseed(seed)
        _clear_verify_cache()
        sim = Simulation(Simulation.OVER_PEERS, backend=backend)
        hkeys = _keys(3, b"flood-honest", seed)
        fkey = _keys(1, b"flood-adversary", seed)[0]
        qset = SCPQuorumSet(threshold=2,
                            validators=[k.public_key for k in hkeys],
                            innerSets=[])

        def tweak(cfg: Config) -> None:
            cfg.DATABASE = "sqlite3://:memory:"
            # tight defense so the scenario caps within a short run:
            # ~burst tokens, slow refill, quick ban escalation
            cfg.FLOOD_RATE_LIMIT_PER_PEER = 50.0
            cfg.FLOOD_RATE_BURST = 30
            cfg.FLOOD_BAN_SCORE_THRESHOLD = 40
            # real-cadence virtual slots (1 s apart): honest per-slot SCP
            # traffic stays under the refill rate, while the flooder's
            # burst lands inside one instant and caps — accelerated
            # closes would make EVERY peer look like a flooder
            cfg.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = False
            cfg.EXPECTED_LEDGER_CLOSE_TIME = 1.0
            # the propagation-disabled control leg measures the hop-
            # recording overhead (the acceptance: close-latency
            # p95 within 5% of this leg)
            cfg.PROPAGATION_STATS_ENABLED = prop_on
        honest = [sim.add_node(k, qset, name="h%d" % i, cfg_tweak=tweak)
                  for i, k in enumerate(hkeys)]
        flooder = sim.add_node(fkey, qset, name="adv", cfg_tweak=tweak)
        for i in range(3):
            for j in range(i + 1, 3):
                sim.connect_peers(honest[i].name, honest[j].name)
        for h in honest:
            sim.connect_peers(flooder.name, h.name)
        sim.start_all_nodes()
        honest_apps = [n.app for n in honest]

        def honest_at(seq: int) -> bool:
            return all(a.ledger_manager.last_closed_ledger_num() >= seq
                       for a in honest_apps)
        _crank_until(sim, lambda: honest_at(2), 60000, "flood-leg start")
        # honest payment traffic through the real overlay: the wire
        # cockpit's tx-lifecycle funnel measures submit→applied latency
        # under flood vs baseline
        ad = AppLedgerAdapter(honest_apps[0])
        root = ad.root_account()
        base_seq = ad.seq_num(root.account_id)
        for i in range(3):
            st = honest_apps[0].submit_transaction(root.tx(
                [root.op_payment(root.account_id, 1 + i)],
                seq=base_seq + 1 + i))
            assert st == 0, "honest payment rejected at submit"
        base = max(a.ledger_manager.last_closed_ledger_num()
                   for a in honest_apps)

        flood_stats = {}
        if flood_on:
            net = flooder.app.config.network_id
            sent = 0
            adv_key = flooder.app.config.node_id().to_xdr()

            def flooder_banned() -> bool:
                return any(adv_key not in a.overlay_manager
                           .authenticated_peers and
                           a.overlay_manager.ban_manager.is_banned(
                               flooder.app.config.node_id())
                           for a in honest_apps)
            for _ in range(40):
                if flooder_banned():
                    break
                for _ in range(burst_msgs):
                    flooder.app.overlay_manager.broadcast_message(
                        _junk_tx_message(net, sent), False)
                    sent += 1
                sim.crank_all_nodes(4)
            assert flooder_banned(), \
                "flood never escalated into a BanManager ban"
            m0 = honest_apps[0].metrics.to_json()
            limited = m0.get("overlay.flood.rate-limited",
                             {}).get("count", 0)
            bans = sum(a.metrics.to_json().get("overlay.flood.ban",
                                               {}).get("count", 0)
                       for a in honest_apps)
            assert limited > 0, "rate limiter never capped the flooder"
            assert bans >= 1
            flood_stats = {"junk_sent": sent, "limited_at_h0": limited,
                           "bans": bans}

        _crank_until(sim, lambda: honest_at(base + slots), 200000,
                     "honest liveness%s" % (" under flood"
                                            if flood_on else ""))
        # the honest payments actually completed the funnel
        def payments_applied() -> bool:
            lc = honest_apps[0].herder.tx_lifecycle
            return lc.fleet_json()["count"] >= 3
        _crank_until(sim, payments_applied, 60000,
                     "honest payments applied")
        _assert_header_equality(honest_apps, min_common=2)
        from ..util.fleet import FleetAggregator
        agg = FleetAggregator()
        for n in honest:
            agg.add_app(n.name, n.app)
        fleet = _fleet_block(agg)
        overlay = agg.overlay_breakdown()
        propagation = agg.propagation_summary()
        sim.stop_all_nodes()
        return {"fleet": fleet, "flood": flood_stats,
                "overlay_breakdown": overlay,
                "propagation": propagation}

    off = leg(False)
    on = leg(True)
    # propagation-disabled control: same flood, hop recording off —
    # the overhead guard compares honest slot p95 against it
    ctrl = leg(True, prop_on=False)
    assert ctrl["propagation"] is None, \
        "control leg still recorded propagation hops"
    p95_off = max(off["fleet"]["slot_latency_p95_ms"], 0.001)
    ratio = round(on["fleet"]["slot_latency_p95_ms"] / p95_off, 3)
    p95_ctrl = max(ctrl["fleet"]["slot_latency_p95_ms"], 0.001)
    prop_overhead = round(on["fleet"]["slot_latency_p95_ms"] / p95_ctrl, 3)
    source = "bench.py --scenario flood"
    records = _common_records("flood", on["fleet"], source)
    records.append(_record("scenario_flood_latency_ratio", "x", ratio,
                           "scenario-flood", "lower", source))
    records.append(_record("scenario_flood_prop_overhead_ratio", "x",
                           prop_overhead, "scenario-flood", "lower",
                           source))
    # wire-cockpit gates: flood duplication ratio + honest
    # tx latency under flood
    records.extend(_overlay_records("flood", on["overlay_breakdown"],
                                    source))
    # propagation cockpit gates: hop latency, tree depth,
    # redundant bandwidth share — and the cross-cockpit reconciliation
    # (duplicates/firsts over merged hop records IS the flood
    # duplication ratio; both cockpits count at Floodgate.add_record)
    bc = bench_records
    records.extend(bc.propagation_records(
        on["propagation"], "scenario-flood", source))
    errs = bc.validate_propagation(
        on["propagation"], where="flood",
        flood=(on["overlay_breakdown"] or {}).get("flood"))
    assert not errs, "propagation block failed validation: %r" % errs
    assert on["overlay_breakdown"] is not None
    assert on["overlay_breakdown"]["flood"]["unique"] > 0
    assert on["overlay_breakdown"]["tx_latency_ms"]["count"] >= 3
    assert on["propagation"] is not None
    assert on["propagation"]["trees"] > 0
    assert on["propagation"]["redundant_bandwidth_share"] > 0
    return {
        "metric": "scenario_flood", "unit": "ms",
        "value": on["fleet"]["slot_latency_p95_ms"],
        "platform": "scenario-flood",
        "scenario": "flood", "seed": seed, "scale": scale,
        "topology": {"nodes": 3, "threshold": 2, "mode": "peers",
                     "adversaries": 1},
        "fault_schedule": ["flooder sprays %d-msg junk-tx bursts until "
                           "banned" % (60 if scale == "tier1" else 200)],
        "assertions": {
            "flooder_banned": True,
            "limited_at_h0": on["flood"]["limited_at_h0"],
            "bans": on["flood"]["bans"],
            "junk_sent": on["flood"]["junk_sent"],
            "p95_ratio_on_vs_off": ratio,
            "prop_overhead_ratio": prop_overhead,
        },
        "fleet": on["fleet"],
        "baseline_fleet": off["fleet"],
        "control_fleet": ctrl["fleet"],
        "overlay_breakdown": on["overlay_breakdown"],
        "baseline_overlay_breakdown": off["overlay_breakdown"],
        "propagation": on["propagation"],
        "records": records,
    }


# --------------------------------------------------------------------------
# partition: region severed and healed; minority self-heals via SCP state

def run_partition(seed: int, scale: str, workdir: str,
                  backend: str = "cuda-resilient") -> dict:
    """Partitioned-region heal: 4 validators across a three-region
    latency matrix over chaos links; one region (1 node) is severed, the
    majority keeps externalizing, the minority's stuck timer fires and
    recovery polls; after heal, the recovery path re-learns the live
    slots via GET_SCP_STATE solicitation (no archive needed inside the
    remember window) and tracking resumes hash-equal."""
    part_slots = 4 if scale == "tier1" else 8

    def tweak(cfg: Config) -> None:
        cfg.DATABASE = "sqlite3://:memory:"
        # cross-region slots take several virtual seconds (latency +
        # nomination rounds): 10 s only fires for the genuinely severed
        # node, not for a slow-but-alive majority
        cfg.CONSENSUS_STUCK_TIMEOUT_SECONDS = 10.0
        # the partitioned node's virtual clock jumps ahead on its own
        # timers; idle/straggler drops would disconnect it permanently
        # (sim links have no redial) — the scenario tests SCP recovery,
        # not the peer book, so park the peer-liveness timeouts
        cfg.PEER_TIMEOUT = 10**6
        cfg.PEER_STRAGGLER_TIMEOUT = 10**6

    sim = Simulation(Simulation.OVER_PEERS, backend=backend)
    keys = _keys(4, b"partition", seed)
    qset = SCPQuorumSet(threshold=3,
                        validators=[k.public_key for k in keys],
                        innerSets=[])
    names = [sim.add_node(k, qset, name="p%d" % i, cfg_tweak=tweak).name
             for i, k in enumerate(keys)]
    sim.apply_latency_matrix(LatencyMatrix(names, "three-region", seed))
    for i in range(4):
        for j in range(i + 1, 4):
            sim.connect_peers(names[i], names[j], chaos=True)
    sim.start_all_nodes()
    _crank_until(sim, lambda: sim.have_all_externalized(3), 80000,
                 "pre-partition convergence")

    minority = names[3]
    majority = names[:3]
    for other in majority:
        sim.set_partition(minority, other, True)
    maj_apps = [sim.nodes[n].app for n in majority]
    min_app = sim.nodes[minority].app
    base = max(a.ledger_manager.last_closed_ledger_num() for a in maj_apps)

    def majority_ahead() -> bool:
        return all(a.ledger_manager.last_closed_ledger_num() >=
                   base + part_slots for a in maj_apps)
    _crank_until(sim, majority_ahead, 200000, "majority under partition")
    for other in majority:
        sim.heal_partition(minority, other)
        # the frames the partition ate advanced the senders' HMAC
        # sequences: the healed link is cryptographically dead, like a
        # real partition killing TCP — reconnect with a fresh handshake
        sim.reconnect_peers(minority, other, chaos=True)

    h = min_app.herder
    from ..herder.herder import HerderState

    def minority_healed() -> bool:
        return (h.recoveries >= 1 and
                h.state == HerderState.HERDER_TRACKING_STATE and
                min_app.ledger_manager.last_closed_ledger_num() >=
                base + part_slots)
    _crank_until(sim, minority_healed, 200000, "minority heal")
    mjson = min_app.metrics.to_json()
    assert mjson["herder.recovery.lost-sync"]["count"] >= 1
    assert mjson["herder.recovery.scp-state-request"]["count"] >= 1, \
        "recovery never solicited SCP state"
    ttt = mjson["herder.recovery.time-to-tracking"]
    assert ttt["count"] >= 1
    tip = max(v.app.ledger_manager.last_closed_ledger_num()
              for v in sim.nodes.values())
    _crank_until(sim, lambda: sim.have_all_externalized(tip + 2), 80000,
                 "post-heal convergence")
    common = _assert_header_equality([v.app for v in sim.nodes.values()],
                                     min_common=4)
    fleet = _fleet_block(sim.fleet())
    matrix = sim.latency_matrix.to_json()
    sim.stop_all_nodes()

    source = "bench.py --scenario partition"
    heal_s = round(ttt["mean"], 6)
    records = _common_records("partition", fleet, source)
    records.append(_record("scenario_recovery_time_to_tracking", "s",
                           heal_s, "scenario-partition", "lower", source))
    return {
        "metric": "scenario_partition", "unit": "ms",
        "value": fleet["slot_latency_p95_ms"],
        "platform": "scenario-partition",
        "scenario": "partition", "seed": seed, "scale": scale,
        "topology": {"nodes": 4, "threshold": 3, "mode": "peers",
                     "profile": "three-region",
                     "regions": matrix["regions"]},
        "fault_schedule": ["sever %s from all for %d slots, then heal"
                           % (minority, part_slots)],
        "assertions": {
            "recovery_time_to_tracking_s": heal_s,
            "scp_state_requests":
                mjson["herder.recovery.scp-state-request"]["count"],
            "common_heights_hash_equal": common,
        },
        "fleet": fleet,
        "records": records,
    }


# --------------------------------------------------------------------------
# surge: pool saturation with hot-account contention + fee-bid eviction

def run_surge(seed: int, scale: str, workdir: str,
              backend: str = "cuda-resilient") -> dict:
    """Surge: a 3-node fleet with a deliberately small tx pool is hit
    with 3 rounds of low-fee payments (every round pays the SAME hot
    destination) until the pool saturates, then a burst of high-fee
    bids — each admission must evict a lowest-fee-rate chain tail
    (`herder.tx-queue.surge-evicted`), the pool stays bounded, and
    consensus keeps closing hash-equal."""
    n_low = 10 if scale == "tier1" else 20
    n_high = 5 if scale == "tier1" else 10
    cap_ops = 3 * n_low

    def tweak(cfg: Config) -> None:
        cfg.DATABASE = "sqlite3://:memory:"
        cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE = cap_ops
        cfg.POOL_LEDGER_MULTIPLIER = 1

    sim = Simulation(Simulation.OVER_LOOPBACK, backend=backend)
    keys = _keys(3, b"surge", seed)
    qset = SCPQuorumSet(threshold=2,
                        validators=[k.public_key for k in keys],
                        innerSets=[])
    names = [sim.add_node(k, qset, name="s%d" % i, cfg_tweak=tweak).name
             for i, k in enumerate(keys)]
    for i in range(3):
        for j in range(i + 1, 3):
            sim.connect(names[i], names[j])
    sim.start_all_nodes()
    n0 = sim.nodes[names[0]].app
    _crank_until(sim, lambda: sim.have_all_externalized(2), 40000,
                 "surge start")

    adapter = AppLedgerAdapter(n0)
    root = adapter.root_account()
    low_keys = _keys(n_low, b"surge-low", seed)
    high_keys = _keys(n_high, b"surge-high", seed)
    n0.submit_transaction(root.tx(
        [root.op_create_account(k.public_key, 10**10)
         for k in low_keys + high_keys]))
    hot = root.account_id   # every payment hits ONE hot destination

    def accounts_exist() -> bool:
        return adapter.account_exists(low_keys[0].public_key) and \
            adapter.account_exists(high_keys[-1].public_key)
    _crank_until(sim, accounts_exist, 40000, "surge accounts")

    # saturate: 3 rounds of low-fee chains, no cranking in between so the
    # pool actually fills instead of draining into txsets
    lows = [TestAccount(adapter, k) for k in low_keys]
    for rnd_i in range(3):
        for acc in lows:
            seq = acc.next_seq() + rnd_i
            st = n0.submit_transaction(acc.tx(
                [acc.op_payment(hot, 50 + rnd_i)], seq=seq, fee=100))
            assert st == 0, "low-fee fill rejected (round %d)" % rnd_i
    q = n0.herder.tx_queue
    assert q.size_ops() == cap_ops, (q.size_ops(), cap_ops)

    # the pool is full: every further same-rate bid must bounce...
    bounced = n0.submit_transaction(
        lows[0].tx([lows[0].op_payment(hot, 999)],
                   seq=lows[0].next_seq() + 3, fee=100))
    assert bounced != 0, "same-rate bid admitted into a full pool"
    # ...while strictly-better bids evict lowest-rate tails
    highs = [TestAccount(adapter, k) for k in high_keys]
    for acc in highs:
        st = n0.submit_transaction(acc.tx(
            [acc.op_payment(hot, 77)], seq=acc.next_seq(), fee=2000))
        assert st == 0, "high-fee bid rejected despite eviction room"
    assert q.size_ops() <= cap_ops
    evicted = n0.metrics.to_json()[
        "herder.tx-queue.surge-evicted"]["count"]
    assert evicted >= n_high, (evicted, n_high)

    # remember the high bids' hashes before consensus consumes them
    high_hashes = {f.contents_hash().hex()
                   for chain in q._pending.values()
                   for f in chain if f.fee_bid >= 2000}
    assert len(high_hashes) == n_high
    tip = n0.ledger_manager.last_closed_ledger_num()
    _crank_until(sim, lambda: sim.have_all_externalized(tip + 4), 80000,
                 "surge drain")
    # the high bids actually made it into closed ledgers
    applied = {row[0] for row in n0.database.execute(
        "SELECT txid FROM txhistory").fetchall()}
    assert high_hashes <= applied, \
        "surge-admitted high-fee txs never applied"
    assert q.size_ops() <= cap_ops
    common = _assert_header_equality([v.app for v in sim.nodes.values()],
                                     min_common=4)
    agg = sim.fleet()
    fleet = _fleet_block(agg)
    # loopback mode has no wire stats (the overlay shim), but the
    # tx-lifecycle half still measures the surge's submit→apply funnel
    # incl. the evictions the fee-market defense performed
    overlay = agg.overlay_breakdown()
    sim.stop_all_nodes()

    source = "bench.py --scenario surge"
    records = _common_records("surge", fleet, source)
    records.extend(_overlay_records("surge", overlay, source))
    assert overlay is not None
    assert overlay["tx_latency_ms"]["count"] > 0
    assert overlay["outcomes"].get("evicted", 0) >= n_high
    return {
        "metric": "scenario_surge", "unit": "ms",
        "value": fleet["slot_latency_p95_ms"],
        "platform": "scenario-surge",
        "scenario": "surge", "seed": seed, "scale": scale,
        "topology": {"nodes": 3, "threshold": 2, "mode": "loopback",
                     "pool_cap_ops": cap_ops},
        "fault_schedule": ["%d low-fee chains x3 rounds to a hot "
                           "destination, then %d high-fee bids"
                           % (n_low, n_high)],
        "assertions": {
            "surge_evicted": evicted,
            "pool_bounded": True,
            "applied_tx_rows": len(applied),
            "common_heights_hash_equal": common,
        },
        "fleet": fleet,
        "overlay_breakdown": overlay,
        "records": records,
    }


# --------------------------------------------------------------------------
# checkpoint: one validator serving signed state checkpoints + membership
# proofs to a fleet of light clients while validating

def run_checkpoint(seed: int, scale: str, workdir: str,
                   backend: str = "cuda-resilient") -> dict:
    """Checkpoint-serving: a 3-node fleet closes ledgers under payment
    load; node 0 maintains the incremental Merkle state commitment
    (asserted equal to the from-scratch oracle at EVERY close) and
    emits signed checkpoints on a short interval. After the load phase
    a fleet of light clients round-robins membership proofs for the
    touched accounts and verifies each against the served checkpoint
    with `light_client_verify` — a pure function over proof bytes, no
    ledger DB, no replay — under the <10 ms acceptance bound; one
    tampered proof and one forged checkpoint signature must be
    rejected."""
    from ..ledger.state_commitment import light_client_verify
    from ..util.timer import real_perf_counter
    from ..xdr import LedgerKey
    slots = 9 if scale == "tier1" else 24
    n_clients = 50 if scale == "tier1" else 1000
    interval = 3

    def tweak(cfg: Config) -> None:
        cfg.DATABASE = "sqlite3://:memory:"
        cfg.STATE_CHECKPOINT_INTERVAL = interval

    sim = Simulation(Simulation.OVER_LOOPBACK, backend=backend)
    keys = _keys(3, b"checkpoint", seed)
    qset = SCPQuorumSet(threshold=2,
                        validators=[k.public_key for k in keys],
                        innerSets=[])
    names = []
    for i, k in enumerate(keys):
        node = sim.add_node(k, qset, name="c%d" % i, cfg_tweak=tweak)
        # every validator runs the bucket list (consensus commits to
        # bucketListHash); node 0 is additionally the checkpoint SERVER
        node.app.enable_buckets(os.path.join(workdir,
                                             "cp-buckets-%d" % i))
        names.append(node.name)
    server = sim.nodes[names[0]].app
    for i in range(3):
        for j in range(i + 1, 3):
            sim.connect(names[i], names[j])
    sim.start_all_nodes()
    _crank_until(sim, lambda: sim.have_all_externalized(2), 40000,
                 "checkpoint-scenario start")

    adapter = AppLedgerAdapter(server)
    root = adapter.root_account()
    accounts = _keys(6, b"checkpoint-acct", seed)
    server.submit_transaction(root.tx(
        [root.op_create_account(k.public_key, 10**10) for k in accounts]))
    sce = server.state_commitment
    bl = server.bucket_manager.bucket_list
    oracle_state = {"lcl": 0, "checked": 0}

    def oracle_each_close() -> None:
        # the 30-ledger-replay acceptance's live twin: every NEW close
        # on the serving node must keep incremental == from-scratch
        lcl = server.ledger_manager.last_closed_ledger_num()
        if lcl == oracle_state["lcl"] or sce.root is None:
            return
        oracle_state["lcl"] = lcl
        assert sce.root == sce.from_scratch_root(bl), \
            "incremental Merkle root diverged from oracle at %d" % lcl
        oracle_state["checked"] += 1

    payers = [TestAccount(adapter, k) for k in accounts]
    pay_seq: Dict[bytes, int] = {}
    pump_state = {"lcl": 0}

    def pump_load() -> None:
        lcl = server.ledger_manager.last_closed_ledger_num()
        oracle_each_close()
        if lcl == pump_state["lcl"]:
            return
        pump_state["lcl"] = lcl
        for i, p in enumerate(payers[:3]):
            seqk = p.sk.seed
            try:
                seq = pay_seq.get(seqk) or p.next_seq()
                st = server.submit_transaction(p.tx(
                    [p.op_payment(root.account_id, 10 + i)], seq=seq))
                if st == 0:
                    pay_seq[seqk] = seq + 1
                else:
                    pay_seq.pop(seqk, None)
            except AssertionError:
                pay_seq.pop(seqk, None)

    base = server.ledger_manager.last_closed_ledger_num()

    def load_done() -> bool:
        pump_load()
        return sim.have_all_externalized(base + slots) and \
            sce.checkpoint() is not None
    _crank_until(sim, load_done, 200000, "checkpoint load phase")
    assert oracle_state["checked"] >= slots - 2, oracle_state

    # --- the serving side: checkpoint + per-client proofs -------------
    cp = sce.checkpoint()
    assert cp is not None
    prove_keys = [LedgerKey.account(root.account_id)] + \
        [LedgerKey.account(k.public_key) for k in accounts]
    proofs = []
    for k in prove_keys:
        p = sce.prove_entry(k)
        assert p is not None, "no proof for a live account"
        proofs.append(p)
    import json as _json
    proof_bytes = max(len(_json.dumps(p)) for p in proofs)

    # --- the light-client fleet: verify without replay or DB ----------
    net = server.config.network_id
    verify_s: List[float] = []
    for c in range(n_clients):
        p = proofs[c % len(proofs)]
        t0 = real_perf_counter()
        ok, reason = light_client_verify(p, cp, net)
        verify_s.append(real_perf_counter() - t0)
        assert ok, "light client %d rejected a valid proof: %s" % (
            c, reason)
    verify_s.sort()
    p50_ms = round(verify_s[len(verify_s) // 2] * 1e3, 4)
    p95_ms = round(verify_s[int(len(verify_s) * 0.95)] * 1e3, 4)
    assert p95_ms < 10.0, "light-client verify p95 %.3f ms over the " \
        "10 ms acceptance bound" % p95_ms

    # tampering must be caught: a flipped entry byte and a forged
    # checkpoint signature
    bad = _json.loads(_json.dumps(proofs[0]))
    flip = "00" if bad["entry"][-2:] != "00" else "01"
    bad["entry"] = bad["entry"][:-2] + flip
    assert not light_client_verify(bad, cp, net)[0], \
        "tampered entry accepted"
    forged = dict(cp)
    forged["signature"] = "00" * 64
    assert not light_client_verify(proofs[0], forged, net)[0], \
        "forged checkpoint signature accepted"

    emitted = server.metrics.to_json()[
        "commitment.checkpoint.emitted"]["count"]
    assert emitted >= 1
    common = _assert_header_equality([v.app for v in sim.nodes.values()],
                                     min_common=4)
    fleet = _fleet_block(sim.fleet())
    sim.stop_all_nodes()

    source = "bench.py --scenario checkpoint"
    records = _common_records("checkpoint", fleet, source)
    records.append(_record("scenario_checkpoint_verify_p95", "ms",
                           p95_ms, "scenario-checkpoint", "lower",
                           source))
    records.append(_record("checkpoint_proof_bytes", "bytes",
                           proof_bytes, "scenario-checkpoint", "lower",
                           source))
    return {
        "metric": "scenario_checkpoint", "unit": "ms",
        "value": fleet["slot_latency_p95_ms"],
        "platform": "scenario-checkpoint",
        "scenario": "checkpoint", "seed": seed, "scale": scale,
        "topology": {"nodes": 3, "threshold": 2, "mode": "loopback",
                     "checkpoint_interval": interval,
                     "light_clients": n_clients},
        "fault_schedule": ["none (proof-integrity scenario: tampered "
                           "proof + forged signature must be rejected)"],
        "assertions": {
            "oracle_checked_closes": oracle_state["checked"],
            "checkpoints_emitted": emitted,
            "light_clients": n_clients,
            "verify_p50_ms": p50_ms,
            "verify_p95_ms": p95_ms,
            "proof_bytes": proof_bytes,
            "tampered_rejected": True,
            "common_heights_hash_equal": common,
        },
        "fleet": fleet,
        "records": records,
    }


# --------------------------------------------------------------------------
# overload: 5x open-loop oversubscription vs the ingress admission tier

def run_overload(seed: int, scale: str, workdir: str,
                 backend: str = "cuda-resilient") -> dict:
    """Million-submitter overload: a 3-node loopback fleet
    whose pool capacity is deliberately small is oversubscribed 5x —
    untrusted-class flooder accounts spraying chained payments, plus a
    seeded open-loop Zipf flood from a 10^6-key submitter keyspace —
    while a handful of priority-class accounts submit honest traffic.
    Three legs: `unloaded` (priority only — the latency baseline),
    `control` (full overload, INGRESS_ENABLED=False — the pool absorbs
    everything and degrades), `ingress` (full overload through the
    admission tier). Gates: the ingress leg keeps applied-tx p95 within
    2x the unloaded baseline with priority goodput >= 90%, while the
    control leg visibly degrades on both axes; every ingress queue/map
    stays bounded."""
    slots = 6 if scale == "tier1" else 12
    txset_cap = 20
    n_pri, n_flood = 4, 10
    pri_per_slot, flood_per_slot = 2, 10     # 100/slot vs 20 capacity
    junk_rate = 30.0                          # open-loop keyspace flood
    oversub = round(
        (n_flood * flood_per_slot + junk_rate + n_pri * pri_per_slot)
        / float(txset_cap), 1)

    pri_keys = _keys(n_pri, b"overload-pri", seed)
    flood_keys = _keys(n_flood, b"overload-flood", seed)

    def leg(name: str, ingress_on: bool, loaded: bool) -> dict:
        rnd.reseed(seed)
        _clear_verify_cache()
        from ..crypto import strkey as _strkey
        sim = Simulation(Simulation.OVER_LOOPBACK, backend=backend)
        vkeys = _keys(3, b"overload-val", seed)
        qset = SCPQuorumSet(threshold=2,
                            validators=[k.public_key for k in vkeys],
                            innerSets=[])

        def tweak(cfg: Config) -> None:
            cfg.DATABASE = "sqlite3://:memory:"
            cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE = txset_cap
            cfg.POOL_LEDGER_MULTIPLIER = 3
            cfg.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = False
            cfg.EXPECTED_LEDGER_CLOSE_TIME = 1.0
            cfg.INGRESS_ENABLED = ingress_on
            if ingress_on:
                cfg.INGRESS_ASYNC_INTAKE = True
                # roughly one close's worth of intake plus slack: the
                # Zipf keyspace flood must overflow it every slot so
                # shed-lowest-class-first is actually exercised
                cfg.INGRESS_INTAKE_DEPTH = txset_cap + 4
                cfg.INGRESS_MAX_SOURCES = 4096
                # tight classes so 5x oversubscription throttles and
                # sheds within a short run: priority unlimited, the
                # junk keyspace (default) and the untrusted flooders
                # capped far below their spray rates
                cfg.INGRESS_CLASSES = {
                    "default": {"rate": 0.5, "burst": 2.0,
                                "max_inflight": 2},
                    "untrusted": {"rate": 0.3, "burst": 1.0,
                                  "max_inflight": 2},
                }
                # the genesis root (account factory) rides the priority
                # class too — the operator pins its own keys
                cfg.INGRESS_PRIORITY_ACCOUNTS = [
                    _strkey.encode_public_key(k.public_key.key_bytes)
                    for k in pri_keys] + [
                    SecretKey.from_seed(
                        sha256(cfg.network_id)).strkey_public()]
                cfg.INGRESS_UNTRUSTED_ACCOUNTS = [
                    _strkey.encode_public_key(k.public_key.key_bytes)
                    for k in flood_keys]
        names = [sim.add_node(k, qset, name="o%d" % i,
                              cfg_tweak=tweak).name
                 for i, k in enumerate(vkeys)]
        for i in range(3):
            for j in range(i + 1, 3):
                sim.connect(names[i], names[j])
        sim.start_all_nodes()
        n0 = sim.nodes[names[0]].app
        _crank_until(sim, lambda: sim.have_all_externalized(2), 40000,
                     "overload start (%s)" % name)

        adapter = AppLedgerAdapter(n0)
        root = adapter.root_account()
        # chunked creates: a tx wider than maxTxSetSize ops could never
        # fit a txset with this deliberately tiny capacity
        all_keys = pri_keys + flood_keys
        rseq = root.next_seq() - 1
        for i in range(0, len(all_keys), 10):
            rseq += 1
            st = n0.submit_transaction(root.tx(
                [root.op_create_account(k.public_key, 10**10)
                 for k in all_keys[i:i + 10]], seq=rseq))
            assert st == 0, "account-creation tx refused at submit"

        def accounts_exist() -> bool:
            return adapter.account_exists(pri_keys[0].public_key) and \
                adapter.account_exists(flood_keys[-1].public_key)
        _crank_until(sim, accounts_exist, 80000, "overload accounts")

        pris = [TestAccount(adapter, k) for k in pri_keys]
        floods = [TestAccount(adapter, k) for k in flood_keys]
        seqs: Dict[bytes, int] = {}
        dest = root.account_id

        def burst(accts, per_acct, counters, amt, hashes=None) -> None:
            """One per-slot submission burst of chained payments; local
            seq tracking resyncs from the ledger after hard rejects so
            bounced chains resume instead of gapping forever. `amt`
            varies per slot so a bounced-then-retried payment is a
            distinct tx, not a lifecycle duplicate."""
            for acc in accts:
                k = acc.sk.seed
                seq = seqs.get(k)
                if seq is None:
                    seq = acc.next_seq() - 1
                for _ in range(per_acct):
                    frame = acc.tx([acc.op_payment(dest, amt)],
                                   seq=seq + 1, fee=100)
                    status = n0.submit_transaction(frame)
                    counters["submitted"] += 1
                    if status == 0:
                        seq += 1
                        counters["accepted"] += 1
                        if hashes is not None:
                            hashes.add(frame.contents_hash().hex())
                    elif status == 3:
                        counters["backpressured"] += 1
                    else:
                        counters["rejected"] += 1
                        seq = acc.next_seq() - 1
                seqs[k] = seq

        pri_counts = {"submitted": 0, "accepted": 0, "backpressured": 0,
                      "rejected": 0}
        flood_counts = dict(pri_counts)
        pri_hashes: set = set()
        if loaded:
            # the open-loop 10^6-keyspace junk flood rides app-clock
            # timers for the whole measurement window
            n0.load_generator.start_open_loop(
                junk_rate, duration_s=float(slots), submitters=10**6,
                zipf_s=1.1, seed=seed, tick=0.5)
        base = n0.ledger_manager.last_closed_ledger_num()
        for s in range(slots):
            # flooders race ahead of honest traffic every slot — in the
            # control leg they fill the pool before priority arrives
            if loaded:
                burst(floods, flood_per_slot, flood_counts, 1 + s)
            burst(pris, pri_per_slot, pri_counts, 1 + s, pri_hashes)
            _crank_until(sim,
                         lambda: sim.have_all_externalized(base + s + 1),
                         200000, "overload slot %d (%s)" % (s, name))
        ol = n0.load_generator.open_loop_status()
        n0.load_generator.stop_open_loop()
        # drain: a few unloaded closes so in-flight priority txs land
        _crank_until(sim,
                     lambda: sim.have_all_externalized(base + slots + 3),
                     200000, "overload drain (%s)" % name)

        applied = {row[0] for row in n0.database.execute(
            "SELECT txid FROM txhistory").fetchall()}
        pri_applied = len(pri_hashes & applied)
        _assert_header_equality([v.app for v in sim.nodes.values()],
                                min_common=2)
        agg = sim.fleet()
        fleet = _fleet_block(agg)
        overlay = agg.overlay_breakdown()
        ing = n0.herder.ingress
        ing_json = ing.to_json() if ing is not None else None
        lc = n0.herder.tx_lifecycle.to_json()
        sim.stop_all_nodes()
        return {"fleet": fleet, "overlay_breakdown": overlay,
                "ingress_json": ing_json, "lifecycle": lc,
                "open_loop": ol, "pri": pri_counts,
                "pri_applied": pri_applied, "flood": flood_counts}

    unloaded = leg("unloaded", ingress_on=True, loaded=False)
    control = leg("control", ingress_on=False, loaded=True)
    on = leg("ingress", ingress_on=True, loaded=True)

    def p95(legb: dict) -> float:
        ob = legb["overlay_breakdown"]
        assert ob is not None and ob["tx_latency_ms"]["count"] > 0
        return max(ob["tx_latency_ms"]["p95"], 0.001)

    p95_unloaded, p95_control, p95_on = p95(unloaded), p95(control), \
        p95(on)
    p95_ratio = round(p95_on / p95_unloaded, 3)
    control_ratio = round(p95_control / p95_unloaded, 3)
    goodput = round(on["pri_applied"] /
                    max(1, on["pri"]["submitted"]), 6)
    goodput_control = round(control["pri_applied"] /
                            max(1, control["pri"]["submitted"]), 6)
    cj = on["ingress_json"]["counters"]
    admitted = sum(c["admitted"] for c in cj.values())
    throttled = sum(c["throttled"] for c in cj.values())
    shed = sum(c["shed"] for c in cj.values())
    decided = admitted + throttled + shed
    shed_ratio = round(shed / max(1, decided), 6)
    ingress_block = {
        "oversubscription": oversub,
        "decided": decided, "admitted": admitted,
        "throttled": throttled, "shed": shed,
        "shed_ratio": shed_ratio,
        "priority": {"submitted": on["pri"]["submitted"],
                     "applied": on["pri_applied"],
                     "goodput": goodput},
        "intake": on["ingress_json"]["intake"],
        "sources": on["ingress_json"]["sources"],
        "outcomes": on["lifecycle"]["outcomes"],
        "tx_latency_p95_ms": round(p95_on, 3),
        "unloaded_p95_ms": round(p95_unloaded, 3),
        "p95_ratio": p95_ratio,
    }

    # acceptance gates: bounded latency + priority goodput
    # through the admission tier, visible degradation without it
    assert p95_ratio <= 2.0, \
        "ingress leg p95 %.1fms exceeds 2x unloaded %.1fms" \
        % (p95_on, p95_unloaded)
    assert goodput >= 0.9, \
        "priority goodput %.3f under overload with ingress on" % goodput
    assert goodput_control < goodput, \
        "control leg did not degrade priority goodput (%.3f vs %.3f)" \
        % (goodput_control, goodput)
    assert p95_control > p95_on, \
        "control leg p95 %.1fms not worse than ingress leg %.1fms" \
        % (p95_control, p95_on)
    assert shed > 0 and throttled > 0, (shed, throttled)
    # bounded memory: intake and per-source maps never exceed their caps
    assert on["ingress_json"]["intake"]["depth"] <= \
        on["ingress_json"]["intake"]["cap"]
    assert on["ingress_json"]["sources"]["tracked"] <= \
        on["ingress_json"]["sources"]["cap"]
    # the lifecycle funnel counted the sheds (sum contract: funnel
    # outcomes are a subset of ingress decisions — duplicates decided
    # more than once are tracked once)
    oc = on["lifecycle"]["outcomes"]
    assert oc.get("shed", 0) + oc.get("throttled", 0) > 0
    assert oc.get("shed", 0) <= shed
    assert oc.get("throttled", 0) <= throttled
    # the open-loop flood actually spanned a wide keyspace and was
    # backpressured rather than absorbed
    assert on["open_loop"]["distinct_submitters"] > 50
    assert on["open_loop"]["backpressured"] > 0
    assert on["open_loop"]["last_retry_after"] is not None

    source = "bench.py --scenario overload"
    plat = "scenario-overload"
    records = _common_records("overload", on["fleet"], source)
    bc = bench_records
    records.extend(bc.ingress_records(ingress_block, plat, source))
    records.append(_record("overload_control_p95_ratio", "x",
                           control_ratio, plat, "higher", source))
    errs = bc.validate_ingress(ingress_block, where="overload")
    assert not errs, "ingress block failed validation: %r" % errs
    return {
        "metric": "scenario_overload", "unit": "ms",
        "value": p95_on,
        "platform": plat,
        "scenario": "overload", "seed": seed, "scale": scale,
        "topology": {"nodes": 3, "threshold": 2, "mode": "loopback",
                     "txset_cap": txset_cap, "pool_multiplier": 3,
                     "priority_accounts": n_pri,
                     "flooder_accounts": n_flood,
                     "junk_keyspace": 10**6},
        "fault_schedule": [
            "%d untrusted flooders x%d chained payments per slot + "
            "%.0f tx/s Zipf(1.1) open-loop junk from a 10^6-key "
            "keyspace (%.1fx oversubscribed) for %d slots"
            % (n_flood, flood_per_slot, junk_rate, oversub, slots)],
        "assertions": {
            "p95_ratio_vs_unloaded": p95_ratio,
            "control_p95_ratio_vs_unloaded": control_ratio,
            "priority_goodput": goodput,
            "control_priority_goodput": goodput_control,
            "shed": shed, "throttled": throttled,
            "intake_bounded": True, "sources_bounded": True,
            "open_loop_distinct_submitters":
                on["open_loop"]["distinct_submitters"],
        },
        "fleet": on["fleet"],
        "baseline_fleet": unloaded["fleet"],
        "control_fleet": control["fleet"],
        "ingress": ingress_block,
        "overlay_breakdown": on["overlay_breakdown"],
        "records": records,
    }


# --------------------------------------------------------------------------
# registry + runner

SCENARIOS: Dict[str, dict] = {
    "churn": {
        "fn": run_churn,
        "description": "kill/restart a tracking node under load + "
                       "archive failover; self-healing recovery to "
                       "TRACKING (time-to-tracking gated)",
    },
    "flood": {
        "fn": run_flood,
        "description": "adversarial junk-tx flood vs the per-peer token "
                       "bucket + ban-score escalation; honest p95 vs "
                       "no-flood baseline",
    },
    "partition": {
        "fn": run_partition,
        "description": "three-region latency matrix, one region severed "
                       "and healed; minority self-heals via solicited "
                       "SCP state",
    },
    "surge": {
        "fn": run_surge,
        "description": "tx-pool saturation with hot-account contention; "
                       "fee-bid surge eviction keeps the pool bounded",
    },
    "overload": {
        "fn": run_overload,
        "description": "5x+ open-loop oversubscription from a 10^6-key "
                       "Zipf submitter keyspace vs the ingress admission "
                       "tier; priority goodput + bounded p95 gated "
                       "against an ingress-off control leg",
    },
    "checkpoint": {
        "fn": run_checkpoint,
        "description": "one validator maintains the incremental Merkle "
                       "state commitment under load (oracle-checked "
                       "every close) and serves signed checkpoints + "
                       "membership proofs to a light-client fleet that "
                       "verifies without replay (<10 ms p95 gated)",
    },
}


def run_scenario(name: str, seed: int = 1, scale: str = "tier1",
                 workdir: Optional[str] = None,
                 backend: str = "cuda-resilient") -> dict:
    """Run one scenario deterministically on `backend`'s stacks; returns
    its fleet bench block (see module docstring). Raises AssertionError
    when a scenario invariant does not hold."""
    if name not in SCENARIOS:
        raise ValueError("unknown scenario %r; known: %s"
                         % (name, ", ".join(sorted(SCENARIOS))))
    assert scale in ("tier1", "soak"), scale
    rnd.reseed(seed)
    _clear_verify_cache()
    own_dir = workdir is None
    if own_dir:
        workdir = tempfile.mkdtemp(prefix="sct-scenario-%s-" % name)
    try:
        block = SCENARIOS[name]["fn"](seed, scale, workdir,
                                       backend=backend)
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
    block["description"] = SCENARIOS[name]["description"]
    return block


def run_suite(seed: int = 1, scale: str = "tier1",
              backend: str = "cuda-resilient") -> dict:
    """All scenarios, one artifact (the reference's
    BENCH_r*_scenarios.json shape)."""
    blocks = {name: run_scenario(name, seed=seed, scale=scale,
                                 backend=backend)
              for name in sorted(SCENARIOS)}
    records: List[dict] = []
    for b in blocks.values():
        records.extend(b["records"])
    return {
        "metric": "scenario_suite", "unit": "scenarios",
        "value": len(blocks), "platform": "scenario-suite",
        "seed": seed, "scale": scale,
        "scenarios": blocks,
        "records": records,
    }
