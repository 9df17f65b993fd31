"""CommandHandler: the operator admin API.

Copied from `stellar_core_tpu/main/command_handler.py` at commit a6220d9;
carry a fix in either copy to the other. The test-only `generateload`
endpoint drives the port's own `simulation/load_generator.py` through
`Application.load_generator`.

`verifier` reads the port's stack as the reference reads its own: the
stack's `inner` is the `CudaSigVerifier` fleet, whose `_fleet_health`
(per-member breakers) and `batches_dispatched` / `sigs_verified` it
reports. On one card, `batches_dispatched` counts the verify kernel's
launches by drains (a warmup's launches are not drains); the per-member
drains ride in `devices`. Deliberately different: on the card's stacks
`verifier` and `hasher` add `counters.kernel_launches`, each kernel's
launch count in the process (drains and warmup), and `launch_counters`
gathers both cockpits' counts for the `catchup` command.

Role parity: reference `src/main/CommandHandler.cpp:77-105` — HTTP
endpoints `info`, `metrics`, `peers`, `quorum`, `scp`, `tx`,
`manualclose`, `upgrades`, `ll`, `bans`, `ban`, `unban`, `connect`,
`droppeer`, `maintenance`, `dropcursor`, `setcursor`, `getcursor`.
Command dispatch is a pure function (`handle_command`) so the CLI, tests,
and the HTTP server share one implementation; the HTTP server executes
each command on the main loop through `clock.post_to_main` (the
single-threaded-consensus invariant, docs/architecture.md:23-26).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..util.log import get_log_levels, get_logger, set_log_level

log = get_logger("Overlay")


class CommandParamError(ValueError):
    """A malformed request parameter: surfaces as a 400 with an error
    dict instead of a 500 stack trace out of the HTTP thread."""


def _int_param(params: Dict[str, str], key: str,
               default: Optional[int] = None,
               minimum: Optional[int] = None) -> Optional[int]:
    """Validated numeric query param: non-numeric or below-minimum
    values raise CommandParamError (-> 400) rather than ValueError deep
    inside a handler."""
    raw = params.get(key)
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except (TypeError, ValueError):
        raise CommandParamError(
            "parameter %r must be an integer, got %r" % (key, raw))
    if minimum is not None and v < minimum:
        raise CommandParamError(
            "parameter %r must be >= %d, got %d" % (key, minimum, v))
    return v


def _float_param(params: Dict[str, str], key: str,
                 default: Optional[float] = None,
                 minimum: Optional[float] = None,
                 maximum: Optional[float] = None) -> Optional[float]:
    raw = params.get(key)
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except (TypeError, ValueError):
        raise CommandParamError(
            "parameter %r must be a number, got %r" % (key, raw))
    if v != v:   # NaN compares false against any bound
        raise CommandParamError("parameter %r must not be NaN" % key)
    if minimum is not None and v < minimum:
        raise CommandParamError(
            "parameter %r must be >= %g, got %g" % (key, minimum, v))
    if maximum is not None and v > maximum:
        raise CommandParamError(
            "parameter %r must be <= %g, got %g" % (key, maximum, v))
    return v


class CommandHandler:
    def __init__(self, app) -> None:
        self.app = app
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- dispatch ------------------------------------------------------------
    def handle_command(self, name: str,
                       params: Dict[str, str]) -> Tuple[int, object]:
        """Returns (http_status, body) — body is a JSON-serializable
        dict, or a plain string served as text/plain (the Prometheus
        exposition path)."""
        fn = getattr(self, "cmd_" + name.replace("-", "_"), None)
        if fn is None:
            return 404, {"error": "unknown command %r" % name,
                         "commands": self.command_names()}
        try:
            return 200, fn(params)
        except CommandParamError as e:
            return 400, {"error": str(e)}
        except Exception as e:
            return 500, {"error": "%s: %s" % (type(e).__name__, e)}

    def command_names(self):
        return sorted(m[len("cmd_"):].replace("_", "-")
                      for m in dir(self) if m.startswith("cmd_"))

    # -- introspection -------------------------------------------------------
    def cmd_info(self, params) -> dict:
        info = self.app.get_info()
        lm = self.app.ledger_manager
        info["history"] = {
            "published_checkpoints":
                self.app.history_manager.published_checkpoints,
            "publish_queue_length":
                len(self.app.history_manager.publish_queue()),
        }
        cm = self.app.catchup_manager
        info["catchup"] = {
            "running": cm.catchup_running(),
            "buffered": cm.buffered_count(),
            "started": cm.catchups_started,
        }
        info["ledger"]["synced"] = lm.is_synced()
        return info

    def cmd_metrics(self, params):
        """`metrics[?filter=<prefix>][&format=prometheus]` — with a
        filter, only metrics whose name starts with the prefix are
        serialized (operators and tests fetch `crypto.` or `ledger.`
        without paying for the registry); `format=prometheus` renders
        the same export in text exposition format for standard scrapers
        (docs/metrics.md#prometheus-exposition)."""
        prefix = params.get("filter") or None
        out = self.app.metrics.to_json(prefix=prefix)
        # crypto-boundary metrics live outside the registry (global cache,
        # per-verifier counters); merge them in medida-style names
        from ..crypto import keys as _keys
        cache = _keys.verify_cache_stats()
        out["crypto.verify.cache-hit"] = {"count": cache["hits"]}
        out["crypto.verify.cache-miss"] = {"count": cache["misses"]}
        v = getattr(self.app, "sig_verifier", None)
        inner = getattr(v, "inner", v)
        if inner is not None and hasattr(inner, "batches_dispatched"):
            out["crypto.verify.batch-dispatch"] = {
                "count": inner.batches_dispatched}
            out["crypto.verify.sigs"] = {"count": inner.sigs_verified}
        if prefix:
            out = {k: v2 for k, v2 in out.items() if k.startswith(prefix)}
        if params.get("format") == "prometheus":
            # HELP text sourced from the docs/metrics.md catalog (the
            # M1-guarded one), falling back to the metric name — real
            # Prometheus/Grafana setups get self-describing scrapes
            from ..util.metrics import load_help_catalog, render_prometheus
            return render_prometheus(out,
                                     help_catalog=load_help_catalog())
        return out

    def cmd_verifier(self, params) -> dict:
        """Device cockpit
        (docs/observability.md#device-cockpit): the batch-verify
        boundary's operational state in one JSON blob — per-bucket
        occupancy/pad-waste histograms, drain attribution by serving
        backend, per-device fleet rows (drain/sig/pad attribution,
        inflight, breaker ring), double-buffer staging overlap,
        compile-cache + per-bucket warmup status (app-clock stamped,
        with the warm-start plan source), queue depth/inflight/
        queue-wait, breaker state, and the verify-cache counters. The
        same data is scrapeable as `sct_verifier_*` series via
        `metrics?format=prometheus`."""
        v = getattr(self.app, "sig_verifier", None)
        if v is None:
            return {"error": "no signature verifier wired"}
        out: dict = {
            "configured_backend": self.app.config.SIG_VERIFY_BACKEND,
            "verifier": v.name,
        }
        stats = getattr(v, "stats", None)
        if stats is not None:
            out.update(stats.to_json())
        breaker = getattr(v, "breaker", None)
        if breaker is not None:
            out["breaker"] = breaker.to_json()
        inner = getattr(v, "inner", v)
        # fleet rows: per-device breaker ring of the card's fleet, read
        # without resolving its members — the per-device drain/inflight
        # attribution itself rides in stats.to_json()["devices"] above
        fleet = getattr(inner, "_fleet_health", None)
        if fleet is not None:
            out["fleet"] = fleet.to_json()
        out["counters"] = {
            "batches_dispatched": getattr(inner, "batches_dispatched", 0),
            "sigs_verified": getattr(inner, "sigs_verified", 0),
            "pending": v.pending(),
        }
        if fleet is not None:
            # the card's stack: the verify kernel's launches in this
            # process (ops/ed25519.LAUNCHES: drains and warmup)
            from ..ops import ed25519 as _ed25519
            out["counters"]["kernel_launches"] = _ed25519.LAUNCHES
        from ..crypto import keys as _keys
        out["cache"] = _keys.verify_cache_stats()
        return out

    def cmd_hasher(self, params) -> dict:
        """Hash cockpit
        (docs/observability.md#hash-cockpit): the batch-hash boundary's
        operational state in one JSON blob — per-drain batch-shape /
        pad-waste / occupancy histograms, per-(lanes×blocks) bucket
        dispatch stats, drain attribution by serving backend AND by
        close-path call site (txset / result-set / header /
        bucket-entries / …), double-buffer staging overlap,
        compile-cache + per-shape warmup status, oversize split-outs,
        and the breaker state. The same data is scrapeable as
        `sct_hasher_*` series via `metrics?format=prometheus`."""
        h = getattr(self.app, "batch_hasher", None)
        if h is None:
            return {"error": "no batch hasher wired"}
        out: dict = {
            "configured_backend": self.app.config.HASH_BACKEND,
            "hasher": h.name,
        }
        stats = getattr(h, "stats", None)
        if stats is not None:
            out.update(stats.to_json())
        breaker = getattr(h, "breaker", None)
        if breaker is not None:
            out["breaker"] = breaker.to_json()
        if getattr(getattr(h, "primary", h), "wants_warmup", False):
            # the card's stack: the SHA-256 kernel's launches in this
            # process (ops/sha256.LAUNCHES: drains and warmup)
            from ..ops import sha256 as _sha256
            out["counters"] = {"kernel_launches": _sha256.LAUNCHES}
        return out

    def launch_counters(self) -> dict:
        """The verify and hash cockpits' launch counts in one line's
        worth: per-backend drains, the verifier's dispatched batches, the
        hasher's dispatches per shape, and the kernels' launches where the
        stacks are the card's (the `catchup` command prints it as it
        exits, since its process ends before an operator could ask)."""
        v = self.cmd_verifier({})
        h = self.cmd_hasher({})
        return {
            "verifier": {"drains": v.get("drains", {}).get("by_backend"),
                         "counters": v.get("counters"),
                         "warmed": len(v.get("warmup", {})
                                       .get("buckets", {}) or {})},
            "hasher": {"drains": h.get("drains", {}).get("by_backend"),
                       "dispatches": {k: d["dispatches"] for k, d in
                                      h.get("buckets", {}).items()},
                       "counters": h.get("counters"),
                       "warmed": len(h.get("warmup", {})
                                     .get("shapes", {}) or {})},
        }

    def cmd_checkpoint(self, params) -> dict:
        """State checkpoints 
        (        docs/observability.md#hash-cockpit): `checkpoint[?seq=N]
        [&entry=<hex LedgerKey XDR>]`. With no params, the latest
        signed StateCheckpoint {ledger seq, header hash, Merkle root,
        node signature}; `seq=N` returns that exact checkpoint from the
        ring. `entry=` additionally serves a Merkle membership proof
        for that ledger entry against the current commitment root —
        `light_client_verify(proof, checkpoint, network_id)` then
        verifies authenticity with no replay and no ledger DB."""
        sce = getattr(self.app, "state_commitment", None)
        bm = getattr(self.app, "bucket_manager", None)
        if sce is None or bm is None:
            return {"error": "state commitments require buckets enabled"}
        seq = _int_param(params, "seq", None, minimum=1)
        cp = sce.checkpoint(seq)
        out: dict = {
            "checkpoint": cp,
            "root": sce.root.hex() if sce.root is not None else None,
            "interval": self.app.config.STATE_CHECKPOINT_INTERVAL,
            "retained": len(sce.checkpoints),
        }
        if cp is None:
            out["error"] = ("no checkpoint for seq %d in the ring" % seq
                            if seq is not None else
                            "no checkpoint emitted yet")
        entry = params.get("entry")
        if entry:
            # proofs are built against the LATEST checkpoint's frozen
            # view — pairing one with an older (or evicted/never-
            # emitted) ring seq would hand a light client a
            # (proof, checkpoint) pair that can never verify, so any
            # non-latest seq+entry combination is a 400, never a
            # silent trap
            latest = sce.checkpoint()
            if seq is not None and (
                    latest is None or cp is None or
                    cp["ledger_seq"] != latest["ledger_seq"]):
                raise CommandParamError(
                    "entry proofs are served against the latest "
                    "checkpoint%s; request them without 'seq'"
                    % ("" if latest is None else
                       " (seq %d)" % latest["ledger_seq"]))
            from ..xdr import LedgerKey
            try:
                key = LedgerKey.from_xdr(bytes.fromhex(entry))
            except Exception:
                raise CommandParamError(
                    "parameter 'entry' must be a hex-encoded LedgerKey "
                    "XDR, got %r" % entry)
            proof = sce.prove_entry(key, bm.bucket_list)
            out["proof"] = proof
            if proof is None:
                out["proof_error"] = \
                    "entry not live in the bucket list"
        return out

    def cmd_applystats(self, params) -> dict:
        """Close cockpit
        (docs/observability.md#close-cockpit): the apply path's
        operational state in one JSON blob — per-op-type counts and
        attributed milliseconds (native engine table + Python-path
        timings), native-bail forensics by classified reason, state-read
        telemetry (per-type point lookups, entry-cache hit/miss,
        prefetch coverage + getPrefetchHitRate parity, bulk-scan rows),
        bucket per-level sizes and merge durations, and the last close's
        blob. `applystats?action=reset` zeroes the cumulative aggregates
        (registry metrics keep their monotonic histories). The same data
        is scrapeable as `sct_ledger_apply_*` / `sct_bucket_*` series
        via `metrics?format=prometheus`."""
        stats = self.app.ledger_manager.apply_stats
        action = params.get("action", "status")
        if action == "reset":
            stats.reset()
            return {"status": "reset", **stats.to_json()}
        if action != "status":
            raise CommandParamError(
                "parameter 'action' must be status|reset, got %r" % action)
        return stats.to_json()

    def cmd_bucketdb(self, params) -> dict:
        """BucketDB cockpit
        (docs/observability.md#bucketdb-cockpit): the bucket-backed read
        path's operational state in one JSON blob — point-read
        hit/miss/tombstone counts, per-level probe attribution (bloom
        skips, index hits, bloom false positives), index build/load
        timing and sidecar load failures, bloom bit density, bytes read
        from bucket files, batched-prefetch shape, and SQL-fallback
        degrades. `bucketdb?action=reset` zeroes the cumulative
        aggregates (registry metrics keep their monotonic histories).
        The same data is scrapeable as `sct_bucketdb_*` series via
        `metrics?format=prometheus`."""
        bm = getattr(self.app, "bucket_manager", None)
        bdb = getattr(bm, "bucketdb", None)
        if bdb is None:
            return {"error": "buckets not enabled"}
        action = params.get("action", "status")
        if action not in ("status", "reset"):
            raise CommandParamError(
                "parameter 'action' must be status|reset, got %r" % action)
        if action == "reset":
            bdb.stats.reset()
        root = self.app.ledger_manager.root
        out = {
            "attached": bool(getattr(root, "bucket_backed",
                                     lambda: False)()),
            **bdb.to_json(),
        }
        if action == "reset":
            out["status"] = "reset"
        return out

    def cmd_overlaystats(self, params) -> dict:
        """Wire cockpit
        (docs/observability.md#overlay-cockpit): the overlay's
        operational state in one JSON blob — per-message-type
        send/recv counters and byte totals, per-peer top-K bandwidth
        attribution, flood dedup (unique vs duplicate receipts +
        duplication ratio, the O(n²) flood waste), send-queue pressure,
        envelope pipeline latency by verify backend, and the
        tx-lifecycle funnel (submit→queue→include→externalize→apply
        stage latencies whose stages sum to total by construction,
        plus per-tx outcomes). `overlaystats?action=reset` zeroes the
        cumulative aggregates (registry metrics keep their monotonic
        histories). The same data is scrapeable as `sct_overlay_*` /
        `sct_herder_tx_*` series via `metrics?format=prometheus`; the
        `fleet` field is the compact shape util/fleet.py aggregates."""
        om = self.app.overlay_manager
        stats = getattr(om, "stats", None) if om is not None else None
        lc = getattr(self.app.herder, "tx_lifecycle", None)
        action = params.get("action", "status")
        if action not in ("status", "reset"):
            raise CommandParamError(
                "parameter 'action' must be status|reset, got %r" % action)
        if action == "reset":
            if stats is not None:
                stats.reset()
            if lc is not None:
                lc.reset()
        if stats is not None and om is not None and \
                hasattr(om, "send_queue_depth"):
            stats.set_queue_depth(*om.send_queue_depth())
        out: dict = {
            "overlay": stats.to_json() if stats is not None else None,
            "tx_lifecycle": lc.to_json() if lc is not None else None,
            "fleet": {
                "overlay": stats.fleet_json()
                if stats is not None else None,
                "tx": lc.fleet_json() if lc is not None else None,
            },
        }
        if action == "reset":
            out["status"] = "reset"
        return out

    def cmd_propagation(self, params) -> dict:
        """Propagation cockpit
        (docs/observability.md#propagation-cockpit): causal flood tracing
        in one JSON blob — per-peer usefulness rankings (first-delivery
        vs redundant-edge counts, wasted bytes, top-K/bottom-K), hop-
        ring occupancy, and the fleet-wide redundant bandwidth share.
        `propagation?hash=H` returns one message's full hop trace (H a
        unique hash-hex prefix); `?peer=P` one peer's score (P a node-id
        hex prefix); `?action=reset` zeroes the aggregates (registry
        metrics keep their monotonic histories). The same data is
        scrapeable as `sct_overlay_prop_*` series via
        `metrics?format=prometheus`; the `fleet` field is the compact
        shape util/fleet.py merges into relay trees."""
        om = self.app.overlay_manager
        prop = getattr(om, "prop_stats", None) if om is not None else None
        if prop is None:
            return {"error": "propagation stats disabled "
                             "(PROPAGATION_STATS_ENABLED=false)"}
        action = params.get("action", "status")
        if action not in ("status", "reset"):
            raise CommandParamError(
                "parameter 'action' must be status|reset, got %r" % action)
        h = params.get("hash")
        if h:
            trace = prop.hash_trace(h)
            if trace is None:
                raise CommandParamError(
                    "no hop record for hash prefix %r" % h)
            return trace
        p = params.get("peer")
        if p:
            detail = prop.peer_detail(p)
            if detail is None:
                raise CommandParamError(
                    "no usefulness record for peer prefix %r" % p)
            return detail
        if action == "reset":
            prop.reset()
        out = prop.to_json()
        out["fleet"] = prop.fleet_json()
        if action == "reset":
            out["status"] = "reset"
        return out

    def cmd_scpstats(self, params) -> dict:
        """Consensus cockpit
        (docs/observability.md#consensus-cockpit): SCP's own attribution
        in one JSON blob — per-slot phase latencies derived from the
        slot-timeline stamps (nominate→prepare→confirm→externalize,
        reconciling with `timeline` by construction), nomination/ballot
        round counts, timer-fire attribution (which timer, which round,
        fired vs cancelled), per-statement-type envelopes-per-slot
        (sent AND received — the O(n²) flood baseline), per-peer
        envelope lag, and quorum health. `scpstats?slot=N` returns one
        slot's full record; `?action=reset` zeroes the aggregates
        (registry metrics keep their monotonic histories). The same
        data is scrapeable as `sct_scp_*` series via
        `metrics?format=prometheus`; the `fleet` field is the compact
        shape util/fleet.py merges into the fleet-wide
        envelopes-per-slot baseline."""
        herder = self.app.herder
        ss = getattr(herder, "scp_stats", None)
        if ss is None:
            return {"error": "consensus cockpit unavailable"}
        action = params.get("action", "status")
        if action not in ("status", "reset"):
            raise CommandParamError(
                "parameter 'action' must be status|reset, got %r" % action)
        slot = _int_param(params, "slot", None, minimum=0)
        if slot is not None:
            rep = ss.slot_report(slot)
            if rep is None:
                raise CommandParamError(
                    "no consensus record for slot %d (ring retains %d "
                    "slots)" % (slot, ss.MAX_SLOTS))
            return rep
        if action == "reset":
            ss.reset()
        from ..herder.herder import HerderState
        out = ss.to_json()
        out["health"] = ss.health(
            herder.current_slot(),
            include_open=herder.state != HerderState.HERDER_TRACKING_STATE)
        out["fleet"] = ss.fleet_json()
        if action == "reset":
            out["status"] = "reset"
        return out

    def cmd_footprint(self, params) -> dict:
        """Node footprint census
        (docs/observability.md#node-footprint): the per-node overhead
        table — every registered bounded structure's occupancy /
        capacity / approx bytes (hop rings, LRU caches, ingress intake,
        tx-lifecycle tracker, timelines, SCP state, send queues) plus
        process RSS / thread count / fd count. `over_capacity` is
        always empty unless a declared bound is broken. Scrapeable as
        `sct_footprint_*` series via `metrics?format=prometheus`; the
        fleet aggregator consumes this endpoint on live nodes."""
        fp = getattr(self.app, "footprint", None)
        if fp is None:
            return {"error": "footprint census unavailable"}
        return fp.to_json()

    def cmd_health(self, params) -> dict:
        """Seven-cockpit health rollup
        (docs/observability.md#propagation-cockpit): the single scrape a
        fleet operator watches — device breaker states (verify + hash)
        with their recovery episodes, flood duplication ratio, native
        apply bails, bucketdb SQL fallbacks, the worst peer's
        propagation usefulness, and the consensus leg (stuck slots with
        absent-member diagnosis, quorum gaps, ballot-round inflation) —
        condensed to a coarse `status: ok|degraded|critical`.
        Degraded = a breaker not closed, SQL-fallback degrades, the
        node out of sync, or a consensus problem; critical = every
        wired device breaker open."""
        app = self.app
        problems: list = []
        out: dict = {}
        breakers: dict = {}
        open_states = []
        for name, owner in (("verifier",
                             getattr(app, "sig_verifier", None)),
                            ("hasher", getattr(app, "batch_hasher", None))):
            b = getattr(owner, "breaker", None)
            if b is None:
                continue
            j = b.to_json()
            breakers[name] = {"state": j["state"], "trips": j["trips"],
                              "recoveries": j["recoveries"]}
            open_states.append(j["state"])
            if j["state"] != "closed":
                problems.append("%s breaker %s" % (name, j["state"]))
        out["breakers"] = breakers
        out["recovery_episodes"] = sum(
            b["recoveries"] for b in breakers.values())
        st = getattr(app.ledger_manager, "apply_stats", None)
        out["native_bails"] = sum(
            getattr(st, "bails", {}).values()) if st is not None else 0
        bdb = getattr(getattr(app, "bucket_manager", None),
                      "bucketdb", None)
        sql = getattr(getattr(bdb, "stats", None), "sql_fallbacks", 0) \
            if bdb is not None else 0
        out["bucketdb_sql_fallbacks"] = sql
        if sql:
            problems.append("bucketdb degraded to SQL (%d reads)" % sql)
        om = app.overlay_manager
        ostats = getattr(om, "stats", None) if om is not None else None
        if ostats is not None:
            fl = ostats.to_json()["flood"]
            out["flood_duplication_ratio"] = fl["duplication_ratio"]
        prop = getattr(om, "prop_stats", None) if om is not None else None
        if prop is not None:
            pj = prop.to_json()
            out["worst_peer_usefulness"] = \
                pj["peers"]["worst_usefulness"]
            out["redundant_bandwidth_share"] = \
                pj["redundant_bandwidth_share"]
        # consensus leg: stuck slots name the absent
        # quorum-slice members; the in-flight slot only counts once the
        # herder has lost sync (mid-nomination is not stuck)
        ss = getattr(app.herder, "scp_stats", None)
        if ss is not None:
            from ..herder.herder import HerderState
            lost = app.herder.state != HerderState.HERDER_TRACKING_STATE
            ch = ss.health(app.herder.current_slot(), include_open=lost)
            out["consensus"] = ch
            for s in ch["stuck_slots"]:
                problems.append(
                    "slot %d stuck (absent: %s)" % (
                        s["slot"],
                        ", ".join(a[:8] for a in s["absent"]) or "none"))
            q = ch["quorum"]
            if q["missing"]:
                problems.append("%d quorum member(s) never heard from"
                                % len(q["missing"]))
            if q["behind"]:
                problems.append("%d quorum member(s) behind"
                                % len(q["behind"]))
            if ch["ballot_inflated"]:
                problems.append("ballot rounds inflated (worst %d)"
                                % ch["ballot_rounds_worst"])
        synced = app.ledger_manager.is_synced()
        out["synced"] = synced
        if not synced:
            problems.append("ledger out of sync")
        if open_states and all(s == "open" for s in open_states):
            status = "critical"
        elif problems:
            status = "degraded"
        else:
            status = "ok"
        out["status"] = status
        out["problems"] = problems
        return out

    def cmd_trace(self, params) -> dict:
        """Span-tracer control + export :
        `trace?action=status|start|stop|clear|dump|flight`.
        `start` takes optional `capacity=N`; `dump` (the default action)
        returns Chrome-trace-event JSON (load in chrome://tracing or
        Perfetto), optional `limit=N` for the last N spans; `flight`
        forces a flight-recorder dump and returns its path."""
        tracer = self.app.tracer
        action = params.get("action", "dump")
        if action == "start":
            cap = _int_param(params, "capacity", None, minimum=1)
            tracer.enable(capacity=cap)
            return {"status": "tracing", "capacity": tracer.capacity}
        if action == "stop":
            tracer.disable()
            return {"status": "stopped", "spans": len(tracer.spans())}
        if action == "clear":
            tracer.clear()
            return {"status": "cleared"}
        if action == "status":
            return {"enabled": tracer.enabled,
                    "spans": len(tracer.spans()),
                    "capacity": tracer.capacity,
                    "dropped": tracer.dropped,
                    "flight_dumps": self.app.flight_recorder.dumps,
                    "flight_suppressed": self.app.flight_recorder.suppressed,
                    "last_flight_path": self.app.flight_recorder.last_path}
        if action == "flight":
            # operator-requested: bypasses the per-reason dump cooldown
            path = self.app.flight_recorder.dump(
                params.get("reason", "manual"), force=True)
            return {"status": "dumped", "path": path}
        if action == "dump":
            limit = _int_param(params, "limit", None, minimum=0)
            return tracer.to_chrome_trace(last_n=limit)
        return {"error": "action must be "
                         "status|start|stop|clear|dump|flight"}

    def cmd_faults(self, params) -> dict:
        """Fault-injection control (docs/robustness.md):
        `faults?action=status|set|clear`. `set` arms one site:
        `faults?action=set&site=device.dispatch&p=1.0&n=3&after=2`
        (probability, max fire count, evaluations to skip first); `clear`
        disarms one `site` or, with no site, everything. `status` (the
        default) reports every armed site's schedule and fire counts,
        the verify breaker, and archive health."""
        faults = self.app.faults
        action = params.get("action", "status")
        if action == "set":
            site = params.get("site")
            if not site:
                return {"error": "missing 'site' param"}
            from ..util.faults import KNOWN_SITES
            if site not in KNOWN_SITES:
                # arming a typo'd site would silently no-op forever:
                # validate against the F1 registry (docs/robustness.md)
                raise CommandParamError(
                    "unknown fault site %r; known sites: %s"
                    % (site, ", ".join(sorted(KNOWN_SITES))))
            p = _float_param(params, "p", 1.0, minimum=0.0, maximum=1.0)
            if p == 0.0:
                # p=0 would arm a site that can never fire — the same
                # silent-no-op class the unknown-site 400 prevents
                raise CommandParamError(
                    "parameter 'p' must be > 0 (use action=clear to "
                    "disarm a site)")
            faults.configure(
                site, probability=p,
                count=_int_param(params, "n", None, minimum=1),
                after=_int_param(params, "after", 0, minimum=0))
            return {"status": "armed", **faults.to_json()}
        if action == "clear":
            faults.clear(params.get("site"))
            return {"status": "cleared", **faults.to_json()}
        if action == "status":
            out = faults.to_json()
            v = getattr(self.app, "sig_verifier", None)
            breaker = getattr(v, "breaker", None)
            if breaker is not None:
                out["verify_breaker"] = breaker.to_json()
            hm = self.app.history_manager
            pool = hm.readable_pool() if hm is not None else None
            if pool is not None:
                out["archives"] = pool.to_json()
            return out
        return {"error": "action must be status|set|clear"}

    def cmd_peers(self, params) -> dict:
        om = self.app.overlay_manager
        return om.get_peers_info() if om is not None else {"peers": []}

    def cmd_quorum(self, params) -> dict:
        return self.app.herder.get_json_info()

    def cmd_checkquorum(self, params) -> dict:
        """Run the quorum-intersection checker over the transitive quorum
        map (reference `check-quorum` / periodic reanalysis); pass
        critical=true to also list intersection-critical groups; pass
        background=true to run it on a worker thread (poll `quorum` for
        the result) so a slow enumeration never blocks the main loop."""
        crit = params.get("critical", "") in ("true", "1")
        h = self.app.herder
        if params.get("background", "") in ("true", "1"):
            started = h.start_quorum_intersection_check(critical=crit)
            return {"status": "started" if started
                    else "already recalculating"}
        return h.check_quorum_intersection(critical=crit)

    def cmd_scp(self, params) -> dict:
        """`scp[?limit=N][&slot=N&timeline=true]` — SCP slot
        introspection; with `slot` + `timeline=true` the response also
        carries that slot's consensus event journal
        (util/slot_timeline.py, docs/observability.md#fleet-view)."""
        h = self.app.herder
        limit = _int_param(params, "limit", 2, minimum=0)
        scp = getattr(h, "scp", None)
        out = scp.get_json_info(limit) if scp is not None else {}
        out["tracking"] = h.current_slot()
        slot = _int_param(params, "slot", None, minimum=0)
        if slot is not None and params.get("timeline") in ("true", "1"):
            out["timeline"] = self.app.slot_timeline.events(slot)
        return out

    def cmd_timeline(self, params) -> dict:
        """`timeline[?slot=N]` — the per-slot consensus event journal:
        one slot's events, or every retained slot. Events are stamped
        with the app clock (`t`) and `perf_counter` (`pc`); `node` names
        the sending node where applicable. The fleet aggregator
        (util/fleet.py) consumes this endpoint on live nodes."""
        slot = _int_param(params, "slot", None, minimum=0)
        out = self.app.slot_timeline.to_json(slot)
        out["node"] = self.app.config.node_name()
        out["node_id"] = self.app.config.node_id().key_bytes.hex()
        return out

    # -- transactions --------------------------------------------------------
    def cmd_tx(self, params) -> dict:
        """Submit a hex- (or base64-) encoded TransactionEnvelope
        (reference CommandHandler.cpp:543-578). A TRY_AGAIN_LATER
        answer carries `retry_after` (seconds) — the ingress tier's
        backpressure hint (docs/robustness.md#ingress--overload).
        Malformed blobs are 400s, not 500s out of the HTTP thread."""
        from ..transactions.transaction_frame import TransactionFrame
        from ..xdr import TransactionEnvelope
        blob = params.get("blob")
        if not blob:
            return {"status": "ERROR", "detail": "missing 'blob' param"}
        try:
            raw = bytes.fromhex(blob)
        except ValueError:
            import base64
            import binascii
            try:
                raw = base64.b64decode(blob, validate=True)
            except (ValueError, binascii.Error):
                raise CommandParamError(
                    "parameter 'blob' is neither hex nor base64")
        try:
            env = TransactionEnvelope.from_xdr(raw)
            frame = TransactionFrame.make_from_wire(
                self.app.config.network_id, env)
        except Exception:
            raise CommandParamError(
                "parameter 'blob' does not decode to a "
                "TransactionEnvelope")
        status = self.app.submit_transaction(frame)
        names = {0: "PENDING", 1: "DUPLICATE", 2: "ERROR", 3: "TRY_AGAIN_LATER"}
        out = {"status": names.get(status, str(status))}
        if status == 2 and frame.result is not None:
            out["detail"] = str(frame.result.code)
        if status == 3:
            herder = self.app.herder
            retry = getattr(herder, "last_retry_after", None)
            out["retry_after"] = round(
                retry if retry is not None
                else self.app.config.EXPECTED_LEDGER_CLOSE_TIME, 3)
        return out

    def cmd_ingress(self, params) -> dict:
        """`ingress[?action=status|set-class|reset]` — the admission
        tier's cockpit (docs/robustness.md#ingress--overload):
        `status` (default) dumps the class table, bounded-intake depth,
        tracked sources and per-class admit/throttle/shed counters;
        `set-class&account=<strkey>&class=priority|default|untrusted`
        re-pins a source account at runtime; `reset` zeroes the
        counters. 400 on unknown actions/classes/accounts."""
        ing = getattr(self.app.herder, "ingress", None)
        if ing is None:
            return {"enabled": False}
        action = params.get("action", "status")
        if action == "status":
            out = ing.to_json()
            out["enabled"] = True
            return out
        if action == "set-class":
            from ..crypto import strkey
            acct = params.get("account")
            cls = params.get("class")
            if not acct or not cls:
                raise CommandParamError(
                    "set-class needs 'account' and 'class' params")
            try:
                raw = strkey.decode_public_key(acct)
            except Exception:
                raise CommandParamError(
                    "parameter 'account' is not a valid strkey "
                    "account id")
            try:
                ing.set_class(raw, cls)
            except ValueError as e:
                raise CommandParamError(str(e))
            return {"status": "ok", "account": acct, "class": cls}
        if action == "reset":
            ing.reset_counters()
            return {"status": "reset"}
        raise CommandParamError(
            "action must be status|set-class|reset, got %r" % action)

    def cmd_manualclose(self, params) -> dict:
        self.app.manual_close()
        return {"status": "ok",
                "ledger": self.app.ledger_manager.last_closed_ledger_num()}

    # -- upgrades ------------------------------------------------------------
    def cmd_upgrades(self, params) -> dict:
        """mode=get|set|clear; set takes protocolversion/basefee/
        basereserve/maxtxsetsize + upgradetime (reference `upgrades`)."""
        from ..herder.upgrades import UpgradeParameters
        ups = self.app.herder.upgrades
        mode = params.get("mode", "get")
        if mode == "get":
            return ups.params.to_json()
        if mode == "clear":
            ups.set_parameters(UpgradeParameters())
            self.app.herder.update_upgrades_status()
            return {"status": "cleared"}
        if mode == "set":
            p = UpgradeParameters()
            # default the schedule to "now": a 0 default would read as
            # epoch and the 12h expiration (remove_applied_and_expired)
            # would silently disarm at the very next close
            p.upgrade_time = int(self.app.clock.now())
            if "upgradetime" in params:
                p.upgrade_time = int(params["upgradetime"])
            if "protocolversion" in params:
                p.protocol_version = int(params["protocolversion"])
            if "basefee" in params:
                p.base_fee = int(params["basefee"])
            if "basereserve" in params:
                p.base_reserve = int(params["basereserve"])
            if "maxtxsetsize" in params:
                p.max_tx_set_size = int(params["maxtxsetsize"])
            ups.set_parameters(p)
            self.app.herder.update_upgrades_status()
            return p.to_json()
        return {"error": "mode must be get|set|clear"}

    # -- logging -------------------------------------------------------------
    def cmd_ll(self, params) -> dict:
        """Set log level: ?level=debug[&partition=Herder]
        (reference `ll`)."""
        if "level" in params:
            set_log_level(params.get("partition"), params["level"])
        return get_log_levels()

    # -- peers ---------------------------------------------------------------
    def cmd_connect(self, params) -> dict:
        om = self.app.overlay_manager
        peer = params.get("peer", "")
        port = int(params.get("port", 0) or 0)
        if not peer:
            return {"error": "missing 'peer' param"}
        if ":" in peer and not port:
            peer, p = peer.rsplit(":", 1)
            port = int(p)
        om.connect_to(peer, port)
        return {"status": "connecting to %s:%d" % (peer, port)}

    def cmd_droppeer(self, params) -> dict:
        om = self.app.overlay_manager
        node = params.get("node", "")
        ban = params.get("ban", "0") == "1"
        for key in list(om.authenticated_peer_ids()):
            p = om.get_peer(key)
            if p is None:
                continue
            if p.peer_id is not None and \
                    p.peer_id.key_bytes.hex().startswith(node):
                if ban:
                    om.ban_manager.ban_node(p.peer_id)
                p.drop("dropped by admin")
                return {"status": "dropped"}
        return {"error": "peer not found"}

    def _parse_node_param(self, node: str):
        """A `node` param as hex-XDR PublicKey or strkey (G...); raises
        CommandParamError (-> 400) on anything else."""
        from ..xdr import PublicKey
        if not node:
            raise CommandParamError("missing 'node' param")
        try:
            if node.startswith("G"):
                from ..crypto import strkey
                return PublicKey.ed25519(strkey.decode_public_key(node))
            return PublicKey.from_xdr(bytes.fromhex(node))
        except Exception:
            raise CommandParamError(
                "parameter 'node' must be a hex-encoded PublicKey XDR "
                "or a G... strkey, got %r" % node)

    def cmd_bans(self, params) -> dict:
        """BanManager operator surface :
        `bans[?action=list|unban|unban_all]` — list the banned node ids
        (flood-control escalation and `droppeer?ban=1` feed this set),
        lift one ban (`action=unban&node=<hex-or-strkey>`), or clear
        them all. Bad params are 400s via CommandParamError."""
        bm = self.app.overlay_manager.ban_manager
        action = params.get("action", "list")
        if action == "list":
            return {"bans": bm.banned()}
        if action == "unban":
            bm.unban_node(self._parse_node_param(params.get("node", "")))
            return {"status": "ok", "bans": bm.banned()}
        if action == "unban_all":
            n = bm.unban_all()
            return {"status": "ok", "unbanned": n, "bans": bm.banned()}
        raise CommandParamError(
            "parameter 'action' must be list|unban|unban_all, got %r"
            % action)

    def cmd_unban(self, params) -> dict:
        bm = self.app.overlay_manager.ban_manager
        bm.unban_node(self._parse_node_param(params.get("node", "")))
        return {"status": "ok"}

    # -- survey / load -------------------------------------------------------
    def cmd_surveytopology(self, params) -> dict:
        """Start (or extend) a topology survey (reference
        `surveytopology`)."""
        sm = self.app.overlay_manager.survey_manager
        duration = float(params.get("duration", 60))
        node = params.get("node")
        sm.start_survey(duration)
        if node:
            from ..xdr import PublicKey
            sm.add_node_to_backlog(
                PublicKey.ed25519(bytes.fromhex(node)))
        return {"status": "started", "duration": duration}

    def cmd_stopsurvey(self, params) -> dict:
        self.app.overlay_manager.survey_manager.stop_survey()
        return {"status": "stopped"}

    def cmd_getsurveyresult(self, params) -> dict:
        sm = self.app.overlay_manager.survey_manager
        # "stats" is the compact shape the fleet aggregator stores for
        # every node (util/fleet.py add_http mirrors add_app.get_stats)
        return {**sm.get_results(), "stats": sm.get_stats()}

    def cmd_loadinfo(self, params) -> dict:
        return {"load": self.app.overlay_manager.load_manager
                .get_json_info()}

    # -- maintenance / cursors ----------------------------------------------
    def cmd_maintenance(self, params) -> dict:
        count = int(params.get("count", 50000))
        n = self.app.maintainer.perform_maintenance(count) \
            if self.app.maintainer else 0
        return {"status": "ok", "rows_deleted": n}

    def cmd_setcursor(self, params) -> dict:
        self.app.external_queue.set_cursor(params["id"],
                                           int(params["cursor"]))
        return {"status": "ok"}

    def cmd_getcursor(self, params) -> dict:
        rid = params.get("id")
        return self.app.external_queue.get_cursors(rid)

    def cmd_dropcursor(self, params) -> dict:
        self.app.external_queue.delete_cursor(params["id"])
        return {"status": "ok"}

    # -- test-only -----------------------------------------------------------
    def _require_test_mode(self):
        """Gate shared by every test-only endpoint."""
        if not self.app.config.ARTIFICIALLY_GENERATE_LOAD_FOR_TESTING:
            return {"error":
                    "set ARTIFICIALLY_GENERATE_LOAD_FOR_TESTING to use"}
        return None

    @staticmethod
    def _named_test_key(name: str):
        """reference txtest::getAccount (TxTests.cpp:379): the name
        stretched with '.' to a 32-byte seed; "root" is the network
        root key."""
        from ..crypto.keys import SecretKey
        seed = name.encode()
        seed += b"." * (32 - len(seed)) if len(seed) < 32 else b""
        return SecretKey.from_seed(seed[:32])

    def _test_key_for(self, name: str):
        if name == "root":
            return self.app.network_root_key()
        return self._named_test_key(name)

    def cmd_testacc(self, params) -> dict:
        """reference CommandHandler::testAcc (test-only,
        CommandHandler.cpp:103-105): balance/seqnum of a name-derived
        test account."""
        gated = self._require_test_mode()
        if gated is not None:
            return gated
        name = params.get("name")
        if not name:
            return {"status": "error",
                    "detail": "Bad HTTP GET: try testacc?name=bob"}
        from ..crypto import strkey
        from ..xdr import LedgerKey
        key = self._test_key_for(name)
        e = self.app.ledger_manager.ltx_root().get_entry(
            LedgerKey.account(key.public_key))
        if e is None:
            return {"status": "error", "detail": "account does not exist"}
        ae = e.data.value
        return {"name": name,
                "id": strkey.encode_public_key(ae.accountID.key_bytes),
                "balance": ae.balance, "seqnum": ae.seqNum}

    def cmd_testtx(self, params) -> dict:
        """reference CommandHandler::testTx (test-only): submit a payment
        (or create-account with create=true) between name-derived test
        accounts."""
        gated = self._require_test_mode()
        if gated is not None:
            return gated
        frm, to = params.get("from"), params.get("to")
        amount = params.get("amount")
        if not (frm and to and amount):
            return {"status": "error",
                    "detail": "try testtx?from=root&to=bob&amount=N"
                              "[&create=true]"}
        from ..crypto import strkey
        from ..testing import AppLedgerAdapter, TestAccount
        ad = AppLedgerAdapter(self.app)
        from_acct = TestAccount(ad, self._test_key_for(frm))
        to_key = self._test_key_for(to)
        amt = int(amount)
        if params.get("create") == "true":
            op = from_acct.op_create_account(to_key.public_key, amt)
        else:
            op = from_acct.op_payment(to_key.public_key, amt)
        frame = from_acct.tx([op])
        status = self.app.submit_transaction(frame)
        return {"from_name": frm, "to_name": to,
                "from_id": strkey.encode_public_key(
                    from_acct.account_id.key_bytes),
                "to_id": strkey.encode_public_key(
                    to_key.public_key.key_bytes),
                "amount": amt, "create": params.get("create") == "true",
                "status": int(status)}

    def cmd_generateload(self, params) -> dict:
        """reference CommandHandler.cpp:103 (test-only)."""
        gated = self._require_test_mode()
        if gated is not None:
            return gated
        lg = self.app.load_generator
        accounts = int(params.get("accounts", 10))
        txs = int(params.get("txs", 10))
        if accounts:
            lg.generate_accounts(accounts)
        if txs:
            lg.generate_payments(txs)
        return lg.status()

    # -- HTTP front-end ------------------------------------------------------
    def start_http(self, port: Optional[int] = None) -> int:
        """Serve the admin API; returns the bound port. Handlers hop to the
        main loop and wait (bounded) for the result."""
        app = self
        clock = self.app.clock
        public = self.app.config.PUBLIC_HTTP_PORT
        host = "" if public else "127.0.0.1"

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:
                u = urlparse(self.path)
                name = u.path.strip("/")
                params = {k: v[0] for k, v in parse_qs(u.query).items()}
                done = threading.Event()
                result: list = [None]

                def run() -> None:
                    result[0] = app.handle_command(name, params)
                    done.set()

                clock.post_to_main(run)
                if not done.wait(timeout=30.0):
                    self._reply(504, {"error": "main loop busy"})
                    return
                status, body = result[0]
                self._reply(status, body)

            def _reply(self, status: int, body) -> None:
                if isinstance(body, str):
                    # Prometheus exposition (and any future text body):
                    # version=0.0.4 is the text-format content type
                    # scrapers negotiate on
                    data = body.encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                else:
                    data = json.dumps(body, indent=1).encode()
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, fmt, *args) -> None:
                pass  # route through our logger, not stderr

        port = port if port is not None else self.app.config.HTTP_PORT
        try:
            self._server = ThreadingHTTPServer((host, port), Handler)
        except OSError:
            self._server = ThreadingHTTPServer((host, 0), Handler)
        bound = self._server.server_address[1]
        self.app.config.HTTP_PORT = bound
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info("admin HTTP API on port %d", bound)
        return bound

    def stop_http(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
