"""Node footprint census (docs/observability.md#node-footprint).

Copied from `stellar_core_tpu/util/footprint.py` at commit a6220d9; carry
a fix in either copy to the other. Nothing is left out.

Every bounded structure in the process (hop rings, LRU caches, ingress
intake and source buckets, the tx-lifecycle tracker, slot timelines, SCP
per-slot state, peer send queues) registers with a
`BoundedStructRegistry` and self-reports occupancy / capacity /
approximate bytes, alongside process-level RSS, thread count and fd
count read from `/proc` (stdlib only — no psutil).

Registration discipline: `track_struct` call sites use LITERAL
structure names — the reference's M1 lint scanner catalogs them exactly
like `new_*` metric registrations (as `footprint.struct.<name>` rows in
docs/metrics.md), so registering a structure without documenting it
fails the gate.

Consumers:

- admin `footprint` endpoint (`to_json`) — the per-node overhead table;
- the metrics registry (`footprint.*` names → `sct_footprint_*` in the
  Prometheus exposition);
- the fleet view: util/fleet.py merges per-node `fleet_json()` blobs
  into the fleet overhead table.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Optional

from .metrics import MetricsRegistry
from .threads import TrackedLock
from .timer import real_monotonic


def process_stats() -> dict:
    """Process-level footprint from /proc (Linux; ru_maxrss fallback):
    resident set in MB, live thread count, open fd count (-1 when
    /proc/self/fd is unreadable)."""
    rss_kb = 0
    try:
        with open("/proc/self/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    rss_kb = int(line.split()[1])
                    break
    except (OSError, ValueError, IndexError):
        try:
            import resource
            # ru_maxrss is the high-water mark, not current RSS — an
            # over-estimate is still a usable scaling signal
            rss_kb = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        except (ImportError, OSError, ValueError):
            rss_kb = 0
    try:
        fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        fds = -1
    return {"rss_mb": round(rss_kb / 1024.0, 3),
            "threads": threading.active_count(),
            "fds": fds}


class BoundedStructRegistry:
    """The census: named bounded structures self-report occupancy /
    capacity / approx bytes through registered callables; `census()`
    snapshots them all plus the process stats. A structure whose
    callbacks raise (owner torn down mid-run) reports an `error` field
    instead of killing the census."""

    MAX_STRUCTS = 256   # registrations retained (the census's own bound)

    def __init__(self, metrics=None, now_fn=None,
                 node_name: str = "") -> None:
        self._now = now_fn or real_monotonic
        # a private registry when none is injected keeps direct
        # constructions (tests, harnesses) app-registry-free while
        # letting every registration below use the new_* idiom the M1
        # metric-catalog scanner keys on
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(now_fn=self._now)
        self.node_name = node_name
        self._lock = TrackedLock("util.footprint")
        m = self.metrics
        self._g_structs = m.new_gauge("footprint.structs")
        self._g_rss = m.new_gauge("footprint.rss-mb")
        self._g_threads = m.new_gauge("footprint.threads")
        self._g_fds = m.new_gauge("footprint.fds")
        self._g_occ: Dict[str, object] = {}
        self._structs: Dict[str, dict] = {}
        self.dropped_registrations = 0

    # -- registration --------------------------------------------------------
    def track_struct(self, name: str, kind: str,
                     capacity_fn: Callable[[], int],
                     occupancy_fn: Callable[[], int],
                     bytes_fn: Optional[Callable[[], int]] = None) -> bool:
        """Register one bounded structure. Call sites pass a LITERAL
        `name` — the M1 scanner catalogs it as `footprint.struct.<name>`
        against docs/metrics.md. Re-registering a name replaces the
        callbacks (a node restart re-wires the same structures).
        Returns False past MAX_STRUCTS (the census stays bounded)."""
        with self._lock:
            if name not in self._structs and \
                    len(self._structs) >= self.MAX_STRUCTS:
                self.dropped_registrations += 1
                return False
            self._structs[name] = {"kind": kind, "capacity": capacity_fn,
                                   "occupancy": occupancy_fn,
                                   "bytes": bytes_fn}
            if name not in self._g_occ:
                self._g_occ[name] = self.metrics.new_gauge(
                    "footprint.struct.%s" % name)
            self._g_structs.set(len(self._structs))
        return True

    # -- census --------------------------------------------------------------
    def census(self) -> dict:
        """Snapshot every registered structure + the process stats.
        `over_capacity` lists structures whose occupancy exceeds their
        own declared cap — always empty unless a bound is broken (the
        footprint soak test and validate_footprint assert exactly
        that)."""
        with self._lock:
            items = list(self._structs.items())
        structs: Dict[str, dict] = {}
        over = []
        approx_total = 0
        for name, fns in items:
            entry: dict = {"kind": fns["kind"]}
            try:
                occ = int(fns["occupancy"]())
                cap = int(fns["capacity"]())
                entry["occupancy"] = occ
                entry["capacity"] = cap
                if fns["bytes"] is not None:
                    b = int(fns["bytes"]())
                    entry["approx_bytes"] = b
                    approx_total += b
                if 0 <= cap < occ:
                    over.append(name)
            except Exception as e:
                # the owner may have been torn down (node stop in a
                # simulation) — report, don't crash the census
                entry["error"] = repr(e)
            structs[name] = entry
            g = self._g_occ.get(name)
            if g is not None and "occupancy" in entry:
                g.set(entry["occupancy"])
        proc = process_stats()
        self._g_rss.set(proc["rss_mb"])
        self._g_threads.set(proc["threads"])
        self._g_fds.set(max(0, proc["fds"]))
        return {"structs": structs, "process": proc,
                "over_capacity": over,
                "approx_bytes_total": approx_total,
                "dropped_registrations": self.dropped_registrations}

    # -- exports -------------------------------------------------------------
    def to_json(self) -> dict:
        """The admin `footprint` blob — one node's overhead table."""
        return {"node": self.node_name, **self.census()}

    def fleet_json(self) -> dict:
        """Compact per-node export FleetAggregator merges into the
        fleet overhead table (one shape for in-process `add_app` and
        HTTP `add_http` intake — identical to `to_json` by design)."""
        return self.to_json()
