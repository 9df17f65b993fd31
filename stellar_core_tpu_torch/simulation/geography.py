"""Geographic latency profiles: seeded per-link latency matrices.

Copied from `stellar_core_tpu/simulation/geography.py` at commit 378eae4;
carry a fix in either copy to the other. Host code: nothing of it runs
on the card, and nothing is left out.

Role parity: the reference's Simulation connects loopback peers with
zero latency, so cross-region effects (externalize skew, straggler
regions, partition-heal convergence) are invisible; the
committee-consensus measurements (PAPERS.md, arXiv:2302.00418) show
commit latency at scale is dominated by exactly those effects. A
`LatencyMatrix` assigns every node a named region round-robin and draws
one deterministic per-link latency from the profile's intra/inter-region
band using a seeded stream — the same (seed, profile, node set) always
yields the same matrix, so scenario runs replay identically.

The matrix feeds `ChaosTransport.link_delay_s` (OVER_PEERS) or
`LoopbackChannel.latency_s` (OVER_LOOPBACK) via
`Simulation.apply_latency_matrix`; delays ride the sender's virtual
clock, so they are deterministic and free of wall time.
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Tuple

# name -> {regions, intra_ms (lo, hi), inter_ms (lo, hi)}
PROFILES: Dict[str, dict] = {
    # one datacenter: sub-millisecond everywhere
    "single-dc": {"regions": ["dc"],
                  "intra_ms": (0.1, 0.5), "inter_ms": (0.1, 0.5)},
    # three continents: fast inside a region, slow across
    "three-region": {"regions": ["us", "eu", "ap"],
                     "intra_ms": (1.0, 5.0), "inter_ms": (30.0, 120.0)},
    # five regions, long tails — the internet-scale shape
    "global": {"regions": ["us-east", "us-west", "eu", "ap", "sa"],
               "intra_ms": (1.0, 8.0), "inter_ms": (40.0, 180.0)},
}


class LatencyMatrix:
    """Seeded symmetric per-link latency assignment over named nodes."""

    def __init__(self, names: Iterable[str], profile: str = "three-region",
                 seed: int = 0) -> None:
        if profile not in PROFILES:
            raise ValueError("unknown latency profile %r; known: %s"
                             % (profile, ", ".join(sorted(PROFILES))))
        self.profile = profile
        self.seed = seed
        self._spec = PROFILES[profile]
        # per-matrix stream: one seed replays one matrix exactly,
        # independent of the global RNG state (D2: seeded, never ambient)
        self._rng = random.Random("geo:%d:%s" % (seed, profile))
        self.region: Dict[str, str] = {}
        self._lat: Dict[Tuple[str, str], float] = {}
        for n in sorted(names):
            self.ensure(n)

    def ensure(self, name: str) -> None:
        """Assign `name` a region (round-robin over the profile's list,
        in assignment order) and draw latencies to every known node —
        late-joining nodes get deterministic links too."""
        if name in self.region:
            return
        regions: List[str] = self._spec["regions"]
        self.region[name] = regions[len(self.region) % len(regions)]
        for other in sorted(self.region):
            if other == name:
                continue
            band = (self._spec["intra_ms"]
                    if self.region[other] == self.region[name]
                    else self._spec["inter_ms"])
            lo, hi = band
            key = (min(name, other), max(name, other))
            self._lat[key] = self._rng.uniform(lo, hi) / 1000.0

    def latency_s(self, a: str, b: str) -> float:
        """One-way link latency in seconds (symmetric); 0.0 for an
        unknown pair (e.g. a node outside the matrix)."""
        return self._lat.get((min(a, b), max(a, b)), 0.0)

    def to_json(self) -> dict:
        return {
            "profile": self.profile,
            "seed": self.seed,
            "regions": dict(self.region),
            "links_ms": {"%s|%s" % k: round(v * 1000.0, 3)
                         for k, v in sorted(self._lat.items())},
        }
