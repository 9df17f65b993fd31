"""Deterministic fault injection: named fault points with seeded
per-site schedules.

Copied (`KNOWN_SITES`, `InjectedFault`, `FaultSite`, `FaultInjector`
without its `SCT_FAULTS` spec parser and its `clear` / `configured`)
from `stellar_core_tpu/util/faults.py` at commit 02ed56d; carry a fix in
either copy to the other. Each site
draws from its own `random.Random("<seed>:<site>")` in the same order as
the reference, so one seed and one configuration fire on the same calls
on both stacks.

- `FaultInjector`: named fault points, each with a schedule
  (probability, max fire count, skip-first-N).
- Every injection is counted in metrics (`fault.injected.<site>`) and,
  with an enabled tracer, tagged on the innermost open span and emitted
  as an instant.

`should_fire(site)` on an unconfigured site is one dict miss.
"""

from __future__ import annotations

import logging
import random
from typing import Dict, Optional

log = logging.getLogger(__name__)

# The reference's site registry, so a name armed on one stack is known on
# the other; the port's verifier checks verify.device-lost and
# verify.staging-stall.
KNOWN_SITES = frozenset({
    "device.dispatch",
    "verify.device-lost",
    "verify.staging-stall",
    "hash.device-lost",
    "hash.dispatch-fail",
    "commitment.sign-fail",
    "overlay.drop",
    "overlay.delay",
    "overlay.duplicate",
    "overlay.reorder",
    "overlay.flood-limit",
    "overlay.send-overflow",
    "archive.get-fail",
    "archive.corrupt",
    "archive.short-read",
    "apply.cluster-fail",
    "apply.pipeline-stall",
    "bucketdb.index-corrupt",
    "bucketdb.read-fail",
    "ingress.admit-stall",
    "ingress.shed-storm",
})


class InjectedFault(Exception):
    """Raised by call sites that turn a fired fault point into an
    exception (`fire_point`)."""


class FaultSite:
    """Schedule for one named fault point."""

    __slots__ = ("name", "probability", "remaining", "skip", "rng",
                 "fired", "evaluated")

    def __init__(self, name: str, probability: float = 1.0,
                 count: Optional[int] = None, after: int = 0,
                 seed: int = 0) -> None:
        self.name = name
        self.probability = probability
        self.remaining = count          # None = unlimited
        self.skip = after               # evaluations to pass through first
        # per-site stream: adding/removing one site never shifts another
        # site's schedule (str seeding is stable across processes)
        self.rng = random.Random("%d:%s" % (seed, name))
        self.fired = 0
        self.evaluated = 0

    def to_json(self) -> dict:
        return {"probability": self.probability,
                "remaining": self.remaining, "skip": self.skip,
                "fired": self.fired, "evaluated": self.evaluated}


class FaultInjector:
    """Registry of fault points; see module docstring."""

    def __init__(self, seed: int = 0, metrics=None, tracer=None) -> None:
        self.seed = seed
        self.metrics = metrics
        self.tracer = tracer
        self._sites: Dict[str, FaultSite] = {}

    def configure(self, name: str, probability: float = 1.0,
                  count: Optional[int] = None, after: int = 0) -> FaultSite:
        if name not in KNOWN_SITES:
            log.warning("arming fault site %r not in KNOWN_SITES — no code "
                        "checks it, so it will never fire", name)
        site = FaultSite(name, probability, count, after, seed=self.seed)
        self._sites[name] = site
        log.info("fault point %s armed: p=%g count=%s after=%d",
                 name, probability, count, after)
        return site

    # -- the hot check -------------------------------------------------------
    def should_fire(self, name: str) -> bool:
        site = self._sites.get(name)
        if site is None:
            return False
        site.evaluated += 1
        if site.skip > 0:
            site.skip -= 1
            return False
        if site.remaining is not None and site.remaining <= 0:
            return False
        if site.probability < 1.0 and site.rng.random() >= site.probability:
            return False
        if site.remaining is not None:
            site.remaining -= 1
        site.fired += 1
        self._mark(site)
        return True

    def fire_point(self, name: str) -> None:
        """`should_fire` + raise: for sites whose effect is an exception."""
        if self.should_fire(name):
            raise InjectedFault(name)

    def _mark(self, site: FaultSite) -> None:
        if self.metrics is not None:
            self.metrics.new_meter("fault.injected.%s" % site.name).mark()
        t = self.tracer
        if t is not None and t.enabled:
            # tag the innermost open span (the operation the fault landed
            # in) and drop an instant so the timeline shows the injection
            stack = t._stack()
            if stack:
                stack[-1].set_tag("fault", site.name)
            t.instant("fault.%s" % site.name, cat="fault",
                      fired=site.fired)

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "sites": {n: s.to_json()
                          for n, s in sorted(self._sites.items())}}
