"""HistoryArchive: remote file store reached through operator shell
commands, and the failover pool over several of them.

Copied from `stellar_core_tpu/history/archive.py` at commit a09415e;
carry a fix in either copy to the other.

Role parity: reference `src/history/HistoryArchive.{h,cpp}` +
`history/readme.md:1-30` — an archive is configured as `get`/`put`/`mkdir`
command templates ({0}=remote path, {1}=local path for get; {0}=local,
{1}=remote for put), so operators plug in curl/aws/cp. Layout
(reference FileTransferInfo.cpp): `<category>/<aa>/<bb>/<cc>/
<category>-<hex8>.xdr.gz` where hex8 is the checkpoint ledger and
aa/bb/cc are its first three hex bytes; HistoryArchiveState JSON at
`.well-known/stellar-history.json` and
`history/<aa>/<bb>/<cc>/history-<hex8>.json`.
"""

from __future__ import annotations

import os
import shlex
import subprocess
from typing import Callable, Dict, List, Optional, Sequence

from ..util.log import get_logger
from ..util.timer import real_monotonic

log = get_logger("History")


def hex8(n: int) -> str:
    return "%08x" % n


def category_path(category: str, checkpoint: int, suffix: str) -> str:
    h = hex8(checkpoint)
    return "%s/%s/%s/%s/%s-%s%s" % (category, h[0:2], h[2:4], h[4:6],
                                    category, h, suffix)


def bucket_path(hash_hex: str) -> str:
    return "bucket/%s/%s/%s/bucket-%s.xdr.gz" % (
        hash_hex[0:2], hash_hex[2:4], hash_hex[4:6], hash_hex)


WELL_KNOWN = ".well-known/stellar-history.json"


class HistoryArchive:
    """One configured archive. Commands run as subprocesses (reference
    runs them through ProcessManager); a plain directory path works too
    (file archive: cp/mkdir fallbacks)."""

    def __init__(self, name: str, get_tmpl: str = "", put_tmpl: str = "",
                 mkdir_tmpl: str = "") -> None:
        self.name = name
        self.get_tmpl = get_tmpl
        self.put_tmpl = put_tmpl
        self.mkdir_tmpl = mkdir_tmpl

    @classmethod
    def from_config(cls, name: str, d: dict) -> "HistoryArchive":
        return cls(name, d.get("get", ""), d.get("put", ""),
                   d.get("mkdir", ""))

    @classmethod
    def local_dir(cls, name: str, root: str) -> "HistoryArchive":
        """file:// archive rooted at a directory (the reference test
        archives use exactly this shape)."""
        root = os.path.abspath(root)
        return cls(name,
                   get_tmpl="cp %s/{0} {1}" % shlex.quote(root),
                   put_tmpl="cp {0} %s/{1}" % shlex.quote(root),
                   mkdir_tmpl="mkdir -p %s/{0}" % shlex.quote(root))

    def has_get(self) -> bool:
        return bool(self.get_tmpl)

    def has_put(self) -> bool:
        return bool(self.put_tmpl)

    # -- command builders (used by history works) ----------------------------
    def get_cmd(self, remote: str, local: str) -> str:
        return self.get_tmpl.replace("{0}", shlex.quote(remote)) \
                            .replace("{1}", shlex.quote(local))

    def put_cmd(self, local: str, remote: str) -> str:
        return self.put_tmpl.replace("{0}", shlex.quote(local)) \
                            .replace("{1}", shlex.quote(remote))

    def mkdir_cmd(self, remote_dir: str) -> str:
        return self.mkdir_tmpl.replace("{0}", shlex.quote(remote_dir))

    # -- synchronous conveniences (CLI paths, tests) -------------------------
    def get_file_sync(self, remote: str, local: str) -> bool:
        cmd = self.get_cmd(remote, local)
        r = subprocess.run(cmd, shell=True, capture_output=True)
        return r.returncode == 0

    def put_file_sync(self, local: str, remote: str) -> bool:
        if self.mkdir_tmpl:
            d = os.path.dirname(remote)
            if d:
                subprocess.run(self.mkdir_cmd(d), shell=True,
                               capture_output=True)
        r = subprocess.run(self.put_cmd(local, remote), shell=True,
                           capture_output=True)
        return r.returncode == 0


class _ArchiveHealth:
    """Per-archive failure bookkeeping inside an ArchivePool."""

    __slots__ = ("successes", "failures", "consecutive_failures",
                 "next_attempt", "last_error_at")

    def __init__(self) -> None:
        self.successes = 0
        self.failures = 0
        self.consecutive_failures = 0
        self.next_attempt = 0.0
        self.last_error_at = 0.0

    def score(self) -> float:
        """Success fraction, optimistic for the untried (a fresh archive
        should be probed before a known-flaky one is retried)."""
        total = self.successes + self.failures
        return (self.successes + 1.0) / (total + 1.0)

    def to_json(self) -> dict:
        return {"successes": self.successes, "failures": self.failures,
                "consecutive_failures": self.consecutive_failures,
                "score": round(self.score(), 3),
                "next_attempt": self.next_attempt}


class ArchivePool:
    """Multi-archive failover for history downloads (docs/robustness.md).

    Tracks a health score per archive and an exponential backoff on
    consecutive failures; `pick()` returns the healthiest archive that
    is not backing off, excluding names the caller already tried for the
    current file. When every archive is excluded or backing off it
    returns the least-bad one anyway — liveness beats politeness when
    the whole archive set is flaky. Works that hold a pool re-pick on
    every retry, so a corrupt or short download from archive A is
    re-fetched from archive B."""

    BACKOFF_BASE = 2.0
    BACKOFF_CAP = 300.0

    def __init__(self, archives: Sequence[HistoryArchive],
                 now_fn: Optional[Callable[[], float]] = None,
                 metrics=None) -> None:
        self.archives: List[HistoryArchive] = list(archives)
        self._by_name: Dict[str, HistoryArchive] = {
            a.name: a for a in self.archives}
        self._health: Dict[str, _ArchiveHealth] = {
            a.name: _ArchiveHealth() for a in self.archives}
        self._now = now_fn or real_monotonic
        self.metrics = metrics
        self.failovers = 0

    # a pool quacks enough like an archive for works that only read gets
    def has_get(self) -> bool:
        return any(a.has_get() for a in self.archives)

    def health(self, name: str) -> _ArchiveHealth:
        return self._health[name]

    def pick(self, exclude: Sequence[str] = ()) -> Optional[HistoryArchive]:
        if not self.archives:
            return None
        now = self._now()
        ex = set(exclude)
        ready = [a for a in self.archives
                 if a.name not in ex
                 and self._health[a.name].next_attempt <= now]
        if ready:
            best = max(ready, key=lambda a: (self._health[a.name].score(),
                                             a.name))
            return best
        # everyone tried or backing off: least consecutive failures wins
        # (ignore both the exclusion and the backoff rather than stall)
        return min(self.archives,
                   key=lambda a: (self._health[a.name].consecutive_failures,
                                  a.name))

    def report_success(self, archive: HistoryArchive) -> None:
        h = self._health.get(archive.name)
        if h is None:
            return
        h.successes += 1
        h.consecutive_failures = 0
        h.next_attempt = 0.0

    def report_failure(self, archive: HistoryArchive) -> None:
        h = self._health.get(archive.name)
        if h is None:
            return
        h.failures += 1
        h.consecutive_failures += 1
        h.last_error_at = self._now()
        h.next_attempt = self._now() + min(
            self.BACKOFF_CAP,
            self.BACKOFF_BASE * (2.0 ** (h.consecutive_failures - 1)))
        if len(self.archives) > 1:
            self.failovers += 1
        if self.metrics is not None:
            self.metrics.new_meter(
                "history.archive.failure.%s" % archive.name).mark()
        log.warning("archive %s failed (%d consecutive); next attempt "
                    "in %.0fs", archive.name, h.consecutive_failures,
                    h.next_attempt - self._now())

    def to_json(self) -> dict:
        return {"archives": {n: h.to_json()
                             for n, h in sorted(self._health.items())},
                "failovers": self.failovers}
