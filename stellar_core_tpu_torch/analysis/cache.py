"""Content-addressed cache for sctlint's per-file work: parsed facts (ModuleFacts/FlowFacts/CFileFacts) and the
per-file rule findings computed from them, keyed by
(engine-digest, config-digest, path, content-sha) and stored as one
pickle per key under `stellar_core_tpu_torch/build/sctlint-cache/`.

Copied from `stellar_core_tpu/analysis/cache.py` at commit 94afec1;
carry a fix in either copy to the other. Nothing is changed but this
header and the cache's place, which `engine.default_config` names.

Keying discipline — every input that can change a file's findings is in
the key, so there is no explicit invalidation protocol at all:

- the file's own content (sha256);
- the ENGINE digest: sha256 over the sources of the analysis package
  itself, so editing any rule invalidates the whole cache (a linter
  that serves stale verdicts after a rule change is worse than a slow
  one);
- the CONFIG digest: the per-module knobs (enabled rules, e1/s1/fl1
  dirs, package name) — flipping a pyproject stanza re-lints.

Failure stance: the cache is an accelerator, never a correctness
dependency. Any OSError/pickle error on read counts as a miss; any
error on write is swallowed; a corrupt entry is deleted and recomputed.
Hit/miss counters are exported on AnalysisResult so tests assert the
warm-run speedup structurally (hits == files) instead of wall-clock.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional

_PICKLE_PROTO = 4


def file_digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def engine_digest() -> str:
    """Digest of the analysis package's own sources — rule edits
    invalidate every cached verdict."""
    here = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for fn in sorted(os.listdir(here)):
        if not fn.endswith(".py"):
            continue
        h.update(fn.encode("utf-8"))
        try:
            with open(os.path.join(here, fn), "rb") as fh:
                h.update(fh.read())
        except OSError:
            h.update(b"<unreadable>")
    return h.hexdigest()


class SctlintCache:
    """One pickle per (path, content, engine, config) key. `None` dir
    disables caching entirely (fixture runs stay hermetic)."""

    # entries kept before mtime-based pruning kicks in; the tree is a
    # few hundred files, so this allows ~8 generations of full-tree
    # churn before any eviction happens at all
    MAX_ENTRIES = 4096

    def __init__(self, cache_dir: Optional[str],
                 config_digest: str = "") -> None:
        self.dir = cache_dir
        self.hits = 0
        self.misses = 0
        self._prefix = ""
        if cache_dir is not None:
            self._prefix = engine_digest()[:16] + config_digest[:16]
            try:
                os.makedirs(cache_dir, exist_ok=True)
            except OSError:
                self.dir = None

    def key_for(self, rel_path: str, data: bytes) -> str:
        h = hashlib.sha256()
        h.update(self._prefix.encode("ascii"))
        h.update(rel_path.encode("utf-8"))
        h.update(b"\x00")
        h.update(data)
        return h.hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key + ".pkl")

    def get(self, key: str):
        """Cached object or None; every failure mode is a miss."""
        if self.dir is None:
            return None
        p = self._path(key)
        try:
            with open(p, "rb") as fh:
                obj = pickle.load(fh)
        except (OSError, pickle.UnpicklingError, EOFError,
                AttributeError, ImportError, IndexError, ValueError):
            try:
                if os.path.exists(p):
                    os.unlink(p)   # corrupt entry: recompute, re-store
            except OSError:
                pass
            self.misses += 1
            return None
        self.hits += 1
        return obj

    def put(self, key: str, obj) -> None:
        if self.dir is None:
            return
        p = self._path(key)
        tmp = p + ".tmp.%d" % os.getpid()
        try:
            with open(tmp, "wb") as fh:
                pickle.dump(obj, fh, protocol=_PICKLE_PROTO)
            os.replace(tmp, p)      # atomic: parallel runs never see torn
        except (OSError, pickle.PicklingError, TypeError):
            try:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            except OSError:
                pass

    def prune(self) -> None:
        """Drop oldest entries past MAX_ENTRIES (stale generations from
        edited files/engines accumulate; content-keying never reuses
        them, so they are pure disk waste)."""
        if self.dir is None:
            return
        try:
            names = [n for n in os.listdir(self.dir)
                     if n.endswith(".pkl")]
            if len(names) <= self.MAX_ENTRIES:
                return
            with_mtime = []
            for n in names:
                p = os.path.join(self.dir, n)
                try:
                    with_mtime.append((os.path.getmtime(p), p))
                except OSError:
                    pass
            with_mtime.sort()
            for _, p in with_mtime[:len(with_mtime) - self.MAX_ENTRIES]:
                try:
                    os.unlink(p)
                except OSError:
                    pass
        except OSError:
            pass
