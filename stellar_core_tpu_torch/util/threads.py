"""Named locks and the registry of worker threads.

Copied (`TrackedLock`, `WORKER_THREAD_REGISTRY`, `spawn_worker`) from
`stellar_core_tpu/util/threads.py` at commit 02ed56d (the
`crypto.verify-dispatch` entry at a29fd1b, the `crypto.hash-*` entries
at abe2377); carry a fix in
either copy to the other. The reference's lock-order checker and
main-thread affinity asserts are armed only by the node stack (its
consensus thread), which the port does not have yet; here a `TrackedLock`
is a `threading.Lock` that carries its name, so the lock graph reads the
same once the checker arrives.

- `WORKER_THREAD_REGISTRY` + `spawn_worker(name, target)`: every worker
  the port starts is spawned through one factory under a registered
  name, so the set of threads that may exist is a reviewable list.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

# name -> description of every worker thread the port may start
WORKER_THREAD_REGISTRY: Dict[str, str] = {
    "crypto.verify-dispatch":
        "ThreadedBatchVerifier dispatch: runs one flushed batch's "
        "verify_many off the main loop and posts the futures' completion "
        "back through clock.post_to_main (one short-lived thread per "
        "batch in flight)",
    "crypto.verify-staging":
        "CudaSigVerifier double-buffer staging: packs drain chunk K+1 "
        "into pinned host buffers and copies it to its members on their "
        "staging streams while the fleet runs chunk K (one short-lived "
        "job thread per staged chunk); launches no kernel",
    "crypto.verify-warmup":
        "CudaSigVerifier warmup: builds the verify kernel and launches "
        "zeros on every planned bucket's route",
    "crypto.hash-staging":
        "CudaBatchHasher double-buffer staging: FIPS-pads hash chunk K+1 "
        "into its pinned host buffer and copies it to the card on the "
        "staging stream while the kernel digests chunk K (one short-lived "
        "job thread per staged chunk, mirroring verify staging); launches "
        "no kernel",
    "crypto.hash-warmup":
        "CudaBatchHasher warmup: builds the SHA-256 kernel and launches "
        "zeros at every warm shape through the staging and launch path of "
        "live traffic",
}


def spawn_worker(name: str, target: Callable[[], None],
                 daemon: bool = True) -> threading.Thread:
    """Start a named worker thread; `name` must be registered in
    WORKER_THREAD_REGISTRY (an unregistered spawn is a programming
    error)."""
    if name not in WORKER_THREAD_REGISTRY:
        raise ValueError(
            "worker thread %r is not in WORKER_THREAD_REGISTRY — register "
            "it (with a description) before spawning" % name)
    t = threading.Thread(target=target, name=name, daemon=daemon)
    t.start()
    return t


class TrackedLock:
    """`threading.Lock` with a name (see the module docstring)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
