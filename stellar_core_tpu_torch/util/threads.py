"""Named locks, the registry of worker threads and the main-thread guard.

Copied (`TrackedLock`, `WORKER_THREAD_REGISTRY`, `spawn_worker`) from
`stellar_core_tpu/util/threads.py` at commit 02ed56d (the
`crypto.verify-dispatch` entry at a29fd1b, the `crypto.hash-*` entries
at abe2377, `catchup.prewarm-pipeline` at 89bbd6f; `main_thread_only`,
`assert_main_thread`, `arm`, `disarm` and `ThreadDisciplineError` at
89bbd6f); carry a fix in either copy to the other. `process.reaper` is
the port's name for the reference ProcessManager's unnamed reaper
threads. The reference's lock-order checker is armed only by the node
stack (its consensus thread), which the port does not
have yet; here a `TrackedLock` is a `threading.Lock` that carries its
name, so the lock graph reads the same once the checker arrives.

- `WORKER_THREAD_REGISTRY` + `spawn_worker(name, target)`: every worker
  the port starts is spawned through one factory under a registered
  name, so the set of threads that may exist is a reviewable list.
- `@main_thread_only` marks a ledger mutation entry point (the bucket
  manager's `add_batch`): it registers the function's qualname and, once
  `arm()` has bound a main thread, raises `ThreadDisciplineError` when
  another thread calls it. Unarmed it only forwards the call.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Optional

_armed = False
_main_thread: Optional[threading.Thread] = None

# qualname -> module of every @main_thread_only function
MAIN_THREAD_REGISTRY: Dict[str, str] = {}

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
    "catchup.prewarm-pipeline":
        "Pipelined catchup (C verifier with the apply engine only): "
        "verifies ledger N+1's signature triples (verifier.prewarm_many, "
        "which releases the interpreter lock in C) while the main thread "
        "applies ledger N; triples are collected on the main thread (no "
        "cross-thread ledger reads)",
    "process.reaper":
        "ProcessManager: waits on one subprocess (an archive's get, put or "
        "mkdir command) and posts its exit code back to the main loop "
        "through clock.post_to_main (one short-lived thread per running "
        "subprocess)",
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


class ThreadDisciplineError(AssertionError):
    """A worker thread called a main-thread-only entry point."""


def arm(main_thread: Optional[threading.Thread] = None) -> None:
    """Enable the affinity checks; binds `main_thread` (default: the
    calling thread) as THE consensus thread. Re-arming rebinds."""
    global _armed, _main_thread
    _main_thread = main_thread or threading.current_thread()
    _armed = True


def disarm() -> None:
    global _armed, _main_thread
    _armed = False
    _main_thread = None


def assert_main_thread(what: str = "") -> None:
    """Raise unless the caller is the bound main thread (no-op until
    armed). Mirrors reference `releaseAssert(threadIsMain())`."""
    if not _armed:
        return
    cur = threading.current_thread()
    if cur is not _main_thread:
        raise ThreadDisciplineError(
            "%s called from thread %r; ledger/consensus state may only "
            "be touched from the main thread %r (use clock.post_to_main)"
            % (what or "main-thread-only code", cur.name,
               _main_thread.name if _main_thread else "<unbound>"))


def main_thread_only(fn: Callable) -> Callable:
    """Mark + guard a consensus/ledger mutation entry point."""
    MAIN_THREAD_REGISTRY[fn.__qualname__] = fn.__module__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _armed and threading.current_thread() is not _main_thread:
            assert_main_thread(fn.__qualname__)
        return fn(*args, **kwargs)

    wrapper.__sct_main_thread_only__ = True
    return wrapper
