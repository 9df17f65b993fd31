"""Thread-discipline runtime checks: affinity assertions, the registry
of worker threads and a debug lock-order checker.

Copied from `stellar_core_tpu/util/threads.py` at commit 89bbd6f (the
`crypto.verify-dispatch` entry at a29fd1b, the `crypto.hash-*` entries at
abe2377); carry a fix in either copy to the other. Left out:
`crypto.cpu-verify-shard`, the reference's CPU verify sharding thread,
which the port's C verifier does not start. `process.reaper` is the
port's name for the reference ProcessManager's unnamed reaper threads.
Deliberately different: an unregistered `spawn_worker` raises
AssertionError explicitly (the reference's `assert`, which `python -O`
would strip).

Everything here is a near-no-op until armed. The node's crank thread
arms it, tests arm it around a case, and production can opt in with
SCT_THREAD_CHECKS=1.

- `WORKER_THREAD_REGISTRY` + `spawn_worker(name, target)`: every worker
  the port starts is spawned through one factory under a registered
  name, so the set of threads that may exist is a reviewable list.
- `@main_thread_only` marks a ledger mutation entry point (the bucket
  manager's `add_batch`, the herder's and SCP's entry points): it
  registers the function's qualname and, once `arm()` has bound a main
  thread, raises `ThreadDisciplineError` when another thread calls it.
- `TrackedLock` wraps `threading.Lock` with acquisition-order tracking:
  the process-wide order graph gains an edge A->B the first time a
  thread acquires B while holding A; an edge that closes a cycle raises
  `LockOrderError` carrying both acquisition stacks.
"""

from __future__ import annotations

import functools
import threading
import traceback
from typing import Callable, Dict, List, Optional, Set

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


def register_worker_thread(name: str, description: str) -> None:
    """Register an additional worker-thread entry point (subsystems
    outside crypto add theirs at import time)."""
    WORKER_THREAD_REGISTRY[name] = description


def spawn_worker(name: str, target: Callable[[], None],
                 daemon: bool = True) -> threading.Thread:
    """Start a named worker thread; `name` must be registered in
    WORKER_THREAD_REGISTRY (an unregistered spawn is a programming
    error)."""
    if name not in WORKER_THREAD_REGISTRY:
        raise AssertionError(
            "worker thread %r is not in WORKER_THREAD_REGISTRY — register "
            "it (with a description) before spawning" % name)
    t = threading.Thread(target=target, name=name, daemon=daemon)
    t.start()
    return t


class ThreadDisciplineError(AssertionError):
    """A worker thread called a main-thread-only entry point."""


class LockOrderError(AssertionError):
    """Two locks were acquired in both orders somewhere in the process:
    a latent deadlock even if the two threads never actually race."""


def arm(main_thread: Optional[threading.Thread] = None) -> None:
    """Enable affinity + lock-order checks; binds `main_thread` (default: the
    calling thread) as THE consensus thread. Re-arming rebinds."""
    global _armed, _main_thread
    _main_thread = main_thread or threading.current_thread()
    _armed = True


def disarm() -> None:
    global _armed, _main_thread
    _armed = False
    _main_thread = None
    _lock_order.reset()


def is_armed() -> bool:
    return _armed


def bound_main_thread() -> Optional[threading.Thread]:
    return _main_thread


def is_main_thread() -> bool:
    return threading.current_thread() is (_main_thread or
                                          threading.main_thread())


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


# --------------------------------------------------------------------------
# Lock-order checker


class _LockOrderGraph:
    """Process-wide acquisition-order graph over TrackedLock names.

    Nodes are lock names; a directed edge A->B means "some thread
    acquired B while holding A". The first acquisition that would make
    B reach A (a cycle) raises. Stacks are only captured when an edge is
    first added, so steady-state tracked acquires cost two dict hits.
    """

    def __init__(self) -> None:
        self._mutex = threading.Lock()   # guards the graph itself
        self._edges: Dict[str, Set[str]] = {}
        self._edge_stacks: Dict[tuple, str] = {}
        self._held = threading.local()   # per-thread stack of lock names

    def reset(self) -> None:
        with self._mutex:
            self._edges.clear()
            self._edge_stacks.clear()

    def _holding(self) -> List[str]:
        h = getattr(self._held, "stack", None)
        if h is None:
            h = self._held.stack = []
        return h

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """Shortest established-order path src -> ... -> dst, or None."""
        seen = {src}
        frontier: List[List[str]] = [[src]]
        while frontier:
            path = frontier.pop(0)
            n = path[-1]
            if n == dst:
                return path
            for nxt in sorted(self._edges.get(n, ())):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(path + [nxt])
        return None

    def note_acquire(self, name: str) -> None:
        held = self._holding()
        if held:
            prev = held[-1]
            if prev != name:
                with self._mutex:
                    out = self._edges.setdefault(prev, set())
                    if name not in out:
                        # new edge: cycle-check before committing it
                        path = self._find_path(name, prev)
                        if path is not None:
                            here = "".join(traceback.format_stack(limit=16))
                            msg = [
                                "lock-order inversion: acquiring %r while "
                                "holding %r, but the order %s was already "
                                "established."
                                % (name, prev, " -> ".join(path)),
                                "--- current acquisition (%r after %r) ---"
                                % (name, prev), here]
                            # each established hop's recorded stack —
                            # for a 2-cycle that is THE conflicting
                            # acquisition; for longer cycles every link
                            # that closes the loop
                            for a, b in zip(path, path[1:]):
                                msg.append(
                                    "--- established order (%r after %r) "
                                    "recorded at ---" % (b, a))
                                msg.append(self._edge_stacks.get(
                                    (a, b),
                                    "<stack unavailable>"))
                            raise LockOrderError("\n".join(msg))
                        out.add(name)
                        self._edge_stacks[(prev, name)] = "".join(
                            traceback.format_stack(limit=16))
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self._holding()
        # release order need not be LIFO; drop the most recent entry
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break


_lock_order = _LockOrderGraph()


def lock_order_graph() -> _LockOrderGraph:
    return _lock_order


class TrackedLock:
    """`threading.Lock` with optional acquisition-order tracking.

    Disarmed cost is one module-global bool check on top of the raw lock
    (the overhead-guard test in tests/test_threads.py keeps it honest),
    so hot locks — the verify cache, the threaded verifier's pending
    queue, the TCP reactor — can stay tracked permanently.
    """

    __slots__ = ("name", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _armed:
            _lock_order.note_acquire(self.name)
            try:
                got = self._lock.acquire(blocking, timeout)
            except BaseException:
                _lock_order.note_release(self.name)
                raise
            if not got:
                _lock_order.note_release(self.name)
            return got
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        self._lock.release()
        # unconditional (not gated on _armed): a disarm between an armed
        # acquire and this release must not leak a stale held-stack
        # entry into the thread's local state; with an empty stack this
        # is one getattr + an empty loop
        _lock_order.note_release(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# production opt-in: the checks are process-lifetime cheap, but default
# off so a bare library import stays side-effect-free
import os as _os  # noqa: E402

if _os.environ.get("SCT_THREAD_CHECKS") == "1":
    arm(threading.main_thread())
