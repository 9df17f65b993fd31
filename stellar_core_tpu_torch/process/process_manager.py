"""ProcessManager: async subprocess execution ("async system()").

Copied from `stellar_core_tpu/process/process_manager.py` at commit
63f3249; carry a fix in either copy to the other. Deliberately different:
the reaper threads are spawned through `util/threads.spawn_worker` under
the registered name `process.reaper`.

Role parity: reference `src/process/ProcessManager{.h,Impl.cpp}:33-553` —
bounded-concurrency subprocess runner; completion events delivered on the
main loop. Python subprocess.Popen + a reaper thread replaces the
fork/exec + SIGCHLD machinery.
"""

from __future__ import annotations

import shlex
import subprocess
import threading
from collections import deque
from typing import Callable, Deque, List, Optional

from ..util.log import get_logger
from ..util.threads import spawn_worker
from ..util.timer import VirtualClock

log = get_logger("Process")


class ProcessExitEvent:
    """Completion handle: register a callback receiving the exit code."""

    def __init__(self, cmd: str) -> None:
        self.cmd = cmd
        self.exit_code: Optional[int] = None
        self._cbs: List[Callable[[int], None]] = []
        self._popen: Optional[subprocess.Popen] = None
        self.cancelled = False

    def add_done_callback(self, cb: Callable[[int], None]) -> None:
        if self.exit_code is not None:
            cb(self.exit_code)
        else:
            self._cbs.append(cb)

    def _complete(self, code: int) -> None:
        self.exit_code = code
        cbs, self._cbs = self._cbs, []
        for cb in cbs:
            cb(code)


class ProcessManager:
    def __init__(self, clock: VirtualClock,
                 max_concurrent: int = 16) -> None:
        self.clock = clock
        self.max_concurrent = max_concurrent
        self._queue: Deque[ProcessExitEvent] = deque()
        self._running: List[ProcessExitEvent] = []
        self._lock = threading.Lock()
        self._shutdown = False

    def run_process(self, cmd: str,
                    out_file: Optional[str] = None) -> ProcessExitEvent:
        ev = ProcessExitEvent(cmd)
        ev._out_file = out_file
        with self._lock:
            self._queue.append(ev)
        self._maybe_start()
        return ev

    def num_running(self) -> int:
        with self._lock:
            return len(self._running)

    def _maybe_start(self) -> None:
        with self._lock:
            while (len(self._running) < self.max_concurrent and
                   self._queue and not self._shutdown):
                ev = self._queue.popleft()
                if ev.cancelled:
                    continue
                try:
                    stdout = (open(ev._out_file, "wb")
                              if ev._out_file else subprocess.DEVNULL)
                    ev._popen = subprocess.Popen(
                        shlex.split(ev.cmd), stdout=stdout,
                        stderr=subprocess.DEVNULL)
                except Exception as e:
                    log.warning("spawn failed: %s (%s)", ev.cmd, e)
                    self.clock.post_to_main(lambda e=ev: e._complete(127))
                    continue
                self._running.append(ev)
                spawn_worker("process.reaper",
                             lambda ev=ev: self._reap(ev))

    def _reap(self, ev: ProcessExitEvent) -> None:
        code = ev._popen.wait()
        if getattr(ev, "_out_file", None) and ev._popen.stdout:
            try:
                ev._popen.stdout.close()
            except Exception:
                pass
        with self._lock:
            if ev in self._running:
                self._running.remove(ev)
        self.clock.post_to_main(lambda: ev._complete(code))
        self._maybe_start()

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._queue.clear()
            for ev in self._running:
                try:
                    ev._popen.terminate()
                except Exception:
                    pass
