"""Overlay transports: loopback pipes and real TCP sockets.

Copied from `stellar_core_tpu/overlay/transport.py` at commit 378eae4;
carry a fix in either copy to the other. Nothing is left out. The reactor
is a thread of its own (`overlay-io`) that posts each frame to the owning
node's clock.

Role parity:
- LoopbackTransport ↔ reference `src/overlay/test/LoopbackPeer.{h,cpp}`:
  paired in-memory queues between two Applications, with the same fault
  knobs (drop/damage/duplicate/reorder probabilities) used by flood and
  herder tests.
- TCPTransport/TCPDoor ↔ reference `src/overlay/TCPPeer.cpp` +
  `PeerDoor.cpp`: length-framed XDR over asio sockets. Here a per-overlay
  reactor thread owns the sockets (the asio io thread role) and posts
  complete frames to the owning Application's VirtualClock via
  post_to_main, preserving the single-threaded consensus contract.

Framing: 4-byte big-endian record mark with the high bit set (single
fragment), matching the project's XDR stream framing.
"""

from __future__ import annotations

import errno
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Optional, Tuple

from ..util import rnd
from ..util.log import get_logger
from ..util.threads import TrackedLock
from ..util.timer import VirtualTimer

log = get_logger("Overlay")

_LAST_FRAG = 0x80000000
MAX_FRAME = 0x2000000        # 32 MiB hard cap on one message


class Transport:
    """Frame pipe interface: owner assigns on_frame/on_closed callbacks."""

    on_frame: Callable[[bytes], None]
    on_closed: Callable[[], None]

    def send_frame(self, raw: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def oldest_unsent_age(self) -> float:
        """Seconds the oldest enqueued-but-unsent frame has been waiting
        (0 when the send queue is drained). Drives the straggler timeout
        (reference Peer::idleTimerExpired mEnqueueTimeOfLastWrite check)."""
        return 0.0


class LoopbackTransport(Transport):
    """One end of an in-process pipe. Delivery is posted onto the RECEIVING
    side's clock so each node only touches its own state on its own crank
    (the simulation lock-step contract)."""

    def __init__(self, clock) -> None:
        self.clock = clock                 # receiving side's clock
        self.other: Optional["LoopbackTransport"] = None
        self.on_frame = lambda raw: None
        self.on_closed = lambda: None
        self.closed = False
        # fault injection on the SENDING side (reference LoopbackPeer.h:35-46)
        self.drop_probability = 0.0
        self.damage_probability = 0.0
        self.duplicate_probability = 0.0
        self.reorder_probability = 0.0
        self._reorder_held: Optional[bytes] = None

    @classmethod
    def pair(cls, clock_a, clock_b
             ) -> Tuple["LoopbackTransport", "LoopbackTransport"]:
        a, b = cls(clock_a), cls(clock_b)
        a.other, b.other = b, a
        return a, b

    def send_frame(self, raw: bytes) -> None:
        if self.closed or self.other is None:
            return
        r = rnd.g_random
        if self.drop_probability and r.random() < self.drop_probability:
            return
        if self.damage_probability and r.random() < self.damage_probability:
            buf = bytearray(raw)
            buf[r.randrange(len(buf))] ^= 0xFF
            raw = bytes(buf)
        frames = [raw]
        if self.duplicate_probability and \
                r.random() < self.duplicate_probability:
            frames.append(raw)
        if self.reorder_probability and r.random() < self.reorder_probability \
                and self._reorder_held is None:
            self._reorder_held = raw
            return
        if self._reorder_held is not None:
            frames.append(self._reorder_held)
            self._reorder_held = None
        other = self.other
        for f in frames:
            other.clock.post(lambda f=f: other._deliver(f))

    def _deliver(self, raw: bytes) -> None:
        if not self.closed:
            self.on_frame(raw)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        other = self.other
        if other is not None and not other.closed:
            other.clock.post(other._closed_by_peer)

    def _closed_by_peer(self) -> None:
        if not self.closed:
            self.closed = True
            self.on_closed()


class ChaosTransport(Transport):
    """Fault-injecting wrapper around another Transport (loopback pipes in
    simulations, but any Transport works): drop / delay / duplicate /
    reorder outbound frames by seeded FaultInjector schedule
    (`overlay.drop` / `overlay.delay` / `overlay.duplicate` /
    `overlay.reorder` sites, util/faults.py), plus a hard `partitioned`
    toggle that severs BOTH directions until healed — the knob the chaos
    soak uses to run a partition-and-heal scenario. The owning Peer sees
    a normal Transport; all chaos happens underneath it."""

    # delay applied to frames the `overlay.delay` site selects; virtual
    # seconds in simulations
    delay_s = 0.25
    # deterministic geographic base delay applied to EVERY outbound frame
    # (seconds on the sender's clock) — fed by the simulation's seeded
    # per-link latency matrix (simulation/geography.py); 0 = co-located
    link_delay_s = 0.0

    def __init__(self, inner: Transport, clock, faults=None,
                 site_prefix: str = "overlay") -> None:
        self.inner = inner
        self.clock = clock            # the owning (sending) side's clock
        self.faults = faults
        self.site_prefix = site_prefix
        self.partitioned = False
        self.dropped = 0              # frames eaten (faults + partition)
        self.delayed = 0
        self.on_frame = lambda raw: None
        self.on_closed = lambda: None
        self._reorder_held: Optional[bytes] = None
        inner.on_frame = self._rx
        inner.on_closed = lambda: self.on_closed()

    def _fire(self, site: str) -> bool:
        from ..util.faults import check_faults
        return check_faults(self, self.site_prefix + "." + site)

    def send_frame(self, raw: bytes) -> None:
        if self.partitioned or self._fire("drop"):
            self.dropped += 1
            return
        frames = [raw]
        if self._fire("duplicate"):
            frames.append(raw)
        if self._fire("reorder") and self._reorder_held is None:
            # hold this frame; it rides behind the NEXT send
            self._reorder_held = raw
            return
        if self._reorder_held is not None:
            frames.append(self._reorder_held)
            self._reorder_held = None
        for f in frames:
            wait = self.link_delay_s
            if self._fire("delay"):
                self.delayed += 1
                wait += self.delay_s
            if wait > 0:
                t = VirtualTimer(self.clock)
                t.expires_from_now(wait)
                t.async_wait(lambda f=f: self._send_now(f))
            else:
                self._send_now(f)

    def _send_now(self, raw: bytes) -> None:
        # re-check the partition at (delayed) delivery time: a frame held
        # over a partition start must not leak through
        if not self.partitioned:
            self.inner.send_frame(raw)
        else:
            self.dropped += 1

    def _rx(self, raw: bytes) -> None:
        if self.partitioned:
            self.dropped += 1
            return
        self.on_frame(raw)

    def set_partitioned(self, on: bool) -> None:
        self.partitioned = on

    def close(self) -> None:
        self.inner.close()

    def oldest_unsent_age(self) -> float:
        return self.inner.oldest_unsent_age()

    @property
    def closed(self) -> bool:
        return getattr(self.inner, "closed", False)


class TCPReactor:
    """Minimal socket reactor thread (the asio io-thread role): reads frames
    off nonblocking sockets, posts them to the main clock; drains per-socket
    write queues; accepts inbound connections."""

    def __init__(self, clock) -> None:
        self.clock = clock
        self._lock = TrackedLock("overlay.reactor")
        self._transports: Dict[socket.socket, "TCPTransport"] = {}
        self._doors: Dict[socket.socket, Callable] = {}
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="overlay-io", daemon=True)
            self._thread.start()

    def wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def add_transport(self, t: "TCPTransport") -> None:
        with self._lock:
            self._transports[t.sock] = t
        self.wake()

    def remove_transport(self, t: "TCPTransport") -> None:
        with self._lock:
            self._transports.pop(t.sock, None)
        self.wake()

    def add_door(self, sock: socket.socket,
                 on_accept: Callable[[socket.socket, tuple], None]) -> None:
        with self._lock:
            self._doors[sock] = on_accept
        self.wake()

    def stop(self) -> None:
        self._stopped = True
        self.wake()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        with self._lock:
            for s in list(self._doors):
                try:
                    s.close()
                except OSError:
                    pass
            self._doors.clear()

    def _run(self) -> None:
        import select
        while not self._stopped:
            with self._lock:
                transports = dict(self._transports)
                doors = dict(self._doors)
            # in-progress connects: fail the ones past their deadline; the
            # rest are watched for writability (= connect completion)
            now = time.monotonic()
            for t in transports.values():
                if t.connecting and now > t.connect_deadline:
                    t._fail()
            rlist = [self._wake_r] + list(doors) + \
                [s for s, t in transports.items() if not t.connecting]
            wlist = [s for s, t in transports.items() if t.wants_write()]
            try:
                r, w, _ = select.select(rlist, wlist, [], 0.25)
            except (OSError, ValueError):
                # a socket was closed mid-select; drop dead entries
                with self._lock:
                    for s in list(self._transports):
                        if s.fileno() < 0:
                            del self._transports[s]
                continue
            for s in r:
                if s is self._wake_r:
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except OSError:
                        pass
                elif s in doors:
                    try:
                        conn, addr = s.accept()
                        conn.setblocking(False)
                        conn.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                        doors[s](conn, addr)
                    except OSError:
                        pass
                else:
                    t = transports.get(s)
                    if t is not None:
                        t.handle_read()
            for s in w:
                t = transports.get(s)
                if t is not None:
                    t.handle_write()


class TCPTransport(Transport):
    # write batching limits (reference Config MAX_BATCH_WRITE_COUNT/BYTES;
    # the overlay manager overrides these from its Config)
    max_batch_write_count = 1024
    max_batch_write_bytes = 1024 * 1024
    # hard cap on queued-but-unsent bytes: exceeding it drops the
    # connection (a peer this far behind is a straggler, and an unbounded
    # queue lets a stuck reader consume all memory)
    send_queue_limit_bytes = 32 * 1024 * 1024
    connect_timeout = 5.0
    # observability/fault wiring, installed by the overlay manager
    # (_apply_transport_limits); both optional — raw transports work bare
    metrics = None
    faults = None

    def __init__(self, reactor: TCPReactor, sock: socket.socket) -> None:
        self.reactor = reactor
        self.sock = sock
        self.on_frame = lambda raw: None
        self.on_closed = lambda: None
        self.closed = False
        self._failed = False
        self._rbuf = b""
        self._wlock = threading.Lock()
        # (framed bytes, enqueue monotonic ts) pairs not yet batched
        self._wqueue: Deque[Tuple[bytes, float]] = deque()
        self._wqueue_bytes = 0
        # coalesced in-flight batch (prefix of the former queue)
        self._wbatch: Optional[memoryview] = None
        self._wbatch_head_ts = 0.0
        self.connecting = False
        self.connect_deadline = 0.0

    @classmethod
    def connect(cls, reactor: TCPReactor, host: str,
                port: int) -> "TCPTransport":
        """Begin a NON-blocking connect; the reactor completes it (connect
        success = writable, failure = SO_ERROR / deadline). Frames queued
        meanwhile flush once connected. The caller never blocks (reference
        TCPPeer::initiate asio async_connect)."""
        # numeric addresses (either family) resolve without blocking; a
        # hostname falls back to a blocking getaddrinfo, as the previous
        # create_connection-based dial also did
        try:
            infos = socket.getaddrinfo(
                host, port, type=socket.SOCK_STREAM,
                flags=socket.AI_NUMERICHOST)
        except socket.gaierror:
            infos = socket.getaddrinfo(host, port, type=socket.SOCK_STREAM)
        # try each resolved address for an immediately-failing dial
        # (create_connection's fallback role); an address that fails only
        # asynchronously is retried via the peer-table backoff
        sock = None
        err = 0
        for family, stype, proto, _cn, addr in infos:
            try:
                sock = socket.socket(family, stype, proto)
            except OSError:
                continue
            sock.setblocking(False)
            err = sock.connect_ex(addr)
            if err in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
                break
            sock.close()
            sock = None
        if sock is None:
            raise OSError(err, "connect to %s:%d: %s"
                          % (host, port, errno.errorcode.get(err, err)))
        t = cls(reactor, sock)
        t.connecting = err != 0
        t.connect_deadline = time.monotonic() + cls.connect_timeout
        if not t.connecting:
            t._connected()
        reactor.add_transport(t)
        return t

    def _connected(self) -> None:
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass

    def wants_write(self) -> bool:
        if self.connecting:
            return True
        with self._wlock:
            return self._wbatch is not None or bool(self._wqueue)

    def oldest_unsent_age(self) -> float:
        with self._wlock:
            if self._wbatch is not None:
                return time.monotonic() - self._wbatch_head_ts
            if self._wqueue:
                return time.monotonic() - self._wqueue[0][1]
        return 0.0

    def send_frame(self, raw: bytes) -> None:
        from ..util.faults import check_faults
        framed = struct.pack(">I", len(raw) | _LAST_FRAG) + raw
        with self._wlock:
            # closed/_failed must be read under the lock: a frame racing
            # _fail()'s queue-clear would otherwise pin bytes on a dead
            # transport forever
            if self.closed or self._failed:
                return
            self._wqueue.append((framed, time.monotonic()))
            self._wqueue_bytes += len(framed)
            overflow = self._wqueue_bytes > self.send_queue_limit_bytes
        # fault site: force the overflow path without queuing 32 MB
        # (docs/robustness.md#fault-points)
        if not overflow and check_faults(self, "overlay.send-overflow"):
            overflow = True
        if overflow:
            # a stalled reader must not pin send_queue_limit_bytes per
            # peer indefinitely: count it and drop the connection
            log.warning("send queue overflow (> %d bytes), dropping peer",
                        self.send_queue_limit_bytes)
            if self.metrics is not None:
                self.metrics.new_meter("overlay.send-queue.overflow").mark()
            self._fail()
            return
        self.reactor.wake()

    def handle_write(self) -> None:
        if self.connecting:
            err = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err != 0:
                self._fail()
                return
            self.connecting = False
            self._connected()
        failed = False
        with self._wlock:
            while not failed:
                if self._wbatch is None:
                    if not self._wqueue:
                        break
                    # coalesce a queue prefix into ONE send, bounded by
                    # the batch limits (reference TCPPeer::messageSender
                    # scatter-gather snapshot, TCPPeer.cpp:225-267)
                    bufs = []
                    total = 0
                    self._wbatch_head_ts = self._wqueue[0][1]
                    while self._wqueue and \
                            len(bufs) < self.max_batch_write_count and \
                            total < self.max_batch_write_bytes:
                        b, _ts = self._wqueue.popleft()
                        bufs.append(b)
                        total += len(b)
                    self._wqueue_bytes -= total
                    self._wbatch = memoryview(b"".join(bufs))
                try:
                    n = self.sock.send(self._wbatch)
                except OSError as e:
                    if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                        break
                    failed = True   # _fail() re-takes the lock: call it
                    break           # only after leaving the locked region
                if n < len(self._wbatch):
                    self._wbatch = self._wbatch[n:]
                    break
                self._wbatch = None
        if failed:
            self._fail()

    def handle_read(self) -> None:
        try:
            data = self.sock.recv(65536)
        except OSError as e:
            if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                return
            self._fail()
            return
        if not data:
            self._fail()
            return
        self._rbuf += data
        while len(self._rbuf) >= 4:
            n = struct.unpack(">I", self._rbuf[:4])[0]
            if not (n & _LAST_FRAG):
                self._fail()
                return
            n &= ~_LAST_FRAG
            if n > MAX_FRAME:
                self._fail()
                return
            if len(self._rbuf) < 4 + n:
                break
            frame = self._rbuf[4:4 + n]
            self._rbuf = self._rbuf[4 + n:]
            self.reactor.clock.post_to_main(
                lambda f=frame: None if self.closed else self.on_frame(f))

    def _fail(self) -> None:
        with self._wlock:
            if self.closed or self._failed:
                return
            # mark failed immediately (the posted _notify_closed may not
            # run until the current main-loop handler returns) and release
            # the buffered backlog — a dead transport must neither accept
            # nor pin more bytes
            self._failed = True
            self._wqueue.clear()
            self._wqueue_bytes = 0
            self._wbatch = None
        self.reactor.remove_transport(self)
        try:
            self.sock.close()
        except OSError:
            pass
        self.reactor.clock.post_to_main(self._notify_closed)

    def _notify_closed(self) -> None:
        if not self.closed:
            self.closed = True
            self.on_closed()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.reactor.remove_transport(self)
        try:
            self.sock.close()
        except OSError:
            pass


class TCPDoor:
    """Listening socket (reference PeerDoor.cpp): accepts inbound
    connections and hands sockets to the overlay manager on the main
    thread."""

    def __init__(self, reactor: TCPReactor, port: int,
                 on_connection: Callable) -> None:
        self.reactor = reactor
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", port))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(16)
        self.sock.setblocking(False)

        def accepted(conn: socket.socket, addr: tuple) -> None:
            t = TCPTransport(reactor, conn)
            reactor.add_transport(t)
            reactor.clock.post_to_main(lambda: on_connection(t, addr))

        reactor.add_door(self.sock, accepted)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
