"""LedgerCloseMeta output stream: full per-close meta for downstream
consumers (Horizon-style ingestion pipelines).

Copied from `stellar_core_tpu/ledger/close_meta_stream.py` at commit
05e2f75; carry a fix in either copy to the other. The records are the
reference's bytes for the same closes.

Role parity: reference `METADATA_OUTPUT_STREAM` config knob
(`src/main/Config.h:264`) and the emission sites in
`src/ledger/LedgerManagerImpl.cpp:590,673-678` — the reference opens the
configured fd/file at startup and writes one XDR `LedgerCloseMeta` record
after every successful ledger close; tested by
`src/ledger/test/LedgerCloseMetaStreamTests.cpp`.

Stream format: RFC 5531 record marks (4-byte big-endian length, high bit
set), the same framing `util/xdrstream.py` uses for history checkpoint
files — a downstream reader needs exactly one framing implementation for
both surfaces.

Crash safety: each record is pre-assembled (mark + body) into one buffer
before any write, so records are emitted back to back and a crash can
only tear the TRAILING record — a large record may still take several
os.write calls, so tearing mid-record IS possible and the reader is
built for it: `read_close_meta_stream` tolerates a truncated tail
(returns every complete record and reports the torn one) instead of
raising, matching how the reference's consumers resume after a crash
(they re-request the last ledger and overwrite).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

from ..util.log import get_logger
from ..xdr import LedgerCloseMeta

log = get_logger("Ledger")

_MARK = struct.Struct(">I")
_LAST_FRAG = 0x80000000


class CloseMetaStream:
    """Writer end. `target` is the config string: a filesystem path
    (truncated at open, like the reference's file mode) or "fd:N" for an
    inherited file descriptor (the operator's pipe)."""

    def __init__(self, target: str) -> None:
        self.target = target
        self._owns_fd = False
        if target.startswith("fd:"):
            self._fd = int(target[3:])
        else:
            self._fd = os.open(target,
                               os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            self._owns_fd = True

    def write_one(self, meta) -> None:
        """One close's meta, framed, from one pre-assembled buffer."""
        body = meta.to_xdr()
        buf = _MARK.pack(len(body) | _LAST_FRAG) + body
        view = memoryview(buf)
        while view:
            n = os.write(self._fd, view)
            view = view[n:]

    def close(self) -> None:
        if self._owns_fd and self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


def read_close_meta_stream(path_or_fd) -> Tuple[List, Optional[str]]:
    """Reader end (the downstream consumer's side, and the test oracle).

    Returns (records, tail_error): every complete LedgerCloseMeta in
    order, plus a description of a torn trailing record if the stream
    ends mid-frame (None for a clean end).
    """
    if isinstance(path_or_fd, int):
        f = os.fdopen(os.dup(path_or_fd), "rb")
    else:
        f = open(path_or_fd, "rb")
    out: List = []
    try:
        while True:
            hdr = f.read(4)
            if not hdr:
                return out, None
            if len(hdr) < 4:
                return out, "torn record mark (%d bytes)" % len(hdr)
            n = _MARK.unpack(hdr)[0]
            if not (n & _LAST_FRAG):
                return out, "bad record mark 0x%08x" % n
            n &= ~_LAST_FRAG
            body = f.read(n)
            if len(body) < n:
                return out, "torn record body (%d of %d bytes)" % (
                    len(body), n)
            out.append(LedgerCloseMeta.from_xdr(body))
    finally:
        f.close()


def iter_close_meta(path_or_fd) -> Iterator:
    """Convenience: yield complete records, silently stopping at a torn
    tail."""
    records, _err = read_close_meta_stream(path_or_fd)
    yield from records
