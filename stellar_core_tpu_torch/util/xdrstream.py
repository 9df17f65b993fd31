"""XDR record streams: length-delimited XDR objects in a file.

Copied from `stellar_core_tpu/util/xdrstream.py` at commit 637fb91; carry a
fix in either copy to the other.

Role parity: reference `src/util/XDRStream.h` (XDRInputFileStream /
XDROutputFileStream) used for history checkpoint files. Framing matches the
RFC 5531 record mark the reference uses: 4-byte big-endian length with the
high bit set (single-fragment records).
"""

from __future__ import annotations

import struct
from typing import Any, Iterator, Optional

_MARK = struct.Struct(">I")
_LAST_FRAG = 0x80000000


def frame_record(body: bytes) -> bytes:
    """One framed record: RFC 5531 mark + body. THE single definition
    of the framing rule — the file writer below and the bucket layer's
    hash/persist path (bucket.entry_record) both call it, so the bucket
    identity hash can never desynchronize from the read path's framing."""
    return _MARK.pack(len(body) | _LAST_FRAG) + body


class XDROutputFileStream:
    def __init__(self, path: str) -> None:
        self._f = open(path, "wb")

    def write_one(self, xdr_type: Any, value: Any) -> None:
        from ..xdr.codec import xdr_bytes
        body = xdr_bytes(xdr_type, value) if not hasattr(value, "to_xdr") \
            else value.to_xdr()
        self._f.write(frame_record(body))

    def write_record(self, record: bytes) -> None:
        """Write an already-framed record (RFC 5531 mark + XDR body):
        the bucket layer hashes and persists the SAME serialized bytes
        (bucket.entry_record — memoized per immutable entry), so a
        bucket file write never re-serializes what its hash already
        paid for."""
        self._f.write(record)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class XDRInputFileStream:
    def __init__(self, path: str) -> None:
        self._f = open(path, "rb")

    def read_one(self, xdr_type: Any) -> Optional[Any]:
        hdr = self._f.read(4)
        if not hdr:
            return None
        if len(hdr) < 4:
            raise IOError("truncated record mark")
        n = _MARK.unpack(hdr)[0]
        if not (n & _LAST_FRAG):
            raise IOError("multi-fragment records unsupported")
        n &= ~_LAST_FRAG
        body = self._f.read(n)
        if len(body) < n:
            raise IOError("truncated record body")
        from ..xdr.codec import xdr_from
        return xdr_from(xdr_type, body)

    def read_all(self, xdr_type: Any) -> Iterator[Any]:
        while True:
            v = self.read_one(xdr_type)
            if v is None:
                return
            yield v

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
