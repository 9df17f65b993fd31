"""XDR (RFC 4506) codec — the canonical wire and hash format.

Copied from `stellar_core_tpu/xdr/codec.py` at commit efc2328; carry a fix
in either copy to the other. The copy has no native route: the reference's
`_native_of` asks its C extension (`native/xdrc.c`) for a per-type packer
and unpacker, and the port has no such extension yet (ROADMAP Queue 1 item
5 lists it), so `xdr_bytes` and `xdr_from` take the compiled Python
`fastcodec` route for every type, on purpose. The bytes are the same
either way: the reference's `tests/test_native_xdr.py` holds its two routes
to identical bytes.

Role parity: reference `src/xdr/*.x` compiled by xdrc via xdrpp
(reference `src/Makefile.am:26-29`); XDR bytes are the canonical hashed
form (reference `docs/architecture.md:50-52`). This is a from-scratch
declarative codec: types are built from combinators and struct/union classes
declare `xdr_fields` / `xdr_union` specs. Big-endian, 4-byte alignment.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Optional as TOptional


class XdrError(Exception):
    pass


class Packer:
    __slots__ = ("_parts",)

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def put(self, b: bytes) -> None:
        self._parts.append(b)

    def bytes(self) -> bytes:
        return b"".join(self._parts)


class Unpacker:
    __slots__ = ("_buf", "_pos")

    def __init__(self, buf: bytes) -> None:
        self._buf = buf
        self._pos = 0

    def take(self, n: int) -> bytes:
        if self._pos + n > len(self._buf):
            raise XdrError("XDR underflow: need %d bytes at %d, have %d"
                           % (n, self._pos, len(self._buf)))
        b = self._buf[self._pos:self._pos + n]
        self._pos += n
        return b

    def done(self) -> bool:
        return self._pos == len(self._buf)

    def assert_done(self) -> None:
        if not self.done():
            raise XdrError("XDR trailing bytes: %d left" % (len(self._buf) - self._pos))


def _pad(n: int) -> int:
    return (4 - n % 4) % 4


# ---------------------------------------------------------------------------
# Type combinators. Each type object has pack(p, v) and unpack(u) -> v.
# ---------------------------------------------------------------------------

class _Int:
    def __init__(self, fmt: str, lo: int, hi: int) -> None:
        self._s = struct.Struct(fmt)
        self._lo, self._hi = lo, hi

    def pack(self, p: Packer, v: int) -> None:
        if not (self._lo <= v <= self._hi):
            raise XdrError("int out of range: %r" % (v,))
        p.put(self._s.pack(v))

    def unpack(self, u: Unpacker) -> int:
        return self._s.unpack(u.take(self._s.size))[0]


Int32 = _Int(">i", -(2**31), 2**31 - 1)
Uint32 = _Int(">I", 0, 2**32 - 1)
Int64 = _Int(">q", -(2**63), 2**63 - 1)
Uint64 = _Int(">Q", 0, 2**64 - 1)


class _Bool:
    def pack(self, p: Packer, v: bool) -> None:
        Uint32.pack(p, 1 if v else 0)

    def unpack(self, u: Unpacker) -> bool:
        x = Uint32.unpack(u)
        if x not in (0, 1):
            raise XdrError("bad bool %d" % x)
        return bool(x)


Bool = _Bool()


class Opaque:
    """Fixed-length opaque."""

    def __init__(self, n: int) -> None:
        self.n = n

    def pack(self, p: Packer, v: bytes) -> None:
        if len(v) != self.n:
            raise XdrError("opaque[%d] got %d bytes" % (self.n, len(v)))
        p.put(v)
        p.put(b"\x00" * _pad(self.n))

    def unpack(self, u: Unpacker) -> bytes:
        v = u.take(self.n)
        pad = u.take(_pad(self.n))
        if pad != b"\x00" * len(pad):
            raise XdrError("nonzero padding")
        return v


class VarOpaque:
    """Variable-length opaque with max size."""

    def __init__(self, maxn: int = 2**32 - 1) -> None:
        self.maxn = maxn

    def pack(self, p: Packer, v: bytes) -> None:
        if len(v) > self.maxn:
            raise XdrError("opaque<%d> got %d bytes" % (self.maxn, len(v)))
        Uint32.pack(p, len(v))
        p.put(v)
        p.put(b"\x00" * _pad(len(v)))

    def unpack(self, u: Unpacker) -> bytes:
        n = Uint32.unpack(u)
        if n > self.maxn:
            raise XdrError("opaque<%d> wire len %d" % (self.maxn, n))
        v = u.take(n)
        pad = u.take(_pad(n))
        if pad != b"\x00" * len(pad):
            raise XdrError("nonzero padding")
        return v


class XdrString:
    def __init__(self, maxn: int = 2**32 - 1) -> None:
        self._o = VarOpaque(maxn)

    def pack(self, p: Packer, v: str) -> None:
        self._o.pack(p, v.encode("utf-8"))

    def unpack(self, u: Unpacker) -> str:
        return self._o.unpack(u).decode("utf-8")


class FixedArray:
    def __init__(self, elem: Any, n: int) -> None:
        self.elem, self.n = elem, n

    def pack(self, p: Packer, v: list) -> None:
        if len(v) != self.n:
            raise XdrError("array[%d] got %d" % (self.n, len(v)))
        for e in v:
            self.elem.pack(p, e)

    def unpack(self, u: Unpacker) -> list:
        return [self.elem.unpack(u) for _ in range(self.n)]


class VarArray:
    def __init__(self, elem: Any, maxn: int = 2**32 - 1) -> None:
        self.elem, self.maxn = elem, maxn

    def pack(self, p: Packer, v: list) -> None:
        if len(v) > self.maxn:
            raise XdrError("array<%d> got %d" % (self.maxn, len(v)))
        Uint32.pack(p, len(v))
        for e in v:
            self.elem.pack(p, e)

    def unpack(self, u: Unpacker) -> list:
        n = Uint32.unpack(u)
        if n > self.maxn:
            raise XdrError("array<%d> wire len %d" % (self.maxn, n))
        return [self.elem.unpack(u) for _ in range(n)]


class OptionalT:
    """XDR optional (pointer): bool then value."""

    def __init__(self, elem: Any) -> None:
        self.elem = elem

    def pack(self, p: Packer, v: Any) -> None:
        if v is None:
            Uint32.pack(p, 0)
        else:
            Uint32.pack(p, 1)
            self.elem.pack(p, v)

    def unpack(self, u: Unpacker) -> Any:
        if Uint32.unpack(u) == 0:
            return None
        return self.elem.unpack(u)


class EnumT:
    """Enum restricted to a known value set (pack rejects unknowns)."""

    def __init__(self, values: dict[int, str]) -> None:
        self.values = values

    def pack(self, p: Packer, v: int) -> None:
        if v not in self.values:
            raise XdrError("bad enum value %r" % (v,))
        Int32.pack(p, v)

    def unpack(self, u: Unpacker) -> int:
        v = Int32.unpack(u)
        if v not in self.values:
            raise XdrError("bad enum value %r" % (v,))
        return v


class XdrStruct:
    """Base for declarative structs: subclasses set xdr_fields = [(name, type)]."""

    xdr_fields: list[tuple[str, Any]] = []

    def __init__(self, **kw: Any) -> None:
        names = [n for n, _ in self.xdr_fields]
        for n in names:
            if n not in kw:
                raise TypeError("%s missing field %s" % (type(self).__name__, n))
            v = kw.pop(n)
            if type(v) is tuple:  # normalize so field-wise __eq__ is exact
                v = list(v)
            setattr(self, n, v)
        if kw:
            raise TypeError("%s unknown fields %s" % (type(self).__name__, list(kw)))

    @classmethod
    def pack(cls, p: Packer, v: "XdrStruct") -> None:
        if not isinstance(v, cls):
            raise XdrError("expected %s, got %r" % (cls.__name__, type(v)))
        for n, t in cls.xdr_fields:
            t.pack(p, getattr(v, n))

    @classmethod
    def unpack(cls, u: Unpacker) -> "XdrStruct":
        vals = {n: t.unpack(u) for n, t in cls.xdr_fields}
        return cls(**vals)

    # value semantics -------------------------------------------------------
    def to_xdr(self) -> bytes:
        return xdr_bytes(type(self), self)

    @classmethod
    def from_xdr(cls, b: bytes) -> "XdrStruct":
        return xdr_from(cls, b)

    def __eq__(self, other: Any) -> bool:
        # field-wise (values are ints/bytes/lists/nested XDR, where ==
        # recurses) — equivalent to comparing canonical bytes, without
        # serializing both sides
        if type(self) is not type(other):
            return False
        for n, _t in self.xdr_fields:
            if getattr(self, n) != getattr(other, n):
                return False
        return True

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.to_xdr()))

    def __repr__(self) -> str:
        fs = ", ".join("%s=%r" % (n, getattr(self, n)) for n, _ in self.xdr_fields)
        return "%s(%s)" % (type(self).__name__, fs)


class XdrUnion:
    """Discriminated union: subclasses set xdr_switch_type (an int/enum type)
    and xdr_arms = {disc_value: (arm_name, arm_type_or_None)}.
    xdr_default = (arm_name, type) optionally handles unknown discriminants.
    """

    xdr_switch_type: Any = Int32
    xdr_arms: dict[int, tuple[str, Any]] = {}
    xdr_default: TOptional[tuple[str, Any]] = None

    def __init__(self, disc: int, value: Any = None) -> None:
        self.disc = disc
        if type(value) is tuple:  # normalize so field-wise __eq__ is exact
            value = list(value)
        self.value = value

    @classmethod
    def _arm(cls, disc: int) -> tuple[str, Any]:
        if disc in cls.xdr_arms:
            return cls.xdr_arms[disc]
        if cls.xdr_default is not None:
            return cls.xdr_default
        raise XdrError("%s: bad discriminant %r" % (cls.__name__, disc))

    @classmethod
    def pack(cls, p: Packer, v: "XdrUnion") -> None:
        if not isinstance(v, cls):
            raise XdrError("expected %s, got %r" % (cls.__name__, type(v)))
        name, t = cls._arm(v.disc)
        cls.xdr_switch_type.pack(p, v.disc)
        if t is not None:
            t.pack(p, v.value)

    @classmethod
    def unpack(cls, u: Unpacker) -> "XdrUnion":
        disc = cls.xdr_switch_type.unpack(u)
        name, t = cls._arm(disc)
        value = t.unpack(u) if t is not None else None
        return cls(disc, value)

    def to_xdr(self) -> bytes:
        return xdr_bytes(type(self), self)

    @classmethod
    def from_xdr(cls, b: bytes) -> "XdrUnion":
        return xdr_from(cls, b)

    def __eq__(self, other: Any) -> bool:
        # structural, like XdrStruct.__eq__
        return (type(self) is type(other) and self.disc == other.disc
                and self.value == other.value)

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.to_xdr()))

    def __repr__(self) -> str:
        name, _ = type(self)._arm(self.disc)
        return "%s(%s=%r)" % (type(self).__name__, name, self.value)


_fastcodec = None  # lazy module ref (fastcodec imports this module)


def _fast():
    global _fastcodec
    if _fastcodec is None:
        from . import fastcodec as _fc
        _fastcodec = _fc
    return _fastcodec


def xdr_bytes(t: Any, v: Any) -> bytes:
    out: list[bytes] = []
    _fast().compile_pack(t)(out.append, v)
    return b"".join(out)


def xdr_from(t: Any, b: bytes) -> Any:
    v, pos = _fast().compile_unpack(t)(b, 0)
    if pos != len(b):
        raise XdrError("XDR trailing bytes: %d left" % (len(b) - pos))
    return v
