"""Compiled fast paths for the XDR codec.

Copied from `stellar_core_tpu/xdr/fastcodec.py` at commit 634bc5e; carry a
fix in either copy to the other.

The declarative codec in codec.py dispatches through a method call per
field per value — measured in the reference at ~60% of its catchup-replay
CPU time (XDR bytes are the canonical hash form, so encode/decode sits
under every hash, every wire message, every history stream). This module
compiles each type combinator ONCE into closure-specialized functions:

    pack:   f(append, value)           append = list.append of the buffer
    unpack: f(buf, pos) -> (value, new_pos)

eliminating interpreter-level indirection (attribute lookups, Packer /
Unpacker objects, per-int bounds objects) while keeping every validation
the slow path performs: int ranges, opaque lengths, zero padding, enum
membership, max array/opaque sizes, trailing-byte checks.

Role parity: the reference gets this for free from xdrpp's generated C++
(reference `src/Makefile.am:26-29`); this is the Python equivalent of
that code generation, done at runtime.
"""

from __future__ import annotations

import struct
from typing import Any, Callable

from . import codec as C

_U32 = struct.Struct(">I")
_I32 = struct.Struct(">i")

PackFn = Callable[[Callable[[bytes], None], Any], None]
UnpackFn = Callable[[bytes, int], tuple]


def _pad(n: int) -> int:
    return (4 - n % 4) % 4


# --------------------------------------------------------------- compilers

def compile_pack(t: Any) -> PackFn:
    # classes must use their OWN slot (inheritance would leak a parent's
    # compiled fn onto subclasses); instances can use plain attributes
    cached = t.__dict__.get("_fast_pack") if isinstance(t, type) \
        else getattr(t, "_fast_pack", None)
    if cached is not None:
        return cached
    fn = _build_pack(t)
    try:
        t._fast_pack = fn
    except (AttributeError, TypeError):
        pass
    return fn


def compile_unpack(t: Any) -> UnpackFn:
    cached = t.__dict__.get("_fast_unpack") if isinstance(t, type) \
        else getattr(t, "_fast_unpack", None)
    if cached is not None:
        return cached
    fn = _build_unpack(t)
    try:
        t._fast_unpack = fn
    except (AttributeError, TypeError):
        pass
    return fn


def _build_pack(t: Any) -> PackFn:
    if isinstance(t, C._Int):
        s, lo, hi = t._s, t._lo, t._hi

        def f(ap, v, s=s, lo=lo, hi=hi):
            if not (lo <= v <= hi):
                raise C.XdrError("int out of range: %r" % (v,))
            ap(s.pack(v))
        return f

    if isinstance(t, C._Bool):
        def f(ap, v):
            ap(b"\x00\x00\x00\x01" if v else b"\x00\x00\x00\x00")
        return f

    if isinstance(t, C.Opaque):
        n = t.n
        pad = b"\x00" * _pad(n)

        def f(ap, v, n=n, pad=pad):
            if len(v) != n:
                raise C.XdrError("opaque[%d] got %d bytes" % (n, len(v)))
            ap(v)
            if pad:
                ap(pad)
        return f

    if isinstance(t, C.VarOpaque):
        maxn = t.maxn

        def f(ap, v, maxn=maxn):
            n = len(v)
            if n > maxn:
                raise C.XdrError("opaque<%d> got %d bytes" % (maxn, n))
            ap(_U32.pack(n))
            ap(v)
            p = _pad(n)
            if p:
                ap(b"\x00" * p)
        return f

    if isinstance(t, C.XdrString):
        inner = _build_pack(t._o)

        def f(ap, v, inner=inner):
            inner(ap, v.encode("utf-8"))
        return f

    if isinstance(t, C.FixedArray):
        elem = compile_pack(t.elem)
        n = t.n

        def f(ap, v, elem=elem, n=n):
            if len(v) != n:
                raise C.XdrError("array[%d] got %d" % (n, len(v)))
            for e in v:
                elem(ap, e)
        return f

    if isinstance(t, C.VarArray):
        elem = compile_pack(t.elem)
        maxn = t.maxn

        def f(ap, v, elem=elem, maxn=maxn):
            n = len(v)
            if n > maxn:
                raise C.XdrError("array<%d> got %d" % (maxn, n))
            ap(_U32.pack(n))
            for e in v:
                elem(ap, e)
        return f

    if isinstance(t, C.OptionalT):
        elem = compile_pack(t.elem)

        def f(ap, v, elem=elem):
            if v is None:
                ap(b"\x00\x00\x00\x00")
            else:
                ap(b"\x00\x00\x00\x01")
                elem(ap, v)
        return f

    if isinstance(t, C.EnumT):
        values = t.values

        def f(ap, v, values=values):
            if v not in values:
                raise C.XdrError("bad enum value %r" % (v,))
            ap(_I32.pack(v))
        return f

    if isinstance(t, type) and issubclass(t, C.XdrStruct):
        cell: list = []   # lazy: xdr_fields may be patched post-creation

        def f(ap, v, cls=t, cell=cell):
            if not cell:
                cell.append(tuple((n, compile_pack(ft))
                                  for n, ft in cls.xdr_fields))
            if v.__class__ is not cls and not isinstance(v, cls):
                raise C.XdrError("expected %s, got %r"
                                 % (cls.__name__, type(v)))
            for n, fp in cell[0]:
                fp(ap, getattr(v, n))
        return f

    if isinstance(t, type) and issubclass(t, C.XdrUnion):
        cell: list = []

        def f(ap, v, cls=t, cell=cell):
            if not cell:
                arms = {d: (compile_pack(at) if at is not None else None)
                        for d, (an, at) in cls.xdr_arms.items()}
                default = None
                if cls.xdr_default is not None:
                    default = compile_pack(cls.xdr_default[1]) \
                        if cls.xdr_default[1] is not None else None
                cell.append((compile_pack(cls.xdr_switch_type), arms,
                             default, cls.xdr_default is not None))
            sw, arms, default, has_default = cell[0]
            if v.__class__ is not cls and not isinstance(v, cls):
                raise C.XdrError("expected %s, got %r"
                                 % (cls.__name__, type(v)))
            disc = v.disc
            if disc in arms:
                fp = arms[disc]
            elif has_default:
                fp = default
            else:
                raise C.XdrError("%s: bad discriminant %r"
                                 % (cls.__name__, disc))
            sw(ap, disc)
            if fp is not None:
                fp(ap, v.value)
        return f

    # unknown combinator: fall back to its own pack via a Packer shim
    def f(ap, v, t=t):
        p = C.Packer()
        t.pack(p, v)
        ap(p.bytes())
    return f


def _build_unpack(t: Any) -> UnpackFn:
    if isinstance(t, C._Int):
        s = t._s
        size = s.size

        def f(buf, pos, s=s, size=size):
            try:
                v = s.unpack_from(buf, pos)[0]
            except struct.error:
                raise C.XdrError("XDR underflow at %d" % pos) from None
            return v, pos + size
        return f

    if isinstance(t, C._Bool):
        def f(buf, pos):
            w = buf[pos:pos + 4]
            if w == b"\x00\x00\x00\x00":
                return False, pos + 4
            if w == b"\x00\x00\x00\x01":
                return True, pos + 4
            if len(w) < 4:
                raise C.XdrError("XDR underflow at %d" % pos)
            raise C.XdrError("bad bool")
        return f

    if isinstance(t, C.Opaque):
        n = t.n
        padn = _pad(n)
        zero = b"\x00" * padn

        def f(buf, pos, n=n, padn=padn, zero=zero):
            end = pos + n + padn
            if end > len(buf):
                raise C.XdrError("XDR underflow at %d" % pos)
            if padn and buf[pos + n:end] != zero:
                raise C.XdrError("nonzero padding")
            return buf[pos:pos + n], end
        return f

    if isinstance(t, C.VarOpaque):
        maxn = t.maxn

        def f(buf, pos, maxn=maxn):
            try:
                n = _U32.unpack_from(buf, pos)[0]
            except struct.error:
                raise C.XdrError("XDR underflow at %d" % pos) from None
            if n > maxn:
                raise C.XdrError("opaque<%d> wire len %d" % (maxn, n))
            pos += 4
            padn = _pad(n)
            end = pos + n + padn
            if end > len(buf):
                raise C.XdrError("XDR underflow at %d" % pos)
            if padn and buf[pos + n:end] != b"\x00" * padn:
                raise C.XdrError("nonzero padding")
            return buf[pos:pos + n], end
        return f

    if isinstance(t, C.XdrString):
        inner = _build_unpack(t._o)

        def f(buf, pos, inner=inner):
            v, pos = inner(buf, pos)
            return v.decode("utf-8"), pos
        return f

    if isinstance(t, C.FixedArray):
        elem = compile_unpack(t.elem)
        n = t.n

        def f(buf, pos, elem=elem, n=n):
            out = []
            ap = out.append
            for _ in range(n):
                v, pos = elem(buf, pos)
                ap(v)
            return out, pos
        return f

    if isinstance(t, C.VarArray):
        elem = compile_unpack(t.elem)
        maxn = t.maxn

        def f(buf, pos, elem=elem, maxn=maxn):
            try:
                n = _U32.unpack_from(buf, pos)[0]
            except struct.error:
                raise C.XdrError("XDR underflow at %d" % pos) from None
            if n > maxn:
                raise C.XdrError("array<%d> wire len %d" % (maxn, n))
            pos += 4
            out = []
            ap = out.append
            for _ in range(n):
                v, pos = elem(buf, pos)
                ap(v)
            return out, pos
        return f

    if isinstance(t, C.OptionalT):
        elem = compile_unpack(t.elem)

        def f(buf, pos, elem=elem):
            w = buf[pos:pos + 4]
            if w == b"\x00\x00\x00\x00":
                return None, pos + 4
            if w == b"\x00\x00\x00\x01":
                return elem(buf, pos + 4)
            if len(w) < 4:
                raise C.XdrError("XDR underflow at %d" % pos)
            raise C.XdrError("bad optional flag")
        return f

    if isinstance(t, C.EnumT):
        values = t.values

        def f(buf, pos, values=values):
            try:
                v = _I32.unpack_from(buf, pos)[0]
            except struct.error:
                raise C.XdrError("XDR underflow at %d" % pos) from None
            if v not in values:
                raise C.XdrError("bad enum value %r" % (v,))
            return v, pos + 4
        return f

    if isinstance(t, type) and issubclass(t, C.XdrStruct):
        cell: list = []

        def f(buf, pos, cls=t, cell=cell):
            if not cell:
                cell.append(tuple((n, compile_unpack(ft))
                                  for n, ft in cls.xdr_fields))
            obj = cls.__new__(cls)
            d = obj.__dict__
            for n, fu in cell[0]:
                d[n], pos = fu(buf, pos)
            return obj, pos
        return f

    if isinstance(t, type) and issubclass(t, C.XdrUnion):
        cell: list = []

        def f(buf, pos, cls=t, cell=cell):
            if not cell:
                arms = {d: (compile_unpack(at) if at is not None else None)
                        for d, (an, at) in cls.xdr_arms.items()}
                default = None
                if cls.xdr_default is not None:
                    default = compile_unpack(cls.xdr_default[1]) \
                        if cls.xdr_default[1] is not None else None
                cell.append((compile_unpack(cls.xdr_switch_type), arms,
                             default, cls.xdr_default is not None))
            sw, arms, default, has_default = cell[0]
            disc, pos = sw(buf, pos)
            if disc in arms:
                fu = arms[disc]
            elif has_default:
                fu = default
            else:
                raise C.XdrError("%s: bad discriminant %r"
                                 % (cls.__name__, disc))
            obj = cls.__new__(cls)
            obj.disc = disc
            if fu is not None:
                obj.value, pos = fu(buf, pos)
            else:
                obj.value = None
            return obj, pos
        return f

    # unknown combinator: fall back to its own unpack via an Unpacker shim
    def f(buf, pos, t=t):
        u = C.Unpacker(buf)
        u._pos = pos
        v = t.unpack(u)
        return v, u._pos
    return f


# ------------------------------------------------------------ deep copy

def compile_copy(t: Any) -> Callable[[Any], Any]:
    """Compiled structural deep copy — the LedgerTxn copy-on-write
    primitive. ~4x cheaper than the pack+unpack round-trip it replaces
    (no byte encoding, no validation re-runs; immutable leaves — ints,
    bytes, strings, enums — pass through by reference)."""
    cached = t.__dict__.get("_fast_copy") if isinstance(t, type) \
        else getattr(t, "_fast_copy", None)
    if cached is not None:
        return cached
    fn = _build_copy(t) or (lambda v: v)
    try:
        t._fast_copy = fn
    except (AttributeError, TypeError):
        pass
    return fn


def _copy_of(t: Any):
    """Like _build_copy, but recurses through the caching compile_copy for
    class types so shared nested structs/unions compile once (matches how
    _build_pack recurses via compile_pack)."""
    if isinstance(t, type) and issubclass(t, (C.XdrStruct, C.XdrUnion)):
        return compile_copy(t)
    return _build_copy(t)


def _build_copy(t: Any):
    """Returns a copy fn, or None meaning 'values of this type are
    immutable — identity suffices' (lets containers of leaves shortcut
    to a plain list() copy)."""
    if isinstance(t, (C._Int, C._Bool, C.Opaque, C.VarOpaque,
                      C.XdrString, C.EnumT)):
        return None

    if isinstance(t, (C.FixedArray, C.VarArray)):
        elem = _copy_of(t.elem)
        if elem is None:
            return lambda v: list(v)
        return lambda v, elem=elem: [elem(e) for e in v]

    if isinstance(t, C.OptionalT):
        elem = _copy_of(t.elem)
        if elem is None:
            return None
        return lambda v, elem=elem: None if v is None else elem(v)

    if isinstance(t, type) and issubclass(t, C.XdrStruct):
        cell: list = []   # lazy: xdr_fields may be patched post-creation

        def f(v, cls=t, cell=cell):
            if not cell:
                cell.append(tuple((n, _copy_of(ft))
                                  for n, ft in cls.xdr_fields))
            obj = cls.__new__(cls)
            d = obj.__dict__
            s = v.__dict__
            for n, fc in cell[0]:
                x = s[n]
                d[n] = x if fc is None else fc(x)
            return obj
        return f

    if isinstance(t, type) and issubclass(t, C.XdrUnion):
        cell: list = []

        def f(v, cls=t, cell=cell):
            if not cell:
                arms = {d: _copy_of(at) if at is not None else None
                        for d, (an, at) in cls.xdr_arms.items()}
                default = None
                if cls.xdr_default is not None and \
                        cls.xdr_default[1] is not None:
                    default = _copy_of(cls.xdr_default[1])
                cell.append((arms, default))
            arms, default = cell[0]
            obj = cls.__new__(cls)
            obj.disc = v.disc
            # unknown disc can't occur on a validly-built value; void
            # arms carry value None, where identity is right anyway
            fc = arms.get(v.disc, default)
            obj.value = v.value if fc is None else fc(v.value)
            return obj
        return f

    # unknown combinator: round-trip through bytes (always correct)
    def f(v, t=t):
        out: list = []
        compile_pack(t)(out.append, v)
        got, _pos = compile_unpack(t)(b"".join(out), 0)
        return got
    return f
