"""The port's XDR codec (`stellar_core_tpu_torch.xdr`) against the JAX
package's (`stellar_core_tpu.xdr`).

- The cases of `tests/test_xdr.py`, run against the port: integer and
  opaque padding, string limits, struct/union round trips, a bad
  discriminant, optionals, the recursive quorum set, a transaction
  envelope, overlay messages, trailing bytes, and the compiled deep copy.
- A differential: seeded random values of `LedgerEntry`, `BucketEntry`,
  `LedgerHeader` and `TransactionEnvelope` (and of the types under them),
  drawn by one generator that walks each package's own type tree with the
  same random stream. The reference's bytes decode in the port and
  re-encode to the same bytes, the port's decode in the reference and
  re-encode to the same bytes, and the two encoders agree on the "same"
  value built in each package.
- The port's codec never takes a native route (it has no `native/xdrc.c`).
Tolerance: none, bytes are compared exactly.
"""

import random

import pytest

import stellar_core_tpu.xdr as RX
import stellar_core_tpu_torch.xdr as X
from stellar_core_tpu.testing import genesis_header as ref_genesis_header
from stellar_core_tpu_torch.xdr import codec as C
from stellar_core_tpu_torch.xdr import fastcodec
from stellar_core_tpu_torch.xdr.codec import Packer, Unpacker, XdrError


def acc(i: int) -> X.PublicKey:
    return X.PublicKey.ed25519(bytes([i] * 32))


def genesis_header() -> X.LedgerHeader:
    """The reference's genesis header, decoded by the port."""
    return X.LedgerHeader.from_xdr(ref_genesis_header().to_xdr())


# --- the cases of tests/test_xdr.py ------------------------------------------

def test_int_roundtrip_and_padding():
    p = Packer()
    X.Uint32.pack(p, 7)
    X.Int64.pack(p, -1)
    b = p.bytes()
    assert len(b) == 12
    u = Unpacker(b)
    assert X.Uint32.unpack(u) == 7
    assert X.Int64.unpack(u) == -1
    u.assert_done()


def test_opaque_padding_canonical():
    o = X.VarOpaque(10)
    p = Packer()
    o.pack(p, b"abc")
    assert p.bytes() == b"\x00\x00\x00\x03abc\x00"
    with pytest.raises(XdrError):
        o.unpack(Unpacker(b"\x00\x00\x00\x03abcX"))


def test_string_limits():
    s = X.XdrString(4)
    p = Packer()
    with pytest.raises(XdrError):
        s.pack(p, "hello")


def test_struct_union_roundtrip():
    a = X.Asset.credit("USD", acc(1))
    assert X.Asset.from_xdr(a.to_xdr()) == a
    n = X.Asset.native()
    assert n.is_native and X.Asset.from_xdr(n.to_xdr()) == n
    assert a != n

    e = X.LedgerEntry(
        lastModifiedLedgerSeq=3,
        data=X.LedgerEntryData(
            X.LedgerEntryType.ACCOUNT,
            X.AccountEntry(accountID=acc(2), balance=100, seqNum=1,
                           numSubEntries=0, inflationDest=None, flags=0,
                           homeDomain="x", thresholds=bytes(4), signers=[],
                           ext=X.AccountEntryExt.v0())),
        ext=X._Ext.v0())
    assert X.LedgerEntry.from_xdr(e.to_xdr()) == e
    assert X.ledger_entry_key(e) == X.LedgerKey.account(acc(2))


def test_union_bad_discriminant():
    with pytest.raises(XdrError):
        X.Asset.from_xdr(b"\x00\x00\x00\x09")


def test_optional():
    t = X.TimeBounds(minTime=1, maxTime=2)
    tx_with = X.OptionalT(X.TimeBounds)
    p = Packer()
    tx_with.pack(p, t)
    p2 = Packer()
    tx_with.pack(p2, None)
    assert len(p.bytes()) == 4 + 16 and p2.bytes() == b"\x00\x00\x00\x00"


def test_recursive_qset():
    q = X.SCPQuorumSet(
        threshold=2, validators=[acc(1), acc(2)],
        innerSets=[X.SCPQuorumSet(threshold=1, validators=[acc(3)],
                                  innerSets=[])])
    assert X.SCPQuorumSet.from_xdr(q.to_xdr()) == q


def _payment_envelope(pkg):
    def a(i):
        return pkg.PublicKey.ed25519(bytes([i] * 32))
    tx = pkg.Transaction(
        sourceAccount=pkg.MuxedAccount.from_account_id(a(1)),
        fee=100, seqNum=7, timeBounds=None, memo=pkg.Memo.none(),
        operations=[pkg.Operation(
            sourceAccount=None,
            body=pkg.OperationBody(
                pkg.OperationType.PAYMENT,
                pkg.PaymentOp(
                    destination=pkg.MuxedAccount.from_account_id(a(2)),
                    asset=pkg.Asset.native(), amount=5)))],
        ext=pkg._Ext.v0())
    return pkg.TransactionEnvelope.for_tx(tx)


def test_transaction_envelope_roundtrip():
    env = _payment_envelope(X)
    assert X.TransactionEnvelope.from_xdr(env.to_xdr()) == env
    assert env.to_xdr() == X.TransactionEnvelope.from_xdr(
        env.to_xdr()).to_xdr()
    assert env.to_xdr() == _payment_envelope(RX).to_xdr()


def test_stellar_message_roundtrip():
    m = X.StellarMessage(X.MessageType.GET_TX_SET, b"\x07" * 32)
    assert X.StellarMessage.from_xdr(m.to_xdr()) == m
    err = X.StellarMessage(
        X.MessageType.ERROR_MSG, X.Error(code=X.ErrorCode.ERR_AUTH, msg="no"))
    assert X.StellarMessage.from_xdr(err.to_xdr()) == err
    assert err.to_xdr() == RX.StellarMessage(
        RX.MessageType.ERROR_MSG,
        RX.Error(code=RX.ErrorCode.ERR_AUTH, msg="no")).to_xdr()


def test_trailing_bytes_rejected():
    a = X.Asset.native()
    with pytest.raises(XdrError):
        X.Asset.from_xdr(a.to_xdr() + b"\x00\x00\x00\x00")


def _sample_account_entry():
    a = X.AccountEntry(
        accountID=acc(1), balance=500, seqNum=7, numSubEntries=1,
        inflationDest=acc(2), flags=0, homeDomain="example.com",
        thresholds=bytes([1, 0, 0, 0]),
        signers=[X.Signer(key=X.SignerKey.ed25519(bytes([9] * 32)),
                          weight=5)],
        ext=X.AccountEntryExt.v0())
    return X.LedgerEntry(lastModifiedLedgerSeq=3,
                         data=X.LedgerEntryData(X.LedgerEntryType.ACCOUNT, a),
                         ext=X._Ext.v0())


def test_compile_copy_equals_and_is_deep():
    e = _sample_account_entry()
    cp = fastcodec.compile_copy(X.LedgerEntry)(e)
    assert cp is not e
    assert cp.to_xdr() == e.to_xdr()
    cp.data.value.balance = 123
    cp.data.value.signers[0].weight = 99
    cp.data.value.signers.append(
        X.Signer(key=X.SignerKey.ed25519(bytes([8] * 32)), weight=1))
    cp.lastModifiedLedgerSeq = 44
    assert e.data.value.balance == 500
    assert e.data.value.signers[0].weight == 5
    assert len(e.data.value.signers) == 1
    assert e.lastModifiedLedgerSeq == 3


def test_compile_copy_void_arm_and_optional_none():
    ext = X._Ext.v0()                    # void union arm
    cpx = fastcodec.compile_copy(type(ext))(ext)
    assert cpx.disc == ext.disc and cpx.value is None
    a = _sample_account_entry().data.value
    a.inflationDest = None               # optional absent
    cpa = fastcodec.compile_copy(X.AccountEntry)(a)
    assert cpa.inflationDest is None
    assert cpa.to_xdr() == a.to_xdr()


def test_compile_copy_matches_roundtrip_on_header():
    h = genesis_header()
    cp = fastcodec.compile_copy(X.LedgerHeader)(h)
    assert cp.to_xdr() == h.to_xdr()
    cp.ledgerSeq += 1
    cp.skipList[0] = b"\x01" * 32
    assert cp.to_xdr() != h.to_xdr()
    assert h.skipList[0] != b"\x01" * 32


def test_no_native_route():
    assert not hasattr(C, "_native_of")
    e = _sample_account_entry()
    assert C.xdr_bytes(X.LedgerEntry, e) == e.to_xdr()
    assert C.xdr_from(X.LedgerEntry, e.to_xdr()) == e


def test_exports_equal_the_reference():
    ref = {n for n in dir(RX) if not n.startswith("__")}
    port = {n for n in dir(X) if not n.startswith("__")}
    assert ref == port


# --- the differential: seeded random values through both codecs -------------

def _draw(t, pkg, r: random.Random, depth: int = 0):
    """A random value of XDR type `t` of package `pkg` (either codec).
    Walks the type tree by the combinators' class names, so the same
    stream of draws builds the same value in both packages."""
    cm = pkg.codec
    kind = type(t).__name__
    small = 3 if depth < 3 else 0
    if kind == "_Int":
        lo, hi = t._lo, t._hi
        return r.choice([lo, hi, 0, r.randint(lo, hi), r.randint(0, 1000)])
    if kind == "_Bool":
        return r.random() < 0.5
    if kind == "Opaque":
        return bytes(r.getrandbits(8) for _ in range(t.n))
    if kind == "VarOpaque":
        n = r.randint(0, min(t.maxn, 9))
        return bytes(r.getrandbits(8) for _ in range(n))
    if kind == "XdrString":
        n = r.randint(0, min(t._o.maxn, 9))
        return "".join(r.choice("abcxyz09-.") for _ in range(n))
    if kind == "FixedArray":
        return [_draw(t.elem, pkg, r, depth + 1) for _ in range(t.n)]
    if kind == "VarArray":
        n = r.randint(0, min(t.maxn, small))
        return [_draw(t.elem, pkg, r, depth + 1) for _ in range(n)]
    if kind == "OptionalT":
        if depth >= 3 or r.random() < 0.4:
            return None
        return _draw(t.elem, pkg, r, depth + 1)
    if kind == "EnumT":
        return r.choice(sorted(t.values))
    if isinstance(t, type) and issubclass(t, cm.XdrStruct):
        return t(**{n: _draw(ft, pkg, r, depth + 1)
                    for n, ft in t.xdr_fields})
    if isinstance(t, type) and issubclass(t, cm.XdrUnion):
        disc = r.choice(sorted(t.xdr_arms))
        at = t.xdr_arms[disc][1]
        return t(disc, None if at is None else _draw(at, pkg, r, depth + 1))
    raise AssertionError("no generator for %r" % (t,))


TYPES = ("LedgerEntry", "BucketEntry", "LedgerHeader", "TransactionEnvelope",
         "LedgerKey", "TransactionResult", "SCPEnvelope", "StellarMessage")


@pytest.mark.parametrize("name", TYPES)
@pytest.mark.parametrize("seed", range(12))
def test_random_values_agree_both_ways(name, seed):
    rt, pt = getattr(RX, name), getattr(X, name)
    ref_v = _draw(rt, RX, random.Random(seed))
    port_v = _draw(pt, X, random.Random(seed))
    ref_b = ref_v.to_xdr()
    port_b = port_v.to_xdr()
    assert port_b == ref_b                          # same value, same bytes
    assert pt.from_xdr(ref_b).to_xdr() == ref_b     # reference -> port
    assert rt.from_xdr(port_b).to_xdr() == port_b   # port -> reference
    assert pt.from_xdr(ref_b) == port_v


@pytest.mark.parametrize("seed", range(4))
def test_truncated_and_trailing_rejected_alike(seed):
    for name in TYPES:
        b = _draw(getattr(RX, name), RX, random.Random(seed)).to_xdr()
        for bad in (b[:-1], b + b"\x00" * 4):
            with pytest.raises(RX.XdrError):
                getattr(RX, name).from_xdr(bad)
            with pytest.raises(XdrError):
                getattr(X, name).from_xdr(bad)
