"""The port's XDR codec C route (`native/xdrc.c`) held against its
`fastcodec` route and the reference's C route.

Every test of `tests/test_native_xdr.py` (10) runs on the port from the
reference's own source (`torch_mirror_harness.Mirror`): the C route's
pack and unpack give the bytes and values of the port's `fastcodec`, and
the same rejections. Each test names its route explicitly
(`xdr_pack_fn` / `xdr_unpack_fn` against `fastcodec.compile_*`), never
through the route `xdr_bytes` cached on the type. The reference's source
reaches its extension module through `_compile_xdr_ext` / `_XDR_MOD`; the
port's is `native.xdr_engine()`, rewritten for both sides to whichever
the side has.

The port's C route decodes each struct and union without a dict of its
own (a fix of the reference's allocation, named in `xdrc.c`'s header).
Cross-package: the port's C route, the reference's C route and the
port's `fastcodec` give the same bytes, and decode to equal values, on
the entry mix (`testing/entries.py`) and on the `TransactionHistoryEntry`
records of one checkpoint's transactions file (eight ledgers of the
ledger-close workload, written by the port's XDR stream). Tolerance:
none.
"""

import numpy as np
import pytest

import stellar_core_tpu.xdr as RX
import stellar_core_tpu_torch.xdr as PX
from stellar_core_tpu import native as RN
from stellar_core_tpu_torch import _build
from stellar_core_tpu_torch import native as N
from stellar_core_tpu_torch.testing import entries as TE
from stellar_core_tpu_torch.xdr import fastcodec

from torch_mirror_harness import Mirror

pytestmark = pytest.mark.skipif(
    _build.find_cc() is None, reason="no C compiler on this host")

SUBS = [(r"native\._compile_xdr_ext\(\)\n    mod = native\._XDR_MOD",
         "mod = (native.xdr_engine() if hasattr(native, 'xdr_engine') "
         "else (native._compile_xdr_ext(), native._XDR_MOD)[1])")]
MIRROR = Mirror(["test_native_xdr.py"], subs=SUBS)
CASES = MIRROR.cases()


def test_mirrors_every_case():
    assert len(CASES) == 10


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_c_route_matches(case):
    MIRROR.run("port", case)


def test_codec_module_loads_from_port_build_dir():
    import os
    mod = N.xdr_engine()
    assert mod.__name__ == "_sctxdr_torch"
    assert os.path.dirname(mod.__file__) == _build.native_build_dir()
    # its rejections raise the port codec's error, not the reference's
    from stellar_core_tpu_torch.xdr.codec import XdrError
    with pytest.raises(XdrError):
        N.xdr_unpack_fn(PX.TimeBounds)(b"\x00" * 7)


def test_c_route_instances_keep_no_dict():
    """A struct or union the C route decodes is made as `object.__new__`
    makes it: its attributes stay inline, with no dict of its own (the
    reference's extension allocates with the bare `tp_alloc`, and each
    instance then carries a dict for the cyclic collector to walk;
    ROADMAP Queue 3). Walks every decoded object of the entry mix without
    touching `__dict__`."""
    import gc
    from stellar_core_tpu_torch.xdr import codec as C
    rng = np.random.default_rng(13)
    unpack = N.xdr_unpack_fn(PX.BucketEntry)
    seen = 0
    todo = [unpack(r)[0] for r in TE.entry_records(rng, 300)]
    while todo:
        v = todo.pop()
        if isinstance(v, list):
            todo.extend(v)
            continue
        if not isinstance(v, (C.XdrStruct, C.XdrUnion)):
            continue
        seen += 1
        assert not any(isinstance(x, dict) for x in gc.get_referents(v)), v
        names = ([n for n, _t in type(v).xdr_fields]
                 if isinstance(v, C.XdrStruct) else ["value"])
        todo.extend(getattr(v, n) for n in names)
    assert seen > 1000


def _three_routes(p_type, r_type, bodies) -> None:
    """Port C route == reference C route == port fastcodec, both ways."""
    p_pack, p_unpack = N.xdr_pack_fn(p_type), N.xdr_unpack_fn(p_type)
    r_pack, r_unpack = RN.xdr_pack_fn(r_type), RN.xdr_unpack_fn(r_type)
    f_pack = fastcodec.compile_pack(p_type)
    f_unpack = fastcodec.compile_unpack(p_type)
    assert None not in (p_pack, p_unpack, r_pack, r_unpack)
    for body in bodies:
        pv, end = p_unpack(body)
        assert end == len(body)
        fv, fend = f_unpack(body, 0)
        assert fend == end and pv == fv
        rv, rend = r_unpack(body)
        assert rend == end
        out = []
        f_pack(out.append, fv)
        assert p_pack(pv) == r_pack(rv) == b"".join(out) == body


def test_entry_mix_same_bytes_on_three_routes():
    rng = np.random.default_rng(12)
    records = TE.entry_records(rng, 2000)
    bodies = [r[4:] for r in records]     # drop the record marks
    _three_routes(PX.LedgerEntry, RX.LedgerEntry, bodies)


def test_checkpoint_tx_history_same_bytes_on_three_routes(tmp_path):
    from stellar_core_tpu_torch.util.xdrstream import (
        XDRInputFileStream, XDROutputFileStream,
    )
    from torch_close_harness import PORT, Workload, close_one, \
        make_port_side
    lm = make_port_side(str(tmp_path / "b"), "in-memory")
    w = Workload(lm)
    path = str(tmp_path / "transactions-00000007.xdr")
    n = 0
    with XDROutputFileStream(path) as out:
        for build, ups in w.schedule():
            prev = lm.lcl_hash
            blobs = [f.envelope_bytes() for f in build()]
            close_one(lm, PORT, blobs, list(ups))
            out.write_one(PX.TransactionHistoryEntry,
                          PX.TransactionHistoryEntry(
                              ledgerSeq=lm.last_closed_ledger_num(),
                              txSet=PX.TransactionSet(
                                  previousLedgerHash=prev,
                                  txs=[PX.TransactionEnvelope.from_xdr(b)
                                       for b in blobs]),
                              ext=PX._Ext.v0()))
            n += 1
            if n == 8:
                break
    raw = open(path, "rb").read()
    bodies, pos = [], 0
    while pos < len(raw):
        size = int.from_bytes(raw[pos:pos + 4], "big") & 0x7FFFFFFF
        bodies.append(raw[pos + 4:pos + 4 + size])
        pos += 4 + size
    assert len(bodies) == 8 and sum(len(b) for b in bodies) > 10_000
    _three_routes(PX.TransactionHistoryEntry, RX.TransactionHistoryEntry,
                  bodies)
    with XDRInputFileStream(path) as ins:
        got = list(ins.read_all(PX.TransactionHistoryEntry))
    assert [g.to_xdr() for g in got] == bodies
    lm.app.bucket_manager.shutdown()
