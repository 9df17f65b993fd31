"""The port's StrKey codec and temporary directories against the reference.

`crypto/strkey.py` and `util/tmpdir.py` are copies of the JAX package's
modules of the same names. StrKey strings are what operators type and
logs print, so the port must encode the same text from the same bytes and
refuse the same damaged strings. TmpDir / TmpDirManager own directories
that are removed, so their lifetimes are held against the reference's
inside pytest's `tmp_path` only.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from stellar_core_tpu.crypto import strkey as ref_strkey
from stellar_core_tpu.util import tmpdir as ref_tmpdir
from stellar_core_tpu_torch.crypto import strkey
from stellar_core_tpu_torch.util import tmpdir

VERSIONS = ("PUBKEY", "SEED", "PRE_AUTH_TX", "HASH_X")


def _payloads(seed, n=16):
    rng = np.random.default_rng(seed)
    out = [bytes(32), b"\xff" * 32]
    out += [rng.bytes(32) for _ in range(n)]
    return out


@pytest.mark.parametrize("version", VERSIONS)
def test_strkey_encode_decode_equal_the_reference(version):
    v = getattr(strkey.StrKeyVersion, version)
    assert v == getattr(ref_strkey.StrKeyVersion, version)
    for raw in _payloads(seed=len(version)):
        s = strkey.encode(v, raw)
        assert s == ref_strkey.encode(v, raw)
        assert strkey.decode(v, s) == raw
        assert ref_strkey.decode(v, s) == raw


def test_strkey_key_helpers_equal_the_reference():
    for raw in _payloads(seed=5):
        g = strkey.encode_public_key(raw)
        s = strkey.encode_seed(raw)
        assert g == ref_strkey.encode_public_key(raw) and g[0] == "G"
        assert s == ref_strkey.encode_seed(raw) and s[0] == "S"
        assert strkey.decode_public_key(g) == raw
        assert strkey.decode_seed(s) == raw


def _refusal(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    except Exception as e:  # binascii.Error is a ValueError; keep the kind
        return type(e).__name__
    return None


def test_strkey_refuses_what_the_reference_refuses():
    rng = np.random.default_rng(11)
    raw = rng.bytes(32)
    g = strkey.encode_public_key(raw)
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZ234567"
    cases = []
    # every single-character change must break the CRC16 or the version
    for i in range(len(g)):
        c = alphabet[(alphabet.index(g[i]) + 1) % 32]
        cases.append(g[:i] + c + g[i + 1:])
    cases += [
        strkey.encode_seed(raw),                       # wrong version byte
        strkey.encode(strkey.StrKeyVersion.PUBKEY, raw[:31]),   # short key
        strkey.encode(strkey.StrKeyVersion.PUBKEY, b""),        # empty key
        "GA",                                          # shorter than a CRC
    ]
    for s in cases:
        mine = _refusal(strkey.decode_public_key, s)
        assert mine is not None, s
        assert mine == _refusal(ref_strkey.decode_public_key, s), s
    assert _refusal(strkey.decode_seed, g) == "strkey wrong version byte"
    assert _refusal(strkey.decode_public_key, cases[-2]) == \
        "bad public key length"


def test_tmpdir_lifetime_equals_the_reference(tmp_path):
    for mod, name in ((tmpdir, "port"), (ref_tmpdir, "ref")):
        root = str(tmp_path / name)
        d = mod.TmpDir(prefix="bucket", root=root)
        assert os.path.isdir(d.path)
        assert os.path.dirname(d.path) == root
        assert os.path.basename(d.path).startswith("bucket-")
        assert d.join("a", "b") == os.path.join(d.path, "a", "b")
        d.remove()
        assert not os.path.exists(d.path)
        d.remove()                       # a second remove is harmless
        with mod.TmpDir(prefix="ctx", root=root) as c:
            open(c.join("f"), "w").close()
            assert os.path.isfile(c.join("f"))
        assert not os.path.exists(c.path)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref")) == []


def test_tmpdir_manager_cleans_its_root_alike(tmp_path):
    for mod, name in ((tmpdir, "port"), (ref_tmpdir, "ref")):
        root = tmp_path / name
        root.mkdir()
        (root / "stale").write_text("left by an earlier run")
        beside = tmp_path / (name + "-beside")
        beside.mkdir()
        m = mod.TmpDirManager(str(root))
        assert os.listdir(root) == []          # cleaned when built
        assert beside.is_dir()                 # nothing outside its root
        d = m.tmp_dir("work")
        assert os.path.dirname(d.path) == str(root)
        m.clean()
        assert not root.exists()
        assert beside.is_dir()
