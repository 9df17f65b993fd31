"""What a mirrored operation-semantics case leaves behind, recorded the
same way on either package and compared byte for byte.

`op_records(pkg, log, verifier=None)` is a `torch_mirror_harness.Mirror`
patch: while a case runs, every `TestLedger.apply_frame`,
`TestLedger.close_with` and `AppLedgerAdapter.apply_frame` appends its
return value, each frame's `TransactionResult` as XDR (a fee bump's inner
result too), the ledger's header as XDR and a SHA-256 over the root's
entries as XDR in key order; every `LedgerManager.close_ledger` appends
the closed header as XDR. `DEFAULT_LEDGER_VERSION` is pinned to 13 on the side for the length
of the case (the suite's `--protocol-version` rewrites the reference's
alone). `verifier`, where given, is what a port `TestLedger` built without
a verifier takes instead of the card's `make_verifier()`: the host's
verifier in tier-1, a counting twin in `chip_smoke.py`'s T1.

`ltx_records(pkg, log)` records, after every `LedgerTxn.commit` and
`rollback`, the root's entries (XDR in key order) and header.

`record_raises` is a `Mirror` hook: each module's `pytest` becomes a
proxy whose `raises` appends the expected and the caught exception's type
names.

`VERIFIER_SUBS` rewrite both sides' source where a case hands a queue or
a frame no verifier (`verifier=None`, `check_valid(ltx, 0, None)`): the
case passes its ledger's verifier instead. The reference's `TestLedger`
holds None there, so its side runs as written; the port's verifies only
through a verifier it is given (no CPU fallback), the card's in T1.

Records hold XDR, return codes and exception type names only: never a
repr, a class of one package (`Tpu*` / `Cuda*`) or a time. This module
imports neither package at load, nor JAX, so the card's host can use it.
"""

import contextlib
import hashlib
from unittest import mock

import pytest

from torch_mirror_harness import record_calls

PINNED_LEDGER_VERSION = 13

VERIFIER_SUBS = (
    (r"verifier=None\)", "verifier=led.verifier)"),
    (r"check_valid\(ltx, 0, None\)", "check_valid(ltx, 0, ledger.verifier)"),
)

# the port side's Application configs name the CPU (the port's
# `Config.test_config` defaults to it already; named here so that a
# changed default cannot move a mirror onto the card)
CPU_CONFIG_SUBS = (
    (r"\bConfig\.test_config\((\d+)\)",
     r'Config.test_config(\1, backend="cpu")'),
)

# the reference's TPU names, pointed at the port's: its verifier the
# card's on the host (the kernel's plain version)
TPU_NAME_SUBS = (
    (r"\bTpuSigVerifier\(\)", 'CudaSigVerifier(device="cpu")'),
    (r"\bTpuSigVerifier\b", "CudaSigVerifier"),
    (r'"tpu-async"', '"cuda-async"'),
    (r"import verify_batch_jit", "import verify_kernel as verify_batch_jit"),
)


def host_verifier():
    """The port's C verifier: what a port `TestLedger` verifies with in
    tier-1, where there is no card."""
    from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
    return CpuSigVerifier()


def _xdr(x):
    return None if x is None else x.to_xdr()


def _result_xdr(r):
    """A result as XDR; a fee bump's inner result whose operation results
    the outer check left unset (None: no XDR form) as its code alone."""
    try:
        return _xdr(r)
    except AttributeError:
        return ("code", int(r.code))


def frame_results(frame) -> list:
    """Each frame's result as XDR, a fee bump's inner result after it."""
    out = [_xdr(frame.result)]
    inner = getattr(frame, "inner", None)
    if inner is not None:
        out.append(_result_xdr(inner.result))
    return out


def entries_sha256(X, root) -> str:
    """SHA-256 over the root's entries as XDR, in key order."""
    h = hashlib.sha256()
    for _k, blob in sorted((X.ledger_entry_key(e).to_xdr(), e.to_xdr())
                           for e in root.all_entries()):
        h.update(blob)
    return h.hexdigest()


@contextlib.contextmanager
def op_records(pkg: str, log: list, verifier=None):
    testing = __import__(pkg + ".testing", fromlist=["x"])
    lm = __import__(pkg + ".ledger.ledger_manager", fromlist=["x"])
    X = __import__(pkg + ".xdr", fromlist=["x"])

    def state(ledger, root) -> tuple:
        return (ledger.header().to_xdr(), entries_sha256(X, root))

    def apply(out, ledger, frame):
        return (bool(out), frame_results(frame)) + state(ledger, ledger.root)

    def close_with(out, ledger, frames):
        return ([bool(x) for x in out],
                [frame_results(f) for f in frames]) + state(ledger,
                                                            ledger.root)

    def app_apply(out, adapter, frame):
        return (bool(out), frame_results(frame)) + state(adapter,
                                                         adapter._root())

    targets = [
        (testing.TestLedger, "apply_frame", apply),
        (testing.TestLedger, "close_with", close_with),
        (testing.AppLedgerAdapter, "apply_frame", app_apply),
        (lm.LedgerManager, "close_ledger",
         lambda _out, m, _lcd: m.lcl_header.to_xdr()),
    ]
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            testing, "DEFAULT_LEDGER_VERSION", PINNED_LEDGER_VERSION))
        if verifier is not None and hasattr(testing, "make_verifier"):
            stack.enter_context(mock.patch.object(testing, "make_verifier",
                                                  verifier))
        stack.enter_context(record_calls(log, targets))
        yield


def ltx_records(pkg: str, log: list):
    L = __import__(pkg + ".ledger.ledgertxn", fromlist=["x"])
    X = __import__(pkg + ".xdr", fromlist=["x"])

    def root_state(_out, ltx) -> tuple:
        root = ltx
        while isinstance(root, L.LedgerTxn):
            root = root._parent
        return (sorted((X.ledger_entry_key(e).to_xdr(), e.to_xdr())
                       for e in root.all_entries()),
                _xdr(root.get_header()))

    return record_calls(log, [(L.LedgerTxn, "commit", root_state),
                              (L.LedgerTxn, "rollback", root_state)])


def _names(expected) -> tuple:
    return tuple(t.__name__ for t in expected) \
        if isinstance(expected, tuple) else (expected.__name__,)


class RecordingPytest:
    """`pytest` for a mirrored module, its `raises` recorded."""

    def __init__(self, log: list) -> None:
        self._log = log

    def __getattr__(self, name):
        return getattr(pytest, name)

    def raises(self, expected, *args, **kw):
        if args:                       # pytest.raises(E, fn, *args)
            info = pytest.raises(expected, *args, **kw)
            self._log.append(("raises", _names(expected),
                              type(info.value).__name__))
            return info
        return self._raises(expected, kw)

    @contextlib.contextmanager
    def _raises(self, expected, kw):
        with pytest.raises(expected, **kw) as info:
            yield info
        self._log.append(("raises", _names(expected),
                          type(info.value).__name__))


def record_raises(side, pkg, mods, log) -> None:
    for mod in mods.values():
        if getattr(mod, "pytest", None) is pytest:
            mod.pytest = RecordingPytest(log)
