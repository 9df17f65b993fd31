"""The port's SCP (`stellar_core_tpu_torch/scp/`) held against the JAX
package's.

Every case of `tests/test_scp.py`, `test_scp_ballot_vectors.py`,
`test_scp_ballot_vectors2.py` and `test_scp_nomination_vectors.py` runs
twice from its own source (`torch_mirror_harness.Mirror`): once as
written, on the reference's `SCP`, and once with every `stellar_core_tpu`
import pointed at the port. Each run passes its own assertions, and both
runs record, through a wrapper around the test driver that `SCP` is
handed, every envelope emitted (as XDR bytes), every timer set or
cancelled (slot, timer, timeout, armed) and every value externalized. The
two transcripts must be equal: the same statements in the same order,
byte for byte. No tolerance.
"""

import pytest

from torch_mirror_harness import Mirror


class RecordingDriver:
    """Hands every SCPDriver call on to the test's driver, and appends
    the calls that carry consensus output to `log`."""

    def __init__(self, drv, log: list) -> None:
        object.__setattr__(self, "_drv", drv)
        object.__setattr__(self, "_log", log)

    def __getattr__(self, name):
        return getattr(self._drv, name)

    def __setattr__(self, name, value):
        setattr(self._drv, name, value)

    def emit_envelope(self, envelope) -> None:
        self._log.append(("emit", envelope.to_xdr()))
        self._drv.emit_envelope(envelope)

    def setup_timer(self, slot_index, timer_id, timeout, cb) -> None:
        self._log.append(("timer", slot_index, int(timer_id),
                          float(timeout), cb is not None))
        self._drv.setup_timer(slot_index, timer_id, timeout, cb)

    def value_externalized(self, slot_index, value) -> None:
        self._log.append(("externalize", slot_index, bytes(value)))
        self._drv.value_externalized(slot_index, value)


def _record_scp(side, pkg, mods, log) -> None:
    """Every module's `SCP` becomes a subclass that wraps its driver."""
    base = __import__(pkg + ".scp.scp", fromlist=["SCP"]).SCP

    class RecordingSCP(base):
        def __init__(self, driver, *a, **kw):
            super().__init__(RecordingDriver(driver, log), *a, **kw)

    for mod in mods.values():
        mod.SCP = RecordingSCP


MIRROR = Mirror(("test_scp.py", "test_scp_ballot_vectors.py",
                 "test_scp_ballot_vectors2.py",
                 "test_scp_nomination_vectors.py"),
                hook=_record_scp, siblings=("test_scp_ballot_vectors",))
CASES = MIRROR.cases()


def test_reference_cases_collected():
    per_file = {}
    for f, _n, _i in CASES:
        per_file[f] = per_file.get(f, 0) + 1
    # 11 + 40 + 18 + 10 test functions; two of the 18 are parametrized
    # three ways
    assert per_file == {"test_scp.py": 11,
                        "test_scp_ballot_vectors.py": 40,
                        "test_scp_ballot_vectors2.py": 22,
                        "test_scp_nomination_vectors.py": 10}


@pytest.mark.parametrize("case", CASES, ids=[Mirror.case_id(c)
                                             for c in CASES])
def test_port_scp_equals_reference(case):
    ref = MIRROR.run("ref", case)
    port = MIRROR.run("port", case)
    assert port == ref
