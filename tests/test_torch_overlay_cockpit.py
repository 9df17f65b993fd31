"""The port's overlay and propagation cockpits
(`stellar_core_tpu_torch/overlay/overlay_stats.py`,
`overlay/propagation_stats.py`) held against the JAX package's.

Every case of `tests/test_overlay_cockpit.py` (15) and of
`tests/test_propagation.py` (13) runs on both packages from the
reference's own source (`torch_mirror_harness.Mirror`), the port's nodes
built by `torch_sim_harness` and the port's `main/application.py`, with
the decisions of `torch_overlay_records.record_overlay` recorded on both
sides and equal, in order: the `overlaystats`, `propagation` and `health`
endpoints, on a live net and over HTTP, and the Prometheus exposition
with its help catalog included. The endpoint case's load, which the
reference makes with `simulation/`'s LoadGenerator (ROADMAP Queue 1 item
9), comes on both sides from a stand-in that submits the same shape
through the node's herder (`LOAD_SUBS`). Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mirror_harness import Mirror  # noqa: E402
from torch_sim_harness import SIM_SUBS  # noqa: E402
import torch_overlay_records as R  # noqa: E402

# the endpoint case's load comes from `simulation/`'s LoadGenerator (not
# ported; ROADMAP Queue 1 item 9): both sides take this stand-in, which
# submits the same shape through the node's herder — one transaction
# creating `n` accounts, then one payment from each of `n` sources (the
# created accounts first, the root after)
LOAD_SUBS = (
    (r"from \w+\.simulation\.load_generator import LoadGenerator",
     "LoadGenerator = _LoadStandIn"),
    (r"(?m)^def _cmd\(app, name, \*\*params\):", '''class _LoadStandIn:
    def __init__(self, app):
        from {pkg}.crypto.hashing import sha256
        from {pkg}.testing import AppLedgerAdapter, TestAccount
        self.app = app
        self.ad = AppLedgerAdapter(app)
        self.root = self.ad.root_account()
        self.keys = []
        self._sha, self._acct = sha256, TestAccount

    def generate_accounts(self, n):
        ks = [SecretKey.from_seed(self._sha(b"load-%d" % (len(self.keys) + i)))
              for i in range(n)]
        self.keys += ks
        self.app.submit_transaction(self.root.tx(
            [self.root.op_create_account(k.public_key, 10**9) for k in ks]))

    def generate_payments(self, n):
        srcs = [self._acct(self.ad, k) for k in self.keys] + [self.root]
        for i in range(n):
            s = srcs[i % len(srcs)]
            self.app.submit_transaction(
                s.tx([s.op_payment(self.root.account_id, 1000 + i)]))


def _cmd(app, name, **params):'''),
)

MIRROR = Mirror(("test_overlay_cockpit.py", "test_propagation.py"),
                patch=R.record_overlay,
                subs=SIM_SUBS + LOAD_SUBS)
CASES = MIRROR.cases()


def test_mirrors_twenty_two_cases():
    """Twenty-eight, since the port has its admin endpoints."""
    by_file = {}
    for f, _n, _i in CASES:
        by_file[f] = by_file.get(f, 0) + 1
    assert by_file == {"test_overlay_cockpit.py": 15,
                       "test_propagation.py": 13}
    # the disabled-cockpit case reads the endpoints on both sides
    src = MIRROR.sides["port"]["mods"]["test_propagation.py"]
    assert "command_handler" in \
        src.test_propagation_disabled_by_config.__code__.co_names


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    sides = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        sides[side] = MIRROR.run(side, case, {"tmp_path": d})
    assert sides["port"] == sides["ref"]
