#!/usr/bin/env python3
"""Time the rounds of `chip_smoke.py`'s O2 on each verify stack.

    python3 experiments/overlay_tcp_rounds.py [--stacks cpu,cuda-async]
                                              [--repeat N]
                                              [--txset-cache on|off]

Run from the root of a checkout. For each stack named (`make_verifier`'s
backend: "cpu", the C verifier, needs no card; "cuda" and "cuda-async"
need one; "cpu-async" is the async layer, `ThreadedBatchVerifier`, over
the C verifier behind the resilient layer, prewarming as the card's
stack does, for a host without a card), in turn and `--repeat` times: four validators in a 3-of-4
quorum, each the port's `Application` on a REAL_TIME clock with that
verify backend (no warmup) and the card's bare hasher ("cuda") beside a
card stack or the CPU's beside "cpu", over localhost TCP (each door on a port the
kernel picks), closing on their own timers and cranked in turn by one
thread, as O2 cranks them. Traffic is O2's: a round that funds 100
senders, one that arms each with 19 extra signers, then 2 rounds of 100
20-signature payments, each submitted at node 0 and cranked until every
node applied it. Prints each round's seconds, the ledgers it took, the
herders' nomination-mode `validate_value` calls and their seconds, the
checks of a txset they made (`TxSetFrame.check_or_trim`) and the highest
nomination round and, as the last line, one JSON object of them with the
card's name and power limit where `nvidia-smi` answers. `--txset-cache
off` gives each herder a txset validity cache that keeps nothing, as the
reference's herder checks a nominated txset at every nomination (ROADMAP
Queue 3 item 11). No check of the card's decisions here:
`chip_smoke.py`'s O2 makes those.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

SENDERS, SIGS, LOADED, NODES = 100, 20, 2, 4
ROUND_S = 300.0


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


class NoCache:
    """A txset validity cache that keeps nothing."""

    def maybe_get(self, key):
        return None

    def put(self, key, value) -> None:
        pass


class Counts:
    """The herders' nomination-mode `validate_value` calls, their
    seconds, the txset checks they made and the highest nomination round,
    summed over every node since the last `take`."""

    def __init__(self) -> None:
        from stellar_core_tpu_torch.herder import herder as HH
        from stellar_core_tpu_torch.herder import txset as TS
        from stellar_core_tpu_torch.scp import nomination as NOM
        self.take()
        validate = HH.HerderSCPDriver.validate_value
        check = TS.TxSetFrame.check_or_trim
        nominate = NOM.NominationProtocol.nominate
        inside = []
        me = self

        def counted_validate(drv, slot_index, value, nomination):
            inside.append(nomination)
            t0 = time.perf_counter()
            try:
                return validate(drv, slot_index, value, nomination)
            finally:
                inside.pop()
                if nomination:
                    me.validations += 1
                    me.validate_s += time.perf_counter() - t0

        def counted_check(txset, *a, **kw):
            if inside and inside[-1]:
                me.checks += 1
            return check(txset, *a, **kw)

        def counted_nominate(nom, *a, **kw):
            out = nominate(nom, *a, **kw)
            me.max_round = max(me.max_round, nom.round_number)
            return out

        HH.HerderSCPDriver.validate_value = counted_validate
        TS.TxSetFrame.check_or_trim = counted_check
        NOM.NominationProtocol.nominate = counted_nominate

    def take(self) -> dict:
        out = {k: getattr(self, k, 0) for k in (
            "validations", "validate_s", "checks", "max_round")}
        self.validations = self.checks = self.max_round = 0
        self.validate_s = 0.0
        return out


def cpu_async_stack() -> None:
    """Lets the node's `make_verifier` build "cpu-async": the async layer
    over the C verifier behind the resilient layer, prewarming as the
    card's stack does."""
    import stellar_core_tpu_torch.main.application as APP
    from stellar_core_tpu_torch.crypto.batch_verifier import (
        ThreadedBatchVerifier,
    )
    real = APP.make_verifier

    def make(backend, *a, **kw):
        if backend != "cpu-async":
            return real(backend, *a, **kw)
        inner = real("cpu-resilient", *a, **kw)
        inner.primary.wants_prewarm = True
        v = ThreadedBatchVerifier(inner, kw["clock"],
                                  metrics=kw.get("metrics"))
        v.stats = inner.stats
        return v

    APP.make_verifier = make


def one_run(stack: str, tmp: str, counts: Counts, cache: bool) -> list:
    import torch_herder_harness as H
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.main.application import Application
    from stellar_core_tpu_torch.transactions.transaction_frame import (
        TransactionFrame,
    )
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    keys = [H.node_seed(i).public_key for i in range(NODES)]
    qset = H.flat_qset(X, keys, NODES - 1)
    apps = []
    for i in range(NODES):
        cfg = H.node_config(i, qset, True, 10_000)
        cfg.MANUAL_CLOSE = False
        cfg.RUN_STANDALONE = False
        cfg.PEER_PORT = 0
        cfg.SIG_VERIFY_BACKEND = stack
        cfg.HASH_BACKEND = "cuda" if stack.startswith("cuda") else "cpu"
        cfg.SIG_VERIFY_WARMUP = False
        app = Application(VirtualClock(ClockMode.REAL_TIME), cfg)
        if not cache:
            app.herder.scp_driver.txset_valid_cache = NoCache()
        app.enable_buckets(os.path.join(tmp, "%s-%d" % (stack, i)))
        apps.append(app)
    applied = [set() for _ in apps]
    for k, app in enumerate(apps):
        lm = app.ledger_manager
        orig = lm.value_externalized

        def value_externalized(lcd, _o=orig, _k=k):
            _o(lcd)
            applied[_k].update(f.full_hash() for f in lcd.tx_set.frames)

        lm.value_externalized = value_externalized

    def crank_until(pred, timeout_s: float) -> bool:
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            if pred():
                return True
            if not sum(a.crank(False) for a in apps):
                time.sleep(0.001)
        return pred()

    for app in apps:
        app.start()
    ports = [a.config.PEER_PORT for a in apps]
    for i, app in enumerate(apps):
        for j, p in enumerate(ports):
            if j != i:
                app.overlay_manager.peer_manager.ensure_exists(
                    "127.0.0.1", p)
    assert crank_until(lambda: all(
        a.overlay_manager.get_authenticated_peers_count() == NODES - 1
        for a in apps), 60), "the nodes did not authenticate"
    tr = H.Traffic(apps[0].ledger_manager, apps[0].config.network_id,
                   apps[0].network_root_key(), SENDERS, SIGS)
    rounds = []
    for label in ["funds", "arms"] + ["loaded"] * LOADED:
        blobs = tr.fund() if label == "funds" else tr.arm() \
            if label == "arms" else tr.payments(len(rounds) + 10)
        good = set()
        for blob in blobs:
            f = TransactionFrame.make_from_wire(
                apps[0].config.network_id,
                X.TransactionEnvelope.from_xdr(blob))
            assert apps[0].submit_transaction(f) == 0
            good.add(f.full_hash())
        seq0 = apps[0].ledger_manager.last_closed_ledger_num()
        counts.take()
        t0 = time.perf_counter()
        assert crank_until(lambda: all(good <= s for s in applied),
                           ROUND_S), "%s: %s never applied" % (stack, label)
        rounds.append({"round": label, "s": time.perf_counter() - t0,
                       "ledgers": apps[0].ledger_manager
                       .last_closed_ledger_num() - seq0, **counts.take()})
        r = rounds[-1]
        print("%s %s: %.3f s, %d ledgers; %d nomination validations in "
              "%.3f s, %d txset checks, nomination round %d at most"
              % (stack, label, r["s"], r["ledgers"], r["validations"],
                 r["validate_s"], r["checks"], r["max_round"]), flush=True)
    for app in apps:
        app.stop()
    return rounds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stacks", default="cpu,cuda-async")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--txset-cache", choices=("on", "off"), default="on")
    args = ap.parse_args()
    cpu_async_stack()
    counts = Counts()
    out = {"card": card(), "txset_cache": args.txset_cache, "runs": []}
    with tempfile.TemporaryDirectory(prefix="overlay_tcp_rounds_") as tmp:
        for r in range(args.repeat):
            for stack in args.stacks.split(","):
                d = os.path.join(tmp, "%d" % r)
                os.makedirs(d, exist_ok=True)
                out["runs"].append({"stack": stack, "rounds": one_run(
                    stack, d, counts, args.txset_cache == "on")})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
