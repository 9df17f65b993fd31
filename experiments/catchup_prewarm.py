#!/usr/bin/env python3
"""Time catchup's replay on the C verifier with each way of prewarming
its signatures.

    python3 experiments/catchup_prewarm.py [--rounds N]

Run from the root of a checkout; needs a C compiler and no card. A node
on the C verifier (`make_verifier("cpu")`, `make_hasher("cpu")`) and the
Python apply phases publishes `chip_smoke.py`'s R1 history (ledgers
2-131 of the multisig mix, checkpoints 63 and 127: 248,101 signatures).
Fresh nodes on the same stacks then replay it in a complete catchup,
their closes in the apply engine, once per variant and round; the rounds
alternate the order of VARIANTS (ABC, CBA, ...):

- "pipeline": what `ApplyCheckpointWork` does on the C verifier with the
  engine: no checkpoint drain; the `catchup.prewarm-pipeline` worker
  verifies each checkpoint's triples while its ledgers apply;
- "drain": what it does on every other verifier: one `prewarm_many` of
  the checkpoint's triples before its first close;
- "engine": neither; each close's engine verifies its own candidates.

Every replay must end SUCCESS at the publisher's ledger hashes,
bucket-list hash and commitment root. Prints, for each replay, its
seconds, ledgers/s, mean `catchup.apply_ledger` and the signatures the C
library verified (a pair verified twice counts twice), and, as the last
line, one JSON object of them with the host's CPU count and, where
`nvidia-smi` answers, the card's name and power limit.
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

import chip_smoke as CS  # noqa: E402

VARIANTS = ("pipeline", "drain", "engine")


def patches(AW, variant: str) -> dict:
    """ApplyCheckpointWork methods to replace for `variant`."""
    if variant == "drain":
        return {"_prewarm_redundant": lambda self: False}
    if variant == "engine":
        return {"_pipeline_enabled": lambda self: False}
    return {}


def replay(K, AW, tmp: str, r1: dict, name: str, variant: str) -> dict:
    """One complete catchup of R1's archive on a fresh C-verifier node."""
    from stellar_core_tpu_torch.catchup import CatchupConfiguration
    from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
    from stellar_core_tpu_torch.crypto.batch_verifier import make_verifier
    from stellar_core_tpu_torch.util.tracing import Tracer
    from stellar_core_tpu_torch.work.basic_work import State
    tr = Tracer()
    node = CS.r_node(tmp, name, r1["archive"], make_verifier("cpu"),
                     make_hasher("cpu"), tracer=tr)
    CS.check(node.ledger_manager.use_native_apply, "%s: the engine" % name)
    verified = []
    saved = {k: getattr(AW.ApplyCheckpointWork, k)
             for k in patches(AW, variant)}
    batch, one = K.raw_verify_batch, K.raw_verify
    K.raw_verify_batch = lambda t: (verified.append(len(t)), batch(t))[1]
    K.raw_verify = lambda *a: (verified.append(1), one(*a))[1]
    for k, fn in patches(AW, variant).items():
        setattr(AW.ApplyCheckpointWork, k, fn)
    K.flush_verify_cache()
    tr.enable(capacity=1 << 16)
    try:
        with CS.GcPauses() as gcp:
            t0 = time.perf_counter()
            work = node.catchup_manager.start_catchup(
                CatchupConfiguration.complete())
            CS.check(CS.r_crank_until(node, work.is_done, 900.0),
                     "%s: the catchup finished" % name)
            wall = time.perf_counter() - t0
    finally:
        tr.disable()
        K.raw_verify_batch, K.raw_verify = batch, one
        for k, fn in saved.items():
            setattr(AW.ApplyCheckpointWork, k, fn)
    lm = node.ledger_manager
    pub = r1["pub"]
    CS.check(work.state == State.SUCCESS
             and lm.last_closed_ledger_num() == CS.R_TIP
             and CS.r_hashes(node.database, 1, CS.R_TIP)
             == CS.r_hashes(pub.database, 1, CS.R_TIP)
             and node.bucket_manager.get_hash() == r1["bucket_list"]
             and node.state_commitment.root == r1["root"],
             "%s: SUCCESS at the publisher's hashes" % name)
    CS.check(lm.last_apply_path == "native", "%s: closes in the engine"
             % name)
    apply_ms = [d["catchup.apply_ledger"] for d in CS.r_spans(tr).values()
                if "catchup.apply_ledger" in d]
    ledgers = CS.R_TIP - 1
    out = {"variant": variant, "s": wall, "ledgers_per_s": ledgers / wall,
           "apply_ledger_ms": sum(ms for ms, _n in apply_ms)
           / max(sum(n for _ms, n in apply_ms), 1),
           "verified": sum(verified), "verify_calls": len(verified),
           "full_gc_ms": sum(gcp.ms)}
    CS.log("%s (%s): %d ledgers in %.2f s = %.2f ledgers/s; "
           "catchup.apply_ledger mean %.1f ms; %d signatures verified in "
           "%d calls; %s" % (name, variant, ledgers, wall,
                             out["ledgers_per_s"], out["apply_ledger_ms"],
                             out["verified"], out["verify_calls"],
                             gcp.line()))
    CS.r_stop(node)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    from stellar_core_tpu_torch.crypto import keys as K
    from stellar_core_tpu_torch.historywork import apply_works as AW
    from stellar_core_tpu_torch.native import apply_engine
    from stellar_core_tpu_torch.ops import ed25519 as E
    from stellar_core_tpu_torch.ops import sha256 as S
    try:
        card = CS.nvidia_smi("name,power.limit")
    except (OSError, subprocess.SubprocessError):
        card = None
    CS.log("card: %s; host CPUs: %d" % (card, os.cpu_count() or 0))
    CS.check(apply_engine() is not None, "the apply engine builds")
    runs = []
    with tempfile.TemporaryDirectory(prefix="catchup_prewarm_") as tmp:
        r1 = CS.r1_publish(S, E, K, tmp, card or "no card")
        for rnd in range(args.rounds):
            order = VARIANTS if rnd % 2 == 0 else VARIANTS[::-1]
            for variant in order:
                runs.append(replay(K, AW, tmp, r1, "%s-%d" % (variant, rnd),
                                   variant))
        CS.r_stop(r1["pub"])
    mean = {v: {k: sum(r[k] for r in runs if r["variant"] == v)
                / max(sum(1 for r in runs if r["variant"] == v), 1)
                for k in ("s", "ledgers_per_s", "apply_ledger_ms",
                          "verified")}
            for v in VARIANTS}
    print(json.dumps({"card": card, "host_cpus": os.cpu_count(),
                      "runs": runs, "mean": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
