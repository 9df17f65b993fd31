"""The control of the comparison that decides `correct`: the reference put
in the port's place with one of the configuration's guarantees broken,
at the cell's own size, on several seeds. Every seed's result has to come
out not correct; the unbroken reference, put there the same way, has to
come out correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        [--control canonical_s|cofactored] [--workers N]

It prints one JSON line a seed with each check's value beside its limit.
The benchmark's own runs never run it. It needs no card: the control's
decisions come from the reference, on the host's cores.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

from . import core
from .run import find_cell, load_benchmark
from .yardstick import ed25519_ref as ref
from .yardstick import xdr as X

CONTROLS = {
    "none": {},
    "canonical_s": {"canonical_s": False},
    "cofactored": {"cofactored": True},
}


def _decide(args):
    items, flags = args
    return [ref.verify(k, s, m, **flags) for (k, s, m) in items]


def decide_all(items, flags: dict, workers: int) -> list:
    """The reference's decisions of (key, sig, msg) items, in order, on
    `workers` processes."""
    if workers <= 1 or len(items) < 1000:
        return _decide((items, flags))
    step = -(-len(items) // (workers * 4))
    chunks = [(items[i:i + step], flags) for i in range(0, len(items), step)]
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as ex:
        return [ok for part in ex.map(_decide, chunks) for ok in part]


def control_checks(root: str, workload: str, seed: int, control: str,
                   seconds: float, workers: int) -> list:
    """The checks of one seed's run with the control in the port's place."""
    bench = load_benchmark(root)
    _cell, config, traffic = find_cell(root, bench, workload)
    flags = CONTROLS[control]
    if traffic["kind"] == "checkpoint":
        from .kinds import checkpoint
        workdir = tempfile.mkdtemp(prefix="portbench-control-")
        try:
            inputs = checkpoint.generate(config, traffic, seed, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        triples = list(inputs.triples)
        decisions = decide_all(triples, flags, workers)
        return checkpoint.judge(inputs,
                                [checkpoint.pack_drain(triples, decisions)],
                                seed,
                                traffic["reference_sample"], 1)
    from .kinds import scp
    inputs = scp.generate(config, traffic, seed, seconds)
    items = [(e.node, e.sig, X.scp_sign_bytes(inputs.network_id,
                                              e.statement))
             for e in inputs.window]
    return scp.judge(inputs, decide_all(items, flags, workers))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="canonical_s",
                    choices=sorted(CONTROLS))
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window of the traffic (default run_seconds)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args(argv)
    root = os.getcwd()
    seconds = args.seconds or load_benchmark(root)["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = control_checks(root, args.workload, seed, args.control,
                                seconds, args.workers)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control": args.control,
            "correct": all(c.ok for c in checks),
            "checks": {c.name: {"value": c.value, "limit": c.limit}
                       for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
