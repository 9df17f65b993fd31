"""Hash-seed differential probe: the runtime twin of the static
set-order rule (the reference's sctlint S1).

Copied from `stellar_core_tpu/testing/hashseed_probe.py` at commit
94afec1; carry a fix in either copy to the other. Nothing is left out.
One deliberate difference: `--backend` (default "cuda-resilient", the
card's stacks) names the stacks of the probe's three nodes
(`simulation/topologies.core`'s `backend`); with no card and no CPU named
the probe raises. The differential test passes `--backend cpu`. As it
exits, the probe writes one line to its standard error, `hashseed_probe
launches` and a JSON list of each node's verify and hash launch counts
(`CommandHandler.launch_counters`, after the nodes' warmups): its
standard output stays the reference's, byte for byte.

S1 bans set-ordered iteration from feeding consensus-visible values,
because CPython randomizes str/bytes hashing per process
(`PYTHONHASHSEED`) and set iteration order with it. This probe runs a
seeded 3-node loopback consensus simulation (buckets enabled, so every
close's commitment is hashed; a funded account created mid-run so txsets
are non-empty), records every node's per-height header hash, bucket-list
hash and txset apply-order, and prints the whole record as canonical
JSON on stdout. Run in two processes under different `PYTHONHASHSEED`
values, the two outputs must be byte-identical; inside one run the three
nodes must agree height by height, which the probe asserts itself.

Run directly: `python -m stellar_core_tpu_torch.testing.hashseed_probe
[--heights N] [--backend NAME]`.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


def collect(heights: int = 4, max_rounds: int = 200000,
            backend: str = "cuda-resilient",
            launches: Optional[list] = None) -> dict:
    """Drive the sim on `backend`'s stacks and return {node: {height:
    record}} where record = {header, bucket_list, txs}. Hashes are hex;
    txs is the apply-order list of full tx hashes in the externalized
    txset. Where `launches` is given, each node's launch counts are
    appended to it before the nodes stop."""
    from ..crypto.keys import SecretKey
    from ..simulation import topologies
    from ..testing import AppLedgerAdapter

    sim = topologies.core(3, 2, backend=backend)
    for node in sim.nodes.values():
        node.app.enable_buckets()
    sim.start_all_nodes()

    records: dict = {name: {} for name in sim.nodes}

    def poll() -> None:
        for name, node in sim.nodes.items():
            lm = node.app.ledger_manager
            seq = lm.last_closed_ledger_num()
            d = records[name]
            if seq in d or seq < 1:
                continue
            header = lm.lcl_header
            txs = []
            ts = node.app.herder.pending.get_tx_set(
                header.scpValue.txSetHash)
            if ts is not None:
                txs = [f.full_hash().hex() for f in ts.sort_for_apply()]
            d[seq] = {"header": lm.lcl_hash.hex(),
                      "bucket_list": header.bucketListHash.hex(),
                      "txs": txs}

    def done_through(target: int):
        def pred() -> bool:
            poll()
            return sim.have_all_externalized(target)
        return pred

    if not sim.crank_until(done_through(2), max_rounds):
        raise SystemExit("probe: consensus never reached height 2")

    # a deterministic payment so at least one txset is non-empty (the
    # seeded test key stream, not os.urandom — the probe's output must
    # be identical across runs)
    first = next(iter(sim.nodes.values()))
    root = AppLedgerAdapter(first.app).root_account()
    alice = SecretKey.pseudo_random_for_testing()
    frame = root.tx([root.op_create_account(alice.public_key, 10 ** 9)])
    if first.app.submit_transaction(frame) != 0:
        raise SystemExit("probe: payment submission refused")

    if not sim.crank_until(done_through(heights), max_rounds):
        raise SystemExit("probe: consensus never reached height %d"
                         % heights)
    poll()
    if launches is not None:
        for node in sim.nodes.values():
            node.app.wait_for_warmups()
            launches.append(node.app.command_handler.launch_counters())
    sim.stop_all_nodes()

    # intra-run agreement first: the three nodes must already match
    # height-by-height, otherwise the diff against the other hash seed
    # would blame the wrong thing
    names = sorted(records)
    for h in range(1, heights + 1):
        per = [(n, records[n].get(h)) for n in names]
        vals = {json.dumps(r, sort_keys=True) for (_, r) in per
                if r is not None}
        if len(vals) > 1:
            raise SystemExit("probe: nodes diverged at height %d: %r"
                             % (h, per))
    if not any(records[n].get(h, {}).get("txs")
               for n in names for h in records[n]):
        raise SystemExit("probe: no non-empty txset was externalized")

    # heights past `heights` may differ per node (whoever closed last);
    # trim so both subprocess runs compare a common prefix
    return {n: {str(h): r for h, r in records[n].items()
                if h <= heights}
            for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hashseed_probe")
    ap.add_argument("--heights", type=int, default=4)
    ap.add_argument("--backend", default="cuda-resilient",
                    help="the nodes' verify and hash stacks "
                         "(main/config.py's names)")
    args = ap.parse_args(argv)
    launches: list = []
    out = collect(args.heights, backend=args.backend, launches=launches)
    json.dump(out, sys.stdout, indent=1, sort_keys=True)
    sys.stdout.write("\n")
    sys.stderr.write("hashseed_probe launches %s\n"
                     % json.dumps(launches, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
