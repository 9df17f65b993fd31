"""Checkpoint traffic: a node catching up verifies each checkpoint's
signatures before it applies any of its ledgers.

The generator writes one history checkpoint (`ledger-*.xdr`,
`transactions-*.xdr`) of the configuration's `checkpoint_frequency`
ledgers, each full with `max_tx_set_operations` one-payment transactions
over its `ledger_entries` accounts, and the ledger state those
transactions' signer sets resolve against. The window drives the port's
pre-apply stage of that checkpoint, `ApplyCheckpointWork._load` then
`._prewarm` (parse, signature collection, the verify drain, the entry
prefetch), pass after pass in a closed loop, with the verify cache emptied
before each pass so that every pass verifies every signature again.

Traffic keys: `checkpoint` (the last ledger of the checkpoint),
`close_time`, `txs_per_multisig_account`,
`corrupt_per_ledger` (extra signatures per ledger by kind: `bit_flip`,
`s_plus_l`, `mixed_order_r`), `reference_sample` (signatures the reference
verifies beside every corrupted one), `warm_buckets`.
Configuration keys: `network_passphrase`, `checkpoint_frequency`,
`max_tx_set_operations`, `ledger_close_s`, `ledger_entries` (the accounts),
`multisig_accounts`, `extra_signers` ([least, most]), and those
`core.build_node` reads.
"""

from __future__ import annotations

import gc
import itertools
import os
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import core
from ..yardstick import ed25519_ref as ref
from ..yardstick import xdr as X
from ..yardstick.signer import signer

Triple = Tuple[bytes, bytes, bytes]
# a transaction carries at most 20 signatures (DecoratedSignature<20>)
MAX_SIGNATURES = 20


@dataclass
class Inputs:
    network_id: bytes
    accounts: List[bytes]            # LedgerEntry XDR of every account
    triples: Dict[Triple, Optional[bool]]   # expected set -> label
    corrupted: List[Triple]          # the planted signatures' triples
    checkpoint: int                  # its last ledger
    first: int
    n_txs: int


def generate(config: dict, traffic: dict, seed: int,
             workdir: str) -> Inputs:
    """The checkpoint's files under `workdir` and what the reference needs.
    Every seed gives the same sizes: the same accounts, signer counts,
    transactions per account and corrupted signatures per ledger, drawn
    into another order."""
    rng = random.Random(seed)
    sg = signer()
    net = X.sha256(config["network_passphrase"].encode())
    n_acc = config["ledger_entries"]
    seeds = [rng.randbytes(32) for _ in range(n_acc)]
    pubs = [sg.public(s) for s in seeds]
    lo, hi = config["extra_signers"]
    multi = rng.sample(range(n_acc), config["multisig_accounts"])
    signers: Dict[int, List[Tuple[bytes, bytes]]] = {}
    for j, i in enumerate(multi):
        extra = [rng.randbytes(32) for _ in range(lo + j % (hi - lo + 1))]
        signers[i] = [(s, sg.public(s)) for s in extra]

    ledgers = config["checkpoint_frequency"]
    per_ledger = config["max_tx_set_operations"]
    close_s = config["ledger_close_s"]
    n_txs = ledgers * per_ledger
    sources = []
    for i in multi:
        sources += [i] * traffic["txs_per_multisig_account"]
    singles = [i for i in range(n_acc) if i not in signers]
    rng.shuffle(singles)
    base, more = divmod(n_txs - len(sources), len(singles))
    for j, i in enumerate(singles):
        sources += [i] * (base + (1 if j < more else 0))
    rng.shuffle(sources)

    last = traffic["checkpoint"]
    if (last + 1) % ledgers:
        raise ValueError("ledger %d ends no checkpoint of %d ledgers"
                         % (last, ledgers))
    first = last - ledgers + 1
    start_seq = (first - 1) << 32
    accounts = []
    for i in range(n_acc):
        extra = signers.get(i, [])
        med = min(len(extra) + 1, MAX_SIGNATURES) if extra else 0
        accounts.append(X.account_entry(
            pubs[i], 10 ** 10, start_seq, bytes([1, 0, med, med]),
            [(p, 1) for (_s, p) in extra], first - 1))

    # first every transaction, its hash and who signs it (the seed's
    # draws in a fixed order), then every signature at once, then the
    # envelopes and files
    next_seq = [start_seq] * n_acc
    kinds = [k for k, n in sorted(traffic["corrupt_per_ledger"].items())
             for _ in range(n)]
    txs = []     # (tx XDR, hash, {key: seed}, corruption, its bit)
    for li in range(ledgers):
        # the corrupted copies go to single-key transactions, which have
        # room for another signature
        room = [t for t in range(per_ledger)
                if sources[li * per_ledger + t] not in signers]
        planted = dict(zip(rng.sample(room, len(kinds)), kinds))
        for t in range(per_ledger):
            src = sources[li * per_ledger + t]
            next_seq[src] += 1
            dest = rng.randrange(n_acc - 1)
            dest += dest >= src
            tx = X.payment_tx(pubs[src], 100, next_seq[src], pubs[dest],
                              rng.randrange(1, 10 ** 9),
                              traffic["close_time"] + close_s * li + 300)
            keys = {pubs[src]: seeds[src]}
            keys.update((p, s) for (s, p) in signers.get(src, []))
            txs.append((tx, X.tx_contents_hash(net, tx), keys,
                        planted.get(t), rng.randrange(512)))
    # the master key and as many signers as the medium threshold needs,
    # each of weight 1
    jobs = [(s, h) for (_tx, h, keys, _c, _b) in txs
            for s in list(keys.values())[:MAX_SIGNATURES]]
    signed = iter(sg.sign_many(jobs))

    triples: Dict[Triple, Optional[bool]] = {}
    corrupted: List[Triple] = []
    prev_hash = rng.randbytes(32)
    tx_file, ledger_file = [], []
    for li in range(ledgers):
        envelopes = []
        for tx, h, keys, corrupt, bit in txs[li * per_ledger:
                                             (li + 1) * per_ledger]:
            sigs = [(k, next(signed), True)
                    for k in list(keys)[:MAX_SIGNATURES]]
            if corrupt is not None:
                master = sigs[0][0]
                bad = (ref.flip_bit(sigs[0][1], bit) if corrupt == "bit_flip"
                       else ref.s_plus_l(sigs[0][1]) if corrupt == "s_plus_l"
                       else ref.mixed_order_sign(keys[master], h))
                sigs.append((master, bad, False))
                corrupted.append((master, bad, h))
            for (signer_key, sig, good) in sigs:
                # the port's candidate rule: every key of the source's
                # signer set whose hint matches the signature's
                for k in keys:
                    if k[-4:] == signer_key[-4:]:
                        trip = (k, sig, h)
                        label = good if k == signer_key else None
                        if triples.get(trip, label) != label:
                            label = None
                        triples[trip] = label
            envelopes.append(X.tx_envelope(
                tx, [(k[-4:], s) for (k, s, _g) in sigs]))
        seq = first + li
        tx_file.append(X.record(X.transaction_history_entry(
            seq, prev_hash, envelopes)))
        header = X.ledger_header(
            seq, prev_hash, X.sha256(prev_hash + b"".join(envelopes)),
            traffic["close_time"] + close_s * li, rng.randbytes(32),
            rng.randbytes(32), 10 ** 17, 10 ** 9, per_ledger)
        entry = X.ledger_header_history_entry(header)
        ledger_file.append(X.record(entry))
        prev_hash = entry[:32]
    for name, recs in (("ledger", ledger_file), ("transactions", tx_file)):
        with open(os.path.join(workdir, "%s-%08x.xdr" % (name, last)),
                  "wb") as fh:
            fh.write(b"".join(recs))
    return Inputs(net, accounts, triples, corrupted, last, first, n_txs)


class Cell:
    """Set-up, window and checks of one checkpoint-traffic run."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 workdir: str, backend: str, seconds: float) -> None:
        from stellar_core_tpu_torch.ledger.ledgertxn import LedgerTxn
        from stellar_core_tpu_torch.xdr import LedgerEntry
        self.traffic = traffic
        self.seed = seed
        self.workdir = workdir
        self.setup = core.Spans()
        with self.setup.span("generate"):
            self.inputs = generate(config, traffic, seed, workdir)
        if backend.startswith("cuda"):
            core.set_warmup_plan(traffic.get("warm_buckets"))
        with self.setup.span("node"):
            self.app = core.build_node(
                config, core.seed_bytes(seed, "node"), workdir, backend)
        with self.setup.span("accounts"):
            ltx = LedgerTxn(self.app.ledger_manager.ltx_root())
            for b in self.inputs.accounts:
                ltx.create(LedgerEntry.from_xdr(b))
            ltx.commit()
        # every drain's triples and decisions, as the verifier got and
        # gave them, packed into bytes (`pack_drain`) so that the record
        # holds no objects the collector walks and none of the port's
        self.drains: List[Tuple[bytes, bytes]] = []
        verifier = self.app.sig_verifier
        inner = verifier.prewarm_many

        def recorded(triples):
            out = inner(triples)
            self.drains.append(pack_drain(triples, out))
            return out
        verifier.prewarm_many = recorded
        # one whole pass warms every shape and path the window drives
        with self.setup.span("warm_pass"):
            self._pass(core.Spans())
        self.drains.clear()
        self.passes: List[Tuple[float, float]] = []
        self.errors: List[str] = []

    def _pass(self, spans: core.Spans) -> None:
        from stellar_core_tpu_torch.crypto.keys import flush_verify_cache
        from stellar_core_tpu_torch.historywork.apply_works import \
            ApplyCheckpointWork
        inp = self.inputs
        flush_verify_cache()
        work = ApplyCheckpointWork(self.app, self.workdir, inp.checkpoint,
                                   inp.first, inp.checkpoint)
        with spans.span("catchup.load"):
            if not work._load():
                raise RuntimeError("the checkpoint's files did not load")
        with spans.span("catchup.prewarm"):
            work._prewarm()

    def window(self, seconds: float, spans: core.Spans) -> core.Outcome:
        gc.collect()
        with core.GcPauses() as pauses:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                a = time.perf_counter()
                try:
                    self._pass(spans)
                except Exception as e:    # a refused or failed drain
                    self.errors.append("%s: %s" % (type(e).__name__, e))
                    break
                self.passes.append((a, time.perf_counter()))
        end = self.passes[-1][1] if self.passes else time.perf_counter()
        n_expected = len(self.inputs.triples)
        decided = sum(len(codes) - codes.count(2)
                      for (_blob, codes) in self.drains)
        out = core.Outcome()
        out.attempted = n_expected * (len(self.passes) + len(self.errors))
        out.failed = max(0, out.attempted - decided)
        if self.passes:
            out.end_to_end["catchup_sigs_per_s"] = decided / (end - t0)
        out.counts = {"sigs_decided": decided}
        out.log_lines.append("setup: " + self.setup.summary())
        out.log_lines.append(
            "window: %d checkpoints of %d transactions and %d signatures "
            "in %.3f s (each %s s); %s%s"
            % (len(self.passes), self.inputs.n_txs, n_expected, end - t0,
               " ".join("%.3f" % (b - a) for (a, b) in self.passes),
               pauses.summary(),
               "; " + "; ".join(self.errors) if self.errors else ""))
        return out

    def checks(self) -> List[core.Check]:
        return judge(self.inputs, self.drains, self.seed,
                     self.traffic["reference_sample"], len(self.passes),
                     failed_passes=len(self.errors))

    def close(self) -> None:
        core.stop_node(self.app)


# a packed triple: key, signature, message
_TRIPLE = 32 + 64 + 32
_DECISIONS = (False, True, None)


def pack_drain(triples, out) -> Tuple[bytes, bytes]:
    """One drain as (its triples end to end, a byte a decision: 1 true, 0
    false, 2 undecided). A triple of another length leaves the blob's
    length off its count, and `unpack_drain` then reads none of it."""
    return (b"".join(itertools.chain.from_iterable(triples)),
            bytes(1 if ok is True else 0 if ok is False else 2
                  for ok in out))


def unpack_drain(packed: Tuple[bytes, bytes]) -> Tuple[list, list]:
    blob, codes = packed
    if len(blob) % _TRIPLE:
        return [], []
    triples = [(blob[i:i + 32], blob[i + 32:i + 96], blob[i + 96:i + 128])
               for i in range(0, len(blob), _TRIPLE)]
    return triples, [_DECISIONS[c] for c in codes]


def judge(inputs: Inputs, drains, seed: int, sample: int, passes: int,
          failed_passes: int = 0, verify=ref.verify) -> List[core.Check]:
    """The checks of a run's drains, each as `pack_drain` made it,
    against the reference: one drain a pass, the triples it collected (as
    a set, with no repeats), every decision against the generator's label
    (a triple without its decision is wrong), and a seed-drawn sample of
    the decisions, every corrupted signature in it, against `verify`."""
    expected = inputs.triples
    rng = random.Random(seed ^ 0x5EED)
    plain = [t for t in expected if expected[t] is not None]
    picked = set(inputs.corrupted) | \
        {t for t in expected if expected[t] is None} | \
        set(rng.sample(plain, min(sample, len(plain))))
    want = {t: verify(*t) for t in sorted(picked)}
    # a label the reference contradicts is the generator's fault, and
    # makes the run's comparison unsound
    disagree = sum(1 for t, w in want.items()
                   if expected[t] is not None and w is not expected[t])
    wrong_sets = (failed_passes + abs(len(drains) - passes)) * \
        len(expected)
    wrong = 0
    for triples, out in map(unpack_drain, drains):
        seen = set(triples)
        wrong_sets += len(seen.symmetric_difference(expected.keys())) + \
            len(triples) - len(seen)
        wrong += abs(len(triples) - len(out))
        for t, ok in zip(triples, out):
            label = expected.get(t)
            if label is not None:
                wrong += ok is not label
            w = want.get(t)
            if w is not None:
                disagree += ok is not w
    return [core.Check("triples_wrong", wrong_sets, 0),
            core.Check("decisions_wrong", wrong, 0),
            core.Check("sample_vs_reference", disagree, 0)]
