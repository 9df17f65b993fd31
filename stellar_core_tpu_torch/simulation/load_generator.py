"""LoadGenerator: synthetic account-creation / payment load.

Copied from `stellar_core_tpu/simulation/load_generator.py` at commit
02f8fbd; carry a fix in either copy to the other. Nothing is left out,
and nothing differs: the generator submits through the node's herder, so
its payments are admitted on whatever verifier the node was built with
(the card's unless the CPU is named; `main/config.py`).

Role parity: reference `src/simulation/LoadGenerator.{h,cpp}:29-120` —
driven by the HTTP `generateload` admin command; creates accounts then
issues payments at a target rate, injecting through the Herder. This is the
standard flood driver for the TransactionQueue verify path (a batch
measurement config of the reference's BASELINE.md).

The **open-loop mode** serves the ingress tier's overload story:
seeded generation over an arbitrarily large submitter keyspace
(10^6 distinct keys cost nothing — keys derive on demand) with Zipf
hot-key skew and target-rate pacing on the app clock (virtual in
simulations, so a 5x-oversubscribed minute replays deterministically).
Open-loop means the generator never waits for outcomes: it submits at
the target rate regardless, and *counts* the backpressure it receives —
`TRY_AGAIN_LATER` answers land in `backpressured` (with the herder's
retry-after hint recorded) instead of being retried, which is exactly
the submitter behavior an admission tier must survive.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

from ..crypto.hashing import sha256
from ..crypto.keys import SecretKey
from ..testing import TestAccount
from ..util.log import get_logger
from ..util.timer import VirtualTimer

log = get_logger("LoadGen")


class ZipfSampler:
    """Seeded Zipf(s) sampler over [1..n] via Hörmann/Derflinger
    rejection-inversion — O(1) per sample with no precomputed tables,
    so a 10^6-key skew costs a handful of floats (sctlint D2: the RNG
    is the caller's seeded stream)."""

    def __init__(self, n: int, s: float, rng: random.Random) -> None:
        assert n >= 1 and s > 0.0
        self.n = n
        self.s = float(s)
        self.rng = rng
        self._h_x1 = self._h_integral(1.5) - 1.0
        self._h_n = self._h_integral(n + 0.5)
        self._s_const = 2.0 - self._h_integral_inverse(
            self._h_integral(2.5) - self._h(2.0))

    def _h_integral(self, x: float) -> float:
        lg = math.log(x)
        if self.s == 1.0:
            return lg
        return ((math.exp((1.0 - self.s) * lg) - 1.0) / (1.0 - self.s))

    def _h(self, x: float) -> float:
        return math.exp(-self.s * math.log(x))

    def _h_integral_inverse(self, x: float) -> float:
        if self.s == 1.0:
            return math.exp(x)
        t = x * (1.0 - self.s)
        if t < -1.0:
            t = -1.0
        return math.exp(math.log1p(t) / (1.0 - self.s))

    def sample(self) -> int:
        while True:
            u = self._h_n + self.rng.random() * (self._h_x1 - self._h_n)
            x = self._h_integral_inverse(u)
            k = int(x + 0.5)
            if k < 1:
                k = 1
            elif k > self.n:
                k = self.n
            if k - x <= self._s_const or \
                    u >= self._h_integral(k + 0.5) - self._h(k):
                return k


class LoadGenerator:
    def __init__(self, app) -> None:
        self.app = app
        self._accounts: List[SecretKey] = []
        self._timer = VirtualTimer(app.clock)
        self._running = False
        self.submitted = 0
        self.failed = 0
        # open-loop overload mode: armed by start_open_loop
        self._ol: Optional[dict] = None
        self._ol_timer: Optional[VirtualTimer] = None

    # -- account book -------------------------------------------------------
    def _account_key(self, i: int) -> SecretKey:
        return SecretKey.from_seed(
            sha256(b"loadgen-%d-" % i + self.app.config.network_id))

    def _adapter(self):
        from ..testing import AppLedgerAdapter
        return AppLedgerAdapter(self.app)

    # -- phases -------------------------------------------------------------
    def generate_accounts(self, n: int,
                          balance: int = 10**9) -> List[SecretKey]:
        """Submit create-account txs from the root (batched 100 ops/tx)."""
        adapter = self._adapter()
        root = adapter.root_account()
        keys = [self._account_key(i) for i in range(n)]
        created = []
        i = 0
        seq = root.next_seq()
        while i < n:
            chunk = keys[i:i + 100]
            ops = [root.op_create_account(k.public_key, balance)
                   for k in chunk]
            frame = root.tx(ops, seq=seq)
            seq += 1
            status = self.app.submit_transaction(frame)
            if status == 0:
                self.submitted += 1
            else:
                self.failed += 1
            created.extend(chunk)
            i += 100
        self._accounts = keys
        return keys

    def generate_payments(self, n_txs: int) -> int:
        """Submit n payment txs round-robin among generated accounts."""
        assert self._accounts, "generate accounts first"
        adapter = self._adapter()
        count = 0
        seqs = {}
        for i in range(n_txs):
            src_k = self._accounts[i % len(self._accounts)]
            dst_k = self._accounts[(i + 1) % len(self._accounts)]
            acc = TestAccount(adapter, src_k)
            seq = seqs.get(src_k.seed)
            if seq is None:
                seq = acc.next_seq()
            frame = acc.tx([acc.op_payment(dst_k.public_key, 1000)],
                           seq=seq)
            seqs[src_k.seed] = seq + 1
            status = self.app.submit_transaction(frame)
            if status == 0:
                self.submitted += 1
                count += 1
            else:
                self.failed += 1
        return count

    # -- open-loop overload mode --------------------------------------------
    def _submitter_key(self, i: int) -> SecretKey:
        """The i-th key of the open-loop submitter keyspace; derived on
        demand, so a 10^6-submitter run never materializes the set."""
        return SecretKey.from_seed(
            sha256(b"open-loop-%d-" % i + self.app.config.network_id))

    def _open_loop_frame(self, idx: int, nonce: int):
        """A distinct, cheap-to-build payment from submitter `idx`
        (unsigned: admission-shed txs must cost the ingress tier
        nothing; the no-ingress control leg pays full validation and
        rejects it — exactly the asymmetry the overload scenario
        measures)."""
        from ..transactions.transaction_frame import TransactionFrame
        from ..xdr import (
            Asset, Memo, MuxedAccount, Operation, OperationBody,
            OperationType, PaymentOp, Transaction, TransactionEnvelope,
            _Ext,
        )
        sk = self._submitter_key(idx)
        dst = self._submitter_key(0)
        op = Operation(sourceAccount=None, body=OperationBody(
            OperationType.PAYMENT,
            PaymentOp(destination=MuxedAccount.from_account_id(
                dst.public_key),
                asset=Asset.native(), amount=1 + nonce)))
        t = Transaction(
            sourceAccount=MuxedAccount.from_account_id(sk.public_key),
            fee=100, seqNum=nonce + 1, timeBounds=None, memo=Memo.none(),
            operations=[op], ext=_Ext.v0())
        return TransactionFrame.make_from_wire(
            self.app.config.network_id, TransactionEnvelope.for_tx(t))

    def start_open_loop(self, txs_per_sec: float, duration_s: float,
                        submitters: int = 1_000_000,
                        zipf_s: float = 1.1, seed: int = 0,
                        tick: float = 0.25) -> None:
        """Arm open-loop generation: every `tick` app-clock seconds
        submit `txs_per_sec * tick` txs (fractions carry) from
        Zipf(zipf_s)-skewed submitters out of a `submitters`-key
        keyspace, for `duration_s`. No retries, no waiting — outcomes
        are only counted (see `open_loop_status`)."""
        assert txs_per_sec > 0 and duration_s > 0
        rng = random.Random("open-loop:%d" % seed)
        self._ol = {
            "rate": float(txs_per_sec),
            "deadline": self.app.clock.now() + duration_s,
            "tick": float(tick),
            "carry": 0.0,
            "sampler": ZipfSampler(submitters, zipf_s, rng),
            "nonces": {},     # submitter idx -> submissions so far
            "submitted": 0, "accepted": 0, "backpressured": 0,
            "rejected": 0, "duplicate": 0,
            "last_retry_after": None,
        }
        self._ol_timer = VirtualTimer(self.app.clock)
        self._arm_open_loop_tick()

    def _arm_open_loop_tick(self) -> None:
        self._ol_timer.expires_from_now(self._ol["tick"])
        self._ol_timer.async_wait(self._open_loop_tick)

    def _open_loop_tick(self) -> None:
        ol = self._ol
        if ol is None:
            return
        want = ol["rate"] * ol["tick"] + ol["carry"]
        n = int(want)
        ol["carry"] = want - n
        for _ in range(n):
            idx = ol["sampler"].sample()
            nonce = ol["nonces"].get(idx, 0)
            ol["nonces"][idx] = nonce + 1
            status = self.app.submit_transaction(
                self._open_loop_frame(idx, nonce))
            ol["submitted"] += 1
            self.submitted += 1
            if status == 0:
                ol["accepted"] += 1
            elif status == 3:
                # open-loop: backpressure is COUNTED, never obeyed —
                # the admission tier must hold against exactly this
                ol["backpressured"] += 1
                hint = getattr(self.app.herder, "last_retry_after", None)
                if hint is not None:
                    ol["last_retry_after"] = hint
                self.failed += 1
            elif status == 1:
                ol["duplicate"] += 1
                self.failed += 1
            else:
                ol["rejected"] += 1
                self.failed += 1
        if self.app.clock.now() < ol["deadline"]:
            self._arm_open_loop_tick()

    def stop_open_loop(self) -> None:
        if self._ol_timer is not None:
            self._ol_timer.cancel()
        self._ol = None

    def open_loop_running(self) -> bool:
        return self._ol is not None and \
            self.app.clock.now() < self._ol["deadline"]

    def open_loop_status(self) -> Optional[dict]:
        ol = self._ol
        if ol is None:
            return None
        return {k: ol[k] for k in
                ("submitted", "accepted", "backpressured", "rejected",
                 "duplicate", "last_retry_after")} | {
                    "distinct_submitters": len(ol["nonces"])}

    def status(self) -> dict:
        out = {"accounts": len(self._accounts),
               "submitted": self.submitted, "failed": self.failed}
        ol = self.open_loop_status()
        if ol is not None:
            out["open_loop"] = ol
        return out
