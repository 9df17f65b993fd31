"""SCP envelope traffic: a node following a quorum verifies each envelope
as it arrives.

The generator makes the configuration's validators (`orgs` organisations
of `validators_per_org`, each inner set `inner_threshold` of them, the
outer set `outer_threshold` of the organisations) and, for each slot of
`ledger_close_s`, the real `SCPEnvelope` XDR of every validator's
statements, one envelope a validator for each of the traffic's `steps`.
When each arrives follows from the configuration's `latency` profile
alone: every validator sends the first step at the slot's start and each
later one as soon as it has heard the step before from a quorum, and this
node hears each envelope one link's latency after it was sent. Values
name transaction sets the node is never sent, so a verified envelope
waits in the herder's `fetching` state and the node's SCP does not run on
it; a corrupted one is discarded.

The window is an open loop on the host clock: each envelope is decoded and
handed to `Herder.recv_scp_envelope(envelope, on_verified=...)` at its due
time (or as soon as the previous call returns, when that is later), and is
timed from its due time to its `on_verified` decision. Between calls the
loop cranks the node's clock, as its main loop would.

Traffic keys: `steps` (statement types in order), `bit_flips_per_slot` (a
list, used slot by slot in turn), `s_plus_l_per_slot`,
`mixed_order_per_slot`, `warm_slots`, `first_slot`, `close_time`,
`warm_buckets`.
Configuration keys: `network_passphrase`, `orgs`, `validators_per_org`,
`inner_threshold`, `outer_threshold`, `ledger_close_s`, `latency`
(`regions`, `intra_ms` and `inter_ms` as [least, most], `seed`), and those
`core.build_node` reads.
"""

from __future__ import annotations

import gc
import math
import random
import time
from dataclasses import dataclass
from typing import List

from .. import core
from ..yardstick import ed25519_ref as ref
from ..yardstick import xdr as X
from ..yardstick.signer import signer


@dataclass
class Envelope:
    due: float          # seconds from the window's start (warm: negative)
    slot: int
    node: bytes         # the validator's public key
    statement: bytes    # SCPStatement XDR
    sig: bytes
    xdr: bytes          # SCPEnvelope XDR
    good: bool          # signed as it stands (the generator's label)


@dataclass
class Inputs:
    network_id: bytes
    quorum_set: bytes
    warm: List[Envelope]
    window: List[Envelope]


def tier1_quorum_set(config: dict, nodes: List[bytes]) -> bytes:
    per = config["validators_per_org"]
    inner = [X.quorum_set(config["inner_threshold"], nodes[i:i + per])
             for i in range(0, len(nodes), per)]
    return X.quorum_set(config["outer_threshold"], [], inner)


def link_latencies(config: dict) -> List[List[float]]:
    """One-way seconds between every two of the validators and this node
    (the last index), as the port's `simulation/geography.py` draws them:
    regions round robin in that order, each link drawn once, uniformly in
    the band inside or across regions, from the profile's own seed, so
    that every run's seed meets the same network."""
    lat = config["latency"]
    n = config["orgs"] * config["validators_per_org"] + 1
    rng = random.Random("geo:%d:%s" % (lat["seed"], lat["profile"]))
    region = [i % lat["regions"] for i in range(n)]
    out = [[0.0] * n for _ in range(n)]
    for i in range(n):
        for j in range(i):
            lo, hi = (lat["intra_ms"] if region[i] == region[j]
                      else lat["inter_ms"])
            out[i][j] = out[j][i] = rng.uniform(lo, hi) / 1000.0
    return out


def send_times(config: dict, n_steps: int,
               lat: List[List[float]]) -> List[List[float]]:
    """Seconds from a slot's start at which each validator sends each
    step: the first at the start, each later one once the validator has
    heard the step before from a quorum of its quorum set
    (`inner_threshold` validators in each of `outer_threshold`
    organisations, its own statement at once)."""
    per = config["validators_per_org"]
    n = config["orgs"] * per
    inner, outer = config["inner_threshold"], config["outer_threshold"]
    times = [[0.0] * n]
    for _ in range(1, n_steps):
        prev = times[-1]
        nxt = []
        for v in range(n):
            heard = sorted(
                sorted(prev[u] + lat[u][v] for u in range(o, o + per))
                [inner - 1] for o in range(0, n, per))
            nxt.append(max(prev[v], heard[outer - 1]))
        times.append(nxt)
    return times


def _pledges(step: str, qh: bytes, value: bytes) -> bytes:
    b = X.ballot(1, value)
    return {
        "nominate_vote": lambda: X.nominate(qh, [value], []),
        "nominate_accept": lambda: X.nominate(qh, [value], [value]),
        "prepare": lambda: X.prepare(qh, b),
        "prepare_prepared": lambda: X.prepare(qh, b, prepared=b),
        "confirm": lambda: X.confirm(qh, b, 1, 1, 1),
        "externalize": lambda: X.externalize(qh, b, 1),
    }[step]()


def _slot(rng: random.Random, config: dict, traffic: dict, net: bytes,
          qh: bytes, nodes, seeds, arrivals, slot: int, start: float,
          flips: int) -> list:
    value = X.stellar_value(rng.randbytes(32), traffic["close_time"] +
                            config["ledger_close_s"] * slot)
    out = []
    for step, at in zip(traffic["steps"], arrivals):
        for n, s, a in zip(nodes, seeds, at):
            st = X.scp_statement(n, slot, _pledges(step, qh, value))
            msg = X.scp_sign_bytes(net, st)
            out.append([start + a, n, st, s, msg, signer().sign(s, msg),
                        True])
    kinds = [0] * flips + [1] * traffic["s_plus_l_per_slot"] +         [2] * traffic["mixed_order_per_slot"]
    for kind, i in zip(kinds, rng.sample(range(len(out)), len(kinds))):
        e = out[i]
        e[5] = (ref.flip_bit(e[5], rng.randrange(512)) if kind == 0
                else ref.s_plus_l(e[5]) if kind == 1
                else ref.mixed_order_sign(e[3], e[4]))
        e[6] = False
    return [Envelope(due, slot, n, st, sig, X.scp_envelope(st, sig), good)
            for (due, n, st, _s, _m, sig, good) in out]


def generate(config: dict, traffic: dict, seed: int,
             seconds: float) -> Inputs:
    """The validators, their quorum set and every envelope of the warm
    slots and of the slots due in a window of `seconds`. Every seed gives
    the same arrival times and counts: envelopes per step, corrupted
    envelopes per slot."""
    rng = random.Random(seed)
    net = X.sha256(config["network_passphrase"].encode())
    n = config["orgs"] * config["validators_per_org"]
    seeds = [rng.randbytes(32) for _ in range(n)]
    nodes = [signer().public(s) for s in seeds]
    qset = tier1_quorum_set(config, nodes)
    qh = X.sha256(qset)
    lat = link_latencies(config)
    arrivals = [[t + lat[v][n] for v, t in enumerate(sent)]
                for sent in send_times(config, len(traffic["steps"]), lat)]
    flips = traffic["bit_flips_per_slot"]
    slot_s = config["ledger_close_s"]
    slot = traffic["first_slot"]
    warm = []
    for k in range(traffic["warm_slots"]):
        warm += _slot(rng, config, traffic, net, qh, nodes, seeds, arrivals,
                      slot, -slot_s * (traffic["warm_slots"] - k), flips[0])
        slot += 1
    window = []
    for k in range(math.ceil(seconds / slot_s)):
        window += [e for e in _slot(rng, config, traffic, net, qh, nodes,
                                    seeds, arrivals, slot, k * slot_s,
                                    flips[k % len(flips)])
                   if e.due < seconds]
        slot += 1
    warm.sort(key=lambda e: e.due)
    window.sort(key=lambda e: e.due)
    return Inputs(net, qset, warm, window)


class Cell:
    """Set-up, window and checks of one SCP-traffic run."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 workdir: str, backend: str, seconds: float) -> None:
        self.setup = core.Spans()
        with self.setup.span("generate"):
            self.inputs = generate(config, traffic, seed, seconds)
        if backend.startswith("cuda"):
            core.set_warmup_plan(traffic.get("warm_buckets"))
        with self.setup.span("node"):
            self.app = core.build_node(
                config, core.seed_bytes(seed, "node"), workdir, backend,
                quorum_set_xdr=self.inputs.quorum_set)
        # each envelope's [decision, its time, recv_scp_envelope's return,
        # the time its call started]
        self.results: List[list] = []
        self.late: List[float] = []
        # the warm slots take the window's path, unmeasured, as soon as
        # each call returns
        with self.setup.span("warm_slots"):
            self._drive(self.inputs.warm, time.perf_counter(), core.Spans(),
                        paced=False)
        self.results.clear()

    def _drive(self, envs: List[Envelope], t0: float, spans: core.Spans,
               paced: bool = True) -> None:
        from stellar_core_tpu_torch.xdr import SCPEnvelope
        herder = self.app.herder
        crank = self.app.crank
        for e in envs:
            due = t0 + e.due
            if paced and time.perf_counter() < due:
                # idle until the envelope is due: crank the node's clock
                # every few ms, as its main loop would, up to 3 ms before
                # it; sleep, then spin the last half millisecond
                with spans.span("scp.idle"):
                    while True:
                        now = time.perf_counter()
                        if now >= due - 0.003:
                            break
                        crank(False)
                        time.sleep(max(0.0, min(
                            due - time.perf_counter() - 0.003, 0.002)))
                    while True:
                        now = time.perf_counter()
                        if now >= due - 0.0005:
                            break
                        time.sleep(due - now - 0.0005)
                    while time.perf_counter() < due:
                        pass
                self.late.append(time.perf_counter() - due)
            decided: list = [None, 0.0, None, time.perf_counter()]

            def on_verified(ok, decided=decided):
                decided[0] = ok
                decided[1] = time.perf_counter()
            with spans.span("scp.decode"):
                env = SCPEnvelope.from_xdr(e.xdr)
            with spans.span("herder.recv_scp_envelope"):
                decided[2] = herder.recv_scp_envelope(
                    env, on_verified=on_verified)
            self.results.append(decided)
        # a decision that lands later (a stack that completes verifies on
        # the node's main loop) is waited for, a minute at most
        deadline = time.perf_counter() + 60.0
        while any(d[0] is None for d in self.results) and \
                time.perf_counter() < deadline:
            crank(False)
            time.sleep(0.0005)

    def window(self, seconds: float, spans: core.Spans) -> core.Outcome:
        envs = self.inputs.window
        gc.collect()
        self.late = []
        t0 = time.perf_counter() + 0.05
        with core.GcPauses() as pauses:
            self._drive(envs, t0, spans)
        end = time.perf_counter()
        lat = sorted(d[1] - (t0 + e.due) for d, e in zip(self.results, envs)
                     if d[0] is not None)
        # of each envelope's time, how much it waited for the loop: from
        # its due time to the start of its call
        queued = [max(0.0, d[3] - (t0 + e.due))
                  for d, e in zip(self.results, envs) if d[0] is not None]
        out = core.Outcome()
        out.attempted = len(envs)
        out.failed = len(envs) - len(lat)
        if lat:
            out.end_to_end["envelope_ms"] = 1e3 * sum(lat) / len(lat)
        # nearest rank; on standard error only, too wide from run to run
        # for an end-to-end bound
        p95 = 1e3 * lat[math.ceil(0.95 * len(lat)) - 1] if lat else 0.0
        # how late the generator ran: the start of each call that was
        # waiting for its due time, against that time
        late = self.late or [0.0]
        out.counts = {"sigs_decided": len(lat)}
        out.log_lines.append("setup: " + self.setup.summary())
        out.log_lines.append(
            "generator: %d envelopes in %.3f s; %d found the loop idle and "
            "started %.4f ms late on average, %.4f ms at most; the other "
            "%d were queued behind the previous call; waiting for the loop "
            "%.4f ms of the mean envelope's %.4f ms; 95th percentile "
            "%.4f ms; %s"
            % (len(envs), end - t0, len(self.late),
               1e3 * sum(late) / len(late), 1e3 * max(late),
               len(envs) - len(self.late),
               1e3 * sum(queued) / max(1, len(queued)),
               1e3 * sum(lat) / max(1, len(lat)), p95, pauses.summary()))
        return out

    def checks(self) -> List[core.Check]:
        from stellar_core_tpu_torch.scp.scp import SCP
        pending = self.app.herder.pending
        states = {}
        for slot, envs in pending.fetching.items():
            for env in envs:
                states[X.sha256(env.to_xdr())] = "fetching"
        for name in ("processed", "discarded"):
            for slot, hashes in getattr(pending, name).items():
                for h in hashes:
                    states.setdefault(h, name)
        decisions = [d[0] for d in self.results]
        rcs = [d[2] for d in self.results]
        valid = SCP.EnvelopeState.VALID
        invalid = SCP.EnvelopeState.INVALID
        return judge(self.inputs, decisions, states, rcs, valid, invalid)

    def close(self) -> None:
        core.stop_node(self.app)


def judge(inputs: Inputs, decisions, states=None, rcs=None, valid=None,
          invalid=None, verify=ref.verify) -> List[core.Check]:
    """Every envelope's decision against the reference's verify of its
    signature (and the generator's label), and, where the port's state is
    given, every envelope's acceptance: a verified one waits for its
    transaction set (or was processed), a refused one is discarded, and
    `recv_scp_envelope` said which."""
    wrong = 0
    wrong_states = 0
    for i, e in enumerate(inputs.window):
        want = verify(e.node, e.sig, X.scp_sign_bytes(inputs.network_id,
                                                      e.statement))
        wrong += (want is not e.good) + (decisions[i] is not want)
        if states is not None:
            got = states.get(X.sha256(e.xdr))
            ok_state = (got in ("fetching", "processed") if want
                        else got == "discarded")
            ok_rc = rcs[i] == (valid if want else invalid)
            wrong_states += (not ok_state) + (not ok_rc)
    out = [core.Check("decisions_wrong", wrong, 0)]
    if states is not None:
        out.append(core.Check("states_wrong", wrong_states, 0))
    return out
