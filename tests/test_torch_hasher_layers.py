"""The hasher's operator layers against the JAX package's, on the CPU
(mirrors tests/test_batch_hasher.py:83-163 without the close path and the
XLA cache, which the port does not have).

The port's side is `CudaBatchHasher(device="cpu")`, the kernel's plain
version behind the card's routing and its double-buffered staging; the
reference's side is `TpuBatchHasher` on JAX's CPU backend. Both run with
`LANE_BUCKETS` patched in the test to (64, 256), so a drain of 700
messages is three chunks and the JAX side compiles two small shapes.
Checked: identical digests (hashlib's) in the caller's order; the
`HasherStats.to_json()` of one drain equal to the reference's with the
timing fields left out (drain histograms, buckets, sites, oversize,
staging chunks and stalls), and the drain's spans equal with the backend
names and timings aside; the breaker with a fallback (`cpu-resilient`:
identical digests and the reference's meter counts) and without one
(`cuda-resilient`: a failed drain raises, the trip leaves a flight dump,
an open breaker refuses, the probe re-closes, no drain served on the
CPU); both fault sites; the warmup's states; a staging stall on the
worker; the vectorised `plan` against the parent's loop; site
attribution. Tolerance: none.
"""

import hashlib
import json
import os
import threading

import numpy as np
import pytest

from stellar_core_tpu.crypto import batch_hasher as RB
from stellar_core_tpu.crypto.batch_verifier import (
    CircuitBreaker as RefBreaker,
)
from stellar_core_tpu.util import faults as RF
from stellar_core_tpu.util import metrics as RM
from stellar_core_tpu.util import tracing as RT
from stellar_core_tpu_torch.crypto import batch_hasher as PB
from stellar_core_tpu_torch.crypto.batch_verifier import (
    BreakerOpenError, CircuitBreaker,
)
from stellar_core_tpu_torch.ledger import state_commitment as SC
from stellar_core_tpu_torch.ops import sha256 as TS
from stellar_core_tpu_torch.testing.entries import entry_records
from stellar_core_tpu_torch.util import faults as PF
from stellar_core_tpu_torch.util import metrics as PM
from stellar_core_tpu_torch.util import tracing as PT

import torch_threads  # noqa: F401  (one intra-op thread a worker)

LANES = (64, 256)
TIMING = ("staged_s", "overlap_s", "last_overlap_pct")


def _drain_msgs(seed: int = 0):
    """700 messages of 0-119 bytes (1-2 blocks) in a shuffled order and
    two oversize ones: three device chunks at 256 lanes."""
    rng = np.random.default_rng(seed)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 120, 700)]
    return msgs[:300] + [rng.bytes(1100), rng.bytes(2048)] + msgs[300:]


def _want(msgs):
    return [hashlib.sha256(m).digest() for m in msgs]


@pytest.fixture
def small_lanes(monkeypatch):
    monkeypatch.setattr(RB.TpuBatchHasher, "LANE_BUCKETS", LANES)
    monkeypatch.setattr(PB.CudaBatchHasher, "LANE_BUCKETS", LANES)


def _port_hasher(clock=None):
    now = clock or (lambda: 0.0)
    tr = PT.Tracer(now_fn=now)
    tr.enable()
    h = PB.CudaBatchHasher(device="cpu")
    h.tracer = tr
    h.stats = PB.HasherStats(metrics=PM.MetricsRegistry(now_fn=now),
                             tracer=tr, now_fn=now)
    return h


def _ref_hasher(clock=None):
    now = clock or (lambda: 0.0)
    tr = RT.Tracer(now_fn=now)
    tr.enable()
    h = RB.TpuBatchHasher()
    h.tracer = tr
    h.stats = RB.HasherStats(metrics=RM.MetricsRegistry(now_fn=now),
                             tracer=tr, now_fn=now)
    return h


def _untimed(stats_json: dict) -> dict:
    out = json.loads(json.dumps(stats_json))
    for k in TIMING:
        del out["staging"][k]
    return out


def _span_view(tracer, rename: dict):
    """(name, tags) of every span, backend names mapped through `rename`,
    the staging overlap (a timing) reduced to its presence."""
    out = []
    for s in tracer.spans():
        tags = dict(s.tags or {})
        for k in ("backend", "platform"):
            if k in tags:
                tags[k] = rename.get(tags[k], tags[k])
        if "staging_overlap_pct" in tags:
            tags["staging_overlap_pct"] = "present"
        out.append((s.name, tags))
    return out


@pytest.fixture
def both_drained(small_lanes):
    msgs = _drain_msgs()
    ref, port = _ref_hasher(), _port_hasher()
    return (msgs, ref.hash_many(msgs, site="bucket-entries"), ref,
            port.hash_many(msgs, site="bucket-entries"), port)


def test_drain_digests_and_stats_equal_reference(both_drained):
    msgs, ref_out, ref, port_out, port = both_drained
    assert port_out == ref_out == _want(msgs)
    got, want = port.stats.to_json(), ref.stats.to_json()
    assert got["staging"]["chunks"] == 2 and got["staging"]["stalls"] == 0
    assert set(got["buckets"]) == {"256x1", "256x2"}
    assert got["oversize_msgs"] == 2
    assert got["sites"]["bucket-entries"]["drains"] == 1
    # the backends carry their own names; everything else is equal
    want["drains"]["by_backend"] = {
        "cuda": want["drains"]["by_backend"].pop("tpu")}
    assert _untimed(got) == _untimed(want)
    assert port.batches == 3 and port.oversize_msgs == 2
    assert port.real_blocks == sum(
        TS.blocks_for_len(len(m)) for m in msgs if len(m) <= 1015)


def test_drain_spans_equal_reference(both_drained):
    _msgs, _r, ref, _p, port = both_drained
    got = _span_view(port.tracer, {})
    assert got == _span_view(ref.tracer, {"tpu": "cuda"})
    assert [n for n, _t in got] == ["crypto.hash.dispatch"] * 3 + [
        "crypto.hash_many"]
    assert got[-1][1]["batches"] == 3 and got[-1][1]["oversize"] == 2


def test_phase_breakdown_keys_the_plain_version_as_cpu(both_drained):
    _msgs, _r, _ref, _p, port = both_drained
    phases = port.tracer.phase_breakdown()["phases"]
    assert phases["crypto.hash_many:cuda@cpu"]["count"] == 1
    assert phases["crypto.hash.dispatch:cuda"]["count"] == 3


def test_staging_stall_restages_on_the_dispatch_thread(small_lanes):
    msgs = _drain_msgs(1)
    h = _port_hasher()
    stage = h._stage_hash_chunk
    failed = []

    def flaky(*args):
        if threading.current_thread().name == "crypto.hash-staging" \
                and not failed:
            failed.append(1)
            raise RuntimeError("staging worker lost")
        return stage(*args)

    h._stage_hash_chunk = flaky
    assert h.hash_many(msgs) == _want(msgs)
    st = h.stats.to_json()["staging"]
    assert failed and st["stalls"] == 1 and st["chunks"] == 1
    assert h.stats.metrics.to_json()["hasher.staging.stall"]["count"] == 1
    assert h.batches == 3


def _old_plan(blocks, lane_buckets, block_buckets):
    """The parent commit's CudaBatchHasher.plan (a Python loop)."""
    def bucket(ladder, n):
        for b in ladder:
            if n <= b:
                return b
        return ladder[-1]

    max_dev = block_buckets[-1]
    over = [i for i, b in enumerate(blocks) if b > max_dev]
    dev = sorted((i for i, b in enumerate(blocks) if b <= max_dev),
                 key=lambda i: blocks[i])
    step = lane_buckets[-1]
    chunks = []
    for k in range(0, len(dev), step):
        idx = dev[k:k + step]
        chunks.append((idx, bucket(lane_buckets, len(idx)),
                       bucket(block_buckets, blocks[idx[-1]])))
    return over, chunks


@pytest.mark.parametrize("n", [0, 1, 255, 4096, 4097, 9000])
def test_vectorised_plan_equals_the_loop(n):
    rng = np.random.default_rng(n)
    blocks = [int(b) for b in rng.choice(
        [1, 1, 2, 2, 2, 3, 4, 5, 8, 9, 16, 17, 40], n)]
    h = PB.CudaBatchHasher(device="cpu")
    got = h.plan(blocks)
    assert got == _old_plan(blocks, h.LANE_BUCKETS, h.BLOCK_BUCKETS)
    over, chunks = got
    assert all(type(i) is int for i in over)
    assert all(type(i) is int for c in chunks for i in c[0])


# --- the breaker with a fallback (cpu-resilient) ---------------------------

def _boom(base):
    class Boom(base):
        def hash_many(self, msgs, site="other"):
            raise RuntimeError("device gone")
    return Boom


def test_breaker_trips_to_fallback_with_identical_digests():
    """tests/test_batch_hasher.py:109-137 on both stacks: the same meter
    counts, breaker states and digests."""
    def run(B, M, Breaker, primary):
        msgs = [b"m%d" % i for i in range(10)]
        now = [0.0]
        metrics = M.MetricsRegistry(now_fn=lambda: now[0])
        fb = B.CpuBatchHasher()
        r = B.ResilientBatchHasher(
            primary, fb, Breaker(threshold=2, cooldown_s=5.0,
                                 now_fn=lambda: now[0]))
        r.metrics = metrics
        for layer in (primary, fb, r):
            layer.stats = B.HasherStats(metrics=metrics,
                                        now_fn=lambda: now[0])
        outs, states = [], []
        for t in (0.0, 0.0, 0.0, 6.0):
            now[0] = t
            outs.append(r.hash_many(msgs))
            states.append(r.breaker.state)
        m = metrics.to_json()
        return (outs == [_want(msgs)] * 4, states,
                {k: m[k]["count"] for k in ("hasher.breaker.trip",
                                            "hasher.dispatch-failure",
                                            "hasher.fallback-drain")})

    got = run(PB, PM, CircuitBreaker, _boom(PB.CpuBatchHasher)())
    assert got == run(RB, RM, RefBreaker, _boom(RB.TpuBatchHasher)())
    assert got == (True, ["closed", "open", "open", "open"],
                   {"hasher.breaker.trip": 1, "hasher.dispatch-failure": 3,
                    "hasher.fallback-drain": 4})


def test_dispatch_fail_fault_site_drives_the_cpu_resilient_breaker():
    def run(B, F):
        faults = F.FaultInjector(seed=3)
        faults.configure("hash.dispatch-fail", probability=1.0, count=3)
        r = B.make_hasher("cpu-resilient", faults=faults,
                          breaker_threshold=3)
        msgs = [b"a", b"bb", b"ccc"]
        outs = [r.hash_many(msgs) for _ in range(3)]
        breaker = r.breaker.to_json()
        del breaker["retry_at"]          # a real-clock stamp
        return (outs == [_want(msgs)] * 3, breaker,
                r.stats.to_json()["drains"]["by_backend"])

    got = run(PB, PF)
    assert got == run(RB, RF)
    assert got[1]["trips"] == 1 and got[2]["cpu"]["drains"] == 3


# --- the breaker without a fallback (cuda-resilient) ------------------------

def test_cuda_resilient_raises_trips_refuses_and_probes(tmp_path):
    clock = [100.0]
    now = lambda: clock[0]   # noqa: E731
    reg = PM.MetricsRegistry(now_fn=now)
    tr = PT.Tracer(now_fn=now)
    tr.enable()
    rec = PT.FlightRecorder(tr, metrics=reg, out_dir=str(tmp_path),
                            now_fn=now)
    faults = PF.FaultInjector(seed=7, metrics=reg)
    faults.configure("hash.dispatch-fail", count=3)

    class Clock:
        def now(self):
            return clock[0]

    h = PB.make_hasher("cuda-resilient", device="cpu", clock=Clock(),
                       metrics=reg, tracer=tr, faults=faults,
                       flight_recorder=rec, breaker_threshold=3,
                       breaker_cooldown=30.0)
    assert isinstance(h, PB.ResilientBatchHasher) and h.fallback is None
    assert isinstance(h.primary, PB.CudaBatchHasher)
    assert h.primary.stats is h.stats
    msgs = [b"x" * n for n in range(50)]
    for _ in range(3):
        with pytest.raises(PF.InjectedFault):
            h.hash_many(msgs)
    assert h.breaker.state == "open" and h.breaker.trips == 1
    with pytest.raises(BreakerOpenError):
        h.hash_many(msgs)
    m = reg.to_json()
    assert m["hasher.dispatch-failure"]["count"] == 3
    assert m["hasher.refused-drain"]["count"] == 1
    assert m["hasher.breaker.trip"]["count"] == 1
    assert "hasher.fallback-drain" not in m
    assert h.stats.to_json()["drains"]["by_backend"] == {}
    assert h.primary.batches == 0
    dumps = [f for f in os.listdir(tmp_path) if "hash-breaker-trip" in f]
    assert len(dumps) == 1
    with open(tmp_path / dumps[0]) as fh:
        blob = json.load(fh)
    assert blob["extra"]["breaker"]["trips"] == 1
    assert blob["metrics"]["hasher.breaker.trip"]["count"] == 1
    clock[0] += 31.0
    assert h.hash_many(msgs, site="bucket-entries") == _want(msgs)
    assert h.breaker.state == "closed" and h.breaker.recoveries == 1
    assert set(h.stats.to_json()["drains"]["by_backend"]) == {"cuda"}
    assert h.primary.batches == 1


def test_device_lost_raises_from_the_device_backend():
    """tests/test_batch_hasher.py:153-163's first half on both stacks; on
    `cuda-resilient` the fault raises too (the reference's "tpu" serves it
    on the CPU; the port's card work never moves there)."""
    for B, F, make in ((PB, PF, lambda: PB.CudaBatchHasher(device="cpu")),
                       (RB, RF, RB.TpuBatchHasher)):
        faults = F.FaultInjector(seed=4)
        faults.configure("hash.device-lost", probability=1.0, count=1)
        h = make()
        h.faults = faults
        with pytest.raises(F.InjectedFault):
            h.hash_many([b"x"])
        assert h.hash_many([b"x"]) == _want([b"x"])
    faults = PF.FaultInjector(seed=4)
    faults.configure("hash.device-lost", probability=1.0, count=1)
    r = PB.make_hasher("cuda-resilient", device="cpu", faults=faults)
    with pytest.raises(PF.InjectedFault):
        r.hash_many([b"x"])
    assert r.breaker.consecutive_failures == 1
    assert r.stats.to_json()["drains"]["by_backend"] == {}
    assert r.hash_many([b"x"]) == _want([b"x"])


def test_a_card_primary_takes_no_fallback():
    class OnCard(PB.BatchHasher):
        on_card = True
    with pytest.raises(ValueError):
        PB.ResilientBatchHasher(OnCard(), PB.CpuBatchHasher())
    assert PB.ResilientBatchHasher(OnCard()).fallback is None


# --- warmup -----------------------------------------------------------------

def test_warmup_states(tmp_path):
    reg = PM.MetricsRegistry()
    tr = PT.Tracer()
    tr.enable()
    rec = PT.FlightRecorder(tr, metrics=reg, out_dir=str(tmp_path))
    h = PB.make_hasher("cuda-resilient", device="cpu", metrics=reg,
                       tracer=tr, flight_recorder=rec)
    assert h.wants_warmup
    h.primary.WARM_SHAPES = ((32, 1), (64, 2), (64, 4))
    assert h.stats.to_json()["warmup"]["state"] == "idle"
    h.warmup(wait=True)
    w = h.stats.to_json()
    assert w["warmup"]["state"] == "done"
    assert w["warmup"]["planned"] == ["32x1", "64x2", "64x4"]
    # on the CPU nothing is built: every shape's cache state is unknown
    assert {k: v["cache"] for k, v in w["warmup"]["shapes"].items()} == {
        "32x1": "unknown", "64x2": "unknown", "64x4": "unknown"}
    assert w["compile_cache"]["enabled"] is True
    assert w["compile_cache"]["unknown"] == 3
    assert w["drains"]["by_backend"] == {} and h.primary.batches == 0
    assert [s.name for s in tr.spans()] == [
        "hasher.warmup.begin"] + ["hasher.warmup.shape"] * 3 + [
        "hasher.warmup.end"]
    h.warmup(wait=True)           # idempotent
    assert len(tr.spans()) == 5
    # the staging buffers serve live traffic after the warmup
    msgs = _drain_msgs(2)
    assert h.hash_many(msgs) == _want(msgs)


def test_warmup_failure_records_and_dumps(tmp_path):
    reg = PM.MetricsRegistry()
    rec = PT.FlightRecorder(PT.Tracer(), metrics=reg,
                            out_dir=str(tmp_path))
    h = PB.make_hasher("cuda", device="cpu", metrics=reg,
                       flight_recorder=rec)

    def broken(lanes, blocks):
        raise RuntimeError("nvcc failed")

    h._compile_shape = broken
    h.warmup(wait=True)
    w = h.stats.to_json()["warmup"]
    assert w["state"] == "failed" and "nvcc failed" in w["error"]
    assert reg.to_json()["hasher.warmup.failure"]["count"] == 1
    assert len([f for f in os.listdir(tmp_path)
                if "hash-warmup-failed" in f]) == 1


# --- attribution ------------------------------------------------------------

def test_entry_leaves_drains_count_under_bucket_entries():
    h = PB.make_hasher("cuda-resilient", device="cpu")
    rng = np.random.default_rng(9)
    for n in (10, 300):
        recs = entry_records(rng, n)
        assert SC.entry_leaves(recs, h) == _want([b"\x00" + r
                                                  for r in recs])
    sites = h.stats.to_json()["sites"]
    assert sites["bucket-entries"]["drains"] == 2
    assert sites["bucket-entries"]["msgs"] == 310
    assert h.digest_one(b"header-bytes", site="header") == \
        hashlib.sha256(b"header-bytes").digest()
    assert h.hash_stream(iter([b"a", b"b"]), site="result-set") == \
        hashlib.sha256(b"ab").digest()
    j = h.stats.to_json()
    assert j["sites"]["header"]["drains"] == 1
    assert j["sites"]["result-set"] == {"drains": 1, "msgs": 2, "bytes": 2}
    assert j["drains"]["by_backend"]["host-stream"]["drains"] == 2


@pytest.mark.parametrize("backend", ["cpu", "cpu-resilient", "cuda",
                                     "cuda-resilient"])
def test_every_stack_shares_one_stats(backend):
    h = PB.make_hasher(backend, device="cpu")
    layers = [h] + [getattr(h, k) for k in ("primary", "fallback")
                    if getattr(h, k, None) is not None]
    assert all(layer.stats is h.stats for layer in layers)
    msgs = _drain_msgs(3)[:40]
    assert h.hash_many(msgs, site="txset") == _want(msgs)
    assert h.stats.to_json()["sites"]["txset"]["msgs"] == 40
