"""The port's verify fleet (`CudaSigVerifier` over members) against the JAX
package's `TpuSigVerifier` fleet scheduler.

- The same 100 triples through the reference's 4-device mesh and the
  port's 4-member CPU fleet at bucket 128: identical decisions, per-device
  rows and dispatch counts (the one JAX sharded shape these tests compile,
  the shape `tests/test_verify_fleet.py` already compiles).
- A scheduler differential with no kernel: both verifiers with their
  dispatch and staging stubbed the same way (as `tests/test_verify_fleet.py`
  stubs the reference's) run one script of lost devices, a clock past the
  cooldown, a staging stall and a raising sharded dispatch; breaker JSON,
  membership keys, per-device stats and every `verifier.*` / `fault.*`
  metric must be equal.
- `warmup_plan`, `FaultInjector` fire sequences and `CircuitBreaker`
  transitions against the reference's on the same recorded histories.
- A member whose dispatch raises: the drain raises, every participant's
  breaker counts it, and no CPU verify runs.
- The warm start (plan persisted beside the kernel libraries) and the
  staging double buffer.

Tolerance: none, decisions and JSON must be equal. The one value left out
of the metric comparison is `verifier.staging.overlap-pct`, a measurement
of real elapsed time on each stack.
"""

import json
import time

import numpy as np
import pytest
import torch

from stellar_core_tpu.crypto import batch_verifier as RBV
from stellar_core_tpu.util.faults import FaultInjector as RefFaultInjector
from stellar_core_tpu.util.metrics import MetricsRegistry as RefRegistry
from stellar_core_tpu_torch.crypto import batch_verifier as BV
from stellar_core_tpu_torch.crypto import keys as K
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ops import ed25519 as E
from stellar_core_tpu_torch.util.faults import FaultInjector
from stellar_core_tpu_torch.util.metrics import MetricsRegistry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_cache():
    K.flush_verify_cache()
    yield
    K.flush_verify_cache()


def _batch(n, n_keys=6, tag=b"fleet"):
    """The reference fleet tests' batch (tests/test_verify_fleet.py)."""
    sks = [SecretKey.from_seed(bytes([i + 1] * 32)) for i in range(n_keys)]
    out = []
    for i in range(n):
        sk = sks[i % n_keys]
        m = tag + b"-%04d" % i
        out.append((sk.public_key, sk.sign(m), m))
    return out


def _corrupt(triples, idxs):
    for i in idxs:
        k, s, m = triples[i]
        triples[i] = (k, bytes([s[0] ^ 1]) + s[1:], m)
    return triples


# ------------------------------------------------ the real sharded verify


def test_sharded_drain_equals_the_reference_mesh():
    import jax
    if jax.device_count() < 4:
        pytest.skip("needs the virtual multi-device CPU platform")
    triples = _corrupt(_batch(100), {3, 41, 97})

    ref_st = RBV.VerifierStats()
    ref = RBV.TpuSigVerifier(shard_threshold=1, devices=jax.devices()[:4])
    ref.BUCKETS = (128,)
    ref.stats = ref_st
    st = BV.VerifierStats()
    v = BV.CudaSigVerifier(devices=["cpu"] * 4, shard_threshold=1)
    v.BUCKETS = (128,)
    v.stats = st

    want = ref.verify_many(triples)
    assert want == [i not in {3, 41, 97} for i in range(100)]
    assert v.verify_many(triples) == want
    assert ref.batches_dispatched == v.batches_dispatched == 1
    assert list(ref._mesh_fns) == list(v._mesh_fns) == [(0, 1, 2, 3)]
    rows = st.to_json()["devices"]
    assert rows == ref_st.to_json()["devices"]
    assert [rows[str(i)]["sigs"] for i in range(4)] == [32, 32, 32, 4]
    assert [rows[str(i)]["pad_total"] for i in range(4)] == [0, 0, 0, 28]
    assert st.to_json()["drains"]["by_backend"]["cuda"] == \
        ref_st.to_json()["drains"]["by_backend"]["tpu"]


# ----------------------------------------- scheduler differential (stubs)


def _echo(*args):
    return np.ones(len(args[0]), bool)


def _stub_stage(self, chunk, route):
    fn, b, idxs = route
    return {"args": (np.zeros((b,), np.int32),),
            "pre_ok": np.ones(len(chunk), bool), "n": len(chunk), "b": b,
            "fn": fn, "idxs": idxs}


def _stub_mesh_fn(self, idxs):
    self._mesh_fns.setdefault(idxs, (None, None))
    return _echo, None


class _RefStub(RBV.TpuSigVerifier):
    """The reference verifier with its jax layers stubbed out, as
    tests/test_verify_fleet.py stubs it: routing, staging hand-off,
    per-device accounting and breakers run for real."""

    def __init__(self, n_devices, **kw):
        super().__init__(devices=list(range(n_devices)), **kw)
        self._devices = list(range(n_devices))
        self._fleet_health = RBV.DeviceFleetHealth(
            n_devices, threshold=self._dev_threshold,
            cooldown_s=self._dev_cooldown, now_fn=self._now, owner=self)
        self._platform = "stub"

    _mesh_fn = _stub_mesh_fn
    _stage_chunk = _stub_stage

    def _single_fn(self):
        return _echo


class _PortStub(BV.CudaSigVerifier):
    """The port's verifier, stubbed the same way over CPU members."""

    def __init__(self, n_devices, **kw):
        super().__init__(devices=["cpu"] * n_devices, **kw)

    _mesh_fn = _stub_mesh_fn
    _stage_chunk = _stub_stage

    def _single_fn(self):
        return _echo


def _run_script(cls, registry, injector):
    clock = {"t": 1000.0}
    reg = registry(now_fn=lambda: clock["t"])
    v = cls(4, now_fn=lambda: clock["t"], shard_threshold=1,
            device_breaker_threshold=2, device_breaker_cooldown=30.0)
    v.BUCKETS = (128,)
    v.stats = (RBV if cls is _RefStub else BV).VerifierStats(
        metrics=reg, now_fn=lambda: clock["t"])
    v.metrics = reg
    v.faults = injector(seed=7, metrics=reg)
    v.faults.configure("verify.device-lost", count=2)
    triples = _batch(64)
    for _ in range(3):
        assert all(v.verify_many(triples))
    clock["t"] += 31.0
    assert all(v.verify_many(triples))
    v.faults.configure("verify.staging-stall", count=1)
    assert all(v.verify_many(_batch(2 * 128)))

    def boom(idxs):
        def fn(*args):
            raise RuntimeError("mesh dispatch died")
        return fn, None

    v._mesh_fn = boom
    with pytest.raises(RuntimeError, match="mesh dispatch died"):
        v.verify_many(triples)
    # the drain meter is named after the backend: "tpu" there, "cuda"
    # here
    metrics = {k.replace("verifier.drains.tpu", "verifier.drains.cuda"): m
               for k, m in reg.to_json().items()
               if k.startswith(("verifier.", "fault."))
               and k != "verifier.staging.overlap-pct"}
    return {"breakers": v.fleet_health.to_json(),
            "mesh_keys": sorted(v._mesh_fns),
            "devices": v.stats.to_json()["devices"],
            "staging_stalls": v.stats.to_json()["staging"]["stalls"],
            "metrics": metrics}


def test_scheduler_differential_against_the_reference():
    ref = _run_script(_RefStub, RefRegistry, RefFaultInjector)
    port = _run_script(_PortStub, MetricsRegistry, FaultInjector)
    assert port["breakers"] == ref["breakers"]
    assert port["mesh_keys"] == ref["mesh_keys"] == \
        [(0, 1, 2, 3), (1, 2, 3)]
    assert port["devices"] == ref["devices"]
    assert port["staging_stalls"] == ref["staging_stalls"] == 1
    assert sorted(port["metrics"]) == sorted(ref["metrics"])
    for name in ref["metrics"]:
        assert port["metrics"][name] == ref["metrics"][name], name
    # the script did what it says: member 0 tripped, recovered, and the
    # raising dispatch counted against all four
    b = port["breakers"]["devices"]
    assert b["0"]["trips"] == 1 and b["0"]["recoveries"] == 1
    assert [b[str(i)]["consecutive_failures"] for i in range(4)] == \
        [1, 1, 1, 1]
    assert port["metrics"]["fault.injected.verify.device-lost"][
        "count"] == 2


# --------------------------------------------- copied helpers, differential


def _record_history(stats):
    for _ in range(3):
        stats.record_bucket_dispatch(512, 500, 12)
    stats.record_bucket_dispatch(2048, 300, 1748)
    stats.record_bucket_dispatch(2048, 1900, 148)
    stats.record_bucket_dispatch(8192, 8000, 193)
    for n in (3, 100, 100, 129, 600, 5000):
        stats.record_drain("cpu", n)
    stats.record_drain("cuda", 9000, pad=100, splits=2, bucketed=True)


@pytest.mark.parametrize("ladder", [(128, 512, 2048, 8192), (128, 2048),
                                    (512, 8192)])
def test_warmup_plan_equals_the_reference(ladder):
    assert BV.warmup_plan(None, ladder) == RBV.warmup_plan(None, ladder)
    assert BV.warmup_plan(BV.VerifierStats(), ladder) == \
        RBV.warmup_plan(RBV.VerifierStats(), ladder)
    ours, theirs = BV.VerifierStats(), RBV.VerifierStats()
    _record_history(ours)
    _record_history(theirs)
    assert BV.warmup_plan(ours, ladder) == RBV.warmup_plan(theirs, ladder)
    assert ours.drain_sizes == theirs.drain_sizes
    assert ours.bucket_traffic(ladder) == theirs.bucket_traffic(ladder)


def _fault_sequence(injector_cls, seed):
    fi = injector_cls(seed=seed)
    fi.configure("verify.device-lost", probability=0.3, count=5, after=2)
    fi.configure("verify.staging-stall", probability=0.6)
    fi.configure("device.dispatch", count=3)
    fired = []
    for i in range(60):
        site = ("verify.device-lost", "verify.staging-stall",
                "device.dispatch")[i % 3]
        fired.append(fi.should_fire(site))
    return fired, fi.to_json()


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_injector_fires_as_the_reference(seed):
    ours = _fault_sequence(FaultInjector, seed)
    assert ours == _fault_sequence(RefFaultInjector, seed)
    assert any(ours[0]) and not all(ours[0])


def _breaker_history(cls):
    clock = {"t": 0.0}
    events = []
    br = cls(threshold=2, cooldown_s=5.0, now_fn=lambda: clock["t"],
             on_trip=lambda: events.append("trip"),
             on_recover=lambda: events.append("recover"))
    steps = []
    script = ["fail", "ok", "fail", "fail", "allow", "tick4", "allow",
              "tick2", "allow", "fail", "allow", "tick6", "allow", "ok",
              "fail", "fail", "tick5", "allow", "ok"]
    for s in script:
        if s == "fail":
            r = br.record_failure()
        elif s == "ok":
            r = br.record_success()
        elif s == "allow":
            r = br.allow()
        else:
            clock["t"] += float(s[4:])
            r = None
        steps.append((s, r, br.to_json(), br.state_code()))
    return steps, events


def test_circuit_breaker_transitions_equal_the_reference():
    ours = _breaker_history(BV.CircuitBreaker)
    assert ours == _breaker_history(RBV.CircuitBreaker)
    assert ours[1] == ["trip", "recover", "trip", "recover"]


# ------------------------------------------------------------ no fallback


def test_a_raising_member_raises_and_counts_against_every_participant(
        monkeypatch):
    calls = []

    def kernel(*args):
        calls.append(args[0].shape[0])
        if len(calls) == 2:
            raise RuntimeError("member 1 lost")
        return torch.zeros(args[0].shape[0], dtype=torch.bool)

    def no_cpu_verify(*_a, **_k):
        raise AssertionError("a CPU verify ran")

    monkeypatch.setattr(E, "verify_kernel", kernel)
    monkeypatch.setattr(E, "verify_plain", no_cpu_verify)
    monkeypatch.setattr(K, "raw_verify_batch", no_cpu_verify)
    monkeypatch.setattr(K, "verify_sig", no_cpu_verify)
    st = BV.VerifierStats()
    v = BV.CudaSigVerifier(devices=["cpu"] * 3, shard_threshold=1)
    v.BUCKETS = (128,)
    v.stats = st
    triples = _batch(40)
    with pytest.raises(RuntimeError, match="member 1 lost"):
        v.verify_many(triples)
    assert calls == [43, 43]               # 128 rounds to 129 on 3
    assert [br.consecutive_failures for br in v.fleet_health.breakers] \
        == [1, 1, 1]
    assert v.batches_dispatched == 0
    assert all(d["inflight"] == 0 for d in st.to_json()["devices"].values())
    # a flush keeps its batch queued, every future unresolved
    futs = [v.enqueue(*t) for t in triples[:5]]
    calls.clear()
    with pytest.raises(RuntimeError, match="member 1 lost"):
        v.flush()
    assert v.pending() == 5 and not any(f.done() for f in futs)
    assert [br.consecutive_failures for br in v.fleet_health.breakers] \
        == [2, 2, 2]


def test_every_breaker_open_uses_every_member():
    clock = {"t": 0.0}
    v = _PortStub(3, now_fn=lambda: clock["t"], shard_threshold=1,
                  device_breaker_threshold=1)
    for i in range(3):
        v.fleet_health.record_failure(i)
    assert v.fleet_health.healthy() == []
    fn, b, idxs = v._route(100)
    assert idxs == (0, 1, 2) and b == 129


# ------------------------------------------------- warm start and staging


def test_warmup_plan_persisted_beside_the_build_and_used(tmp_path):
    st = BV.VerifierStats()
    for _ in range(4):
        st.record_bucket_dispatch(512, 512, 0)
    v = BV.CudaSigVerifier(devices=["cpu"], plan_dir=str(tmp_path))
    v.stats = st
    path = v.save_warmup_plan()
    assert path == str(tmp_path / "warmup_buckets.json")
    with open(path) as fh:
        blob = json.load(fh)
    assert blob["buckets"] == [512] and blob["traffic"] == {"512": 4}

    v2 = BV.CudaSigVerifier(devices=["cpu"], plan_dir=str(tmp_path))
    v2.stats = BV.VerifierStats()
    compiled = []
    v2._compile_bucket = compiled.append
    v2.warmup(wait=True)
    assert compiled == [512]
    w = v2.stats.warmup_json()
    assert w["state"] == "done" and w["source"] == "cockpit"
    assert v2.stats.to_json()["compile_cache"]["dir"] == str(tmp_path)

    v3 = BV.CudaSigVerifier(devices=["cpu"], plan_dir=str(tmp_path))
    v3.BUCKETS = (128, 2048)
    v3.stats = BV.VerifierStats()
    compiled3 = []
    v3._compile_bucket = compiled3.append
    v3.warmup(wait=True)
    assert compiled3 == [128, 2048]
    assert v3.stats.warmup_json()["source"] == "default"
    assert BV.CudaSigVerifier(devices=["cpu"]).save_warmup_plan() is None


def test_warmup_launches_each_planned_bucket(tmp_path, monkeypatch):
    """A real warmup on a 2-member CPU fleet: bucket 8 on one member,
    bucket 16 sharded (SHARD_MIN_BATCH 16); nothing to build on the CPU,
    so every bucket classifies "unknown"."""
    seen = []
    plain = E.verify_kernel

    def kernel(*args):
        seen.append(args[0].shape[0])
        return plain(*args)

    monkeypatch.setattr(E, "verify_kernel", kernel)
    v = BV.CudaSigVerifier(devices=["cpu"] * 2, shard_threshold=16,
                           plan_dir=str(tmp_path))
    v.BUCKETS = (8, 16)
    v.stats = BV.VerifierStats()
    v.warmup(wait=True)
    assert seen == [8, 8, 8]
    assert list(v._mesh_fns) == [(0, 1)]
    w = v.stats.warmup_json()
    assert w["state"] == "done" and sorted(w["buckets"]) == ["16", "8"]
    assert {b["cache"] for b in w["buckets"].values()} == {"unknown"}


class _Lazy:
    """A launch in flight: the wait (50 ms) is in the gather, as in
    `parallel/mesh.Launched`."""

    def __init__(self, arr):
        self.arr = arr

    def __array__(self, dtype=None, copy=None):
        time.sleep(0.05)
        return self.arr


class _SlowStub(_PortStub):
    """The 'fleet' takes 50 ms per chunk and staging 30 ms."""

    def _single_fn(self):
        return lambda *args: _Lazy(_echo(*args))

    def _stage_chunk(self, chunk, route):
        time.sleep(0.03)
        return _stub_stage(self, chunk, route)


def test_staging_overlaps_the_fleet():
    reg = MetricsRegistry()
    st = BV.VerifierStats(metrics=reg)
    v = _SlowStub(1)
    v.BUCKETS = (128,)
    v.stats = st
    assert all(v.verify_many(_batch(3 * 128)))
    s = st.to_json()["staging"]
    assert s["chunks"] == 2 and s["stalls"] == 0
    assert s["staged_s"] > 0 and s["overlap_s"] > 0
    assert reg.to_json()["verifier.staging.overlap-pct"]["value"] > 0


def test_staged_chunks_equal_the_c_verifier():
    """Three chunks of 16 on two members with the real staging path: the
    worker prepares and places chunk K+1 while chunk K runs."""
    triples = _corrupt(_batch(40, tag=b"stage"), {0, 17, 39})
    st = BV.VerifierStats()
    v = BV.CudaSigVerifier(devices=["cpu"] * 2, shard_threshold=16)
    v.BUCKETS = (8, 16)
    v.stats = st
    assert v.verify_many(triples) == K.raw_verify_batch(triples)
    assert v.batches_dispatched == 3
    assert st.to_json()["staging"]["chunks"] == 2
