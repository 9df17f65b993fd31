"""The CUDA kernels on the card (marked `cuda`; skipped without one).

Run on a machine with a CUDA card (no JAX needed):

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The verify kernel's decisions must equal its plain version's on the same
CUDA tensors, lane for lane (adversarial vectors plus a seeded corpus),
at lane counts that end inside a warp, one past a block, a 3-member shard
of 8,193 and the largest bucket;
the SHA-256 kernel's digest words must equal its plain version's, every
lane including padding lanes and out-of-range counts, and hashlib's, also
on a full warp pair of 16-block lanes, one 16-block lane, a sorted
per-close chunk of 1,000 entry leaves at 1024 x 16 (padded by
`pad_chunk` over stale words) and a batch with no positive count. The
hasher's staging: a drain of six chunks through its two pinned buffers
(each reused three times), five times over, equals hashlib; every staged
chunk's words are 16-byte aligned on the card; the warmup launches once
per warm shape; `hash.device-lost` and `make_hasher("cuda-resilient")`
with `hash.dispatch-fail` raise with no launch, an open breaker refuses
and the probe launches. Each
wrapper must count each launch and reject what its kernel does not take,
and `CudaSigVerifier` / `CudaBatchHasher` on their default device must
match the CPU backends, as must fleets of 2 and 3 members sharing the
card (a staged drain repeated five times), and a 3-member sharded verify
on a ragged lane count must equal verify_plain. On the card's host the C
host prep must equal the numpy prep on every deciding row; one burst
through `make_verifier("cuda-async")` must launch once and complete every
future from the card; `make_verifier("cuda-resilient")` with
`device.dispatch` firing must raise, trip, refuse drains while open
(no launch, no CPU verify) and re-close on the half-open probe, which
launches the kernel. The state commitment engine over the card's hasher
must give the `hashlib` twin's root on every close of a churned bucket
list (40 closes of entries in the testing/entries.py mix, with updates
and tombstones), `from_scratch_root` on the last, and the twin's proofs.
The ledger-close schedule closes in the apply engine on the card's stacks
against a twin in the Python phases, and a cold close in the engine
launches the verify kernel once, as the engine's candidates derive, with
the C verifier's decisions. Tolerance: none.
"""

import numpy as np
import pytest
import torch

import hashlib

from stellar_core_tpu_torch.crypto import keys as K
from stellar_core_tpu_torch.crypto.batch_hasher import (
    CudaBatchHasher, make_hasher,
)
from stellar_core_tpu_torch import native
from stellar_core_tpu_torch.crypto.batch_verifier import (
    BreakerOpenError, CpuSigVerifier, CudaSigVerifier, make_verifier,
)
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ops import ed25519 as E
from stellar_core_tpu_torch.ops import sha256 as S
from stellar_core_tpu_torch.testing.entries import entry_records
from stellar_core_tpu_torch.testing.vectors import _vectors
from stellar_core_tpu_torch.util.faults import FaultInjector, InjectedFault
from stellar_core_tpu_torch.util.metrics import MetricsRegistry
from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
from stellar_core_tpu_torch.xdr import PublicKey

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _triples(n: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    keys = [SecretKey(rng.bytes(32)) for _ in range(8)]
    out = []
    for i in range(n):
        msg = rng.bytes(int(rng.integers(0, 400)))
        sig = bytearray(keys[i % 8].sign(msg))
        if i % 7 == 6:
            sig[int(rng.integers(0, 64))] ^= 4
        out.append((keys[i % 8].public_key.key_bytes, bytes(sig), msg))
    return out


def _device_args(triples, device):
    prep = E.prepare_batch(*map(list, zip(*triples)))
    return prep, tuple(torch.from_numpy(prep[k]).to(device)
                       for k in E.ARG_KEYS)


@pytest.mark.parametrize("n", [1, 33, 128, 129, 1000, 2731, 8192])
def test_kernel_matches_plain_on_card(card, n):
    vecs = [(p, s, m) for (_l, p, s, m) in _vectors()]
    triples = (vecs + _triples(max(n - len(vecs), 0)))[:n]
    prep, args = _device_args(triples, card)
    before = E.LAUNCHES
    got = E.verify_kernel(*args)
    torch.cuda.synchronize()
    assert E.LAUNCHES == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.bool
    want = E.verify_plain(*args)
    assert torch.equal(got, want)
    decisions = (got.cpu().numpy() & prep["pre_ok"]).tolist()
    assert decisions == K.raw_verify_batch(triples)


def test_empty_batch_launches_nothing(card):
    _prep, args = _device_args(_triples(2), card)
    before = E.LAUNCHES
    out = E.verify_kernel(*(a[:0] for a in args))
    assert out.shape == (0,) and E.LAUNCHES == before


def test_wrapper_rejects_mixed_devices(card):
    _prep, args = _device_args(_triples(4), card)
    with pytest.raises(ValueError):
        E.verify_kernel(args[0].cpu(), *args[1:])
    with pytest.raises(ValueError):
        E.verify_kernel(args[0], args[1].cpu(), *args[2:])


def test_cuda_verifier_matches_cpu(card):
    K.flush_verify_cache()
    triples = _triples(300, seed=12)
    v = CudaSigVerifier()
    assert v.device.type == "cuda"
    assert v.verify_many(triples) == CpuSigVerifier().verify_many(triples)
    assert v.batches_dispatched == 1
    K.flush_verify_cache()


def test_two_member_fleet_on_one_card_matches_cpu(card):
    """Two members sharing the card, each on its own streams: a 2048
    chunk sharded 1024 + 1024 (two launches), the 300 tail on member 0."""
    K.flush_verify_cache()
    triples = _triples(2048 + 300, seed=15)
    v = CudaSigVerifier(devices=["cuda:0", "cuda:0"])
    v.BUCKETS = (512, 2048)
    before = E.LAUNCHES
    assert v.verify_many(triples) == CpuSigVerifier().verify_many(triples)
    assert E.LAUNCHES == before + 3
    assert list(v._mesh_fns) == [(0, 1)]
    K.flush_verify_cache()


def test_three_member_sharded_verify_equals_plain_on_ragged_lanes(card):
    """129 lanes over three members of the card, 43 each (not a multiple
    of the kernel's block): every lane, the padding lane too, equals
    verify_plain over the whole batch."""
    from stellar_core_tpu_torch.parallel.mesh import (
        make_fleet, pad_batch_to, sharded_verify,
    )
    triples = [(p, s, m) for (_l, p, s, m) in _vectors()][:64]
    triples += _triples(128 - len(triples), seed=17)
    prep = pad_batch_to(E.prepare_batch(*map(list, zip(*triples))), 129)
    arrays = [prep[k] for k in E.ARG_KEYS]
    got = sharded_verify(make_fleet(["cuda:0"] * 3))(*arrays)
    want = E.verify_plain(*(torch.from_numpy(a).cuda() for a in arrays))
    assert torch.equal(got, want.cpu())
    assert (got[:128].numpy() & prep["pre_ok"][:128]).tolist() == \
        K.raw_verify_batch(triples)


def test_staged_drain_repeats_identically(card):
    """A multi-chunk drain over three members of the card, five times:
    chunk K+1 is copied on the staging streams while chunk K runs, so a
    launch that does not wait for its copies would read a half-copied
    batch and give other decisions on some run."""
    K.flush_verify_cache()
    triples = _triples(4 * 1024 + 77, seed=16)
    want = CpuSigVerifier().verify_many(triples)
    v = CudaSigVerifier(devices=["cuda:0"] * 3)
    v.BUCKETS = (128, 1024)
    for _ in range(5):
        assert v.verify_many(triples) == want
    assert v.batches_dispatched == 5 * 5
    K.flush_verify_cache()


# --- SHA-256 ------------------------------------------------------------------

def _hash_args(lanes: int, blocks: int, device, seed: int = 13):
    """Real padded messages in most lanes, then lanes of random words with
    counts in [-1, blocks + 3]."""
    rng = np.random.default_rng(seed)
    n = max(1, lanes * 3 // 4)
    msgs = [rng.bytes(int(x)) for x in rng.integers(0, 64 * blocks - 8, n)]
    words = rng.integers(0, 1 << 32, (lanes, blocks, 16),
                         dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(-1, blocks + 4, lanes).astype(np.int32)
    words[:n], counts[:n] = S.pad_messages_np(msgs, blocks)
    return msgs, (torch.from_numpy(words.view(np.int32)).to(device),
                  torch.from_numpy(counts).to(device))


@pytest.mark.parametrize("lanes,blocks", [(1, 1), (33, 2), (256, 16),
                                          (4096, 2), (1000, 5)])
def test_sha256_kernel_matches_plain_on_card(card, lanes, blocks):
    msgs, args = _hash_args(lanes, blocks, card)
    before = S.LAUNCHES
    got = S.hash_blocks_kernel(*args)
    torch.cuda.synchronize()
    assert S.LAUNCHES == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, S.hash_blocks_plain(*args))
    host = got.cpu().numpy().view(np.uint32)
    assert S.digests_to_bytes(host[:len(msgs)]) == \
        [hashlib.sha256(m).digest() for m in msgs]


def _staging_case(kind: str):
    """(messages, words uint32, counts int32) of one staging case: real
    messages first, the other lanes garbage words."""
    rng = np.random.default_rng(15)
    if kind == "idle":
        # every count 0 or negative: no block is staged, every lane H0
        words = rng.integers(0, 1 << 32, (300, 4, 16),
                             dtype=np.uint64).astype(np.uint32)
        return [], words, rng.integers(-5, 1, 300).astype(np.int32)
    if kind == "per-close":
        # 1,000 entry leaves in the hasher's order, staged at 1024 x 16
        msgs = [b"\x00" + r for r in entry_records(rng, 1000)]
        h = CudaBatchHasher(device="cpu")
        _over, chunks = h.plan([S.blocks_for_len(len(m)) for m in msgs])
        msgs = [msgs[i] for i in chunks[0][0]]
        # padded as the hasher stages it: real blocks only, stale words
        # past each lane's count
        words = rng.integers(0, 1 << 32, (1024, 16, 16),
                             dtype=np.uint64).astype(np.uint32)
        counts = np.empty((1024,), np.int32)
        S.pad_chunk(*S.join_messages(msgs), words.view(np.int32), counts)
        return msgs, words, counts
    # "pair": a full warp pair of 16-block lanes (the most staged);
    # "chain": one lane of 16 blocks
    lanes = 32 if kind == "pair" else 1
    msgs = [rng.bytes(int(n)) for n in rng.integers(64 * 15 - 8, 64 * 16 - 8,
                                                    lanes)]
    words, counts = S.pad_messages_np(msgs, 16)
    assert (counts == 16).all()
    return msgs, words, counts


@pytest.mark.parametrize("kind", ["pair", "chain", "per-close", "idle"])
def test_sha256_kernel_staging_cases_match_plain(card, kind):
    msgs, words, counts = _staging_case(kind)
    w = torch.from_numpy(words.view(np.int32)).to(card)
    c = torch.from_numpy(counts).to(card)
    before = S.LAUNCHES
    got = S.hash_blocks_kernel(w, c)
    torch.cuda.synchronize()
    assert S.LAUNCHES == before + 1
    assert torch.equal(got, S.hash_blocks_plain(w, c))
    host = got.cpu().numpy().view(np.uint32)
    assert S.digests_to_bytes(host[:len(msgs)]) == \
        [hashlib.sha256(m).digest() for m in msgs]
    assert (host[len(msgs):] == S._H0).all()


def test_sha256_empty_batch_launches_nothing(card):
    _msgs, (w, c) = _hash_args(4, 1, card)
    before = S.LAUNCHES
    out = S.hash_blocks_kernel(w[:0], c[:0])
    assert out.shape == (0, 8) and S.LAUNCHES == before


def test_sha256_wrapper_rejects_mixed_devices_and_misalignment(card):
    _msgs, (w, c) = _hash_args(4, 2, card)
    with pytest.raises(ValueError):
        S.hash_blocks_kernel(w.cpu(), c)
    with pytest.raises(ValueError):
        S.hash_blocks_kernel(w, c.cpu())
    flat = torch.zeros(4 * 2 * 16 + 1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        S.hash_blocks_kernel(flat[1:].view(4, 2, 16), c)


def test_cuda_hasher_matches_hashlib(card):
    rng = np.random.default_rng(14)
    msgs = [rng.bytes(n) for n in
            (0, 3, 40, 64, 119, 300, 900, 1015, 1016, 2048)] * 3
    msgs += [rng.bytes(int(n)) for n in rng.integers(0, 200, 5000)]
    h = make_hasher("cuda")
    assert isinstance(h, CudaBatchHasher) and h.device.type == "cuda"
    before = S.LAUNCHES
    assert h.hash_many(msgs, site="bench") == \
        [hashlib.sha256(m).digest() for m in msgs]
    assert h.oversize_msgs == 6 and h.batches == 2
    assert S.LAUNCHES == before + 2


def test_native_prep_equals_numpy_prep_on_the_card_host(card):
    vecs = [(p, s, m) for (_l, p, s, m) in _vectors()]
    triples = vecs + _triples(8192 - len(vecs))
    cols = list(map(list, zip(*triples)))
    assert native.prep_lib() is not None, "the C prep must build here"
    ref = E.prepare_batch_plain(*cols)
    calls = native.PREP_CALLS
    nat = E.prepare_batch(*cols)
    assert native.PREP_CALLS == calls + 1
    assert (ref["pre_ok"] == nat["pre_ok"]).all()
    mask = ref["pre_ok"]
    for k in E.ARG_KEYS:
        assert (ref[k][mask] == nat[k][mask]).all(), k


def test_cuda_async_burst_launches_once(card):
    K.flush_verify_cache()
    clock = VirtualClock(ClockMode.REAL_TIME)
    reg = MetricsRegistry(now_fn=clock.now)
    v = make_verifier("cuda-async", clock=clock, metrics=reg)
    triples = _triples(120, seed=21)
    want = CpuSigVerifier().verify_many(triples)
    before = E.LAUNCHES
    futs = [v.enqueue(PublicKey.ed25519(k), s, m)
            for (k, s, m) in triples]
    v.flush()
    deadline = clock.now() + 60
    while not all(f.done() for f in futs) and clock.now() < deadline:
        clock.crank(True)
    assert [f.result() for f in futs] == want
    assert E.LAUNCHES == before + 1
    m = reg.to_json()
    assert "crypto.verify.dispatch-failure" not in m
    assert "crypto.verify.requeued" not in m
    assert "cpu" not in v.stats.to_json()["drains"]["by_backend"]
    assert m["crypto.verify.latency"]["count"] == 120
    assert v.breaker.state == "closed"
    K.flush_verify_cache()


def test_cuda_resilient_trips_and_recovers(card):
    """Failed drains raise with no launch and no CPU verify, the open
    breaker refuses drains, and the half-open probe launches once."""
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    reg = MetricsRegistry(now_fn=clock.now)
    v = make_verifier("cuda-resilient", clock=clock, metrics=reg,
                      breaker_threshold=3, breaker_cooldown=30.0)
    assert v.fallback is None
    v.faults = FaultInjector(metrics=reg)
    v.faults.configure("device.dispatch", count=3)
    triples = _triples(300, seed=23)
    want = CpuSigVerifier().verify_many(triples)
    before = E.LAUNCHES
    K.flush_verify_cache()
    for _ in range(3):
        with pytest.raises(InjectedFault):
            v.prewarm_many(triples)
    assert v.breaker.state == "open"
    with pytest.raises(BreakerOpenError):
        v.prewarm_many(triples)
    assert E.LAUNCHES == before
    m = reg.to_json()
    assert m["crypto.verify.dispatch-failure"]["count"] == 3
    assert m["crypto.verify.refused-drain"]["count"] == 1
    assert "crypto.verify.fallback-drain" not in m
    assert v.stats.to_json()["drains"]["by_backend"] == {}
    clock.set_virtual_time(31.0)
    assert v.prewarm_many(triples) == want
    assert E.LAUNCHES == before + 1
    assert v.breaker.state == "closed" and v.breaker.recoveries == 1
    K.flush_verify_cache()


# --- the hasher's staging and operator layers --------------------------------

def _hash_msgs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(x)) for x in rng.integers(0, 500, n)]


def test_hash_drain_reuses_pinned_buffers(card):
    """Six chunks of 1,024 lanes: buffers 0 and 1 each staged three times
    a drain while the other's chunk runs; a padder that overwrote a buffer
    before its copy was done would change digests on some run."""
    msgs = _hash_msgs(6 * 1024 - 100, seed=24)
    want = [hashlib.sha256(m).digest() for m in msgs]
    h = make_hasher("cuda")
    h.LANE_BUCKETS = (256, 1024)
    assert all(b.words.is_pinned() and b.counts.is_pinned()
               for b in h._buffers)
    before = S.LAUNCHES
    for _ in range(5):
        assert h.hash_many(msgs, site="bucket-entries") == want
    assert S.LAUNCHES == before + 30 and h.batches == 30
    st = h.stats.to_json()["staging"]
    assert st["chunks"] == 25 and st["stalls"] == 0


def test_hash_staged_words_are_aligned(card):
    h = CudaBatchHasher()
    for lanes, blocks in ((1, 1), (256, 2), (1024, 5), (4096, 16)):
        msgs = _hash_msgs(lanes, seed=lanes)[:lanes]
        msgs = [m[:64 * blocks - 9] for m in msgs]
        blob, off, lens = S.join_messages(msgs)
        staged = h._stage_hash_chunk(blob, off, lens, lanes, blocks,
                                     lanes % 2)
        assert staged["words"].data_ptr() % 16 == 0
        assert staged["words"].is_cuda and staged["words"].shape == \
            (lanes, blocks, 16)
        got = h._launch(staged)[:lanes].cpu().numpy().view(np.uint32)
        assert S.digests_to_bytes(got) == \
            [hashlib.sha256(m).digest() for m in msgs]


def test_hash_warmup_launches_each_shape(card):
    h = make_hasher("cuda-resilient")
    before = S.LAUNCHES
    h.warmup(wait=True)
    w = h.stats.to_json()["warmup"]
    assert w["state"] == "done" and len(w["shapes"]) == 3
    assert S.LAUNCHES == before + 3
    assert all(v["cache"] in ("hit", "miss") for v in w["shapes"].values())


def test_hash_faults_raise_on_the_card(card):
    msgs = _hash_msgs(300, seed=25)
    want = [hashlib.sha256(m).digest() for m in msgs]
    faults = FaultInjector()
    faults.configure("hash.device-lost", count=1)
    h = make_hasher("cuda", faults=faults)
    before = S.LAUNCHES
    with pytest.raises(InjectedFault):
        h.hash_many(msgs)
    assert S.LAUNCHES == before
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    reg = MetricsRegistry(now_fn=clock.now)
    faults = FaultInjector(metrics=reg)
    faults.configure("hash.dispatch-fail", count=3)
    r = make_hasher("cuda-resilient", clock=clock, metrics=reg,
                    faults=faults, breaker_threshold=3,
                    breaker_cooldown=30.0)
    for _ in range(3):
        with pytest.raises(InjectedFault):
            r.hash_many(msgs)
    with pytest.raises(BreakerOpenError):
        r.hash_many(msgs)
    assert S.LAUNCHES == before
    assert r.stats.to_json()["drains"]["by_backend"] == {}
    clock.set_virtual_time(31.0)
    assert r.hash_many(msgs) == want
    assert S.LAUNCHES == before + 1 and r.breaker.state == "closed"


def test_state_commitment_on_the_card(card):
    from types import SimpleNamespace
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.bucket import BucketManager
    from stellar_core_tpu_torch.ledger import state_commitment as SC
    from stellar_core_tpu_torch.testing.entries import bucket_entries
    rng = np.random.default_rng(17)
    mgr = BucketManager(background_merges=False)
    cfg = SimpleNamespace(NODE_SEED=SecretKey(b"\x07" * 32),
                          network_id=b"\x4e" * 32,
                          STATE_CHECKPOINT_INTERVAL=8)
    eng = SC.StateCommitmentEngine(SimpleNamespace(
        batch_hasher=make_hasher("cuda"), config=cfg, metrics=None))
    twin = SC.StateCommitmentEngine(SimpleNamespace(
        batch_hasher=make_hasher("cpu"), config=cfg, metrics=None))
    live = []
    S.LAUNCHES = 0
    for seq in range(1, 41):
        inits = [b.value for b in bucket_entries(entry_records(rng, 60))]
        pick = rng.choice(len(live), min(len(live), 30),
                          replace=False).tolist() if live else []
        ups = []
        for i in pick[:25]:
            e = X.LedgerEntry.from_xdr(live[i].to_xdr())
            e.lastModifiedLedgerSeq = seq
            live[i] = e
            ups.append(e)
        deads = []
        for i in sorted(pick[25:], reverse=True):
            deads.append(X.ledger_entry_key(live.pop(i)))
        live += inits
        mgr.add_batch(seq, 13, inits, ups, deads)
        hh = bytes([seq]) * 32
        cp, tcp = eng.on_close(mgr.bucket_list, seq, hh), \
            twin.on_close(mgr.bucket_list, seq, hh)
        assert eng.root == twin.root, seq
        assert (cp and cp.to_json()) == (tcp and tcp.to_json())
    assert S.LAUNCHES > 0
    assert eng.root == eng.from_scratch_root(mgr.bucket_list)
    for e in live[::97]:
        key = X.ledger_entry_key(e)
        proof = eng.prove_entry(key)
        assert proof is not None and proof == twin.prove_entry(key)
        assert SC.light_client_verify(proof, eng.checkpoint(),
                                      b"\x4e" * 32) == (True, "ok")


def _close_side(lm, blobs, upgrades=()):
    """trim_invalid then value_externalized on one port side, from an
    empty verify cache (the card and its twin share the process's
    cache); returns the removed hashes and the applied frames."""
    from torch_close_harness import PORT, close_one
    K.flush_verify_cache()
    return close_one(lm, PORT, blobs, upgrades)


def test_ledger_closes_on_card_match_cpu_twin(card, tmp_path):
    """The ledger-close schedule of test_torch_ledger_close on a port
    LedgerManager whose verifier and hasher are the card's
    "cuda-resilient" stacks, against a twin on CpuSigVerifier and the
    hashlib hasher: the same trimmed sets and every observed byte equal
    after every close; each validation launches the verify kernel once
    (one prewarm batch, or a lone transaction's check) and its close not
    at all. The card's closes run in the apply engine, the twin's in the
    Python phases."""
    from stellar_core_tpu_torch.crypto.batch_verifier import make_verifier
    from torch_close_harness import Workload, make_port_side, observe
    v = make_verifier("cuda-resilient")
    h = make_hasher("cuda-resilient")
    lm = make_port_side(str(tmp_path / "card"), "sqlite3://:memory:",
                        verifier=v, hasher=h)
    twin = make_port_side(str(tmp_path / "twin"), "sqlite3://:memory:")
    twin.use_native_apply = False
    w = Workload(lm)
    E.LAUNCHES = S.LAUNCHES = 0
    closes = 0
    for build, ups in w.schedule():
        blobs = [f.envelope_bytes() for f in build()]
        e0 = E.LAUNCHES
        removed, frames = _close_side(lm, blobs, ups)
        assert E.LAUNCHES - e0 == 1, closes
        assert (lm.last_apply_path, twin.use_native_apply) == \
            ("native", False)
        t_removed, t_frames = _close_side(twin, blobs, ups)
        assert removed == t_removed
        got, want = observe(lm, frames), observe(twin, t_frames)
        for k in got:
            assert got[k] == want[k], (closes, k)
        closes += 1
    assert closes == 18 and S.LAUNCHES > 0
    for side in (lm, twin):
        side.app.bucket_manager.shutdown()


def test_engine_cold_close_on_card_launches_as_derived(card, tmp_path):
    """A cold close in the apply engine on the card: the set validated,
    the verify cache flushed, then closed. The engine's one verify
    callback gets the candidates derived from the state
    (`engine_candidates`) and launches the kernel once per 8,192 of them
    (here once, where the Python phases launch once per transaction); its
    decisions equal the C verifier's, and the close equals a twin's
    closing through the Python phases."""
    from stellar_core_tpu_torch.crypto.batch_verifier import make_verifier
    from torch_close_harness import (
        PORT, Workload, close_one, engine_candidates, engine_launches,
        make_port_side, observe,
    )
    v = make_verifier("cuda-resilient")
    lm = make_port_side(str(tmp_path / "card"), "sqlite3://:memory:",
                        verifier=v, hasher=make_hasher("cuda-resilient"))
    twin = make_port_side(str(tmp_path / "twin"), "sqlite3://:memory:")
    twin.use_native_apply = False
    w = Workload(lm)
    sched = list(w.schedule())
    for build, ups in sched[:6]:        # senders, signers, trust lines
        blobs = [f.envelope_bytes() for f in build()]
        assert _close_side(lm, blobs, ups)[0] == \
            _close_side(twin, blobs, ups)[0]
    build, ups = sched[6]
    blobs = [f.envelope_bytes() for f in build()]
    net = lm.app.config.network_id
    frames = [PORT.TransactionFrame.make_from_wire(
        net, PORT.X.TransactionEnvelope.from_xdr(b)) for b in blobs]
    ts = PORT.TxSetFrame(net, lm.lcl_hash, frames)
    K.flush_verify_cache()
    removed = ts.trim_invalid(lm.ltx_root(), v)
    K.flush_verify_cache()
    applied = ts.sort_for_apply()
    cands = engine_candidates(lm.root, applied)
    want = engine_launches(cands)
    calls = []
    inner = v.prewarm_many

    def recording(triples):
        got = inner(triples)
        calls.append((list(triples), list(got)))
        return got

    v.prewarm_many = recording
    header = lm.root.get_header()
    value = PORT.X.StellarValue(
        txSetHash=ts.get_contents_hash(), closeTime=header.scpValue
        .closeTime + 5, upgrades=list(ups),
        ext=PORT.X.StellarValueExt(0, None))
    e0 = E.LAUNCHES
    lm.value_externalized(PORT.LedgerCloseData(header.ledgerSeq + 1, ts,
                                               value))
    del v.prewarm_many
    assert lm.last_apply_path == "native"
    assert want == 1 < len(applied)
    assert E.LAUNCHES - e0 == want
    assert [t for t, _g in calls] == [cands]
    assert calls[0][1] == K.raw_verify_batch(cands)
    t_removed, t_frames = _close_side(twin, blobs, ups)
    assert sorted(f.contents_hash() for f in removed) == t_removed
    got, want_o = observe(lm, applied), observe(twin, t_frames)
    for k in got:
        assert got[k] == want_o[k], k
    for side in (lm, twin):
        side.app.bucket_manager.shutdown()


def test_catchup_on_card_matches_cpu_publisher(card, tmp_path):
    """A port node on the C verifier and `make_hasher("cpu")` closes the
    ledger-close schedule (checkpoints of 8) and publishes two
    checkpoints; a fresh node on the card's "cuda-resilient" stacks
    catches up from that archive, complete: every header it stores
    equals the publisher's, its bucket list the header's, its commitment
    root a CPU node's caught up the same way; the
    checkpoints' drains launch the verify kernel, the replayed closes
    launch it never, and no signature is verified on the CPU."""
    from stellar_core_tpu_torch.catchup import CatchupConfiguration
    from stellar_core_tpu_torch.crypto.batch_verifier import make_verifier
    from stellar_core_tpu_torch.work.basic_work import State
    from torch_catchup_harness import (
        crank_until, header_hashes, make_port_app, run_work, stop,
    )
    from torch_close_harness import Workload
    freq = 8
    root = tmp_path / "archive"
    root.mkdir()
    pub = make_port_app(tmp_path / "pub", archives=[("test", root)],
                        writable=True, freq=freq)
    w = Workload(pub.ledger_manager)
    for build, ups in w.schedule():
        _close_side(pub.ledger_manager,
                    [f.envelope_bytes() for f in build()], ups)
    assert crank_until(pub, lambda: pub.history_manager.publish_queue()
                       == [])
    assert pub.history_manager.published_checkpoints == 2
    tip = 2 * freq - 1
    node = make_port_app(tmp_path / "card", archives=[("test", root)],
                         freq=freq, verifier=make_verifier("cuda-resilient"),
                         hasher=make_hasher("cuda-resilient"))
    in_close = []
    close = node.ledger_manager.close_ledger

    def counting_close(lcd):
        e0 = E.LAUNCHES
        close(lcd)
        in_close.append(E.LAUNCHES - e0)

    node.ledger_manager.close_ledger = counting_close
    calls = []
    real = K.raw_verify_batch
    K.raw_verify_batch = lambda t: calls.append(len(t)) or real(t)
    K.flush_verify_cache()
    E.LAUNCHES = S.LAUNCHES = 0
    try:
        work = node.catchup_manager.start_catchup(
            CatchupConfiguration.complete())
        assert run_work(node, work) == State.SUCCESS
    finally:
        K.raw_verify_batch = real
    assert node.ledger_manager.last_closed_ledger_num() == tip
    assert header_hashes(node.database, 1, tip) == \
        header_hashes(pub.database, 1, tip)
    assert node.bucket_manager.get_hash() == \
        node.ledger_manager.lcl_header.bucketListHash
    twin = make_port_app(tmp_path / "twin", archives=[("test", root)],
                         freq=freq)
    work = twin.catchup_manager.start_catchup(
        CatchupConfiguration.complete())
    assert run_work(twin, work) == State.SUCCESS
    assert node.state_commitment.root == twin.state_commitment.root
    assert E.LAUNCHES > 0 and S.LAUNCHES > 0
    assert len(in_close) == tip - 1 and not any(in_close)
    assert calls == []
    for app in (pub, node, twin):
        stop(app)


def test_herder_network_on_card_reaches_consensus(card, tmp_path):
    """Four port validators in a 3-of-4 quorum, each on
    `make_verifier("cuda")` and `make_hasher("cuda")`, over the herder
    harness's relay: three slots (fund four senders, arm them, a slot of
    4-signature payments with one corrupted, refused by every node). Every
    node externalizes the same value and closes to the same hashes as a
    CPU twin closing the same values; the verify kernel launches once per
    distinct envelope and once per transaction's first admission, and
    nothing sent to the card is verified on the CPU."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.herder.txset import TxSetFrame
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerCloseData
    import torch_herder_harness as H
    keys = [H.node_seed(i).public_key for i in range(4)]
    qset = H.flat_qset(X, keys, 3)
    relay = None
    for i in range(4):
        cfg = H.node_config(i, qset, i == 0, 1000)
        app = H.make_port_node(tmp_path / ("n%d" % i), cfg,
                               make_verifier("cuda"), make_hasher("cuda"))
        relay = relay or H.Relay(cfg.network_id)
        relay.join("n%d" % i, app)
    twin = H.make_port_app(tmp_path / "twin",
                           config=H.node_config(4, qset, False, 1000))
    tr = H.Traffic(relay.nodes[0].app.ledger_manager, relay.network_id,
                   relay.nodes[0].app.network_root_key(), senders=4, sigs=4,
                   corrupt_every=3)
    sites = H.Sites(lambda: E.LAUNCHES)
    for n in relay.nodes:
        sites.wrap(n.app.herder, "recv_scp_envelope", "envelope")
        sites.wrap(n.app.herder.tx_queue, "try_add", "admission")
    calls = []
    real = K.raw_verify_batch, K.raw_verify
    K.raw_verify_batch = lambda t: calls.extend(t) or real[0](t)
    K.raw_verify = lambda *t: calls.append(t) or real[1](*t)
    K.flush_verify_cache()
    E.LAUNCHES = S.LAUNCHES = 0
    n_txs = 0
    try:
        # each slot's transactions are built against the ledger it follows
        for seq, build in ((2, tr.fund), (3, tr.arm),
                           (4, lambda: tr.payments(4))):
            blobs = build()
            for k, b in enumerate(blobs):
                got = relay.submit(k % 4, b)
                bad = hashlib.sha256(b).digest() in tr.corrupted
                assert set(got) == {2 if bad else 0}
            n_txs += len(blobs)
            relay.close_slot(seq)
            sv = X.StellarValue.from_xdr(relay.nodes[0].externalized[seq])
            ts = relay.nodes[0].app.herder.pending.get_tx_set(sv.txSetHash)
            twin.ledger_manager.value_externalized(LedgerCloseData(
                seq, TxSetFrame.from_wire(relay.network_id, X.TransactionSet
                                          .from_xdr(ts.to_wire().to_xdr())),
                sv))
            want = (twin.ledger_manager.lcl_hash,
                    twin.bucket_manager.get_hash(),
                    twin.state_commitment.root)
            assert {relay.hashes(n) for n in relay.nodes} == {want}
    finally:
        K.raw_verify_batch, K.raw_verify = real
    assert tr.corrupted
    assert {k: c for k, c in sites.by_site.items() if c} == {
        "envelope": len(relay.envelopes), "admission": n_txs}
    assert E.LAUNCHES == len(relay.envelopes) + n_txs and S.LAUNCHES > 0
    # the herder checks nominated values' signatures on the host, as the
    # reference does; no envelope or transaction triple reaches the C
    # verifier
    assert set(calls) <= H.value_sig_triples(relay)
    for n in relay.nodes:
        H.stop(n.app)
    H.stop(twin)
