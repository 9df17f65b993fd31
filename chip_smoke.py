#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (`stellar_core_tpu_torch`) on
one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a). It builds every kernel from the
sources in the checkout, then:

1. holds each kernel against its plain PyTorch version on the card, on the
   same inputs, at every bucket of the verifier's ladder (128, 512, 2048
   and 8192; the main path launches at 128, 2048 and 8192): the
   adversarial ed25519 vectors plus a seeded corpus in which every 7th
   signature is corrupted. Tolerance: none, the decisions must be
   identical (a verifier that differs on one signature forks consensus);
2. calls the model entry (`graft_entry.entry()`) and checks that its
   forward ran on the card and accepted its batch;
3. drives the main path through the entry points a node calls, with every
   kernel's launch count set to 0 just before and read just after: a
   checkpoint-sized drain through `prewarm_many` (3 x 8192 + 1000
   signatures, the reference bench's fleet-verify drain plus a tail that
   lands in the 2048 bucket; 32 B, ~200 B and a few 4 KB messages), a
   second `prewarm_many` of the same drain that must dispatch nothing, and
   20 live-SCP bursts of 100-128 `enqueue`s, each followed by `flush`.
   Every decision must equal the port's C CPU verifier and the expected
   corruption pattern;
4. runs the drain once more, from an empty cache, under `torch.profiler`,
   and reads the card's busy share and the kernel's device time from the
   trace.

It prints the card's name and power limit, the build time, per-bucket
kernel and plain-version times (CUDA events), drain throughput, its
host layers timed alone, the profiled drain's device busy share, flush
latency, a `{"kernels": [...]}` line and, last, `{"ok": true, "device":
{...}}`. Any failed check raises (exit code 1) and prints no result; so
does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

DRAIN_CHUNK, DRAIN_CHUNKS, DRAIN_TAIL = 8192, 3, 1000
BURSTS, BURST_MIN, BURST_MAX = 20, 100, 128
CORRUPT_EVERY = 7
N_KEYS = 256

# Peak rates of the card used for bound_ms. Integer multiply: Hopper issues
# 64 32-bit integer multiply-adds per clock per SM (half its 128 FP32
# lanes); one IMAD.WIDE (32x32->64) is counted as one, which makes the
# bound a floor. Memory: the H100 SXM's 3.35 TB/s (NVIDIA data sheet).
IMAD_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
# 32x32->64 products per verify in the kernel's radix 2^25.5: 1,819 field
# multiplies (100 products each) and 1,550 squarings (55 each), counted
# from csrc/ed25519_verify.cu: two decompressions (19 mul + 255 sq each),
# -A and its folded T (2 mul), the table of v(-A) (4 doublings with T,
# 3 adds, 8 T folds: 40 mul + 16 sq), 64 ladder windows (20 mul + 16 sq
# each, plus one T on the last), 64 Niels adds (7 mul each), the final
# compare (2 mul). The count does not depend on the data.
FE_MUL_PER_VERIFY = 2 * 19 + 2 + 40 + 64 * 20 + 1 + 64 * 7 + 2
FE_SQ_PER_VERIFY = 2 * 255 + 16 + 64 * 16
PRODUCTS_PER_VERIFY = 100 * FE_MUL_PER_VERIFY + 55 * FE_SQ_PER_VERIFY
IN_BYTES_PER_VERIFY = 4 * (20 + 1 + 20 + 1 + 64 + 64) + 1   # inputs + out


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError("chip_smoke check failed: " + what)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=" + query,
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    return r.stdout.strip().splitlines()[0].strip()


def make_corpus(rng: np.random.Generator, n: int, keys: list) -> tuple:
    """n signed triples: 32 B, ~200 B and (every 50th) 4 KB messages;
    every CORRUPT_EVERY-th signature has one bit flipped. Returns
    (triples, expected decision per triple)."""
    lens = np.where(rng.random(n) < 0.6, 32, rng.integers(150, 251, n))
    lens[::50] = 4096
    blob = rng.bytes(int(lens.sum()))
    flips = rng.integers(0, 512, n)
    key_idx = rng.integers(0, len(keys), n)
    triples, expect = [], []
    off = 0
    for i in range(n):
        msg = blob[off:off + lens[i]]
        off += lens[i]
        sk = keys[key_idx[i]]
        sig = bytearray(sk.sign(msg))
        bad = i % CORRUPT_EVERY == CORRUPT_EVERY - 1
        if bad:
            sig[flips[i] // 8] ^= 1 << (flips[i] % 8)
        triples.append((sk.public_key, bytes(sig), msg))
        expect.append(not bad)
    return triples, expect


def time_cuda(fn, reps: int) -> float:
    """Mean ms of fn() over reps launches, after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_drain(run) -> dict:
    """run() under torch.profiler (CPU and CUDA activity): its result, its
    host wall time, and from the trace the card's busy time (the union of
    all device activity), the verify kernel's launches and device time,
    and the device time of the five largest names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    kern = [e for e in dev if "ed25519_verify_kernel" in e.name]
    return {"result": result, "wall_ms": wall_ms, "device_events": len(dev),
            "busy_ms": busy_us / 1e3, "kernel_launches": len(kern),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kern) / 1e3,
            "by_name": sorted(((k[:40], us / 1e3) for k, us
                               in by_name.items()),
                              key=lambda kv: -kv[1])[:5]}


def kernel_vs_plain(E, vectors: list, corpus: list, bucket: int,
                    props) -> dict:
    """The verify kernel against verify_plain on the same CUDA tensors at
    one bucket; their timings and the bound."""
    import torch
    triples = ([(p, s, m) for (_l, p, s, m) in vectors] +
               corpus[:bucket - len(vectors)])
    check(len(triples) == bucket, "batch fills bucket %d" % bucket)
    prep = E.prepare_batch([t[0] for t in triples], [t[1] for t in triples],
                           [t[2] for t in triples])
    args = tuple(torch.from_numpy(prep[k]).cuda() for k in E.ARG_KEYS)
    got = E.verify_kernel(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = E.verify_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mismatches = int((got != want).sum())
    check(mismatches == 0, "kernel == plain at bucket %d (%d lanes differ)"
          % (bucket, mismatches))
    ms = time_cuda(lambda: E.verify_kernel(*args),
                   reps=200 if bucket <= 512 else 20)
    ops_s = (props["sms"] * IMAD_PER_CLOCK_PER_SM * props["clock_hz"])
    param_bytes = 4 * 64 * 9 * 3 * 10 + 4 * 30
    bound_ops_ms = PRODUCTS_PER_VERIFY * bucket / ops_s * 1e3
    bound_bytes_ms = (IN_BYTES_PER_VERIFY * bucket + param_bytes) \
        / HBM_BYTES_PER_S * 1e3
    return {"decisions": (got.cpu().numpy() & prep["pre_ok"]).tolist(),
            "ms": ms, "plain_ms": plain_ms, "mismatches": mismatches,
            "bound_ms": max(bound_ops_ms, bound_bytes_ms),
            "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms
            else "bytes"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from stellar_core_tpu_torch import _build
    from stellar_core_tpu_torch.graft_entry import entry
    from stellar_core_tpu_torch.crypto import batch_verifier as BV
    from stellar_core_tpu_torch.crypto import keys as K
    from stellar_core_tpu_torch.native import ed25519_native
    from stellar_core_tpu_torch.ops import ed25519 as E
    from stellar_core_tpu_torch.testing.vectors import _vectors

    card = nvidia_smi("name,power.limit")
    log(card)
    log("python %s, torch %s, cuda %s" % (sys.version.split()[0],
                                          torch.__version__,
                                          torch.version.cuda))
    props = {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
             "clock_hz": float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6}
    log("SMs %d, max SM clock %.0f MHz" % (props["sms"],
                                           props["clock_hz"] / 1e6))

    # --- build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_cuda()
    check(ed25519_native() is not None, "the C CPU verifier builds")
    log("build: %.1f s (%s)" % (time.perf_counter() - t0,
                                ", ".join(sorted(libs))))
    with open(libs["ed25519_verify"][:-3] + ".log") as fh:
        for line in fh:
            if "registers" in line or "spill" in line:
                log("ptxas: " + line.strip())

    # --- data -------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    keys = [K.SecretKey(rng.bytes(32)) for _ in range(N_KEYS)]
    n_drain = DRAIN_CHUNK * DRAIN_CHUNKS + DRAIN_TAIL
    corpus, expect = make_corpus(rng, n_drain + BURSTS * BURST_MAX, keys)
    drain, drain_expect = corpus[:n_drain], expect[:n_drain]
    burst_pool, burst_expect = corpus[n_drain:], expect[n_drain:]
    vectors = _vectors()
    log("data: %d signed triples + %d adversarial vectors in %.1f s"
        % (len(corpus), len(vectors), time.perf_counter() - t0))
    t0 = time.perf_counter()
    cpu_ref = K.raw_verify_batch(corpus)
    cpu_s = time.perf_counter() - t0
    check(cpu_ref == expect, "C CPU verifier == corruption pattern")
    vec_ref = K.raw_verify_batch([(p, s, m) for (_l, p, s, m) in vectors])
    check(any(vec_ref[1:]), "some hostile vector accepts")
    log("C CPU verifier (one thread): %d sigs in %.2f s = %.0f sigs/s"
        % (len(corpus), cpu_s, len(corpus) / cpu_s))

    # --- each kernel against its plain version, on the card ---------------
    warm = tuple(torch.from_numpy(a[:32]).cuda() for a in (
        E.prepare_batch(*zip(*corpus[:32]))[k] for k in E.ARG_KEYS))
    E.verify_plain(*warm)     # the plain version's first-call costs
    ladder = BV.CudaSigVerifier.BUCKETS
    buckets = {}
    for b in ladder:
        r = kernel_vs_plain(E, vectors, corpus, b, props)
        check(r["decisions"][:len(vectors)] == vec_ref,
              "kernel == C verifier on every adversarial vector")
        check(r["decisions"][len(vectors):]
              == expect[:b - len(vectors)],
              "kernel decisions == corruption pattern at bucket %d" % b)
        buckets[b] = r
        log("kernel ed25519_verify bucket %d: %.4f ms (%.1f sigs/ms), "
            "plain %.1f ms, bound %.4f ms (%s), mismatches %d"
            % (b, r["ms"], b / r["ms"], r["plain_ms"], r["bound_ms"],
               r["bound_by"], r["mismatches"]))

    kernel_ms = {b: r["ms"] for b, r in buckets.items()}

    # --- the model entry, on the card -------------------------------------
    fwd, entry_args = entry()
    out = fwd(*entry_args)
    torch.cuda.synchronize()
    check(out.device.type == "cuda" and tuple(out.shape) == (128,)
          and bool(out.all()), "entry()'s forward accepts its batch on "
          "the card")
    log("entry(): forward of %d signatures on %s, all accepted"
        % (out.shape[0], out.device))

    # --- the main path ----------------------------------------------------
    K.flush_verify_cache()
    v = BV.make_verifier("cuda")
    E.LAUNCHES = 0
    t0 = time.perf_counter()
    got = v.prewarm_many(drain)
    drain_s = time.perf_counter() - t0
    check(got == cpu_ref[:n_drain] == drain_expect,
          "drain decisions == C verifier == corruption pattern")
    drain_launches = E.LAUNCHES
    check(v.batches_dispatched == DRAIN_CHUNKS + 1 == drain_launches,
          "drain dispatched %d chunks" % (DRAIN_CHUNKS + 1))
    got2 = v.prewarm_many(drain)
    check(got2 == got, "second prewarm_many gives the same decisions")
    check(v.batches_dispatched == DRAIN_CHUNKS + 1
          and E.LAUNCHES == drain_launches,
          "second prewarm_many dispatches nothing (all cache hits)")
    log("drain: %d sigs through prewarm_many in %.3f s = %.0f sigs/s "
        "(%d launches; host prep included)"
        % (n_drain, drain_s, n_drain / drain_s, drain_launches))
    # where the drain's time goes: its layers timed alone on the same data
    t0 = time.perf_counter()
    [K._cache_key(*t) for t in drain]
    keys_s = time.perf_counter() - t0
    prep_s = 0.0
    for i in range(0, n_drain, DRAIN_CHUNK):
        chunk = drain[i:i + DRAIN_CHUNK]
        t0 = time.perf_counter()
        E.prepare_batch(*map(list, zip(*chunk)))
        prep_s += time.perf_counter() - t0
    kern_s = (DRAIN_CHUNKS * kernel_ms[DRAIN_CHUNK]
              + kernel_ms[v._bucket(DRAIN_TAIL)]) / 1e3
    log("drain layers timed alone (estimates; they need not sum to the "
        "drain): cache keys %.1f ms, host prep %.1f ms, kernel %.1f ms "
        "(CUDA events by bucket)"
        % (keys_s * 1e3, prep_s * 1e3, kern_s * 1e3))

    lat = []
    pos = 0
    for _ in range(BURSTS):
        n = int(rng.integers(BURST_MIN, BURST_MAX + 1))
        burst = burst_pool[pos:pos + n]
        want = burst_expect[pos:pos + n]
        pos += n
        futs = [v.enqueue(*t) for t in burst]
        check(v.pending() == n, "burst queued")
        t0 = time.perf_counter()
        v.flush()
        lat.append((time.perf_counter() - t0) * 1e3)
        check(all(f.done() for f in futs), "every future resolved")
        check([f.result() for f in futs] == want
              == cpu_ref[n_drain + pos - n:n_drain + pos],
              "burst decisions == C verifier")
    launches = E.LAUNCHES
    check(launches == drain_launches + BURSTS,
          "one launch per flush (%d launches)" % launches)
    check(launches > 0, "the main path launched the verify kernel")
    log("flush latency, 128 bucket, %d bursts of %d-%d: p50 %.3f ms, "
        "p99 %.3f ms (p99 of %d samples is their maximum)"
        % (BURSTS, BURST_MIN, BURST_MAX, float(np.percentile(lat, 50)),
           float(np.percentile(lat, 99)), len(lat)))
    log("main path kernel launches: ed25519_verify %d" % launches)

    # --- the drain again, from an empty cache, under the profiler ----------
    K.flush_verify_cache()
    prof = profile_drain(lambda: v.prewarm_many(drain))
    check(prof["result"] == drain_expect, "profiled drain decisions")
    if prof["device_events"]:
        log("profiled drain: %.3f ms wall, card busy %.3f ms = %.2f%% "
            "(idle %.2f%%); ed25519_verify_kernel %d launches, %.3f ms; "
            "device time by name: %s"
            % (prof["wall_ms"], prof["busy_ms"],
               100.0 * prof["busy_ms"] / prof["wall_ms"],
               100.0 - 100.0 * prof["busy_ms"] / prof["wall_ms"],
               prof["kernel_launches"], prof["kernel_ms"],
               ", ".join("%s %.3f ms" % kv for kv in prof["by_name"])))
    else:
        log("profiled drain: %.3f ms wall; the profiler recorded no device "
            "activity, so the busy share is not measured" % prof["wall_ms"])

    main_b = buckets[DRAIN_CHUNK]
    log(json.dumps({"kernels": [{
        "name": "ed25519_verify", "route": "cuda",
        "source": "stellar_core_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "stellar_core_tpu/ops/ed25519.py:328",
        "launches": launches, "max_abs_err": float(main_b["mismatches"]),
        "ms": main_b["ms"], "plain_ms": main_b["plain_ms"],
        "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
        "library_ms": None, "check": "ok",
        "buckets": {str(b): {k: r[k] for k in ("ms", "plain_ms",
                                                "bound_ms", "mismatches")}
                    for b, r in buckets.items()}}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
