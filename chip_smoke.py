#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (`stellar_core_tpu_torch`) on
one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a). It builds every kernel from the
sources in the checkout (one nvcc per source, all started together), then
drives three paths and the ledger that runs on the hash path.

The verify path (`ed25519_verify`):

1. holds the kernel against its plain PyTorch version on the card, on the
   same inputs, at every bucket of the verifier's ladder (128, 512, 2048
   and 8192; the main path launches at 128, 2048 and 8192) and at 1, 129
   and 2731 lanes (a lone signature, one past a block of 32 signatures, a
   3-member shard of 8193): the adversarial ed25519 vectors plus a seeded
   corpus in which every 7th signature is corrupted. Tolerance: none, the decisions
   must be identical (a verifier that differs on one signature forks
   consensus);
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

The verify boundary's host layers (the C host prep `native/prep.c` behind
`prepare_batch` and `prewarm_many`, the resilient and async layers), each
driven with the counts set to 0 just before it and read just after:

H1. holds the native `prepare_batch` against the numpy one
   (`prepare_batch_plain`) on the drain's chunks, the adversarial vectors
   and a batch with short, long and missing rows: `pre_ok` equal, and all
   six arrays equal on every row `pre_ok` passes (the rows it rejects
   reach no decision, and the two paths fill them differently); and
   `cache_keys_native` against `keys._cache_key` on the drain, triple for
   triple. Prints each 8,192 chunk's host ms for both preps, the native
   one split into pack, C call and recode, and the drain's cache-key ms
   in both forms, in turns;
H2. drives the checkpoint drain through `make_verifier("cuda")` with the
   native prep and, with `prepare_batch` swapped for `prepare_batch_plain`
   for the length of the drain, the numpy prep, in turns (native, numpy,
   numpy, native), each from an empty cache, then one 4-member fleet drain on cuda:0 and one profiled drain
   in each mode: every decision equal to the C verifier, the launches as
   in step 3, and in native mode one C prep per chunk staged. Prints
   sigs/s, the host-prep ms per chunk, the staging worker's time and its
   overlap with the kernel (`staging_overlap_pct`) and the card's busy
   share;
H3. runs 20 live-SCP bursts of 100-128 `enqueue`s through
   `make_verifier("cuda-async")` on a real-time `VirtualClock`, each
   flushed and cranked until every future completes: every decision
   right, one launch a burst, no failed or requeued dispatch, no drain
   verified on the CPU, the breaker closed.
   Prints the p50/p99 of `crypto.verify.latency`, of the queue wait and of
   flush to the last future;
H4. runs `make_verifier("cuda-resilient")` (no fallback) with
   `device.dispatch` firing three times: the three drains raise with no
   launch, the breaker trips (meter, a flight dump by the real
   `FlightRecorder`), a drain while it is
   open is refused (BreakerOpenError, no launch), no drain is verified on
   the CPU, and past the cooldown on a virtual clock the half-open probe
   launches the kernel once, returns the kernel's decisions and re-closes
   it.

The verify fleet (`ed25519_verify_sharded`: the verify kernel launched once
per fleet member on the member's own stream, then a gather;
parallel/mesh.py). The machine has one card, so fleets of 2, 3 and 4
members share cuda:0, each member on its own streams:

4b. holds `sharded_verify` over 2, 3 and 4 members against
   `verify_plain` over the whole batch on the card, lane for lane (on 3
   members padded to 129 and 8193 lanes, 43 and 2731 per member, as the
   verifier pads them), and against the C verifier, at 128 (the
   adversarial vectors plus corpus) and 8192; times
   the sharded launch (CUDA events behind a sleep kernel) at 8192 over 1,
   2, 3 and 4 members and at 128 over 1 and 4, and the gather's copies;
4c. drives the checkpoint drain (with the counts set to 0 just before and
   read just after) through `make_verifier("cuda")`, whose fleet is one
   member per visible card, and through `CudaSigVerifier(devices=
   ["cuda:0"] * k)` for k = 2, 3 and 4, three times each from an empty
   cache: every decision equal to the C verifier, 3·k + 1 launches per
   drain (each 8192 chunk sharded over every member, the 1,000 tail on
   one), the per-member stats adding up to the drains;
4d. trips member 0 of a 4-member fleet with the `verify.device-lost` fault
   point: the next drain runs on members 1-3 (8,193 lanes per chunk) with
   correct decisions, and the drain after the injected clock passes the
   cooldown re-closes the breaker; runs `graft_entry.dryrun_multichip(4)`
   over 4 members of cuda:0; profiles one 4-member drain for the kernels'
   device time per stream, whether launches on different streams
   overlapped, the staging overlap and the card's busy share.

The hash path (`sha256`):

5. holds the kernel against its plain version on the card at all 15
   (lanes x blocks) shapes of the hasher's ladder (256/1024/4096 x
   1/2/4/8/16): every FIPS boundary length that fits, random lengths up to
   the block bucket, and padding lanes of garbage words with count 0; at
   one lane of 1 and of 16 blocks (the chain alone); and on a real
   per-close chunk (1,000 entry leaves planned by the hasher, sorted by
   block count, and padded by the C padder over stale words). All 8
   words of every lane must be equal, and every real lane must equal
   hashlib. Tolerance: none (a digest one bit
   off forks consensus). Each shape's kernel time (CUDA events), plain
   time and single-thread hashlib time on the same batch are printed
   beside two floors: the throughput bound, and the chain floor (its
   longest lane's block count times the per-block latency of a chain, the
   slope between the 1-lane launches of 1 and 16 blocks), and which of the
   two binds;
6. drives the main path with the counts set to 0 just before and read
   just after: a deep-level entry-root drain of 2^20 bucket-entry leaves
   (protocol-13 XDR, 60 % accounts, 25 % trustlines, 10 % offers, 4 % data
   entries, 1 % accounts with 1-20 signers; testing/entries.py) through
   `make_hasher("cuda")` and `merkle_root`, every leaf and the root equal
   to hashlib's; then 20 per-close drains of 1,000 leaves through
   `entry_root`, each root equal to hashlib's, with the shapes of their
   launches and their padding printed;
7. times the drain's layers alone on the same data (leaf assembly, host
   padding, host->device, kernel, device->host, digests_to_bytes, Merkle
   interior), runs the drain once more under `torch.profiler` for the
   card's busy share, and sends messages shaped like the reference's
   mixed test batch (two oversize lengths) through `CudaBatchHasher` on the
   card, which must hash the 6 oversize ones on the host.

The hasher's operator layers (the C padder `native/sha256_pad.c` behind
`pad_chunk`, the pinned double-buffered staging, the warmup, the breaker
stack, the Tracer and FlightRecorder), each driven with the counts set to
0 just before it and read just after:

H5. holds the C padder against the numpy padding (`pad_chunk_plain`, which
   is `pad_messages_np`) on every chunk of the 2^20-leaf drain, on a
   per-close chunk and on messages of 0, 55, 56, 63, 64, 119, 120 and
   1,015 bytes, each written over stale words: the counts equal (0 on
   padding lanes) and the words equal on every real block. Prints ms per
   chunk of both forms, timed in turns;
H6. drives `make_hasher("cuda-resilient")` with a real `Tracer` and
   `FlightRecorder`: `warmup(wait=True)` (done, 3 shapes, 3 launches),
   then the 2^20-leaf entry-root drain with the C padder and, with
   `pad_chunk` swapped for `pad_chunk_plain` for the length of the drain,
   the numpy padding, in turns (C, numpy, numpy, C), then 20 per-close
   roots, each in both modes in turns, then one profiled drain per mode:
   every leaf and root equal to hashlib's, one launch per planned chunk,
   one padding per chunk staged (a C call in C mode), every drain counted
   under `bucket-entries`, none served on the CPU. Prints leaves/s, host
   padding ms per drain, `staging_overlap_pct`, the span breakdown
   (`Tracer.phase_breakdown`) and the card's busy share per mode;
H7. trips `make_hasher("cuda-resilient")` (no fallback) with
   `hash.dispatch-fail` firing three times: each drain raises with no
   launch, the breaker trips with one `hash-breaker-trip` flight dump, a
   drain while it is open is refused (BreakerOpenError), none is served
   on the CPU, and past the cooldown the half-open probe launches and
   re-closes it; then `hash.device-lost` raises from inside
   `CudaBatchHasher` with no launch.

The ledger (the port's XDR codec, bucket list and state commitment engine
over the hash path), each phase driven with the counts set to 0 just
before it and read just after:

L1. builds 2^20 live entries of the testing/entries.py mix as the port's
   `BucketEntry` objects (decoded by the port's codec), in canonical
   order without a Python sort, adopts them as the curr buckets of levels
   4-10 (most in level 10, which never spills) through a `BucketManager`
   with background merges over a temporary bucket directory, and
   restores the list with `assume_state` at a ledger that is a multiple
   of 128, as a node starts after catchup. No launch. Prints the setup s;
L2. builds a `StateCommitmentEngine` over `make_hasher("cuda-resilient")`
   with a real `Tracer`, `FlightRecorder`, metrics and faults, a node seed
   and network id and a checkpoint every 8 closes, and a twin engine over
   `make_hasher("cpu")` on the same list. The first `update_root` drains
   every entry through the card: its root == the twin's ==
   `from_scratch_root`, one launch per planned chunk, every drain counted
   under `bucket-entries`, none served on the CPU. Prints its ms, then
   the card's busy share from a second, profiled first update;
L3. 64 closes of 1,000 changed entries each (850 updates, 100 inits, 50
   deads: an assumption with no published source) through
   `BucketManager.add_batch`, the ready merges resolved and
   `snapshot_ledger` stamping a real `LedgerHeader`, then `on_close` on
   both engines: the roots equal on every close and == from_scratch_root
   on the last, the same 8 checkpoints from both, and on every close
   exactly one launch per 4,096-lane chunk of the leaves of the buckets
   new in its slots, decided from the bucket list alone (a bucket moved
   from curr to snap costs none). The closes run without the profiler.
   Prints p50/p99 of `commitment.update-ms`, the changed leaves, launches
   and shapes per close and the span breakdown; then replays the 64
   updates on L2's profiled engine (CUDA activity only) for the card's
   busy share: the same roots in the same launches;
L4. proves keys whose newest version is in level 0, in a middle level and
   in the deep bucket (which re-hashes its 2^20 entries through the card,
   as the reference does): each proof == the twin's, accepted by
   `light_client_verify` against the served checkpoint, rejected with a
   flipped entry byte, a wrong sibling in `entry_path`, another network
   id or a flipped signature byte; a deleted key gets no proof. Prints
   each proof's ms and bytes;
L5. fires `commitment.sign-fail` once over 16 more closes: that
   interval's checkpoint is skipped (the twin's is not), the meter counts
   1, the flight recorder dumps `checkpoint-sign-fail`, and the next
   interval emits. Times nothing.

It prints the card's name and power limit, the build time, both kernels'
ptxas reports (registers, stack frame, spills, shared memory; each from
the log of the build that made its library, marked when that build was
an earlier process's), the verify kernel's product count per verify
beside the bound's, both kernels' SASS opcode counts (cuobjdump, where
the toolkit has it) and, for the SHA-256 kernel, each warp role's loop
per block (instructions, ptxas's stall clocks, opcodes), the
kernels' times, the paths' throughput and latency, their host layers
timed alone, the profiled drains' device busy share, a
`{"kernels": [...]}` line (three entries; the sha256 entry's launches are
the hash main path's and L2-L4's, `launches_by_path`) and, last,
`{"ok": true, "device": {...}}`. Any failed check raises (exit code
1) and prints no result; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

DRAIN_CHUNK, DRAIN_CHUNKS, DRAIN_TAIL = 8192, 3, 1000
BURSTS, BURST_MIN, BURST_MAX = 20, 100, 128
CORRUPT_EVERY = 7
N_KEYS = 256
# time_cuda's sleep per timed launch: about 100 us at 2 GHz, several times
# the host's cost of one launch through a wrapper
SLEEP_CYCLES_PER_REP = 200_000

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
# The quad design (four lanes per signature) issues more products for the
# same work; the bound keeps the count above as its yardstick. Per verify,
# summed over the quad's lanes: four decompressions, -A (4 mul), 8 cached
# conversions (4 mul each), the table's 4 doublings (4 sq + 4 mul each)
# and 3 adds (8 mul each), 256 ladder doublings, 64 ladder adds, 64
# fixed-base adds, the fixed-base sum's conversion and add (12 mul), the
# compare (4 mul).
QUAD_FE_MUL = 4 * 19 + 4 + 8 * 4 + 4 * 4 + 3 * 8 + 256 * 4 + 64 * 8 \
    + 64 * 8 + 12 + 4
QUAD_FE_SQ = 4 * 255 + 4 * 4 + 256 * 4
QUAD_PRODUCTS_PER_VERIFY = 100 * QUAD_FE_MUL + 55 * QUAD_FE_SQ
# lane counts off the ladder at which phase 1 also holds the verify kernel
# against its plain version: one lane, one past a block of 32 signatures,
# and a 3-member shard of 8,193
RAGGED_LANES = (1, 129, 2731)
IN_BYTES_PER_VERIFY = 4 * (20 + 1 + 20 + 1 + 64 + 64) + 1   # inputs + out

# SHA-256: integer instructions per 64-byte block, counted from
# csrc/sha256.cu with each C operation as the one SASS instruction it can
# become (rotate = one funnel shift, three-input xor/and/or = one LOP3,
# three-term add = one IADD3). A round is 6 shifts, 4 LOP3 and 4 adds, a
# schedule step 6 shifts, 2 LOP3 and 2 adds; 64 rounds, 48 steps and 8
# final adds. The shifts and LOP3 must run on Hopper's INT32 pipe, 64 per
# clock per SM; an add may also issue as an IMAD on the FMA pipe, so the
# adds are held only by the issue rate, one warp instruction per clock per
# scheduler, 128 per clock per SM. Floor per block per SM: the larger of
# the two. Bytes per message: its real blocks (64 B each), its count (4 B)
# and its digest (32 B).
INT32_PIPE_PER_CLOCK_PER_SM = 64
ISSUE_PER_CLOCK_PER_SM = 128
PIPE_INSTR_PER_BLOCK = 64 * (6 + 4) + 48 * (6 + 2)
INSTR_PER_BLOCK = PIPE_INSTR_PER_BLOCK + 64 * 4 + 48 * 2 + 8
CLOCKS_PER_BLOCK_PER_SM = max(
    PIPE_INSTR_PER_BLOCK / INT32_PIPE_PER_CLOCK_PER_SM,
    INSTR_PER_BLOCK / ISSUE_PER_CLOCK_PER_SM)
HASH_LANES = (256, 1024, 4096)
HASH_BLOCKS = (1, 2, 4, 8, 16)
FIPS_LENS = (0, 55, 56, 63, 64, 119, 120, 1015)
DRAIN_LEAVES = 1 << 20
HASH_MAIN_SHAPE = "4096x2"     # most of the drain's chunks: 2-block leaves
CHAIN_BLOCKS = 16              # the 1-lane chain timed at 1 and 16 blocks
CLOSES, CLOSE_LEAVES = 20, 1000
# the fleet phase: drains over 2, 3 and 4 members sharing cuda:0, each
# three times from an empty cache; the sharded launch timed at these
# (bucket: member counts)
FLEET_SIZES = (2, 3, 4)
FLEET_RUNS = 3
FLEET_TIMES = {128: (1, 4), 8192: (1, 2, 3, 4)}
# the host-prep phase: the drain's prep modes in turns, and the cache-key
# forms timed this many times each, in turns
PREP_MODES = ("native", "numpy", "numpy", "native")
CACHE_KEY_REPS = 3
# the breaker phases: drains of the first DRAIN_TAIL triples (H4) or of
# CLOSE_LEAVES records (H7), the resilient layer's breaker threshold and
# cooldown (app-clock seconds)
BREAKER_THRESHOLD, BREAKER_COOLDOWN = 3, 30.0
# the hash layers' drains: the padding's modes in turns
PAD_MODES = ("c", "numpy", "numpy", "c")
# the ledger phases (L1-L5): a restored state of LEDGER_STATE live entries
# at LEDGER_START (a multiple of 128, so the 64 closes change levels 0-3
# only); the curr buckets of levels 4-9 hold DEEP_LEVEL_ENTRIES, level 10
# the rest. Each close changes LEDGER_MIX = (updates, inits, deads)
# entries, the per-close cell's 1,000 (an assumption with no published
# source, like the entries' mix); a checkpoint every CHECKPOINT_EVERY
# closes, signed for the Stellar test network's id.
LEDGER_STATE = 1 << 20
LEDGER_START = 128 * 400_000
DEEP_LEVEL_ENTRIES = {4: 256, 5: 512, 6: 1024, 7: 2048, 8: 4096, 9: 8192}
LEDGER_CLOSES = 64
LEDGER_MIX = (850, 100, 50)
LEDGER_PROTOCOL = 13
CHECKPOINT_EVERY = 8
LEDGER_NETWORK_ID = hashlib.sha256(
    b"Test SDF Network ; September 2015").digest()


def p99(samples) -> float:
    """The sample at or above the 99th percentile's rank, not an
    interpolation: with fewer than 100 samples, their maximum."""
    return float(np.percentile(samples, 99, method="higher"))


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
    """Mean device ms of fn() over reps launches, after one warm-up call.
    A sleep kernel holds the stream while the host enqueues the launches,
    so they run back to back on the card and the wrapper's host time per
    launch (tens of us, more than a small kernel takes) is not counted.
    If the card reached the start event before the host had enqueued every
    launch, the sleep is doubled and the measurement taken again."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES_PER_REP * reps
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        all_queued = not start.query()
        torch.cuda.synchronize()
        if all_queued:
            return start.elapsed_time(end) / reps
        cycles *= 2


def profile_drain(run, kernel: str, cpu: bool = True) -> dict:
    """run() under torch.profiler (CPU and CUDA activity, or CUDA alone
    when not `cpu`): its result, its host wall time, and from the trace
    the card's busy time (the union of all device activity), the launches
    and device time of the kernel whose name contains `kernel`, and the
    device time of the five largest names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=([ProfilerActivity.CPU] if cpu else [])
                 + [ProfilerActivity.CUDA]) as prof:
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
    kern = [e for e in dev if kernel in e.name]
    return {"result": result, "wall_ms": wall_ms, "device_events": len(dev),
            "busy_ms": busy_us / 1e3, "kernel_launches": len(kern),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kern) / 1e3,
            "by_name": sorted(((k[:40], us / 1e3) for k, us
                               in by_name.items()),
                              key=lambda kv: -kv[1])[:5]}


def kernel_vs_plain(E, vectors: list, corpus: list, lanes: int,
                    props, timed: bool = True) -> dict:
    """The verify kernel against verify_plain on the same CUDA tensors at
    one lane count (the adversarial vectors first, then the corpus); when
    timed, their timings and the bound."""
    import torch
    triples = ([(p, s, m) for (_l, p, s, m) in vectors] + corpus)[:lanes]
    check(len(triples) == lanes, "batch fills %d lanes" % lanes)
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
    check(mismatches == 0, "kernel == plain at %d lanes (%d lanes differ)"
          % (lanes, mismatches))
    out = {"decisions": (got.cpu().numpy() & prep["pre_ok"]).tolist(),
           "plain_ms": plain_ms, "mismatches": mismatches}
    if timed:
        out["ms"] = time_cuda(lambda: E.verify_kernel(*args),
                              reps=200 if lanes <= 512 else 20)
        out["bound_ms"], out["bound_by"] = verify_bound(lanes, props)
    return out


def ptxas_report(log_path: str, kernel: str) -> dict:
    """The `-Xptxas -v` figures of the entry function whose name contains
    `kernel`, from the build log beside its library: registers, stack
    frame, spill stores and loads, static shared memory (bytes)."""
    with open(log_path) as fh:
        text = fh.read()
    i = text.find("Compiling entry function")
    while i >= 0 and kernel not in text[i:text.find("\n", i)]:
        i = text.find("Compiling entry function", i + 1)
    check(i >= 0, "ptxas report of %s in %s" % (kernel, log_path))
    sect = text[i:]
    nxt = sect.find("Compiling entry function", 1)
    sect = sect[:nxt if nxt > 0 else len(sect)]

    def num(pattern: str) -> int:
        m = re.search(pattern, sect)
        return int(m.group(1)) if m else 0
    return {"registers": num(r"Used (\d+) registers"),
            "stack_bytes": num(r"(\d+) bytes stack frame"),
            "spill_store_bytes": num(r"(\d+) bytes spill stores"),
            "spill_load_bytes": num(r"(\d+) bytes spill loads"),
            "smem_bytes": num(r"(\d+) bytes smem")}


def verify_bound(lanes: int, props) -> tuple:
    """(bound ms, "operations" or "bytes") of verifying `lanes` signatures:
    the products over the card's IMAD rate, or the inputs, outputs and one
    parameter block over its memory rate, whichever is larger. The count
    does not depend on how the lanes are split over launches: on N cards
    each would take 1/N of it."""
    ops_s = props["sms"] * IMAD_PER_CLOCK_PER_SM * props["clock_hz"]
    param_bytes = 4 * 64 * 9 * 3 * 10 + 4 * 30
    ops_ms = PRODUCTS_PER_VERIFY * lanes / ops_s * 1e3
    bytes_ms = (IN_BYTES_PER_VERIFY * lanes + param_bytes) \
        / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def log_profile(what: str, prof: dict, kernel: str) -> None:
    if prof["device_events"]:
        log("profiled %s: %.3f ms wall, card busy %.3f ms = %.2f%% "
            "(idle %.2f%%); %s %d launches, %.3f ms; device time by name: "
            "%s" % (what, prof["wall_ms"], prof["busy_ms"],
                    100.0 * prof["busy_ms"] / prof["wall_ms"],
                    100.0 - 100.0 * prof["busy_ms"] / prof["wall_ms"],
                    kernel, prof["kernel_launches"], prof["kernel_ms"],
                    ", ".join("%s %.3f ms" % kv for kv in prof["by_name"])))
    else:
        log("profiled %s: %.3f ms wall; the profiler recorded no device "
            "activity, so the busy share is not measured"
            % (what, prof["wall_ms"]))


def hash_bound(real_blocks: int, lanes: int, props) -> tuple:
    """(bound ms, "operations" or "bytes") of one SHA-256 launch."""
    ops_ms = CLOCKS_PER_BLOCK_PER_SM * real_blocks \
        / (props["sms"] * props["clock_hz"]) * 1e3
    bytes_ms = (64 * real_blocks + 36 * lanes) / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def hashlib_leaves(records: list) -> list:
    """The oracle's entry leaves: SHA256(0x00 || record), one hashlib call
    each."""
    return [hashlib.sha256(b"\x00" + r).digest() for r in records]


def sass_opcodes(lib: str, kernel: str):
    """Opcode counts (without modifiers) of the SASS of the function whose
    name contains `kernel` in the built library, from the toolkit's
    cuobjdump; None where the toolkit has none."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, inside = Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1)] += 1
    return counts


def hash_batch(S, rng: np.random.Generator, lanes: int, blocks: int):
    """One ladder shape's batch: every FIPS boundary length that fits, then
    random lengths up to the block bucket (ragged counts), then padding
    lanes (a tenth) of garbage words with count 0. Returns (messages,
    words uint32, counts int32)."""
    n = lanes - lanes // 10
    fits = [x for x in FIPS_LENS if S.blocks_for_len(x) <= blocks]
    lens = fits + [int(x) for x in rng.integers(0, 64 * blocks - 8,
                                                n - len(fits))]
    msgs = [rng.bytes(x) for x in lens]
    words = rng.integers(0, 1 << 32, (lanes, blocks, 16),
                         dtype=np.uint64).astype(np.uint32)
    counts = np.zeros((lanes,), np.int32)
    words[:n], counts[:n] = S.pad_messages_np(msgs, blocks)
    return msgs, words, counts


def hash_case(S, msgs: list, words, counts, what: str, props) -> dict:
    """The SHA-256 kernel against hash_blocks_plain on the same CUDA
    tensors, the real lanes (the first len(msgs)) against hashlib and the
    rest against H0; their times, hashlib's, the throughput bound and the
    longest lane's clamped block count."""
    import torch
    lanes, blocks = words.shape[0], words.shape[1]
    w = torch.from_numpy(words.view(np.int32)).cuda()
    c = torch.from_numpy(counts).cuda()
    got = S.hash_blocks_kernel(w, c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = S.hash_blocks_plain(w, c)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mismatches = int((got != want).sum())
    check(mismatches == 0, "sha256 kernel == plain at %s (%d words "
          "differ)" % (what, mismatches))
    host = got.cpu().numpy().view(np.uint32)
    t0 = time.perf_counter()
    oracle = [hashlib.sha256(m).digest() for m in msgs]
    hashlib_ms = (time.perf_counter() - t0) * 1e3
    check(S.digests_to_bytes(host[:len(msgs)]) == oracle,
          "sha256 kernel == hashlib at %s" % what)
    check((host[len(msgs):] == S._H0).all(),
          "padding lanes keep H0 at %s" % what)
    ms = time_cuda(lambda: S.hash_blocks_kernel(w, c), reps=200)
    real = np.clip(counts, 0, blocks)
    bound_ms, bound_by = hash_bound(int(real.sum()), lanes, props)
    return {"ms": ms, "plain_ms": plain_ms, "hashlib_ms": hashlib_ms,
            "mismatches": mismatches, "real_blocks": int(real.sum()),
            "longest": int(real.max()), "bound_ms": bound_ms,
            "bound_by": bound_by}


def sass_loops(lib: str, kernel: str):
    """The innermost loops of at least 200 instructions in the SASS of the
    function whose name contains `kernel`: for each, its instruction count,
    the sum of the stall counts ptxas put in the instructions' control bits
    (clocks the warp waits before its next issue; waits on loads and
    barriers come on top) and its opcode counts. None where the toolkit has
    no cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    lines = subprocess.run([exe, "-sass", lib], capture_output=True,
                           text=True, timeout=120, check=True).stdout \
        .splitlines()
    ins, inside = [], False
    for i, line in enumerate(lines):
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);\s*/\* 0x[0-9a-f]+ \*/",
                     line)
        if inside and m and i + 1 < len(lines):
            hi = re.search(r"/\* (0x[0-9a-f]+) \*/", lines[i + 1])
            if hi:
                ins.append((int(m.group(1), 16), m.group(2),
                            (int(hi.group(1), 16) >> 41) & 0xF))
    at = {a: k for k, (a, _t, _s) in enumerate(ins)}
    spans = []
    for k, (a, text, _s) in enumerate(ins):
        m = re.search(r"\bBRA (?:\S+ )?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in at \
                and k - at[int(m.group(1), 16)] >= 200:
            spans.append((at[int(m.group(1), 16)], k))
    loops = []
    for lo, hi in spans:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans):
            continue
        body = ins[lo:hi + 1]
        ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
                      for _a, t, _s in body)
        loops.append({"instructions": len(body),
                      "stall_clocks": sum(s for _a, _t, s in body),
                      "ops": ops})
    return loops


def hash_drain_layers(S, hasher, records: list) -> dict:
    """The entry-leaf drain's layers timed alone on the host clock, on the
    same data, one chunk at a time as hash_many runs them (through the
    hasher's own staging buffer and stream), with a synchronise after each
    device step: ms per layer. The kernel's device time comes from the
    profiled drain."""
    import torch
    t = dict.fromkeys(("leaf assembly", "join", "plan", "host padding",
                       "host->device", "launch + kernel", "device->host",
                       "digests_to_bytes"), 0.0)
    t0 = time.perf_counter()
    msgs = [b"\x00" + r for r in records]
    t1 = time.perf_counter()
    blob, off, lens = S.join_messages(msgs)
    t2 = time.perf_counter()
    _over, chunks = hasher._route((lens + np.uint64(72)) // np.uint64(64))
    t3 = time.perf_counter()
    t["leaf assembly"] += t1 - t0
    t["join"] += t2 - t1
    t["plan"] += t3 - t2
    buf = hasher._buffers[0]
    for idx, lanes, blk in chunks:
        t0 = time.perf_counter()
        words = buf.words[:lanes * blk * 16].view(lanes, blk, 16)
        counts = buf.counts[:lanes]
        S.pad_chunk(blob, off[idx], lens[idx], words.numpy(),
                    counts.numpy())
        t1 = time.perf_counter()
        with torch.cuda.stream(hasher._copy_stream):
            w = words.to(hasher.device, non_blocking=True)
            c = counts.to(hasher.device, non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dig = S.hash_blocks_kernel(w, c)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host = dig[:len(idx)].cpu().numpy().view(np.uint32)
        t4 = time.perf_counter()
        S.digests_to_bytes(host)
        t5 = time.perf_counter()
        for k, a, b in (("host padding", t0, t1), ("host->device", t1, t2),
                        ("launch + kernel", t2, t3),
                        ("device->host", t3, t4),
                        ("digests_to_bytes", t4, t5)):
            t[k] += b - a
    return {k: v * 1e3 for k, v in t.items()}


def hash_path(torch, rng: np.random.Generator, props) -> tuple:
    """Phases 5-7 of the module docstring: the SHA-256 kernel at every
    ladder shape, the hash main path, its layers, the profiled drain and
    the oversize route. Returns (per-shape results, main-path launches,
    the drain's records, their hashlib leaves)."""
    from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
    from stellar_core_tpu_torch.ledger import state_commitment as SC
    from stellar_core_tpu_torch.ops import ed25519 as E
    from stellar_core_tpu_torch.ops import sha256 as S
    from stellar_core_tpu_torch.testing.entries import entry_records

    # --- the SHA-256 kernel against its plain version --------------------
    S.hash_blocks_plain(torch.zeros((8, 1, 16), dtype=torch.int32).cuda(),
                        torch.ones(8, dtype=torch.int32).cuda())
    # the chain alone: one lane of 1 and of CHAIN_BLOCKS blocks; the slope
    # is the latency of one compression in a chain
    shapes = {}
    for blk in (1, CHAIN_BLOCKS):
        msg = rng.bytes(64 * blk - 9)
        words, counts = S.pad_messages_np([msg], blk)
        shapes["1x%d" % blk] = hash_case(S, [msg], words, counts,
                                         "1x%d" % blk, props)
    block_ms = (shapes["1x%d" % CHAIN_BLOCKS]["ms"] - shapes["1x1"]["ms"]) \
        / (CHAIN_BLOCKS - 1)
    log("sha256 chain: one lane of 1 / %d blocks %.5f / %.5f ms: %.5f ms "
        "per block in a chain"
        % (CHAIN_BLOCKS, shapes["1x1"]["ms"],
           shapes["1x%d" % CHAIN_BLOCKS]["ms"], block_ms))
    for lanes in HASH_LANES:
        for blk in HASH_BLOCKS:
            key = "%dx%d" % (lanes, blk)
            shapes[key] = hash_case(S, *hash_batch(S, rng, lanes, blk), key,
                                    props)
    # a real per-close chunk: 1,000 entry leaves, planned and staged as
    # the hasher's per-close drain stages them (sorted by block count)
    stager = make_hasher("cuda")
    close = [b"\x00" + r for r in entry_records(rng, CLOSE_LEAVES)]
    _over, chunks = stager.plan([S.blocks_for_len(len(m)) for m in close])
    check(len(chunks) == 1, "a per-close drain is one chunk")
    idx, lanes, blk = chunks[0]
    # padded as the hasher stages it: the C padder writes real blocks over
    # stale words, which neither version of the kernel may read
    words = rng.integers(0, 1 << 32, (lanes, blk, 16),
                         dtype=np.uint64).astype(np.uint32)
    counts = np.empty((lanes,), np.int32)
    S.pad_chunk(*S.join_messages([close[i] for i in idx]),
                words.view(np.int32), counts)
    key = "per-close %dx%d" % (lanes, blk)
    shapes[key] = hash_case(S, [close[i] for i in idx], words, counts, key,
                            props)
    for key, r in shapes.items():
        r["chain_floor_ms"] = r["longest"] * block_ms
        log("kernel sha256 %s: %.5f ms (%.1f blocks/us), plain %.1f ms, "
            "hashlib (one thread) %.3f ms; throughput bound %.5f ms (%s), "
            "chain floor %.5f ms (%d blocks x %.5f ms): the %s binds; "
            "mismatches %d"
            % (key, r["ms"], r["real_blocks"] / r["ms"] / 1e3,
               r["plain_ms"], r["hashlib_ms"], r["bound_ms"], r["bound_by"],
               r["chain_floor_ms"], r["longest"], block_ms,
               "chain" if r["chain_floor_ms"] >= r["bound_ms"]
               else "throughput", r["mismatches"]))

    # --- the hash path: a deep-level entry-root drain, then per-close ------
    t0 = time.perf_counter()
    records = entry_records(rng, DRAIN_LEAVES)
    log("data: %d bucket-entry records (%d bytes) in %.1f s"
        % (len(records), sum(map(len, records)), time.perf_counter() - t0))
    t0 = time.perf_counter()
    want_leaves = hashlib_leaves(records)
    hashlib_s = time.perf_counter() - t0
    want_root = SC.merkle_root(want_leaves)
    log("hashlib (one thread): %d leaves in %.3f s = %.0f leaves/s"
        % (len(records), hashlib_s, len(records) / hashlib_s))
    hasher = make_hasher("cuda")
    E.LAUNCHES = S.LAUNCHES = 0
    t0 = time.perf_counter()
    leaves = SC.entry_leaves(records, hasher)
    t1 = time.perf_counter()
    root = SC.merkle_root(leaves)
    t2 = time.perf_counter()
    drain_launches = S.LAUNCHES
    check(leaves == want_leaves, "every drain leaf == hashlib")
    check(root == want_root, "drain root == the all-hashlib root")
    check(hasher.oversize_msgs == 0, "no oversize entry in the drain")
    check(drain_launches == hasher.batches
          >= DRAIN_LEAVES // hasher.LANE_BUCKETS[-1],
          "drain launched %d chunks" % drain_launches)
    check(E.LAUNCHES == 0, "the hash path launched no verify kernel")
    log("entry-root drain: %d leaves in %.3f s = %.0f leaves/s (hash_many "
        "%.3f s, Merkle interior %.3f s); %d launches, %d real blocks, "
        "%d pad blocks, %d oversize"
        % (len(records), t2 - t0, len(records) / (t2 - t0), t1 - t0,
           t2 - t1, drain_launches, hasher.real_blocks, hasher.pad_blocks,
           hasher.oversize_msgs))
    _over, chunks = hasher.plan([S.blocks_for_len(1 + len(r))
                                 for r in records])
    log("drain launch shapes (lanes x blocks): %s"
        % ", ".join("%s x%d" % kv for kv in sorted(Counter(
            "%dx%d" % (lanes, blk) for _i, lanes, blk in chunks).items())))
    lat, close_shapes = [], Counter()
    real0, pad0 = hasher.real_blocks, hasher.pad_blocks
    for _ in range(CLOSES):
        batch = entry_records(rng, CLOSE_LEAVES)
        want = SC.merkle_root(hashlib_leaves(batch))
        t0 = time.perf_counter()
        got = SC.entry_root(batch, hasher)
        lat.append((time.perf_counter() - t0) * 1e3)
        check(got == want, "per-close entry root == hashlib")
        _over, chunks = hasher.plan([S.blocks_for_len(1 + len(r))
                                     for r in batch])
        close_shapes.update("%dx%d" % (lanes, blk)
                            for _i, lanes, blk in chunks)
    hash_launches = S.LAUNCHES
    check(hash_launches == drain_launches + CLOSES,
          "one launch per per-close drain (%d launches)" % hash_launches)
    check(E.LAUNCHES == 0, "the hash path launched no verify kernel")
    log("per-close entry_root, %d drains of %d leaves: p50 %.3f ms, "
        "p99 %.3f ms (p99 of %d samples is their maximum)"
        % (CLOSES, CLOSE_LEAVES, float(np.percentile(lat, 50)),
           p99(lat), len(lat)))
    real = hasher.real_blocks - real0
    pad = hasher.pad_blocks - pad0
    log("per-close launch shapes (lanes x blocks): %s; %d real blocks, "
        "%d pad blocks (%.1f %% of those shipped)"
        % (", ".join("%s x%d" % kv for kv in sorted(close_shapes.items())),
           real, pad, 100.0 * pad / (real + pad)))
    log("main path kernel launches: sha256 %d" % hash_launches)

    # --- where the drain's time goes; the profiled drain; oversize --------
    t0 = time.perf_counter()
    SC.merkle_root(leaves)
    merkle_ms = (time.perf_counter() - t0) * 1e3
    layers = hash_drain_layers(S, hasher, records)
    log("drain layers timed alone (they need not sum to the drain): %s, "
        "Merkle interior %.1f ms"
        % (", ".join("%s %.1f ms" % kv for kv in layers.items()),
           merkle_ms))
    prof = profile_drain(lambda: SC.entry_root(records, hasher),
                         "sha256_blocks_kernel")
    check(prof["result"] == want_root, "profiled drain root")
    log_profile("entry-root drain", prof, "sha256_blocks_kernel")
    mixed = [rng.bytes(n) for n in
             (0, 3, 40, 64, 119, 300, 900, 1015, 1016, 2048)] * 3
    h2 = make_hasher("cuda")
    check(h2.hash_many(mixed, site="bench") == S.sha256_batch_host(mixed),
          "mixed batch with oversize messages == hashlib")
    check(h2.oversize_msgs == 6 and h2.batches == 1,
          "6 oversize messages hashed on the host, one launch")
    log("mixed batch: %d messages, %d oversize on the host, %d launch"
        % (len(mixed), h2.oversize_msgs, h2.batches))

    return shapes, hash_launches, records, want_leaves


def time_sharded(M, fleet, arrays, reps: int) -> float:
    """Mean device ms of one sharded launch (each member's kernel on its
    own stream, on its lanes) over reps, as time_cuda measures: a sleep
    kernel holds the current stream, every member's stream waits for the
    start event, and the end event waits for every member's stream."""
    import torch
    shards = M.place_shards(fleet, arrays)
    M.launch_shards(*shards).gather()
    cur = torch.cuda.current_stream()
    cycles = SLEEP_CYCLES_PER_REP * reps * len(fleet)
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record(cur)
        for m in fleet:
            m.stream.wait_event(start)
        for _ in range(reps):
            M.launch_shards(*shards)
        for m in fleet:
            cur.wait_stream(m.stream)
        end.record(cur)
        all_queued = not start.query()
        torch.cuda.synchronize()
        if all_queued:
            return start.elapsed_time(end) / reps
        cycles *= 2


def time_gather(M, fleet, arrays, reps: int) -> float:
    """Mean device ms of the gather alone: one device->host copy per
    member, on its stream, into one pinned buffer (timed as
    time_sharded times the launches)."""
    import torch
    outs = M.launch_shards(*M.place_shards(fleet, arrays)).outs
    torch.cuda.synchronize()
    host = torch.empty(sum(o.shape[0] for o in outs), dtype=torch.bool,
                       pin_memory=True)
    cur = torch.cuda.current_stream()
    cycles = SLEEP_CYCLES_PER_REP * reps
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record(cur)
        for m in fleet:
            m.stream.wait_event(start)
        for _ in range(reps):
            off = 0
            for m, o in zip(fleet, outs):
                with torch.cuda.stream(m.stream):
                    host[off:off + o.shape[0]].copy_(o, non_blocking=True)
                off += o.shape[0]
        for m in fleet:
            cur.wait_stream(m.stream)
        end.record(cur)
        all_queued = not start.query()
        torch.cuda.synchronize()
        if all_queued:
            return start.elapsed_time(end) / reps
        cycles *= 2


def sharded_vs_plain(E, M, K, vectors, corpus, bucket: int, props) -> dict:
    """sharded_verify over 2, 3 and 4 members of cuda:0 against
    verify_plain over the whole batch on the card, lane for lane (padding
    lanes included: on 3 members the batch is padded to the next multiple
    of 3, 129 or 8193, as the verifier's route pads it), and its real
    lanes against the C verifier; then the sharded launch's device time
    over each member count of FLEET_TIMES, and the gather's."""
    import torch
    triples = ([(p, s, m) for (_l, p, s, m) in vectors] +
               corpus[:bucket - len(vectors)])
    prep = E.prepare_batch(*map(list, zip(*triples)))
    arrays = [prep[k] for k in E.ARG_KEYS]
    dev_args = tuple(torch.from_numpy(a).cuda() for a in arrays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = E.verify_plain(*dev_args).cpu()
    plain_ms = (time.perf_counter() - t0) * 1e3
    c_ref = K.raw_verify_batch(triples)
    wants = {bucket: want}
    mismatches = 0
    for k in FLEET_SIZES:
        lanes = -(-bucket // k) * k
        padded = M.pad_batch_to(prep, lanes)
        pa = [padded[a] for a in E.ARG_KEYS]
        if lanes not in wants:
            wants[lanes] = E.verify_plain(
                *(torch.from_numpy(a).cuda() for a in pa)).cpu()
        got = M.sharded_verify(M.make_fleet(["cuda:0"] * k))(*pa)
        mismatches += int((got != wants[lanes]).sum())
        check(torch.equal(got, wants[lanes]), "sharded_verify over %d "
              "members == verify_plain at %d lanes" % (k, lanes))
        check((got[:bucket].numpy() & prep["pre_ok"]).tolist() == c_ref,
              "sharded_verify over %d members == C verifier at %d"
              % (k, bucket))
    ms = {}
    for k in FLEET_TIMES[bucket]:
        lanes = -(-bucket // k) * k
        padded = M.pad_batch_to(prep, lanes)
        ms[k] = time_sharded(M, M.make_fleet(["cuda:0"] * k),
                             [padded[a] for a in E.ARG_KEYS],
                             reps=100 if bucket <= 512 else 10)
    gather_ms = time_gather(M, M.make_fleet(["cuda:0"] * 4), arrays,
                            reps=100)
    bound_ms, bound_by = verify_bound(bucket, props)
    return {"ms": ms, "gather_ms": gather_ms, "plain_ms": plain_ms,
            "mismatches": mismatches, "bound_ms": bound_ms,
            "bound_by": bound_by}


def fleet_drain(BV, K, E, v, drain: list, cpu_ref: list, what: str) -> float:
    """One checkpoint drain from an empty cache through v.prewarm_many:
    every decision == the C verifier, 3·k + 1 launches on a fleet of k
    (each 8192 chunk sharded over every member, the tail on one). Returns
    the drain's seconds."""
    K.flush_verify_cache()
    k = len(v._members)
    before = E.LAUNCHES
    t0 = time.perf_counter()
    got = v.prewarm_many(drain)
    dt = time.perf_counter() - t0
    check(got == cpu_ref, "%s drain decisions == C verifier" % what)
    check(E.LAUNCHES - before == DRAIN_CHUNKS * k + 1,
          "%s drain launched %d kernels (want %d)"
          % (what, E.LAUNCHES - before, DRAIN_CHUNKS * k + 1))
    return dt


def union_ms(intervals) -> float:
    """ms covered by the union of (start us, end us) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def trace_streams(prof_run, kernel: str) -> dict:
    """prof_run() under torch.profiler, its Chrome trace read back: the
    kernel's device ms per stream, whether launches on different streams
    overlapped on the card, and the card's busy ms (union of kernels and
    copies) against the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = prof_run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from stellar_core_tpu_torch import _build
    path = os.path.join(_build.BUILD_DIR, "fleet-drain-trace-%d.json"
                        % os.getpid())
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.unlink(path)
    evs = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                       "gpu_memset")]
    kern = [e for e in evs if e["cat"] == "kernel" and kernel in e["name"]]
    per_stream: dict = {}
    for e in kern:
        st = e.get("args", {}).get("stream", "?")
        per_stream[st] = per_stream.get(st, 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kern)
    overlapped = any(b[0] < a[1] for a, b in zip(spans, spans[1:]))
    return {"result": result, "wall_ms": wall_ms, "launches": len(kern),
            "spans": spans,
            "per_stream_ms": per_stream, "overlapped": overlapped,
            "kernel_union_ms": union_ms(spans),
            "kernel_sum_ms": sum(per_stream.values()),
            "busy_ms": union_ms([(e["ts"], e["ts"] + e["dur"])
                                 for e in evs]),
            "device_events": len(evs)}


class _Clock:
    """An injected app clock: the breakers read `now`."""

    def __init__(self) -> None:
        self.t = 1000.0

    def now(self) -> float:
        return self.t


def fleet_path(torch, vectors: list, corpus: list, drain: list,
               cpu_ref: list, props) -> dict:
    """Phase 4b of the module docstring: the sharded verify against its
    plain version and timed, the checkpoint drain over the real fleet and
    over 2, 3 and 4 members of cuda:0, a member's breaker tripped and
    recovered, the multi-device dry run, one profiled 4-member drain.
    Returns the numbers for the kernels line."""
    from stellar_core_tpu_torch import graft_entry
    from stellar_core_tpu_torch.crypto import batch_verifier as BV
    from stellar_core_tpu_torch.crypto import keys as K
    from stellar_core_tpu_torch.ops import ed25519 as E
    from stellar_core_tpu_torch.ops import sha256 as S
    from stellar_core_tpu_torch.parallel import mesh as M
    from stellar_core_tpu_torch.util.faults import FaultInjector

    # --- the sharded verify against verify_plain, and its times ----------
    shard = {}
    for b in sorted(FLEET_TIMES):
        r = sharded_vs_plain(E, M, K, vectors, corpus, b, props)
        shard[b] = r
        log("sharded ed25519_verify at %d on cuda:0: %s; gather (4 "
            "members) %.4f ms; plain (whole batch) %.1f ms; bound %.4f ms "
            "(%s; on N cards 1/N of it); mismatches %d"
            % (b, ", ".join("%d member%s %.4f ms" % (k, "s"[:k > 1], t)
                            for k, t in r["ms"].items()),
               r["gather_ms"], r["plain_ms"], r["bound_ms"], r["bound_by"],
               r["mismatches"]))

    # --- the main path: the checkpoint drain over each fleet -------------
    n_drain = len(drain)
    E.LAUNCHES = S.LAUNCHES = 0
    real = BV.make_verifier("cuda")
    check(len(real._members) == torch.cuda.device_count(),
          "make_verifier('cuda') builds one member per visible card")
    secs = {"real": [fleet_drain(BV, K, E, real, drain, cpu_ref,
                                 "real fleet") for _ in range(FLEET_RUNS)]}
    for k in FLEET_SIZES:
        v = BV.CudaSigVerifier(devices=["cuda:0"] * k)
        v.stats = BV.VerifierStats()
        secs[k] = [fleet_drain(BV, K, E, v, drain, cpu_ref,
                               "%d-member" % k) for _ in range(FLEET_RUNS)]
        rows = v.stats.to_json()["devices"]
        check(sorted(rows) == [str(i) for i in range(k)],
              "every member of %d served the drain" % k)
        shipped = FLEET_RUNS * (
            DRAIN_CHUNKS * -(-DRAIN_CHUNK // k) * k + v._bucket(DRAIN_TAIL))
        check(sum(r["sigs"] for r in rows.values()) == FLEET_RUNS * n_drain
              and sum(r["sigs"] + r["pad_total"] for r in rows.values())
              == shipped, "%d members' stats add up to the drains" % k)
        log("fleet of %d on cuda:0: per-member sigs %s, pad %s; staging "
            "overlap %s %%"
            % (k, [rows[str(i)]["sigs"] for i in range(k)],
               [rows[str(i)]["pad_total"] for i in range(k)],
               v.stats.to_json()["staging"]["last_overlap_pct"]))
    launches = E.LAUNCHES
    check(S.LAUNCHES == 0, "the fleet path launched no hash kernel")
    check(launches == FLEET_RUNS * sum(DRAIN_CHUNKS * k + 1 for k in
                                       (len(real._members),) + FLEET_SIZES),
          "fleet path launches (%d)" % launches)
    for key, ss in secs.items():
        log("checkpoint drain, %s: %s s = %s sigs/s"
            % ("make_verifier('cuda') fleet of %d" % len(real._members)
               if key == "real" else "%d members of cuda:0" % key,
               " / ".join("%.3f" % x for x in ss),
               " / ".join("%.0f" % (n_drain / x) for x in ss)))
    log("fleet path kernel launches: ed25519_verify %d" % launches)

    # --- a member's breaker: tripped, then recovered ----------------------
    clock = _Clock()
    faults = FaultInjector(seed=7)
    v = BV.CudaSigVerifier(devices=["cuda:0"] * 4, now_fn=clock.now,
                           device_breaker_threshold=2,
                           device_breaker_cooldown=30.0)
    v.faults = faults
    v.stats = BV.VerifierStats(now_fn=clock.now)
    faults.configure("verify.device-lost", count=2)
    K.flush_verify_cache()
    check(v.prewarm_many(drain) == cpu_ref, "drain with member 0 lost")
    br = v.fleet_health.breakers[0]
    check(br.state == "open" and br.trips == 1, "member 0's breaker open")
    rows0 = v.stats.to_json()["devices"]
    before = E.LAUNCHES
    K.flush_verify_cache()
    check(v.prewarm_many(drain) == cpu_ref,
          "drain on members 1-3 == C verifier")
    check(E.LAUNCHES - before == DRAIN_CHUNKS * 3 + 1,
          "degraded drain: 3 launches per chunk + 1")
    rows1 = v.stats.to_json()["devices"]
    check(rows1.get("0") == rows0.get("0"),
          "member 0 served nothing while open")
    lanes = -(-DRAIN_CHUNK // 3) * 3
    check(all(rows1[str(i)]["sigs"] + rows1[str(i)]["pad_total"]
              - rows0[str(i)]["sigs"] - rows0[str(i)]["pad_total"]
              == DRAIN_CHUNKS * lanes // 3
              + (v._bucket(DRAIN_TAIL) if i == 1 else 0)
              for i in (1, 2, 3)),
          "members 1-3 took %d lanes per chunk" % lanes)
    check((1, 2, 3) in v._mesh_fns, "the 3-member membership was used")
    clock.t += 31.0
    K.flush_verify_cache()
    check(v.prewarm_many(drain) == cpu_ref, "drain after the cooldown")
    check(br.state == "closed" and br.recoveries == 1,
          "member 0's breaker re-closed")
    log("breaker: member 0 tripped by verify.device-lost (2 fires), the "
        "next drain ran on members 1-3 at %d lanes per chunk, and the "
        "drain after the 30 s cooldown re-closed it (breaker JSON %s)"
        % (lanes, json.dumps(br.to_json())))

    # --- the multi-device dry run ------------------------------------------
    graft_entry.dryrun_multichip(4, devices=["cuda:0"] * 4)

    # --- one 4-member drain under the profiler -----------------------------
    v4 = BV.CudaSigVerifier(devices=["cuda:0"] * 4)
    v4.stats = BV.VerifierStats()
    K.flush_verify_cache()
    prof = trace_streams(lambda: v4.prewarm_many(drain),
                         "ed25519_verify_kernel")
    check(prof["result"] == cpu_ref, "profiled 4-member drain decisions")
    overlap = v4.stats.to_json()["staging"]["last_overlap_pct"]
    if prof["device_events"]:
        log("profiled 4-member drain: %.3f ms wall, card busy %.3f ms = "
            "%.2f %%; %d kernel launches, device ms per stream %s; kernel "
            "sum %.3f ms, union %.3f ms: launches on different streams %s; "
            "staging overlap %s %%"
            % (prof["wall_ms"], prof["busy_ms"],
               100.0 * prof["busy_ms"] / prof["wall_ms"], prof["launches"],
               {k: round(x, 3) for k, x in prof["per_stream_ms"].items()},
               prof["kernel_sum_ms"], prof["kernel_union_ms"],
               "overlapped" if prof["overlapped"] else "did not overlap",
               overlap))
    else:
        log("profiled 4-member drain: %.3f ms wall; the profiler recorded "
            "no device activity (not measured); staging overlap %s %%"
            % (prof["wall_ms"], overlap))
    # the same chunks one verify_many each: no staging worker runs beside
    # the dispatch thread, so nothing competes with it for the
    # interpreter between the members' launches
    K.flush_verify_cache()
    alone = trace_streams(
        lambda: sum((v4.verify_many(drain[i:i + DRAIN_CHUNK]) for i in
                     range(0, DRAIN_CHUNKS * DRAIN_CHUNK, DRAIN_CHUNK)), []),
        "ed25519_verify_kernel")
    check(alone["result"] == cpu_ref[:DRAIN_CHUNKS * DRAIN_CHUNK],
          "profiled chunks-alone decisions")
    for what, p in (("in the drain", prof), ("each alone", alone)):
        groups = [p["spans"][i:i + 4] for i in
                  range(0, 4 * DRAIN_CHUNKS, 4)]
        if p["launches"] < 4 * DRAIN_CHUNKS:
            log("8192 chunks over 4 members, %s: the profiler recorded %d "
                "kernels (%d device events); stagger not measured"
                % (what, p["launches"], p["device_events"]))
            continue
        log("8192 chunks over 4 members, %s: first to last member's kernel "
            "start %s ms, the chunk's kernels spread over %s ms of the card"
            % (what, " / ".join("%.3f" % ((g[-1][0] - g[0][0]) / 1e3)
                                for g in groups),
               " / ".join("%.3f" % union_ms(g) for g in groups)))
    return {"shard": shard, "launches": launches}


# --- the verify boundary's host layers (C host prep, async, breaker) -------


class TimedSwap:
    """Swaps `module.<name>` for a timed wrapper for the length of a
    `with`: the seconds of every call, on whichever thread (the dispatch
    thread stages a drain's first chunk, the staging worker the rest).
    With `plain`, the wrapper calls `module.<name>_plain` instead, so the
    drain runs on the numpy path (`prepare_batch_plain`,
    `pad_chunk_plain`)."""

    def __init__(self, module, name: str, plain: bool = False) -> None:
        import threading
        self.module = module
        self.name = name
        self.plain = plain
        self.secs: list = []
        self._lock = threading.Lock()

    def __enter__(self) -> "TimedSwap":
        self._orig = getattr(self.module, self.name)
        fn = getattr(self.module, self.name + "_plain") if self.plain \
            else self._orig

        def timed(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                with self._lock:
                    self.secs.append(time.perf_counter() - t0)

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self._orig)


def prep_both(E, cols: list) -> tuple:
    """(numpy prep, native prep) of one batch: prepare_batch_plain and
    prepare_batch."""
    return E.prepare_batch_plain(*cols), E.prepare_batch(*cols)


def check_prep_equal(E, ref: dict, nat: dict, what: str) -> int:
    """pre_ok equal, and all six arrays equal on every row pre_ok passes
    (the rows it rejects reach no decision; the two paths fill them
    differently). Returns the deciding rows."""
    check(bool((ref["pre_ok"] == nat["pre_ok"]).all()),
          "native pre_ok == numpy pre_ok (%s)" % what)
    mask = ref["pre_ok"]
    for k in E.ARG_KEYS:
        check(nat[k].dtype == ref[k].dtype and nat[k].shape == ref[k].shape
              and bool((nat[k][mask] == ref[k][mask]).all()),
              "native %s == numpy %s on every deciding row (%s)"
              % (k, k, what))
    return int(mask.sum())


def host_prep_phase(E, K, native, drain: list, vectors: list) -> dict:
    """The native prep against the numpy prep on the drain (chunk by
    chunk, as the drain stages it), the adversarial vectors and a batch
    with short, long and missing rows; the drain's cache keys in both
    forms; per 8,192-chunk host ms of both preps, the native one split
    into pack, C call and recode."""
    check(native.prep_lib() is not None, "the C host prep builds")
    calls0 = native.PREP_CALLS
    rows = {"drain": 0}
    chunks = [drain[i:i + DRAIN_CHUNK]
              for i in range(0, len(drain), DRAIN_CHUNK)]
    for chunk in chunks:
        rows["drain"] += check_prep_equal(
            E, *prep_both(E, list(map(list, zip(*chunk)))), "drain")
    vec_cols = [list(c) for c in zip(*[(p, s, m)
                                        for (_l, p, s, m) in vectors])]
    rows["vectors"] = check_prep_equal(E, *prep_both(E, vec_cols),
                                       "adversarial vectors")
    pubs, sigs, msgs = map(list, zip(*drain[:DRAIN_TAIL]))
    pubs[3] = pubs[3][:31]                  # a short key
    pubs[4] = pubs[4] + b"\x00"             # a long key
    sigs[5] = sigs[5][:63]
    sigs[6] = sigs[6] + b"\x00"
    sigs[7] = sigs[7][:20]
    sigs = sigs[:DRAIN_TAIL - 10]            # the last 10 rows lack one
    msgs = msgs[:DRAIN_TAIL - 5]
    ref, nat = prep_both(E, [pubs, sigs, msgs])
    rows["ragged"] = check_prep_equal(E, ref, nat, "ragged rows")
    check(not nat["pre_ok"][3:8].any() and not nat["pre_ok"][-10:].any(),
          "the ragged rows are rejected")
    check(native.PREP_CALLS - calls0 == len(chunks) + 2,
          "every native prep above ran the C library")
    log("host prep: native == numpy on pre_ok and on all six arrays of "
        "every deciding row: %d of the drain's %d, %d of %d adversarial "
        "vectors, %d of %d ragged rows"
        % (rows["drain"], len(drain), rows["vectors"], len(vectors),
           rows["ragged"], DRAIN_TAIL))

    # per 8,192 chunk: numpy, and native split into its three parts
    split = {"numpy": [], "native": [], "pack": [], "c_call": [],
             "recode": []}
    for chunk in chunks[:DRAIN_CHUNKS]:
        cols = list(map(list, zip(*chunk)))
        t0 = time.perf_counter()
        E.prepare_batch_plain(*cols)
        split["numpy"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        E.prepare_batch(*cols)
        split["native"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        good, pub_arr, sig_arr, ms = E.pack_batch(*cols)
        t1 = time.perf_counter()
        prep = native.prepare_batch_native(pub_arr, sig_arr, ms)
        t2 = time.perf_counter()
        E.finish_native(prep, good)
        t3 = time.perf_counter()
        split["pack"].append(t1 - t0)
        split["c_call"].append(t2 - t1)
        split["recode"].append(t3 - t2)
    ms_of = {k: [round(x * 1e3, 3) for x in v] for k, v in split.items()}
    log("host prep per 8,192-signature chunk (ms, %d chunks of the drain): "
        "numpy %s; native %s = pack %s + C call %s + recode %s"
        % (DRAIN_CHUNKS, ms_of["numpy"], ms_of["native"], ms_of["pack"],
           ms_of["c_call"], ms_of["recode"]))

    # the drain's verify-cache keys, both forms, in turns
    want = [K._cache_key(*t) for t in drain]
    check(native.cache_keys_native(drain) == want,
          "cache_keys_native == keys._cache_key, triple for triple")
    keys_ms = {"hashlib": [], "native": []}
    for form in ("hashlib", "native", "native", "hashlib") * \
            ((CACHE_KEY_REPS + 1) // 2):
        t0 = time.perf_counter()
        if form == "native":
            native.cache_keys_native(drain)
        else:
            [K._cache_key(*t) for t in drain]
        keys_ms[form].append(round((time.perf_counter() - t0) * 1e3, 3))
    log("cache keys of the %d-triple drain (ms, in turns): hashlib loop "
        "%s, cache_keys_native %s" % (len(drain), keys_ms["hashlib"],
                                      keys_ms["native"]))
    return {"rows": rows, "chunk_ms": ms_of, "keys_ms": keys_ms}


def prep_mode_drains(BV, K, E, S, native, drain: list, cpu_ref: list) -> dict:
    """The checkpoint drain through make_verifier("cuda").prewarm_many
    on the native and the numpy prep in turns (PREP_MODES), each from an
    empty cache; then one 4-member fleet drain on cuda:0 and one profiled
    drain in each mode. Every decision == the C verifier, DRAIN_CHUNKS + 1
    launches a drain (3 * 4 + 1 on the fleet), and in native mode one C
    prep per chunk staged."""
    n = len(drain)
    E.LAUNCHES = S.LAUNCHES = native.PREP_CALLS = 0
    out: dict = {"native": [], "numpy": []}

    def one(v, mode: str, launches: int, what: str) -> dict:
        K.flush_verify_cache()
        l0, p0 = E.LAUNCHES, native.PREP_CALLS
        with TimedSwap(E, "prepare_batch", mode == "numpy") as pt:
            t0 = time.perf_counter()
            got = v.prewarm_many(drain)
            dt = time.perf_counter() - t0
        check(got == cpu_ref, "%s drain (prep %s) == C verifier"
              % (what, mode))
        check(E.LAUNCHES - l0 == launches,
              "%s drain (prep %s): %d launches" % (what, mode, launches))
        check(len(pt.secs) == DRAIN_CHUNKS + 1,
              "%s drain staged %d chunks" % (what, DRAIN_CHUNKS + 1))
        check(native.PREP_CALLS - p0 == (len(pt.secs) if mode == "native"
                                         else 0),
              "%s drain (prep %s): one C prep per chunk staged"
              % (what, mode))
        st = v.stats.to_json()["staging"]
        return {"s": dt, "sigs_per_s": n / dt,
                "prep_ms": sum(pt.secs) * 1e3,
                "prep_chunk_ms": [round(x * 1e3, 3) for x in pt.secs],
                "staged_ms": st["staged_s"] * 1e3,
                "overlap_ms": st["overlap_s"] * 1e3,
                "overlap_pct": st["last_overlap_pct"]}

    for mode in PREP_MODES:
        r = one(BV.make_verifier("cuda"), mode, DRAIN_CHUNKS + 1,
                "make_verifier('cuda')")
        out[mode].append(r)
        log("drain, prep %s: %.0f sigs/s (%.3f s); host prep %.1f ms "
            "(per chunk %s); staging worker %.1f ms, %.1f ms of it while the "
            "kernel ran: staging_overlap_pct %s"
            % (mode, r["sigs_per_s"], r["s"], r["prep_ms"], r["prep_chunk_ms"], r["staged_ms"],
               r["overlap_ms"], r["overlap_pct"]))
    for mode in ("native", "numpy"):
        v4 = BV.CudaSigVerifier(devices=["cuda:0"] * 4)
        v4.stats = BV.VerifierStats()
        r = one(v4, mode, DRAIN_CHUNKS * 4 + 1, "4-member")
        out["fleet4_" + mode] = r
        log("4-member fleet drain on cuda:0, prep %s: %.0f sigs/s; host "
            "prep %.1f ms; staging_overlap_pct %s"
            % (mode, r["sigs_per_s"], r["prep_ms"], r["overlap_pct"]))
    for mode in ("native", "numpy"):
        K.flush_verify_cache()
        v = BV.make_verifier("cuda")
        with TimedSwap(E, "prepare_batch", mode == "numpy"):
            prof = profile_drain(lambda: v.prewarm_many(drain),
                                 "ed25519_verify_kernel")
        check(prof["result"] == cpu_ref,
              "profiled drain (prep %s) decisions" % mode)
        log_profile("drain, prep %s" % mode, prof, "ed25519_verify_kernel")
        out["prof_" + mode] = prof
    check(S.LAUNCHES == 0, "the prep-mode drains launched no hash kernel")
    log("prep-mode drains: ed25519_verify %d launches, native prep %d "
        "calls" % (E.LAUNCHES, native.PREP_CALLS))
    return out


def async_scp_phase(BV, K, E, S, rng, pool: list, want: list) -> dict:
    """20 bursts of 100-128 enqueues through make_verifier("cuda-async")
    on a real-time VirtualClock, each flushed and cranked (`crank(True)`,
    the node's loop) until every future completes: one launch a burst,
    every decision right, none verified on the CPU, no failed or requeued
    dispatch, the breaker closed."""
    from stellar_core_tpu_torch.util.metrics import Histogram, MetricsRegistry
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    K.flush_verify_cache()
    clock = VirtualClock(ClockMode.REAL_TIME)
    reg = MetricsRegistry(now_fn=clock.now)
    v = BV.make_verifier("cuda-async", clock=clock, metrics=reg)
    E.LAUNCHES = S.LAUNCHES = 0
    walls = []
    pos = 0
    for _ in range(BURSTS):
        n = int(rng.integers(BURST_MIN, BURST_MAX + 1))
        burst, exp = pool[pos:pos + n], want[pos:pos + n]
        pos += n
        before = E.LAUNCHES
        futs = [v.enqueue(*t) for t in burst]
        check(v.pending() == n, "async burst queued")
        t0 = time.perf_counter()
        v.flush()
        deadline = t0 + 60.0
        while not all(f.done() for f in futs) and \
                time.perf_counter() < deadline:
            clock.crank(True)
        walls.append((time.perf_counter() - t0) * 1e3)
        check(all(f.done() for f in futs), "every async future completed")
        check([f.result() for f in futs] == exp,
              "async burst decisions == C verifier")
        check(E.LAUNCHES - before == 1, "one launch per async burst")
    m = reg.to_json()
    check("crypto.verify.dispatch-failure" not in m
          and "crypto.verify.requeued" not in m,
          "no async dispatch failed or was queued again")
    check(set(v.stats.to_json()["drains"]["by_backend"]) == {"cuda"},
          "every async burst was verified on the card")
    check(v.breaker.state == "closed", "the breaker is closed")
    check(S.LAUNCHES == 0, "the async path launched no hash kernel")
    lat, wait = m["crypto.verify.latency"], m["verifier.queue.wait"]
    log("async live SCP, %d bursts of %d-%d through make_verifier("
        "'cuda-async'): crypto.verify.latency p50 %.3f ms, p99 %.3f ms "
        "(%d verifies; the quantiles are over the timer's reservoir of the "
        "last %d); queue wait p50 %.3f ms, p99 %.3f ms (%d batches); flush "
        "to last future p50 %.3f ms, p99 %.3f ms (host clock); %d launches"
        % (BURSTS, BURST_MIN, BURST_MAX, lat["median"] * 1e3,
           lat["p99"] * 1e3, lat["count"], Histogram.MAX_SAMPLES,
           wait["median"] * 1e3, wait["p99"] * 1e3, wait["count"],
           float(np.percentile(walls, 50)), p99(walls),
           E.LAUNCHES))
    return {"latency": lat, "wait": wait, "walls": walls}


def breaker_phase(BV, K, E, S, drain: list, kernel_ref: list,
                  flight_dir: str) -> None:
    """make_verifier("cuda-resilient"), which has no fallback, with
    `device.dispatch` firing BREAKER_THRESHOLD times: those drains raise
    with no launch and trip the breaker (meter, flight dump); a drain
    while it is open is refused with no launch; no drain is verified on
    the CPU; past the cooldown on the virtual clock, the half-open probe
    launches the kernel once, returns its decisions and re-closes it. The
    flight dump goes to `flight_dir`."""
    from stellar_core_tpu_torch.util.faults import FaultInjector, InjectedFault
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    from stellar_core_tpu_torch.util.tracing import FlightRecorder, Tracer
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    reg = MetricsRegistry(now_fn=clock.now)
    rec = FlightRecorder(Tracer(), metrics=reg, out_dir=flight_dir,
                         now_fn=clock.now)
    faults = FaultInjector(seed=7, metrics=reg)
    faults.configure("device.dispatch", count=BREAKER_THRESHOLD)
    v = BV.make_verifier("cuda-resilient", clock=clock, metrics=reg,
                         faults=faults, flight_recorder=rec,
                         breaker_threshold=BREAKER_THRESHOLD,
                         breaker_cooldown=BREAKER_COOLDOWN)
    check(v.fallback is None, "the card's stack has no fallback")
    part, want = drain[:DRAIN_TAIL], kernel_ref[:DRAIN_TAIL]
    E.LAUNCHES = S.LAUNCHES = 0
    K.flush_verify_cache()

    def raises(exc_type) -> bool:
        try:
            v.prewarm_many(part)
        except exc_type:
            return True
        return False

    for _ in range(BREAKER_THRESHOLD):
        check(raises(InjectedFault), "a failed drain raises")
    check(v.breaker.state == "open" and v.breaker.trips == 1,
          "the breaker tripped")
    check(raises(BV.BreakerOpenError), "the open breaker refuses a drain")
    m = reg.to_json()
    check(E.LAUNCHES == 0, "no launch while the dispatch fails or the "
          "breaker is open")
    check(m["crypto.verify.dispatch-failure"]["count"] == BREAKER_THRESHOLD,
          "crypto.verify.dispatch-failure == %d" % BREAKER_THRESHOLD)
    check(m["crypto.verify.refused-drain"]["count"] == 1,
          "crypto.verify.refused-drain == 1")
    check(rec.dumps == 1 and "verify-breaker-trip" in rec.last_path,
          "the trip left one flight dump")
    check(v.stats.to_json()["drains"]["by_backend"] == {},
          "no drain was verified while the breaker tripped")
    clock.set_virtual_time(clock.now() + BREAKER_COOLDOWN + 1.0)
    check(v.prewarm_many(part) == want, "the probe drain's decisions")
    m = reg.to_json()
    check(E.LAUNCHES == 1, "the half-open probe launched the kernel once")
    check(v.breaker.state == "closed" and v.breaker.recoveries == 1,
          "the probe re-closed the breaker")
    check("crypto.verify.fallback-drain" not in m
          and set(v.stats.to_json()["drains"]["by_backend"]) == {"cuda"},
          "every drain was verified on the card")
    check(S.LAUNCHES == 0, "the breaker phase launched no hash kernel")
    log("breaker: make_verifier('cuda-resilient'), device.dispatch fired %d "
        "times: %d drains of %d raised with no launch, tripped "
        "(crypto.breaker.trip %d, flight dump %r), one drain refused while "
        "open, none verified on the CPU; the half-open probe after %.0f s "
        "launched the kernel once and re-closed the breaker (breaker JSON "
        "%s)"
        % (BREAKER_THRESHOLD, BREAKER_THRESHOLD, DRAIN_TAIL,
           m["crypto.breaker.trip"]["count"],
           os.path.basename(rec.last_path),
           BREAKER_COOLDOWN + 1.0, json.dumps(v.breaker.to_json())))


def real_blocks_equal(words, counts, ref_words, ref_counts) -> bool:
    """Counts equal the reference's on its lanes and 0 past them, and the
    words equal it on every real block (block i < count of its lane)."""
    n = len(ref_counts)
    if not (counts[:n] == ref_counts).all() or (counts[n:] != 0).any():
        return False
    mask = np.arange(words.shape[1])[None, :] < ref_counts[:n, None]
    return bool((words[:n][mask] == ref_words[:n][mask]).all())


def pad_phase(S, native, hasher, records: list, rng) -> dict:
    """H5: the C padder (`native.sha256_pad_native`) against the numpy
    padding (`pad_chunk_plain`, `pad_messages_np` copied into the buffer)
    on every chunk of the 2^20-leaf drain, on a per-close chunk and on
    messages of FIPS_LENS, each into a buffer of stale words: counts equal
    and words equal on every real block. Both forms are timed per chunk,
    in turns (C first on even chunks, numpy first on odd ones)."""
    from stellar_core_tpu_torch.testing.entries import entry_records
    check(native.sha256_pad_lib() is not None, "the C padder builds")
    cases = []
    for what, msgs in (
            ("drain", [b"\x00" + r for r in records]),
            ("per-close", [b"\x00" + r
                           for r in entry_records(rng, CLOSE_LEAVES)])):
        blob, off, lens = S.join_messages(msgs)
        _over, chunks = hasher._route((lens + np.uint64(72))
                                      // np.uint64(64))
        cases += [(what, blob, off[idx], lens[idx], lanes, blk)
                  for idx, lanes, blk in chunks]
    fips = [rng.bytes(x) for x in FIPS_LENS]
    cases.append(("FIPS lengths", *S.join_messages(fips), 256, 16))
    stale = np.int32(-0x5A5A5A5B)
    big = max(lanes * blk for *_x, lanes, blk in cases) * 16
    c_buf, n_buf = np.empty(big, np.int32), np.empty(big, np.int32)
    c_cnt, n_cnt = np.empty(4096, np.int32), np.empty(4096, np.int32)
    calls0 = native.PAD_CALLS
    ms: dict = {}      # (what, shape) -> {"c": [...], "numpy": [...]}
    blocks_real = 0
    for k, (what, blob, off, lens, lanes, blk) in enumerate(cases):
        cw = c_buf[:lanes * blk * 16].reshape(lanes, blk, 16)
        nw = n_buf[:lanes * blk * 16].reshape(lanes, blk, 16)
        cc, nc = c_cnt[:lanes], n_cnt[:lanes]
        cw.fill(stale)
        cc.fill(77)
        nw.fill(stale)
        nc.fill(77)
        row = ms.setdefault((what, "%dx%d" % (lanes, blk)),
                            {"c": [], "numpy": []})
        for form in (("c", "numpy") if k % 2 == 0 else ("numpy", "c")):
            t0 = time.perf_counter()
            if form == "c":
                check(native.sha256_pad_native(blob, off, lens, cw, cc),
                      "the C padder ran")
            else:
                S.pad_chunk_plain(blob, off, lens, nw, nc)
            row[form].append((time.perf_counter() - t0) * 1e3)
        check(real_blocks_equal(cw, cc, nw, nc),
              "C padder == pad_messages_np on every real block and count "
              "(%s chunk %d, %dx%d)" % (what, k, lanes, blk))
        blocks_real += int(nc.sum())
    check(native.PAD_CALLS - calls0 == len(cases),
          "every C padding above ran the C library")
    log("H5 padder: C == pad_messages_np on every real block and count of "
        "%d chunks (%d real blocks): the drain's, a per-close chunk, "
        "messages of %s bytes"
        % (len(cases), blocks_real, "/".join(map(str, FIPS_LENS))))
    for (what, shape), row in ms.items():
        log("H5 padder ms per chunk, %s %s (%d chunks, in turns): C median "
            "%.4f [%.4f-%.4f], numpy median %.3f [%.3f-%.3f]; sum C %.2f, "
            "numpy %.1f"
            % (what, shape, len(row["c"]), float(np.median(row["c"])),
               min(row["c"]), max(row["c"]), float(np.median(row["numpy"])),
               min(row["numpy"]), max(row["numpy"]), sum(row["c"]),
               sum(row["numpy"])))
    drain = [r for (what, _s), r in ms.items() if what == "drain"]
    out = {form: sum(sum(r[form]) for r in drain) for form in ("c", "numpy")}
    log("H5 padder, all %d drain chunks: C %.1f ms, numpy %.1f ms (%.1fx)"
        % (sum(len(r["c"]) for r in drain), out["c"], out["numpy"],
           out["numpy"] / out["c"]))
    return out


def phases_line(pb: dict) -> str:
    return ", ".join("%s %.1f ms (%d)" % (k, v["total_s"] * 1e3, v["count"])
                     for k, v in sorted(pb["phases"].items(),
                                        key=lambda kv: -kv[1]["total_s"]))


def hash_layer_drains(S, E, native, SC, records: list, want_leaves: list,
                      rng, flight_dir: str, card: str) -> dict:
    """H6: make_hasher("cuda-resilient") with a real Tracer and
    FlightRecorder: warmup(wait=True) (3 shapes, 3 launches), then the
    2^20-leaf entry-root drain with the C padder and with the numpy padding
    swapped in, in turns (PAD_MODES), then 20 per-close roots, each in
    both modes in turns, then one profiled drain per mode. Every leaf and
    root == hashlib, one launch per planned chunk, one pad per chunk staged
    (in C mode each a C call), every drain counted under bucket-entries,
    none served on the CPU."""
    from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
    from stellar_core_tpu_torch.testing.entries import entry_records
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.tracing import FlightRecorder, Tracer
    reg = MetricsRegistry()
    tr = Tracer()
    tr.enable()
    h = make_hasher("cuda-resilient", metrics=reg, tracer=tr,
                    flight_recorder=FlightRecorder(tr, metrics=reg,
                                                   out_dir=flight_dir))
    check(h.fallback is None, "the card's hash stack has no fallback")
    want_root = SC.merkle_root(want_leaves)
    E.LAUNCHES = S.LAUNCHES = 0
    t0 = time.perf_counter()
    h.warmup(wait=True)
    warm_s = time.perf_counter() - t0
    warm = h.stats.to_json()["warmup"]
    check(warm["state"] == "done" and len(warm["shapes"]) == 3
          and S.LAUNCHES == 3, "warmup: done, 3 shapes, 3 launches")
    log("H6 warmup: %.3f s, shapes %s" % (warm_s, json.dumps(
        {k: [v["seconds"], v["cache"]] for k, v in warm["shapes"].items()})))
    planned = len(h.inner.plan([S.blocks_for_len(1 + len(r))
                                for r in records])[1])
    out: dict = {"c": [], "numpy": []}
    for k, mode in enumerate(PAD_MODES):
        tr.clear()
        l0, p0 = S.LAUNCHES, native.PAD_CALLS
        with TimedSwap(S, "pad_chunk", mode == "numpy") as pt:
            t0 = time.perf_counter()
            leaves = SC.entry_leaves(records, h)
            t1 = time.perf_counter()
            root = SC.merkle_root(leaves)
            t2 = time.perf_counter()
        check(leaves == want_leaves, "H6 drain (%s): every leaf == hashlib"
              % mode)
        check(root == want_root, "H6 drain (%s): root == hashlib" % mode)
        check(S.LAUNCHES - l0 == planned and len(pt.secs) == planned,
              "H6 drain (%s): %d launches, one pad per chunk" % (mode,
                                                                 planned))
        check(native.PAD_CALLS - p0 == (planned if mode == "c" else 0),
              "H6 drain (%s): one C padding per chunk in C mode" % mode)
        check(h.stats.to_json()["sites"]["bucket-entries"]["drains"]
              == k + 1, "bucket-entries counts each drain")
        span = [sp for sp in tr.spans() if sp.name == "crypto.hash_many"][-1]
        pb = tr.phase_breakdown(wall_s=t2 - t0)
        r = {"leaves_per_s": len(records) / (t2 - t0), "s": t2 - t0,
             "hash_many_s": t1 - t0, "merkle_s": t2 - t1,
             "pad_ms": sum(pt.secs) * 1e3,
             "overlap_pct": span.tags.get("staging_overlap_pct"),
             "phases": pb}
        out[mode].append(r)
        log("H6 drain, padding %s (%s): %.0f leaves/s (%.3f s: hash_many "
            "%.3f, Merkle %.3f); host padding %.1f ms over %d chunks; "
            "staging_overlap_pct %s; spans: %s"
            % (mode, card, r["leaves_per_s"], r["s"], r["hash_many_s"],
               r["merkle_s"], r["pad_ms"], planned, r["overlap_pct"],
               phases_line(pb)))
    backends = h.stats.to_json()["drains"]["by_backend"]
    check(set(backends) == {"cuda"}, "no H6 drain was served on the CPU")
    check(S.LAUNCHES == 3 + len(PAD_MODES) * planned,
          "launches == planned chunks + 3 for the warmup")
    lat: dict = {"c": [], "numpy": [], "c_pad": [], "numpy_pad": []}
    for i in range(CLOSES):
        batch = entry_records(rng, CLOSE_LEAVES)
        want = SC.merkle_root(hashlib_leaves(batch))
        n_chunks = len(h.inner.plan([S.blocks_for_len(1 + len(r))
                                     for r in batch])[1])
        for mode in (("c", "numpy") if i % 2 == 0 else ("numpy", "c")):
            l0 = S.LAUNCHES
            with TimedSwap(S, "pad_chunk", mode == "numpy") as pt:
                t0 = time.perf_counter()
                got = SC.entry_root(batch, h)
                lat[mode].append((time.perf_counter() - t0) * 1e3)
            lat[mode + "_pad"].append(sum(pt.secs) * 1e3)
            check(got == want and S.LAUNCHES - l0 == n_chunks,
                  "H6 per-close root (%s) == hashlib, one launch per "
                  "planned chunk" % mode)
    for mode in ("c", "numpy"):
        log("H6 per-close entry_root, padding %s, %d drains of %d leaves "
            "(%s): p50 %.3f ms, p99 %.3f ms; host padding p50 %.3f ms"
            % (mode, CLOSES, CLOSE_LEAVES, card,
               float(np.percentile(lat[mode], 50)),
               p99(lat[mode]),
               float(np.percentile(lat[mode + "_pad"], 50))))
    for mode in ("c", "numpy"):
        with TimedSwap(S, "pad_chunk", mode == "numpy"):
            prof = profile_drain(lambda: SC.entry_root(records, h),
                                 "sha256_blocks_kernel")
        check(prof["result"] == want_root, "H6 profiled drain root (%s)"
              % mode)
        log_profile("H6 drain, padding %s" % mode, prof,
                    "sha256_blocks_kernel")
        out["prof_" + mode] = prof
    j = h.stats.to_json()
    check(set(j["drains"]["by_backend"]) == {"cuda"}
          and j["sites"]["bucket-entries"]["drains"]
          == len(PAD_MODES) + 2 * CLOSES + 2,
          "every H6 drain on the card, counted under bucket-entries")
    check(E.LAUNCHES == 0, "the hash layers launched no verify kernel")
    log("H6 stats: staging %s, by_backend %s"
        % (json.dumps(j["staging"]), json.dumps(j["drains"]["by_backend"])))
    out["closes"] = lat
    return out


def hash_breaker_phase(S, E, SC, rng, flight_dir: str) -> None:
    """H7: make_hasher("cuda-resilient") (no fallback) with
    `hash.dispatch-fail` firing BREAKER_THRESHOLD times: those drains raise
    with no launch, the breaker trips (meter, one `hash-breaker-trip`
    flight dump), a drain while it is open is refused with no launch, no
    drain is served on the CPU; past the cooldown on a virtual clock the
    half-open probe launches once and re-closes it; then
    `hash.device-lost` raises from inside the device backend with no
    launch."""
    from stellar_core_tpu_torch.crypto.batch_hasher import (
        CudaBatchHasher, make_hasher,
    )
    from stellar_core_tpu_torch.crypto.batch_verifier import BreakerOpenError
    from stellar_core_tpu_torch.testing.entries import entry_records
    from stellar_core_tpu_torch.util.faults import FaultInjector, InjectedFault
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    from stellar_core_tpu_torch.util.tracing import FlightRecorder, Tracer
    import traceback
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    reg = MetricsRegistry(now_fn=clock.now)
    tr = Tracer(now_fn=clock.now)
    tr.enable()
    rec = FlightRecorder(tr, metrics=reg, out_dir=flight_dir,
                         now_fn=clock.now)
    faults = FaultInjector(seed=7, metrics=reg, tracer=tr)
    faults.configure("hash.dispatch-fail", count=BREAKER_THRESHOLD)
    h = make_hasher("cuda-resilient", clock=clock, metrics=reg, tracer=tr,
                    faults=faults, flight_recorder=rec,
                    breaker_threshold=BREAKER_THRESHOLD,
                    breaker_cooldown=BREAKER_COOLDOWN)
    batch = entry_records(rng, CLOSE_LEAVES)
    want = hashlib_leaves(batch)
    n_chunks = len(h.inner.plan([S.blocks_for_len(1 + len(r))
                                 for r in batch])[1])
    E.LAUNCHES = S.LAUNCHES = 0

    def raised(exc_type):
        try:
            SC.entry_leaves(batch, h)
        except exc_type as e:
            return e
        return None

    for _ in range(BREAKER_THRESHOLD):
        check(raised(InjectedFault) is not None, "a failed drain raises")
    check(h.breaker.state == "open" and h.breaker.trips == 1,
          "the hash breaker tripped")
    check(raised(BreakerOpenError) is not None,
          "the open hash breaker refuses a drain")
    m = reg.to_json()
    check(S.LAUNCHES == 0, "no launch while the dispatch fails or the "
          "breaker is open")
    check(m["hasher.dispatch-failure"]["count"] == BREAKER_THRESHOLD
          and m["hasher.refused-drain"]["count"] == 1
          and m["hasher.breaker.trip"]["count"] == 1,
          "hasher.dispatch-failure %d, refused-drain 1, breaker.trip 1"
          % BREAKER_THRESHOLD)
    check(rec.dumps == 1 and "hash-breaker-trip" in rec.last_path,
          "the trip left one hash-breaker-trip flight dump")
    check(h.stats.to_json()["drains"]["by_backend"] == {},
          "no drain was served while the breaker tripped")
    clock.set_virtual_time(clock.now() + BREAKER_COOLDOWN + 1.0)
    check(SC.entry_leaves(batch, h) == want, "the probe drain's leaves")
    check(S.LAUNCHES == n_chunks and h.breaker.state == "closed"
          and h.breaker.recoveries == 1,
          "the half-open probe drain launched once per chunk and "
          "re-closed the breaker")
    faults.configure("hash.device-lost", count=1)
    e = raised(InjectedFault)
    check(e is not None and any(
        isinstance(f.f_locals.get("self"), CudaBatchHasher)
        for f, _l in traceback.walk_tb(e.__traceback__)),
        "hash.device-lost raises from inside the device backend")
    m = reg.to_json()
    check(S.LAUNCHES == n_chunks and E.LAUNCHES == 0,
          "hash.device-lost: no launch")
    check(m["fault.injected.hash.device-lost"]["count"] == 1,
          "hash.device-lost fired once")
    check("hasher.fallback-drain" not in m
          and set(h.stats.to_json()["drains"]["by_backend"]) == {"cuda"},
          "every hash drain was served on the card")
    log("H7 hash breaker: make_hasher('cuda-resilient'), hash.dispatch-fail "
        "fired %d times: %d drains of %d leaves raised with no launch, "
        "tripped (hasher.breaker.trip %d, flight dump %s), one drain refused "
        "while open, none served on the CPU; the half-open probe after "
        "%.0f s launched %d time(s) and re-closed the breaker; "
        "hash.device-lost "
        "raised inside CudaBatchHasher with no launch (breaker JSON %s)"
        % (BREAKER_THRESHOLD, BREAKER_THRESHOLD, CLOSE_LEAVES,
           m["hasher.breaker.trip"]["count"], os.path.basename(rec.last_path),
           BREAKER_COOLDOWN + 1.0, n_chunks,
           json.dumps(h.breaker.to_json())))


# --- the ledger phases (L1-L5): the state commitment over a real state -----

def ledger_header(X, seq: int, prev: bytes):
    """A protocol-13 header at `seq` after `prev` (bucket-list hash and
    skip list filled by BucketManager.snapshot_ledger)."""
    zero = b"\x00" * 32
    return X.LedgerHeader(
        ledgerVersion=LEDGER_PROTOCOL, previousLedgerHash=prev,
        scpValue=X.StellarValue(txSetHash=zero, closeTime=seq, upgrades=[],
                                ext=X.StellarValueExt(0, None)),
        txSetResultHash=zero, bucketListHash=zero, ledgerSeq=seq,
        totalCoins=10 ** 17, feePool=0, inflationSeq=0, idPool=0,
        baseFee=100, baseReserve=5_000_000, maxTxSetSize=1000,
        skipList=[zero] * 4, ext=X._Ext.v0())


def leaf_blocks(S, bucket) -> list:
    """SHA-256 block count of each of a bucket's entry leaves (the 0x00
    prefix and the XDR body: its framed record less the 4-byte mark)."""
    from stellar_core_tpu_torch.bucket.bucket import entry_record
    return [S.blocks_for_len(len(entry_record(e)) - 3)
            for e in bucket.entries]


def bucket_launches(S, hasher, bucket) -> int:
    """Launches that hashing a bucket's entry leaves takes on the card:
    one per chunk of the widest lane bucket, over the leaves that fit the
    longest block bucket (longer ones are hashed on the host)."""
    ladder = type(hasher)
    n = sum(1 for b in leaf_blocks(S, bucket)
            if b <= ladder.BLOCK_BUCKETS[-1])
    return -(-n // ladder.LANE_BUCKETS[-1])


def list_slots(bl) -> list:
    """The bucket list's 22 buckets in commitment leaf order (level 0
    curr, level 0 snap, level 1 curr, ...), read from the list itself."""
    return [b for lev in bl.levels for b in (lev.curr, lev.snap)]


def slots_view(slots: list):
    """A read-only stand-in for a bucket list holding `slots` (what
    update_root reads), so a close's buckets can be committed again."""
    from types import SimpleNamespace
    return SimpleNamespace(levels=[SimpleNamespace(curr=c, snap=s)
                                   for c, s in zip(slots[::2], slots[1::2])])


def ledger_state(rng, bucket_dir: str, card: str) -> dict:
    """L1: LEDGER_STATE live entries of the testing/entries.py mix as the
    port's BucketEntry objects, in canonical order (one numpy sort of the
    bodies' identity prefixes), split into the deep levels' curr buckets
    (DEEP_LEVEL_ENTRIES, the rest in level 10), adopted through a
    BucketManager with background merges over `bucket_dir`, then restored
    with assume_state at LEDGER_START."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.bucket import BucketManager, K_NUM_LEVELS
    from stellar_core_tpu_torch.bucket.bucket import (
        Bucket, bucket_entry_sort_key,
    )
    from stellar_core_tpu_torch.testing import entries as TE
    zero = b"\x00" * 32
    t0 = time.perf_counter()
    records = TE.entry_records(rng, LEDGER_STATE)
    order = TE.canonical_order(records)
    level = np.full(LEDGER_STATE, K_NUM_LEVELS - 1)
    pick = rng.permutation(LEDGER_STATE)
    k = 0
    for lv, n in sorted(DEEP_LEVEL_ENTRIES.items()):
        level[pick[k:k + n]] = lv
        k += n
    t_gen = time.perf_counter()
    mgr = BucketManager(bucket_dir, background_merges=True)
    hashes, live, by_level = [], [], {}
    t_decode = t_hash = 0.0
    for lv in range(K_NUM_LEVELS):
        idx = order[level[order] == lv]
        if not len(idx):
            hashes.append({"curr": zero, "snap": zero})
            continue
        t1 = time.perf_counter()
        ents = TE.bucket_entries([records[i] for i in idx.tolist()])
        t2 = time.perf_counter()
        b = mgr.adopt_bucket(Bucket([X.BucketEntry.meta(LEDGER_PROTOCOL)]
                                    + ents))
        t_hash += time.perf_counter() - t2
        t_decode += t2 - t1
        check(b.path is not None and os.path.exists(b.path),
              "L1: level %d's bucket is written to the bucket directory"
              % lv)
        live.extend(e.value for e in ents)
        by_level[lv] = b
        hashes.append({"curr": b.get_hash(), "snap": zero})
    del records
    mgr.assume_state(hashes, LEDGER_START, LEDGER_PROTOCOL)
    setup_s = time.perf_counter() - t0
    bl = mgr.bucket_list
    check(all(lev.curr is by_level.get(i, lev.curr) and lev.snap.is_empty()
              and lev.next.is_clear() for i, lev in enumerate(bl.levels)),
          "L1: assume_state restored every level, no merge to restart")
    check(sum(len(b.payload_entries()) for b in by_level.values())
          == len(live) == LEDGER_STATE, "L1: %d live entries" % LEDGER_STATE)
    deep = by_level[K_NUM_LEVELS - 1].entries
    for i in rng.integers(1, len(deep) - 1, 2000).tolist():
        check(bucket_entry_sort_key(deep[i]) < bucket_entry_sort_key(
            deep[i + 1]), "L1: the deep bucket is in canonical order")
    log("L1 state (%s): %d live entries at ledger %d in %.1f s (generate + "
        "sort %.1f s, decode %.1f s, bucket hash + file %.1f s); levels "
        "%s; level 10 holds %d; bucket-list hash %s"
        % (card, LEDGER_STATE, LEDGER_START, setup_s, t_gen - t0, t_decode,
           t_hash, json.dumps({str(k): len(b) - 1
                               for k, b in sorted(by_level.items())}),
           len(deep) - 1, mgr.get_hash().hex()[:16]))
    return {"mgr": mgr, "live": live, "deep": deep, "setup_s": setup_s}


def ledger_close(X, S, SC, st: dict, seq: int, rng) -> dict:
    """One close of LEDGER_MIX changed entries through
    BucketManager.add_batch, then on_close on both engines. Checks the
    roots equal and that the card hashed exactly the leaves of the changed
    buckets not seen in an earlier close. Which buckets those are is
    decided from the bucket list alone (the slot hashes of the previous
    close and every hash seen before, kept in `st`), never from the
    engine's caches."""
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.testing import entries as TE
    from stellar_core_tpu_torch.xdr import fastcodec
    n_up, n_init, n_dead = LEDGER_MIX
    live, eng, twin, mgr = st["live"], st["eng"], st["twin"], st["mgr"]
    copy = fastcodec.compile_copy(X.LedgerEntry)
    pick = rng.choice(len(live), n_up + n_dead, replace=False).tolist()
    ups = []
    for i in pick[:n_up]:
        e = copy(live[i])
        e.lastModifiedLedgerSeq = seq
        live[i] = e
        ups.append(e)
        st["touched"][X.ledger_entry_key(e).to_xdr()] = seq
    deads = []
    for i in sorted(pick[n_up:], reverse=True):
        k = X.ledger_entry_key(live[i])
        deads.append(k)
        st["touched"][k.to_xdr()] = -seq
        live[i] = live[-1]
        live.pop()
    inits = [b.value for b in TE.bucket_entries(
        TE.entry_records(rng, n_init))]
    for e in inits:
        e.lastModifiedLedgerSeq = seq
        st["touched"][X.ledger_entry_key(e).to_xdr()] = seq
    live.extend(inits)
    t0 = time.perf_counter()
    mgr.add_batch(seq, LEDGER_PROTOCOL, inits, ups, deads)
    mgr.bucket_list.resolve_any_ready_futures()
    hdr = st["header"]
    hdr.ledgerSeq = seq
    hdr.previousLedgerHash = st["header_hash"]
    hdr.scpValue.closeTime = seq
    mgr.snapshot_ledger(hdr)
    st["header_hash"] = hh = sha256(hdr.to_xdr())
    add_ms = (time.perf_counter() - t0) * 1e3
    # what the card must hash: the buckets in slots whose hash changed
    # since the previous close and was never seen before (a bucket that
    # moved from curr to snap, or an empty one, costs no launch)
    slots = list_slots(mgr.bucket_list)
    fresh, cached = {}, 0
    for prev, b in zip(st["slot_hashes"], slots):
        bh = b.get_hash()
        if bh == prev or bh == SC.ZERO_HASH:
            continue
        if bh in st["seen"] or bh in fresh:
            cached += 1
        else:
            fresh[bh] = b
    st["slot_hashes"] = [b.get_hash() for b in slots]
    st["seen"].update(st["slot_hashes"])
    want_launches = sum(bucket_launches(S, st["hasher"].inner, b)
                        for b in fresh.values())
    want_msgs = sum(len(b.entries) for b in fresh.values())
    l0 = S.LAUNCHES
    m0 = st["hasher"].stats.to_json()["sites"].get(
        "bucket-entries", {}).get("msgs", 0)
    t0 = time.perf_counter()
    cp = eng.on_close(mgr.bucket_list, seq, hh)
    close_ms = (time.perf_counter() - t0) * 1e3
    launches = S.LAUNCHES - l0
    msgs = st["hasher"].stats.to_json()["sites"]["bucket-entries"]["msgs"] \
        - m0
    t0 = time.perf_counter()
    tcp = twin.on_close(mgr.bucket_list, seq, hh)
    twin_ms = (time.perf_counter() - t0) * 1e3
    check(eng.root == twin.root, "close %d: the card's root == the hashlib "
          "twin's" % seq)
    check(launches == want_launches and msgs == want_msgs,
          "close %d: %d launches for the %d leaves of the %d buckets new "
          "in its slots (got %d launches, %d leaves)"
          % (seq, want_launches, want_msgs, len(fresh), launches, msgs))
    check((cp is None and tcp is None) or (
        cp is not None and tcp is not None
        and cp.to_json() == tcp.to_json()) or (
        cp is None and st.get("sign_fail")),
          "close %d: the same checkpoint from both engines" % seq)
    mgr.forget_unreferenced_buckets()
    return {"seq": seq, "leaves": msgs, "launches": launches,
            "buckets": list(fresh.values()), "slots": slots,
            "root": eng.root,
            "changed": len(fresh), "cached": cached, "add_ms": add_ms,
            "close_ms": close_ms, "twin_ms": twin_ms,
            "checkpoint": cp is not None}


def ledger_layers(S, SC, h, cpu, buckets: list, card: str) -> None:
    """Where the closes' commitment time goes: the entry-root work of the
    buckets the 64 closes drained, each layer timed alone on them (the
    records' XDR bodies, the leaves through the card's hasher and through
    hashlib, the Merkle interior on the host), each leaf == hashlib's."""
    from stellar_core_tpu_torch.bucket.bucket import entry_record
    t0 = time.perf_counter()
    recs = [[entry_record(e)[4:] for e in b.entries] for b in buckets]
    t1 = time.perf_counter()
    leaves = [SC.entry_leaves(r, h) for r in recs]
    t2 = time.perf_counter()
    want = [SC.entry_leaves(r, cpu) for r in recs]
    t3 = time.perf_counter()
    for lv in leaves:
        SC.merkle_root(lv)
    t4 = time.perf_counter()
    check(leaves == want, "L3 layers: every leaf == hashlib's")
    log("L3 layers timed alone over the %d buckets the closes drained "
        "(%d leaves; %s): records %.1f ms, leaves through the card %.1f "
        "ms (hashlib %.1f ms), Merkle interior %.1f ms"
        % (len(buckets), sum(len(r) for r in recs), card,
           (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
           (t4 - t3) * 1e3))


def ledger_path(S, E, rng, flight_dir: str, card: str) -> dict:
    """L1-L5 of the module docstring; returns the launches of L2-L4."""
    from types import SimpleNamespace
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.ledger import state_commitment as SC
    from stellar_core_tpu_torch.util.faults import FaultInjector
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.tracing import FlightRecorder, Tracer
    out = {"launches": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_buckets_") as bdir:
        # --- L1 ------------------------------------------------------------
        E.LAUNCHES = S.LAUNCHES = 0
        st = ledger_state(rng, bdir, card)
        check(S.LAUNCHES == 0 and E.LAUNCHES == 0,
              "L1 builds the state without a launch")
        mgr = st["mgr"]
        bl = mgr.bucket_list
        out["setup_s"] = st["setup_s"]

        # --- L2 ------------------------------------------------------------
        reg = MetricsRegistry()
        tr = Tracer()
        tr.enable()
        faults = FaultInjector(seed=LEDGER_START, metrics=reg, tracer=tr)
        rec = FlightRecorder(tr, metrics=reg, out_dir=flight_dir)
        h = make_hasher("cuda-resilient", metrics=reg, tracer=tr,
                        faults=faults, flight_recorder=rec)
        check(h.fallback is None, "L2: the card's hash stack has no "
              "fallback")
        cfg = SimpleNamespace(NODE_SEED=SecretKey(rng.bytes(32)),
                              network_id=LEDGER_NETWORK_ID,
                              STATE_CHECKPOINT_INTERVAL=CHECKPOINT_EVERY)
        eng = SC.StateCommitmentEngine(SimpleNamespace(
            batch_hasher=h, config=cfg, metrics=reg, tracer=tr,
            faults=faults, flight_recorder=rec))
        twin = SC.StateCommitmentEngine(SimpleNamespace(
            batch_hasher=make_hasher("cpu"), config=cfg,
            metrics=MetricsRegistry()))
        st.update(eng=eng, twin=twin, hasher=h, touched={},
                  header=ledger_header(X, LEDGER_START, b"\x00" * 32),
                  header_hash=b"\x00" * 32)
        buckets = [b for b in list_slots(bl) if b.get_hash() != SC.ZERO_HASH]
        st["slot_hashes"] = [b.get_hash() for b in list_slots(bl)]
        st["seen"] = set(st["slot_hashes"])
        want = sum(bucket_launches(S, h.inner, b) for b in buckets)
        E.LAUNCHES = S.LAUNCHES = 0
        t0 = time.perf_counter()
        root = eng.update_root(bl)
        first_ms = (time.perf_counter() - t0) * 1e3
        first_launches = S.LAUNCHES
        t0 = time.perf_counter()
        twin_root = twin.update_root(bl)
        twin_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        oracle = eng.from_scratch_root(bl)
        oracle_s = time.perf_counter() - t0
        check(root == twin_root == oracle, "L2: the first root == the "
              "hashlib twin's == from_scratch_root")
        check(first_launches == want > 0, "L2: %d launches, one per planned "
              "chunk of the %d buckets" % (want, len(buckets)))
        # a second engine over the same hasher, profiled; its caches then
        # hold the state `eng`'s hold before L3, and L3 replays its closes
        # on it under the profiler
        fresh = SC.StateCommitmentEngine(SimpleNamespace(
            batch_hasher=h, config=None, metrics=None))
        prof = profile_drain(lambda: fresh.update_root(bl),
                             "sha256_blocks_kernel")
        check(prof["result"] == root, "L2: the profiled first root")
        j = h.stats.to_json()
        check(j["sites"]["bucket-entries"]["drains"] == 2 * len(buckets)
              and set(j["drains"]["by_backend"]) == {"cuda"}
              and j["oversize_msgs"] == 0,
              "L2: every drain on the card, counted under bucket-entries")
        out["launches"]["L2"] = S.LAUNCHES
        check(S.LAUNCHES == 2 * want and E.LAUNCHES == 0,
              "L2: launches (first update + profiled update)")
        out["first_ms"] = first_ms
        log("L2 first update_root (%s): %d leaves of %d buckets through "
            "make_hasher(\"cuda-resilient\") in %.1f ms (%d launches); "
            "hashlib twin %.1f ms; from_scratch_root %.1f s; root %s"
            % (card, sum(len(b) for b in buckets), len(buckets), first_ms,
               first_launches, twin_ms, oracle_s, root.hex()[:16]))
        log_profile("L2 first update_root", prof, "sha256_blocks_kernel")

        # --- L3 ------------------------------------------------------------
        log("L3 mix per close: %d updates of live entries, %d inits, %d "
            "deads (an assumption, no published source)" % LEDGER_MIX)
        shapes0 = {k: v["dispatches"] for k, v in j["buckets"].items()}
        tr.clear()
        E.LAUNCHES = S.LAUNCHES = 0
        t0 = time.perf_counter()
        closes = [ledger_close(X, S, SC, st, LEDGER_START + k, rng)
                  for k in range(1, LEDGER_CLOSES + 1)]
        wall_s = time.perf_counter() - t0
        out["launches"]["L3"] = S.LAUNCHES
        check(S.LAUNCHES == sum(c["launches"] for c in closes) > 0
              and E.LAUNCHES == 0, "L3: the closes launched the hash kernel")
        last = LEDGER_START + LEDGER_CLOSES
        check(eng.root == twin.root == eng.from_scratch_root(bl),
              "L3: the root == from_scratch_root on the last close")
        check(sorted(eng.checkpoints) == sorted(twin.checkpoints)
              == [LEDGER_START + CHECKPOINT_EVERY * i for i in
                  range(1, LEDGER_CLOSES // CHECKPOINT_EVERY + 1)]
              and reg.to_json()["commitment.checkpoint.emitted"]["count"]
              == LEDGER_CLOSES // CHECKPOINT_EVERY,
              "L3: %d checkpoints" % (LEDGER_CLOSES // CHECKPOINT_EVERY))
        check(any(c["cached"] for c in closes),
              "L3: slots that took a cached bucket (curr to snap) cost no "
              "launch")
        upd = reg.new_histogram("commitment.update-ms")
        check(upd.count == 1 + LEDGER_CLOSES, "commitment.update-ms: one "
              "sample per update")
        ms = list(upd._samples[1:1 + LEDGER_CLOSES])
        j = h.stats.to_json()
        shapes = {k: v["dispatches"] - shapes0.get(k, 0)
                  for k, v in j["buckets"].items()
                  if v["dispatches"] - shapes0.get(k, 0)}
        check(set(j["drains"]["by_backend"]) == {"cuda"},
              "L3: no drain served on the CPU")
        leaves = [c["leaves"] for c in closes]
        out.update(update_ms=ms, closes=closes)
        log("L3 %d closes (%s): commitment.update-ms p50 %.3f ms, p99 %.3f "
            "ms (p99 of %d samples is their maximum); on_close p50 %.3f "
            "ms, hashlib twin p50 %.3f ms, add_batch p50 %.3f ms; changed "
            "leaves per close min %d / p50 %d / max %d; %d launches, "
            "shapes %s; closes with a slot served from the cache %d; wall "
            "%.1f s"
            % (LEDGER_CLOSES, card, float(np.percentile(ms, 50)),
               p99(ms), len(ms),
               float(np.percentile([c["close_ms"] for c in closes], 50)),
               float(np.percentile([c["twin_ms"] for c in closes], 50)),
               float(np.percentile([c["add_ms"] for c in closes], 50)),
               min(leaves), int(np.percentile(leaves, 50)), max(leaves),
               S.LAUNCHES, json.dumps(shapes),
               sum(1 for c in closes if c["cached"]), wall_s))
        log("L3 per close (seq: leaves/launches/update ms): %s"
            % " ".join("%d:%d/%d/%.1f" % (c["seq"] - LEDGER_START,
                                          c["leaves"], c["launches"], m)
                       for c, m in zip(closes, ms)))
        log("L3 spans: %s" % phases_line(tr.phase_breakdown(wall_s=wall_s)))
        # the card's busy share: the closes above run without the profiler;
        # their 64 updates are replayed on L2's profiled engine (whose
        # caches start where `eng`'s did), recording CUDA activity only
        l3_launches = S.LAUNCHES
        prof = profile_drain(
            lambda: [fresh.update_root(slots_view(c.pop("slots")))
                     for c in closes],
            "sha256_blocks_kernel", cpu=False)
        check(prof["result"] == [c["root"] for c in closes]
              and S.LAUNCHES - l3_launches == l3_launches,
              "L3 replay: the same %d roots in the same %d launches"
              % (LEDGER_CLOSES, l3_launches))
        log_profile("L3 replay of the 64 updates (CUDA activity only)",
                    prof, "sha256_blocks_kernel")
        if prof["device_events"]:
            log("L3 card busy %.3f ms over the unprofiled closes' %.3f ms "
                "of commitment.update-ms = %.2f%%"
                % (prof["busy_ms"], sum(ms),
                   100.0 * prof["busy_ms"] / sum(ms)))
        ledger_layers(S, SC, h, st["twin"].app.batch_hasher,
                      [b for c in closes for b in c.pop("buckets")], card)

        # --- L4 ------------------------------------------------------------
        touched = st["touched"]
        ups = [k for k, s in touched.items() if s == LEDGER_START + 1]
        newest = [k for k, s in touched.items() if s == last]
        gone = [k for k, s in touched.items() if s < 0]
        untouched = [e for e in st["deep"][1:50000]
                     if X.ledger_entry_key(e.value).to_xdr() not in touched]
        cases = [("level 0", X.LedgerKey.from_xdr(newest[0]), (0,)),
                 ("middle", X.LedgerKey.from_xdr(ups[0]), range(1, 10)),
                 ("deep", X.ledger_entry_key(untouched[0].value), (10,))]
        cp = eng.checkpoint()
        check(cp is not None and cp["ledger_seq"] == last,
              "L4: the served checkpoint is the last close's")
        E.LAUNCHES = S.LAUNCHES = 0
        out["proofs"] = {}
        for what, key, levels in cases:
            l0 = S.LAUNCHES
            t0 = time.perf_counter()
            proof = eng.prove_entry(key)
            p_ms = (time.perf_counter() - t0) * 1e3
            check(proof is not None and proof["leaf_index"] // 2 in levels,
                  "L4: a %s proof, in level %s" % (what, list(levels)))
            # no close since the served checkpoint: its buckets are the
            # list's own
            bucket = list_slots(bl)[proof["leaf_index"]]
            check(S.LAUNCHES - l0 == bucket_launches(S, h.inner, bucket) > 0,
                  "L4: the %s proof re-hashes its bucket on the card"
                  % what)
            check(proof == twin.prove_entry(key), "L4: %s proof == the "
                  "hashlib twin's" % what)
            check(SC.light_client_verify(proof, cp, LEDGER_NETWORK_ID)
                  == (True, "ok"), "L4: %s proof accepted" % what)
            bad = json.loads(json.dumps(proof))
            bad["entry"] = bad["entry"][:-2] + (
                "00" if bad["entry"][-2:] != "00" else "01")
            check(SC.light_client_verify(bad, cp, LEDGER_NETWORK_ID)
                  == (False, "merkle root mismatch"),
                  "L4: a flipped entry byte is rejected")
            bad = json.loads(json.dumps(proof))
            bad["entry_path"][0]["h"] = sha256(b"evil").hex()
            check(not SC.light_client_verify(bad, cp, LEDGER_NETWORK_ID)[0],
                  "L4: a wrong sibling in entry_path is rejected")
            check(not SC.light_client_verify(proof, cp, b"\x42" * 32)[0],
                  "L4: another network_id is rejected")
            forged = dict(cp)
            forged["signature"] = "%02x" % (int(cp["signature"][:2], 16)
                                            ^ 1) + cp["signature"][2:]
            check(SC.light_client_verify(proof, forged, LEDGER_NETWORK_ID)
                  == (False, "checkpoint signature invalid"),
                  "L4: a flipped signature byte is rejected")
            nbytes = len(json.dumps(proof))
            out["proofs"][what] = {"ms": p_ms, "bytes": nbytes}
            log("L4 %s proof (%s): level %d of %d entries, %.3f ms, %d "
                "bytes, %d launches; accepted, 4 tamperings rejected"
                % (what, card, proof["leaf_index"] // 2,
                   proof["entry_count"], p_ms, nbytes, S.LAUNCHES - l0))
        check(all(eng.prove_entry(X.LedgerKey.from_xdr(k)) is None
                  for k in gone[:20]), "L4: a deleted key gets no proof")
        out["launches"]["L4"] = S.LAUNCHES
        check(E.LAUNCHES == 0, "L4 launched no verify kernel")

        # --- L5 ------------------------------------------------------------
        faults.configure("commitment.sign-fail", probability=1.0, count=1)
        st["sign_fail"] = True
        dumps = rec.dumps
        for k in range(1, 2 * CHECKPOINT_EVERY + 1):
            ledger_close(X, S, SC, st, last + k, rng)
        skipped, emitted = last + CHECKPOINT_EVERY, last + 2 * CHECKPOINT_EVERY
        m = reg.to_json()
        check(skipped not in eng.checkpoints and skipped in twin.checkpoints
              and emitted in eng.checkpoints
              and eng.checkpoint() == twin.checkpoint(emitted),
              "L5: the failed interval is skipped, the next one emits")
        check(m["commitment.sign-fail"]["count"] == 1
              and m["fault.injected.commitment.sign-fail"]["count"] == 1,
              "L5: the meter counts 1")
        check(rec.dumps == dumps + 1
              and "checkpoint-sign-fail" in rec.last_path,
              "L5: the flight recorder dumped checkpoint-sign-fail")
        with open(rec.last_path) as fh:
            check(json.load(fh)["extra"]["ledger_seq"] == skipped,
                  "L5: the dump names the skipped ledger")
        check(eng.root == twin.root, "L5: roots still equal")
        log("L5 commitment.sign-fail: checkpoint at ledger %d skipped, "
            "meter 1, flight dump %s, checkpoint at %d emitted"
            % (skipped, os.path.basename(rec.last_path), emitted))
        mgr.shutdown()
    return out

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # the breaker phases' flight dumps go to a directory of their own
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flight_") as fdir:
        return smoke(torch, args, fdir)


def smoke(torch, args, flight_dir: str) -> int:
    """The phases of the module docstring, in order; raises on a failed
    check."""
    from stellar_core_tpu_torch import _build
    from stellar_core_tpu_torch.graft_entry import entry
    from stellar_core_tpu_torch.crypto import batch_verifier as BV
    from stellar_core_tpu_torch.crypto import keys as K
    from stellar_core_tpu_torch import native
    from stellar_core_tpu_torch.native import ed25519_native
    from stellar_core_tpu_torch.ops import ed25519 as E
    from stellar_core_tpu_torch.ops import sha256 as S
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
    prebuilt = {stem for stem in ("ed25519_verify", "sha256")
                if _build.cuda_built(stem)}
    libs = _build.build_cuda()
    check(ed25519_native() is not None, "the C CPU verifier builds")
    check(native.prep_lib() is not None, "the C host prep builds")
    log("build: %.1f s (%s)" % (time.perf_counter() - t0,
                                ", ".join(sorted(libs))))
    check(sorted(libs) == ["ed25519_verify", "sha256"],
          "both kernels built")
    for stem, kernel in (("ed25519_verify", "ed25519_verify_kernel"),
                         ("sha256", "sha256_blocks_kernel")):
        log("ptxas %s (%s): %s" % (
            kernel, "an earlier build's log" if stem in prebuilt
            else "built in this run",
            json.dumps(ptxas_report(libs[stem][:-3] + ".log", kernel))))
    log("ed25519 bound: %d products per verify (%d field multiplies, %d "
        "squarings); the quad design issues %d (%d, %d)"
        % (PRODUCTS_PER_VERIFY, FE_MUL_PER_VERIFY, FE_SQ_PER_VERIFY,
           QUAD_PRODUCTS_PER_VERIFY, QUAD_FE_MUL, QUAD_FE_SQ))
    ops = sass_opcodes(libs["ed25519_verify"], "ed25519_verify_kernel")
    if ops is not None:
        log("sass ed25519_verify_kernel: %d instructions; %s"
            % (sum(ops.values()),
               ", ".join("%s %d" % kv for kv in ops.most_common(16))))
    ops = sass_opcodes(libs["sha256"], "sha256_blocks_kernel")
    if ops is None:
        log("sass sha256_blocks_kernel: no cuobjdump in the toolkit")
    else:
        log("sass sha256_blocks_kernel: %d instructions; %s"
            % (sum(ops.values()),
               ", ".join("%s %d" % kv for kv in ops.most_common(12))))
        # one loop per warp role, each run once per block: the round warp's
        # has the ring loads and no stores, the schedule warp's the stores
        for loop in sass_loops(libs["sha256"], "sha256_blocks_kernel"):
            role = ("schedule warp" if loop["ops"]["STS.128"]
                    else "round warp" if loop["ops"]["LDS.128"] else "loop")
            log("sass sha256_blocks_kernel %s, per block: %d instructions, "
                "%d stall clocks; %s"
                % (role, loop["instructions"], loop["stall_clocks"],
                   ", ".join("%s %d" % kv
                             for kv in loop["ops"].most_common(8))))
    log("sha256 bound: %d INT32-pipe + %d other instructions per block, "
        "%.2f clocks per block per SM"
        % (PIPE_INSTR_PER_BLOCK, INSTR_PER_BLOCK - PIPE_INSTR_PER_BLOCK,
           CLOCKS_PER_BLOCK_PER_SM))

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
    for n in RAGGED_LANES:
        r = kernel_vs_plain(E, vectors, corpus, n, props, timed=False)
        ref = (vec_ref + expect)[:n]
        check(r["decisions"] == ref,
              "kernel == C verifier at %d lanes" % n)
        log("kernel ed25519_verify at %d lanes (off the ladder): == plain "
            "and the C verifier, mismatches %d" % (n, r["mismatches"]))

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
    E.LAUNCHES = S.LAUNCHES = 0
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
        "(%d launches; host prep included, native)"
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
    check(S.LAUNCHES == 0, "the verify path launched no hash kernel")
    log("flush latency, 128 bucket, %d bursts of %d-%d: p50 %.3f ms, "
        "p99 %.3f ms (p99 of %d samples is their maximum)"
        % (BURSTS, BURST_MIN, BURST_MAX, float(np.percentile(lat, 50)),
           p99(lat), len(lat)))
    log("main path kernel launches: ed25519_verify %d" % launches)

    # --- the drain again, from an empty cache, under the profiler ----------
    K.flush_verify_cache()
    prof = profile_drain(lambda: v.prewarm_many(drain),
                         "ed25519_verify_kernel")
    check(prof["result"] == drain_expect, "profiled drain decisions")
    log_profile("drain", prof, "ed25519_verify_kernel")

    # --- the host layers: C prep, both prep modes, async, breaker ----------
    host_prep_phase(E, K, native, drain, vectors)
    prep_mode_drains(BV, K, E, S, native, drain, cpu_ref[:n_drain])
    async_scp_phase(BV, K, E, S, rng, burst_pool, cpu_ref[n_drain:])
    breaker_phase(BV, K, E, S, drain, got, flight_dir)

    fleet = fleet_path(torch, vectors, corpus, drain, cpu_ref[:n_drain],
                       props)

    shapes, hash_launches, records, want_leaves = hash_path(torch, rng,
                                                           props)

    # --- the hasher's operator layers: C padder, staging, breaker ----------
    from stellar_core_tpu_torch.crypto.batch_hasher import CudaBatchHasher
    from stellar_core_tpu_torch.ledger import state_commitment as SC
    pad_phase(S, native, CudaBatchHasher(), records, rng)
    hash_layer_drains(S, E, native, SC, records, want_leaves, rng,
                      flight_dir, card)
    hash_breaker_phase(S, E, SC, rng, flight_dir)

    # --- the ledger: bucket list and state commitment over 2^20 entries ---
    ledger = ledger_path(S, E, rng, flight_dir, card)
    ledger_launches = sum(ledger["launches"].values())

    main_b = buckets[DRAIN_CHUNK]
    main_s = shapes[HASH_MAIN_SHAPE]
    main_f = fleet["shard"][DRAIN_CHUNK]
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
                    for b, r in buckets.items()}}, {
        "name": "sha256", "route": "cuda",
        "source": "stellar_core_tpu_torch/csrc/sha256.cu",
        "replaces": "stellar_core_tpu/ops/sha256.py:112",
        "launches": hash_launches + ledger_launches,
        "launches_by_path": {"hash main path": hash_launches,
                             **ledger["launches"]},
        "max_abs_err": float(max(r["mismatches"] for r in shapes.values())),
        "ms": main_s["ms"], "plain_ms": main_s["plain_ms"],
        "bound_ms": main_s["bound_ms"], "bound_by": main_s["bound_by"],
        "chain_floor_ms": main_s["chain_floor_ms"],
        "library_ms": None, "check": "ok", "main_shape": HASH_MAIN_SHAPE,
        "shapes": {k: {f: r[f] for f in ("ms", "plain_ms", "hashlib_ms",
                                         "bound_ms", "chain_floor_ms",
                                         "mismatches")}
                   for k, r in shapes.items()}}, {
        "name": "ed25519_verify_sharded", "route": "cuda",
        "source": "stellar_core_tpu_torch/parallel/mesh.py + "
                  "stellar_core_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "stellar_core_tpu/parallel/mesh.py:33",
        "launches": fleet["launches"],
        "max_abs_err": float(sum(r["mismatches"]
                                 for r in fleet["shard"].values())),
        "ms": main_f["ms"][4], "plain_ms": main_f["plain_ms"],
        "bound_ms": main_f["bound_ms"], "bound_by": main_f["bound_by"],
        "library_ms": None, "check": "ok",
        "main_shape": "%d lanes over 4 members of cuda:0" % DRAIN_CHUNK,
        "members": {str(b): {"ms": {str(k): t for k, t in r["ms"].items()},
                             "gather_ms": r["gather_ms"],
                             "plain_ms": r["plain_ms"],
                             "bound_ms": r["bound_ms"]}
                    for b, r in fleet["shard"].items()}}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
