#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (`stellar_core_tpu_torch`) on
one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a). It builds every kernel from the
sources in the checkout (one nvcc per source, all started together), then
drives three paths.

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
   the block bucket, and padding lanes of garbage words with count 0. All
   8 words of every lane must be equal, and every real lane must equal
   hashlib. Tolerance: none (a digest one bit off forks consensus). Each
   shape's kernel time (CUDA events), bound, plain time and single-thread
   hashlib time on the same batch are printed;
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

It prints the card's name and power limit, the build time, both kernels'
ptxas reports (registers, stack frame, spills, shared memory; each from
the log of the build that made its library, marked when that build was
an earlier process's), the verify kernel's product count per verify
beside the bound's, both kernels' SASS opcode counts (cuobjdump, where
the toolkit has it), the
kernels' times, the paths' throughput and latency, their host layers
timed alone, the profiled drains' device busy share, a
`{"kernels": [...]}` line (three entries) and, last,
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
CLOSES, CLOSE_LEAVES = 20, 1000
# the fleet phase: drains over 2, 3 and 4 members sharing cuda:0, each
# three times from an empty cache; the sharded launch timed at these
# (bucket: member counts)
FLEET_SIZES = (2, 3, 4)
FLEET_RUNS = 3
FLEET_TIMES = {128: (1, 4), 8192: (1, 2, 3, 4)}


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


def profile_drain(run, kernel: str) -> dict:
    """run() under torch.profiler (CPU and CUDA activity): its result, its
    host wall time, and from the trace the card's busy time (the union of
    all device activity), the launches and device time of the kernel
    whose name contains `kernel`, and the device time of the five largest
    names."""
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


def hash_kernel_vs_plain(S, rng, lanes: int, blocks: int, props) -> dict:
    """The SHA-256 kernel against hash_blocks_plain on the same CUDA
    tensors at one ladder shape; their times, hashlib's and the bound."""
    import torch
    msgs, words, counts = hash_batch(S, rng, lanes, blocks)
    w = torch.from_numpy(words.view(np.int32)).cuda()
    c = torch.from_numpy(counts).cuda()
    got = S.hash_blocks_kernel(w, c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = S.hash_blocks_plain(w, c)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mismatches = int((got != want).sum())
    check(mismatches == 0, "sha256 kernel == plain at %dx%d (%d words "
          "differ)" % (lanes, blocks, mismatches))
    host = got.cpu().numpy().view(np.uint32)
    t0 = time.perf_counter()
    oracle = [hashlib.sha256(m).digest() for m in msgs]
    hashlib_ms = (time.perf_counter() - t0) * 1e3
    check(S.digests_to_bytes(host[:len(msgs)]) == oracle,
          "sha256 kernel == hashlib at %dx%d" % (lanes, blocks))
    check((host[len(msgs):] == S._H0).all(),
          "padding lanes keep H0 at %dx%d" % (lanes, blocks))
    ms = time_cuda(lambda: S.hash_blocks_kernel(w, c), reps=200)
    bound_ms, bound_by = hash_bound(int(counts.sum()), lanes, props)
    return {"ms": ms, "plain_ms": plain_ms, "hashlib_ms": hashlib_ms,
            "mismatches": mismatches, "real_blocks": int(counts.sum()),
            "bound_ms": bound_ms, "bound_by": bound_by}


def hash_drain_layers(S, hasher, records: list) -> dict:
    """The entry-leaf drain's layers timed alone on the host clock, on the
    same data, one chunk at a time as hash_many runs them, with a
    synchronise after each device step: ms per layer. The kernel's device
    time comes from the profiled drain."""
    import torch
    t = dict.fromkeys(("leaf assembly", "plan", "host padding",
                       "host->device", "launch + kernel",
                       "device->host", "digests_to_bytes"), 0.0)
    t0 = time.perf_counter()
    msgs = [b"\x00" + r for r in records]
    t1 = time.perf_counter()
    _over, chunks = hasher.plan([S.blocks_for_len(len(m)) for m in msgs])
    t2 = time.perf_counter()
    t["leaf assembly"] += t1 - t0
    t["plan"] += t2 - t1
    for idx, lanes, blk in chunks:
        t0 = time.perf_counter()
        words, counts = hasher.stage([msgs[i] for i in idx], lanes, blk)
        t1 = time.perf_counter()
        w = torch.from_numpy(words).to(hasher.device)
        c = torch.from_numpy(counts).to(hasher.device)
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
    the oversize route. Returns (per-shape results, main-path launches)."""
    from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
    from stellar_core_tpu_torch.ledger import state_commitment as SC
    from stellar_core_tpu_torch.ops import ed25519 as E
    from stellar_core_tpu_torch.ops import sha256 as S
    from stellar_core_tpu_torch.testing.entries import entry_records

    # --- the SHA-256 kernel against its plain version, every ladder shape --
    S.hash_blocks_plain(torch.zeros((8, 1, 16), dtype=torch.int32).cuda(),
                        torch.ones(8, dtype=torch.int32).cuda())
    shapes = {}
    for lanes in HASH_LANES:
        for blk in HASH_BLOCKS:
            r = hash_kernel_vs_plain(S, rng, lanes, blk, props)
            shapes["%dx%d" % (lanes, blk)] = r
            log("kernel sha256 %dx%d: %.4f ms (%.1f blocks/us), plain "
                "%.1f ms, hashlib (one thread) %.3f ms, bound %.5f ms (%s), "
                "mismatches %d"
                % (lanes, blk, r["ms"], r["real_blocks"] / r["ms"] / 1e3,
                   r["plain_ms"], r["hashlib_ms"], r["bound_ms"],
                   r["bound_by"], r["mismatches"]))

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
           float(np.percentile(lat, 99)), len(lat)))
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

    return shapes, hash_launches


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
    check(S.LAUNCHES == 0, "the verify path launched no hash kernel")
    log("flush latency, 128 bucket, %d bursts of %d-%d: p50 %.3f ms, "
        "p99 %.3f ms (p99 of %d samples is their maximum)"
        % (BURSTS, BURST_MIN, BURST_MAX, float(np.percentile(lat, 50)),
           float(np.percentile(lat, 99)), len(lat)))
    log("main path kernel launches: ed25519_verify %d" % launches)

    # --- the drain again, from an empty cache, under the profiler ----------
    K.flush_verify_cache()
    prof = profile_drain(lambda: v.prewarm_many(drain),
                         "ed25519_verify_kernel")
    check(prof["result"] == drain_expect, "profiled drain decisions")
    log_profile("drain", prof, "ed25519_verify_kernel")

    fleet = fleet_path(torch, vectors, corpus, drain, cpu_ref[:n_drain],
                       props)

    shapes, hash_launches = hash_path(torch, rng, props)

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
        "launches": hash_launches,
        "max_abs_err": float(max(r["mismatches"] for r in shapes.values())),
        "ms": main_s["ms"], "plain_ms": main_s["plain_ms"],
        "bound_ms": main_s["bound_ms"], "bound_by": main_s["bound_by"],
        "library_ms": None, "check": "ok", "main_shape": HASH_MAIN_SHAPE,
        "shapes": {k: {f: r[f] for f in ("ms", "plain_ms", "hashlib_ms",
                                         "bound_ms", "mismatches")}
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
