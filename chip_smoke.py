#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (`stellar_core_tpu_torch`) on
one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a). It builds every kernel from the
sources in the checkout (one nvcc per source, all started together), then
drives three paths, the ledger that runs on the hash path, the ledger
manager's close that runs on both, and the catchup that replays published
checkpoints through that close.

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

The close (the port's LedgerTxn, transactions layer, TxSetFrame and
LedgerManager over both paths), each phase driven with the counts set to
0 just before it and read just after. The card's LedgerManager closes
through `make_verifier("cuda-resilient")` and `make_hasher(
"cuda-resilient")` (no fallback), with a real Tracer, FlightRecorder and
metrics; a CPU twin (`CpuSigVerifier`, the hashlib hasher, the in-memory
root) closes the same values. Each side validates from an empty verify
cache (the process has one), so neither reads the other's decisions:

C1. restores a state of CLOSE_STATE entries of the same mix (every offer
   with an ID of its own) plus the network root account: buckets written
   and adopted as in L1, `assume_state` at LEDGER_START, then
   `apply_buckets` into a `LedgerTxnRoot` over sqlite `:memory:` (the
   twin: its own list over the same buckets, the in-memory root) and
   `set_last_closed_ledger` on a header that commits to the list. The
   commitment's first root follows, one launch per planned chunk. Prints
   the restore's seconds split into generation, buckets and apply;
C2. three closes build the senders as `replay_bench` does: the root
   creates 200 in two 100-operation transactions, then one close arms
   them (senders 0-99: 19 more signers and a medium threshold of 20;
   100-199: one more signer and 2);
C3. 64 closes of 100 payments, each signed by 20 keys, every 7th with one
   signature corrupted, each run as a node runs it:
   `TxSetFrame.trim_invalid` (the herder's call), a StellarValue over the
   trimmed set, `LedgerManager.value_externalized`. Checks: the trimmed
   transactions are the corrupted ones on both sides; one verify launch
   per validation (one prewarm of 2,000 triples at the 2,048 bucket) and
   none in a close; SHA-256 launches per close as derived from the bucket
   list alone (L3's rule); lcl_hash, every result pair, the bucket-list
   hash and the commitment root equal to the twin's after every close.
   Prints validation p50/p99 and sigs/s, `ledger.ledger.close` p50/p99,
   the close's spans per close, and the card's busy share from a replay
   of the validations' prewarm drains with only CUDA activity profiled;
C4. 32 closes of 100 two-signature payments between disjoint partner
   pairs (the standard mix's payments), with the same checks and prints;
C5. a cold close: one C3-shaped set validated on the card, the verify
   cache flushed, then closed, so each transaction's first signature
   check launches the kernel: the launches equal the transactions left
   after trimming, decisions and lcl_hash equal the twin's, and the root
   equals `from_scratch_root`. Prints the close's time beside C3's.

Catchup (the port's work scheduler, history publish and catchup over
the close path), each phase driven with the counts set to 0 just before
it and read just after. Every node is a port node wired as the
reference's Application wires one (sqlite in a file, a bucket directory,
the persistent state's local HAS, a local-directory archive reached
through `ProcessManager`); every card node runs `make_verifier` and
`make_hasher("cuda-resilient")` (no fallback) from an empty verify cache:

R1. a CPU node (the C verifier, `make_hasher("cpu")`) closes the history
   through `value_externalized`, each set validated by `trim_invalid` as
   in C2/C3: ledger 2 funds 100 senders in one 100-operation transaction,
   ledger 3 arms them (19 more signers, a medium threshold of 20), and
   ledgers 4-131 carry 100 payments to the root, each signed by 20 keys
   (`replay_bench`'s multisig mix at pubnet's checkpoint frequency, 64).
   Checkpoints 63 and 127 publish; the archive's layout is checked as
   `test_catchup.py::test_publish_layout` checks it (the HAS, the four
   categories, every bucket it names). Prints the closes' p50, the
   publishes' seconds and the archive's bytes. This node is the oracle of
   R2-R5;
R2. a fresh card node catches up complete: SUCCESS at 127; every ledger's
   hash, the bucket-list hash and the commitment root equal the
   publisher's; the verify launches per drain equal the count derived
   from the archive alone (checkpoint 63's master-key drain, its re-drain
   after ledger 3 adds the signers, checkpoint 127's drain: 1, 14 and 16
   launches), none inside a replayed close; every distinct triple
   verified on the card exactly once and none on the CPU; SHA-256
   launches per close as derived from the bucket list (L3's rule).
   Prints ledgers/s, transactions/s and signatures/s end to end, each
   checkpoint's spans (`catchup.load_files`, `catchup.txset_parse`,
   `catchup.sig_prep`, `crypto.verify_many`, the mean
   `catchup.apply_ledger`), the drains' sigs/s, the full collections, and
   the card's busy share over the drains from a profiled replay of them;
R3. a node restarted over R2's SQL file, bucket directory and persistent
   state: LCL 127 and a bucket list that hashes to its header's; the
   commitment's first root, computed on the card, equals the
   publisher's; it closes value 128 cold (one verify launch a
   transaction) to the publisher's hash;
R4. a fresh card node at genesis, configured to catch up the last
   checkpoint (CATCHUP_RECENT 64: a minimal catchup to a checkpoint tip
   would apply buckets at 127 and replay nothing), hears values 128-131:
   it enters LM_CATCHING_UP_STATE with 4 values buffered, applies the
   buckets at 63, replays 64-127 behind one 16-launch drain, then closes
   128-131 from the buffer, cold (one launch a transaction), and ends
   synced at 131 with the publisher's hash. Prints the bucket-apply's
   seconds and the replay's ledgers/s;
R5. faults, each on a fresh card node over its own copy of the archive,
   as R4 catches up: (a) one byte of checkpoint 127's ledger file
   flipped: VerifyLedgerChainWork fails, nothing is applied or launched;
   (b) one byte of the first signature of ledger 64's first transaction
   flipped in the transactions file: the catchup fails at 64 (its value
   no longer matches the set), LCL 63, and the card's decision on the
   flipped triple is False, as the C verifier's; (c) `device.dispatch`
   fires in checkpoint 127's drain: the drain raises, the catchup fails
   at LCL 63 (a failed checkpoint is not retried), the resilient layer's
   meter counts it, nothing is verified on the CPU.
   (`verify.device-lost` would not fail it: on one card the fleet has one
   member, whose loss the fault point leaves alone, and on more members
   it degrades the fleet.) Times nothing.

It prints the card's name and power limit, the build time, both kernels'
ptxas reports (registers, stack frame, spills, shared memory; each from
the log of the build that made its library, marked when that build was
an earlier process's), the verify kernel's product count per verify
beside the bound's, both kernels' SASS opcode counts (cuobjdump, where
the toolkit has it) and, for the SHA-256 kernel, each warp role's loop
per block (instructions, ptxas's stall clocks, opcodes), the
kernels' times, the paths' throughput and latency, their host layers
timed alone, the profiled drains' device busy share, a
`{"kernels": [...]}` line (three entries; the ed25519_verify entry's
launches are the verify main path's, C2-C5's and R2-R5's, the sha256
entry's the hash main path's, L2-L4's, C1-C5's and R2-R5's, each split
in `launches_by_path`, R2-R5 under `catchup`)
and, last,
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
# the close phases (C1-C5): a state of CLOSE_STATE entries of the same mix
# plus the network root account, restored at LEDGER_START through the
# bucket applicator (2^18: at 2^19 C1 took 95.0 s on an H100's host, over
# the 90 s a restore is given here); CLOSE_SENDERS senders, the first
# CLOSE_TXS with CLOSE_SIGS signatures a payment (replay_bench's
# txs_per_ledger=100, sigs_per_tx=20, bench.py:339-341), the rest with 2;
# C3_CLOSES closes of the multisig mix, C4_CLOSES of the standard mix's
# payments; every CLOSE_CORRUPT_EVERY-th payment carries a corrupted
# signature.
CLOSE_STATE = 1 << 18
GENESIS_TOTAL_COINS = 10 ** 17
CLOSE_MAX_TX_SET_SIZE = 10_000
CLOSE_SENDERS, CLOSE_TXS, CLOSE_SIGS = 200, 100, 20
C3_CLOSES, C4_CLOSES = 64, 32
CLOSE_CORRUPT_EVERY = 7
# the catchup phases (R1-R5): replay_bench's multisig mix (bench.py:339-470,
# CLOSE_TXS transactions a ledger with CLOSE_SIGS signatures each) at
# pubnet's checkpoint frequency of 64 (history/checkpoints.py:11) instead
# of the bench's 8. Ledger 2 funds CLOSE_TXS senders, ledger 3 arms them,
# every later ledger up to R_TOP carries their multisig payments; the
# checkpoints up to R_TIP are published and the values after it kept for
# R3 and R4. R4 catches up the last checkpoint (R_RECENT ledgers) over
# the bucket list of the one before it. The network is LEDGER_NETWORK_ID's.
R_FREQ = 64
R_TIP = 2 * R_FREQ - 1
R_TOP = R_TIP + 4
R_RECENT = R_FREQ
R_PASSPHRASE = "Test SDF Network ; September 2015"


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
        triples.append((sk.public_key.key_bytes, bytes(sig), msg))
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
    from stellar_core_tpu_torch import xdr as X
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
        futs = [v.enqueue(X.PublicKey.ed25519(k), sg, m)
                for (k, sg, m) in burst]
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


def ledger_state(rng, bucket_dir: str, card: str, n: int = LEDGER_STATE,
                 extra=(), phase: str = "L1") -> dict:
    """L1 (and C1): `n` live entries of the testing/entries.py mix as the
    port's BucketEntry objects, in canonical order (one numpy sort of the
    bodies' identity prefixes), split into the deep levels' curr buckets
    (DEEP_LEVEL_ENTRIES, the rest in level 10), adopted through a
    BucketManager with background merges over `bucket_dir`, then restored
    with assume_state at LEDGER_START. Every offer has an ID of its own
    (C1's SQL root keys offers by ID alone); the LedgerEntry objects of
    `extra` join level 4's bucket."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.bucket import BucketManager, K_NUM_LEVELS
    from stellar_core_tpu_torch.bucket.bucket import (
        Bucket, bucket_entry_sort_key,
    )
    from stellar_core_tpu_torch.testing import entries as TE
    zero = b"\x00" * 32
    t0 = time.perf_counter()
    records = TE.unique_offer_ids(TE.entry_records(rng, n))
    order = TE.canonical_order(records)
    level = np.full(n, K_NUM_LEVELS - 1)
    pick = rng.permutation(n)
    k = 0
    for lv, m in sorted(DEEP_LEVEL_ENTRIES.items()):
        level[pick[k:k + m]] = lv
        k += m
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
        if lv == 4 and extra:
            ents = sorted(ents + [X.BucketEntry.live(e) for e in extra],
                          key=bucket_entry_sort_key)
        t2 = time.perf_counter()
        b = mgr.adopt_bucket(Bucket([X.BucketEntry.meta(LEDGER_PROTOCOL)]
                                    + ents))
        t_hash += time.perf_counter() - t2
        t_decode += t2 - t1
        check(b.path is not None and os.path.exists(b.path),
              "%s: level %d's bucket is written to the bucket directory"
              % (phase, lv))
        live.extend(e.value for e in ents)
        by_level[lv] = b
        hashes.append({"curr": b.get_hash(), "snap": zero})
    del records
    mgr.assume_state(hashes, LEDGER_START, LEDGER_PROTOCOL)
    setup_s = time.perf_counter() - t0
    bl = mgr.bucket_list
    check(all(lev.curr is by_level.get(i, lev.curr) and lev.snap.is_empty()
              and lev.next.is_clear() for i, lev in enumerate(bl.levels)),
          "%s: assume_state restored every level, no merge to restart"
          % phase)
    check(sum(len(b.payload_entries()) for b in by_level.values())
          == len(live) == n + len(extra), "%s: %d live entries"
          % (phase, n + len(extra)))
    deep = by_level[K_NUM_LEVELS - 1].entries
    for i in rng.integers(1, len(deep) - 1, 2000).tolist():
        check(bucket_entry_sort_key(deep[i]) < bucket_entry_sort_key(
            deep[i + 1]), "%s: the deep bucket is in canonical order" % phase)
    log("%s state (%s): %d live entries at ledger %d in %.1f s (generate + "
        "sort %.1f s, decode %.1f s, bucket hash + file %.1f s); levels "
        "%s; level 10 holds %d; bucket-list hash %s"
        % (phase, card, n + len(extra), LEDGER_START, setup_s, t_gen - t0,
           t_decode,
           t_hash, json.dumps({str(k): len(b) - 1
                               for k, b in sorted(by_level.items())}),
           len(deep) - 1, mgr.get_hash().hex()[:16]))
    return {"mgr": mgr, "live": live, "deep": deep, "setup_s": setup_s,
            "generate_s": t_gen - t0, "decode_s": t_decode,
            "bucket_s": t_hash}


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


# --- the close phases (C1-C5): LedgerManager closes over a restored state --

def close_side(mgr, verifier, hasher, sql: bool, root_sk, node_seed,
               metrics=None, tracer=None, recorder=None):
    """A port LedgerManager over `mgr`, closing through `verifier` and
    `hasher`, with its own StateCommitmentEngine, on a LedgerTxnRoot over
    sqlite `:memory:` (`sql`) or the in-memory root."""
    from types import SimpleNamespace
    from stellar_core_tpu_torch.database.database import Database
    from stellar_core_tpu_torch.ledger import state_commitment as SC
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerManager
    cfg = SimpleNamespace(
        DATABASE="sqlite3://:memory:" if sql else "in-memory",
        LEDGER_PROTOCOL_VERSION=LEDGER_PROTOCOL,
        GENESIS_TOTAL_COINS=GENESIS_TOTAL_COINS,
        TESTING_UPGRADE_DESIRED_FEE=100, TESTING_UPGRADE_RESERVE=5_000_000,
        TESTING_UPGRADE_MAX_TX_SET_SIZE=CLOSE_MAX_TX_SET_SIZE,
        network_id=LEDGER_NETWORK_ID, NODE_SEED=node_seed,
        STATE_CHECKPOINT_INTERVAL=CHECKPOINT_EVERY)
    app = SimpleNamespace(
        config=cfg, network_root_key=lambda: root_sk, sig_verifier=verifier,
        batch_hasher=hasher, bucket_manager=mgr,
        database=Database() if sql else None, metrics=metrics,
        tracer=tracer, flight_recorder=recorder)
    app.state_commitment = SC.StateCommitmentEngine(app)
    return LedgerManager(app)


def fresh_slots(S, SC, st: dict, bl) -> int:
    """SHA-256 launches the card's commitment owes for the list's current
    slots: one per 4,096-lane chunk of the leaves of each bucket whose
    hash changed since the previous close and was never seen before,
    decided from the bucket list alone, as L3 decides them."""
    slots = list_slots(bl)
    fresh = {}
    for prev, b in zip(st["slot_hashes"], slots):
        bh = b.get_hash()
        if bh == prev or bh == SC.ZERO_HASH or bh in st["seen"]:
            continue
        fresh[bh] = b
    st["slot_hashes"] = [b.get_hash() for b in slots]
    st["seen"].update(st["slot_hashes"])
    return sum(bucket_launches(S, st["hasher"].inner, b)
               for b in fresh.values())


class GcPauses:
    """Full (generation 2) collections of the cyclic garbage collector
    while it is entered: their count and each one's ms, from
    `gc.callbacks`."""

    def __enter__(self):
        import gc
        self.ms, self._t0 = [], None
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms.append((time.perf_counter() - self._t0) * 1e3)
            self._t0 = None

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._cb)
        return False

    def line(self) -> str:
        return ("%d full collections, %.1f ms in all, the longest %.1f ms"
                % (len(self.ms), sum(self.ms), max(self.ms, default=0.0)))


def close_round(S, E, K, SC, st: dict, blobs: list, corrupted: set,
                prewarm: bool = True) -> dict:
    """One ledger on the card's LedgerManager and on its CPU twin, as a
    node runs it: TxSetFrame.trim_invalid through the side's verifier
    (the herder's call), a StellarValue over the trimmed set, then
    value_externalized. Each side starts from an empty verify cache (they
    share the process's). Without `prewarm` the cache is flushed again
    between the card's validation and its close. Checks: the removed
    transactions are the corrupted ones on both sides; the card's verify
    launches are as derived from the set (one prewarm batch for two or
    more transactions, else one per transaction, and none in the close,
    or one per transaction in a cold close); its SHA-256 launches are as
    derived from the bucket list; and lcl_hash, each result pair, the
    bucket-list hash and the commitment root equal the twin's."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.herder.txset import TxSetFrame
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerCloseData
    from stellar_core_tpu_torch.transactions.transaction_frame import (
        TransactionFrame,
    )
    out = {}
    for side in ("card", "twin"):
        lm = st[side]
        frames = [TransactionFrame.make_from_wire(
            LEDGER_NETWORK_ID, X.TransactionEnvelope.from_xdr(b))
            for b in blobs]
        ts = TxSetFrame(LEDGER_NETWORK_ID, lm.lcl_hash, frames)
        K.flush_verify_cache()
        e0 = E.LAUNCHES
        t0 = time.perf_counter()
        removed = ts.trim_invalid(lm.ltx_root(), lm.app.sig_verifier)
        val_ms = (time.perf_counter() - t0) * 1e3
        e_val = E.LAUNCHES - e0
        if not prewarm:
            K.flush_verify_cache()
        header = lm.root.get_header()
        seq = header.ledgerSeq + 1
        value = X.StellarValue(
            txSetHash=ts.get_contents_hash(hasher=lm.app.batch_hasher),
            closeTime=header.scpValue.closeTime + 1,
            upgrades=[], ext=X.StellarValueExt(0, None))
        e0, s0 = E.LAUNCHES, S.LAUNCHES
        t0 = time.perf_counter()
        lm.value_externalized(LedgerCloseData(seq, ts, value))
        close_ms = (time.perf_counter() - t0) * 1e3
        check(lm.last_closed_ledger_num() == seq, "close %d applied" % seq)
        applied = ts.sort_for_apply()
        out[side] = {
            "hashes": {f.contents_hash() for f in frames},
            "removed": sorted(f.contents_hash() for f in removed),
            "val_ms": val_ms, "close_ms": close_ms, "e_val": e_val,
            "e_close": E.LAUNCHES - e0, "s_close": S.LAUNCHES - s0,
            "lcl": lm.lcl_hash,
            "results": [f.result_pair_xdr() for f in applied],
            "bucket_list": lm.app.bucket_manager.get_hash(),
            "root": lm.app.state_commitment.root, "txs": len(applied)}
        if side == "card":
            want_s = fresh_slots(S, SC, st, lm.app.bucket_manager.bucket_list)
    card, twin = out["card"], out["twin"]
    want_removed = sorted(card.pop("hashes") & corrupted)
    check(card["removed"] == twin["removed"] == want_removed,
          "close %d: the trimmed transactions are the %d corrupted ones"
          % (seq, len(want_removed)))
    n = len(blobs)
    want_val = 1 if n > 1 else n
    want_close = 0 if prewarm else n - len(want_removed)
    check(card["e_val"] == want_val and card["e_close"] == want_close,
          "close %d: verify launches %d in validation, %d in the close "
          "(got %d, %d)" % (seq, want_val, want_close, card["e_val"],
                            card["e_close"]))
    check(card["s_close"] == want_s, "close %d: %d SHA-256 launches as "
          "derived from the bucket list (got %d)"
          % (seq, want_s, card["s_close"]))
    check(twin["e_val"] == twin["e_close"] == twin["s_close"] == 0,
          "close %d: the twin launched nothing" % seq)
    for k in ("lcl", "results", "bucket_list", "root"):
        check(card[k] == twin[k], "close %d: the card's %s == the twin's"
              % (seq, k))
    card["seq"] = seq
    card["twin_val_ms"], card["twin_close_ms"] = twin["val_ms"], \
        twin["close_ms"]
    return card


class CloseTraffic:
    """The reference bench's senders (`replay_bench`, bench.py:339-468)
    built with the port's TestAccount against the card side's state:
    `senders` senders (CLOSE_SENDERS), the first CLOSE_TXS armed with 19
    extra signers and a medium threshold of 20, the rest with one extra
    signer and a threshold of 2. Every key comes from SecretKey.from_seed;
    every `corrupt_every`-th payment (CLOSE_CORRUPT_EVERY; 0 for none) has
    one signature corrupted."""

    def __init__(self, lm, root_sk, senders: int = CLOSE_SENDERS,
                 corrupt_every: int = CLOSE_CORRUPT_EVERY):
        from stellar_core_tpu_torch import testing as T
        from stellar_core_tpu_torch.crypto.keys import SecretKey
        from stellar_core_tpu_torch.xdr import LedgerKey

        class Shim:
            network_id = LEDGER_NETWORK_ID

            def header(self):
                return lm.root.get_header()

            def seq_num(self, account_id):
                e = lm.root.get_entry(LedgerKey.account(account_id))
                return e.data.value.seqNum if e is not None else 0

        shim = Shim()
        self.root = T.TestAccount(shim, root_sk)
        self.senders = [T.TestAccount(shim, SecretKey.from_seed(
            bytes([7, i & 0xFF] + [11] * 30))) for i in range(senders)]
        self.extra = [[SecretKey.from_seed(bytes([201 + j, i & 0xFF]
                                                 + [7] * 30))
                       for j in range((CLOSE_SIGS if i < CLOSE_TXS else 2)
                                      - 1)]
                      for i in range(senders)]
        self.corrupt_every = corrupt_every
        self.corrupted = set()
        self.k = 0

    def fund(self, lo: int) -> list:
        r = self.root
        return [r.tx([r.op_create_account(s.account_id, 10 ** 10)
                      for s in self.senders[lo:lo + CLOSE_TXS]])
                .envelope_bytes()]

    def arm(self) -> list:
        return [s.tx([s.op_add_signer(k.public_key.key_bytes) for k in ks]
                     + [s.op_set_options(med=len(ks) + 1)]).envelope_bytes()
                for s, ks in zip(self.senders, self.extra)]

    def _signed(self, s, ks, dest, amount):
        f = s.tx([s.op_payment(dest, amount)], extra_signers=ks)
        self.k += 1
        if self.corrupt_every and self.k % self.corrupt_every == 0:
            ds = f.signatures[1 + self.k % len(ks)]
            ds.signature = ds.signature[:9] + bytes(
                [ds.signature[9] ^ 0x10]) + ds.signature[10:]
            self.corrupted.add(f.contents_hash())
        return f.envelope_bytes()

    def multisig(self, rnd: int) -> list:
        """CLOSE_TXS payments to the root, each signed by CLOSE_SIGS keys
        (the multisig mix). The amount varies by round so that a trimmed
        payment's successor, which reuses its sequence number, does not
        reuse its contents hash."""
        return [self._signed(s, self.extra[i], self.root.account_id,
                             1000 + rnd)
                for i, s in enumerate(self.senders[:CLOSE_TXS])]

    def standard(self, rnd: int) -> list:
        """Two-signature payments between disjoint partner pairs (the
        standard mix's payments, bench.py:457-468)."""
        pay = self.senders[CLOSE_TXS:]
        return [self._signed(s, self.extra[CLOSE_TXS + i],
                             pay[i ^ 1].account_id, 1000 + rnd)
                for i, s in enumerate(pay)]


def close_path(S, E, K, rng, flight_dir: str, card: str) -> dict:
    """C1-C5 of the module docstring; returns the launches by phase."""
    from stellar_core_tpu_torch import testing as T
    from stellar_core_tpu_torch.bucket import BucketManager, apply_buckets
    from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
    from stellar_core_tpu_torch.crypto.batch_verifier import make_verifier
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.ledger import state_commitment as SC
    from stellar_core_tpu_torch.transactions.account_helpers import (
        make_account_entry,
    )
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.tracing import FlightRecorder, Tracer
    out = {"verify": {}, "sha256": {}}
    root_sk = T.root_secret_key(LEDGER_NETWORK_ID)
    node_seed = SecretKey(rng.bytes(32))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_close_") as bdir:
        # --- C1 ------------------------------------------------------------
        E.LAUNCHES = S.LAUNCHES = 0
        t0 = time.perf_counter()
        st = ledger_state(rng, bdir, card, n=CLOSE_STATE, phase="C1",
                          extra=[make_account_entry(
                              root_sk.public_key, GENESIS_TOTAL_COINS, 0,
                              LEDGER_START)])
        mgr = st.pop("mgr")
        st.pop("live")
        st.pop("deep")
        slots = list_slots(mgr.bucket_list)
        # the twin's list holds the same bucket objects, in memory only
        twin_mgr = BucketManager(None, background_merges=True)
        for b in slots:
            twin_mgr.adopt_bucket(b)
        twin_mgr.assume_state(
            [{"curr": lev.curr.get_hash(), "snap": lev.snap.get_hash()}
             for lev in mgr.bucket_list.levels], LEDGER_START,
            LEDGER_PROTOCOL)
        check(twin_mgr.get_hash() == mgr.get_hash(),
              "C1: the twin's bucket list == the card's")
        reg = MetricsRegistry()
        tr = Tracer()
        rec = FlightRecorder(tr, metrics=reg, out_dir=flight_dir)
        v = make_verifier("cuda-resilient", metrics=reg, tracer=tr,
                          flight_recorder=rec)
        h = make_hasher("cuda-resilient", metrics=reg, tracer=tr,
                        flight_recorder=rec)
        check(v.fallback is None and h.fallback is None,
              "C1: the card's stacks have no fallback")
        lm = close_side(mgr, v, h, True, root_sk, node_seed, metrics=reg,
                        tracer=tr, recorder=rec)
        twin = close_side(twin_mgr, make_verifier("cpu"),
                          make_hasher("cpu"), False, root_sk, node_seed)
        # the downloaded header the restore fast-forwards to
        header = ledger_header(X, LEDGER_START, b"\x00" * 32)
        header.maxTxSetSize = CLOSE_MAX_TX_SET_SIZE
        header.totalCoins = GENESIS_TOTAL_COINS
        header.bucketListHash = mgr.get_hash()
        header.idPool = CLOSE_STATE     # above every restored offer's ID
        for side in (lm, twin):
            side.root.set_header(X.LedgerHeader.from_xdr(header.to_xdr()))
        t1 = time.perf_counter()
        n_applied = apply_buckets(lm.root, slots)
        apply_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        apply_buckets(twin.root, slots)
        twin_apply_s = time.perf_counter() - t1
        check(n_applied == lm.root.count_entries() == CLOSE_STATE + 1
              == twin.root.count_entries(),
              "C1: %d entries applied into each root (%d, %d, %d)" % (
                  CLOSE_STATE + 1, n_applied, lm.root.count_entries(),
                  twin.root.count_entries()))
        for side in (lm, twin):
            side.set_last_closed_ledger(
                X.LedgerHeader.from_xdr(header.to_xdr()),
                sha256(header.to_xdr()))
        check(lm.lcl_hash == twin.lcl_hash and
              lm.lcl_header.bucketListHash == mgr.get_hash(),
              "C1: both LCLs at the restored header")
        restore_s = st["setup_s"] + apply_s
        wall_s = time.perf_counter() - t0
        check(S.LAUNCHES == 0 and E.LAUNCHES == 0,
              "C1's restore launches nothing")
        # the commitment's first root, as a restarted node computes it
        st.update(hasher=h, seen=set(),
                  slot_hashes=[SC.ZERO_HASH] * len(slots))
        want = fresh_slots(S, SC, st, mgr.bucket_list)
        t1 = time.perf_counter()
        root = lm.app.state_commitment.update_root(mgr.bucket_list)
        first_ms = (time.perf_counter() - t1) * 1e3
        check(root == twin.app.state_commitment.update_root(
            twin_mgr.bucket_list), "C1: the first commitment root == the "
            "twin's")
        check(S.LAUNCHES == want > 0 and E.LAUNCHES == 0,
              "C1: %d SHA-256 launches for the first root" % want)
        out["sha256"]["C1"] = S.LAUNCHES
        out["restore_s"] = restore_s
        log("C1 restore (%s): %d entries in %.1f s: generation %.1f s, "
            "buckets %.1f s (decode %.1f, hash + file %.1f), apply_buckets "
            "into a LedgerTxnRoot over sqlite :memory: %.1f s (%.1f us an "
            "entry); with the twin's list and in-memory root (%.1f s) %.1f "
            "s; first commitment root %.1f ms in %d launches"
            % (card, CLOSE_STATE + 1, restore_s, st["generate_s"],
               st["setup_s"] - st["generate_s"], st["decode_s"],
               st["bucket_s"], apply_s, apply_s / (CLOSE_STATE + 1) * 1e6,
               twin_apply_s, wall_s, first_ms, S.LAUNCHES))
        st.update(card=lm, twin=twin)
        traffic = CloseTraffic(lm, root_sk)

        # --- C2 ------------------------------------------------------------
        E.LAUNCHES = S.LAUNCHES = 0
        c2 = [close_round(S, E, K, SC, st, traffic.fund(lo), set())
              for lo in range(0, CLOSE_SENDERS, CLOSE_TXS)]
        c2.append(close_round(S, E, K, SC, st, traffic.arm(), set()))
        out["verify"]["C2"], out["sha256"]["C2"] = E.LAUNCHES, S.LAUNCHES
        log("C2 senders (%s): %d closes (%s txs), %d verify and %d SHA-256 "
            "launches, close ms %s"
            % (card, len(c2), "/".join(str(c["txs"]) for c in c2),
               E.LAUNCHES, S.LAUNCHES,
               " ".join("%.1f" % c["close_ms"] for c in c2)))

        # --- C3 and C4 -----------------------------------------------------
        recorded = []
        pw = v.prewarm_many

        def recording_prewarm(triples):
            got = pw(triples)
            recorded.append((list(triples), got))
            return got

        for phase, closes, build in (
                ("C3", C3_CLOSES, traffic.multisig),
                ("C4", C4_CLOSES, traffic.standard)):
            timer = reg.new_timer("ledger.ledger.close")
            n0 = timer.count
            tr.clear()
            tr.enable(capacity=65536)
            recorded.clear()
            v.prewarm_many = recording_prewarm
            E.LAUNCHES = S.LAUNCHES = 0
            t0 = time.perf_counter()
            with GcPauses() as gcp:
                rounds = [close_round(S, E, K, SC, st, build(k),
                                      traffic.corrupted)
                          for k in range(closes)]
            wall_s = time.perf_counter() - t0
            v.prewarm_many = pw
            tr.disable()
            out["verify"][phase], out["sha256"][phase] = \
                E.LAUNCHES, S.LAUNCHES
            check(timer.count - n0 == closes,
                  "%s: ledger.ledger.close sampled once a close" % phase)
            close_s = list(timer._samples[n0:n0 + closes])
            val = [c["val_ms"] for c in rounds]
            sigs = sum(len(t) for t, _g in recorded)
            pb = tr.phase_breakdown(wall_s=wall_s)
            spans = {k: pb["phases"][k]["total_s"] * 1e3 / closes
                     for k in ("close.apply", "close.result_hash",
                               "close.bucket_add", "close.commitment",
                               "close.sql_commit", "close.txset_sort",
                               "close.commit", "close.header_hash")
                     if k in pb["phases"]}
            log("%s %d closes of %d txs (%s): %d trimmed (the corrupted); "
                "validation p50 %.1f ms, p99 %.1f ms, %.0f sigs/s over %d "
                "prewarmed signatures; ledger.ledger.close p50 %.1f ms, p99 "
                "%.1f ms (p99 of %d samples is their maximum); the twin's "
                "validation p50 %.1f ms, close p50 %.1f ms; launches: verify "
                "%d, SHA-256 %d; wall %.1f s"
                % (phase, closes, len(rounds[0]["results"]) +
                   len(rounds[0]["removed"]), card,
                   sum(len(c["removed"]) for c in rounds),
                   float(np.percentile(val, 50)), p99(val),
                   sigs / (sum(val) / 1e3), sigs,
                   float(np.percentile(close_s, 50)) * 1e3,
                   p99(close_s) * 1e3, len(close_s),
                   float(np.percentile([c["twin_val_ms"] for c in rounds],
                                       50)),
                   float(np.percentile([c["twin_close_ms"] for c in rounds],
                                       50)),
                   E.LAUNCHES, S.LAUNCHES, wall_s))
            log("%s close spans, exclusive ms per close: %s; every span: %s"
                % (phase, ", ".join("%s %.2f" % kv for kv in sorted(
                    spans.items(), key=lambda kv: -kv[1])), phases_line(pb)))
            log("%s garbage collector over the %d closes (both sides and "
                "the transactions' building): %s; validations over 1 s: %s; "
                "closes over 1 s: %s"
                % (phase, closes, gcp.line(),
                   [round(x, 1) for x in val if x > 1e3],
                   [round(x * 1e3, 1) for x in close_s if x > 1.0]))
            # the card's busy share: the validations' prewarm drains
            # replayed from an empty cache, CUDA activity only
            l0 = E.LAUNCHES
            prof = profile_drain(
                lambda: [(K.flush_verify_cache(), pw(t))[1]
                         for t, _g in recorded],
                "ed25519_verify_kernel", cpu=False)
            check(prof["result"] == [g for _t, g in recorded]
                  and E.LAUNCHES - l0 == len(recorded),
                  "%s replay: the same decisions in %d launches"
                  % (phase, len(recorded)))
            log_profile("%s replay of the %d validations' prewarm drains "
                        "(CUDA activity only)" % (phase, len(recorded)),
                        prof, "ed25519_verify_kernel")
            if prof["device_events"]:
                log("%s card busy %.3f ms over the validations' %.1f ms = "
                    "%.2f%%" % (phase, prof["busy_ms"], sum(val),
                                100.0 * prof["busy_ms"] / sum(val)))
            out[phase] = {"val_ms": val, "close_ms": [x * 1e3
                                                      for x in close_s],
                          "sigs_per_s": sigs / (sum(val) / 1e3)}

        # --- C5 ------------------------------------------------------------
        E.LAUNCHES = S.LAUNCHES = 0
        c5 = close_round(S, E, K, SC, st, traffic.multisig(C3_CLOSES),
                         traffic.corrupted, prewarm=False)
        out["verify"]["C5"], out["sha256"]["C5"] = E.LAUNCHES, S.LAUNCHES
        log("C5 cold close (%s): %d txs after trimming %d, the verify cache "
            "flushed between validation and close: %d launches in the close "
            "(one per transaction), close %.1f ms against C3's p50 %.1f ms"
            % (card, c5["txs"], len(c5["removed"]), c5["e_close"],
               c5["close_ms"], float(np.percentile(out["C3"]["close_ms"],
                                                   50))))
        sce = lm.app.state_commitment
        t0 = time.perf_counter()
        check(sce.root == sce.from_scratch_root(mgr.bucket_list),
              "C5: the commitment root == from_scratch_root")
        log("C5 from_scratch_root over the final list: %.1f s"
            % (time.perf_counter() - t0))
        for m in (mgr, twin_mgr):
            m.shutdown()
    return out


# --- the catchup phases (R1-R5): publish, catch up on the card, restart --

def r_node(tmp: str, name: str, archive: str, verifier, hasher,
           writable: bool = False, recent: int = 0, metrics=None,
           tracer=None, recorder=None, faults=None):
    """A started port node, wired as the reference's Application wires
    one (`main/application.py` is not ported): sqlite in `tmp`/`name`.db,
    buckets in `tmp`/`name`-buckets (so a second node of the same name
    restarts over the first one's files), the local-directory archive
    `archive`, and the verifier and hasher it is handed. Like
    `Application.start`, it restores the last known ledger or starts a
    new one. `recent` > 0 makes a gap's catchup a recent one of that many
    ledgers (minimal otherwise)."""
    from types import SimpleNamespace
    from stellar_core_tpu_torch.bucket import BucketManager
    from stellar_core_tpu_torch.catchup.catchup_manager import CatchupManager
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.database.database import Database
    from stellar_core_tpu_torch.history.archive import HistoryArchive
    from stellar_core_tpu_torch.history.history_manager import HistoryManager
    from stellar_core_tpu_torch.ledger import state_commitment as SC
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerManager
    from stellar_core_tpu_torch.main.config import Config
    from stellar_core_tpu_torch.main.persistent_state import PersistentState
    from stellar_core_tpu_torch.process.process_manager import ProcessManager
    from stellar_core_tpu_torch.util.faults import FaultInjector
    from stellar_core_tpu_torch.util.status_manager import StatusManager
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    from stellar_core_tpu_torch.work.scheduler import WorkScheduler
    db_file = os.path.join(tmp, name + ".db")
    cfg = Config()
    cfg.NETWORK_PASSPHRASE = R_PASSPHRASE
    cfg.NODE_SEED = SecretKey.from_seed(sha256(name.encode()))
    cfg.DATABASE = "sqlite3://" + db_file
    cfg.CHECKPOINT_FREQUENCY = R_FREQ
    cfg.CATCHUP_RECENT = recent
    cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE = CLOSE_MAX_TX_SET_SIZE
    arch = HistoryArchive.local_dir("r", archive)
    cfg.HISTORY = {"r": {"get": arch.get_tmpl, "mkdir": arch.mkdir_tmpl}}
    if writable:
        cfg.HISTORY["r"]["put"] = arch.put_tmpl
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    db = Database(db_file, metrics)
    app = SimpleNamespace(
        clock=clock, config=cfg, database=db,
        persistent_state=PersistentState(db), metrics=metrics,
        tracer=tracer, flight_recorder=recorder,
        faults=faults or FaultInjector(), sig_verifier=verifier,
        batch_hasher=hasher,
        bucket_manager=BucketManager(os.path.join(tmp, name + "-buckets")),
        status_manager=StatusManager(),
        network_root_key=lambda: SecretKey.from_seed(
            sha256(cfg.network_id)))
    check(cfg.network_id == LEDGER_NETWORK_ID, "R: the network's id")
    app.state_commitment = SC.StateCommitmentEngine(app)
    app.ledger_manager = LedgerManager(app)
    app.work_scheduler = WorkScheduler(clock)
    app.process_manager = ProcessManager(clock,
                                         cfg.MAX_CONCURRENT_SUBPROCESSES)
    app.history_manager = HistoryManager(app)
    app.catchup_manager = CatchupManager(app)

    def crank() -> int:
        # Application.crank: flush what the crank's handlers enqueued
        n = clock.crank(False)
        verifier.flush()
        return n

    app.crank = crank
    if not app.ledger_manager.load_last_known_ledger():
        app.ledger_manager.start_new_ledger()
    app.history_manager.publish_queued_history()
    return app


def r_crank_until(app, pred, timeout_s: float) -> bool:
    """Crank until pred(); an idle crank waits 0.5 ms for the archive's
    subprocesses to post their exit codes."""
    deadline = time.perf_counter() + timeout_s
    while not pred():
        if time.perf_counter() > deadline:
            return False
        if not app.crank():
            time.sleep(0.0005)
    return True


def r_stop(app) -> None:
    """Stop a node: its subprocesses, merges, temporary files and SQL."""
    app.process_manager.shutdown()
    app.bucket_manager.shutdown()
    app.history_manager.publish_queue_dir.remove()
    app.database.close()


def lcd_from_db(db, seq: int):
    """The value the publisher externalized for `seq`, rebuilt from its
    SQL store as consensus would hand it to another node."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.herder.txset import TxSetFrame
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerCloseData
    from stellar_core_tpu_torch.transactions.transaction_frame import (
        TransactionFrame,
    )
    header = X.LedgerHeader.from_xdr(db.execute(
        "SELECT data FROM ledgerheaders WHERE ledgerseq = ?",
        (seq,)).fetchone()[0])
    frames = [TransactionFrame.make_from_wire(
        LEDGER_NETWORK_ID, X.TransactionEnvelope.from_xdr(r[0]))
        for r in db.execute("SELECT txbody FROM txhistory WHERE "
                            "ledgerseq = ? ORDER BY txindex",
                            (seq,)).fetchall()]
    return LedgerCloseData(seq, TxSetFrame(
        LEDGER_NETWORK_ID, header.previousLedgerHash, frames),
        header.scpValue)


def r_hashes(db, lo: int, hi: int) -> dict:
    return dict(db.execute(
        "SELECT ledgerseq, ledgerhash FROM ledgerheaders WHERE ledgerseq "
        "BETWEEN ? AND ? ORDER BY ledgerseq", (lo, hi)).fetchall())


def archive_ledgers(archive: str, checkpoint: int) -> dict:
    """seq -> the signature count of each of its transactions, read from
    the archive's transactions file of `checkpoint` (gunzipped here)."""
    import gzip
    from stellar_core_tpu_torch.history.archive import category_path
    from stellar_core_tpu_torch.util.xdrstream import XDRInputFileStream
    from stellar_core_tpu_torch.xdr import TransactionHistoryEntry
    gz = os.path.join(archive, category_path("transactions", checkpoint,
                                             ".xdr.gz"))
    with tempfile.NamedTemporaryFile(suffix=".xdr") as fh:
        with gzip.open(gz, "rb") as g:
            fh.write(g.read())
        fh.flush()
        with XDRInputFileStream(fh.name) as ins:
            return {e.ledgerSeq: [len(t.value.signatures)
                                  for t in e.txSet.txs]
                    for e in ins.read_all(TransactionHistoryEntry)}


def r_drains(archive: str, first: int, chunk: int) -> list:
    """The catchup's verify drains from ledger `first` to R_TIP, derived
    from the archive alone: (signatures, launches) per drain. A
    checkpoint drains every signature whose signer exists when it starts;
    the senders' extra signers exist from ledger 3 on (its transactions
    add them), so from genesis checkpoint 63 first drains one master-key
    signature a transaction, and after ledger 3 re-drains the other
    signatures of ledgers 4-63. A drain launches once per `chunk` (the
    verifier's largest bucket) or part of one."""
    drains = []
    for c in range(R_FREQ - 1, R_TIP + 1, R_FREQ):
        if c < first:
            continue
        led = archive_ledgers(archive, c)
        if first <= 3 and 3 in led:
            drains.append(sum(len(v) for s, v in led.items()))
            drains.append(sum(n - 1 for s, v in led.items() if s > 3
                              for n in v))
        else:
            drains.append(sum(sum(v) for s, v in led.items()
                              if s >= first))
    return [(n, -(-n // chunk)) for n in drains]


R_SPANS = ("catchup.load_files", "catchup.txset_parse", "catchup.sig_prep",
           "crypto.verify_many", "catchup.apply_ledger")


def r_spans(tr) -> dict:
    """checkpoint -> span name -> (ms, count) for R_SPANS, the outermost
    span of each name only, from the tracer's spans: a span without a
    checkpoint tag belongs to the checkpoint whose files were loaded last
    before it started."""
    spans = sorted((s for s in tr.spans() if s.dur is not None),
                   key=lambda s: s.t0)
    by_sid = {s.sid: s for s in spans}
    out: dict = {}
    cur = None
    for s in spans:
        tags = s.tags or {}
        if s.name == "catchup.load_files":
            cur = tags.get("checkpoint")
        c = tags.get("checkpoint", cur)
        if s.name not in R_SPANS or c is None:
            continue
        p = by_sid.get(s.parent)
        while p is not None and p.name != s.name:
            p = by_sid.get(p.parent)
        if p is not None:
            continue
        ms, n = out.setdefault(c, {}).get(s.name, (0.0, 0))
        out[c][s.name] = (ms + s.dur * 1e3, n + 1)
    return out


def r_span_line(spans: dict) -> str:
    parts = []
    for c, d in sorted(spans.items()):
        ms, n = d.get("catchup.apply_ledger", (0.0, 0))
        parts.append("checkpoint %d: %s, catchup.apply_ledger mean %.1f ms"
                     % (c, ", ".join("%s %.1f ms" % (k, d[k][0])
                                     for k in R_SPANS[:-1] if k in d),
                        ms / max(n, 1)))
    return "; ".join(parts)


class RProbe:
    """What a card node's catchup launched, where: every drain through
    `prewarm_many` (its triples, decisions, launches and seconds), the
    triples the card's verify_many received, the verify and SHA-256
    launches inside each close (each close's SHA-256 launches against
    fresh_slots' derivation), and every call of the C verifier."""

    def __init__(self, S, E, K, SC, app):
        self.S, self.E, self.K, self.SC, self.app = S, E, K, SC, app
        # drains: the triples each sent to the card, their decisions,
        # its launches and seconds
        self.drains, self.card_triples, self.closes = [], [], {}
        self.cpu_calls, self.close_errors = [], []
        self.st = {"hasher": app.batch_hasher, "seen": set(),
                   "slot_hashes": [SC.ZERO_HASH] * 22}
        v = app.sig_verifier
        self._pw, self._vm = v.prewarm_many, v.primary.verify_many
        self._close = app.ledger_manager.close_ledger
        self._raw = (K.raw_verify, K.raw_verify_batch)

    def __enter__(self):
        S, E, K, app = self.S, self.E, self.K, self.app
        v, lm = app.sig_verifier, app.ledger_manager

        def prewarm(triples):
            e0, c0, t0 = E.LAUNCHES, len(self.card_triples), \
                time.perf_counter()
            got = self._pw(triples)
            decided = dict(zip(triples, got))
            new = self.card_triples[c0:]
            self.drains.append({"triples": new,
                                "decisions": [decided[t] for t in new],
                                "launches": E.LAUNCHES - e0,
                                "s": time.perf_counter() - t0})
            return got

        def verify_many(triples):
            self.card_triples.extend(triples)
            return self._vm(triples)

        def close(lcd):
            e0, s0, t0 = E.LAUNCHES, S.LAUNCHES, time.perf_counter()
            try:
                self._close(lcd)
            except Exception as e:
                self.close_errors.append((lcd.ledger_seq, repr(e)))
                raise
            want = fresh_slots(S, self.SC, self.st,
                               app.bucket_manager.bucket_list)
            self.closes[lcd.ledger_seq] = (
                E.LAUNCHES - e0, S.LAUNCHES - s0, want,
                time.perf_counter() - t0, t0)

        raw, raw_batch = self._raw
        v.prewarm_many, v.primary.verify_many = prewarm, verify_many
        lm.close_ledger = close
        K.raw_verify = lambda *a: self.cpu_calls.append(1) or raw(*a)
        K.raw_verify_batch = lambda t: (self.cpu_calls.append(len(t))
                                        or raw_batch(t))
        return self

    def __exit__(self, *exc):
        v = self.app.sig_verifier
        v.prewarm_many, v.primary.verify_many = self._pw, self._vm
        self.app.ledger_manager.close_ledger = self._close
        self.K.raw_verify, self.K.raw_verify_batch = self._raw
        return False

    def sha_as_derived(self) -> bool:
        return all(s == w for _e, s, w, _t, _t0 in self.closes.values())

    def close_launches(self, lo: int, hi: int) -> list:
        return [self.closes[s][0] for s in range(lo, hi + 1)]


def card_stacks(metrics, tracer, recorder, faults=None) -> tuple:
    """make_verifier and make_hasher("cuda-resilient") with the node's
    metrics, tracer and flight recorder (no CPU fallback)."""
    from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
    from stellar_core_tpu_torch.crypto.batch_verifier import make_verifier
    v = make_verifier("cuda-resilient", metrics=metrics, tracer=tracer,
                      faults=faults, flight_recorder=recorder)
    h = make_hasher("cuda-resilient", metrics=metrics, tracer=tracer,
                    flight_recorder=recorder)
    check(v.fallback is None and h.fallback is None,
          "R: the card's stacks have no fallback")
    return v, h


def r_close(app, blobs: list) -> float:
    """One close on the CPU publisher, as C2/C3 build one: the set's
    TxSetFrame.trim_invalid (nothing is removed: the R history carries no
    corrupted signature), then value_externalized; returns its ms."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.herder.txset import TxSetFrame
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerCloseData
    from stellar_core_tpu_torch.transactions.transaction_frame import (
        TransactionFrame,
    )
    lm = app.ledger_manager
    frames = [TransactionFrame.make_from_wire(
        LEDGER_NETWORK_ID, X.TransactionEnvelope.from_xdr(b)) for b in blobs]
    ts = TxSetFrame(LEDGER_NETWORK_ID, lm.lcl_hash, frames)
    check(not ts.trim_invalid(lm.ltx_root(), app.sig_verifier),
          "R1: a set loses no transaction in validation")
    header = lm.root.get_header()
    value = X.StellarValue(
        txSetHash=ts.get_contents_hash(hasher=app.batch_hasher),
        closeTime=header.scpValue.closeTime + 1, upgrades=[],
        ext=X.StellarValueExt(0, None))
    t0 = time.perf_counter()
    lm.value_externalized(LedgerCloseData(header.ledgerSeq + 1, ts, value))
    ms = (time.perf_counter() - t0) * 1e3
    check(lm.last_closed_ledger_num() == header.ledgerSeq + 1,
          "R1: close %d" % (header.ledgerSeq + 1))
    return ms


def r1_publish(S, E, K, tmp: str, card: str) -> dict:
    """R1 of the module docstring; returns the publisher and its archive."""
    from stellar_core_tpu_torch import testing as T
    from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
    from stellar_core_tpu_torch.crypto.batch_verifier import make_verifier
    from stellar_core_tpu_torch.history.archive import category_path
    from stellar_core_tpu_torch.history.archive_state import (
        HistoryArchiveState,
    )
    archive = os.path.join(tmp, "archive")
    os.makedirs(archive)
    pub = r_node(tmp, "publisher", archive, make_verifier("cpu"),
                 make_hasher("cpu"), writable=True)
    traffic = CloseTraffic(pub.ledger_manager,
                           T.root_secret_key(LEDGER_NETWORK_ID),
                           senders=CLOSE_TXS, corrupt_every=0)
    hm = pub.history_manager
    publish_s = []
    publish = hm.publish_queued_history

    def timed_publish():
        t0 = time.perf_counter()
        try:
            return publish()
        finally:
            publish_s.append(time.perf_counter() - t0)

    hm.publish_queued_history = timed_publish
    K.flush_verify_cache()
    E.LAUNCHES = S.LAUNCHES = 0
    close_ms, roots = [], {}
    t0 = time.perf_counter()
    with GcPauses() as gcp:
        for seq in range(2, R_TOP + 1):
            blobs = (traffic.fund(0) if seq == 2 else traffic.arm()
                     if seq == 3 else traffic.multisig(seq))
            close_ms.append(r_close(pub, blobs))
            roots[seq] = pub.state_commitment.root
            pub.crank()       # runs a queued checkpoint's publish
    wall = time.perf_counter() - t0
    check(hm.publish_queue() == [] and hm.published_checkpoints == 2,
          "R1: checkpoints %d and %d published" % (R_FREQ - 1, R_TIP))
    check(E.LAUNCHES == S.LAUNCHES == 0, "R1: the publisher launched "
          "nothing")
    # the archive's layout, as test_catchup.py::test_publish_layout reads it
    with open(os.path.join(archive, ".well-known",
                           "stellar-history.json")) as fh:
        has = HistoryArchiveState.from_json(fh.read())
    check(has.current_ledger == R_TIP, "R1: the archive's tip is %d" % R_TIP)
    for c in (R_FREQ - 1, R_TIP):
        for cat in ("ledger", "transactions", "results", "scp"):
            check(os.path.exists(os.path.join(
                archive, category_path(cat, c, ".xdr.gz"))),
                "R1: %s file of checkpoint %d" % (cat, c))
    for hh in has.bucket_hashes():
        check(os.path.exists(os.path.join(
            archive, "bucket", hh[0:2], hh[2:4], hh[4:6],
            "bucket-%s.xdr.gz" % hh)), "R1: bucket %s" % hh[:8])
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _s, fs in os.walk(archive) for f in fs)
    log("R1 publish (%s): a CPU node closed ledgers 2-%d (%d senders, "
        "then %d payments of %d signatures a ledger) in %.1f s; close p50 "
        "%.1f ms, p99 %.1f ms (p99 of %d samples is their maximum); "
        "publishes of checkpoints %d and %d %s s; the archive %d bytes "
        "(%d buckets named by its HAS); %s"
        % (card, R_TOP, CLOSE_TXS, CLOSE_TXS, CLOSE_SIGS, wall,
           float(np.percentile(close_ms, 50)), p99(close_ms), len(close_ms),
           R_FREQ - 1, R_TIP,
           "/".join("%.2f" % x for x in publish_s if x > 1e-3), size,
           len(has.bucket_hashes()), gcp.line()))
    header = r_header(pub, R_TIP)
    return {"pub": pub, "archive": archive, "root": roots[R_TIP],
            "bucket_list": header.bucketListHash}


def r_header(app, seq: int):
    from stellar_core_tpu_torch import xdr as X
    return X.LedgerHeader.from_xdr(app.database.execute(
        "SELECT data FROM ledgerheaders WHERE ledgerseq = ?",
        (seq,)).fetchone()[0])


def r2_complete(S, E, K, SC, tmp: str, r1: dict, flight_dir: str,
                card: str) -> dict:
    """R2 of the module docstring: a complete catchup on the card."""
    from stellar_core_tpu_torch.catchup import CatchupConfiguration
    from stellar_core_tpu_torch.crypto.batch_verifier import CudaSigVerifier
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.tracing import FlightRecorder, Tracer
    from stellar_core_tpu_torch.work.basic_work import State
    pub, archive = r1["pub"], r1["archive"]
    reg, tr = MetricsRegistry(), Tracer()
    rec = FlightRecorder(tr, metrics=reg, out_dir=flight_dir)
    v, h = card_stacks(reg, tr, rec)
    node = r_node(tmp, "r2", archive, v, h, metrics=reg, tracer=tr,
                  recorder=rec)
    want = r_drains(archive, 2, CudaSigVerifier.BUCKETS[-1])
    K.flush_verify_cache()
    E.LAUNCHES = S.LAUNCHES = 0
    tr.enable(capacity=1 << 16)
    t0 = time.perf_counter()
    with RProbe(S, E, K, SC, node) as pr, GcPauses() as gcp:
        work = node.catchup_manager.start_catchup(
            CatchupConfiguration.complete())
        check(r_crank_until(node, work.is_done, 900.0),
              "R2: the catchup finished")
    wall = time.perf_counter() - t0
    tr.disable()
    lm = node.ledger_manager
    check(work.state == State.SUCCESS and lm.is_synced()
          and lm.last_closed_ledger_num() == R_TIP,
          "R2: SUCCESS at LCL %d" % R_TIP)
    check(r_hashes(node.database, 1, R_TIP) == r_hashes(pub.database, 1,
                                                        R_TIP),
          "R2: every replayed ledger's hash == the publisher's")
    check(node.bucket_manager.get_hash() == r1["bucket_list"]
          and node.state_commitment.root == r1["root"],
          "R2: the bucket-list hash and commitment root == the "
          "publisher's at %d" % R_TIP)
    launches = [d["launches"] for d in pr.drains if d["triples"]]
    check([len(d["triples"]) for d in pr.drains if d["triples"]]
          == [n for n, _l in want] and launches == [n for _n, n in want]
          and E.LAUNCHES == sum(launches),
          "R2: verify launches per drain %s as derived from the archive "
          "(signatures, launches) %s" % (launches, want))
    check(len(pr.card_triples) == len(set(pr.card_triples)),
          "R2: every distinct triple verified on the card exactly once "
          "(%d)" % len(pr.card_triples))
    check(not any(pr.close_launches(2, R_TIP)),
          "R2: no verify launch inside a replayed close")
    check(pr.cpu_calls == [], "R2: no signature verified on the CPU")
    check(pr.sha_as_derived(), "R2: SHA-256 launches per close as derived "
          "from the bucket list (%d in all)" % S.LAUNCHES)
    ledgers = R_TIP - 1
    per_tx = [v for c in (R_FREQ - 1, R_TIP)
              for v in archive_ledgers(archive, c).values()]
    txs, sigs = sum(len(v) for v in per_tx), sum(sum(v) for v in per_tx)
    drain_n = len(pr.card_triples)
    drain_s = sum(d["s"] for d in pr.drains)
    log("R2 complete catchup (%s): %d ledgers in %.1f s = %.2f ledgers/s, "
        "%.0f transactions/s, %.0f signatures/s end to end; verify "
        "launches %d (drains %s), none in the %d replayed closes; SHA-256 "
        "launches %d; the drains %d triples in %.2f s = %.0f sigs/s; %s"
        % (card, ledgers, wall, ledgers / wall, txs / wall, sigs / wall,
           E.LAUNCHES, launches, len(pr.closes), S.LAUNCHES, drain_n,
           drain_s, drain_n / drain_s, gcp.line()))
    log("R2 spans: " + r_span_line(r_spans(tr)))
    out = {"verify": E.LAUNCHES, "sha256": S.LAUNCHES}
    # the card's busy share: the drains replayed from an empty cache
    drains = [d for d in pr.drains if d["triples"]]
    l0 = E.LAUNCHES
    prof = profile_drain(
        lambda: [(K.flush_verify_cache(), v.prewarm_many(d["triples"]))[1]
                 for d in drains], "ed25519_verify_kernel", cpu=False)
    check(prof["result"] == [d["decisions"] for d in drains]
          and E.LAUNCHES - l0 == sum(launches),
          "R2 replay: the same decisions in %d launches" % sum(launches))
    log_profile("R2 replay of the %d drains (CUDA activity only)"
                % len(drains), prof, "ed25519_verify_kernel")
    if prof["device_events"]:
        log("R2 card busy %.3f ms over the drains' %.1f ms = %.2f%%, over "
            "the catchup's %.1f s = %.3f%%"
            % (prof["busy_ms"], drain_s * 1e3,
               100.0 * prof["busy_ms"] / (drain_s * 1e3), wall,
               100.0 * prof["busy_ms"] / (wall * 1e3)))
    r_stop(node)
    return out


def r3_restart(S, E, K, SC, tmp: str, r1: dict, flight_dir: str,
               card: str) -> dict:
    """R3 of the module docstring: a node restarted over R2's files."""
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.tracing import FlightRecorder, Tracer
    pub = r1["pub"]
    reg, tr = MetricsRegistry(), Tracer()
    rec = FlightRecorder(tr, metrics=reg, out_dir=flight_dir)
    v, h = card_stacks(reg, tr, rec)
    K.flush_verify_cache()
    E.LAUNCHES = S.LAUNCHES = 0
    t0 = time.perf_counter()
    node = r_node(tmp, "r2", r1["archive"], v, h, metrics=reg, tracer=tr,
                  recorder=rec)
    restart_s = time.perf_counter() - t0
    lm, bm = node.ledger_manager, node.bucket_manager
    check(lm.last_closed_ledger_num() == R_TIP and lm.is_synced()
          and bm.get_hash() == lm.lcl_header.bucketListHash
          == r1["bucket_list"],
          "R3: load_last_known_ledger gives LCL %d and the bucket list its "
          "header commits to" % R_TIP)
    check(E.LAUNCHES == S.LAUNCHES == 0, "R3: the restart launches nothing")
    with RProbe(S, E, K, SC, node) as pr, GcPauses() as gcp:
        want = fresh_slots(S, SC, pr.st, bm.bucket_list)
        t0 = time.perf_counter()
        root = node.state_commitment.update_root(bm.bucket_list)
        root_ms = (time.perf_counter() - t0) * 1e3
        check(root == r1["root"] and S.LAUNCHES == want,
              "R3: the first commitment root, computed on the card in %d "
              "launches, == the publisher's" % want)
        lm.value_externalized(lcd_from_db(pub.database, R_TIP + 1))
    e, s, ws, close_s, _t0 = pr.closes[R_TIP + 1]
    txs = len(lcd_from_db(pub.database, R_TIP + 1).tx_set.frames)
    check(lm.lcl_hash.hex() == r_hashes(pub.database, R_TIP + 1,
                                        R_TIP + 1)[R_TIP + 1],
          "R3: ledger %d's hash == the publisher's" % (R_TIP + 1))
    check(e == txs and s == ws and pr.cpu_calls == [],
          "R3: the cold close launches verify once per transaction (%d of "
          "%d) and SHA-256 as derived (%d of %d), none on the CPU"
          % (e, txs, s, ws))
    log("R3 restart (%s): load_last_known_ledger over the SQL file and "
        "bucket directory %.2f s; the first commitment root %.1f ms in %d "
        "launches; ledger %d closed cold in %.1f ms (%d verify launches); "
        "%s" % (card, restart_s, root_ms, want, R_TIP + 1, close_s * 1e3,
                e, gcp.line()))
    r_stop(node)
    return {"verify": E.LAUNCHES, "sha256": S.LAUNCHES}


def r4_gap(S, E, K, SC, tmp: str, r1: dict, flight_dir: str,
           card: str) -> dict:
    """R4 of the module docstring: a node at genesis hears the values
    after the archive's tip."""
    from stellar_core_tpu_torch.crypto.batch_verifier import CudaSigVerifier
    from stellar_core_tpu_torch.historywork import apply_works as AW
    from stellar_core_tpu_torch.ledger.ledger_manager import (
        LedgerManagerState,
    )
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.tracing import FlightRecorder, Tracer
    pub, archive = r1["pub"], r1["archive"]
    reg, tr = MetricsRegistry(), Tracer()
    rec = FlightRecorder(tr, metrics=reg, out_dir=flight_dir)
    v, h = card_stacks(reg, tr, rec)
    node = r_node(tmp, "r4", archive, v, h, recent=R_RECENT, metrics=reg,
                  tracer=tr, recorder=rec)
    lm, cm = node.ledger_manager, node.catchup_manager
    first = R_TIP - R_RECENT + 1
    want = r_drains(archive, first, CudaSigVerifier.BUCKETS[-1])
    buffered = [lcd_from_db(pub.database, s)
                for s in range(R_TIP + 1, R_TOP + 1)]
    apply_s = []
    run = AW.ApplyBucketsWork.on_run

    def timed_apply(self):
        t0 = time.perf_counter()
        try:
            return run(self)
        finally:
            apply_s.append(time.perf_counter() - t0)

    K.flush_verify_cache()
    E.LAUNCHES = S.LAUNCHES = 0
    AW.ApplyBucketsWork.on_run = timed_apply
    t0 = time.perf_counter()
    try:
        with RProbe(S, E, K, SC, node) as pr, GcPauses() as gcp:
            for lcd in buffered:
                lm.value_externalized(lcd)
            check(lm.state == LedgerManagerState.LM_CATCHING_UP_STATE
                  and cm.buffered_count() == len(buffered)
                  and cm.catchup_running(),
                  "R4: catching up with %d values buffered"
                  % len(buffered))
            check(r_crank_until(node, lambda: not cm.catchup_running(),
                                600.0), "R4: the catchup finished")
    finally:
        AW.ApplyBucketsWork.on_run = run
    wall = time.perf_counter() - t0
    check(lm.is_synced() and lm.last_closed_ledger_num() == R_TOP
          and lm.lcl_hash.hex() == r_hashes(pub.database, R_TOP,
                                            R_TOP)[R_TOP],
          "R4: synced at %d with the publisher's hash" % R_TOP)
    check(r_hashes(node.database, first, R_TOP)
          == r_hashes(pub.database, first, R_TOP),
          "R4: every ledger from %d == the publisher's" % first)
    check(sorted(pr.closes) == list(range(first, R_TOP + 1))
          and len(apply_s) == 1,
          "R4: buckets applied once at %d, then ledgers %d-%d closed"
          % (first - 1, first, R_TOP))
    launches = [d["launches"] for d in pr.drains if d["triples"]]
    txs = [len(lcd.tx_set.frames) for lcd in buffered]
    check(launches == [n for _n, n in want]
          and not any(pr.close_launches(first, R_TIP))
          and pr.close_launches(R_TIP + 1, R_TOP) == txs
          and E.LAUNCHES == sum(launches) + sum(txs),
          "R4: verify launches: drains %s as derived %s, none in the "
          "replayed closes, one per transaction in the buffered ones %s"
          % (launches, want, pr.close_launches(R_TIP + 1, R_TOP)))
    check(pr.cpu_calls == [] and pr.sha_as_derived(),
          "R4: none on the CPU; SHA-256 per close as derived")
    replay = [pr.closes[s] for s in range(first, R_TIP + 1)]
    replay_s = replay[-1][4] + replay[-1][3] - replay[0][4]
    log("R4 online catchup from a gap (%s): %d values buffered; buckets "
        "applied at %d in %.2f s; ledgers %d-%d replayed in %.1f s = %.2f "
        "ledgers/s (drains %s launches); the %d buffered closes cold, %s "
        "launches, %s ms; %.1f s in all; %s"
        % (card, len(buffered), first - 1, apply_s[0], first, R_TIP,
           replay_s, (R_TIP - first + 1) / replay_s, launches,
           len(buffered), pr.close_launches(R_TIP + 1, R_TOP),
           "/".join("%.1f" % (pr.closes[s][3] * 1e3)
                    for s in range(R_TIP + 1, R_TOP + 1)), wall,
           gcp.line()))
    r_stop(node)
    return {"verify": E.LAUNCHES, "sha256": S.LAUNCHES}


def flip_in_gz(path: str, find: bytes = b"", offset: int = 0) -> bytes:
    """Flip one byte of a gzipped archive file, in its decompressed bytes:
    at `offset`, or at `offset` into the first occurrence of `find`.
    Returns the bytes at that place after the flip (64 of them)."""
    import gzip
    with gzip.open(path, "rb") as g:
        raw = bytearray(g.read())
    at = (raw.find(find) if find else 0)
    check(at >= 0, "R5: the bytes to corrupt are in %s" % path)
    raw[at + offset] ^= 0x01
    with gzip.open(path, "wb") as g:
        g.write(bytes(raw))
    return bytes(raw[at:at + 64])


def r5_faults(S, E, K, SC, tmp: str, r1: dict, flight_dir: str) -> dict:
    """R5 of the module docstring: three faults, each on a fresh card node
    over its own copy of the archive; nothing is timed."""
    from stellar_core_tpu_torch.history.archive import category_path
    from stellar_core_tpu_torch.util.faults import FaultInjector
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.tracing import FlightRecorder, Tracer
    from stellar_core_tpu_torch.work.basic_work import State
    pub = r1["pub"]
    out = {"verify": 0, "sha256": 0}
    first = R_TIP - R_RECENT + 1
    victim = lcd_from_db(pub.database, first).tx_set.frames[0]
    for case in ("a", "b", "c"):
        archive = os.path.join(tmp, "archive-" + case)
        shutil.copytree(r1["archive"], archive)
        reg, tr = MetricsRegistry(), Tracer()
        rec = FlightRecorder(tr, metrics=reg, out_dir=flight_dir)
        faults = FaultInjector(metrics=reg)
        v, h = card_stacks(reg, tr, rec, faults=faults)
        node = r_node(tmp, "r5" + case, archive, v, h, recent=R_RECENT,
                      metrics=reg, tracer=tr, recorder=rec, faults=faults)
        flipped = None
        if case == "a":
            flip_in_gz(os.path.join(archive, category_path(
                "ledger", R_TIP, ".xdr.gz")), offset=40)
        elif case == "b":
            sig = victim.signatures[0].signature
            flipped = flip_in_gz(os.path.join(archive, category_path(
                "transactions", R_TIP, ".xdr.gz")), find=sig, offset=7)
        else:
            faults.configure("device.dispatch")
        K.flush_verify_cache()
        E.LAUNCHES = S.LAUNCHES = 0
        with RProbe(S, E, K, SC, node) as pr:
            work = node.catchup_manager.start_catchup()
            check(r_crank_until(node, work.is_done, 600.0),
                  "R5%s: the catchup finished" % case)
        lcl = node.ledger_manager.last_closed_ledger_num()
        check(work.state == State.FAILURE and pr.cpu_calls == [],
              "R5%s: the catchup fails, nothing verified on the CPU" % case)
        if case == "a":
            check(lcl == 1 and not pr.closes and E.LAUNCHES == 0,
                  "R5a: a flipped byte of checkpoint %d's ledger file fails "
                  "VerifyLedgerChainWork; nothing applied or launched"
                  % R_TIP)
            what = "the ledger chain refused, LCL 1"
        elif case == "b":
            triple = (victim.source_account_id().key_bytes, flipped,
                      victim.contents_hash())
            decided = {t: d for dr in pr.drains
                       for t, d in zip(dr["triples"], dr["decisions"])}
            check(lcl == first - 1 and decided.get(triple) is False
                  and K.raw_verify_batch([triple]) == [False]
                  and [s for s, _e in pr.close_errors] == [first],
                  "R5b: a flipped signature byte in ledger %d fails the "
                  "catchup there, LCL %d; the card's decision on it False, "
                  "as the C verifier's" % (first, first - 1))
            what = "ledger %d failed (%s), LCL %d" % (
                first, pr.close_errors[0][1][:60], lcl)
        else:
            m = {k: d["count"] for k, d in reg.to_json().items()
                 if k.startswith(("crypto.", "fault."))
                 and "count" in d}
            check(lcl == first - 1 and E.LAUNCHES == 0 and not pr.closes
                  and m.get("crypto.verify.dispatch-failure") == 1
                  == m.get("fault.injected.device.dispatch"),
                  "R5c: device.dispatch in checkpoint %d's drain fails the "
                  "catchup at LCL %d, counted by the resilient layer's "
                  "meter (%s)" % (R_TIP, first - 1, m))
            what = "the drain raised, LCL %d; meters %s" % (lcl, m)
        log("R5%s: %s; %d verify and %d SHA-256 launches"
            % (case, what, E.LAUNCHES, S.LAUNCHES))
        out["verify"] += E.LAUNCHES
        out["sha256"] += S.LAUNCHES
        r_stop(node)
    return out


def catchup_path(S, E, K, SC, flight_dir: str, card: str) -> dict:
    """R1-R5 of the module docstring; returns the launches by kernel."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_catchup_") as tmp:
        r1 = r1_publish(S, E, K, tmp, card)
        out = {"verify": 0, "sha256": 0}
        for phase in (r2_complete, r3_restart, r4_gap):
            got = phase(S, E, K, SC, tmp, r1, flight_dir, card)
            for k in out:
                out[k] += got[k]
        got = r5_faults(S, E, K, SC, tmp, r1, flight_dir)
        for k in out:
            out[k] += got[k]
        r_stop(r1["pub"])
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
    from stellar_core_tpu_torch import xdr as X
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
        futs = [v.enqueue(X.PublicKey.ed25519(k), sg, m)
                for (k, sg, m) in burst]
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

    # --- the close: LedgerManager closes of signed multisig ledgers -------
    closes = close_path(S, E, K, rng, flight_dir, card)

    # --- catchup: publish, replay checkpoints on the card, restart ---------
    catchup = catchup_path(S, E, K, SC, flight_dir, card)

    main_b = buckets[DRAIN_CHUNK]
    main_s = shapes[HASH_MAIN_SHAPE]
    main_f = fleet["shard"][DRAIN_CHUNK]
    log(json.dumps({"kernels": [{
        "name": "ed25519_verify", "route": "cuda",
        "source": "stellar_core_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "stellar_core_tpu/ops/ed25519.py:328",
        "launches": launches + sum(closes["verify"].values())
        + catchup["verify"],
        "launches_by_path": {"verify main path": launches,
                             **closes["verify"],
                             "catchup": catchup["verify"]},
        "max_abs_err": float(main_b["mismatches"]),
        "ms": main_b["ms"], "plain_ms": main_b["plain_ms"],
        "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
        "library_ms": None, "check": "ok",
        "buckets": {str(b): {k: r[k] for k in ("ms", "plain_ms",
                                                "bound_ms", "mismatches")}
                    for b, r in buckets.items()}}, {
        "name": "sha256", "route": "cuda",
        "source": "stellar_core_tpu_torch/csrc/sha256.cu",
        "replaces": "stellar_core_tpu/ops/sha256.py:112",
        "launches": hash_launches + ledger_launches
        + sum(closes["sha256"].values()) + catchup["sha256"],
        "launches_by_path": {"hash main path": hash_launches,
                             **ledger["launches"], **closes["sha256"],
                             "catchup": catchup["sha256"]},
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
