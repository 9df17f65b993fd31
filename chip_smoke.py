#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (`stellar_core_tpu_torch`) on
one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a). It builds every kernel from the
sources in the checkout (one nvcc per source, all started together) and,
on a thread beside them, the port's two CPython extensions with `cc` and
the interpreter's headers (the apply engine `native/applyc.c` and the XDR
codec's C route `native/xdrc.c`, into `stellar_core_tpu_torch/build/`
under the names `_sctapply_torch` and `_sctxdr_torch`), then drives
three paths, the ledger that runs on the hash path, the ledger manager's
close that runs on both (its fee and apply phases in the apply engine,
which verifies each close's candidate signatures in one `prewarm_many`),
the catchup that replays published checkpoints through that close, and a
network of herder nodes reaching consensus on the values that close,
first through a relay, then over the port's overlay: authenticated
loopback peers and localhost TCP, simulated fleets, and last the
reference's operation-semantics cases, their signatures decided on the
card.
Every close node runs as the reference's default node: its SQL root's
point reads served from the bucket list by BucketDB, the close cockpit
(`ledger/apply_stats.py`) on, the apply engine; the CPU twins and the
publisher read SQL and apply in the Python phases.

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
   `BucketEntry` objects (decoded by the port's codec, its C route), in
   canonical order without a Python sort, adopts them as the curr buckets
   of levels 4-10 (most in level 10, which never spills) through a
   `BucketManager` with background merges over a temporary bucket
   directory, and restores the list with `assume_state` at a ledger that
   is a multiple of 128, as a node starts after catchup. The manager
   indexes every adopted bucket for BucketDB (`bucket/bucket_index.py`:
   a sorted key index and a bloom filter of 10 bits a key, the sidecar
   `bucket-<hex>.xdr.idx` written beside the bucket; key fingerprints are
   `hashlib` SHA-256 on the host). No launch. Prints the setup s, the
   index build s, the sidecars' bytes and the bloom filters' bit density;
X1. (the codec, first half, after L1) encodes L1's 2^20 LedgerEntry
   values through the codec's C route (`native.xdr_pack_fn`) and through
   its Python route (`fastcodec`): the bytes equal; then decodes them by
   both routes, each decoding re-encoding to the same bytes. Prints each
   route's encode and decode ms, timed with the cyclic collector off (L1
   prints the decode with it on). The second half, after R1, does the same
   with the TransactionHistoryEntry records of R1's checkpoint-127
   transactions file, whose own bytes both routes must give;
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
0 just before it and read just after. Both nodes are wired as the
reference's default node (`tests/torch_catchup_harness.py::wire_node`:
the BucketManager on the close cockpit `apply_stats`, BucketDB, no
invariant, no close-meta stream). The card's LedgerManager closes
through `make_verifier("cuda-resilient")` and `make_hasher(
"cuda-resilient")` (no fallback), with a real Tracer, FlightRecorder and
metrics, its fee and apply phases in the apply engine, its SQL root's
point reads served by BucketDB (BUCKETDB_READS, the reference's
default); a CPU twin (`CpuSigVerifier`, the hashlib hasher, a SQL root
that reads SQL) closes the same values through the Python phases
(`use_native_apply` False), so every close is also a differential of the
two read paths. Each
side validates from an empty verify cache (the process has one), so
neither reads the other's decisions. At every close: the card's path is
"native" and the twin's "python" (no engine bail: these mixes hold no
residual shape), and the engine's one verify callback gets exactly the
candidates derived from the state before the close by the engine's rule
(`tests/torch_close_harness.py::engine_candidates`: hint-matched master
keys and signers of each transaction's accounts, plus the set's
set-options signers), launching once per 8,192 of them the verify cache
does not hold, its decisions equal to the C verifier's:

C1. restores a state of CLOSE_STATE entries of the same mix (every offer
   with an ID of its own) plus the network root account: buckets written
   and adopted as in L1, `assume_state` at LEDGER_START, then
   `apply_buckets` into a `LedgerTxnRoot` over sqlite `:memory:` (the
   twin: its own list over the same buckets, its own SQL root) and
   `set_last_closed_ledger` on a header that commits to the list, after
   which the card's root reads through BucketDB and the twin's SQL. The
   commitment's first root follows, one launch per planned chunk. Prints
   the restore's seconds split into generation, buckets (the BucketDB
   index build among them) and apply, and the card's indexes;
C2. three closes build the senders as `replay_bench` does: the root
   creates 200 in two 100-operation transactions, then one close arms
   them (senders 0-99: 19 more signers and a medium threshold of 20;
   100-199: one more signer and 2);
C3. 32 closes (64 until the operator's node, M1, came) of 100
   payments, each signed by 20 keys, every 7th with one signature
   corrupted, every 5th paying an account restored in C1 and
   not paid before (one each of levels 4-9, the rest of level 10, so
   that the close reads the deep levels) and the rest the root, each run
   as a node runs it:
   `TxSetFrame.trim_invalid` (the herder's call), a StellarValue over the
   trimmed set, `LedgerManager.value_externalized`. Checks: the trimmed
   transactions are the corrupted ones on both sides; one verify launch
   per validation (one prewarm of 2,000 triples at the 2,048 bucket) and
   none in a close (the engine's candidates are all in the cache);
   SHA-256 launches per close as derived from the bucket list alone (L3's
   rule); lcl_hash, every result pair, the bucket-list hash and the
   commitment root equal to the twin's after every close. Prints
   validation p50/p99 and sigs/s, `ledger.ledger.close` p50/p99,
   `close.apply` p50 and mean on both sides (the engine against the
   Python phases), the close's spans per close, and the card's busy share
   from a replay of the validations' prewarm drains with only CUDA
   activity profiled. C3 runs both read paths on the card's node in one
   call: its odd closes with BucketDB detached (SQL point reads; the
   bulk prefetch then defers to the engine, which loads its keys itself),
   its even closes attached (one batched BucketDB pass a close in
   `close.prefetch`), the entry cache emptied before each close so that
   the close's reads reach the path; every BucketDB close makes no SQL
   point lookup, every SQL close no bucket read; the BucketDB half hits
   each of levels 4-10, the SQL half probes no level. Prints each half's p50 of `close.prefetch`, `close.apply` and
   `ledger.ledger.close` and its levels probed,
   BucketDbStats (reads by outcome, levels probed, the bloom filters'
   false-positive rate, bytes read, prefetch batches), the cockpit's
   `apply_breakdown()` (per-op ms, bails, state reads; its parts add up
   to the apply wall within the reference test's `_breakdown_sums` bound)
   and the engine's clusters;
C4. 32 closes of 100 two-signature payments between disjoint partner
   pairs (the standard mix's payments; every 5th to a restored account
   as in C3, BucketDB hitting each of levels 4-10),
   with the same checks and prints,
   both nodes with INVARIANT_CHECKS [".*"] (all six invariants on every
   close) and METADATA_OUTPUT_STREAM set to a file each: the two streams,
   read back through `read_close_meta_stream`, are equal record for
   record and byte for byte, one record a close. Prints the ms per close
   of the tx-phase delta snapshot and of `check_on_ledger_close` on both;
C5. a cold close: one C3-shaped set validated on the card, the verify
   cache flushed, then closed: the engine drains all its candidates in
   one `prewarm_many`, one launch, decisions and lcl_hash equal the
   twin's. Prints the close's time beside C3's. C5p: the next C3-shaped
   set closed cold on the same card node through the Python phases
   (`use_native_apply` False, the route every engine bail takes): one
   launch per transaction left after trimming, at its first signature
   check, every decision equal to the C verifier's, lcl_hash equal to the
   twin's; prints its measured launches and time beside C5's. The root
   then equals `from_scratch_root`. Then the fault case: a close of C4-shaped payments with `device.dispatch`
   armed on a `cuda-resilient` verifier: the fault raises out of the
   engine's verify callback and the close raises SignatureVerifyError;
   the LCL, its hash and the entries are unchanged, no transaction is
   applied by the Python phases instead, nothing launches and nothing is
   verified on the CPU. Last, the invariant case (a tripped invariant
   stops a node, so it ends the card's node): all invariants and a
   stream again, one C4-shaped close on the Python phases whose payment
   mints lumens (as `tests/test_invariants.py::
   test_corrupted_op_aborts_real_close`): InvariantDoesNotHold, the LCL
   and its hash unchanged, no record in the stream.

Catchup (the port's work scheduler, history publish and catchup over
the close path), each phase driven with the counts set to 0 just before
it and read just after. Every node is a port node wired as the
reference's Application wires one (sqlite in a file, a bucket directory
with BucketDB through `wire_node`, the persistent state's local HAS, a
local-directory archive reached through `ProcessManager`); every card
node runs `make_verifier` and `make_hasher("cuda-resilient")` (no
fallback) from an empty verify cache, and its root reads through
BucketDB; the publisher's reads SQL:

R1. a CPU node (the C verifier, `make_hasher("cpu")`, the Python apply
   phases) closes the history through `value_externalized`, each set
   validated by `trim_invalid` as
   in C2/C3: ledger 2 funds 100 senders in one 100-operation transaction,
   ledger 3 arms them (19 more signers, a medium threshold of 20), and
   ledgers 4-131 carry 100 payments to the root, each signed by 20 keys
   (`replay_bench`'s multisig mix at pubnet's checkpoint frequency, 64).
   Checkpoints 63 and 127 publish; the archive's layout is checked as
   `test_catchup.py::test_publish_layout` checks it (the HAS, the four
   categories, every bucket it names). Prints the closes' p50, the
   publishes' seconds and the archive's bytes. This node is the oracle of
   R2-R5. R1 runs with the earlier phases' objects frozen out of the
   cyclic collector's reach (`gc.freeze()` after one full collection,
   `gc.unfreeze()` after R1), so its full collections walk only the
   objects made since; prints the frozen count. R2-R5 collect over all
   of them again;
R2. a fresh card node catches up complete: SUCCESS at 127; every ledger's
   hash, the bucket-list hash and the commitment root equal the
   publisher's; the verify launches per drain equal the count derived
   from the archive alone (checkpoint 63's master-key drain, its re-drain
   after ledger 3 adds the signers, checkpoint 127's drain: 1, 14 and 16
   launches), none inside a replayed close (every close runs in the
   apply engine, whose candidates the drains left in the cache); every
   distinct triple verified on the card exactly once and none on the
   CPU; SHA-256 launches per close as derived from the bucket list (L3's
   rule). Prints ledgers/s, transactions/s and signatures/s end to end,
   each checkpoint's spans (`catchup.load_files`, `catchup.txset_parse`,
   `catchup.sig_prep`, `crypto.verify_many`, the mean
   `catchup.apply_ledger`), the drains' sigs/s, the full collections, the
   card's busy share over the drains from a profiled replay of them, and
   each checkpoint's prefetch summary line (`_log_checkpoint_summary`:
   the checkpoint's keys covered by its one batched BucketDB pass);
R2p. a second fresh card node replays the same archive's first
   checkpoint (a complete catchup to 63; the whole archive until the
   operator's node, M1, came) with its closes in the Python phases
   (`use_native_apply` False), with R2's checks to 63: the launches of
   R2's first checkpoint, drain for drain (1 and 14), none in a close.
   Prints both replays' ledgers/s and mean `catchup.apply_ledger`;
R3. a node restarted over R2's SQL file, bucket directory and persistent
   state: LCL 127 and a bucket list that hashes to its header's; the
   commitment's first root, computed on the card, equals the
   publisher's; it closes value 128 cold in the engine (one launch, as
   its candidates derive; decisions equal the C verifier's) to the
   publisher's hash. The restart loads every persisted sidecar with no
   rebuild (the index loads equal the indexes, no build) and passes
   `_check_bucket_coverage` (the root still reads through BucketDB);
R4. a fresh card node at genesis, configured to catch up the last
   checkpoint (CATCHUP_RECENT 64: a minimal catchup to a checkpoint tip
   would apply buckets at 127 and replay nothing), hears values 128-131:
   it enters LM_CATCHING_UP_STATE with 4 values buffered, applies the
   buckets at 63, replays 64-127 behind one 16-launch drain, then closes
   128-131 from the buffer, cold, in the engine (one launch a close, as
   the candidates derive, decisions equal the C verifier's), and ends
   synced at 131 with the publisher's hash; the bucket-apply's
   `set_last_closed_ledger` re-attaches BucketDB at 63. Prints the
   bucket-apply's seconds and the replay's ledgers/s;
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

The operator's node (M1, after R5, while R1's archive is there), driven
with the counts set to 0 just before it and read just after: each step is
a process of its own, `python -m stellar_core_tpu_torch <command> --conf
node.toml`, from the checkout's root, on a TOML config with a sqlite
database and a bucket directory in a temporary directory, R1's archive as
HISTORY, R1's network passphrase and genesis, MANUAL_CLOSE,
RUN_STANDALONE, a free HTTP_PORT, and no backend named (so the node's
verifier and hasher are the default card stacks, "cuda-resilient"). The
processes' kernel launches are read from their own counts (the
`verifier` and `hasher` endpoints' `counters.kernel_launches`, and the
`catchup` command's launch line), this process launching nothing:

M1. `new-db` prints the publisher's genesis hash; `catchup 127/max`
   exits 0 and prints `catchup SUCCESS at ledger 127`, every header hash
   1-127 in the node's database == the publisher's, its verify drains on
   the card as derived from the archive (R2's), its SHA-256 launches R2's
   (derived from the bucket list close by close), each kernel's launches
   its drains' plus its warmup's; a CPU twin (the C verifier,
   `make_hasher("cpu")`) starts from a copy of the node's files; then
   `force-scp`, and `run` in the background: `info` at LCL 127, synced;
   4 closes of 100 payments of R1's mix (20 signatures, every 7th
   corrupted) from its senders at their next sequence numbers, each
   submitted through `tx?blob=`, each valid one answering PENDING and each
   corrupted one ERROR (the card's admission verify said False), each
   close through `manualclose`, its externalized set exactly the valid
   payments submitted before it, the twin closing the value read back
   from the node's database with the same header hash, bucket-list hash
   and commitment root; the `verifier` endpoint's drains all served by
   the card's stack and its launches as derived from the data (one per
   admission whose candidate triples miss the process's cache, plus a
   close whose engine candidates miss it), the `hasher` endpoint's as
   derived from the twin's bucket list (every bucket at the process's
   first close, whose commitment engine starts empty); one read each of
   `metrics?format=prometheus`, `footprint` and `health`; SIGINT: exit 0
   and the warmup plan saved; `run` again: `info` at 131, 100 more
   payments and `manualclose` close 132 (as derived, from an empty
   cache), SIGINT, exit 0; `offline-info` prints 132. A step that exits
   non-zero, an endpoint that answers other than 200 or does not parse,
   and a `run` alive after its stop (killed, then raised) fail M1. Prints
   each step's seconds, each process's start-up included.

SCP and the herder (after R5), each driven with the counts set to 0 just
before it and read just after. Nodes are port herder nodes in this
process (`tests/torch_herder_harness.py`: each its own `LedgerManager`
over sqlite, `BucketManager`, `StateCommitmentEngine` and slot journal,
a virtual clock, manual closes triggered slot by slot on every node,
node 0 forcing SCP) wired by a relay that stands in for overlay: every
envelope, transaction, txset and quorum set crosses as XDR bytes, and
the relay's crank flushes each node's verifier after its ready work, as
`Application.crank` does, and moves the clocks only when no node has
work and no verify is under way. Traffic is the multisig mix: ledger 2
funds 100 senders, ledger 3 arms them with 19 extra signers, then each
loaded slot carries one 20-signature payment from every sender, submitted
to the nodes in turn and flooded to the rest; every 7th carries a
corrupted signature, and every node must answer it ADD_STATUS_ERROR.

S1. 21 validators, pubnet's tier-1 shape (7 organisations of 3; each
   node's quorum 5 of the 7 organisations, each an inner set of 2 of its
   3), each on `make_verifier("cuda")` and `make_hasher("cuda")`, and a
   CPU twin (one port `LedgerManager` on the C verifier and
   `make_hasher("cpu")`, its closes in the Python phases, its root
   reading SQL, closing the value each slot externalized): 4 slots, 2
   loaded (the relay's numbers, beside O1's over the real overlay). Checks: every node's root reads through BucketDB and its
   every close runs in the apply engine; all 21 nodes externalize
   one value a slot;
   at every height every node's lcl hash, bucket-list hash and
   commitment root are equal and equal the twin's; the verify launches
   by call site equal the count derived from the run's data: one per
   distinct envelope flooded (the first node it reaches misses the
   process's verify cache and flushes it alone, `herder.py:755`), one per
   transaction's first admission (its `prewarm_many`), none in the
   nominations' and closes' `trim_invalid`, the externalize hints or the
   cranks' flushes; the SHA-256 launches all in the closes, as derived
   from each node's bucket list; every decision a verifier returned
   equals the C verifier's; nothing sent to the card is verified on the
   CPU, whose only triples are the nominated values' signatures (the
   herder checks those on the host, as the reference does). Prints, per
   loaded slot, the seconds from the first `trigger_next_ledger` to all
   21 externalized and to all 21 closed (p50 and max), the admission
   rounds, envelopes per slot and per node, launches by site, each
   node's verify demand with cache hits (what 21 machines would each
   verify), the card's busy share over the loaded slots (profiled, CUDA
   activity only), and the full collections;
S2. 4 validators in a 3-of-4 quorum, each on `make_verifier("cuda-async")`
   (stamping verify latency on the host's clock; completions post to the
   node's virtual clock), 7 slots, 5 loaded; after slot 5, node 0's last
   envelope with one signature byte flipped is relayed to nodes 1 and 2.
   Checks: every slot externalizes and closes to equal hashes on all
   four, every close in the apply engine; both nodes drop the forged
   envelope on the card's False
   decision and consensus goes on; every flooded envelope is verified on
   the card; the verify launches are at most the bound derived from the
   data, each receiver once per envelope, the forged one twice and each
   transaction once (S1's one launch per distinct envelope does not
   hold here: a node's verify is still in flight when the next node
   asks, so it has not reached the process's cache; each node verifies
   for itself, as it would on its own machine, and coalesces what
   arrives while its own dispatch is in flight); SHA-256 as derived;
   decisions equal the C verifier's, none sent to the card verified on
   the CPU. Prints `crypto.verify.latency` p50 and p99 and S1's count
   beside the launches.

The overlay (`stellar_core_tpu_torch/overlay/`): the herder's nodes
reach each other only through the port's `OverlayManager`, each envelope
relayed by a node only when its verifier passed it (`overlay/peer.py`'s
on-verified relay), so the card's verify sits on every hop of a flood:

O1. S1's 21 validators, quorum, card stacks, BucketDB, apply engine, CPU
   twin and traffic, with the relay taken out
   (`tests/torch_herder_harness.py::OverlayNet`): each node linked to 8
   peers over authenticated loopback pipes (node i dials i+1 .. i+4 mod
   21; 84 links, each a full Hello/Auth handshake with its AuthCert
   verified on the host, the reference's `TARGET_PEER_CONNECTIONS`), the
   transactions submitted at node 0 (`submit_transaction`: admission on
   the card, a flood on status 0) and flooded to every node before each
   slot's trigger; 3 slots, 1 loaded; after the last, node 0 sends node 1,
   over their link, its last envelope with one signature byte flipped.
   Checks: every link authenticated on both ends, before and after; every
   slot externalizes and closes, every node == the twin at every height,
   every close in the apply engine; the corrupted transactions reach
   node 0's queue only and no floodgate; every accepted transaction
   reaches every node's queue; node 1 refuses the forged envelope on the
   card's False (`overlay.envelope.rejected` 1 there, 0 elsewhere) and no
   other node sees it; verify launches by site == one per distinct
   envelope originated, the forged one and one per transaction's first
   admission (a node that hears an envelope from 8 peers verifies it
   once; the cache is the process's); SHA-256 as derived; decisions ==
   the C verifier's, none sent to the card verified on the CPU. Prints per
   loaded slot the flood and trigger -> all externalized / closed
   seconds, frames and bytes received by message type, the flood
   duplication ratio and fanout, the TX_SET frames, the propagation
   cockpit's receipt -> relay and origin -> receipt delays (host clock),
   the herders' envelope intake on the host clock with and without a
   launch beside the cockpit's virtual-clock verify latency, launches by
   site, each node's verify demand, the busy share and the collections;
O2. 4 validators in a 3-of-4 quorum, each the port's `Application` on a
   REAL_TIME clock with SIG_VERIFY_BACKEND "cuda-async", HASH_BACKEND
   "cuda" (no warmup) and BucketDB, RUN_STANDALONE off, each door on a
   port the kernel picks, every other node's port in its peer book, the
   nodes closing on their own timers; a CPU twin closes node 0's every
   value. Traffic: the funding, arming and 2 loaded rounds of the same mix
   submitted at node 0, each cranked until applied on every node.
   Checks: every node authenticates its 3 peers over TCP; every height ==
   on all four and the twin; every envelope a node verified was verified
   on the card, and every relay of an envelope followed its verify's True
   (the relay waits for the async batch); launches <= S2's per-receiver
   bound (each of 3 receivers once per envelope, each transaction once);
   SHA-256 as derived; decisions == the C verifier's. Prints
   `overlay.envelope.verify-latency.<backend>` p50 and p99 per node (a
   real clock here), the send-queue depth maximum, bytes sent over the
   sockets per round and the receipt -> relay delays.

The simulation (`stellar_core_tpu_torch/simulation/`, the scenario lab
`testing/scenarios.py`, the fuzzer `main/fuzz.py` and the hash-seed
probe), after O2, each phase driven with the counts set to 0 just before
it and read just after. A fleet built with no backend named is a fleet
of card nodes: every node its own `Application` with its own
`"cuda-resilient"` verifier and hasher, warming both kernels on its own
threads at every start (a restart too), all in this one process and its
one verify cache:

G1. the scenario lab's six scenarios (churn, flood, partition, surge,
   overload, checkpoint), `run_scenario(name, seed=1, scale="tier1")` on
   the card's stacks, then each again with `backend="cpu"` as the twin
   (the C verifier behind the card stack's own queue, and hashlib behind
   the card hasher's routing, each counting what the card would launch
   for the same calls). Checks: every assertion the scenario makes as it
   runs; the card's block == the twin's less the fields that read the
   host's clock (`tests/torch_sim_harness.py::comparable`: the fleet
   view's slot latencies and skews, taken on the slot journal's
   perf-counter stamps, the light clients' verify timings, and the churn
   scenario's schedule, which follows its archive's `cp` subprocesses);
   the header hash at every (node, height) both runs closed == the
   twin's; every drain served by the card; each kernel's launches == the
   nodes' drains plus one warmup per node start; the drains == the
   twin's counts (churn excepted: its schedule follows the host's
   clock). Prints each scenario's card and twin seconds, its launches,
   its peak card memory and its slot latency p50 in virtual ms beside the
   block's host-clock one; for overload also the priority goodput and
   the applied p95 ratio. Past G1_CUT_AFTER_S seconds of the script
   before G1, G1 runs only overload, churn and checkpoint, and says so;
G2. the operator's commands, one process each (`python -m
   stellar_core_tpu_torch`; the two `simulate`s beside `gen-fuzz`, then
   the `run` node driven while the fuzzers and G3's probes run), with TOML
   configs that name no backend:
   `simulate --ledgers 8 --txs 100` (a fixed NODE_SEED) ends on the same
   ledger hash as a second `simulate` whose config names "cpu", its verify
   drains one at 128 lanes for each of its 900 admissions and none in a
   close; a `run` node with ARTIFICIALLY_GENERATE_LOAD_FOR_TESTING serves
   `generateload?accounts=100&txs=0`, `manualclose`,
   `generateload?accounts=0&txs=400` and three more `manualclose`s: its
   `verifier` endpoint's drains == the 401 admissions, its `hasher`
   endpoint's == the commitment's launches derived from a C-verifier
   twin's bucket list, and the twin closing the node's values read back
   from its SQL reaches the same header hash at every height;
   `gen-fuzz --mode tx`, `fuzz --mode tx --input` and `fuzz --mode
   overlay --iterations 300` exit 0, no handler raising; each command's
   second line gives its launches, every drain the card's, each kernel's
   launches == the drains plus the warmups;
G3. the hash-seed probe (`python -m
   stellar_core_tpu_torch.testing.hashseed_probe`, the card's stacks)
   under PYTHONHASHSEED 1 and 2, side by side: byte-identical outputs;
   its standard error's launch line as in G2.

The reference's operation semantics (T1, after G3), each case driven
with the counts set to 0 just before it and read just after:

T1. the 428 cases of the reference's 14 operation-semantics files whose
   cases sign transactions (`T1_FILES`: payments, path payments, offers,
   exchange, liabilities, allow-trust, inflation, the upgrade matrix,
   envelopes, multisig and merges in a set and in the queue, fee bumps,
   result codes), loaded from the checkout's `tests/` by
   `torch_mirror_harness.Mirror(..., sides=("port",))`, which reads their
   source as text and points it at the port (no `jax`, no
   `stellar_core_tpu`). Each case runs twice, from an empty verify cache
   each time: as written, its `TestLedger()`s verifying on the card's bare
   fleet (`make_verifier()`), and on a twin whose `TestLedger`s take the C
   verifier behind the card stack's boundary (`t1_twin`). Checks: every
   assertion of the case on both; the two records equal
   (`torch_ops_records.op_records`: each application's return value, each
   result and a fee bump's inner result and the header as XDR, a SHA-256
   over the root's entries; the type of each exception a case expects);
   the card's launches == its drains == the twin's drains after the cache
   (a flush after an enqueue that missed, a `verify_many` of any triple);
   every triple the card decided decided alike by the twin's backend, and
   no other; afterwards neither `jax` nor `stellar_core_tpu` in
   `sys.modules`. Prints the cases, frames, signatures the card decided
   and rejected, launches and seconds.

The lint, first, on the card's host and before the build: the port's
own engine over the port's package with the port's allowlist, through
its command line as an operator runs it (`python -m
stellar_core_tpu_torch.analysis --json`; the Python rules D1, D2, T1,
E1, F1, M1, S1, FL1, B1, the C rules N1-N4 over `native/*.c` and the
CUDA sources `csrc/*.cu`/`*.cuh`, and A1). Checks: no violation, no
stale allowlist entry, no parse error, and findings behind the allowlist
(the rules ran). Prints its files, its findings by rule against the
allowlist's entries, and its seconds.

It prints the card's name and power limit, the build time, both kernels'
ptxas reports (registers, stack frame, spills, shared memory; each from
the log of the build that made its library, marked when that build was
an earlier process's), the verify kernel's product count per verify
beside the bound's, both kernels' SASS opcode counts (cuobjdump, where
the toolkit has it) and, for the SHA-256 kernel, each warp role's loop
per block (instructions, ptxas's stall clocks, opcodes), the
kernels' times, the paths' throughput and latency, their host layers
timed alone, the profiled drains' device busy share, each path's wall
seconds on one line (the lint's too) beside the card's name and power
limit, a `{"kernels": [...]}` line (three entries; the ed25519_verify entry's
launches are the verify main path's, C2-C5p's, R2-R5's, M1's, S1-S2's,
O1-O2's, G1-G3's and T1's, the sha256 entry's the hash main path's, L2-L4's,
C1-C5p's, R2-R5's, M1's, S1-S2's, O1-O2's and G1-G3's, each split in
`launches_by_path`, R2, R2p and R3-R5 under `catchup`, M1 under `main
M1`, S1 and S2 under `herder S1` and `herder S2`, O1 and O2 under
`overlay O1` and `overlay O2`, G1-G3 under `simulation G1` to
`simulation G3`, T1 under `semantics T1`)
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
# bucket applicator (2^17 since the simulation path came: with 2^18 the
# whole script ran 1,254 s on one H100's host, over the 1,200 s limit; at
# 2^19 C1 took 95.0 s, over the 90 s a restore is given here); CLOSE_SENDERS senders, the first
# CLOSE_TXS with CLOSE_SIGS signatures a payment (replay_bench's
# txs_per_ledger=100, sigs_per_tx=20, bench.py:339-341), the rest with 2;
# C3_CLOSES closes of the multisig mix, C4_CLOSES of the standard mix's
# payments; every CLOSE_CORRUPT_EVERY-th payment carries a corrupted
# signature. Every CLOSE_DEEP_EVERY-th payment of a close goes instead to
# an account restored in C1 and not yet paid, drawn so that each close
# pays one account of each of levels 4-9 and the rest from level 10: the
# close's reads of those accounts reach the deep levels' buckets.
CLOSE_STATE = 1 << 17
GENESIS_TOTAL_COINS = 10 ** 17
CLOSE_MAX_TX_SET_SIZE = 10_000
CLOSE_SENDERS, CLOSE_TXS, CLOSE_SIGS = 200, 100, 20
# (C3 had 64 closes until the operator's node, M1, came)
C3_CLOSES, C4_CLOSES = 32, 32
CLOSE_CORRUPT_EVERY = 7
CLOSE_DEEP_EVERY = 5
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
# the herder phases (S1, S2): S1 is pubnet's tier-1 shape, S1_ORGS
# organisations of S1_PER_ORG validators, each node's quorum an inner set
# of 2 of each organisation's 3 and 5 of the 7 organisations
# (tests/test_quorum_intersection.py's _pubnet_like), closing S1_LOADED
# slots of the multisig mix after the two that fund and arm its senders;
# S2 is S2_NODES validators in a 3-of-4 quorum on the async verify stack,
# S2_LOADED loaded slots. S1 had 10 loaded slots until the close phases'
# payments reached the deep levels; on a slow host the whole run then
# took about 1,110 s, so S1 gave up 4 of them, and 4 more when the overlay
# phases came (S1 stays as the relay's numbers beside O1's).
S1_ORGS, S1_PER_ORG, S1_LOADED = 7, 3, 2
S2_NODES, S2_LOADED = 4, 5
# the overlay phases (O1, O2): O1 is S1's network and traffic with the
# relay taken out, each node linked to O1_DEGREE peers over authenticated
# loopback pipes (the reference's TARGET_PEER_CONNECTIONS), O1_LOADED
# loaded slots (2 until the operator's node, M1, came); O2 is O2_NODES
# validators over localhost TCP, O2_LOADED loaded slots each
O1_DEGREE, O1_LOADED = 8, 1
O2_NODES, O2_LOADED = 4, 2
# seconds a round of O2 may take to apply everywhere: on the card a
# round stalled for up to 135 s before the herder kept each txset's
# verdict (ROADMAP Queue 3 item 11)
O2_ROUND_S = 300
# the operator's node (M1): M1_ROUNDS loaded closes of R1's multisig mix
# through the admin API, a restart, one more; the payments' amounts are
# offset by M1_AMOUNT_BASE so that no payment repeats one of R1's
M1_ROUNDS = 4
M1_AMOUNT_BASE = 1000
# the simulation path (G1-G3): the scenario lab's six scenarios at their
# tier-1 scale and seed 1, each on the card's stacks and again on the
# CPU's; G1's card half is cut to G1_CUT when the script has already run
# G1_CUT_AFTER_S seconds before it (the limit is 1,200 s)
G1_SCENARIOS = ("churn", "flood", "partition", "surge", "overload",
                "checkpoint")
G1_CUT = ("overload", "churn", "checkpoint")
G1_CUT_AFTER_S = 900
# G2: `simulate` (the port's funds 100 senders where the reference's
# stops at about 60; ROADMAP Queue 3 item 12), the `run` node's
# `generateload` (accounts, then payments, then closes), and the overlay
# fuzzer's iterations
G2_LEDGERS, G2_TXS = 8, 100
G2_ACCOUNTS, G2_PAYMENTS, G2_CLOSES = 100, 400, 4
G2_FUZZ_ITERATIONS = 300
# gen-fuzz's seed: its mutated envelope still decodes, so `fuzz --input`
# takes it through the frame, the fee and sequence checks and the apply
G2_FUZZ_SEED = 15
# T1: the reference's operation-semantics files whose cases sign
# transactions, each with the count `pytest --collect-only` gives
T1_FILES = {"test_payment_matrix.py": 23, "test_path_payment_matrix.py": 41,
            "test_path_payment_vectors.py": 18, "test_offer_matrix.py": 28,
            "test_exchange_vectors.py": 76, "test_liabilities_matrix.py": 78,
            "test_op_liability_matrix.py": 17,
            "test_allow_trust_matrix.py": 10, "test_inflation_matrix.py": 4,
            "test_upgrades_matrix.py": 31, "test_txenvelope_matrix.py": 25,
            "test_multisig_merge_queue_matrix.py": 38,
            "test_fee_bump_vectors.py": 17, "test_txresults_matrix.py": 22}
REPO = os.path.dirname(os.path.abspath(__file__))
# the node's processes run from the checkout's root, unbuffered so their
# output reaches its files as it is printed
M1_ENV = dict(os.environ, PYTHONUNBUFFERED="1")


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
                 extra=(), phase: str = "L1", mgr=None) -> dict:
    """L1 (and C1): `n` live entries of the testing/entries.py mix as the
    port's BucketEntry objects, in canonical order (one numpy sort of the
    bodies' identity prefixes), split into the deep levels' curr buckets
    (DEEP_LEVEL_ENTRIES, the rest in level 10), adopted through `mgr` (a
    BucketManager with background merges over `bucket_dir` for None),
    which indexes each for BucketDB at adoption and writes its sidecar,
    then restored with assume_state at LEDGER_START. Every offer has an
    ID of its own (C1's SQL root keys offers by ID alone); the LedgerEntry
    objects of `extra` join level 4's bucket. Returns, beside the timings,
    the account IDs of each level's restored accounts (`accounts`, those
    of `extra` left out)."""
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
    if mgr is None:
        mgr = BucketManager(bucket_dir, background_merges=True)
    hashes, live, by_level, accounts = [], [], {}, {}
    t_decode = t_hash = 0.0
    for lv in range(K_NUM_LEVELS):
        idx = order[level[order] == lv]
        if not len(idx):
            hashes.append({"curr": zero, "snap": zero})
            continue
        t1 = time.perf_counter()
        ents = TE.bucket_entries([records[i] for i in idx.tolist()])
        accounts[lv] = [e.value.data.value.accountID for e in ents
                        if e.value.data.disc == X.LedgerEntryType.ACCOUNT]
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
    index_s = mgr.bucketdb.stats.index["build_seconds"]
    check(mgr.bucketdb.stats.index["builds"] == len(by_level),
          "%s: every adopted bucket indexed for BucketDB" % phase)
    log("%s state (%s): %d live entries at ledger %d in %.1f s (generate + "
        "sort %.1f s, decode %.1f s, bucket hash + file + index %.1f s, "
        "of it the BucketDB index build %.2f s); levels "
        "%s; level 10 holds %d; bucket-list hash %s; BucketDB %s"
        % (phase, card, n + len(extra), LEDGER_START, setup_s, t_gen - t0,
           t_decode,
           t_hash, index_s, json.dumps({str(k): len(b) - 1
                                        for k, b in sorted(
                                            by_level.items())}),
           len(deep) - 1, mgr.get_hash().hex()[:16],
           bucketdb_line(mgr, bucket_dir)))
    return {"mgr": mgr, "live": live, "deep": deep, "accounts": accounts,
            "setup_s": setup_s,
            "generate_s": t_gen - t0, "decode_s": t_decode,
            "bucket_s": t_hash, "index_s": index_s}


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
        st.pop("accounts")
        check(S.LAUNCHES == 0 and E.LAUNCHES == 0,
              "L1 builds the state without a launch")
        mgr = st["mgr"]
        bl = mgr.bucket_list
        out["setup_s"] = st["setup_s"]
        x1_entries(X, st["live"], card)

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

def close_side(bucket_dir, verifier, hasher, bucket_reads: bool, root_sk,
               node_seed, metrics=None, tracer=None, recorder=None):
    """A port LedgerManager on a LedgerTxnRoot over sqlite `:memory:`,
    closing through `verifier` and `hasher`, with its own
    StateCommitmentEngine, wired by `torch_catchup_harness.wire_node` as
    the reference's Application wires a node: its BucketManager (in
    `bucket_dir`, or in memory only for None) on its close cockpit, its
    SQL root reading through BucketDB when `bucket_reads` (the
    reference's default) and from SQL otherwise, no invariant and no
    close-meta stream (the defaults; C4 turns both on)."""
    from types import SimpleNamespace
    from stellar_core_tpu_torch.database.database import Database
    from stellar_core_tpu_torch.ledger import state_commitment as SC
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerManager
    cfg = SimpleNamespace(
        DATABASE="sqlite3://:memory:",
        LEDGER_PROTOCOL_VERSION=LEDGER_PROTOCOL,
        GENESIS_TOTAL_COINS=GENESIS_TOTAL_COINS,
        TESTING_UPGRADE_DESIRED_FEE=100, TESTING_UPGRADE_RESERVE=5_000_000,
        TESTING_UPGRADE_MAX_TX_SET_SIZE=CLOSE_MAX_TX_SET_SIZE,
        network_id=LEDGER_NETWORK_ID, NODE_SEED=node_seed,
        STATE_CHECKPOINT_INTERVAL=CHECKPOINT_EVERY,
        BUCKETDB_READS=bucket_reads, BUCKETDB_BLOOM_BITS_PER_KEY=10,
        INVARIANT_CHECKS=[], METADATA_OUTPUT_STREAM="")
    app = SimpleNamespace(
        config=cfg, network_root_key=lambda: root_sk, sig_verifier=verifier,
        batch_hasher=hasher, database=Database(), metrics=metrics,
        tracer=tracer, flight_recorder=recorder)
    app.state_commitment = SC.StateCommitmentEngine(app)
    lm = app.ledger_manager = LedgerManager(app)
    harness("torch_catchup_harness").wire_node(app, bucket_dir)
    return lm


def bucketdb_line(mgr, bucket_dir) -> str:
    """A BucketManager's indexes: the builds and loads and their seconds,
    the sidecar files' bytes in `bucket_dir`, the indexed entries and the
    bloom filters' mean bit density."""
    db = mgr.bucketdb
    ix = db.stats.to_json()["index"]
    with db._lock:
        idxs = list(db._indexes.values())
    dens = [i.bloom.bit_density() for i in idxs if len(i)]
    side = sum(os.path.getsize(os.path.join(bucket_dir, f))
               for f in os.listdir(bucket_dir) if f.endswith(".idx")) \
        if bucket_dir else 0
    return ("%d indexes (%d entries): %d builds in %.2f s, %d loads in "
            "%.2f s, %d load failures; sidecars %d bytes; bloom bit "
            "density %.2f%% (mean), %d bits a key"
            % (len(idxs), sum(len(i) for i in idxs), ix["builds"],
               ix["build_seconds"], ix["loads"], ix["load_seconds"],
               ix["load_failures"], side,
               100.0 * sum(dens) / max(len(dens), 1), db.bits_per_key))


def level_hits(db) -> dict:
    """BucketDB's probes and hits so far, by level: {level: [probes,
    hits]}, point reads and prefetch passes together."""
    return {int(k): [v["probes"], v["hits"]]
            for k, v in db.stats.to_json()["levels"].items()}


def add_levels(into: dict, before: dict, after: dict) -> None:
    """Adds to `into` the probes and hits of `after` beyond `before`
    (two `level_hits`)."""
    for lv, (p, h) in after.items():
        p0, h0 = before.get(lv, (0, 0))
        if p > p0:
            acc = into.setdefault(lv, [0, 0])
            acc[0] += p - p0
            acc[1] += h - h0


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
    hasher = getattr(st["hasher"], "inner", st["hasher"])
    return sum(bucket_launches(S, hasher, b) for b in fresh.values())


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


class LogLines:
    """While entered, the messages of logger `name` (and its children)
    that contain `needle`, in `lines`."""

    def __init__(self, name: str, needle: str):
        import logging
        self.logger = logging.getLogger(name)
        self.needle, self.lines = needle, []
        outer = self

        class Grab(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if outer.needle in msg:
                    outer.lines.append(msg)

        self.handler = Grab()

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        return False


class EnqueueCalls:
    """While entered, records every `enqueue` of `verifier` (the Python
    phases' SignatureChecker) as (triple, decision), each decision read
    once the context exits, when every future is complete."""

    def __init__(self, verifier, calls: list):
        self.v, self.calls, self.futs = verifier, calls, []

    def __enter__(self):
        v = self.v
        inner = type(v).enqueue.__get__(v)

        def enqueue(key, sig, msg):
            f = inner(key, sig, msg)
            self.futs.append(((key.key_bytes, sig, msg), f))
            return f

        v.enqueue = enqueue
        return self

    def __exit__(self, *exc):
        del self.v.enqueue
        if exc[0] is None:
            self.calls.extend((t, f.result()) for t, f in self.futs)
        return False


class EngineCalls:
    """While entered, records every `prewarm_many` of `verifier` (the
    apply engine's verify callback inside a close) as (triples, decisions)
    in `calls`. The calls go to the verifier's own method, past any
    recorder a phase set on the instance for its validations."""

    def __init__(self, verifier, calls: list):
        self.v, self.calls = verifier, calls

    def __enter__(self):
        v = self.v
        self.had = "prewarm_many" in v.__dict__
        self.inner = v.prewarm_many
        inner = type(v).prewarm_many.__get__(v)

        def prewarm(triples):
            got = inner(triples)
            self.calls.append((list(triples), list(got)))
            return got

        v.prewarm_many = prewarm
        return self

    def __exit__(self, *exc):
        if self.had:
            self.v.prewarm_many = self.inner
        else:
            del self.v.prewarm_many
        return False


def harness(name: str):
    """A port-only harness module of the checkout's `tests/`, imported
    from the checkout: `torch_close_harness` (the apply engine's candidate
    rule, `engine_candidates` and `engine_launches`),
    `torch_catchup_harness` (`wire_node`, `enable_buckets`,
    `invariants_and_stream`: a node's ledger layer as the reference's
    Application builds it), `torch_herder_harness` (the relay, the node
    builder, the traffic, and `OverlayNet`: the relay's network over the
    real overlay), `torch_sim_harness` (`comparable`: a scenario block
    without its host-clock fields)."""
    import importlib
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def close_round(S, E, K, SC, st: dict, blobs: list, corrupted: set,
                prewarm: bool = True, native: bool = True,
                cold_reads: bool = False) -> dict:
    """One ledger on the card's LedgerManager and on its CPU twin, as a
    node runs it: TxSetFrame.trim_invalid through the side's verifier
    (the herder's call), a StellarValue over the trimmed set, then
    value_externalized. The card closes through the apply engine (through
    the Python phases if not `native`), the twin through the Python
    phases. Each side starts from an empty verify cache (they share the
    process's). Without `prewarm` the cache is flushed again between the
    card's validation and its close. Checks: the removed transactions are
    the corrupted ones on both sides; the card's verify launches are as
    derived from the set (one prewarm batch for two or more transactions,
    else one per transaction) and, in the close, the engine's one
    `prewarm_many` of the candidates derived from the state
    (`engine_candidates`), launching once per 8,192 of them the cache
    does not hold (none after the validation's prewarm, one in a cold
    close), or, in the Python phases, one `enqueue`s-and-`flush` per
    transaction left, launching once each in a cold close, none after the
    prewarm; every decision of the close equal to the C verifier's; the
    close paths as chosen (with `cold_reads`, the card root's entry cache
    is emptied just before the close, so that the close's point reads
    reach the root's read path); the card's SHA-256 launches as derived from
    the bucket list; and lcl_hash, each result pair, the bucket-list hash
    and the commitment root equal the twin's."""
    CH = harness("torch_close_harness")
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
        applied = ts.sort_for_apply()
        cands = CH.engine_candidates(lm.root, applied)
        want_e = CH.engine_launches(cands)
        calls, flushed = [], []
        if side == "card":
            lm.use_native_apply = native
            if cold_reads:
                lm.root._cache.clear()
        with EngineCalls(lm.app.sig_verifier, calls), \
                EnqueueCalls(lm.app.sig_verifier, flushed):
            e0, s0 = E.LAUNCHES, S.LAUNCHES
            t0 = time.perf_counter()
            try:
                lm.value_externalized(LedgerCloseData(seq, ts, value))
            finally:
                if side == "card":
                    lm.use_native_apply = True
            close_ms = (time.perf_counter() - t0) * 1e3
        check(lm.last_closed_ledger_num() == seq, "close %d applied" % seq)
        out[side] = {
            "hashes": {f.contents_hash() for f in frames},
            "removed": sorted(f.contents_hash() for f in removed),
            "val_ms": val_ms, "close_ms": close_ms, "e_val": e_val,
            "e_close": E.LAUNCHES - e0, "s_close": S.LAUNCHES - s0,
            "lcl": lm.lcl_hash,
            "results": [f.result_pair_xdr() for f in applied],
            "bucket_list": lm.app.bucket_manager.get_hash(),
            "root": lm.app.state_commitment.root, "txs": len(applied),
            "path": lm.last_apply_path, "cands": cands, "want_e": want_e,
            "calls": calls, "flushed": flushed}
        if side == "card":
            want_s = fresh_slots(S, SC, st, lm.app.bucket_manager.bucket_list)
    card, twin = out["card"], out["twin"]
    want_removed = sorted(card.pop("hashes") & corrupted)
    check(card["removed"] == twin["removed"] == want_removed,
          "close %d: the trimmed transactions are the %d corrupted ones"
          % (seq, len(want_removed)))
    n = len(blobs)
    want_val = 1 if n > 1 else n
    want_path = "native" if native else "python"
    check(card["path"] == want_path and twin["path"] == "python",
          "close %d: the card closed in the %s, the twin in the Python "
          "phases (%s, %s)" % (seq, "apply engine" if native else
                               "Python phases", card["path"], twin["path"]))
    calls, flushed = card.pop("calls"), card.pop("flushed")
    if native:
        # the engine's one verify callback a close, of the derived
        # candidates
        want_close = card["want_e"]
        check([t for t, _g in calls] == ([card["cands"]] if card["cands"]
                                         else []) and not flushed,
              "close %d: the engine's verify callback got the %d "
              "candidates derived from the state, in one call"
              % (seq, len(card["cands"])))
        check(want_close == (0 if prewarm else 1),
              "close %d: %d launches derived from the engine's candidates"
              % (seq, want_close))
    else:
        # the Python phases: each transaction's SignatureChecker enqueues
        # its hint-matched pairs and flushes once, a launch when the
        # cache misses
        want_close = 0 if prewarm else n - len(want_removed)
        check(not calls and len({m for (_k, _s, m), _g in flushed})
              == card["txs"], "close %d: the Python phases enqueued the "
              "pairs of each of the %d transactions, no prewarm_many"
              % (seq, card["txs"]))
        calls = [([t for t, _g in flushed], [g for _t, g in flushed])]
    check(card["e_val"] == want_val and card["e_close"] == want_close,
          "close %d: verify launches %d in validation, %d in the close "
          "(got %d, %d)" % (seq, want_val, want_close, card["e_val"],
                            card["e_close"]))
    for triples, got in calls:
        check(got == K.raw_verify_batch(triples), "close %d: the close's "
              "%d decisions == the C verifier's" % (seq, len(triples)))
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
    card.pop("cands")
    return card


def deep_destinations(accounts: dict, per_close: int):
    """C1's restored account IDs (`accounts`: level -> IDs) in the order
    the close phases pay them, each once: rounds of `per_close`, one from
    each of levels 4-9 and the rest (at least one) from level 10, while
    levels 4-9 last; then level 10's alone."""
    deep = sorted(DEEP_LEVEL_ENTRIES)
    top = max(accounts)
    rounds = min(len(accounts[lv]) for lv in deep)
    rest = max(per_close - len(deep), 1)
    out = []
    for r in range(rounds):
        out.extend(accounts[lv][r] for lv in deep)
        out.extend(accounts[top][r * rest:(r + 1) * rest])
    out.extend(accounts[top][rounds * rest:])
    return out


class CloseTraffic:
    """The reference bench's senders (`replay_bench`, bench.py:339-468)
    built with the port's TestAccount against the card side's state:
    `senders` senders (CLOSE_SENDERS), the first CLOSE_TXS armed with 19
    extra signers and a medium threshold of 20, the rest with one extra
    signer and a threshold of 2. Every key comes from SecretKey.from_seed;
    every `corrupt_every`-th payment (CLOSE_CORRUPT_EVERY; 0 for none) has
    one signature corrupted. With `deep` (account IDs, each paid once, in
    order), every CLOSE_DEEP_EVERY-th payment of a close pays the next of
    them instead of its mix's destination."""

    def __init__(self, lm, root_sk, senders: int = CLOSE_SENDERS,
                 corrupt_every: int = CLOSE_CORRUPT_EVERY, deep=None):
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
        self.deep = iter(deep) if deep is not None else None

    def _dest(self, i: int, dest):
        if self.deep is not None and i % CLOSE_DEEP_EVERY == 0:
            return next(self.deep)
        return dest

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
        return [self._signed(s, self.extra[i],
                             self._dest(i, self.root.account_id),
                             1000 + rnd)
                for i, s in enumerate(self.senders[:CLOSE_TXS])]

    def standard(self, rnd: int) -> list:
        """Two-signature payments between disjoint partner pairs (the
        standard mix's payments, bench.py:457-468)."""
        pay = self.senders[CLOSE_TXS:]
        return [self._signed(s, self.extra[CLOSE_TXS + i],
                             self._dest(i, pay[i ^ 1].account_id),
                             1000 + rnd)
                for i, s in enumerate(pay)]


def close_path(S, E, K, rng, flight_dir: str, card: str) -> dict:
    """C1-C5p of the module docstring; returns the launches by phase."""
    from stellar_core_tpu_torch import testing as T
    from stellar_core_tpu_torch.bucket import apply_buckets
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
    NH = harness("torch_catchup_harness")
    root_sk = T.root_secret_key(LEDGER_NETWORK_ID)
    node_seed = SecretKey(rng.bytes(32))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_close_") as bdir:
        # --- C1 ------------------------------------------------------------
        E.LAUNCHES = S.LAUNCHES = 0
        t0 = time.perf_counter()
        reg = MetricsRegistry()
        tr = Tracer()
        rec = FlightRecorder(tr, metrics=reg, out_dir=flight_dir)
        v = make_verifier("cuda-resilient", metrics=reg, tracer=tr,
                          flight_recorder=rec)
        h = make_hasher("cuda-resilient", metrics=reg, tracer=tr,
                        flight_recorder=rec)
        check(v.fallback is None and h.fallback is None,
              "C1: the card's stacks have no fallback")
        # the card's node as the reference's default node: its SQL root
        # reads through BucketDB (attached before the restore, as before
        # genesis); the twin's root reads SQL
        lm = close_side(bdir, v, h, True, root_sk, node_seed, metrics=reg,
                        tracer=tr, recorder=rec)
        ttr = Tracer()
        twin = close_side(None, make_verifier("cpu"), make_hasher("cpu"),
                          False, root_sk, node_seed, tracer=ttr)
        mgr, twin_mgr = lm.app.bucket_manager, twin.app.bucket_manager
        check(lm.root.bucket_backed() and not twin.root.bucket_backed(),
              "C1: the card's root reads through BucketDB, the twin's SQL")
        st = ledger_state(rng, bdir, card, n=CLOSE_STATE, phase="C1",
                          extra=[make_account_entry(
                              root_sk.public_key, GENESIS_TOTAL_COINS, 0,
                              LEDGER_START)], mgr=mgr)
        st.pop("mgr")
        st.pop("live")
        st.pop("deep")
        deep = deep_destinations(st.pop("accounts"),
                                 -(-CLOSE_TXS // CLOSE_DEEP_EVERY))
        slots = list_slots(mgr.bucket_list)
        # the twin's list holds the same bucket objects, in memory only
        for b in slots:
            twin_mgr.adopt_bucket(b)
        twin_mgr.assume_state(
            [{"curr": lev.curr.get_hash(), "snap": lev.snap.get_hash()}
             for lev in mgr.bucket_list.levels], LEDGER_START,
            LEDGER_PROTOCOL)
        check(twin_mgr.get_hash() == mgr.get_hash(),
              "C1: the twin's bucket list == the card's")
        # the card closes in the apply engine, the twin in the Python
        # phases: each close is held against the other path
        check(lm.use_native_apply, "C1: the card's close runs the engine")
        twin.use_native_apply = False
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
        check(lm.root.bucket_backed() and not twin.root.bucket_backed(),
              "C1: after set_last_closed_ledger the card's root reads "
              "through BucketDB (the list covers the restored state), "
              "the twin's SQL")
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
            "buckets %.1f s (decode %.1f, hash + file + index %.1f, of it "
            "the BucketDB index build %.2f), apply_buckets "
            "into a LedgerTxnRoot over sqlite :memory: %.1f s (%.1f us an "
            "entry); with the twin's list and its SQL root (%.1f s) %.1f "
            "s; first commitment root %.1f ms in %d launches; the card's "
            "BucketDB %s"
            % (card, CLOSE_STATE + 1, restore_s, st["generate_s"],
               st["setup_s"] - st["generate_s"], st["decode_s"],
               st["bucket_s"], st["index_s"], apply_s,
               apply_s / (CLOSE_STATE + 1) * 1e6,
               twin_apply_s, wall_s, first_ms, S.LAUNCHES,
               bucketdb_line(mgr, bdir)))
        st.update(card=lm, twin=twin)
        traffic = CloseTraffic(lm, root_sk, deep=deep)
        del deep

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
            ttr.clear()
            ttr.enable(capacity=65536)
            recorded.clear()
            v.prewarm_many = recording_prewarm
            if phase == "C3":
                # the cockpit's and BucketDB's aggregates of C3 alone
                lm.apply_stats.reset()
                mgr.bucketdb.stats.reset()
            else:
                streams = c4_begin(NH, lm, twin, bdir)
                c4_levels = {}
            E.LAUNCHES = S.LAUNCHES = 0
            t0 = time.perf_counter()
            rounds, per_close = [], []
            with GcPauses() as gcp:
                for k in range(closes):
                    # C3 runs both read paths on the card's node: its
                    # odd closes read SQL, its even closes BucketDB
                    bucket = phase != "C3" or (k + 1) % 2 == 0
                    if bucket:
                        lm.root.attach_bucketdb(mgr.bucketdb)
                    else:
                        lm.root.detach_bucketdb()
                    n_sp = len(tr.spans())
                    lv0 = level_hits(mgr.bucketdb)
                    rounds.append(close_round(S, E, K, SC, st, build(k),
                                              traffic.corrupted,
                                              cold_reads=phase == "C3"))
                    levels = {}
                    add_levels(levels, lv0, level_hits(mgr.bucketdb))
                    blob = lm.apply_stats.last_close
                    check(blob["path"] == "native" and (
                        blob["reads"]["lookups"] == {} if bucket else
                        blob["reads"]["bucket_reads"] == 0),
                        "%s close %d: the card's point reads all from %s "
                        "(%s)" % (phase, k + 1, "BucketDB" if bucket
                                  else "SQL", blob["reads"]))
                    per_close.append((bucket, tr.spans()[n_sp:], blob,
                                      levels))
                    if phase == "C4":
                        add_levels(c4_levels, {}, levels)
            lm.root.attach_bucketdb(mgr.bucketdb)
            wall_s = time.perf_counter() - t0
            v.prewarm_many = pw
            tr.disable()
            ttr.disable()
            apply_ms = {side: [sp.dur * 1e3 for sp in t.spans()
                               if sp.name == "close.apply"
                               and sp.dur is not None]
                        for side, t in (("card", tr), ("twin", ttr))}
            check(len(apply_ms["card"]) == len(apply_ms["twin"]) == closes,
                  "%s: one close.apply span a close on each side" % phase)
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
            log("%s close.apply (%s): the card's apply engine p50 %.2f ms, "
                "mean %.2f ms; the twin's Python phases p50 %.2f ms, mean "
                "%.2f ms; every close native on the card, python on the "
                "twin, no engine bail"
                % (phase, card,
                   float(np.percentile(apply_ms["card"], 50)),
                   float(np.mean(apply_ms["card"])),
                   float(np.percentile(apply_ms["twin"], 50)),
                   float(np.mean(apply_ms["twin"]))))
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
                          "sigs_per_s": sigs / (sum(val) / 1e3),
                          "apply_ms": apply_ms}
            if phase == "C3":
                out["C3"]["halves"] = c3_read_paths(lm, mgr, per_close,
                                                    close_s, card)
            else:
                out["C4"]["invariants"] = c4_end(
                    lm, twin, streams, tr, ttr, closes, card)
                check(all(c4_levels.get(lv, (0, 0))[1] > 0
                          for lv in range(4, 11)),
                      "C4: BucketDB hit each of levels 4-10 (%s)"
                      % json.dumps(c4_levels))
                log("C4 BucketDB levels probed (%s), [probes, hits] over "
                    "the %d closes: %s" % (card, closes,
                                           json.dumps(c4_levels)))

        # --- C5 ------------------------------------------------------------
        E.LAUNCHES = S.LAUNCHES = 0
        c5 = close_round(S, E, K, SC, st, traffic.multisig(C3_CLOSES),
                         traffic.corrupted, prewarm=False)
        out["verify"]["C5"], out["sha256"]["C5"] = E.LAUNCHES, S.LAUNCHES
        log("C5 cold close (%s): %d txs after trimming %d, the verify cache "
            "flushed between validation and close: %d launches in the close "
            "(the apply engine's one drain of its candidates), close %.1f "
            "ms against C3's p50 %.1f ms"
            % (card, c5["txs"], len(c5["removed"]), c5["e_close"],
               c5["close_ms"],
               float(np.percentile(out["C3"]["close_ms"], 50))))
        # --- C5p: the same cold close through the Python phases ------------
        E.LAUNCHES = S.LAUNCHES = 0
        c5p = close_round(S, E, K, SC, st, traffic.multisig(C3_CLOSES + 1),
                          traffic.corrupted, prewarm=False, native=False)
        out["verify"]["C5p"], out["sha256"]["C5p"] = E.LAUNCHES, S.LAUNCHES
        log("C5p cold close in the Python phases (%s): %d txs after "
            "trimming %d: %d launches in the close (one per transaction, "
            "at its first signature check), close %.1f ms against C5's "
            "%.1f ms in the apply engine"
            % (card, c5p["txs"], len(c5p["removed"]), c5p["e_close"],
               c5p["close_ms"], c5["close_ms"]))
        sce = lm.app.state_commitment
        t0 = time.perf_counter()
        check(sce.root == sce.from_scratch_root(mgr.bucket_list),
              "C5, C5p: the commitment root == from_scratch_root")
        log("C5 from_scratch_root over the final list: %.1f s"
            % (time.perf_counter() - t0))
        c5_fault(E, K, lm, traffic, reg, tr, rec)
        c4_invariant_abort(NH, E, S, lm, traffic, bdir, card)
        for m in (mgr, twin_mgr):
            m.shutdown()
    return out


def c3_read_paths(lm, mgr, per_close: list, close_s: list,
                  card: str) -> dict:
    """C3's two read paths on the card's node, from one call: for each
    half (the closes that read SQL, those that read BucketDB) the p50 of
    `close.prefetch`, `close.apply` and `ledger.ledger.close`; then
    BucketDbStats, the cockpit's `apply_breakdown()` (held to the
    reference test's `_breakdown_sums` bound: its per-op parts and the
    rest add up to the apply wall) and the engine's clusters."""
    halves = {}
    for name, want in (("SQL", False), ("BucketDB", True)):
        sel = [(spans, close_s[i]) for i, (b, spans, _bl, _lv) in
               enumerate(per_close) if b == want]
        levels = {}
        for b, _sp, _bl, lv in per_close:
            if b == want:
                add_levels(levels, {}, lv)
        ms = {}
        for span in ("close.prefetch", "close.apply"):
            ms[span] = [sp.dur * 1e3 for spans, _c in sel for sp in spans
                        if sp.name == span and sp.dur is not None]
        ms["ledger.ledger.close"] = [c * 1e3 for _s, c in sel]
        check(len(ms["close.apply"]) == len(sel) and len(ms[
            "close.prefetch"]) == (len(sel) if want else 0),
            "C3 %s half: one close.apply a close, %s" % (
                name, "one close.prefetch a close (the batched BucketDB "
                "pass)" if want else "no close.prefetch (the engine "
                "loads its keys itself on a SQL root)"))
        check(all(levels.get(lv, (0, 0))[1] > 0
                  for lv in range(4, 11)) if want else levels == {},
              "C3 %s half: %s (%s)" % (
                  name, "BucketDB hit each of levels 4-10" if want
                  else "no BucketDB probe",
                  json.dumps(levels)))
        halves[name] = {k: float(np.percentile(x, 50)) if x else None
                        for k, x in ms.items()}
        halves[name]["levels"] = levels
        log("C3 %s reads (%s): %d closes; p50 close.prefetch %s, "
            "close.apply %.2f ms, ledger.ledger.close %.2f ms; BucketDB "
            "levels probed, [probes, hits]: %s"
            % (name, card, len(sel),
               "%.2f ms" % halves[name]["close.prefetch"] if want else
               "none (deferred to the engine)",
               halves[name]["close.apply"],
               halves[name]["ledger.ledger.close"], json.dumps(levels)))
    db = mgr.bucketdb
    dj = db.stats.to_json()
    log("C3 BucketDbStats (%s), the BucketDB half: reads %s; levels "
        "probed %s; bloom %s, false-positive rate %.4f; %d bytes read; "
        "prefetch %s" % (card, json.dumps(dj["reads"]),
                         json.dumps(dj["levels"]), json.dumps(dj["bloom"]),
                         db.stats.false_positive_rate(), dj["bytes_read"],
                         json.dumps(dj["prefetch"])))
    ab = lm.apply_stats.apply_breakdown()
    total_ms = sum(ab["per_op_ms"].values()) + ab["other_ms"]
    wall_ms = ab["apply_wall_s"] * 1e3
    check(abs(total_ms - wall_ms) < max(0.5, 1e-3 * wall_ms)
          and ab["other_ms"] >= 0.0,
          "C3 apply_breakdown: per-op %.3f + other %.3f ms == the apply "
          "wall %.3f ms" % (total_ms - ab["other_ms"], ab["other_ms"],
                            wall_ms))
    check(ab["bails"] == {} and ab["closes"].get("native", 0)
          == len(per_close), "C3 apply_breakdown: %d closes in the "
          "engine, no bail" % len(per_close))
    log("C3 apply_breakdown (%s): apply wall %.1f ms over %d closes; per "
        "op ms %s (counts %s), other %.1f ms; bails %s; state reads %s"
        % (card, wall_ms, len(per_close), json.dumps(ab["per_op_ms"]),
           json.dumps(ab["op_counts"]), ab["other_ms"],
           json.dumps(ab["bails"]), json.dumps(ab["state_reads"])))
    cl = ab["clusters"]
    log("C3 clusters (%s): the last close %d clusters, the widest %d "
        "transactions, %d workers; %d parallel closes, %d serial, %d "
        "degraded; the last close's cluster apply %.2f ms"
        % (card, cl["last_count"], cl["last_width"], cl["last_workers"],
           cl["parallel_closes"], cl["serial_closes"], cl["degraded"],
           cl["last_apply_ms"]))
    return {"halves": halves, "clusters": cl,
            "bucketdb": {"reads": dj["reads"], "bytes_read":
                         dj["bytes_read"], "fp_rate":
                         db.stats.false_positive_rate()}}


def c4_begin(NH, lm, twin, bdir: str) -> dict:
    """C4's nodes run every invariant and stream their close meta, each
    to a file: the card's node and the twin with INVARIANT_CHECKS
    [".*"] and METADATA_OUTPUT_STREAM set, wired again as the
    reference's Application wires them (`invariants_and_stream`)."""
    paths = {}
    for name, side in (("card", lm), ("twin", twin)):
        cfg = side.app.config
        paths[name] = os.path.join(bdir, "c4-meta-%s.xdr" % name)
        cfg.INVARIANT_CHECKS = [".*"]
        cfg.METADATA_OUTPUT_STREAM = paths[name]
        NH.invariants_and_stream(side.app)
        check(len(side.app.invariant_manager.enabled_names()) == 6,
              "C4: the %s runs all six invariants" % name)
    return paths


def c4_end(lm, twin, paths: dict, tr, ttr, closes: int,
           card: str) -> dict:
    """After C4: both streams closed and read back through
    `read_close_meta_stream`, equal record for record and byte for byte,
    one record a close; the invariants' ms per close (the tx-phase delta
    snapshot, `check_on_ledger_close`) on each side; then both nodes back
    to the defaults (no invariant, no stream)."""
    from stellar_core_tpu_torch.ledger.close_meta_stream import (
        read_close_meta_stream,
    )
    recs, raw = {}, {}
    for name, side in (("card", lm), ("twin", twin)):
        side.app.close_meta_stream.close()
        recs[name], err = read_close_meta_stream(paths[name])
        check(err is None and len(recs[name]) == closes,
              "C4: the %s's stream holds %d whole records" % (name, closes))
        with open(paths[name], "rb") as fh:
            raw[name] = fh.read()
        cfg = side.app.config
        cfg.INVARIANT_CHECKS, cfg.METADATA_OUTPUT_STREAM = [], ""
        harness("torch_catchup_harness").invariants_and_stream(side.app)
    check([r.to_xdr() for r in recs["card"]] ==
          [r.to_xdr() for r in recs["twin"]] and raw["card"] == raw["twin"],
          "C4: the card's close-meta stream == the twin's, record for "
          "record, byte for byte (%d bytes)" % len(raw["card"]))
    check(recs["card"][-1].value.ledgerHeader.hash == lm.lcl_hash,
          "C4: the stream's last record carries the LCL's hash")
    ms = {}
    for name, t in (("card", tr), ("twin", ttr)):
        for span in ("close.invariant_snapshot", "close.invariants"):
            d = [sp.dur * 1e3 for sp in t.spans()
                 if sp.name == span and sp.dur is not None]
            check(len(d) == closes, "C4: one %s span a close on the %s"
                  % (span, name))
            ms[(name, span)] = (float(np.percentile(d, 50)),
                                float(np.mean(d)))
    log("C4 invariants (%s), all six on both nodes, ms per close p50 / "
        "mean: the card's tx-phase delta snapshot %.2f / %.2f, "
        "check_on_ledger_close %.2f / %.2f; the twin's %.2f / %.2f, "
        "%.2f / %.2f; the close-meta streams %d records, %d bytes each, "
        "equal"
        % ((card,) + ms[("card", "close.invariant_snapshot")]
           + ms[("card", "close.invariants")]
           + ms[("twin", "close.invariant_snapshot")]
           + ms[("twin", "close.invariants")]
           + (closes, len(raw["card"]))))
    return {"ms": {"%s %s" % k: v for k, v in ms.items()},
            "stream_bytes": len(raw["card"])}


def c4_invariant_abort(NH, E, S, lm, traffic, bdir: str, card: str) -> None:
    """The invariant case, last on the card's node (a tripped invariant
    stops a node, as in the reference, so nothing closes on it after):
    INVARIANT_CHECKS [".*"] and a close-meta stream again, then one
    C4-shaped close on the Python phases whose payment mints lumens (the
    payment's apply credits the destination without debiting the source,
    as `tests/test_invariants.py::test_corrupted_op_aborts_real_close`
    does): InvariantDoesNotHold, the LCL and its hash unchanged, and no
    record in the stream."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.herder.txset import TxSetFrame
    from stellar_core_tpu_torch.invariant.invariants import (
        InvariantDoesNotHold,
    )
    from stellar_core_tpu_torch.ledger.close_meta_stream import (
        read_close_meta_stream,
    )
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerCloseData
    from stellar_core_tpu_torch.transactions import account_helpers as AH
    from stellar_core_tpu_torch.transactions.operations import (
        PaymentOpFrame, PaymentResultCode,
    )
    from stellar_core_tpu_torch.transactions.transaction_frame import (
        TransactionFrame,
    )
    path = os.path.join(bdir, "c4-abort-meta.xdr")
    cfg = lm.app.config
    cfg.INVARIANT_CHECKS, cfg.METADATA_OUTPUT_STREAM = [".*"], path
    NH.invariants_and_stream(lm.app)
    frames = [TransactionFrame.make_from_wire(
        LEDGER_NETWORK_ID, X.TransactionEnvelope.from_xdr(b))
        for b in traffic.standard(C4_CLOSES + 2)]
    frames = [f for f in frames if f.contents_hash() not in
              traffic.corrupted]
    ts = TxSetFrame(LEDGER_NETWORK_ID, lm.lcl_hash, frames)
    check(not ts.trim_invalid(lm.ltx_root(), lm.app.sig_verifier),
          "C4 invariant: the set validates whole")
    header = lm.root.get_header()
    seq, lcl = header.ledgerSeq, lm.lcl_hash
    value = X.StellarValue(
        txSetHash=ts.get_contents_hash(hasher=lm.app.batch_hasher),
        closeTime=header.scpValue.closeTime + 1, upgrades=[],
        ext=X.StellarValueExt(0, None))

    def minting_apply(self, ltx):
        body = self.op.body.value
        dest = AH.load_account(ltx, body.destination.account_id)
        AH.add_balance(ltx.load_header(), dest, body.amount)
        return self.set_inner(PaymentResultCode.SUCCESS)

    real = PaymentOpFrame.do_apply
    PaymentOpFrame.do_apply = minting_apply
    lm.use_native_apply = False
    raised = None
    t0 = time.perf_counter()
    try:
        lm.close_ledger(LedgerCloseData(seq + 1, ts, value))
    except InvariantDoesNotHold as e:
        raised = e
    finally:
        PaymentOpFrame.do_apply = real
        lm.use_native_apply = True
        lm.app.close_meta_stream.close()
    ms = (time.perf_counter() - t0) * 1e3
    recs, err = read_close_meta_stream(path)
    check(raised is not None and "ConservationOfLumens" in str(raised)
          and lm.last_closed_ledger_num() == seq and lm.lcl_hash == lcl
          and err is None and recs == []
          and lm.apply_stats.last_close["path"] == "failed",
          "C4 invariant: a close of %d payments that mint lumens raises "
          "InvariantDoesNotHold (%s); LCL %d and its hash unchanged, no "
          "close-meta record written" % (len(frames), raised, seq))
    log("C4 invariant abort (%s): a close of %d payments whose apply "
        "mints lumens, on the Python phases, raised InvariantDoesNotHold "
        "in %.1f ms (%s); LCL %d and its hash unchanged, the stream empty"
        % (card, len(frames), ms, raised, seq))


def c5_fault(E, K, lm, traffic, reg, tr, rec) -> None:
    """The fault case after C5: the card's close with `device.dispatch`
    armed on its verifier. The fault raises out of the apply engine's
    verify callback, and the close raises it as SignatureVerifyError: the
    LCL, its hash and the root's entries stay as they were, no transaction
    is applied by the Python phases instead, and nothing launches or is
    verified on the CPU."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.crypto.batch_verifier import make_verifier
    from stellar_core_tpu_torch.herder.txset import TxSetFrame
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerCloseData
    from stellar_core_tpu_torch.transactions import transaction_frame as TF
    from stellar_core_tpu_torch.transactions.signature_checker import (
        SignatureVerifyError,
    )
    from stellar_core_tpu_torch.util.faults import FaultInjector, \
        InjectedFault
    faults = FaultInjector(metrics=reg)
    vf = make_verifier("cuda-resilient", metrics=reg, tracer=tr,
                       faults=faults, flight_recorder=rec)
    frames = [TF.TransactionFrame.make_from_wire(
        LEDGER_NETWORK_ID, X.TransactionEnvelope.from_xdr(b))
        for b in traffic.standard(C4_CLOSES + 1)]
    frames = [f for f in frames if f.contents_hash() not in
              traffic.corrupted]
    ts = TxSetFrame(LEDGER_NETWORK_ID, lm.lcl_hash, frames)
    header = lm.root.get_header()
    seq = header.ledgerSeq
    value = X.StellarValue(
        txSetHash=ts.get_contents_hash(hasher=lm.app.batch_hasher),
        closeTime=header.scpValue.closeTime + 1, upgrades=[],
        ext=X.StellarValueExt(0, None))
    lcl, owner = lm.lcl_hash, frames[0].source_account_id()
    before = lm.root.get_entry(X.LedgerKey.account(owner)).to_xdr()
    applied, cpu = [], []
    saved = (lm.app.sig_verifier, TF.TransactionFrame.apply,
             K.raw_verify, K.raw_verify_batch)
    lm.app.sig_verifier = vf
    TF.TransactionFrame.apply = lambda *a, **k: applied.append(1)
    K.raw_verify = lambda *a: cpu.append(1)
    K.raw_verify_batch = lambda t: cpu.append(len(t))
    faults.configure("device.dispatch")
    K.flush_verify_cache()
    e0 = E.LAUNCHES
    raised = None
    try:
        lm.close_ledger(LedgerCloseData(seq + 1, ts, value))
    except SignatureVerifyError as e:
        raised = e
    finally:
        (lm.app.sig_verifier, TF.TransactionFrame.apply, K.raw_verify,
         K.raw_verify_batch) = saved
    m = {k: d["count"] for k, d in reg.to_json().items()
         if k in ("crypto.verify.dispatch-failure",
                  "fault.injected.device.dispatch") and "count" in d}
    check(raised is not None and isinstance(raised.__cause__, InjectedFault)
          and lm.last_closed_ledger_num() == seq
          and lm.lcl_hash == lcl and not applied and not cpu
          and E.LAUNCHES == e0
          and lm.root.get_entry(X.LedgerKey.account(owner)).to_xdr()
          == before,
          "C5 fault: device.dispatch in the engine's verify callback fails "
          "the close of %d transactions; LCL %d and its hash unchanged, "
          "nothing applied in Python, launched or verified on the CPU"
          % (len(frames), seq))
    log("C5 fault: the close raised %r out of the apply engine's verify "
        "callback; LCL %d unchanged; meters %s" % (raised, seq, m))


# --- the catchup phases (R1-R5): publish, catch up on the card, restart --

def r_node(tmp: str, name: str, archive: str, verifier, hasher,
           writable: bool = False, recent: int = 0, metrics=None,
           tracer=None, recorder=None, faults=None,
           bucket_reads: bool = True):
    """A started port node, wired by hand as the reference's Application
    wires one, so that each phase hands it its own verifier, hasher and
    probes (M1 starts the port's `Application` through the command
    line): sqlite in `tmp`/`name`.db,
    buckets in `tmp`/`name`-buckets (so a second node of the same name
    restarts over the first one's files) through
    `torch_catchup_harness.wire_node`, its SQL root reading through
    BucketDB when `bucket_reads` (the reference's default) and from SQL
    otherwise, the local-directory archive `archive`, and the verifier
    and hasher it is handed. Like `Application.start`, it restores the
    last known ledger or starts a new one. `recent` > 0 makes a gap's
    catchup a recent one of that many ledgers (minimal otherwise)."""
    from types import SimpleNamespace
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
    cfg.BUCKETDB_READS = bucket_reads
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
        batch_hasher=hasher, status_manager=StatusManager(),
        network_root_key=lambda: SecretKey.from_seed(
            sha256(cfg.network_id)))
    check(cfg.network_id == LEDGER_NETWORK_ID, "R: the network's id")
    app.state_commitment = SC.StateCommitmentEngine(app)
    app.ledger_manager = LedgerManager(app)
    harness("torch_catchup_harness").wire_node(
        app, os.path.join(tmp, name + "-buckets"))
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


def r_drains(archive: str, first: int, chunk: int,
             last: int = R_TIP) -> list:
    """The catchup's verify drains from ledger `first` to `last` (a
    checkpoint), derived
    from the archive alone: (signatures, launches) per drain. A
    checkpoint drains every signature whose signer exists when it starts;
    the senders' extra signers exist from ledger 3 on (its transactions
    add them), so from genesis checkpoint 63 first drains one master-key
    signature a transaction, and after ledger 3 re-drains the other
    signatures of ledgers 4-63. A drain launches once per `chunk` (the
    verifier's largest bucket) or part of one."""
    drains = []
    for c in range(R_FREQ - 1, last + 1, R_FREQ):
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
    `prewarm_many` (its triples, decisions, launches and seconds, and the
    ledger whose close made it, None for a checkpoint's drain), the
    triples the card's verify_many received, the verify and SHA-256
    launches inside each close (each close's SHA-256 launches against
    fresh_slots' derivation, its verify launches against the apply
    engine's candidates, `engine_launches`, derived before it from the
    state, and the path it took), and every call of the C verifier."""

    def __init__(self, S, E, K, SC, app):
        self.S, self.E, self.K, self.SC, self.app = S, E, K, SC, app
        # drains: the triples each sent to the card, their decisions,
        # its launches and seconds
        self.drains, self.card_triples, self.closes = [], [], {}
        self.cpu_calls, self.close_errors = [], []
        self.in_close = None
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
                                "s": time.perf_counter() - t0,
                                "in_close": self.in_close})
            return got

        def verify_many(triples):
            self.card_triples.extend(triples)
            return self._vm(triples)

        CH = harness("torch_close_harness")

        def close(lcd):
            want_e = CH.engine_launches(CH.engine_candidates(
                lm.root, lcd.tx_set.sort_for_apply())) \
                if lm.use_native_apply else None
            self.in_close = lcd.ledger_seq
            e0, s0, t0 = E.LAUNCHES, S.LAUNCHES, time.perf_counter()
            try:
                self._close(lcd)
            except Exception as e:
                self.close_errors.append((lcd.ledger_seq, repr(e)))
                raise
            finally:
                self.in_close = None
            want = fresh_slots(S, self.SC, self.st,
                               app.bucket_manager.bucket_list)
            self.closes[lcd.ledger_seq] = (
                E.LAUNCHES - e0, S.LAUNCHES - s0, want,
                time.perf_counter() - t0, t0, want_e, lm.last_apply_path)

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
        return all(c[1] == c[2] for c in self.closes.values())

    def close_launches(self, lo: int, hi: int) -> list:
        return [self.closes[s][0] for s in range(lo, hi + 1)]

    def engine_as_derived(self, lo: int, hi: int) -> bool:
        """Every close from `lo` to `hi` ran in the apply engine and
        launched verify as its candidates derive."""
        return all(self.closes[s][6] == "native"
                   and self.closes[s][0] == self.closes[s][5]
                   for s in range(lo, hi + 1))

    def checkpoint_drains(self) -> list:
        return [d for d in self.drains
                if d["triples"] and d["in_close"] is None]

    def close_decisions_ok(self, K) -> bool:
        """The decisions of the drains inside closes == the C verifier's
        (call after the probe has exited: it counts C verifier calls)."""
        ds = [d for d in self.drains if d["triples"] and d["in_close"]]
        return all(K.raw_verify_batch(d["triples"]) == d["decisions"]
                   for d in ds)


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
    """R1 of the module docstring; returns the publisher and its archive.
    The objects alive before it are frozen out of the collector's reach
    for its length (one full collection first, so no garbage is frozen)."""
    import gc
    gc.collect()
    gc.freeze()
    try:
        return r1_frozen(S, E, K, tmp, card, gc.get_freeze_count())
    finally:
        gc.unfreeze()


def r1_frozen(S, E, K, tmp: str, card: str, frozen: int) -> dict:
    """R1 itself, with the `frozen` objects of the earlier phases out of
    the collector's reach."""
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
                 make_hasher("cpu"), writable=True, bucket_reads=False)
    check(not pub.ledger_manager.root.bucket_backed(),
          "R1: the publisher's root reads SQL")
    # the history is applied by the Python phases, so the card's engine
    # replays (R2) are held against another path's ledgers
    pub.ledger_manager.use_native_apply = False
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
        "(%d buckets named by its HAS); %s, %d objects of the earlier phases "
        "frozen"
        % (card, R_TOP, CLOSE_TXS, CLOSE_TXS, CLOSE_SIGS, wall,
           float(np.percentile(close_ms, 50)), p99(close_ms), len(close_ms),
           R_FREQ - 1, R_TIP,
           "/".join("%.2f" % x for x in publish_s if x > 1e-3), size,
           len(has.bucket_hashes()), gcp.line(), frozen))
    header = r_header(pub, R_TIP)
    return {"pub": pub, "archive": archive, "root": roots[R_TIP],
            "bucket_list": header.bucketListHash, "roots": roots}


def x1_routes(what: str, t, values: list, card: str) -> dict:
    """X1's check of one type: `values` encoded by the codec's C route
    (`native.xdr_pack_fn`) and by its Python route (`fastcodec`), each
    route's bytes decoded by both; every encoding byte-equal, every
    decoding re-encoding to the same bytes, each C decoding ending at its
    buffer's end. Timed with the cyclic collector off, so the times are
    the codecs' own (L1's decode runs with it on). Returns the ms of each
    route's encode and decode."""
    import gc
    from stellar_core_tpu_torch import native
    from stellar_core_tpu_torch.xdr import fastcodec
    c_pack, c_unpack = native.xdr_pack_fn(t), native.xdr_unpack_fn(t)
    check(c_pack is not None and c_unpack is not None,
          "X1: the C route has a program for %s" % t.__name__)
    f_pack, f_unpack = fastcodec.compile_pack(t), fastcodec.compile_unpack(t)

    def f_bytes(v):
        out = []
        f_pack(out.append, v)
        return b"".join(out)

    ms = {}
    gc_was = gc.isenabled()
    gc.disable()
    try:
        t0 = time.perf_counter()
        cb = [c_pack(v) for v in values]
        ms["c_encode"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        fb = [f_bytes(v) for v in values]
        ms["fastcodec_encode"] = (time.perf_counter() - t0) * 1e3
        check(cb == fb, "X1: %s: %d values, the C route's bytes == "
              "fastcodec's" % (what, len(values)))
        del fb
        t0 = time.perf_counter()
        cv = [c_unpack(b) for b in cb]
        ms["c_decode"] = (time.perf_counter() - t0) * 1e3
        check(all(end == len(b) for (_v, end), b in zip(cv, cb)),
              "X1: %s: each C decoding ends at its buffer's end" % what)
        t0 = time.perf_counter()
        fv = [f_unpack(b, 0)[0] for b in cb]
        ms["fastcodec_decode"] = (time.perf_counter() - t0) * 1e3
        check([c_pack(v) for v in fv] == cb
              and [c_pack(v) for v, _e in cv] == cb,
              "X1: %s: each route's decoding re-encodes to the same bytes"
              % what)
        n_bytes = sum(len(b) for b in cb)
    finally:
        if gc_was:
            gc.enable()
    log("X1 codec, %s (%s): %d values, %d bytes; the collector off, "
        "encode: C %.1f ms, fastcodec %.1f ms; decode: C %.1f ms, "
        "fastcodec %.1f ms; bytes equal"
        % (what, card, len(values), n_bytes, ms["c_encode"],
                   ms["fastcodec_encode"], ms["c_decode"],
                   ms["fastcodec_decode"]))
    return ms


def x1_entries(X, live: list, card: str) -> dict:
    """X1, first half: L1's live entries through both codec routes."""
    return x1_routes("L1's %d LedgerEntry records" % len(live),
                     X.LedgerEntry, live, card)


def x1_tx_history(r1: dict, card: str) -> dict:
    """X1, second half: the TransactionHistoryEntry records of R1's
    checkpoint-127 transactions file (decoded here by fastcodec) through
    both codec routes, which must also give the file's own bytes."""
    import gzip
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.history.archive import category_path
    from stellar_core_tpu_torch.xdr import fastcodec
    gz = os.path.join(r1["archive"], category_path("transactions", R_TIP,
                                                   ".xdr.gz"))
    with gzip.open(gz, "rb") as g:
        raw = g.read()
    bodies, pos = [], 0
    while pos < len(raw):
        size = int.from_bytes(raw[pos:pos + 4], "big") & 0x7FFFFFFF
        bodies.append(raw[pos + 4:pos + 4 + size])
        pos += 4 + size
    f_unpack = fastcodec.compile_unpack(X.TransactionHistoryEntry)
    values = [f_unpack(b, 0)[0] for b in bodies]
    check(len(values) == R_FREQ and all(
        X.TransactionHistoryEntry.from_xdr(b).to_xdr() == b
        for b in bodies), "X1: checkpoint %d's file holds %d ledgers, "
        "each re-encoding to its own bytes" % (R_TIP, R_FREQ))
    return x1_routes("checkpoint %d's transactions file" % R_TIP,
                     X.TransactionHistoryEntry, values, card)


def r_header(app, seq: int):
    from stellar_core_tpu_torch import xdr as X
    return X.LedgerHeader.from_xdr(app.database.execute(
        "SELECT data FROM ledgerheaders WHERE ledgerseq = ?",
        (seq,)).fetchone()[0])


def r2_complete(S, E, K, SC, tmp: str, r1: dict, flight_dir: str,
                card: str, native: bool = True) -> dict:
    """R2 of the module docstring: a complete catchup on the card, its
    closes in the apply engine; R2p (`native` False) a complete catchup
    to the first checkpoint on a second fresh node whose closes run the
    Python phases."""
    phase, name = ("R2", "r2") if native else ("R2p", "r2p")
    top = R_TIP if native else R_FREQ - 1
    points = range(R_FREQ - 1, top + 1, R_FREQ)
    from stellar_core_tpu_torch.catchup import CatchupConfiguration
    from stellar_core_tpu_torch.crypto.batch_verifier import CudaSigVerifier
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    from stellar_core_tpu_torch.util.tracing import FlightRecorder, Tracer
    from stellar_core_tpu_torch.work.basic_work import State
    pub, archive = r1["pub"], r1["archive"]
    reg, tr = MetricsRegistry(), Tracer()
    rec = FlightRecorder(tr, metrics=reg, out_dir=flight_dir)
    v, h = card_stacks(reg, tr, rec)
    node = r_node(tmp, name, archive, v, h, metrics=reg, tracer=tr,
                  recorder=rec)
    node.ledger_manager.use_native_apply = native
    check(node.ledger_manager.root.bucket_backed(),
          "%s: the card node's root reads through BucketDB" % phase)
    want = r_drains(archive, 2, CudaSigVerifier.BUCKETS[-1], top)
    K.flush_verify_cache()
    E.LAUNCHES = S.LAUNCHES = 0
    tr.enable(capacity=1 << 16)
    t0 = time.perf_counter()
    with RProbe(S, E, K, SC, node) as pr, GcPauses() as gcp, \
            LogLines("stellar.History", "prefetch coverage") as summary:
        work = node.catchup_manager.start_catchup(
            CatchupConfiguration.complete() if native
            else CatchupConfiguration(top))
        check(r_crank_until(node, work.is_done, 900.0),
              "%s: the catchup finished" % phase)
    wall = time.perf_counter() - t0
    tr.disable()
    lm = node.ledger_manager
    check(lm.root.bucket_backed() and len(summary.lines) == len(points),
          "%s: the root still reads through BucketDB; one prefetch "
          "summary a checkpoint (%d)" % (phase, len(summary.lines)))
    for line in summary.lines:
        log("%s prefetch (%s): %s" % (phase, card, line))
    check(work.state == State.SUCCESS and lm.is_synced()
          and lm.last_closed_ledger_num() == top,
          "%s: SUCCESS at LCL %d" % (phase, top))
    check(r_hashes(node.database, 1, top) == r_hashes(pub.database, 1, top),
          "%s: every replayed ledger's hash == the publisher's" % phase)
    check(node.bucket_manager.get_hash() == r_header(pub, top).bucketListHash
          and node.state_commitment.root == r1["roots"][top],
          "%s: the bucket-list hash and commitment root == the "
          "publisher's at %d" % (phase, top))
    drains = pr.checkpoint_drains()
    launches = [d["launches"] for d in drains]
    check([len(d["triples"]) for d in drains]
          == [n for n, _l in want] and launches == [n for _n, n in want]
          and E.LAUNCHES == sum(launches),
          "%s: verify launches per drain %s as derived from the archive "
          "(signatures, launches) %s" % (phase, launches, want))
    check(len(pr.card_triples) == len(set(pr.card_triples)),
          "%s: every distinct triple verified on the card exactly once "
          "(%d)" % (phase, len(pr.card_triples)))
    check(not any(pr.close_launches(2, top)),
          "%s: no verify launch inside a replayed close" % phase)
    paths = {pr.closes[q][6] for q in range(2, top + 1)}
    if native:
        check(pr.engine_as_derived(2, top),
              "R2: every replayed close ran in the apply engine, its "
              "candidates all in the cache (none derived to launch)")
    else:
        check(paths == {"python"}, "R2p: every replayed close ran the "
              "Python phases")
    check(pr.cpu_calls == [], "%s: no signature verified on the CPU"
          % phase)
    check(pr.sha_as_derived(), "%s: SHA-256 launches per close as derived "
          "from the bucket list (%d in all)" % (phase, S.LAUNCHES))
    ledgers = top - 1
    per_tx = [v for c in points
              for v in archive_ledgers(archive, c).values()]
    txs, sigs = sum(len(v) for v in per_tx), sum(sum(v) for v in per_tx)
    drain_n = len(pr.card_triples)
    drain_s = sum(d["s"] for d in pr.drains)
    spans = r_spans(tr)
    apply_ms = [d["catchup.apply_ledger"] for d in spans.values()
                if "catchup.apply_ledger" in d]
    apply_mean = sum(ms for ms, _n in apply_ms) / max(
        sum(n for _ms, n in apply_ms), 1)
    log("%s complete catchup to %d (%s), closes in the %s: %d ledgers in "
        "%.1f s "
        "= %.2f ledgers/s, %.0f transactions/s, %.0f signatures/s end to "
        "end; catchup.apply_ledger mean %.1f ms; verify launches %d "
        "(drains %s), none in the %d replayed closes; SHA-256 launches %d; "
        "the drains %d triples in %.2f s = %.0f sigs/s; %s"
        % (phase, top, card, "apply engine" if native else "Python phases",
           ledgers, wall, ledgers / wall, txs / wall, sigs / wall,
           apply_mean, E.LAUNCHES, launches, len(pr.closes), S.LAUNCHES,
           drain_n, drain_s, drain_n / drain_s, gcp.line()))
    log("%s spans: %s" % (phase, r_span_line(spans)))
    out = {"verify": E.LAUNCHES, "sha256": S.LAUNCHES,
           "drain_launches": launches, "ledgers_per_s": ledgers / wall,
           "apply_ms": apply_mean}
    # the card's busy share: the drains replayed from an empty cache
    l0 = E.LAUNCHES
    prof = profile_drain(
        lambda: [(K.flush_verify_cache(), v.prewarm_many(d["triples"]))[1]
                 for d in drains], "ed25519_verify_kernel", cpu=False)
    check(prof["result"] == [d["decisions"] for d in drains]
          and E.LAUNCHES - l0 == sum(launches),
          "%s replay: the same decisions in %d launches"
          % (phase, sum(launches)))
    log_profile("%s replay of the %d drains (CUDA activity only)"
                % (phase, len(drains)), prof, "ed25519_verify_kernel")
    if prof["device_events"]:
        log("%s card busy %.3f ms over the drains' %.1f ms = %.2f%%, over "
            "the catchup's %.1f s = %.3f%%"
            % (phase, prof["busy_ms"], drain_s * 1e3,
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
    ix = bm.bucketdb.stats.to_json()["index"]
    with bm.bucketdb._lock:
        n_idx = len(bm.bucketdb._indexes)
    check(lm.root.bucket_backed() and n_idx > 0
          and ix["loads"] == n_idx and ix["builds"] == 0
          and ix["load_failures"] == 0,
          "R3: the restart loaded the %d persisted sidecars with no "
          "rebuild (loads %d, builds %d) and passed _check_bucket_coverage "
          "(the root reads through BucketDB)" % (n_idx, ix["loads"],
                                                  ix["builds"]))
    log("R3 restart BucketDB (%s): %s" % (
        card, bucketdb_line(bm, os.path.join(tmp, "r2-buckets"))))
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
    e, s, ws, close_s, _t0, want_e, path = pr.closes[R_TIP + 1]
    txs = len(lcd_from_db(pub.database, R_TIP + 1).tx_set.frames)
    check(lm.lcl_hash.hex() == r_hashes(pub.database, R_TIP + 1,
                                        R_TIP + 1)[R_TIP + 1],
          "R3: ledger %d's hash == the publisher's" % (R_TIP + 1))
    check(path == "native" and e == want_e == 1 and s == ws
          and pr.cpu_calls == [],
          "R3: the cold close ran in the apply engine and launched verify "
          "as its candidates derive (%d of %d; the Python phases' one per "
          "transaction, derived: %d) and SHA-256 as derived (%d of "
          "%d), none on the CPU" % (e, want_e, txs, s, ws))
    check(pr.close_decisions_ok(K), "R3: the engine's decisions == the C "
          "verifier's")
    log("R3 restart (%s): load_last_known_ledger over the SQL file and "
        "bucket directory %.2f s; the first commitment root %.1f ms in %d "
        "launches; ledger %d closed cold in the apply engine in %.1f ms "
        "(%d verify launches; the Python phases' one per transaction, "
        "derived from the set as C5p measures it: %d); %s"
        % (card, restart_s, root_ms, want, R_TIP + 1, close_s * 1e3, e,
           txs, gcp.line()))
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

    attached = []
    attach = lm.root.attach_bucketdb

    def counted_attach(bdb):
        attached.append(lm.last_closed_ledger_num())
        attach(bdb)

    lm.root.attach_bucketdb = counted_attach
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
        del lm.root.attach_bucketdb
    wall = time.perf_counter() - t0
    check(attached == [first - 1] and lm.root.bucket_backed(),
          "R4: the bucket-apply's set_last_closed_ledger re-attached "
          "BucketDB at %d (%s)" % (first - 1, attached))
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
    launches = [d["launches"] for d in pr.checkpoint_drains()]
    txs = [len(lcd.tx_set.frames) for lcd in buffered]
    cold = pr.close_launches(R_TIP + 1, R_TOP)
    check(launches == [n for _n, n in want]
          and not any(pr.close_launches(first, R_TIP))
          and pr.engine_as_derived(first, R_TOP)
          and cold == [1] * len(buffered)
          and E.LAUNCHES == sum(launches) + sum(cold),
          "R4: verify launches: drains %s as derived %s, none in the "
          "replayed closes, in the buffered ones %s as the engine's "
          "candidates derive (the Python phases: one per transaction, %s)"
          % (launches, want, cold, txs))
    check(pr.cpu_calls == [] and pr.sha_as_derived(),
          "R4: none on the CPU; SHA-256 per close as derived")
    check(pr.close_decisions_ok(K), "R4: the engine's decisions in the "
          "buffered closes == the C verifier's")
    replay = [pr.closes[s] for s in range(first, R_TIP + 1)]
    replay_s = replay[-1][4] + replay[-1][3] - replay[0][4]
    log("R4 online catchup from a gap (%s): %d values buffered; buckets "
        "applied at %d in %.2f s; ledgers %d-%d replayed in %.1f s = %.2f "
        "ledgers/s (drains %s launches); the %d buffered closes cold in "
        "the apply engine, %s launches (the Python phases' one per "
        "transaction, derived from the sets as C5p measures it: %s), %s "
        "ms; %.1f s "
        "in all; %s"
        % (card, len(buffered), first - 1, apply_s[0], first, R_TIP,
           replay_s, (R_TIP - first + 1) / replay_s, launches,
           len(buffered), cold, txs,
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



# ------------------------------------------- main: the operator's node (M1)

def m1_http(port: int, path: str):
    """One admin request to the M1 node; a reply other than 200 raises
    (urllib's HTTPError), a body that does not parse raises. Returns the
    JSON body, or the text of the Prometheus exposition."""
    import urllib.request
    with urllib.request.urlopen("http://127.0.0.1:%d/%s" % (port, path),
                                timeout=120) as r:
        check(r.status == 200, "M1: %s answered %d" % (path, r.status))
        ctype = r.headers.get("Content-Type", "")
        body = r.read().decode()
    if ctype.startswith("text/plain"):
        return body
    return json.loads(body)


def m1_cli(steps: list, what: str, *args) -> str:
    """`python -m stellar_core_tpu_torch <args>` from the checkout's root
    in a process of its own (`g_cli`); a non-zero exit fails M1. Records
    the step's seconds (the process's start-up, torch's import and the
    built kernels' load included) and returns its standard output."""
    [(out, _err)] = g_cli(steps, [("M1 " + what,
                                   ["stellar_core_tpu_torch"] + list(args),
                                   None)])
    steps[-1] = (what, steps[-1][1])
    return "\n".join(out) + ("\n" if out else "")


class M1Node:
    """A background `python -m stellar_core_tpu_torch run` of M1's config,
    its output in files beside it. `stop` sends SIGINT and waits for exit
    0; a process still alive after that (or after an error) is killed and
    M1 fails."""

    def __init__(self, d: str, conf: str, port: int, tag: str) -> None:
        self.port = port
        self.out = open(os.path.join(d, "run-%s.out" % tag), "w")
        self.err = open(os.path.join(d, "run-%s.err" % tag), "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "stellar_core_tpu_torch", "run",
             "--conf", conf], cwd=REPO, env=M1_ENV, stdout=self.out,
            stderr=self.err)
        self.err_path = self.err.name

    def wait_port(self, timeout_s: float = 300.0) -> float:
        import socket
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            check(self.proc.poll() is None, "M1: `run` still running "
                  "while its admin port opens")
            try:
                with socket.create_connection(("127.0.0.1", self.port),
                                              0.5):
                    return time.perf_counter() - self.t0
            except OSError:
                time.sleep(0.05)
        check(False, "M1: the admin port %d opened" % self.port)

    def stop(self) -> float:
        import signal
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGINT)
        try:
            rc = self.proc.wait(120)
        except subprocess.TimeoutExpired:
            rc = None
        check(rc == 0, "M1: `run` exits 0 on SIGINT (%s)" % rc)
        return time.perf_counter() - t0

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
            self.out.close()
            self.err.close()
            with open(self.err_path) as fh:
                log("M1 run stderr: %s" % fh.read()[-4000:])
            raise RuntimeError("M1: a `run` process outlived its stop")
        self.out.close()
        self.err.close()


def m1_launches(body: dict, kind: str) -> tuple:
    """(drains served, kernel launches, warmup launches, backends that
    served drains) from the `verifier` or `hasher` endpoint's body."""
    if kind == "verify":
        served = body["counters"]["batches_dispatched"]
        warmed = len(body["warmup"].get("buckets", {}))
    else:
        served = sum(d["dispatches"] for d in body["buckets"].values())
        warmed = len(body["warmup"].get("shapes", {}))
    return (served, body["counters"]["kernel_launches"], warmed,
            sorted(k for k, d in body["drains"]["by_backend"].items()
                   if d.get("drains", 0)))


def m1_counts(port: int) -> tuple:
    """The `verifier` and `hasher` endpoints once both warmups are done
    (a warmup launch is counted by the kernel's wrapper before the cockpit
    records its bucket)."""
    deadline = time.perf_counter() + 300
    while True:
        v, h = m1_http(port, "verifier"), m1_http(port, "hasher")
        if v["warmup"].get("state") == h["warmup"].get("state") == "done":
            return v, h
        check(time.perf_counter() < deadline and "failed" not in (
            v["warmup"].get("state"), h["warmup"].get("state")),
              "M1: both warmups finish (%s, %s)"
              % (v["warmup"].get("state"), h["warmup"].get("state")))
        time.sleep(0.2)


def m1_check_card(what: str, v: dict, h: dict, want_v: int,
                  want_h: int) -> tuple:
    """Every drain served by the card's stack and none on a CPU backend,
    the drains' launches as derived, and each kernel's launches the drains'
    plus its warmup's. Returns (verify, SHA-256) kernel launches."""
    vs, vk, vw, vb = m1_launches(v, "verify")
    hs, hk, hw, hb = m1_launches(h, "hash")
    check(v["verifier"] == "resilient" and "breaker" in v
          and v["breaker"]["state"] == "closed"
          and v["configured_backend"] == "cuda-resilient"
          and h["configured_backend"] == "cuda-resilient",
          "%s: the node's stacks are the card's, named by default"
          " (%s / %s)" % (what, v["configured_backend"],
                          h["configured_backend"]))
    check(vb in ([], ["cuda"]) and hb and "cpu" not in hb
          and "cpu" not in vb,
          "%s: every drain served by the card (verify %s, hash %s)"
          % (what, vb, hb))
    check(vs == want_v and vk == vs + vw,
          "%s: verify launches by drains %d == %d derived from the data "
          "(kernel %d = drains + %d warmup)" % (what, vs, want_v, vk, vw))
    check(hs == want_h and hk == hs + hw,
          "%s: SHA-256 launches by drains %d == %d derived from the bucket "
          "list (kernel %d = drains + %d warmup)"
          % (what, hs, want_h, hk, hw))
    return vk, hk


def m1_round(port: int, twin, traffic, seq: int, seen: set, st: dict,
             S, SC, db_path: str) -> tuple:
    """One loaded close of M1: CLOSE_TXS payments of R1's mix from the
    senders at their next sequence numbers (from the twin's state), every
    CLOSE_CORRUPT_EVERY-th corrupted, through `tx?blob=`, then
    `manualclose`; the twin closes the value read back from the node's
    database. Returns the verify launches derived for it (admissions whose
    candidates miss `seen`, the node's cache, and the close's engine
    candidates that miss it), the SHA-256 launches derived from the bucket
    list, the admission seconds and the number of valid payments."""
    import sqlite3
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.ledger.ledgertxn import LedgerTxn
    from stellar_core_tpu_torch.transactions.transaction_frame import (
        TransactionFrame,
    )
    CH = harness("torch_close_harness")
    lm = twin.ledger_manager
    blobs = traffic.multisig(seq + M1_AMOUNT_BASE)
    launches = 0
    ok_blobs = []
    # the derivation on the twin first, so that the admissions' seconds
    # are the `tx` requests' alone
    bads = []
    for b in blobs:
        frame = TransactionFrame.make_from_wire(
            LEDGER_NETWORK_ID, X.TransactionEnvelope.from_xdr(b))
        ltx = LedgerTxn(lm.ltx_root())
        try:
            cands = frame.candidate_sig_triples(ltx)
        finally:
            ltx.rollback()
        misses = [t for t in cands if t not in seen]
        launches += -(-len(misses) // 8192)
        seen.update(cands)
        bads.append(frame.contents_hash() in traffic.corrupted)
    admit_s = 0.0
    for b, bad in zip(blobs, bads):
        t0 = time.perf_counter()
        got = m1_http(port, "tx?blob=" + b.hex())
        admit_s += time.perf_counter() - t0
        check(got["status"] == ("ERROR" if bad else "PENDING"),
              "M1: ledger %d's %s payment answers %s (%s)"
              % (seq, "corrupted" if bad else "valid",
                 "ERROR" if bad else "PENDING", got))
        if not bad:
            ok_blobs.append(b)
    got = m1_http(port, "manualclose")
    check(got == {"status": "ok", "ledger": seq},
          "M1: manualclose closes %d (%s)" % (seq, got))
    db = sqlite3.connect(db_path)
    try:
        lcd = lcd_from_db(db, seq)
        node_hash = r_hashes(db, seq, seq)[seq]
        header = X.LedgerHeader.from_xdr(db.execute(
            "SELECT data FROM ledgerheaders WHERE ledgerseq = ?",
            (seq,)).fetchone()[0])
    finally:
        db.close()
    check(sorted(f.envelope.to_xdr() for f in lcd.tx_set.frames)
          == sorted(ok_blobs),
          "M1: ledger %d's set holds exactly the %d valid payments "
          "submitted before it" % (seq, len(ok_blobs)))
    cands = CH.engine_candidates(lm.root, lcd.tx_set.sort_for_apply())
    misses = [t for t in cands if t not in seen]
    launches += -(-len(misses) // 8192)
    seen.update(cands)
    lm.value_externalized(lcd)
    owed = fresh_slots(S, SC, st, twin.bucket_manager.bucket_list)
    cp = m1_http(port, "checkpoint")
    check(lm.last_closed_ledger_num() == seq
          and lm.lcl_hash.hex() == node_hash
          and twin.bucket_manager.get_hash() == header.bucketListHash
          and cp["root"] == twin.state_commitment.root.hex(),
          "M1: the twin's ledger %d == the card node's (header hash, "
          "bucket-list hash, commitment root)" % seq)
    return launches, owed, admit_s, len(ok_blobs)


def m1_main(S, E, K, SC, tmp: str, r1: dict, r2: dict, card: str) -> dict:
    """M1 of the module docstring; returns the launches by kernel."""
    import socket
    import sqlite3
    from stellar_core_tpu_torch import _build
    from stellar_core_tpu_torch import testing as T
    from stellar_core_tpu_torch.crypto import strkey
    from stellar_core_tpu_torch.crypto.batch_hasher import (
        CudaBatchHasher, make_hasher,
    )
    from stellar_core_tpu_torch.crypto.batch_verifier import (
        CpuSigVerifier, CudaSigVerifier,
    )
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.history.archive import HistoryArchive
    pub, archive = r1["pub"], r1["archive"]
    d = os.path.join(tmp, "m1")
    os.makedirs(d)
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    arch = HistoryArchive.local_dir("r", archive)
    db_path = os.path.join(d, "node.db")
    conf = os.path.join(d, "node.toml")
    with open(conf, "w") as fh:
        fh.write("\n".join([
            "NETWORK_PASSPHRASE = %s" % json.dumps(R_PASSPHRASE),
            "NODE_SEED = %s" % json.dumps(strkey.encode_seed(
                SecretKey.from_seed(sha256(b"m1-node")).seed)),
            "DATABASE = %s" % json.dumps("sqlite3://" + db_path),
            "BUCKET_DIR_PATH = %s" % json.dumps(os.path.join(d, "buckets")),
            "RUN_STANDALONE = true", "MANUAL_CLOSE = true",
            "HTTP_PORT = %d" % port,
            "FLIGHT_RECORDER_DIR = %s" % json.dumps(d),
            "CHECKPOINT_FREQUENCY = %d" % R_FREQ,
            "TESTING_UPGRADE_MAX_TX_SET_SIZE = %d" % CLOSE_MAX_TX_SET_SIZE,
            "[HISTORY.r]", "get = %s" % json.dumps(arch.get_tmpl),
            "mkdir = %s" % json.dumps(arch.mkdir_tmpl), ""]))
    steps = []
    t_all = time.perf_counter()
    # 1. new-db: the publisher's genesis
    out = m1_cli(steps, "new-db", "new-db", "--conf", conf)
    genesis = r_hashes(pub.database, 1, 1)[1]
    check(out.strip() == "new ledger: genesis %s" % genesis,
          "M1: new-db prints the publisher's genesis hash (%s)"
          % out.strip())
    # 2. catchup over R1's archive, on the card
    out = m1_cli(steps, "catchup", "catchup", "%d/max" % R_TIP, "--conf",
                 conf).splitlines()
    check(out[0] == "catchup SUCCESS at ledger %d" % R_TIP,
          "M1: catchup prints its success at %d (%s)" % (R_TIP, out[0]))
    check(out[1].startswith("catchup launches "),
          "M1: catchup prints its launch counts")
    cu = json.loads(out[1][len("catchup launches "):])
    db = sqlite3.connect(db_path)
    try:
        same = r_hashes(db, 1, R_TIP) == r_hashes(pub.database, 1, R_TIP)
    finally:
        db.close()
    check(same, "M1: every header hash 1-%d in the node's database == the "
          "publisher's" % R_TIP)
    want_drains = r_drains(archive, 2, CudaSigVerifier.BUCKETS[-1])
    cv, ch = cu["verifier"], cu["hasher"]
    check(sorted(k for k, n in cv["drains"].items() if n["drains"])
          == ["cuda"] and "cpu" not in ch["drains"]
          and cv["counters"]["batches_dispatched"]
          == sum(n for _s, n in want_drains)
          and cv["counters"]["kernel_launches"]
          == cv["counters"]["batches_dispatched"] + cv["warmed"],
          "M1 catchup: verify drains on the card %s, launches %d == %d "
          "derived from the archive %s (kernel %d with %d warmup)"
          % (cv["drains"], cv["counters"]["batches_dispatched"],
             sum(n for _s, n in want_drains), want_drains,
             cv["counters"]["kernel_launches"], cv["warmed"]))
    hs = sum(ch["dispatches"].values())
    check(hs == r2["sha256"] and ch["counters"]["kernel_launches"]
          == hs + ch["warmed"],
          "M1 catchup: SHA-256 launches by drains %d == R2's %d, derived "
          "from the bucket list close by close (kernel %d with %d warmup)"
          % (hs, r2["sha256"], ch["counters"]["kernel_launches"],
             ch["warmed"]))
    launches = {"verify": cv["counters"]["kernel_launches"],
                "sha256": ch["counters"]["kernel_launches"]}
    # the twin: a port node on the C verifier over a copy of the node's
    # files after the catchup
    shutil.copy2(db_path, os.path.join(d, "twin.db"))
    shutil.copytree(os.path.join(d, "buckets"),
                    os.path.join(d, "twin-buckets"))
    twin = r_node(d, "twin", archive, CpuSigVerifier(), make_hasher("cpu"))
    check(twin.ledger_manager.last_closed_ledger_num() == R_TIP,
          "M1: the twin starts at %d" % R_TIP)
    traffic = CloseTraffic(twin.ledger_manager,
                           T.root_secret_key(LEDGER_NETWORK_ID),
                           senders=CLOSE_TXS,
                           corrupt_every=CLOSE_CORRUPT_EVERY)
    lane_ref = CudaBatchHasher(device="cpu")
    valid, admit_s = [], []
    # 3. force-scp, then run
    out = m1_cli(steps, "force-scp", "force-scp", "--conf", conf)
    check(out.strip() == "force-scp set", "M1: force-scp sets the flag")
    node = M1Node(d, conf, port, "1")
    try:
        steps.append(("run (to its admin port)", node.wait_port()))
        info = m1_http(port, "info")
        check(info["ledger"]["num"] == R_TIP and info["state"] == "Synced!"
              and info["ledger"]["synced"],
              "M1: info at LCL %d, synced (%s, %s)"
              % (R_TIP, info["ledger"]["num"], info["state"]))
        seen = set()
        st = {"hasher": lane_ref, "seen": set(),
              "slot_hashes": [SC.ZERO_HASH] * 22}
        want_v = want_h = 0
        t0 = time.perf_counter()
        for k in range(M1_ROUNDS):
            v_k, h_k, a_s, n_ok = m1_round(port, twin, traffic,
                                           R_TIP + 1 + k, seen, st, S, SC,
                                           db_path)
            want_v += v_k
            want_h += h_k
            admit_s.append(a_s)
            valid.append(n_ok)
        steps.append(("%d loaded closes" % M1_ROUNDS,
                      time.perf_counter() - t0))
        v, h = m1_counts(port)
        got = m1_check_card("M1 run", v, h, want_v, want_h)
        launches["verify"] += got[0]
        launches["sha256"] += got[1]
        prom = m1_http(port, "metrics?format=prometheus")
        check(isinstance(prom, str) and "# TYPE sct_" in prom
              and "# HELP " in prom,
              "M1: the Prometheus exposition parses")
        fp = m1_http(port, "footprint")
        check(fp["over_capacity"] == [] and fp["structs"],
              "M1: footprint has no structure over capacity")
        health = m1_http(port, "health")
        check(health["breakers"]["verifier"]["state"] == "closed"
              and health["breakers"]["hasher"]["state"] == "closed"
              and health["synced"], "M1: health shows both breakers "
              "closed and the node synced (%s)" % health["status"])
        log("M1 endpoints (%s): verifier drains %s, hasher drains %s; "
            "Prometheus %d series lines; footprint %d structures, RSS %s "
            "MB, %s threads; health %s %s"
            % (card, v["drains"]["by_backend"], h["drains"]["by_backend"],
               sum(1 for l in prom.splitlines() if l and l[0] != "#"),
               len(fp["structs"]), fp["process"]["rss_mb"],
               fp["process"]["threads"], health["status"],
               health["problems"]))
        # 4. restart: SIGINT saves the warmup plan
        plan = os.path.join(_build.BUILD_DIR, CudaSigVerifier.PLAN_BASENAME)
        t_stop = time.time()
        steps.append(("run stop (SIGINT)", node.stop()))
    finally:
        node.close()
    check(os.path.exists(plan) and os.path.getmtime(plan) >= t_stop - 1,
          "M1: the stop saved the warmup plan (%s)" % plan)
    node = M1Node(d, conf, port, "2")
    try:
        steps.append(("run again (to its admin port)", node.wait_port()))
        info = m1_http(port, "info")
        top = R_TIP + M1_ROUNDS
        check(info["ledger"]["num"] == top and info["state"] == "Synced!",
              "M1: after the restart info at LCL %d, synced (%s)"
              % (top, info["ledger"]["num"]))
        seen2 = set()
        st2 = {"hasher": lane_ref, "seen": set(),
               "slot_hashes": [SC.ZERO_HASH] * 22}
        t0 = time.perf_counter()
        v_k, h_k, a_s, n_ok = m1_round(port, twin, traffic, top + 1, seen2,
                                       st2, S, SC, db_path)
        admit_s.append(a_s)
        valid.append(n_ok)
        steps.append(("1 loaded close", time.perf_counter() - t0))
        v, h = m1_counts(port)
        got = m1_check_card("M1 restart", v, h, v_k, h_k)
        launches["verify"] += got[0]
        launches["sha256"] += got[1]
        steps.append(("run stop (SIGINT)", node.stop()))
    finally:
        node.close()
    out = m1_cli(steps, "offline-info", "offline-info", "--conf", conf)
    info = json.loads(out)
    check(info["ledger"]["num"] == top + 1,
          "M1: offline-info after the stop at %d (%s)"
          % (top + 1, info["ledger"]["num"]))
    r_stop(twin)
    total = time.perf_counter() - t_all
    log("M1 steps (%s), seconds with each process's start-up: %s; %.1f s "
        "in all" % (card, ", ".join("%s %.2f" % kv for kv in steps),
                    total))
    per_tx = [s_ * 1e3 / CLOSE_TXS for s_ in admit_s]
    log("M1 (%s): catchup 1-%d (%d ledgers) on the card, verify drains %s, "
        "SHA-256 %d; %d + 1 loaded closes of %d payments (%s valid), every "
        "header, bucket-list hash and commitment root == the C-verifier "
        "twin's; admissions through `tx` %.2f ms a payment (mean of "
        "rounds; each request's round trip alone, the twin's derivation "
        "outside it); launches by kernel %s"
        % (card, R_TIP, R_TIP - 1, want_drains, hs, M1_ROUNDS, CLOSE_TXS,
           valid, float(np.mean(per_tx)), launches))
    return launches

def catchup_path(S, E, K, SC, flight_dir: str, card: str) -> dict:
    """R1-R5 of the module docstring; returns the launches by kernel."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_catchup_") as tmp:
        r1 = r1_publish(S, E, K, tmp, card)
        x1_tx_history(r1, card)
        out = {"verify": 0, "sha256": 0}
        r2 = r2_complete(S, E, K, SC, tmp, r1, flight_dir, card)
        r2p = r2_complete(S, E, K, SC, tmp, r1, flight_dir, card,
                          native=False)
        first = r2p["drain_launches"]
        check(r2["drain_launches"][:len(first)] == first
              and sum(r2["drain_launches"]) == r2["verify"]
              and sum(first) == r2p["verify"],
              "R2p: the launches of R2's first checkpoint (%s, %d), all in "
              "the drains" % (first, r2p["verify"]))
        log("R2 against R2p (%s): %.2f against %.2f ledgers/s, "
            "catchup.apply_ledger mean %.1f against %.1f ms (apply engine "
            "to %d against Python phases to %d), %d and %d launches"
            % (card, r2["ledgers_per_s"], r2p["ledgers_per_s"],
               r2["apply_ms"], r2p["apply_ms"], R_TIP, R_FREQ - 1,
               r2["verify"], r2p["verify"]))
        for got in (r2, r2p):
            for k in out:
                out[k] += got[k]
        for phase in (r3_restart, r4_gap):
            got = phase(S, E, K, SC, tmp, r1, flight_dir, card)
            for k in out:
                out[k] += got[k]
        got = r5_faults(S, E, K, SC, tmp, r1, flight_dir)
        for k in out:
            out[k] += got[k]
        # the operator's node, while R1's archive and publisher are here
        E.LAUNCHES = S.LAUNCHES = 0
        out["main M1"] = m1_main(S, E, K, SC, tmp, r1, r2, card)
        check(E.LAUNCHES == S.LAUNCHES == 0, "M1: this process launched "
              "nothing; the node's processes did")
        r_stop(r1["pub"])
    return out


# ------------------------------------------------------ SCP and the herder

class HerderProbe:
    """What a network's verifiers and kernels did, where: verify and
    SHA-256 launches by call site (`Sites`: each herder's envelope intake,
    externalize-hint intake, trigger, each queue's admission, each ledger
    manager's close, the relay's per-crank flushes), each node's verify
    demand (triples asked of `enqueue` and `prewarm_many`, cache hits
    included), every triple the card was sent, every decision a verifier
    returned, every triple the C verifier decided (the herder checks a
    nominated value's signature on the host, `PubKeyUtils.verify_sig`, as
    the reference does), and per node and close the SHA-256 launches the
    close owed by its bucket list (`fresh_slots`)."""

    def __init__(self, H, S, E, K, SC, relay):
        self.S, self.E, self.K, self.SC, self.relay = S, E, K, SC, relay
        self.vsites = H.Sites(lambda: E.LAUNCHES)
        self.hsites = H.Sites(lambda: S.LAUNCHES)
        self.demand = Counter()
        self.card_triples, self.cpu_triples = [], []
        self.decisions = {}
        self.sha_owed = 0
        self.sha_off = []       # (seq, launched, owed) where they differ
        self.paths = Counter()  # the close paths the nodes took
        self._raw = (K.raw_verify, K.raw_verify_batch)

    def _decided(self, triple, ok) -> None:
        prev = self.decisions.setdefault(triple, ok)
        check(prev == ok, "one decision per triple")

    def install(self) -> None:
        K = self.K
        # what a crank runs outside the sites above: the verifier flushes
        # after each node's ready work
        for sites in (self.vsites, self.hsites):
            sites.wrap(self.relay, "step", "crank")
        for node in self.relay.nodes:
            app = node.app
            h = app.herder
            for sites in (self.vsites, self.hsites):
                sites.wrap(h, "recv_scp_envelope", "envelope")
                sites.wrap(h, "_note_externalize_hint", "externalize hint")
                sites.wrap(h, "trigger_next_ledger", "nominate")
                sites.wrap(h.tx_queue, "try_add", "admission")
                sites.wrap(app.ledger_manager, "value_externalized",
                           "close")
            self._wrap_verifier(node)
            # the engine commits nothing at genesis: the first close owes
            # every bucket of the list
            st = {"hasher": app.batch_hasher, "seen": set(),
                  "slot_hashes": [self.SC.ZERO_HASH] * 22}
            self._wrap_close(app, st)
        raw, raw_batch = self._raw
        K.raw_verify = lambda *t: self.cpu_triples.append(t) or raw(*t)
        K.raw_verify_batch = lambda ts: (self.cpu_triples.extend(ts)
                                         or raw_batch(ts))

    def uninstall(self) -> None:
        self.K.raw_verify, self.K.raw_verify_batch = self._raw

    def _wrap_verifier(self, node) -> None:
        v = node.app.sig_verifier
        name = node.name
        enqueue, prewarm = v.enqueue, v.prewarm_many

        def enqueue_(key, sig, msg):
            self.demand[name] += 1
            fut = enqueue(key, sig, msg)
            t = (key.key_bytes, sig, msg)
            fut.add_done_callback(lambda ok: self._decided(t, ok))
            return fut

        def prewarm_(triples):
            self.demand[name] += len(triples)
            got = prewarm(triples)
            for t, ok in zip(triples, got):
                self._decided(tuple(t), ok)
            return got

        v.enqueue, v.prewarm_many = enqueue_, prewarm_
        fleet = getattr(v, "inner", v)     # the device verifier
        vm = fleet.verify_many

        def verify_many(triples):
            self.card_triples.extend(tuple(t) for t in triples)
            return vm(triples)

        fleet.verify_many = verify_many

    def _wrap_close(self, app, st) -> None:
        lm = app.ledger_manager
        orig = lm.close_ledger

        def close_ledger(lcd):
            s0 = self.S.LAUNCHES
            orig(lcd)
            self.paths[lm.last_apply_path] += 1
            owed = fresh_slots(self.S, self.SC, st,
                               app.bucket_manager.bucket_list)
            self.sha_owed += owed
            if self.S.LAUNCHES - s0 != owed:
                self.sha_off.append((lcd.ledger_seq,
                                     self.S.LAUNCHES - s0, owed))

        lm.close_ledger = close_ledger

    def check_decisions(self, what: str) -> int:
        """Every decision a verifier returned equals the C verifier's;
        nothing the card was sent was decided on the C verifier before;
        returns the number of distinct triples."""
        check(not set(self.card_triples) & set(self.cpu_triples),
              "%s: nothing sent to the card is verified on the CPU" % what)
        triples = sorted(self.decisions)
        ref = self._raw[1](triples)
        bad = sum(1 for t, r in zip(triples, ref)
                  if self.decisions[t] != r)
        check(bad == 0, "%s: every card decision (%d distinct triples) == "
              "the C verifier's (%d differ)" % (what, len(triples), bad))
        return len(triples)


def twin_close(lm, node, seq: int) -> None:
    """The value `node` externalized for `seq`, closed by the CPU twin:
    the txset crosses as XDR bytes."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.herder.txset import TxSetFrame
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerCloseData
    sv = X.StellarValue.from_xdr(node.externalized[seq])
    ts = node.app.herder.pending.get_tx_set(sv.txSetHash)
    twin_ts = TxSetFrame.from_wire(
        lm.app.config.network_id,
        X.TransactionSet.from_xdr(ts.to_wire().to_xdr()))
    lm.value_externalized(LedgerCloseData(seq, twin_ts, sv))
    check(lm.last_closed_ledger_num() == seq, "the twin closed %d" % seq)


def submit_round(relay, blobs: list, corrupted: set, what: str) -> float:
    """Each transaction to node k mod n, flooded to every other node:
    every node answers ADD_STATUS_PENDING, or ADD_STATUS_ERROR for a
    corrupted one (`corrupted`: full hashes, the SHA-256 of the envelope
    bytes). Returns the seconds the round took."""
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.herder.tx_queue import TxQueueResult
    t0 = time.perf_counter()
    for k, blob in enumerate(blobs):
        got = relay.submit(k % len(relay.nodes), blob)
        bad = sha256(blob) in corrupted
        want = TxQueueResult.ADD_STATUS_ERROR if bad \
            else TxQueueResult.ADD_STATUS_PENDING
        check(set(got) == {want}, "%s: every node answers %s to transaction "
              "%d (got %s)" % (what, "ERROR" if bad else "PENDING", k,
                               sorted(set(got))))
    return time.perf_counter() - t0


def network_hashes(relay, twin) -> tuple:
    got = {relay.hashes(n) for n in relay.nodes}
    check(len(got) == 1, "every node's lcl hash, bucket-list hash and "
          "commitment root are equal")
    h = got.pop()
    if twin is not None:
        tw = (twin.ledger_manager.lcl_hash, twin.bucket_manager.get_hash(),
              twin.state_commitment.root)
        check(h == tw, "the network's hashes == the CPU twin's")
    return h


def s1_network(H, S, E, K, SC, BV, BH, tmp: str, card: str) -> dict:
    """S1 of the module docstring; returns the launches by kernel."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
    from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
    n = S1_ORGS * S1_PER_ORG
    keys = [H.node_seed(i).public_key for i in range(n)]
    qset = H.tier1_qset(X, keys, S1_ORGS, S1_PER_ORG)
    t0 = time.perf_counter()
    relay = None
    for i in range(n):
        cfg = H.node_config(i, qset, i == 0, CLOSE_MAX_TX_SET_SIZE)
        app = H.make_port_node(os.path.join(tmp, "s1-%d" % i), cfg,
                               BV.make_verifier("cuda"),
                               BH.make_hasher("cuda"))
        if relay is None:
            relay = H.Relay(cfg.network_id)
        relay.join("v%d" % i, app)
    twin_cfg = H.node_config(n, qset, False, CLOSE_MAX_TX_SET_SIZE)
    twin_cfg.BUCKETDB_READS = False
    twin = H.make_port_app(os.path.join(tmp, "s1-twin"), config=twin_cfg,
                           verifier=CpuSigVerifier(),
                           hasher=make_hasher("cpu"))
    # the nodes close in the apply engine reading through BucketDB, the
    # twin in the Python phases reading SQL
    twin.ledger_manager.use_native_apply = False
    check(all(nd.app.ledger_manager.root.bucket_backed()
              for nd in relay.nodes)
          and not twin.ledger_manager.root.bucket_backed(),
          "S1: every node's root reads through BucketDB, the twin's SQL")
    network_hashes(relay, twin)      # genesis
    log("S1: %d validators (%d organisations of %d, each node's quorum "
        "%d of %d inner sets of %d of %d) and a CPU twin built in %.1f s "
        "on %s" % (n, S1_ORGS, S1_PER_ORG, qset.threshold, S1_ORGS,
                   S1_PER_ORG // 2 + 1, S1_PER_ORG,
                   time.perf_counter() - t0, card))
    tr = H.Traffic(relay.nodes[0].app.ledger_manager, relay.network_id,
                   relay.nodes[0].app.network_root_key(), CLOSE_TXS,
                   CLOSE_SIGS, corrupt_every=CLOSE_CORRUPT_EVERY)
    K.flush_verify_cache()
    probe = HerderProbe(H, S, E, K, SC, relay)
    probe.install()
    E.LAUNCHES = S.LAUNCHES = 0
    n_txs, admit_s = 0, []

    def one_slot(seq: int, blobs: list) -> dict:
        nonlocal n_txs
        admit_s.append(submit_round(relay, blobs, tr.corrupted,
                                    "S1 slot %d" % seq))
        n_txs += len(blobs)
        r = relay.close_slot(seq)
        twin_close(twin.ledger_manager, relay.nodes[0], seq)
        network_hashes(relay, twin)
        return r

    try:
        with GcPauses() as gc_pauses:
            one_slot(2, tr.fund())
            one_slot(3, tr.arm())
            loaded = []

            def run_loaded():
                for k in range(S1_LOADED):
                    seq = 4 + k
                    loaded.append(one_slot(seq, tr.payments(seq)))
                return loaded

            prof = profile_drain(run_loaded, "ed25519_verify_kernel",
                                 cpu=False)
    finally:
        probe.uninstall()
    top = 3 + S1_LOADED
    check(all(n.app.ledger_manager.last_closed_ledger_num() == top
              for n in relay.nodes), "S1: every node closed %d" % top)
    check(probe.paths == Counter({"native": n * (top - 1)}),
          "S1: every node's every close ran in the apply engine (%s)"
          % dict(probe.paths))
    n_env = len(relay.envelopes)
    env_distinct = len({raw for _i, _s, raw in relay.envelopes})
    check(env_distinct == n_env, "S1: every flooded envelope distinct")
    v, h = probe.vsites.by_site, probe.hsites.by_site
    want_v = {"envelope": n_env, "admission": n_txs}
    got_v = {k: c for k, c in v.items() if c}
    check(got_v == want_v and E.LAUNCHES == n_env + n_txs,
          "S1: verify launches by site %s == derived %s (one per distinct "
          "envelope, one per transaction's first admission, none in the "
          "nominations' and closes' trim_invalid, the hints or the "
          "cranks' flushes; %d in all)" % (dict(got_v), want_v, E.LAUNCHES))
    got_h = {k: c for k, c in h.items() if c}
    check(got_h == ({"close": probe.sha_owed} if probe.sha_owed else {})
          and S.LAUNCHES == probe.sha_owed,
          "S1: SHA-256 launches by site %s == %d derived from each node's "
          "bucket list, all in its closes (closes that differ: %s)"
          % (dict(got_h), probe.sha_owed, probe.sha_off[:8]))
    n_dec = probe.check_decisions("S1")
    host = set(probe.cpu_triples)
    check(host <= H.value_sig_triples(relay),
          "S1: the C verifier decided only nominated values' signatures")
    ext = [r["externalize_s"] for r in loaded]
    cls = [r["close_s"] for r in loaded]
    per_slot = Counter(s for _i, s, _r in relay.envelopes)
    per_node = Counter(i for i, _s, _r in relay.envelopes)
    log("S1 (%s): %d slots (2 funds %d senders, 3 arms them, %d loaded of "
        "%d %d-signature payments, every %dth corrupted and refused by "
        "every node), every node == the CPU twin at every height; "
        "trigger -> all %d externalized p50 %.3f s, max %.3f s; -> all "
        "closed p50 %.3f s, max %.3f s; admission rounds p50 %.3f s "
        "(%d transactions x %d nodes)"
        % (card, top - 1, CLOSE_TXS, S1_LOADED, CLOSE_TXS, CLOSE_SIGS,
           CLOSE_CORRUPT_EVERY, n, float(np.percentile(ext, 50)), max(ext),
           float(np.percentile(cls, 50)), max(cls),
           float(np.percentile(admit_s[2:], 50)), CLOSE_TXS, n))
    log("S1: envelopes flooded %d (per slot %s; per node %s), each "
        "delivered to %d nodes; timer advances %d"
        % (n_env, dict(sorted(per_slot.items())),
           sorted(per_node.values()), n - 1, relay.advances))
    log("S1: verify launches by site %s (derived: %s), SHA-256 by site %s "
        "(derived %d); %d distinct triples decided, == the C verifier; %d "
        "value signatures checked on the host (the reference's "
        "PubKeyUtils.verify_sig), none of them sent to the card"
        % (dict(got_v), want_v, dict(got_h), probe.sha_owed, n_dec,
           len(host)))
    log("S1: verify demand per node (enqueue + prewarm_many triples, "
        "cache hits included; what %d separate machines would each "
        "verify): %s" % (n, sorted(probe.demand.values())))
    log_profile("S1 loaded slots", prof, "ed25519_verify_kernel")
    log("S1: %s" % gc_pauses.line())
    for node in relay.nodes:
        H.stop(node.app)
    H.stop(twin)
    return {"verify": E.LAUNCHES, "sha256": S.LAUNCHES}



class RealStamps:
    """The node's clock for its async verify stack, stamping on the
    host's clock: completions still post to the node's virtual clock,
    but `crypto.verify.latency` and the queue waits read real seconds
    (the virtual clock stands still while a verify runs)."""

    def __init__(self, clock) -> None:
        self.post_to_main = clock.post_to_main

    @staticmethod
    def now() -> float:
        return time.perf_counter()


def s2_async(H, S, E, K, SC, BV, BH, tmp: str, card: str) -> dict:
    """S2 of the module docstring; returns the launches by kernel."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    keys = [H.node_seed(i).public_key for i in range(S2_NODES)]
    qset = H.flat_qset(X, keys, S2_NODES - 1)
    reg = MetricsRegistry(now_fn=time.perf_counter)
    relay = None
    for i in range(S2_NODES):
        cfg = H.node_config(i, qset, i == 0, CLOSE_MAX_TX_SET_SIZE)
        app = H.make_port_node(
            os.path.join(tmp, "s2-%d" % i), cfg,
            lambda app: BV.make_verifier("cuda-async",
                                         clock=RealStamps(app.clock),
                                         metrics=reg),
            BH.make_hasher("cuda"))
        if relay is None:
            relay = H.Relay(cfg.network_id)
        relay.join("a%d" % i, app)
    check(all(nd.app.ledger_manager.root.bucket_backed()
              for nd in relay.nodes),
          "S2: every node's root reads through BucketDB")
    tr = H.Traffic(relay.nodes[0].app.ledger_manager, relay.network_id,
                   relay.nodes[0].app.network_root_key(), CLOSE_TXS,
                   CLOSE_SIGS, corrupt_every=CLOSE_CORRUPT_EVERY)
    K.flush_verify_cache()
    probe = HerderProbe(H, S, E, K, SC, relay)
    probe.install()
    E.LAUNCHES = S.LAUNCHES = 0
    n_txs, forged = 0, None
    top = 3 + S2_LOADED
    try:
        for seq in range(2, top + 1):
            blobs = tr.fund() if seq == 2 else tr.arm() if seq == 3 \
                else tr.payments(seq)
            submit_round(relay, blobs, tr.corrupted, "S2 slot %d" % seq)
            n_txs += len(blobs)
            relay.close_slot(seq)
            network_hashes(relay, None)
            if seq == 5:
                # node 0's last envelope with one signature byte flipped,
                # relayed to nodes 1 and 2
                raw = [r for i, _s, r in relay.envelopes if i == 0][-1]
                forged = raw[:-5] + bytes([raw[-5] ^ 0x01]) + raw[-4:]
                for to in relay.nodes[1:3]:
                    relay.deliver_envelope(to, relay.nodes[0], forged)
                relay.settle()
    finally:
        probe.uninstall()
    check(all(n.app.ledger_manager.last_closed_ledger_num() == top
              for n in relay.nodes), "S2: every node closed %d" % top)
    check(probe.paths == Counter({"native": len(relay.nodes) * (top - 1)}),
          "S2: every node's every close ran in the apply engine (%s)"
          % dict(probe.paths))
    env = X.SCPEnvelope.from_xdr(forged)
    st = env.statement
    triple = (st.nodeID.key_bytes, env.signature,
              relay.nodes[1].app.herder.scp_driver._envelope_sign_bytes(st))
    fh = sha256(forged)
    check(probe.decisions.get(triple) is False
          and triple in probe.card_triples
          and all(fh in n.app.herder.pending.discarded.get(st.slotIndex, ())
                  for n in relay.nodes[1:3]),
          "S2: the forged envelope was refused on the card's False "
          "decision by both nodes it reached, and consensus went on")
    n_env = len(relay.envelopes)
    # S1's rule (one launch per distinct envelope, the forged one, one per
    # transaction) assumes the first node's verify lands in the process's
    # cache before the next node asks; here it is still in flight then,
    # so each node that receives an envelope may verify it itself, as a
    # validator on its own machine does. The bound from the data: each
    # of the n - 1 receivers at most once per envelope, the two nodes
    # handed the forged one, each transaction once (admission drains
    # synchronously, so later nodes hit the cache)
    s1_rule = n_env + 1 + n_txs
    bound = (S2_NODES - 1) * n_env + 2 + n_txs
    envs = set()
    for _i, _s, raw in relay.envelopes:
        e = X.SCPEnvelope.from_xdr(raw)
        envs.add((e.statement.nodeID.key_bytes, e.signature,
                  relay.nodes[0].app.herder.scp_driver
                  ._envelope_sign_bytes(e.statement)))
    check(envs <= set(probe.card_triples),
          "S2: every flooded envelope was verified on the card")
    check(0 < E.LAUNCHES <= bound,
          "S2: %d verify launches <= %d derived from the data (%d receivers "
          "x %d envelopes, the forged one twice, %d transactions)"
          % (E.LAUNCHES, bound, S2_NODES - 1, n_env, n_txs))
    check(S.LAUNCHES == probe.sha_owed, "S2: SHA-256 launches == %d "
          "derived from the bucket lists" % probe.sha_owed)
    n_dec = probe.check_decisions("S2")
    m = reg.to_json()
    check("crypto.verify.requeued" not in m, "S2: no dispatch requeued")
    lat = m["crypto.verify.latency"]
    log("S2 (%s): %d validators on make_verifier('cuda-async'), quorum %d "
        "of %d, %d slots (%d loaded); every node == every other at every "
        "height; verify launches %d <= %d derived (%d receivers x %d "
        "envelopes + the forged one twice + transactions %d; S1's rule "
        "would give %d); SHA-256 %d as derived; %d distinct "
        "triples == the C verifier; the forged envelope dropped by both "
        "nodes on the card's False; crypto.verify.latency p50 %.3f ms, "
        "p99 %.3f ms (%d verifies, host clock); timer advances %d"
        % (card, S2_NODES, S2_NODES - 1, S2_NODES, top - 1, S2_LOADED,
           E.LAUNCHES, bound, S2_NODES - 1, n_env, n_txs, s1_rule,
           S.LAUNCHES, n_dec,
           lat["median"] * 1e3, lat["p99"] * 1e3, lat["count"],
           relay.advances))
    for node in relay.nodes:
        H.stop(node.app)
    return {"verify": E.LAUNCHES, "sha256": S.LAUNCHES}


def herder_path(S, E, K, SC, card: str) -> dict:
    """S1 and S2 of the module docstring; returns the launches by kernel
    and phase."""
    from stellar_core_tpu_torch.crypto import batch_hasher as BH
    from stellar_core_tpu_torch.crypto import batch_verifier as BV
    H = harness("torch_herder_harness")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_herder_") as tmp:
        t0 = time.perf_counter()
        s1 = s1_network(H, S, E, K, SC, BV, BH, tmp, card)
        log("S1: %.1f s in all" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        s2 = s2_async(H, S, E, K, SC, BV, BH, tmp, card)
        log("S2: %.1f s in all" % (time.perf_counter() - t0))
    return {"verify": {"herder S1": s1["verify"], "herder S2": s2["verify"]},
            "sha256": {"herder S1": s1["sha256"], "herder S2": s2["sha256"]}}


# ------------------------------------------------------------------ overlay

def overlay_totals(nodes) -> dict:
    """Frames and bytes every node received, by message type, summed over
    `nodes` (their overlay cockpits, `overlay_stats.to_json`)."""
    out: Counter = Counter()
    for n in nodes:
        for name, t in n.app.overlay_manager.stats.to_json()[
                "by_type"].items():
            out[(name, "msgs")] += t["recv_msgs"]
            out[(name, "bytes")] += t["recv_bytes"]
    return out


def by_type_line(before: Counter, after: Counter) -> str:
    names = sorted({k[0] for k in after})
    parts = []
    for name in names:
        m = after[(name, "msgs")] - before[(name, "msgs")]
        if m:
            parts.append("%s %d (%d B)" % (name, m, after[(name, "bytes")]
                                           - before[(name, "bytes")]))
    return ", ".join(parts)


def flood_line(nodes) -> str:
    """The flood duplication ratio (duplicate receipts over first ones)
    and mean fanout of a broadcast, over every node's floodgate."""
    u = d = b = f = 0
    for n in nodes:
        fl = n.app.overlay_manager.stats.to_json()["flood"]
        u, d = u + fl["unique"], d + fl["duplicates"]
        b, f = b + fl["broadcasts"], f + fl["fanout_total"]
    return ("flood: %d first receipts, %d duplicates (duplication ratio "
            "%.3f), %d broadcasts, mean fanout %.2f"
            % (u, d, d / u if u else 0.0, b, f / b if b else 0.0))


def hop_delays(nodes, types=("scp-message",)) -> dict:
    """From every node's propagation cockpit (host perf-counter stamps of
    each hop): per node and message, first receipt -> first relay (the
    node's verify and processing on the way), and per message, its origin
    -> its first receipt at each other node; seconds."""
    relay, reach = [], []
    origin = {}
    recvs = []
    for n in nodes:
        prop = n.app.overlay_manager.prop_stats
        for hx, rec in prop.fleet_json()["hashes"].items():
            if rec["type"] not in types:
                continue
            hops = rec["hops"]
            o = [h["pc"] for h in hops if h["dir"] == "origin"]
            if o:
                origin[hx] = o[0]
            r = [h["pc"] for h in hops if h["dir"] == "recv"]
            s = [h["pc"] for h in hops if h["dir"] == "send"]
            if r:
                recvs.append((hx, r[0]))
                if s and s[0] >= r[0]:
                    relay.append(s[0] - r[0])
    for hx, t in recvs:
        if hx in origin:
            reach.append(t - origin[hx])
    return {"relay": relay, "reach": reach}


def pct_line(what: str, xs: list, scale: float = 1e3,
             unit: str = "ms") -> str:
    if not xs:
        return "%s: none" % what
    return "%s p50 %.3f %s, p99 %.3f %s, max %.3f %s (%d)" % (
        what, float(np.percentile(xs, 50)) * scale, unit,
        float(np.percentile(xs, 99)) * scale, unit, max(xs) * scale, unit,
        len(xs))


class IntakeClock:
    """Host perf-counter seconds of every `recv_scp_envelope` of a
    network's herders, split by whether the call launched the verify
    kernel (a cache miss verified on the card) or not: the overlay
    cockpit's `overlay.envelope.verify-latency` reads the node's virtual
    clock, which stands still while a synchronous verify runs."""

    def __init__(self, E, nodes) -> None:
        self.launched, self.cached = [], []
        for n in nodes:
            h = n.app.herder
            orig = h.recv_scp_envelope

            def recv(env, on_verified=None, _orig=orig):
                c0, t0 = E.LAUNCHES, time.perf_counter()
                try:
                    return _orig(env, on_verified=on_verified)
                finally:
                    dt = time.perf_counter() - t0
                    (self.launched if E.LAUNCHES > c0
                     else self.cached).append(dt)

            h.recv_scp_envelope = recv


class SeenBy:
    """Per node, the hashes of every transaction its herder was handed,
    every envelope its herder took in and every message its floodgate
    recorded."""

    def __init__(self, nodes) -> None:
        from stellar_core_tpu_torch.crypto.hashing import sha256
        self.txs = [set() for _ in nodes]
        self.envs = [set() for _ in nodes]
        self.flooded = [set() for _ in nodes]
        for i, n in enumerate(nodes):
            h, fg = n.app.herder, n.app.overlay_manager.floodgate
            rt, re_, ar = h.recv_transaction, h.recv_scp_envelope, \
                fg.add_record

            def recv_tx(frame, _o=rt, _s=self.txs[i]):
                _s.add(frame.full_hash())
                return _o(frame)

            def recv_env(env, on_verified=None, _o=re_, _s=self.envs[i]):
                _s.add(sha256(env.to_xdr()))
                return _o(env, on_verified=on_verified)

            def add_record(msg, *a, _o=ar, _s=self.flooded[i], **kw):
                _s.add(sha256(msg.to_xdr()))
                return _o(msg, *a, **kw)

            h.recv_transaction, h.recv_scp_envelope = recv_tx, recv_env
            fg.add_record = add_record


def o1_overlay(H, S, E, K, SC, BV, BH, tmp: str, card: str) -> dict:
    """O1 of the module docstring; returns the launches by kernel."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
    from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
    from stellar_core_tpu_torch.crypto.hashing import sha256
    n = S1_ORGS * S1_PER_ORG
    keys = [H.node_seed(i).public_key for i in range(n)]
    qset = H.tier1_qset(X, keys, S1_ORGS, S1_PER_ORG)
    t0 = time.perf_counter()
    net = None
    for i in range(n):
        cfg = H.node_config(i, qset, i == 0, CLOSE_MAX_TX_SET_SIZE)
        app = H.make_port_node(os.path.join(tmp, "o1-%d" % i), cfg,
                               BV.make_verifier("cuda"),
                               BH.make_hasher("cuda"))
        if net is None:
            net = H.OverlayNet(cfg.network_id)
        net.join("o%d" % i, app)
    degree = net.nodes[0].app.config.TARGET_PEER_CONNECTIONS
    check(degree == O1_DEGREE, "O1: each node targets %d peers, the "
          "reference's default" % O1_DEGREE)
    twin_cfg = H.node_config(n, qset, False, CLOSE_MAX_TX_SET_SIZE)
    twin_cfg.BUCKETDB_READS = False
    twin = H.make_port_app(os.path.join(tmp, "o1-twin"), config=twin_cfg,
                           verifier=CpuSigVerifier(),
                           hasher=make_hasher("cpu"))
    twin.ledger_manager.use_native_apply = False
    check(all(nd.app.ledger_manager.root.bucket_backed()
              for nd in net.nodes), "O1: every node reads through BucketDB")
    network_hashes(net, twin)
    built_s = time.perf_counter() - t0
    # node i dials i+1 .. i+degree/2 (mod n): each node has `degree` peers
    t0 = time.perf_counter()
    for i in range(n):
        for d in range(1, degree // 2 + 1):
            net.link(i, (i + d) % n)
    check(net.crank_until(net.authenticated, 50)
          and len(net.links) == n * degree // 2
          and all(nd.app.overlay_manager.get_authenticated_peers_count()
                  == degree for nd in net.nodes),
          "O1: all %d links authenticated on both ends, %d peers a node"
          % (n * degree // 2, degree))
    hs_s = time.perf_counter() - t0
    log("O1: %d validators and a CPU twin built in %.1f s on %s; %d "
        "loopback links (node i dials i+1..i+%d mod %d), each a full "
        "Hello/Auth handshake (X25519, HKDF, one AuthCert verify on the "
        "host per end), authenticated in %.3f s of host time"
        % (n, built_s, card, len(net.links), degree // 2, n, hs_s))
    tr = H.Traffic(net.nodes[0].app.ledger_manager, net.network_id,
                   net.nodes[0].app.network_root_key(), CLOSE_TXS,
                   CLOSE_SIGS, corrupt_every=CLOSE_CORRUPT_EVERY)
    K.flush_verify_cache()
    seen = SeenBy(net.nodes)
    clock_probe = IntakeClock(E, net.nodes)
    probe = HerderProbe(H, S, E, K, SC, net)
    probe.install()
    E.LAUNCHES = S.LAUNCHES = 0
    n_txs, loaded, lines, bad_msgs = 0, [], [], set()
    from stellar_core_tpu_torch.herder.tx_queue import TxQueueResult

    def one_slot(seq: int, blobs: list, label: str) -> dict:
        nonlocal n_txs
        before = overlay_totals(net.nodes)
        t0 = time.perf_counter()
        for blob in blobs:
            got = net.submit(0, blob)
            bad = sha256(blob) in tr.corrupted
            want = TxQueueResult.ADD_STATUS_ERROR if bad \
                else TxQueueResult.ADD_STATUS_PENDING
            check(got == want, "O1 slot %d: node 0 answers %s" % (
                seq, "ERROR" if bad else "PENDING"))
            if bad:
                bad_msgs.add(sha256(X.StellarMessage(
                    X.MessageType.TRANSACTION,
                    X.TransactionEnvelope.from_xdr(blob)).to_xdr()))
        n_txs += len(blobs)
        # the accepted transactions flood to every node before the slot
        net.settle()
        flood_s = time.perf_counter() - t0
        r = net.close_slot(seq)
        twin_close(twin.ledger_manager, net.nodes[0], seq)
        network_hashes(net, twin)
        after = overlay_totals(net.nodes)
        r["flood_s"] = flood_s
        lines.append("O1 slot %d (%s): frames received %d (%d B): %s"
                     % (seq, label, sum(v for k, v in after.items()
                                        if k[1] == "msgs")
                        - sum(v for k, v in before.items()
                              if k[1] == "msgs"),
                        sum(v for k, v in after.items() if k[1] == "bytes")
                        - sum(v for k, v in before.items()
                              if k[1] == "bytes"),
                        by_type_line(before, after)))
        return r

    forged = None
    try:
        with GcPauses() as gc_pauses:
            one_slot(2, tr.fund(), "funds")
            one_slot(3, tr.arm(), "arms")

            def run_loaded():
                for k in range(O1_LOADED):
                    seq = 4 + k
                    loaded.append(one_slot(seq, tr.payments(seq),
                                           "loaded"))
                return loaded

            prof = profile_drain(run_loaded, "ed25519_verify_kernel",
                                 cpu=False)
            # node 0's last envelope, one signature byte flipped, sent to
            # node 1 over their authenticated link
            raw = [r for i, _s, r in net.envelopes if i == 0][-1]
            forged = raw[:-5] + bytes([raw[-5] ^ 0x01]) + raw[-4:]
            net.peer(0, 1).send_message(X.StellarMessage(
                X.MessageType.SCP_MESSAGE, X.SCPEnvelope.from_xdr(forged)))
            net.settle()
    finally:
        probe.uninstall()
    top = 3 + O1_LOADED
    check(all(nd.app.ledger_manager.last_closed_ledger_num() == top
              for nd in net.nodes), "O1: every node closed %d" % top)
    check(probe.paths == Counter({"native": n * (top - 1)}),
          "O1: every node's every close ran in the apply engine (%s)"
          % dict(probe.paths))
    check(net.authenticated(), "O1: every link still authenticated")
    # the transactions: the corrupted ones stop at node 0
    corrupted = set(tr.corrupted)
    check(corrupted and corrupted <= seen.txs[0]
          and not any(corrupted & s for s in seen.txs[1:]),
          "O1: the %d corrupted transactions reached node 0's queue only"
          % len(corrupted))
    check(len(bad_msgs) == len(corrupted)
          and not any(bad_msgs & s for s in seen.flooded),
          "O1: no floodgate recorded a corrupted transaction")
    # every accepted transaction reached every node's queue
    good = seen.txs[0] - corrupted
    check(all(good <= s for s in seen.txs[1:]),
          "O1: every accepted transaction reached every node's queue")
    # the forged envelope: refused on the card at node 1, never relayed
    env = X.SCPEnvelope.from_xdr(forged)
    st = env.statement
    triple = (st.nodeID.key_bytes, env.signature,
              net.nodes[1].app.herder.scp_driver._envelope_sign_bytes(st))
    fh = sha256(forged)
    rejected = [nd.app.overlay_manager.stats.to_json()["envelope"][
        "rejected"] for nd in net.nodes]
    check(probe.decisions.get(triple) is False
          and triple in probe.card_triples
          and fh in seen.envs[1]
          and not any(fh in s for k, s in enumerate(seen.envs) if k != 1)
          and rejected[1] == 1 and sum(rejected) == 1,
          "O1: the forged envelope was refused on the card's False at "
          "node 1 (overlay.envelope.rejected 1 there, 0 elsewhere) and "
          "reached no other node")
    n_env = len(net.envelopes)
    env_distinct = len({raw for _i, _s, raw in net.envelopes})
    check(env_distinct == n_env, "O1: every originated envelope distinct")
    v, h = probe.vsites.by_site, probe.hsites.by_site
    want_v = {"envelope": n_env + 1, "admission": n_txs}
    got_v = {k: c for k, c in v.items() if c}
    check(got_v == want_v and E.LAUNCHES == n_env + 1 + n_txs,
          "O1: verify launches by site %s == derived %s (one per distinct "
          "envelope, the forged one, one per transaction's first admission "
          "at node 0; %d in all)" % (dict(got_v), want_v, E.LAUNCHES))
    got_h = {k: c for k, c in h.items() if c}
    check(got_h == ({"close": probe.sha_owed} if probe.sha_owed else {})
          and S.LAUNCHES == probe.sha_owed,
          "O1: SHA-256 launches by site %s == %d derived from each node's "
          "bucket list (closes that differ: %s)"
          % (dict(got_h), probe.sha_owed, probe.sha_off[:8]))
    n_dec = probe.check_decisions("O1")
    host = set(probe.cpu_triples)
    check(host <= H.value_sig_triples(net),
          "O1: the C verifier decided only nominated values' signatures")
    # txsets: built from the flooded transactions or fetched (TX_SET)
    fetched = sum(nd.app.overlay_manager.stats.to_json()["by_type"].get(
        "tx-set", {}).get("recv_msgs", 0) for nd in net.nodes)
    for seq in range(2, top + 1):
        sv = X.StellarValue.from_xdr(net.nodes[0].externalized[seq])
        check(all(nd.app.herder.pending.get_tx_set(sv.txSetHash) is not None
                  or nd.app.ledger_manager.last_closed_ledger_num() >= seq
                  for nd in net.nodes),
              "O1: slot %d's txset reached every node" % seq)
    ext = [r["externalize_s"] for r in loaded]
    cls = [r["close_s"] for r in loaded]
    fl = [r["flood_s"] for r in loaded]
    log("O1 (%s): %d slots (2 funds %d senders, 3 arms them, %d loaded of "
        "%d %d-signature payments submitted at node 0, every %dth "
        "corrupted and refused there), every node == the CPU twin at every "
        "height; per loaded slot: submission + flood to every node p50 "
        "%.3f s, max %.3f s; trigger -> all %d externalized p50 %.3f s, "
        "max %.3f s; -> all closed p50 %.3f s, max %.3f s"
        % (card, top - 1, CLOSE_TXS, O1_LOADED, CLOSE_TXS, CLOSE_SIGS,
           CLOSE_CORRUPT_EVERY, float(np.percentile(fl, 50)), max(fl), n,
           float(np.percentile(ext, 50)), max(ext),
           float(np.percentile(cls, 50)), max(cls)))
    for line in lines:
        log(line)
    log("O1: %s; TX_SET frames received %d (a node whose queue holds the "
        "flooded transactions builds the same txset itself)"
        % (flood_line(net.nodes), fetched))
    d = hop_delays(net.nodes)
    log("O1: host clock, %s; %s" % (
        pct_line("an envelope's receipt -> relay at one node (its verify "
                 "and processing)", d["relay"]),
        pct_line("origin -> first receipt at each other node",
                 d["reach"])))
    dt = hop_delays(net.nodes, ("transaction",))
    log("O1: host clock, %s" % pct_line(
        "a transaction's receipt -> relay at one node (its admission)",
        dt["relay"]))
    m = net.nodes[1].app.overlay_manager.stats.to_json()["envelope"]
    log("O1: overlay.envelope.verify-latency (the node's virtual clock, "
        "which stands still during a synchronous verify): node 1 %d "
        "envelopes, %.6f s in all; host clock, recv_scp_envelope: %s; %s"
        % (m["count"], m["verify_seconds"],
           pct_line("with a launch", clock_probe.launched),
           pct_line("from the cache", clock_probe.cached)))
    log("O1: verify launches by site %s (derived %s), SHA-256 by site %s "
        "(derived %d); %d distinct triples decided, == the C verifier; %d "
        "value signatures checked on the host"
        % (dict(got_v), want_v, dict(got_h), probe.sha_owed, n_dec,
           len(host)))
    log("O1: verify demand per node (enqueue + prewarm_many triples, cache "
        "hits included): %s" % sorted(probe.demand.values()))
    log_profile("O1 loaded slots", prof, "ed25519_verify_kernel")
    log("O1: %s" % gc_pauses.line())
    net.stop()
    for node in net.nodes:
        H.stop(node.app)
    H.stop(twin)
    return {"verify": E.LAUNCHES, "sha256": S.LAUNCHES}


class TcpNet:
    """O2's nodes (the port's `Application`s on REAL_TIME clocks,
    their overlay on localhost TCP), cranked in turn by one thread as
    `tests/test_overlay_tcp.py` cranks its nodes, in the shape
    `HerderProbe` reads: `nodes` (the relay's `Node`s, which stamp each
    externalized value) and `step`, one `Application.crank` of every
    node. A crank longer than a quarter second is kept: on the async
    stack a node's multi-second validation holds every other node's next
    envelope back; before the herder kept each txset's verdict, the
    nomination timers then outran the validations and a round stalled
    for up to 135 s (ROADMAP Queue 3 item 11)."""

    def __init__(self, H, apps) -> None:
        from stellar_core_tpu_torch import xdr as X
        from stellar_core_tpu_torch.herder.txset import TxSetFrame
        from stellar_core_tpu_torch.transactions.transaction_frame import (
            TransactionFrame,
        )
        self.nodes = [H.Node(self, "t%d" % i, a, X, TxSetFrame,
                             TransactionFrame) for i, a in enumerate(apps)]
        self.envelopes = []
        self.queue_max = 0
        # the longest single cranks: (s, node index, perf-counter end)
        self.long_cranks = []

    def step(self) -> int:
        n = 0
        for k, node in enumerate(self.nodes):
            t0 = time.perf_counter()
            n += node.app.crank(False)
            t1 = time.perf_counter()
            if t1 - t0 > 0.25:
                self.long_cranks.append((t1 - t0, k, t1))
            total, _b = node.app.overlay_manager.send_queue_depth()
            self.queue_max = max(self.queue_max, total)
        return n

    def crank_until(self, pred, timeout_s: float) -> bool:
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            if pred():
                return True
            if not self.step():
                time.sleep(0.001)
        return pred()


def o2_tcp(H, S, E, K, SC, BV, BH, tmp: str, card: str) -> dict:
    """O2 of the module docstring; returns the launches by kernel."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
    from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.main.application import Application
    from stellar_core_tpu_torch.transactions.transaction_frame import (
        TransactionFrame,
    )
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    keys = [H.node_seed(i).public_key for i in range(O2_NODES)]
    qset = H.flat_qset(X, keys, O2_NODES - 1)
    apps = []
    for i in range(O2_NODES):
        cfg = H.node_config(i, qset, True, CLOSE_MAX_TX_SET_SIZE)
        cfg.MANUAL_CLOSE = False
        cfg.RUN_STANDALONE = False
        cfg.PEER_PORT = 0
        # the node's own stacks: the async verifier on its clock, the bare
        # hasher; no warmup, so every launch is the network's traffic
        cfg.SIG_VERIFY_BACKEND, cfg.HASH_BACKEND = "cuda-async", "cuda"
        cfg.SIG_VERIFY_WARMUP = False
        cfg.FLIGHT_RECORDER_DIR = tmp
        app = Application(VirtualClock(ClockMode.REAL_TIME), cfg)
        app.enable_buckets(os.path.join(tmp, "o2-%d" % i))
        apps.append(app)
    net = TcpNet(H, apps)
    # each close's hashes and applied transactions, per node and height
    closed = [dict() for _ in apps]
    applied = [set() for _ in apps]
    for k, app in enumerate(apps):
        lm = app.ledger_manager
        orig = lm.value_externalized

        def value_externalized(lcd, _o=orig, _lm=lm, _app=app, _k=k):
            _o(lcd)
            applied[_k].update(f.full_hash() for f in lcd.tx_set.frames)
            closed[_k][lcd.ledger_seq] = (
                _lm.lcl_hash, _app.bucket_manager.get_hash(),
                _app.state_commitment.root)

        lm.value_externalized = value_externalized
        om = app.overlay_manager
        me = app.config.node_id()
        bcast = om.broadcast_message

        def broadcast_message(msg, force=False, _o=bcast, _me=me, _k=k):
            if msg.disc == X.MessageType.SCP_MESSAGE:
                e = msg.value
                if e.statement.nodeID == _me:
                    raw = e.to_xdr()
                    if all(raw != r for _i, _s, r in net.envelopes[-64:]):
                        net.envelopes.append(
                            (_k, e.statement.slotIndex, raw))
                else:
                    # a relay: the envelope's verify must have landed
                    t = (e.statement.nodeID.key_bytes, e.signature,
                         apps[0].herder.scp_driver._envelope_sign_bytes(
                             e.statement))
                    relays.append(probe.decisions.get(t))
            return _o(msg, force)

        om.broadcast_message = broadcast_message
    relays = []
    twin_cfg = H.node_config(O2_NODES, qset, False, CLOSE_MAX_TX_SET_SIZE)
    twin_cfg.BUCKETDB_READS = False
    twin = H.make_port_app(os.path.join(tmp, "o2-twin"), config=twin_cfg,
                           verifier=CpuSigVerifier(),
                           hasher=make_hasher("cpu"))
    twin.ledger_manager.use_native_apply = False
    tr = H.Traffic(apps[0].ledger_manager, apps[0].config.network_id,
                   apps[0].network_root_key(), CLOSE_TXS, CLOSE_SIGS,
                   corrupt_every=CLOSE_CORRUPT_EVERY)
    K.flush_verify_cache()
    probe = HerderProbe(H, S, E, K, SC, net)
    probe.install()
    E.LAUNCHES = S.LAUNCHES = 0
    n_txs = 0
    t0 = time.perf_counter()
    frames0 = overlay_totals(net.nodes)
    try:
        for app in apps:
            app.start()
        ports = [a.config.PEER_PORT for a in apps]
        for i, app in enumerate(apps):
            app.config.KNOWN_PEERS = ["127.0.0.1:%d" % p
                                      for j, p in enumerate(ports) if j != i]
            for j, p in enumerate(ports):
                if j != i:
                    app.overlay_manager.peer_manager.ensure_exists(
                        "127.0.0.1", p)
        check(net.crank_until(lambda: all(
            a.overlay_manager.get_authenticated_peers_count()
            == O2_NODES - 1 for a in apps), 60),
            "O2: every node authenticated its %d peers over TCP"
            % (O2_NODES - 1))
        auth_s = time.perf_counter() - t0
        slots = []
        for label in ["funds", "arms"] + ["loaded"] * O2_LOADED:
            blobs = tr.fund() if label == "funds" else tr.arm() \
                if label == "arms" else tr.payments(len(slots) + 10)
            good = set()
            for blob in blobs:
                f = TransactionFrame.make_from_wire(
                    apps[0].config.network_id,
                    X.TransactionEnvelope.from_xdr(blob))
                st = apps[0].submit_transaction(f)
                bad = sha256(blob) in tr.corrupted
                check((st != 0) == bad, "O2: node 0 refuses exactly the "
                      "corrupted transactions")
                if not bad:
                    good.add(f.full_hash())
            n_txs += len(blobs)
            b0 = sum(a.overlay_manager.stats.to_json()["totals"][
                "send_bytes"] for a in apps)
            s0 = time.perf_counter()
            check(net.crank_until(
                lambda: all(good <= a for a in applied), O2_ROUND_S),
                "O2: the %s slot's transactions applied on every node"
                % label)
            slots.append({"label": label, "s": time.perf_counter() - s0,
                          "seq": max(a.ledger_manager
                                     .last_closed_ledger_num()
                                     for a in apps),
                          "bytes": sum(a.overlay_manager.stats.to_json()[
                              "totals"]["send_bytes"] for a in apps) - b0})
    finally:
        probe.uninstall()
    top = min(a.ledger_manager.last_closed_ledger_num() for a in apps)
    # the twin closes node 0's every value; every node == the twin
    node0 = net.nodes[0]
    for seq in range(2, top + 1):
        twin_close(twin.ledger_manager, node0, seq)
        tw = (twin.ledger_manager.lcl_hash, twin.bucket_manager.get_hash(),
              twin.state_commitment.root)
        check(all(closed[k].get(seq) == tw for k in range(O2_NODES)),
              "O2: height %d equal on all %d nodes and the CPU twin"
              % (seq, O2_NODES))
    n_env = len(net.envelopes)
    envs = set()
    for _i, _s, raw in net.envelopes:
        e = X.SCPEnvelope.from_xdr(raw)
        envs.add((e.statement.nodeID.key_bytes, e.signature,
                  apps[0].herder.scp_driver._envelope_sign_bytes(
                      e.statement)))
    # an envelope that reaches a node already past its slot, or is still
    # on the wire when the run ends, is dropped unverified
    verified = envs & set(probe.decisions)
    check(verified and verified <= set(probe.card_triples),
          "O2: every envelope a node verified (%d of the %d flooded) was "
          "verified on the card" % (len(verified), len(envs)))
    check(relays and all(ok is True for ok in relays),
          "O2: every relayed envelope (%d) was relayed after its verify "
          "landed True" % len(relays))
    bound = (O2_NODES - 1) * n_env + n_txs
    check(0 < E.LAUNCHES <= bound,
          "O2: %d verify launches <= %d derived (%d receivers x %d "
          "envelopes + %d transactions)"
          % (E.LAUNCHES, bound, O2_NODES - 1, n_env, n_txs))
    check(S.LAUNCHES == probe.sha_owed, "O2: SHA-256 launches == %d "
          "derived from the bucket lists" % probe.sha_owed)
    n_dec = probe.check_decisions("O2")
    mj = [a.metrics.to_json() for a in apps]
    check(not any("crypto.verify.requeued" in m for m in mj),
          "O2: no dispatch requeued")
    check(probe.paths == Counter({"native": O2_NODES * (top - 1)})
          or set(probe.paths) == {"native"},
          "O2: every close ran in the apply engine (%s)" % dict(probe.paths))
    name = "overlay.envelope.verify-latency.%s" % apps[0].sig_verifier.name
    lat = [m[name] for m in mj if name in m]
    d = hop_delays(net.nodes)
    log("O2 (%s): %d validators on make_verifier('cuda-async') over "
        "localhost TCP (REAL_TIME clocks, each door on a port the kernel "
        "picked), quorum %d of %d: authenticated in %.3f s; %d ledgers "
        "closed, each == on all nodes and the CPU twin; slots: %s"
        % (card, O2_NODES, O2_NODES - 1, O2_NODES, auth_s, top - 1,
           ", ".join("%s %.3f s to applied everywhere (ledger %d, %d B "
                     "sent over the sockets)" % (s["label"], s["s"],
                                                 s["seq"], s["bytes"])
                     for s in slots)))
    log("O2: %s (real clock), per node: %s; send-queue depth max %d B"
        % (name, "; ".join("p50 %.3f ms p99 %.3f ms (%d)"
                           % (x["median"] * 1e3, x["p99"] * 1e3, x["count"])
                           for x in lat), net.queue_max))
    t_start = min(min(n.t_closed.values()) for n in net.nodes)
    log("O2: each node's closes, s after its first: %s" % "; ".join(
        "%s %s" % (n.name, " ".join("%d@%.2f" % (q, t - t_start)
                                    for q, t in sorted(n.t_closed.items())))
        for n in net.nodes))
    log("O2: cranks over 0.25 s (s, node, s after the first close): %s; "
        "verifier meters %s" % (
            ", ".join("%.2f/t%d/%.2f" % (d_, k, t - t_start)
                      for d_, k, t in sorted(net.long_cranks)[-8:]),
            {k: v.get("count") for m in mj for k, v in m.items()
             if k.startswith(("crypto.verify", "verifier.queue"))
             and ("requeued" in k or "failed" in k or "queue" in k)}))
    log("O2: frames received over the run: %s"
        % by_type_line(frames0, overlay_totals(net.nodes)))
    log("O2: host clock, %s; %s" % (
        pct_line("an envelope's receipt -> relay at one node",
                 d["relay"]),
        pct_line("origin -> first receipt at each other node", d["reach"])))
    log("O2: verify launches %d <= %d derived; SHA-256 %d as derived; %d "
        "distinct triples == the C verifier; %d of %d flooded envelopes "
        "verified, all on the card; %d relays, each after its verify "
        "landed True; %s"
        % (E.LAUNCHES, bound, S.LAUNCHES, n_dec, len(verified), len(envs),
           len(relays), flood_line(net.nodes)))
    for a in apps:
        a.stop()
    for node in net.nodes:
        node.app.database.close()
    H.stop(twin)
    return {"verify": E.LAUNCHES, "sha256": S.LAUNCHES}


def overlay_path(S, E, K, SC, card: str) -> dict:
    """O1 and O2 of the module docstring; returns the launches by kernel
    and phase."""
    from stellar_core_tpu_torch.crypto import batch_hasher as BH
    from stellar_core_tpu_torch.crypto import batch_verifier as BV
    H = harness("torch_herder_harness")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_overlay_") as tmp:
        t0 = time.perf_counter()
        o1 = o1_overlay(H, S, E, K, SC, BV, BH, tmp, card)
        log("O1: %.1f s in all" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        o2 = o2_tcp(H, S, E, K, SC, BV, BH, tmp, card)
        log("O2: %.1f s in all" % (time.perf_counter() - t0))
    return {"verify": {"overlay O1": o1["verify"],
                       "overlay O2": o2["verify"]},
            "sha256": {"overlay O1": o1["sha256"],
                       "overlay O2": o2["sha256"]}}


class RecordedApps:
    """While entered, every port `Application` a `Simulation` builds is
    kept (`apps`, in order of construction; a restart is a new one), each
    close it makes is recorded under (its index, sequence) with the
    header hash (`closes`), and `restarted_at` is the highest LCL of the
    fleet when a node is first restarted (None without a restart)."""

    def __init__(self) -> None:
        self.apps = []
        self.closes = {}
        self.restarted_at = None

    def __enter__(self):
        from stellar_core_tpu_torch.main.application import Application
        from stellar_core_tpu_torch.simulation import simulation
        rec = self
        restart = simulation.Simulation.restart_node

        def restart_node(sim, name):
            if rec.restarted_at is None:
                rec.restarted_at = max(
                    n.app.ledger_manager.last_closed_ledger_num()
                    for n in sim.nodes.values())
            return restart(sim, name)

        self._restart = restart
        simulation.Simulation.restart_node = restart_node

        class Recorded(Application):
            def __init__(self, clock, config):
                super().__init__(clock, config)
                idx = len(rec.apps)
                rec.apps.append(self)
                lm = self.ledger_manager
                close = lm.value_externalized

                def value_externalized(lcd):
                    out = close(lcd)
                    rec.closes[(idx, lm.last_closed_ledger_num())] = \
                        lm.lcl_hash.hex()
                    return out

                lm.value_externalized = value_externalized

        self._mod, self._orig = simulation, simulation.Application
        simulation.Application = Recorded
        return self

    def __exit__(self, *exc) -> None:
        self._mod.Application = self._orig
        self._mod.Simulation.restart_node = self._restart


class TwinStacks:
    """While entered, an `Application` whose config names "cpu" gets the
    C verifier behind the card stack's own queue (`enqueue` probes the
    process's cache and queues, `flush` and `prewarm_many` drain through
    `verify_many`) and hashlib behind the card hasher's routing, and each
    counts what the card's stacks would launch for the same calls: one
    verify launch per 8,192-signature chunk of a drain, one SHA-256
    launch per 4,096-message chunk of a `hash_many`'s messages of at most
    16 blocks (`counts`). The twin's drains are the card's launches."""

    def __init__(self) -> None:
        self.counts = {"verify": 0, "sha256": 0}

    def __enter__(self):
        from stellar_core_tpu_torch.crypto import batch_hasher as BH
        from stellar_core_tpu_torch.crypto import batch_verifier as BV
        from stellar_core_tpu_torch.main import application as A
        counts = self.counts
        chunk = BV.CudaSigVerifier.BUCKETS[-1]
        lanes = BH.CudaBatchHasher.LANE_BUCKETS[-1]
        blocks = BH.CudaBatchHasher.BLOCK_BUCKETS[-1]

        class Twin(BV.CpuSigVerifier):
            # not "cpu": catchup then drains each checkpoint as on the
            # card, where the C verifier's name skips that drain
            name = "twin"
            wants_prewarm = True

            def warmup(self, wait: bool = False) -> None:
                pass      # the C verifier has no kernel to warm

            def enqueue(self, key, sig, msg):
                return self._batch_enqueue(key, sig, msg)

            def flush(self) -> None:
                self._batch_flush()

            def pending(self) -> int:
                return len(self._pending)

            def verify_many(self, triples):
                counts["verify"] += -(-len(triples) // chunk)
                return super().verify_many(triples)

        class TwinHasher(BH.CpuBatchHasher):
            def hash_many(self, msgs, site="other"):
                n = sum(1 for m in msgs if (len(m) + 72) // 64 <= blocks)
                counts["sha256"] += -(-n // lanes)
                return super().hash_many(msgs, site=site)

        make_v, make_h = A.make_verifier, BH.make_hasher

        def make_verifier(backend, *a, **kw):
            v = make_v(backend, *a, **kw)
            if backend != "cpu":
                return v
            t = Twin()
            t.__dict__.update(v.__dict__)
            t._pending = []
            t._max_pending = a[0] if a else kw.get("max_pending", 8192)
            return t

        def make_hasher(backend, *a, **kw):
            h = make_h(backend, *a, **kw)
            if backend != "cpu":
                return h
            t = TwinHasher()
            t.__dict__.update(h.__dict__)
            return t

        self._saved = ((A, "make_verifier", make_v),
                       (BH, "make_hasher", make_h))
        A.make_verifier, BH.make_hasher = make_verifier, make_hasher
        return self

    def __exit__(self, *exc) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def app_launches(app) -> dict:
    """A node's drains and warmup launches, from its `verifier` and
    `hasher` endpoints (the cockpits M1 reads over HTTP)."""
    vs, _vk, vw, vb = m1_launches(app.command_handler.cmd_verifier({}),
                                  "verify")
    h = app.command_handler.cmd_hasher({})
    hs, _hk, hw, _hb = m1_launches(h, "hash")
    return {"verify": vs, "verify_warmup": vw, "verify_backends": vb,
            "sha256": hs, "sha256_warmup": hw,
            "hash_backends": sorted(k for k, d in h["drains"]
                                    ["by_backend"].items()
                                    if d.get("drains", 0))}


def virtual_slot_p50_ms(apps) -> float:
    """p50 over every node and slot of externalize - nominate.trigger on
    the node's app clock (virtual in a simulation), in ms."""
    lat = []
    for app in apps:
        tl = app.slot_timeline
        for slot in list(tl._slots):
            a, b = tl.first(slot, "nominate.trigger"), \
                tl.first(slot, "externalize")
            if a is not None and b is not None:
                lat.append((b["t"] - a["t"]) * 1e3)
    return float(np.percentile(lat, 50)) if lat else float("nan")


def g1_scenario(SCN, SH, E, S, torch, name: str, card: str) -> dict:
    """One scenario of G1 on the card and on its twin; returns the card's
    launches by kernel and what the log line prints."""
    from stellar_core_tpu_torch.crypto import keys as K
    E.LAUNCHES = S.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    K.flush_verify_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_g1_") as wd:
        t0 = time.perf_counter()
        with RecordedApps() as rec:
            block = SCN.run_scenario(name, seed=1, scale="tier1",
                                     workdir=wd)
        card_s = time.perf_counter() - t0
    for app in rec.apps:
        app.wait_for_warmups()
    launches = {"verify": E.LAUNCHES, "sha256": S.LAUNCHES}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    per = [app_launches(app) for app in rec.apps]
    drains = {"verify": sum(p["verify"] for p in per),
              "sha256": sum(p["sha256"] for p in per)}
    warm = {"verify": sum(p["verify_warmup"] for p in per),
            "sha256": sum(p["sha256_warmup"] for p in per)}
    check(all(p["verify_backends"] in ([], ["cuda"])
              and set(p["hash_backends"]) <= {"cuda", "host-stream"}
              for p in per),
          "G1 %s: every drain of its %d nodes served by the card (%s)"
          % (name, len(per), sorted({b for p in per for b in
                                     p["verify_backends"]
                                     + p["hash_backends"]})))
    for k in ("verify", "sha256"):
        check(launches[k] == drains[k] + warm[k],
              "G1 %s: %s launches %d == the nodes' drains %d + %d warmup "
              "launches (%d node starts)" % (name, k, launches[k],
                                             drains[k], warm[k],
                                             len(per)))
    check(warm["verify"] >= len(per) and warm["sha256"] >= len(per),
          "G1 %s: every node start warmed both kernels" % name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_g1t_") as wd:
        K.flush_verify_cache()
        t0 = time.perf_counter()
        with TwinStacks() as twin, RecordedApps() as trec:
            tblock = SCN.run_scenario(name, seed=1, scale="tier1",
                                      workdir=wd, backend="cpu")
        twin_s = time.perf_counter() - t0
    check(E.LAUNCHES == launches["verify"]
          and S.LAUNCHES == launches["sha256"],
          "G1 %s: the twin launched nothing" % name)
    check(SH.comparable(block) == SH.comparable(tblock),
          "G1 %s: the card's block == the twin's, less the host-clock "
          "fields" % name)
    common = set(rec.closes) & set(trec.closes)
    # after churn's restart the victim rejoins through its archive's `cp`
    # subprocesses, and the close times that follow depend on the host's
    # clock: each run's nodes agree among themselves (the scenario
    # asserts it), card and twin only up to the restart
    top = rec.restarted_at if name == "churn" else None
    held = sorted(k for k in common if top is None or k[1] <= top)
    differ = sorted(k for k in common if rec.closes[k] != trec.closes[k])
    check(len(held) >= 2 and not [k for k in differ if k in held],
          "G1 %s: every header hash at the %d (node, height) pairs both "
          "runs closed%s == the twin's (differing: %s)"
          % (name, len(held), "" if top is None else
             " up to the restart at %d" % top, differ[:12]))
    if name != "churn":
        check(drains == twin.counts,
              "G1 %s: the card's drains %s == the twin's, derived from "
              "the same calls %s" % (name, drains, twin.counts))
    a = block["assertions"]
    extra = ""
    if name == "overload":
        extra = ", priority goodput %s, applied p95 ratio %s" % (
            a["priority_goodput"], a["p95_ratio_vs_unloaded"])
    log("G1 %s (%s): card %.2f s, twin %.2f s; %d node starts; launches "
        "verify %d (%d drains + %d warmup; twin drains %d) sha256 %d (%d "
        "+ %d; twin %d); peak card memory %.1f MiB; slot latency p50 "
        "%.3f virtual ms (the block's host-clock p50 %.3f ms); %d "
        "common (node, height) headers, %d held equal, %d differ after "
        "the restart%s"
        % (name, card, card_s, twin_s, len(per), launches["verify"],
           drains["verify"], warm["verify"], twin.counts["verify"],
           launches["sha256"], drains["sha256"], warm["sha256"],
           twin.counts["sha256"], peak_mb,
           virtual_slot_p50_ms(rec.apps),
           block["fleet"]["slot_latency_p50_ms"], len(common), len(held),
           len(differ), extra))
    return launches


def g_start(jobs: list) -> list:
    """Each job `(what, args, env[, cwd])`, `python -m <args>` from `cwd`
    (the checkout's root by default), in a process of its own, all
    started now; its output and error go to temporary files. Returns the
    handles for `g_wait`."""
    procs = []
    for what, args, env, *cwd in jobs:
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs.append((what, time.perf_counter(), out, err, subprocess.Popen(
            [sys.executable, "-m"] + list(args), cwd=cwd[0] if cwd else REPO,
            env=env or M1_ENV, stdout=out, stderr=err)))
    return procs


def g_stop(procs: list) -> None:
    """Kill what `g_start` started and is still running; close its
    files."""
    for _w, _t, out, err, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()
        err.close()


def g_wait(steps: list, procs: list) -> list:
    """Wait for `g_start`'s processes; a non-zero exit fails the phase.
    Records each step's seconds (its process's start-up included) and
    returns each one's standard output's and error's lines, in order."""
    got = []
    try:
        done = {}
        deadline = time.perf_counter() + 900
        while len(done) < len(procs):
            check(time.perf_counter() < deadline,
                  "%s end within 900 s" % [w for w, *_ in procs])
            for k, (_w, t0, _o, _e, p) in enumerate(procs):
                if k not in done and p.poll() is not None:
                    done[k] = time.perf_counter() - t0
            time.sleep(0.02)
        for k, (what, _t0, out, err, p) in enumerate(procs):
            steps.append((what, done[k]))
            out.seek(0)
            err.seek(0)
            o, e = out.read(), err.read()
            if p.returncode != 0:
                log("%s stderr: %s" % (what, e[-4000:]))
            check(p.returncode == 0, "%s exits 0 (%d)"
                  % (what, p.returncode))
            got.append((o.splitlines(), e.splitlines()))
    finally:
        g_stop(procs)
    return got


def g_cli(steps: list, jobs: list) -> list:
    """`g_start` then `g_wait`: the jobs side by side, their results."""
    return g_wait(steps, g_start(jobs))


def card_counts(what: str, nodes: list) -> tuple:
    """Each node's `launch_counters` (a command's second line): every
    drain served by the card, and the process's kernel launches == the
    drains plus the warmups. Returns the (verify, SHA-256) launches."""
    v = [n["verifier"] for n in nodes]
    h = [n["hasher"] for n in nodes if "hasher" in n]
    check(all(sorted(k for k, d in (x["drains"] or {}).items()
                     if d["drains"]) in ([], ["cuda"]) for x in v)
          and all("cpu" not in (x["drains"] or {}) for x in h),
          "%s: every drain served by the card" % what)
    vk = v[0]["counters"]["kernel_launches"]
    check(vk == sum(x["counters"]["batches_dispatched"] + x["warmed"]
                    for x in v),
          "%s: verify launches %d == the nodes' drains + warmups" % (
              what, vk))
    hk = h[0]["counters"]["kernel_launches"] if h else 0
    check(hk == sum(sum(x["dispatches"].values()) + x["warmed"]
                    for x in h),
          "%s: SHA-256 launches %d == the nodes' drains + warmups" % (
              what, hk))
    return vk, hk


def g_conf(d: str, name: str, backend=None, port=None, extra=()) -> str:
    """A TOML config of R1's network in `d`: a node seed, the genesis of
    the close phases (R_FREQ, CLOSE_MAX_TX_SET_SIZE), SQL and buckets of
    its own, and the two backend lines only where `backend` is named."""
    from stellar_core_tpu_torch.crypto import strkey
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    lines = [
        "NETWORK_PASSPHRASE = %s" % json.dumps(R_PASSPHRASE),
        "NODE_SEED = %s" % json.dumps(strkey.encode_seed(
            SecretKey.from_seed(sha256(b"g2-node")).seed)),
        "DATABASE = %s" % json.dumps("sqlite3://" + os.path.join(
            d, name + ".db")),
        "BUCKET_DIR_PATH = %s" % json.dumps(os.path.join(
            d, name + "-buckets")),
        "CHECKPOINT_FREQUENCY = %d" % R_FREQ,
        "TESTING_UPGRADE_MAX_TX_SET_SIZE = %d" % CLOSE_MAX_TX_SET_SIZE]
    if backend is not None:
        lines += ["SIG_VERIFY_BACKEND = %s" % json.dumps(backend),
                  "HASH_BACKEND = %s" % json.dumps(backend)]
    if port is not None:
        lines.append("HTTP_PORT = %d" % port)
    path = os.path.join(d, name + ".toml")
    with open(path, "w") as fh:
        fh.write("\n".join(lines + list(extra)) + "\n")
    return path


def g2_simulate_jobs(d: str) -> list:
    """G2's `simulate` on the card and its CPU twin, as `g_start` jobs."""
    args = ["stellar_core_tpu_torch", "simulate", "--ledgers",
            str(G2_LEDGERS), "--txs", str(G2_TXS), "--conf"]
    return [("G2 simulate", args + [g_conf(d, "sim")], None),
            ("G2 simulate (CPU twin)", args + [g_conf(d, "sim-twin", "cpu")],
             None)]


def g2_simulate(out: list, tout: list, card: str) -> tuple:
    """G2's `simulate` checks on the two processes' output; returns the
    card process's (verify, SHA-256) launches."""
    rate, got = json.loads(out[0]), json.loads(out[1])
    twin = json.loads(tout[1])
    top = 1 + G2_TXS + G2_LEDGERS
    check(got["ledger"] == twin["ledger"] == top
          and got["hash"] == twin["hash"],
          "G2 simulate: ledger %d, its hash == the CPU twin's (%s, %s)"
          % (top, got["hash"][:16], twin["hash"][:16]))
    v = got["launches"]["verifier"]
    admissions = G2_TXS + G2_LEDGERS * G2_TXS
    cuda = (v["drains"] or {}).get("cuda", {})
    check(v["counters"]["batches_dispatched"] == admissions
          == cuda.get("drains") == cuda.get("sigs")
          and cuda.get("pad_total") == 127 * admissions,
          "G2 simulate: verify drains %s == %d admissions, one at 128 "
          "lanes for each payment, none in a close"
          % (cuda, admissions))
    launches = card_counts("G2 simulate", [got["launches"]])
    log("G2 simulate (%s): %d ledgers of %d payments after %d funding "
        "closes, %s ledgers/s (%s tx/s); launches verify %d, sha256 %d; "
        "the CPU twin %s ledgers/s (the two and gen-fuzz side by side)"
        % (card, G2_LEDGERS, G2_TXS, G2_TXS, rate["ledgers_per_sec"],
           rate["txs_per_sec"], launches[0], launches[1],
           json.loads(tout[0])["ledgers_per_sec"]))
    return launches


def g2_generateload(steps: list, d: str, S, SC, card: str) -> tuple:
    """G2's `run` node driven with `generateload` and `manualclose` over
    its admin API, then closed again by a C-verifier twin from its SQL;
    returns the node's (verify, SHA-256) launches."""
    import socket
    import sqlite3
    from stellar_core_tpu_torch.crypto.batch_hasher import (
        CudaBatchHasher, make_hasher,
    )
    from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    conf = g_conf(d, "run", port=port, extra=(
        "RUN_STANDALONE = true", "MANUAL_CLOSE = true", "FORCE_SCP = true",
        "ARTIFICIALLY_GENERATE_LOAD_FOR_TESTING = true"))
    node = M1Node(d, conf, port, "g2")
    try:
        steps.append(("G2 run (to its admin port)", node.wait_port()))
        t0 = time.perf_counter()
        got = m1_http(port, "generateload?accounts=%d&txs=0" % G2_ACCOUNTS)
        check(got.get("accounts") == G2_ACCOUNTS and got["failed"] == 0,
              "G2: generateload creates %d accounts (%s)" % (G2_ACCOUNTS,
                                                             got))
        closes = [m1_http(port, "manualclose")]
        got = m1_http(port, "generateload?accounts=0&txs=%d" % G2_PAYMENTS)
        check(got["submitted"] == 1 + G2_PAYMENTS and got["failed"] == 0,
              "G2: generateload submits %d payments, none refused (%s)"
              % (G2_PAYMENTS, got))
        closes += [m1_http(port, "manualclose")
                   for _ in range(G2_CLOSES - 1)]
        steps.append(("G2 generateload and %d closes" % G2_CLOSES,
                      time.perf_counter() - t0))
        check([c.get("ledger") for c in closes]
              == list(range(2, 2 + G2_CLOSES)),
              "G2: manualclose closes %d-%d (%s)"
              % (2, 1 + G2_CLOSES, closes))
        v, h = m1_counts(port)
        vs, vk, vw, vb = m1_launches(v, "verify")
        hs, hk, hw, hb = m1_launches(h, "hash")
        steps.append(("G2 run stop (SIGINT)", node.stop()))
    finally:
        node.close()
    want = 1 + G2_PAYMENTS
    check(vb == ["cuda"] and "cpu" not in hb and vs == want
          and vk == vs + vw and hk == hs + hw,
          "G2 run: verify drains %d on %s == %d admissions (the accounts' "
          "transaction and each payment; the closes' candidates all "
          "cached), kernel %d with %d warmup; SHA-256 %d + %d warmup"
          % (vs, vb, want, vk, vw, hs, hw))
    archive = os.path.join(d, "empty-archive")
    os.makedirs(archive)
    twin = r_node(d, "g2-twin", archive, CpuSigVerifier(),
                  make_hasher("cpu"))
    st = {"hasher": CudaBatchHasher(device="cpu"), "seen": set(),
          "slot_hashes": [SC.ZERO_HASH] * 22}
    owed = 0
    db = sqlite3.connect(os.path.join(d, "run.db"))
    try:
        node_hashes = r_hashes(db, 1, 1 + G2_CLOSES)
        check(node_hashes[1] == twin.ledger_manager.lcl_hash.hex(),
              "G2: the twin's genesis == the node's")
        for seq in range(2, 2 + G2_CLOSES):
            twin.ledger_manager.value_externalized(lcd_from_db(db, seq))
            owed += fresh_slots(S, SC, st, twin.bucket_manager.bucket_list)
            check(twin.ledger_manager.lcl_hash.hex() == node_hashes[seq],
                  "G2: the twin's ledger %d == the card node's" % seq)
        ntx = db.execute("SELECT COUNT(*) FROM txhistory").fetchone()[0]
    finally:
        db.close()
        r_stop(twin)
    check(ntx == 1 + G2_PAYMENTS, "G2: %d transactions applied" % ntx)
    check(hs == owed, "G2 run: SHA-256 launches by drains %d == %d "
          "derived from the twin's bucket list close by close" % (hs, owed))
    log("G2 run node (%s): generateload %d accounts then %d payments, %d "
        "closes, every header == the C-verifier twin's; verify %d "
        "launches (%d drains + %d warmup), SHA-256 %d (%d + %d; the "
        "twin's bucket list owes the commitment %d)"
        % (card, G2_ACCOUNTS, G2_PAYMENTS, G2_CLOSES, vk, vs, vw, hk, hs,
           hw, owed))
    return vk, hk


def g2_gen_fuzz_job(d: str) -> tuple:
    """G2's `gen-fuzz` as a `g_start` job, and the input's path."""
    path = os.path.join(d, "input.bin")
    return ("G2 gen-fuzz", ["stellar_core_tpu_torch", "gen-fuzz", path,
                            "--mode", "tx", "--seed", str(G2_FUZZ_SEED),
                            "--conf", g_conf(d, "fuzz")], None), path


def g2_fuzz_jobs(d: str, path: str) -> list:
    """G2's `fuzz --input` and `fuzz --mode overlay` as `g_start` jobs."""
    conf = os.path.join(d, "fuzz.toml")
    return [("G2 fuzz --input", ["stellar_core_tpu_torch", "fuzz", "--mode",
                                 "tx", "--input", path, "--conf", conf],
             None),
            ("G2 fuzz --mode overlay",
             ["stellar_core_tpu_torch", "fuzz", "--mode", "overlay",
              "--iterations", str(G2_FUZZ_ITERATIONS), "--conf", conf],
             None)]


def g2_fuzz(gen: list, path: str, out: list, oout: list,
            card: str) -> tuple:
    """G2's fuzz checks on `gen-fuzz`'s, `fuzz --input`'s and `fuzz --mode
    overlay`'s output; returns their (verify, SHA-256) launches."""
    check(gen[-1].startswith("wrote ") and os.path.getsize(path) > 0,
          "G2: gen-fuzz writes its input (%s)" % gen[-1])
    one, tx_l = json.loads(out[0]), json.loads(out[1])
    check(one["iterations"] == 1 and one["decode_rejects"] == 0
          and tx_l["backend"] == "cuda-resilient",
          "G2: fuzz --input takes its one input past the decode on the "
          "card's stack (%s)" % one)
    tx = card_counts("G2 fuzz --input", tx_l["launches"])
    ov, ov_l = json.loads(oout[0]), json.loads(oout[1])
    check(ov["iterations"] == G2_FUZZ_ITERATIONS
          and ov["handler_errors"] == 0 and len(ov_l["launches"]) >= 2,
          "G2: fuzz --mode overlay runs %d iterations, no handler raised "
          "(%s)" % (G2_FUZZ_ITERATIONS, ov))
    ovk = card_counts("G2 fuzz --mode overlay", ov_l["launches"])
    check(ovk[0] > 0, "G2: the overlay fuzzer's nodes verified on the card")
    log("G2 fuzz (%s): --input %s, launches verify %d sha256 %d; overlay "
        "%s over %d nodes, launches verify %d sha256 %d"
        % (card, one, tx[0], tx[1], ov, len(ov_l["launches"]), ovk[0],
           ovk[1]))
    return tx[0] + ovk[0], tx[1] + ovk[1]


def g3_jobs(d: str) -> list:
    """G3's two probes, on the card's stacks under hash seeds 1 and 2, as
    `g_start` jobs. Each runs in a directory of its own under `d`: its
    nodes keep their buckets in the default `buckets/` of the working
    directory, and the two run side by side."""
    jobs = []
    for seed in (1, 2):
        cwd = os.path.join(d, "probe-%d" % seed)
        os.makedirs(cwd)
        path = os.pathsep.join(
            p for p in (REPO, M1_ENV.get("PYTHONPATH")) if p)
        jobs.append(("G3 probe PYTHONHASHSEED=%d" % seed,
                     ["stellar_core_tpu_torch.testing.hashseed_probe"],
                     dict(M1_ENV, PYTHONHASHSEED=str(seed),
                          PYTHONPATH=path), cwd))
    return jobs


def g3_probe(results: list, card: str) -> tuple:
    """G3's checks on the two probes' output; returns their (verify,
    SHA-256) launches."""
    outs, launches = [], [0, 0]
    for out, err in results:
        outs.append("\n".join(out))
        line = [x for x in err if x.startswith("hashseed_probe launches ")]
        check(len(line) == 1, "G3: the probe prints its launch line")
        got = card_counts("G3 probe", json.loads(
            line[0][len("hashseed_probe launches "):]))
        launches[0] += got[0]
        launches[1] += got[1]
    check(outs[0] == outs[1] and json.loads(outs[0]),
          "G3: the probe's output under PYTHONHASHSEED 1 and 2 is "
          "byte-identical (%d bytes)" % len(outs[0]))
    log("G3 probe (%s): two runs byte-identical, %d bytes; launches "
        "verify %d sha256 %d" % (card, len(outs[0]), launches[0],
                                 launches[1]))
    return tuple(launches)


def simulation_path(S, E, K, SC, torch, t_smoke: float, card: str) -> dict:
    """G1-G3 of the module docstring; returns the launches by kernel and
    phase."""
    from stellar_core_tpu_torch.testing import scenarios as SCN
    SH = harness("torch_sim_harness")
    names = G1_SCENARIOS
    if time.perf_counter() - t_smoke > G1_CUT_AFTER_S:
        names = G1_CUT
        log("G1 cut to %s: the script had run %.0f s before it"
            % (", ".join(names), time.perf_counter() - t_smoke))
    t0 = time.perf_counter()
    g1 = {"verify": 0, "sha256": 0}
    for name in names:
        got = g1_scenario(SCN, SH, E, S, torch, name, card)
        g1["verify"] += got["verify"]
        g1["sha256"] += got["sha256"]
    log("G1: %.1f s in all" % (time.perf_counter() - t0))
    # G2 and G3 overlap what does not depend on each other: the two
    # `simulate`s beside `gen-fuzz`, then the `run` node driven while the
    # two fuzzers and the two probes run
    steps = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_g2_") as d:
        gen_job, path = g2_gen_fuzz_job(d)
        (out, _e), (tout, _te), (gen, _ge) = g_cli(
            steps, g2_simulate_jobs(d) + [gen_job])
        sim = g2_simulate(out, tout, card)
        later = g_start(g2_fuzz_jobs(d, path) + g3_jobs(d))
        try:
            run = g2_generateload(steps, d, S, SC, card)
        except BaseException:
            g_stop(later)
            raise
        results = g_wait(steps, later)
        fz = g2_fuzz(gen, path, results[0][0], results[1][0], card)
        g3 = g3_probe(results[2:], card)
    log("G2 and G3: %.1f s in all" % (time.perf_counter() - t0))
    log("G2-G3 steps (%s), seconds with each process's start-up: %s"
        % (card, ", ".join("%s %.2f" % kv for kv in steps)))
    return {"verify": {"simulation G1": g1["verify"],
                       "simulation G2": sim[0] + run[0] + fz[0],
                       "simulation G3": g3[0]},
            "sha256": {"simulation G1": g1["sha256"],
                       "simulation G2": sim[1] + run[1] + fz[1],
                       "simulation G3": g3[1]}}


def t1_twin(BV, K, tally: dict):
    """T1's twin verifier: the C verifier behind the card stack's boundary.
    It prewarms where the card's does (`wants_prewarm`), records each
    triple that reached its backend after the cache with its decision, and
    counts its drains as the card would launch them: a `flush` after an
    `enqueue` that missed the cache, and a `verify_many` of any triple."""

    class Twin(BV.CpuSigVerifier):
        wants_prewarm = True

        def __init__(self) -> None:
            self._missed = False

        def enqueue(self, key, sig, msg):
            ck = K._cache_key(key.key_bytes, sig, msg)
            with K._cache_lock:
                hit = K._verify_cache.maybe_get(ck)
            fut = super().enqueue(key, sig, msg)
            if hit is None:
                self._missed = True
                tally["decided"].append(((key.key_bytes, sig, msg),
                                         fut.result()))
            return fut

        def flush(self) -> None:
            if self._missed:
                tally["drains"] += 1
                self._missed = False

        def verify_many(self, triples):
            out = super().verify_many(triples)
            if triples:
                tally["drains"] += 1
                tally["decided"].extend(zip(triples, out))
            return out

    return Twin


def t1_decisions(pairs: list, what: str) -> dict:
    """{triple: decision} of a side's (triple, decision) pairs; one triple
    decided twice must be decided alike."""
    out = {}
    for t, ok in pairs:
        check(out.setdefault(t, ok) == ok, "%s: one triple decided two "
              "ways" % what)
    return out


def t1_frames(log: list) -> int:
    """The frames a case's record shows applied: (name, summary) entries
    of `torch_ops_records.op_records`."""
    return sum(1 if e[0] == "apply_frame" else len(e[1][1]) for e in log
               if e[0] in ("apply_frame", "close_with"))


def semantics_path(E, K, BV, card: str) -> dict:
    """T1 of the module docstring: the reference's operation-semantics
    cases on the port, the card deciding their signatures, each case
    against a C-verifier twin."""
    import functools
    H = harness("torch_mirror_harness")
    R = harness("torch_ops_records")
    t0 = time.perf_counter()
    M = H.Mirror(("test_ledgertxn.py",) + tuple(T1_FILES),
                 hook=R.record_raises, subs=R.VERIFIER_SUBS,
                 siblings=("test_ledgertxn",), sides=("port",))
    cases = [c for c in M.cases() if c[0] in T1_FILES]
    for f, n in T1_FILES.items():
        check(sum(c[0] == f for c in cases) == n,
              "T1: %d cases of %s, as pytest collects" % (n, f))
    card_calls = []
    orig = BV.CudaSigVerifier.verify_many

    def card_verify_many(self, triples):
        out = orig(self, triples)
        card_calls.append(list(zip(triples, out)))
        return out

    frames = decided = rejected = launches = drains = 0
    BV.CudaSigVerifier.verify_many = card_verify_many
    try:
        for case in cases:
            what = "T1 " + H.Mirror.case_id(case)
            K.flush_verify_cache()
            del card_calls[:]
            M.patch = R.op_records
            n0 = E.LAUNCHES
            card_log = M.run("port", case)
            n = E.LAUNCHES - n0
            card_pairs = [p for call in card_calls for p in call]
            tally = {"drains": 0, "decided": []}
            K.flush_verify_cache()
            M.patch = functools.partial(R.op_records,
                                        verifier=t1_twin(BV, K, tally))
            twin_log = M.run("port", case)
            check(card_log == twin_log, "%s: the card's record == the "
                  "twin's" % what)
            check(n == len(card_calls) == tally["drains"],
                  "%s: %d launches, one per card drain (%d), == the "
                  "twin's drains after the cache (%d)"
                  % (what, n, len(card_calls), tally["drains"]))
            got = t1_decisions(card_pairs, what + " (card)")
            want = t1_decisions(tally["decided"], what + " (twin)")
            check(got == want, "%s: the card decided every triple the "
                  "twin's backend decided, alike" % what)
            frames += t1_frames(card_log)
            decided += len(card_pairs)
            rejected += sum(1 for _t, ok in card_pairs if not ok)
            launches += n
            drains += tally["drains"]
    finally:
        BV.CudaSigVerifier.verify_many = orig
    check(launches > 0 and rejected > 0, "T1: the card decided the cases' "
          "signatures and rejected some")
    check(not any(m == "jax" or m.startswith(("jax.", "stellar_core_tpu."))
                  or m == "stellar_core_tpu" for m in sys.modules),
          "T1: neither jax nor stellar_core_tpu was imported")
    wall = time.perf_counter() - t0
    log("semantics T1 (%s): %d reference cases of %d files on the port, "
        "each on the card and on a C-verifier twin, records equal; %d "
        "frames; the card decided %d signatures (%d rejected, as the twin "
        "decided them) in %d launches == the twin's %d drains after the "
        "cache; %.1f s" % (card, len(cases), len(T1_FILES), frames,
                           decided, rejected, launches, drains, wall))
    return {"verify": launches, "cases": len(cases), "s": wall}


def lint_path(card: str) -> None:
    """The lint of the module docstring: the port's engine over the port's
    package, through its command line."""
    from stellar_core_tpu_torch.analysis import default_config
    from stellar_core_tpu_torch.analysis.engine import load_allowlist
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "stellar_core_tpu_torch.analysis", "--json"],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    wall = time.perf_counter() - t0
    check(r.returncode in (0, 1) and r.stdout.lstrip().startswith("{"),
          "lint: the command ran (rc %d): %s"
          % (r.returncode, r.stderr[-2000:]))
    out = json.loads(r.stdout)
    for f in out["violations"]:
        log("lint violation: %(rule)s %(path)s:%(line)d (%(qualname)s) "
            "%(message)s" % f)
    for e in out["stale_entries"]:
        log("lint stale allowlist entry: %(rule)s %(path)s#%(qual)s "
            "(line %(lineno)d)" % e)
    for err in out["parse_errors"]:
        log("lint parse error: %s" % err)
    check(r.returncode == 0 and out["ok"] and not out["violations"]
          and not out["stale_entries"] and not out["parse_errors"],
          "lint: no unallowed finding, stale entry or parse error")
    rules = Counter(f["rule"] for f in out["findings"])
    check(sum(rules.values()) > 0, "lint: the rules found the sites the "
          "allowlist names")
    entries = load_allowlist(default_config().allowlist_path)
    files = out["cache"]["hits"] + out["cache"]["misses"]
    log("lint (%s): `python -m stellar_core_tpu_torch.analysis` over "
        "stellar_core_tpu_torch/, %d files (%d from its cache): %d "
        "findings (%s), every one behind the allowlist's %d entries; 0 "
        "violations, 0 stale entries, 0 parse errors; %.1f s"
        % (card, files, out["cache"]["hits"], sum(rules.values()),
           ", ".join("%s %d" % kv for kv in sorted(rules.items())),
           len(entries), wall))


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
    t_smoke = time.perf_counter()
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

    # each path's wall seconds, for the budget (PERF.md §5)
    path_s = {}
    t_path = t_smoke

    def lap(name: str) -> None:
        nonlocal t_path
        now = time.perf_counter()
        path_s[name] = round(now - t_path, 1)
        t_path = now

    lap("start-up")

    # --- the lint, on the card's host --------------------------------------
    lint_path(card)
    lap("lint")

    # --- build ------------------------------------------------------------
    t0 = time.perf_counter()
    prebuilt = {stem for stem in ("ed25519_verify", "sha256")
                if _build.cuda_built(stem)}
    # the apply engine and the codec's C route (CPython extensions, cc)
    # build on a thread while nvcc builds the kernels
    exts, ext_err = {}, []

    def build_extensions():
        try:
            t1 = time.perf_counter()
            exts["applyc"] = native.apply_engine()
            exts["xdrc"] = native.xdr_engine()
            exts["s"] = time.perf_counter() - t1
        except BaseException as e:   # re-raised on the main thread
            ext_err.append(e)

    import threading
    th = threading.Thread(target=build_extensions)
    th.start()
    try:
        libs = _build.build_cuda()
    finally:
        th.join()
    if ext_err:
        raise ext_err[0]
    check(exts["applyc"] is not None and exts["xdrc"] is not None
          and exts["applyc"].__name__ == "_sctapply_torch"
          and exts["xdrc"].__name__ == "_sctxdr_torch"
          and all(os.path.dirname(exts[k].__file__) == _build.BUILD_DIR
                  for k in ("applyc", "xdrc")),
          "the apply engine and the codec's C route build into %s"
          % _build.BUILD_DIR)
    check(ed25519_native() is not None, "the C CPU verifier builds")
    check(native.prep_lib() is not None, "the C host prep builds")
    log("build: %.1f s (%s; the extensions %s and %s in %.1f s beside "
        "them)" % (time.perf_counter() - t0, ", ".join(sorted(libs)),
                   os.path.basename(exts["applyc"].__file__),
                   os.path.basename(exts["xdrc"].__file__), exts["s"]))
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
    lap("build, verify and fleet")

    shapes, hash_launches, records, want_leaves = hash_path(torch, rng,
                                                           props)

    # --- the hasher's operator layers: C padder, staging, breaker ----------
    from stellar_core_tpu_torch.crypto.batch_hasher import CudaBatchHasher
    from stellar_core_tpu_torch.ledger import state_commitment as SC
    pad_phase(S, native, CudaBatchHasher(), records, rng)
    hash_layer_drains(S, E, native, SC, records, want_leaves, rng,
                      flight_dir, card)
    hash_breaker_phase(S, E, SC, rng, flight_dir)
    lap("hash")

    # --- the ledger: bucket list and state commitment over 2^20 entries ---
    ledger = ledger_path(S, E, rng, flight_dir, card)
    ledger_launches = sum(ledger["launches"].values())
    lap("ledger")

    # --- the close: LedgerManager closes of signed multisig ledgers -------
    closes = close_path(S, E, K, rng, flight_dir, card)
    lap("close")

    # --- catchup: publish, replay checkpoints on the card, restart ---------
    catchup = catchup_path(S, E, K, SC, flight_dir, card)
    lap("catchup and M1")

    # --- SCP and the herder: a tier-1 quorum reaching consensus ------------
    herder = herder_path(S, E, K, SC, card)
    lap("herder")

    # --- overlay: the same quorum over authenticated peers, and TCP -------
    overlay = overlay_path(S, E, K, SC, card)
    lap("overlay")

    # --- simulation: the scenario lab, the operator's commands, the probe --
    simulation = simulation_path(S, E, K, SC, torch, t_smoke, card)
    lap("simulation")

    # --- the reference's operation-semantics cases, decided on the card ---
    semantics = semantics_path(E, K, BV, card)
    lap("semantics T1")
    log("paths' wall seconds (%s): %s; %.1f s in all"
        % (card, json.dumps(path_s), time.perf_counter() - t_smoke))

    main_b = buckets[DRAIN_CHUNK]
    main_s = shapes[HASH_MAIN_SHAPE]
    main_f = fleet["shard"][DRAIN_CHUNK]
    log(json.dumps({"kernels": [{
        "name": "ed25519_verify", "route": "cuda",
        "source": "stellar_core_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "stellar_core_tpu/ops/ed25519.py:328",
        "launches": launches + sum(closes["verify"].values())
        + catchup["verify"] + catchup["main M1"]["verify"]
        + sum(herder["verify"].values())
        + sum(overlay["verify"].values())
        + sum(simulation["verify"].values()) + semantics["verify"],
        "launches_by_path": {"verify main path": launches,
                             **closes["verify"],
                             "catchup": catchup["verify"],
                             "main M1": catchup["main M1"]["verify"],
                             **herder["verify"], **overlay["verify"],
                             **simulation["verify"],
                             "semantics T1": semantics["verify"]},
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
        + sum(closes["sha256"].values()) + catchup["sha256"]
        + catchup["main M1"]["sha256"]
        + sum(herder["sha256"].values())
        + sum(overlay["sha256"].values())
        + sum(simulation["sha256"].values()),
        "launches_by_path": {"hash main path": hash_launches,
                             **ledger["launches"], **closes["sha256"],
                             "catchup": catchup["sha256"],
                             "main M1": catchup["main M1"]["sha256"],
                             **herder["sha256"], **overlay["sha256"],
                             **simulation["sha256"]},
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
