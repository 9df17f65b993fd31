"""State commitments: an incremental Merkle tree over the bucket list,
signed succinct checkpoints, and light-client membership proofs.

Copied from `stellar_core_tpu/ledger/state_commitment.py` at commit
637fb91 (the Merkle helpers, `entry_leaves` and `entry_root` since
ada2c73); carry a fix in either copy to the other. One deliberate
difference: the reference's `StateCommitmentEngine._entry_leaves` hashes
with `hashlib` on the host when the app has no `batch_hasher`; the copy
raises TypeError instead, as the module's `entry_leaves` does without a
hasher, so a node meant to hash on the card never does so silently on the
host. `from_scratch_root` stays the `hashlib` oracle, as in the
reference.

The bucket list already content-addresses the whole ledger state — but
its hash chain (`SHA256(concat_i SHA256(curr_i ‖ snap_i))`) only proves
WHOLE-STATE equality. This module adds the proof-carrying half:

- **Commitment tree.** One Merkle leaf per bucket slot (curr and snap
  of each of the 11 levels, 22 leaves): `leaf = SHA256(0x02 ‖
  bucket_stream_hash ‖ entry_root)`, where `entry_root` is the Merkle
  root over the bucket's entry leaves (`SHA256(0x00 ‖ entry_xdr)`).
  Interior nodes are `SHA256(0x01 ‖ left ‖ right)` with a lonely right
  edge promoted unchanged — the prefixes domain-separate the two tree
  layers from each other and from raw SHA-256 traffic.
- **Incremental update.** Buckets are immutable and content-addressed,
  so entry roots are cached by bucket hash: a close recomputes entry
  roots only for buckets that CHANGED this close (level-0 fresh every
  close, deeper levels only at their spill boundaries) — O(changed
  levels), not O(state). The 22-leaf top tree re-hashes in 21 small
  SHA-256s. A from-scratch oracle (`from_scratch_root`) ignores every
  cache.
- **Checkpoints.** Every `STATE_CHECKPOINT_INTERVAL` closes the engine
  emits a `StateCheckpoint` {ledger seq, header hash, Merkle root, node
  signature over the network-id-bound payload}, kept in a bounded ring.
  The `commitment.sign-fail` fault site models a sealed-key failure: the
  checkpoint for that interval is skipped (visible via
  `commitment.sign-fail`), the next interval retries.
- **Light clients.** `light_client_verify(proof, checkpoint,
  network_id)` is a pure function over the proof bytes — no ledger DB,
  no bucket files, no Application: entry leaf → entry root → commitment
  leaf → root, then the ed25519 signature over the checkpoint payload.

Leaf hashing is the device-batchable load (thousands of small messages
per changed bucket), so it goes through a BatchHasher
(`site="bucket-entries"`; `make_hasher()` for the card); the interior is
hashed on the host. `entry_leaves` and `entry_root` also take a bucket's
XDR entry bodies directly: the bytes `entry_record(e)[4:]` gives (the
framed record without its RFC 5531 mark).
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from ..bucket.bucket import bucket_entry_sort_key, entry_record
from ..crypto.hashing import sha256
from ..crypto.keys import PubKeyUtils
from ..util.log import get_logger
from ..util.timer import real_monotonic
from ..util.tracing import tracer_instant
from ..xdr import BucketEntryType, PublicKey, ledger_key_sort_key

log = get_logger("Ledger")

# default closes-per-checkpoint; the app's config.STATE_CHECKPOINT_INTERVAL
# overrides per node
CHECKPOINT_INTERVAL = 8

# domain-separation prefixes (module docstring)
ENTRY_LEAF_PREFIX = b"\x00"
NODE_PREFIX = b"\x01"
BUCKET_LEAF_PREFIX = b"\x02"

# checkpoint signature payload versioning
_SIGN_DOMAIN = b"sct-state-checkpoint-v1"

ZERO_HASH = b"\x00" * 32


def _node(left: bytes, right: bytes) -> bytes:
    return sha256(NODE_PREFIX + left + right)


def merkle_root(leaves: List[bytes]) -> bytes:
    """Root over leaf hashes; a lonely right edge is promoted unchanged
    (no duplication — the path length just shortens on that edge).
    Empty input commits to the zero hash."""
    if not leaves:
        return ZERO_HASH
    level = list(leaves)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(_node(level[i], level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def merkle_path(leaves: List[bytes], index: int) -> List[dict]:
    """Inclusion path for leaves[index]: a list of {"h": sibling hex,
    "right": sibling-is-on-the-right} steps from leaf to root."""
    assert 0 <= index < len(leaves)
    path: List[dict] = []
    level = list(leaves)
    i = index
    while len(level) > 1:
        nxt = []
        for j in range(0, len(level) - 1, 2):
            nxt.append(_node(level[j], level[j + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        sib = i ^ 1
        if sib < len(level):
            path.append({"h": level[sib].hex(), "right": bool(sib > i)})
        i //= 2
        level = nxt
    return path


def merkle_climb(leaf: bytes, path: List[dict]) -> bytes:
    """Recompute the root from a leaf and its inclusion path."""
    h = leaf
    for step in path:
        sib = bytes.fromhex(step["h"])
        h = _node(h, sib) if step["right"] else _node(sib, h)
    return h


def entry_leaves(records: Sequence[bytes], hasher) -> List[bytes]:
    """Entry leaf hashes of one bucket, from its XDR entry bodies, through
    `hasher` (a BatchHasher, `make_hasher()` for the card) in one drain."""
    return hasher.hash_many([ENTRY_LEAF_PREFIX + r for r in records],
                            site="bucket-entries")


def entry_root(records: Sequence[bytes], hasher) -> bytes:
    """Merkle root over one bucket's entry leaves, hashed by `hasher`."""
    return merkle_root(entry_leaves(records, hasher))


def checkpoint_sign_payload(network_id: bytes, ledger_seq: int,
                            header_hash: bytes, root: bytes) -> bytes:
    """The bytes a checkpoint signature covers: domain- and
    network-bound so a checkpoint can never be replayed across networks
    or mistaken for any other signed artifact."""
    return (_SIGN_DOMAIN + network_id +
            ledger_seq.to_bytes(4, "big") + header_hash + root)


class StateCheckpoint:
    """A signed, succinct state commitment: everything a light client
    needs to verify entry membership without replay."""

    __slots__ = ("ledger_seq", "header_hash", "merkle_root", "node_id",
                 "signature")

    def __init__(self, ledger_seq: int, header_hash: bytes,
                 merkle_root_: bytes, node_id: bytes,
                 signature: bytes) -> None:
        self.ledger_seq = ledger_seq
        self.header_hash = header_hash
        self.merkle_root = merkle_root_
        self.node_id = node_id          # 32-byte ed25519 public key
        self.signature = signature

    def to_json(self) -> dict:
        return {"v": 1, "ledger_seq": self.ledger_seq,
                "header_hash": self.header_hash.hex(),
                "merkle_root": self.merkle_root.hex(),
                "node_id": self.node_id.hex(),
                "signature": self.signature.hex()}

    @classmethod
    def from_json(cls, blob: dict) -> "StateCheckpoint":
        return cls(int(blob["ledger_seq"]),
                   bytes.fromhex(blob["header_hash"]),
                   bytes.fromhex(blob["merkle_root"]),
                   bytes.fromhex(blob["node_id"]),
                   bytes.fromhex(blob["signature"]))


def light_client_verify(proof: dict, checkpoint: dict,
                        network_id: bytes) -> Tuple[bool, str]:
    """Pure light-client verification: (ok, reason). Touches ONLY the
    proof + checkpoint blobs and the network id — no ledger DB, no
    bucket files, no Application object.

    Steps: entry leaf → entry root (entry_path) → commitment leaf
    (bucket hash binding) → commitment root (leaf_path) → root equality
    with the checkpoint → ed25519 signature over the checkpoint
    payload."""
    try:
        entry = bytes.fromhex(proof["entry"])
        bucket_hash = bytes.fromhex(proof["bucket_hash"])
        root = bytes.fromhex(checkpoint["merkle_root"])
        header_hash = bytes.fromhex(checkpoint["header_hash"])
        node_id = bytes.fromhex(checkpoint["node_id"])
        signature = bytes.fromhex(checkpoint["signature"])
        seq = int(checkpoint["ledger_seq"])
    except (KeyError, ValueError, TypeError) as e:
        return False, "malformed proof/checkpoint: %s" % e
    entry_leaf = sha256(ENTRY_LEAF_PREFIX + entry)
    entry_root = merkle_climb(entry_leaf, proof.get("entry_path", []))
    leaf = sha256(BUCKET_LEAF_PREFIX + bucket_hash + entry_root)
    got_root = merkle_climb(leaf, proof.get("leaf_path", []))
    if got_root != root:
        return False, "merkle root mismatch"
    payload = checkpoint_sign_payload(network_id, seq, header_hash, root)
    if not PubKeyUtils.verify_sig(PublicKey.ed25519(node_id), signature,
                                  payload):
        return False, "checkpoint signature invalid"
    return True, "ok"


class StateCommitmentEngine:
    """Per-node commitment state: leaf/entry-root caches, the live
    root, and the checkpoint ring. Driven from the close path
    (`on_close`, main thread only — mirrors the bucket list's own
    threading contract); `checkpoint()` and `prove_entry()` serve what
    the reference's admin `checkpoint` endpoint serves."""

    CHECKPOINT_RING = 64

    def __init__(self, app) -> None:
        self.app = app
        self.metrics = getattr(app, "metrics", None)
        # bucket-hash -> entry Merkle root; buckets are immutable, so
        # the cache is sound by construction. Bounded: stale entries
        # (buckets GC'd by forgetUnreferencedBuckets) age out once the
        # map exceeds twice the live slot count.
        self._entry_roots: "OrderedDict[bytes, bytes]" = OrderedDict()
        # leaf slot -> (bucket_hash, leaf_hash): the incremental state
        self._leaves: List[Optional[Tuple[bytes, bytes]]] = []
        self._root: Optional[bytes] = None
        self._closes = 0
        self.checkpoints: "OrderedDict[int, StateCheckpoint]" = \
            OrderedDict()
        # the latest checkpoint's frozen view: the bucket objects (all
        # immutable, shared with the live list) and their leaf hashes
        # at emit time — proofs are built against THIS root so a served
        # (proof, checkpoint) pair always verifies, however many closes
        # have advanced the live root since
        self._checkpoint_slots: Optional[List] = None
        self._checkpoint_leaves: Optional[List[bytes]] = None
        if self.metrics is not None:
            m = self.metrics
            self._h_changed = m.new_histogram("commitment.leaves-changed")
            self._h_update = m.new_histogram("commitment.update-ms")
        else:
            self._h_changed = self._h_update = None

    # -- entry roots ---------------------------------------------------------
    def _entry_leaves(self, bucket) -> List[bytes]:
        """Entry leaf hashes for one bucket — the device-batchable
        drain: whole entry-blocks per dispatch through the app's
        BatchHasher (`site="bucket-entries"`). Raises TypeError when the
        app has no `batch_hasher` (module docstring)."""
        # entry_record is the memoized framed record the bucket's own
        # hash serialized; [4:] strips the RFC 5531 mark back to the
        # XDR body, so leaf hashing never re-serializes an entry
        hasher = getattr(self.app, "batch_hasher", None)
        if hasher is None:
            raise TypeError("StateCommitmentEngine needs app.batch_hasher "
                            "(make_hasher()); it never hashes entry "
                            "leaves on the host on its own")
        return entry_leaves([entry_record(e)[4:] for e in bucket.entries],
                            hasher)

    def entry_root(self, bucket) -> bytes:
        """Merkle root over a bucket's entry leaves, cached by the
        bucket's identity hash (immutable content)."""
        bh = bucket.get_hash()
        got = self._entry_roots.get(bh)
        if got is not None:
            self._entry_roots.move_to_end(bh)
            return got
        root = merkle_root(self._entry_leaves(bucket))
        self._entry_roots[bh] = root
        limit = max(64, 4 * max(1, len(self._leaves)))
        while len(self._entry_roots) > limit:
            self._entry_roots.popitem(last=False)
        return root

    @staticmethod
    def _slots(bucket_list) -> List:
        """The fixed leaf order: level 0 curr, level 0 snap, level 1
        curr, ... — matching the bucket list's own hash-chain order."""
        out = []
        for lev in bucket_list.levels:
            out.append(lev.curr)
            out.append(lev.snap)
        return out

    def _leaf_hash(self, bucket) -> Tuple[bytes, bytes]:
        bh = bucket.get_hash()
        if bh == ZERO_HASH:
            return bh, sha256(BUCKET_LEAF_PREFIX + bh + ZERO_HASH)
        return bh, sha256(BUCKET_LEAF_PREFIX + bh + self.entry_root(bucket))

    # -- the incremental update ---------------------------------------------
    def update_root(self, bucket_list) -> bytes:
        """Refresh the commitment root after a close: only leaves whose
        bucket hash changed recompute their entry root (cache hit
        otherwise); the 22-leaf top tree re-hashes unconditionally (21
        small SHA-256s — cheaper than tracking its internal nodes)."""
        t0 = real_monotonic()
        slots = self._slots(bucket_list)
        if len(self._leaves) != len(slots):
            self._leaves = [None] * len(slots)
        changed = 0
        for i, b in enumerate(slots):
            bh = b.get_hash()
            cached = self._leaves[i]
            if cached is not None and cached[0] == bh:
                continue
            self._leaves[i] = self._leaf_hash(b)
            changed += 1
        self._root = merkle_root([lf[1] for lf in self._leaves])
        if self._h_changed is not None:
            self._h_changed.update(changed)
            self._h_update.update((real_monotonic() - t0) * 1e3)
        return self._root

    def from_scratch_root(self, bucket_list) -> bytes:
        """The differential oracle: the same root computed with every
        cache bypassed (entry leaves re-hashed via plain hashlib)."""
        leaves = []
        for b in self._slots(bucket_list):
            bh = b.get_hash()
            if bh == ZERO_HASH:
                er = ZERO_HASH
            else:
                er = merkle_root([sha256(ENTRY_LEAF_PREFIX + e.to_xdr())
                                  for e in b.entries])
            leaves.append(sha256(BUCKET_LEAF_PREFIX + bh + er))
        return merkle_root(leaves)

    @property
    def root(self) -> Optional[bytes]:
        return self._root

    # -- the close hook ------------------------------------------------------
    def on_close(self, bucket_list, ledger_seq: int,
                 header_hash: bytes) -> Optional[StateCheckpoint]:
        """Called once per committed close (main thread): incremental
        root update, then a signed checkpoint every
        STATE_CHECKPOINT_INTERVAL closes. Returns the checkpoint when
        one was emitted."""
        self.update_root(bucket_list)
        self._closes += 1
        interval = getattr(getattr(self.app, "config", None),
                           "STATE_CHECKPOINT_INTERVAL",
                           CHECKPOINT_INTERVAL)
        if interval <= 0 or self._closes % interval:
            return None
        return self._emit_checkpoint(ledger_seq, header_hash,
                                     self._slots(bucket_list))

    def _emit_checkpoint(self, ledger_seq: int, header_hash: bytes,
                         slots: List) -> Optional[StateCheckpoint]:
        cfg = getattr(self.app, "config", None)
        seed = getattr(cfg, "NODE_SEED", None)
        if seed is None or self._root is None:
            return None
        payload = checkpoint_sign_payload(cfg.network_id, ledger_seq,
                                          header_hash, self._root)
        try:
            faults = getattr(self.app, "faults", None)
            if faults is not None:
                # a sealed-key/HSM failure: this interval's checkpoint
                # is skipped (metered + dumped), the next one retries
                faults.fire_point("commitment.sign-fail")
            sig = seed.sign(payload)
        except Exception as e:
            log.warning("checkpoint signing failed at ledger %d: %s — "
                        "skipping this interval", ledger_seq, e)
            if self.metrics is not None:
                self.metrics.new_meter("commitment.sign-fail").mark()
            fr = getattr(self.app, "flight_recorder", None)
            if fr is not None:
                fr.dump("checkpoint-sign-fail",
                        extra={"ledger_seq": ledger_seq,
                               "error": repr(e)})
            return None
        cp = StateCheckpoint(ledger_seq, header_hash, self._root,
                             seed.public_key.key_bytes, sig)
        self.checkpoints[ledger_seq] = cp
        # freeze the proof view (module docstring): immutable bucket
        # refs + the leaf vector that hashes to cp.merkle_root
        self._checkpoint_slots = list(slots)
        self._checkpoint_leaves = [lf[1] for lf in self._leaves] \
            if self._leaves else None
        while len(self.checkpoints) > self.CHECKPOINT_RING:
            self.checkpoints.popitem(last=False)
        if self.metrics is not None:
            self.metrics.new_meter("commitment.checkpoint.emitted").mark()
            self.metrics.new_counter(
                "commitment.checkpoint.seq").set_count(ledger_seq)
        tracer_instant(getattr(self.app, "tracer", None),
                       "commitment.checkpoint", cat="ledger",
                       seq=ledger_seq, root=self._root.hex()[:16])
        return cp

    def checkpoint(self, seq: Optional[int] = None) -> Optional[dict]:
        """The latest (or an exact-seq) checkpoint as the JSON blob the
        admin endpoint serves and light_client_verify consumes."""
        if not self.checkpoints:
            return None
        if seq is None:
            return next(reversed(self.checkpoints.values())).to_json()
        cp = self.checkpoints.get(seq)
        return cp.to_json() if cp is not None else None

    # -- proofs --------------------------------------------------------------
    def prove_entry(self, key, bucket_list=None) -> Optional[dict]:
        """Membership proof for the NEWEST live version of `key` (first
        match walking level 0 curr → deepest snap, the bucket list's
        own read order). Returns None when the entry is absent or its
        newest record is a tombstone.

        Proofs are built against the latest CHECKPOINT's frozen view
        when one exists (so the served (proof, checkpoint) pair always
        verifies); the live bucket list is the fallback before the
        first checkpoint — those proofs verify against `root`.

        Each bucket is binary-searched on the canonical entry order
        (bucket_entry_sort_key — the identity ordering buckets are
        sorted by), so a proof costs O(levels · log entries) key
        computations, not a full O(state) scan with a serialized
        comparison per entry."""
        target = (ledger_key_sort_key(key),)
        if self._checkpoint_slots is not None:
            slots = self._checkpoint_slots
        elif bucket_list is not None:
            slots = self._slots(bucket_list)
        else:
            return None
        for slot_idx, bucket in enumerate(slots):
            if bucket.get_hash() == ZERO_HASH:
                continue
            entries = bucket.entries
            lo, hi = 0, len(entries)
            while lo < hi:
                mid = (lo + hi) // 2
                if bucket_entry_sort_key(entries[mid]) < target:
                    lo = mid + 1
                else:
                    hi = mid
            if lo >= len(entries) or \
                    bucket_entry_sort_key(entries[lo]) != target:
                continue
            e = entries[lo]
            if e.disc == BucketEntryType.DEADENTRY:
                return None                  # newest record: deleted
            return self._build_proof(slots, slot_idx, bucket, lo, e)
        return None

    def _build_proof(self, slots, slot_idx: int, bucket, entry_idx: int,
                     entry) -> dict:
        entry_leaves = self._proof_entry_leaves(bucket)
        if self._checkpoint_slots is not None and \
                slots is self._checkpoint_slots and \
                self._checkpoint_leaves is not None:
            leaf_hashes = self._checkpoint_leaves
        elif self._leaves and len(self._leaves) == len(slots) and \
                all(lf is not None for lf in self._leaves):
            leaf_hashes = [lf[1] for lf in self._leaves]
        else:
            leaf_hashes = [self._leaf_hash(b)[1] for b in slots]
        proof = {
            "v": 1,
            "entry": entry.to_xdr().hex(),
            "entry_index": entry_idx,
            "entry_count": len(bucket.entries),
            "entry_path": merkle_path(entry_leaves, entry_idx),
            "bucket_hash": bucket.get_hash().hex(),
            "leaf_index": slot_idx,
            "leaf_path": merkle_path(leaf_hashes, slot_idx),
        }
        if self.metrics is not None:
            self.metrics.new_meter("commitment.proof.served").mark()
            self.metrics.new_histogram("commitment.proof.bytes").update(
                len(json.dumps(proof)))
        return proof

    def _proof_entry_leaves(self, bucket) -> List[bytes]:
        # positional leaves in the bucket's canonical (sorted) entry
        # order; only the ROOT is cached (entry_root), so a proof pays
        # one leaf re-hash pass over its bucket — bounded by bucket
        # size, off the close path (admin requests post to main)
        return self._entry_leaves(bucket)
