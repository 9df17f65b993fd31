"""State commitments: the Merkle tree over a bucket's entries.

Port of part of `stellar_core_tpu/ledger/state_commitment.py` at commit
ada2c73: the domain-separation prefixes, the Merkle helpers (`merkle_root`,
`merkle_path`, `merkle_climb`, copies; carry a fix in either copy to the
other) and the entry-root drain of `StateCommitmentEngine._entry_leaves` /
`entry_root`, without its cache.

A bucket's entry root is the Merkle root over its entry leaves,
`SHA256(0x00 ‖ BucketEntry XDR)`; interior nodes are `SHA256(0x01 ‖ left ‖
right)` with a lonely right edge promoted unchanged. Leaf hashing is the
device-batchable load (thousands of small messages per changed bucket), so
it goes through a BatchHasher (`site="bucket-entries"`); the interior is
hashed on the host.

The port has no bucket layer yet, so `entry_leaves` and `entry_root` take
the bucket's XDR entry bodies: the bytes the reference's
`entry_record(e)[4:]` gives (the framed record without its RFC 5531 mark).
The engine itself (the incremental tree over the bucket list, checkpoints,
proofs) comes with the bucket layer.
"""

from __future__ import annotations

from typing import List, Sequence

from ..crypto.hashing import sha256

# domain-separation prefixes (module docstring)
ENTRY_LEAF_PREFIX = b"\x00"
NODE_PREFIX = b"\x01"
BUCKET_LEAF_PREFIX = b"\x02"

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
