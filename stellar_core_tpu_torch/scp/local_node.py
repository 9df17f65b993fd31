"""LocalNode: quorum-set math (quorum slices, v-blocking sets, weights).

Copied from `stellar_core_tpu/scp/local_node.py` at commit 85271b0;
carry a fix in either copy to the other. Nothing is left out.

Role parity: reference `src/scp/LocalNode.{h,cpp}:57-91` — isQuorumSlice,
isVBlocking, isQuorum (transitive closure), findClosestVBlocking,
getNodeWeight. Pure functions over SCPQuorumSet; no I/O.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set

from ..xdr import NodeID, SCPQuorumSet

UINT64_MAX = 2**64 - 1


def _nid(n: NodeID) -> bytes:
    return n.key_bytes


class LocalNode:
    def __init__(self, node_id: NodeID, is_validator: bool,
                 qset: SCPQuorumSet) -> None:
        self.node_id = node_id
        self.is_validator = is_validator
        self.qset = qset
        from ..crypto.hashing import sha256
        self.qset_hash = sha256(qset.to_xdr())

    def update_quorum_set(self, qset: SCPQuorumSet) -> None:
        from ..crypto.hashing import sha256
        self.qset = qset
        self.qset_hash = sha256(qset.to_xdr())

    # -- static quorum math --------------------------------------------------
    @staticmethod
    def is_quorum_slice(qset: SCPQuorumSet, nodes: Set[bytes]) -> bool:
        """Does `nodes` contain a slice of qset?"""
        count = sum(1 for v in qset.validators if _nid(v) in nodes)
        count += sum(1 for inner in qset.innerSets
                     if LocalNode.is_quorum_slice(inner, nodes))
        return count >= qset.threshold

    @staticmethod
    def is_v_blocking(qset: SCPQuorumSet, nodes: Set[bytes]) -> bool:
        """Does `nodes` intersect every slice of qset? Equivalent: qset can't
        reach threshold without `nodes`."""
        if qset.threshold == 0:
            return False
        left = qset.threshold
        total = len(qset.validators) + len(qset.innerSets)
        # how many members may be 'lost' while still reaching threshold
        slack = total - qset.threshold
        blocked = sum(1 for v in qset.validators if _nid(v) in nodes)
        blocked += sum(1 for inner in qset.innerSets
                       if LocalNode.is_v_blocking(inner, nodes))
        return blocked > slack

    @staticmethod
    def is_v_blocking_filter(qset: SCPQuorumSet, envelopes: Iterable,
                             filt: Callable) -> bool:
        nodes = {_nid(e.statement.nodeID) for e in envelopes
                 if filt(e.statement)}
        return LocalNode.is_v_blocking(qset, nodes)

    @staticmethod
    def is_quorum(local_qset: Optional[SCPQuorumSet], envelopes: Dict,
                  qset_of: Callable, filt: Callable) -> bool:
        """Transitive quorum check: nodes passing `filt` whose quorum sets
        (via qset_of(statement)) are recursively satisfied. `envelopes` maps
        nodeID-bytes → envelope. If local_qset given, the final set must also
        be a slice for the local node (reference LocalNode::isQuorum)."""
        nodes = {nb for nb, e in envelopes.items() if filt(e.statement)}
        while True:
            def ok(nb: bytes) -> bool:
                q = qset_of(envelopes[nb].statement)
                return q is not None and LocalNode.is_quorum_slice(q, nodes)
            pruned = {nb for nb in nodes if ok(nb)}
            if pruned == nodes:
                break
            nodes = pruned
        if not nodes:
            return False
        if local_qset is not None:
            return LocalNode.is_quorum_slice(local_qset, nodes)
        return True

    @staticmethod
    def find_closest_v_blocking(qset: SCPQuorumSet, nodes: Set[bytes],
                                excluded: Optional[bytes] = None
                                ) -> List[bytes]:
        """Smallest subset of `nodes` that is v-blocking for qset
        (greedy, reference findClosestVBlocking)."""
        leftTillBlock = 1 + (len(qset.validators) + len(qset.innerSets)
                             - qset.threshold)
        res: List[bytes] = []
        candidates: List[List[bytes]] = []
        for v in qset.validators:
            nb = _nid(v)
            if nb == excluded:
                continue
            if nb in nodes:
                candidates.append([nb])
        for inner in qset.innerSets:
            sub = LocalNode.find_closest_v_blocking(inner, nodes, excluded)
            if sub:
                candidates.append(sub)
        candidates.sort(key=len)
        for c in candidates:
            leftTillBlock -= 1
            res.extend(c)
            if leftTillBlock == 0:
                return res
        return []  # not blockable with these nodes

    # -- weights (nomination leader election) --------------------------------
    @staticmethod
    def get_node_weight(node: bytes, qset: SCPQuorumSet) -> int:
        """Weight in [0, 2^64): fraction of slices containing node,
        approximated hierarchically (reference getNodeWeight)."""
        n = qset.threshold
        d = len(qset.validators) + len(qset.innerSets)
        if d == 0:
            return 0
        for v in qset.validators:
            if _nid(v) == node:
                return (UINT64_MAX * n) // d
        for inner in qset.innerSets:
            w = LocalNode.get_node_weight(node, inner)
            if w > 0:
                return (w * n) // d
        return 0


def all_nodes_of(qset: SCPQuorumSet) -> Set[bytes]:
    out = {_nid(v) for v in qset.validators}
    for inner in qset.innerSets:
        out |= all_nodes_of(inner)
    return out
