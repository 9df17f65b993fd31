"""Quorum intersection checker + transitive quorum tracker.

Copied from `stellar_core_tpu/herder/quorum_intersection.py` at commit
ba35320; carry a fix in either copy to the other. Nothing is left out.

Role parity: reference `src/herder/QuorumIntersectionCheckerImpl.{h,cpp}`
(min-quorum enumeration with SCC pruning, contraction to maximal quorums,
half-space cutoff, perimeter look-ahead, max-indegree branching heuristic
— algorithm documented at QuorumIntersectionCheckerImpl.h:7-300, after
Lachowski arXiv:1902.06493) and `src/herder/QuorumTracker.{h,cpp}`
(transitive closure of the local qset over received SCP traffic).

Sets of nodes are Python ints used as bitmasks — the Python-idiomatic
analogue of the reference's BitSet, giving O(1)-word intersection /
containment over networks of hundreds of validators.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..util.log import get_logger
from ..xdr import PublicKey, SCPQuorumSet

log = get_logger("SCP")


class QuorumIntersectionChecker:
    def __init__(self, qmap: Dict[bytes, Optional[SCPQuorumSet]],
                 parent: "QuorumIntersectionChecker" = None) -> None:
        """qmap: node id (raw 32B ed25519) -> its quorum set (None if
        unknown; unknown nodes can never be satisfied, matching the
        reference's treatment of missing qsets).

        `parent` shares its interrupt flag with this checker (the
        criticality scan builds one throwaway checker per candidate
        group; the reference threads one shared interrupt flag through
        all of them — HerderImpl.cpp:140-144)."""
        self._parent = parent
        self.ids: List[bytes] = sorted(qmap)
        self.index: Dict[bytes, int] = {v: i for i, v in enumerate(self.ids)}
        self.n = len(self.ids)
        self.full: int = (1 << self.n) - 1
        self._qsets: List[Optional[SCPQuorumSet]] = [
            qmap[v] for v in self.ids]
        # dependency edges i -> j (j appears in i's qset, transitively
        # through inner sets)
        self._deps: List[int] = [self._dep_mask(qs) for qs in self._qsets]
        self.interrupted = False
        self.last_split: Optional[Tuple[List[bytes], List[bytes]]] = None
        self.quorums_seen = 0
        # compiled qset forms: pubnet-scale maps share qset structure
        # heavily (every org validator carries the same top-level set), so
        # satisfaction is evaluated per DISTINCT compiled set and memoized
        # per (set, mask) — this is what makes ~100-org transitive maps
        # finish (reference compiles to TBitSet structures similarly,
        # QuorumIntersectionCheckerImpl.h:7-60)
        self._compiled: List[Tuple[int, int, Tuple[int, ...]]] = []
        self._compile_by_id: Dict[int, int] = {}
        self._compile_by_val: Dict[tuple, int] = {}
        self._compile_keepalive: List[SCPQuorumSet] = []
        self._node_cq: List[Optional[int]] = [
            None if qs is None else self._compile_qs(qs)
            for qs in self._qsets]
        self._sat_cache: Dict[Tuple[int, int], bool] = {}
        # nodes grouped by compiled qset: a contraction pass evaluates
        # each DISTINCT qset once instead of once per node (nodes with no
        # qset are never satisfied, so they simply have no group)
        groups: Dict[int, int] = {}
        for i, ci in enumerate(self._node_cq):
            if ci is not None:
                groups[ci] = groups.get(ci, 0) | (1 << i)
        self._cq_groups: List[Tuple[int, int]] = sorted(groups.items())

    # -- qset satisfaction ---------------------------------------------------
    def _dep_mask(self, qs: Optional[SCPQuorumSet]) -> int:
        m = 0
        if qs is None:
            return m
        for v in qs.validators:
            i = self.index.get(v.key_bytes)
            if i is not None:
                m |= 1 << i
        for inner in qs.innerSets:
            m |= self._dep_mask(inner)
        return m

    def _compile_qs(self, qs: SCPQuorumSet) -> int:
        key = id(qs)
        hit = self._compile_by_id.get(key)
        if hit is not None:
            return hit
        # keep the object alive: the id-keyed memo must never serve a
        # freed object's recycled id to a different qset
        self._compile_keepalive.append(qs)
        direct = 0
        for v in qs.validators:
            i = self.index.get(v.key_bytes)
            if i is not None:
                direct |= 1 << i
        children = tuple(self._compile_qs(inner) for inner in qs.innerSets)
        vkey = (qs.threshold, direct, children)
        idx = self._compile_by_val.get(vkey)
        if idx is None:
            idx = len(self._compiled)
            self._compiled.append(vkey)
            self._compile_by_val[vkey] = idx
        self._compile_by_id[key] = idx
        return idx

    def _sat(self, ci: int, mask: int) -> bool:
        ck = (ci, mask)
        cached = self._sat_cache.get(ck)
        if cached is not None:
            return cached
        thr, direct, children = self._compiled[ci]
        hits = (direct & mask).bit_count()
        if hits < thr:
            for ch in children:
                if self._sat(ch, mask):
                    hits += 1
                    if hits >= thr:
                        break
        r = hits >= thr
        if len(self._sat_cache) > 4_000_000:
            self._sat_cache.clear()
        self._sat_cache[ck] = r
        return r

    def _qset_satisfied(self, qs: SCPQuorumSet, mask: int) -> bool:
        return self._sat(self._compile_qs(qs), mask)

    def _node_satisfied(self, i: int, mask: int) -> bool:
        ci = self._node_cq[i]
        return ci is not None and self._sat(ci, mask)

    # -- quorum machinery (refinement 2) ------------------------------------
    def contract_to_maximal_quorum(self, mask: int) -> int:
        """Largest quorum within `mask`, or 0 (reference
        contractToMaximalQuorum). Each fixpoint pass walks the distinct
        compiled qsets, not the individual nodes."""
        while True:
            next_mask = 0
            for ci, gmask in self._cq_groups:
                gm = gmask & mask
                if gm and self._sat(ci, mask):
                    next_mask |= gm
            if next_mask == mask:
                return mask
            mask = next_mask
            if mask == 0:
                return 0

    def is_a_quorum(self, mask: int) -> bool:
        return mask != 0 and self.contract_to_maximal_quorum(mask) == mask

    def is_minimal_quorum(self, mask: int) -> bool:
        """A quorum none of whose one-smaller subsets contains a quorum
        (reference isMinimalQuorum)."""
        m = mask
        while m:
            low = m & -m
            if self.contract_to_maximal_quorum(mask & ~low) != 0:
                return False
            m ^= low
        return True

    # -- SCC analysis (the outer pruning) ------------------------------------
    def _sccs(self) -> List[int]:
        """Tarjan over the dependency graph; returns SCC masks."""
        idx = [0] * self.n
        low = [0] * self.n
        on = [False] * self.n
        comp: List[int] = []
        stack: List[int] = []
        counter = [1]

        def strongconnect(v0: int) -> None:
            # iterative tarjan (explicit stack) to survive big nets
            work = [(v0, 0)]
            while work:
                v, pi = work.pop()
                if pi == 0:
                    idx[v] = low[v] = counter[0]
                    counter[0] += 1
                    stack.append(v)
                    on[v] = True
                recurse = False
                deps = self._deps[v]
                m = deps >> pi
                shift = pi
                while m:
                    if m & 1:
                        w = shift
                        if idx[w] == 0:
                            work.append((v, shift + 1))
                            work.append((w, 0))
                            recurse = True
                            break
                        elif on[w]:
                            low[v] = min(low[v], idx[w])
                    m >>= 1
                    shift += 1
                if recurse:
                    continue
                if low[v] == idx[v]:
                    c = 0
                    while True:
                        w = stack.pop()
                        on[w] = False
                        c |= 1 << w
                        if w == v:
                            break
                    comp.append(c)
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[v])

        for v in range(self.n):
            if idx[v] == 0:
                strongconnect(v)
        return comp

    # -- the enumeration (refinements 3-7) -----------------------------------
    def network_enjoys_quorum_intersection(self) -> bool:
        if self.n == 0:
            return True
        sccs = self._sccs()
        # pick the SCC containing a quorum; a quorum in any OTHER SCC is an
        # immediate disjoint pair (SCCs don't intersect by construction)
        main_scc = 0
        for c in sorted(sccs, key=lambda c: -bin(c).count("1")):
            if self.contract_to_maximal_quorum(c) != 0:
                if main_scc:
                    self._record_split(
                        self.contract_to_maximal_quorum(main_scc),
                        self.contract_to_maximal_quorum(c))
                    return False
                main_scc = c
        if not main_scc:
            log.warning("no quorum found in any SCC")
            return True    # vacuously true: no quorums at all
        self._main = main_scc
        self._maxsz = bin(main_scc).count("1") // 2 + 1
        self.quorums_seen = 0
        return self._enumerate(0, main_scc)

    def _record_split(self, a: int, b: int) -> None:
        self.last_split = ([self.ids[i] for i in _bits(a)],
                           [self.ids[i] for i in _bits(b)])
        log.warning("found disjoint quorums: %s | %s",
                    [x.hex()[:8] for x in self.last_split[0]],
                    [x.hex()[:8] for x in self.last_split[1]])

    def _enumerate(self, committed: int, remaining: int) -> bool:
        """True iff no disjoint minq pair found in this branch (reference's
        recursive enumerate with early exits #1-3)."""
        if self.interrupted or \
                (self._parent is not None and self._parent.interrupted):
            raise InterruptedError("quorum intersection check interrupted")
        if bin(committed).count("1") > self._maxsz:
            return True
        if committed != 0 and self.is_a_quorum(committed):
            self.quorums_seen += 1
            if self.is_minimal_quorum(committed):
                comp = self.contract_to_maximal_quorum(
                    self._main & ~committed)
                if comp:
                    self._record_split(committed, comp)
                    return False
            return True   # supersets of a quorum are never minqs
        if remaining == 0:
            return True
        perimeter = committed | remaining
        maxq = self.contract_to_maximal_quorum(perimeter)
        if maxq == 0 or (committed & ~maxq) != 0:
            return True   # no quorum ahead extends committed
        i = self._pick_branch_node(remaining)
        bit = 1 << i
        return (self._enumerate(committed, remaining & ~bit) and
                self._enumerate(committed | bit, remaining & ~bit))

    def _pick_branch_node(self, remaining: int) -> int:
        """Max indegree within the remaining subgraph (refinement 7)."""
        best, best_deg = -1, -1
        for i in _bits(remaining):
            deg = 0
            for j in _bits(remaining):
                if (self._deps[j] >> i) & 1:
                    deg += 1
            if deg > best_deg:
                best, best_deg = i, deg
        return best


def _bits(mask: int):
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


class QuorumTracker:
    """Transitive quorum map rooted at the local node (reference
    QuorumTracker.h:21-51)."""

    def __init__(self, local_id: PublicKey,
                 local_qset_fn: Callable[[], SCPQuorumSet]) -> None:
        self._local_id = local_id
        self._local_qset_fn = local_qset_fn
        self._quorum: Dict[bytes, Optional[SCPQuorumSet]] = {}
        self.rebuild(lambda node_id: None)

    def is_node_definitely_in_quorum(self, node_id: PublicKey) -> bool:
        return node_id.key_bytes in self._quorum

    def _qset_nodes(self, qs: SCPQuorumSet) -> List[bytes]:
        out = [v.key_bytes for v in qs.validators]
        for inner in qs.innerSets:
            out.extend(self._qset_nodes(inner))
        return out

    def expand(self, node_id: PublicKey,
               qset: SCPQuorumSet) -> bool:
        """Add node's qset if node is already in the transitive quorum
        (reference expand); False means caller should rebuild."""
        key = node_id.key_bytes
        if key not in self._quorum:
            return False
        if self._quorum[key] is not None:
            return self._quorum[key].to_xdr() == qset.to_xdr()
        self._quorum[key] = qset
        for dep in self._qset_nodes(qset):
            self._quorum.setdefault(dep, None)
        return True

    def rebuild(self, lookup: Callable[[PublicKey],
                                       Optional[SCPQuorumSet]]) -> None:
        """Recompute the closure from the local qset via `lookup`
        (reference rebuild)."""
        self._quorum = {}
        frontier = [(self._local_id.key_bytes, self._local_qset_fn())]
        while frontier:
            key, qs = frontier.pop()
            if key in self._quorum and self._quorum[key] is not None:
                continue
            self._quorum[key] = qs
            if qs is None:
                continue
            for dep in self._qset_nodes(qs):
                if dep not in self._quorum:
                    self._quorum[dep] = None
                    got = lookup(PublicKey.ed25519(dep))
                    if got is not None:
                        frontier.append((dep, got))
        self.quorum_map_changed = True

    def get_quorum(self) -> Dict[bytes, Optional[SCPQuorumSet]]:
        return self._quorum


# -- intersection-critical group analysis ------------------------------------

def _points_to_any(qs: SCPQuorumSet, group: frozenset) -> bool:
    """Single traversal: does qs reference any member of `group`?"""
    for v in qs.validators:
        if v.key_bytes in group:
            return True
    return any(_points_to_any(i, group) for i in qs.innerSets)


def _criticality_candidates(qs: SCPQuorumSet, out: set, root: bool) -> None:
    """Reference findCriticalityCandidates: every validator as a
    singleton, plus every non-root LEAF innerSet as a group."""
    for v in qs.validators:
        out.add(frozenset((v.key_bytes,)))
    if not root and not qs.innerSets:
        out.add(frozenset(v.key_bytes for v in qs.validators))
    for i in qs.innerSets:
        _criticality_candidates(i, out, False)


def intersection_critical_groups(
        qmap: Dict[bytes, Optional[SCPQuorumSet]],
        parent: QuorumIntersectionChecker = None) -> List[set]:
    """Find "intersection-critical" node groups (reference
    QuorumIntersectionChecker::getIntersectionCriticalGroups): for each
    candidate group (leaf innerSets + singletons), install a "fickle"
    qset — threshold 2 over {the group itself, anyone pointing at the
    group} so the group goes along with anyone — and re-check
    intersection. Groups whose fickleness splits the network are the
    operators to watch."""
    candidates: set = set()
    for qs in qmap.values():
        if qs is not None:
            _criticality_candidates(qs, candidates, True)
    log.info("examining %d node groups for intersection-criticality",
             len(candidates))
    critical: List[set] = []
    # frozenset ordering is subset partial order — sort by element lists
    # for deterministic output across runs
    for group in sorted(candidates, key=sorted):
        group_qset = SCPQuorumSet(
            threshold=len(group),
            validators=[PublicKey.ed25519(k) for k in sorted(group)],
            innerSets=[])
        points_to = sorted(
            node for node, qs in qmap.items()
            if node not in group and qs is not None and
            _points_to_any(qs, group))
        fickle = SCPQuorumSet(
            threshold=2,
            validators=[],
            innerSets=[group_qset,
                       SCPQuorumSet(threshold=1,
                                    validators=[PublicKey.ed25519(k)
                                                for k in points_to],
                                    innerSets=[])])
        test_qmap = dict(qmap)
        for k in group:
            test_qmap[k] = fickle
        checker = QuorumIntersectionChecker(test_qmap, parent=parent)
        if not checker.network_enjoys_quorum_intersection():
            critical.append(set(group))
    return critical


def intersection_critical_groups_strkey(
        qmap: Dict[bytes, Optional[SCPQuorumSet]],
        parent: QuorumIntersectionChecker = None) -> List[List[str]]:
    """Criticality report in operator form (strkey lists) — shared by the
    HTTP checkquorum endpoint and the check-quorum CLI."""
    from ..crypto.strkey import encode_public_key
    return [sorted(encode_public_key(k) for k in group)
            for group in intersection_critical_groups(qmap, parent=parent)]
