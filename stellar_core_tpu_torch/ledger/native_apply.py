"""Close-time glue for the apply engine (`native/applyc.c`).

Copied from `stellar_core_tpu/ledger/native_apply.py` at commit 89bbd6f;
carry a fix in either copy to the other. Per-op attribution
(`record_native_op_table`), bail classification (`record_bail`), the
cluster telemetry (`record_clusters`) and the cluster degrade land in the
manager's `apply_stats` (`ledger/apply_stats.py`, the close cockpit).
Deliberately different: a close with no verifier
raises TypeError (the reference builds a CpuSigVerifier); a verifier that
raises inside the engine's verify callback fails the close with
SignatureVerifyError, as a failed drain fails the Python phases'
SignatureChecker (the reference's close raises the verifier's own
exception), and no Python apply runs in its place; a host without a C
compiler runs the Python phases (the engine is None), but a failed build
raises (native.apply_engine).

The engine runs the fee and apply phases of a ledger close for every wire
op type, plain v1 AND fee-bump envelopes, and muxed account references
(protocol >= 10). This module decides per close whether the engine may
run, feeds it (entry lookups, one batched signature verify per close,
order-book scans), chooses the execution mode (conflict-graph parallel
clusters vs serial), and installs its outputs so everything downstream of
the apply loop — result hash, bucket-list delta, tx/fee history rows —
runs unchanged Python over identical state.

The engine verifies through ONE call of `verifier.prewarm_many` per close
(`preverify_all`): every candidate (signer key, signature, contents hash)
pair of the set — the hint-matched signers of the live signer sets plus
the statically known additions (set-options signers, created accounts'
master keys). On the card's verifier that call is one drain: a cold close
launches the verify kernel once per 8,192 pairs the cache does not hold.

The engine returns {"bail": reason} for ANY input outside its subset
before mutating shared state, and the caller then runs the Python phases,
which stay the semantics (tests/test_torch_native_apply.py holds the two
equal). Residual bail reasons: non-ed25519 signer keys
(`signer-key-type`), >20-signer shapes (`multisig-shape`), wire thresholds
over 255 (`threshold-range`), due inflation payouts pre-protocol-12
(`inflation-payout`), op shapes whose Python apply raises (`op-shape`),
and op-level auth failures whose Python result mix is unserializable
(`op-auth`). A bail is part of the semantics, not a device fallback.

Parallel close: the engine partitions the txset into clusters by
statically-touched entries and applies disjoint clusters on worker
threads with the interpreter lock released. `apply.cluster-fail`
(util.faults) degrades a would-be-parallel close to serial — the same
close, one thread. Config NATIVE_PARALLEL_WORKERS sizes the worker pool,
1 for the serial engine (the reference's NATIVE_PARALLEL_APPLY and
SCT_PARALLEL_APPLY switches, which repeat NATIVE_PARALLEL_WORKERS = 1,
are left out).
"""

from __future__ import annotations

import os
from typing import List, Optional

from .apply_stats import op_type_name


def _classify_engine_bail(reason: str) -> str:
    """Engine reason string -> metric-safe reason. `op-<n>` carries the
    numeric wire type; name it (`op-manage-sell-offer`) so operators
    read traffic, not enum values."""
    if reason.startswith("op-") and reason[3:].isdigit():
        return "op-" + op_type_name(int(reason[3:]))
    return reason


def _bail(stats, reason: str) -> bool:
    """Record one classified ineligibility/bailout; returns False so
    call sites read `return _bail(stats, "...")`."""
    if stats is not None:
        stats.record_bail(reason)
    return False


def parallel_workers(lm) -> int:
    """Effective worker count for the conflict-graph parallel close:
    Config NATIVE_PARALLEL_WORKERS when set (> 0), else cpu_count
    capped at 16. 1 disables parallelism."""
    cfg = getattr(getattr(lm, "app", None), "config", None)
    n = int(getattr(cfg, "NATIVE_PARALLEL_WORKERS", 0) or 0)
    if n > 0:
        return n
    return min(16, os.cpu_count() or 1)


def native_apply_txset(lm, ltx, frames, base_fee: Optional[int],
                       verifier, force_mode: Optional[str] = None) -> bool:
    """Run the whole txset's fee+apply phases in the engine. Returns False
    on any ineligibility/bailout with NO state mutated (the caller then
    runs the Python phases); True means ltx, the header fee pool + id
    pool, and every frame's result/meta are populated exactly as the
    Python path would have. An exception raised by the verifier inside
    the engine propagates as SignatureVerifyError, with nothing applied.

    `force_mode` ("serial"/"parallel") pins the execution mode — the
    differential tests' forced-parallel-vs-serial equality leg."""
    if verifier is None:
        raise TypeError("native_apply_txset needs a verifier "
                        "(make_verifier(...), or CpuSigVerifier() for the "
                        "host)")
    stats = getattr(lm, "apply_stats", None)
    if not getattr(lm, "use_native_apply", True):
        return _bail(stats, "disabled")
    from ..native import apply_engine
    eng = apply_engine()
    if eng is None:
        return _bail(stats, "no-engine")
    from ..transactions.signature_checker import SignatureVerifyError
    from ..transactions.transaction_frame import (
        FeeBumpTransactionFrame, TransactionFrame,
    )
    if ltx._changes:
        return _bail(stats, "open-changes")
    header = ltx.load_header()
    if header.ledgerVersion < 10:
        return _bail(stats, "protocol-pre10")
    for f in frames:
        if type(f) is not TransactionFrame and \
                type(f) is not FeeBumpTransactionFrame:
            return _bail(stats, "frame-type")
    root = lm.root
    get_blob = getattr(root, "get_entry_blob", None)
    book = getattr(root, "offers_for_book_blobs", None)
    acct_offers = getattr(root, "offers_by_account_blobs", None)
    if get_blob is None or book is None or acct_offers is None:
        return _bail(stats, "no-blob-lookup")
    params = {
        "ledgerVersion": header.ledgerVersion,
        "ledgerSeq": header.ledgerSeq,
        "closeTime": header.scpValue.closeTime,
        "baseFee": header.baseFee,
        "baseReserve": header.baseReserve,
        "effBaseFee": base_fee if base_fee is not None else header.baseFee,
        "feePool": header.feePool,
        "idPool": header.idPool,
        "inflationSeq": header.inflationSeq,
    }
    envs: List[bytes] = [f.envelope_bytes() for f in frames]
    # fee bumps carry outer||inner contents hashes (the engine verifies
    # outer signatures over the outer hash, inner over the inner)
    hashes: List[bytes] = [
        f.contents_hash() + f.inner.contents_hash()
        if hasattr(f, "inner") else f.contents_hash()
        for f in frames]
    # tests pin the schedule (forced-parallel vs serial equality leg)
    # either per call or per manager
    mode = force_mode or getattr(lm, "native_force_mode", None) or "auto"
    workers = parallel_workers(lm)
    if mode == "parallel" and workers < 2:
        workers = 2
    if mode == "auto" and workers > 1:
        # fault site: a parallel close degrades to the same close on one
        # thread — never to the Python path
        from ..util.faults import check_faults
        if check_faults(getattr(lm, "app", None), "apply.cluster-fail"):
            mode = "serial"
            if stats is not None:
                stats.record_cluster_degrade()
    opts = {"workers": workers, "mode": mode}

    def verify(triples):
        try:
            return verifier.prewarm_many(triples)
        except Exception as e:
            raise SignatureVerifyError(
                "signature verifier failed: %r" % (e,)) from e

    out = eng.apply_close(params, envs, hashes, get_blob, verify, book,
                          acct_offers, opts)
    if out is None:
        return _bail(stats, "engine-ineligible")
    if "bail" in out:
        return _bail(stats, _classify_engine_bail(out["bail"]))
    header.feePool = out["feePool"]
    header.idPool = out["idPool"]
    ltx.inject_native_changes(out["changes"])
    for f, rb, fcb, mb in zip(frames, out["results"], out["fee_changes"],
                              out["meta"]):
        f.set_native_apply_output(rb, fcb, mb)
    if stats is not None:
        if out.get("op_stats"):
            stats.record_native_op_table(out["op_stats"])
        cl = out.get("clusters")
        if cl:
            stats.record_clusters(cl["count"], cl["max_txs"],
                                  cl["workers"], bool(cl["parallel"]),
                                  apply_ns=cl.get("apply_ns", 0))
    return True
