"""BatchSigVerifier: the batch boundary every signature check goes through.

Port of the core of `stellar_core_tpu/crypto/batch_verifier.py`:

    enqueue(key32, sig, msg) -> VerifyFuture   (accumulate)
    flush()                                    (dispatch one device batch)
    verify_many(triples) -> [bool]             (whole-ledger/checkpoint drain)
    prewarm_many(triples) -> [bool]            (drain that seeds the cache)

Backends:
- CpuSigVerifier — synchronous CPU verify (crypto/keys.py).
- CudaSigVerifier — the counterpart of the reference's TpuSigVerifier:
  pads each drain to a bucket of a fixed ladder, splits oversize drains,
  and runs each bucket as one launch of the CUDA verify kernel
  (ops/ed25519.verify_kernel). Correctness contract: identical
  accept/reject decisions to CpuSigVerifier (RFC 8032 cofactorless).

Unlike the reference, nothing here falls back to the CPU: a dispatch that
raises propagates to the caller (a flush puts its batch back in the queue
first, so no future is lost).

The global verify-result cache (crypto/keys.py) sits in front of every
backend; cache hits never enqueue.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..ops import ed25519 as _e
from ..parallel.mesh import pad_batch_to
from . import keys as _keys

Triple = Tuple[bytes, bytes, bytes]  # (key32, sig, msg)


class VerifyFuture:
    """Completion handle for one enqueued verify."""

    __slots__ = ("_done", "_result", "_callbacks")

    def __init__(self) -> None:
        self._done = False
        self._result = False
        self._callbacks: List[Callable[[bool], None]] = []

    def done(self) -> bool:
        return self._done

    def result(self) -> bool:
        if not self._done:
            raise RuntimeError("verify future not completed; call flush()")
        return self._result

    def add_done_callback(self, cb: Callable[[bool], None]) -> None:
        if self._done:
            cb(self._result)
        else:
            self._callbacks.append(cb)

    def _complete(self, ok: bool) -> None:
        self._done = True
        self._result = ok
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(ok)


class BatchSigVerifier:
    """Abstract backend; see module docstring."""

    name = "abstract"

    def enqueue(self, key32: bytes, sig: bytes, msg: bytes) -> VerifyFuture:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def verify_many(self, triples: Sequence[Triple]) -> List[bool]:
        raise NotImplementedError

    def prewarm_many(self, triples: Sequence[Triple]) -> List[bool]:
        """Whole-ledger/checkpoint drain: verify a large batch in one
        dispatch and seed the result cache so later per-signature checks
        all hit. Already-cached triples are not re-dispatched."""
        cks = [_keys._cache_key(k, s, m) for (k, s, m) in triples]
        out: List[Optional[bool]] = [None] * len(triples)
        todo: List[Tuple[int, Triple, bytes]] = []  # (idx, triple, key)
        with _keys._cache_lock:
            for i, (t, ck) in enumerate(zip(triples, cks)):
                hit = _keys._verify_cache.maybe_get(ck)
                if hit is not None:
                    out[i] = hit
                else:
                    todo.append((i, t, ck))
        if todo:
            results = self.verify_many([t for (_i, t, _ck) in todo])
            with _keys._cache_lock:
                for ((i, _t, ck), ok) in zip(todo, results):
                    _keys._verify_cache.put(ck, ok)
                    out[i] = ok
        return out  # type: ignore[return-value]

    def pending(self) -> int:
        return 0

    # -- pending-queue machinery (batch backends) ---------------------------
    # cache-probe on enqueue, self-flush at _max_pending, one verify_many
    # per flush, futures completed and the cache fed from the results

    _pending: List[Tuple[Triple, VerifyFuture]]
    _max_pending: int

    def _batch_enqueue(self, key32: bytes, sig: bytes,
                       msg: bytes) -> VerifyFuture:
        ck = _keys._cache_key(key32, sig, msg)
        with _keys._cache_lock:
            hit = _keys._verify_cache.maybe_get(ck)
        f = VerifyFuture()
        if hit is not None:
            f._complete(hit)
            return f
        self._pending.append(((key32, sig, msg), f))
        if len(self._pending) >= self._max_pending:
            self.flush()
        return f

    def _batch_flush(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        try:
            results = self.verify_many([t for (t, _f) in batch])
        except BaseException:
            self._pending = batch + self._pending
            raise
        for ((k, s, m), f), ok in zip(batch, results):
            with _keys._cache_lock:
                _keys._verify_cache.put(_keys._cache_key(k, s, m), ok)
            f._complete(ok)


class CpuSigVerifier(BatchSigVerifier):
    """Synchronous CPU backend."""

    name = "cpu"

    def enqueue(self, key32: bytes, sig: bytes, msg: bytes) -> VerifyFuture:
        f = VerifyFuture()
        f._complete(_keys.verify_sig(key32, sig, msg))
        return f

    def flush(self) -> None:
        pass

    def verify_many(self, triples: Sequence[Triple]) -> List[bool]:
        return _keys.raw_verify_batch(triples)


class CudaSigVerifier(BatchSigVerifier):
    """Batched backend on the CUDA verify kernel.

    Batches are padded up to fixed bucket sizes (padding lanes are
    masked by the host prechecks) and oversize batches are split into
    chunks of the largest bucket; each chunk is one kernel launch. Runs
    on `device` (default: the current CUDA device). Without CUDA the
    constructor raises, unless the caller asks for `device="cpu"`, where
    the wrapper runs the kernel's plain version."""

    name = "cuda"
    BUCKETS = (128, 512, 2048, 8192)

    def __init__(self, max_pending: int = 8192, device=None) -> None:
        if device is None:
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CudaSigVerifier needs a CUDA device; none is available "
                "(pass device='cpu' to run the kernel's plain version)")
        self._pending: List[Tuple[Triple, VerifyFuture]] = []
        self._max_pending = max_pending
        self.batches_dispatched = 0
        self.sigs_verified = 0

    def enqueue(self, key32: bytes, sig: bytes, msg: bytes) -> VerifyFuture:
        return self._batch_enqueue(key32, sig, msg)

    def pending(self) -> int:
        return len(self._pending)

    def flush(self) -> None:
        self._batch_flush()

    def _bucket(self, n: int) -> int:
        for b in self.BUCKETS:
            if n <= b:
                return b
        return self.BUCKETS[-1]

    def verify_many(self, triples: Sequence[Triple]) -> List[bool]:
        out: List[bool] = []
        step = self.BUCKETS[-1]
        for i in range(0, len(triples), step):
            chunk = triples[i:i + step]
            n = len(chunk)
            prep = _e.prepare_batch([t[0] for t in chunk],
                                    [t[1] for t in chunk],
                                    [t[2] for t in chunk])
            padded = pad_batch_to(prep, self._bucket(n))
            ok = _e.verify_kernel(*(torch.from_numpy(padded[k]).to(
                self.device) for k in _e.ARG_KEYS)).cpu().numpy()
            out.extend((ok[:n] & prep["pre_ok"]).tolist())
            self.batches_dispatched += 1
            self.sigs_verified += n
        return out


def make_verifier(backend: str = "cuda", max_pending: int = 8192,
                  device=None) -> BatchSigVerifier:
    """Backend selection by name: "cuda" (the default; it raises without
    a card unless `device="cpu"` is given) or "cpu" (the C verifier)."""
    if backend == "cpu":
        return CpuSigVerifier()
    if backend == "cuda":
        return CudaSigVerifier(max_pending=max_pending, device=device)
    raise ValueError("unknown sig verify backend %r" % backend)
