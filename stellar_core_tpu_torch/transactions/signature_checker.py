"""SignatureChecker: multisig weight/threshold accounting over a tx's
signatures.

Copied from `stellar_core_tpu/transactions/signature_checker.py` at commit
183ecd9; carry a fix in either copy to the other. Two deliberate
differences: the checker uses the verifier it is given and raises
TypeError without one (the reference falls back to a CpuSigVerifier, which
would verify on the host unseen where the card was meant to); and a
verifier whose flush raises (a failed drain on the card) surfaces as
`SignatureVerifyError`, which the transaction frames let through instead
of turning it into a txINTERNAL_ERROR result, so a failed drain fails
the close.

The fuzzing hook (`set_fuzzing_mode`, reference `:32-37`) is kept: while
it is on, every check passes with no verify at all, so a node that
closed ledgers under it would never reach the card. Only `main/fuzz.py`
sets it, and clears it in a `finally` around every run.

Role parity: reference `src/transactions/SignatureChecker.{h,cpp}:18-120`:
weight accumulation over ed25519 / pre-auth-tx / hash-x signers, hint
pre-filter, "all signatures used" discipline; and
`src/transactions/SignatureUtils.cpp:27-36` (hint filter + verifySig).

Semantics matched to the reference:
- one call consumes each SIGNER at most once, but a SIGNATURE may satisfy
  multiple calls (multiple ops of one tx share signatures); the "used"
  mark only feeds check_all_signatures_used (txBAD_AUTH_EXTRA).
- success as soon as accumulated weight >= needed_weight (weights capped
  at 255); needed_weight 0 still requires one valid signer.

The verify call goes through the injected BatchSigVerifier: all
hint-matching (signature, signer) pairs are enqueued and flushed in ONE
batch before accumulation — with the card's verifier this is one launch
per check (none when the set's prewarm filled the cache).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from ..crypto.batch_verifier import BatchSigVerifier
from ..xdr import (
    DecoratedSignature, PublicKey, Signer, SignerKey, SignerKeyType,
)


_FUZZING_MODE = False  # reference SignatureChecker.cpp:33-35 parity hook


def set_fuzzing_mode(on: bool) -> None:
    global _FUZZING_MODE
    _FUZZING_MODE = on


def _hint_of(b32: bytes) -> bytes:
    return b32[-4:]


class SignatureVerifyError(RuntimeError):
    """The verifier failed to decide a batch (its flush raised): not a
    signature that failed to verify, but a verifier that failed."""


class SignatureChecker:
    def __init__(self, network_hash_contents: bytes,
                 signatures: Sequence[DecoratedSignature],
                 verifier: Optional[BatchSigVerifier] = None) -> None:
        if verifier is None:
            raise TypeError("SignatureChecker needs a verifier (make_verifier"
                            "(...) or CpuSigVerifier() for the host)")
        self._contents_hash = network_hash_contents
        self._sigs = list(signatures)
        self._used = [False] * len(self._sigs)
        self._verifier = verifier
        # hint → signature indices: each check then probes one bucket per
        # signer instead of scanning the sigs × signers cross-product (a
        # 20-sig 20-signer multisig tx is 400 hint compares per check)
        self._by_hint: Dict[bytes, List[int]] = {}
        for i, ds in enumerate(self._sigs):
            self._by_hint.setdefault(ds.hint, []).append(i)

    def check_signature(self, signers: List[Signer],
                        needed_weight: int) -> bool:
        if _FUZZING_MODE:
            return True
        total = 0

        # pre-auth-tx signers match the contents hash directly
        for signer in signers:
            if signer.key.disc == \
                    SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX and \
                    signer.key.value == self._contents_hash:
                total += min(signer.weight, 255)
                if total >= needed_weight:
                    return True

        def verify_all(remaining: List[Signer], verify_fn) -> bool:
            nonlocal total
            for i, ds in enumerate(self._sigs):
                for j, signer in enumerate(remaining):
                    if verify_fn(i, ds, signer):
                        self._used[i] = True
                        total += min(signer.weight, 255)
                        if total >= needed_weight:
                            return True
                        remaining.pop(j)
                        break
            return False

        # hash-x: sha256(signature) equals the signer key
        hashx = [s for s in signers
                 if s.key.disc == SignerKeyType.SIGNER_KEY_TYPE_HASH_X]
        if verify_all(hashx, lambda i, ds, s:
                      hashlib.sha256(ds.signature).digest() == s.key.value):
            return True

        # ed25519: enqueue all hint-matching pairs, flush once, then
        # accumulate from the completed futures
        eds = [s for s in signers
               if s.key.disc == SignerKeyType.SIGNER_KEY_TYPE_ED25519]
        futs: Dict[Tuple[int, bytes], object] = {}
        for signer in eds:
            kb = signer.key.value
            for i in self._by_hint.get(_hint_of(kb), ()):
                futs[(i, kb)] = self._verifier.enqueue(
                    PublicKey.ed25519(kb), self._sigs[i].signature,
                    self._contents_hash)
        if futs:
            try:
                self._verifier.flush()
            except Exception as e:
                raise SignatureVerifyError(
                    "signature verifier failed: %r" % (e,)) from e

        def ed_ok(i: int, ds: DecoratedSignature, signer: Signer) -> bool:
            fut = futs.get((i, signer.key.value))
            return fut is not None and fut.result()

        return verify_all(eds, ed_ok)

    def check_all_signatures_used(self) -> bool:
        """Reference: any unused signature makes the tx invalid
        (txBAD_AUTH_EXTRA)."""
        if _FUZZING_MODE:
            return True
        return all(self._used)
