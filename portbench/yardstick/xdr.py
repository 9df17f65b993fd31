"""The XDR the benchmark writes, encoded by hand from Stellar's `.x` files.

Independent of the port's codec: the benchmark makes its inputs as bytes
here, the port decodes them, and the reference reads these same bytes.
Only the shapes the traffic uses are written (protocol 13): ed25519
accounts and signers, V1 transaction envelopes with one payment, the
history files' entries, and SCP statements and envelopes.
"""

from __future__ import annotations

import hashlib
import struct

ENVELOPE_TYPE_SCP = 1
ENVELOPE_TYPE_TX = 2

SCP_ST_PREPARE = 0
SCP_ST_CONFIRM = 1
SCP_ST_EXTERNALIZE = 2
SCP_ST_NOMINATE = 3


def sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def u32(v: int) -> bytes:
    return struct.pack(">I", v)


def i64(v: int) -> bytes:
    return struct.pack(">q", v)


def u64(v: int) -> bytes:
    return struct.pack(">Q", v)


def var_opaque(b: bytes) -> bytes:
    return u32(len(b)) + b + b"\x00" * (-len(b) % 4)


def var_array(items) -> bytes:
    items = list(items)
    return u32(len(items)) + b"".join(items)


def optional(b) -> bytes:
    return u32(0) if b is None else u32(1) + b


def public_key(key32: bytes) -> bytes:
    """PublicKey / AccountID / NodeID: PUBLIC_KEY_TYPE_ED25519."""
    return u32(0) + key32


def muxed_account(key32: bytes) -> bytes:
    return u32(0) + key32          # KEY_TYPE_ED25519


# --- ledger entries --------------------------------------------------------

def account_entry(key32: bytes, balance: int, seq_num: int,
                  thresholds: bytes, signers, last_modified: int) -> bytes:
    """LedgerEntry holding an AccountEntry; `signers` are (key32, weight)
    ed25519 signers, in the ascending key order the ledger keeps."""
    signer_xdr = [u32(0) + k + u32(w) for (k, w) in sorted(signers)]
    acc = (public_key(key32) + i64(balance) + i64(seq_num)
           + u32(len(signer_xdr))             # numSubEntries
           + optional(None)                   # inflationDest
           + u32(0)                           # flags
           + var_opaque(b"")                  # homeDomain
           + thresholds
           + var_array(signer_xdr)
           + u32(0))                          # ext v0
    return u32(last_modified) + u32(0) + acc + u32(0)


# --- transactions ------------------------------------------------------------

def payment_tx(source: bytes, fee: int, seq_num: int, dest: bytes,
               amount: int, max_time: int) -> bytes:
    """Transaction: one native payment, time bounds [0, max_time], no
    memo."""
    op = (optional(None) + u32(1)             # PAYMENT
          + muxed_account(dest) + u32(0)      # native asset
          + i64(amount))
    return (muxed_account(source) + u32(fee) + i64(seq_num)
            + optional(u64(0) + u64(max_time))
            + u32(0)                          # MEMO_NONE
            + var_array([op])
            + u32(0))


def tx_contents_hash(network_id: bytes, tx_xdr: bytes) -> bytes:
    """What a transaction's signers sign: SHA-256 of the network id, the
    envelope type and the transaction."""
    return sha256(network_id + u32(ENVELOPE_TYPE_TX) + tx_xdr)


def decorated_signature(hint: bytes, sig: bytes) -> bytes:
    return hint + var_opaque(sig)


def tx_envelope(tx_xdr: bytes, signatures) -> bytes:
    """TransactionEnvelope, ENVELOPE_TYPE_TX; `signatures` are (hint, sig)."""
    return (u32(ENVELOPE_TYPE_TX) + tx_xdr
            + var_array(decorated_signature(h, s) for (h, s) in signatures))


# --- history files -------------------------------------------------------------

def transaction_history_entry(ledger_seq: int, prev_hash: bytes,
                              envelopes) -> bytes:
    return u32(ledger_seq) + prev_hash + var_array(envelopes) + u32(0)


def stellar_value(tx_set_hash: bytes, close_time: int) -> bytes:
    return tx_set_hash + u64(close_time) + var_array([]) + u32(0)


def ledger_header(seq: int, prev_hash: bytes, tx_set_hash: bytes,
                  close_time: int, result_hash: bytes, bucket_hash: bytes,
                  total_coins: int, fee_pool: int, max_tx_set_size: int,
                  version: int = 13, base_fee: int = 100,
                  base_reserve: int = 5_000_000) -> bytes:
    return (u32(version) + prev_hash
            + stellar_value(tx_set_hash, close_time)
            + result_hash + bucket_hash + u32(seq)
            + i64(total_coins) + i64(fee_pool)
            + u32(0) + u64(0)                 # inflationSeq, idPool
            + u32(base_fee) + u32(base_reserve) + u32(max_tx_set_size)
            + b"\x00" * 128                   # skipList
            + u32(0))


def ledger_header_history_entry(header_xdr: bytes) -> bytes:
    return sha256(header_xdr) + header_xdr + u32(0)


def record(body: bytes) -> bytes:
    """One record of an XDR stream file: RFC 5531 record marking, a single
    last fragment."""
    return u32(0x80000000 | len(body)) + body


# --- SCP -------------------------------------------------------------------

def ballot(counter: int, value: bytes) -> bytes:
    return u32(counter) + var_opaque(value)


def quorum_set(threshold: int, validators, inner_sets=()) -> bytes:
    return (u32(threshold) + var_array(public_key(v) for v in validators)
            + var_array(inner_sets))


def nominate(qset_hash: bytes, votes, accepted) -> bytes:
    return (u32(SCP_ST_NOMINATE) + qset_hash
            + var_array(var_opaque(v) for v in votes)
            + var_array(var_opaque(v) for v in accepted))


def prepare(qset_hash: bytes, b: bytes, prepared=None, n_c: int = 0,
            n_h: int = 0) -> bytes:
    return (u32(SCP_ST_PREPARE) + qset_hash + b + optional(prepared)
            + optional(None) + u32(n_c) + u32(n_h))


def confirm(qset_hash: bytes, b: bytes, n_prepared: int, n_commit: int,
            n_h: int) -> bytes:
    return (u32(SCP_ST_CONFIRM) + b + u32(n_prepared) + u32(n_commit)
            + u32(n_h) + qset_hash)


def externalize(qset_hash: bytes, commit: bytes, n_h: int) -> bytes:
    return u32(SCP_ST_EXTERNALIZE) + commit + u32(n_h) + qset_hash


def scp_statement(node: bytes, slot: int, pledges: bytes) -> bytes:
    return public_key(node) + u64(slot) + pledges


def scp_sign_bytes(network_id: bytes, statement_xdr: bytes) -> bytes:
    """What an SCP envelope's signature covers: SHA-256 of the network id,
    ENVELOPE_TYPE_SCP and the statement."""
    return sha256(network_id + u32(ENVELOPE_TYPE_SCP) + statement_xdr)


def scp_envelope(statement_xdr: bytes, sig: bytes) -> bytes:
    return statement_xdr + var_opaque(sig)
