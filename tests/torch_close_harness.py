"""The ledger-close workload the port's close tests share: the port's
side of a LedgerManager pair, the transactions of 18 closes (the bench's
senders and roles, multisig and 2-signature payments, every operation
type of `bench.py`'s `_StandardMix`, corrupted signatures, one upgrade),
and what a close must agree on. It imports only the port, so the
`cuda`-marked tests can use it where the JAX package is absent.
"""

import hashlib
from types import SimpleNamespace

import stellar_core_tpu_torch.xdr as PX
from stellar_core_tpu_torch import testing as T
from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.database.database import Database
from stellar_core_tpu_torch.herder.txset import TxSetFrame
from stellar_core_tpu_torch.herder.upgrades import (
    UpgradeParameters, Upgrades,
)
from stellar_core_tpu_torch.ledger import ledger_manager as PLM
from stellar_core_tpu_torch.ledger import state_commitment as PSC
from stellar_core_tpu_torch.transactions.transaction_frame import (
    FeeBumpTransactionFrame, TransactionFrame,
)

NET = T.TESTING_NETWORK_ID
NODE_SEED = hashlib.sha256(b"ledger-close node seed").digest()
MULTISIG, TWO_SIG, ROLES = 4, 2, 20
CORRUPT_EVERY = 3          # every 3rd multisig payment carries a bad sig
# the port's modules a close goes through, as close_one takes them
PORT = SimpleNamespace(X=PX, TransactionFrame=TransactionFrame,
                       TxSetFrame=TxSetFrame,
                       LedgerCloseData=PLM.LedgerCloseData)


def config(pkg_secret_key, database: str):
    return SimpleNamespace(
        DATABASE=database, LEDGER_PROTOCOL_VERSION=13,
        GENESIS_TOTAL_COINS=T.GENESIS_TOTAL_COINS,
        TESTING_UPGRADE_DESIRED_FEE=100, TESTING_UPGRADE_RESERVE=5_000_000,
        TESTING_UPGRADE_MAX_TX_SET_SIZE=10_000, network_id=NET,
        NODE_SEED=pkg_secret_key(NODE_SEED), STATE_CHECKPOINT_INTERVAL=4,
        BUCKETDB_READS=True, BUCKETDB_BLOOM_BITS_PER_KEY=10,
        INVARIANT_CHECKS=[], METADATA_OUTPUT_STREAM="")


def make_port_side(bucket_dir: str, database: str, verifier=None,
                   hasher=None):
    """The port's LedgerManager app: `sig_verifier`, `batch_hasher`,
    `state_commitment`, `database`, and the ledger layer of
    `torch_catchup_harness.wire_node` (the bucket manager, merges on the
    closing thread, whose BucketDB a SQL root reads through; the
    invariant manager and close-meta stream of the config, none), started
    at genesis."""
    from torch_catchup_harness import wire_node
    cfg = config(SecretKey, database)
    app = SimpleNamespace(
        config=cfg, network_root_key=T.root_secret_key,
        sig_verifier=verifier or CpuSigVerifier(),
        batch_hasher=hasher or make_hasher("cpu"),
        database=None if database == "in-memory" else Database(),
        metrics=None, tracer=None, flight_recorder=None)
    app.state_commitment = PSC.StateCommitmentEngine(app)
    lm = app.ledger_manager = PLM.LedgerManager(app)
    wire_node(app, bucket_dir, background_merges=False)
    lm.start_new_ledger()
    return lm


class Shim:
    """TestAccount's ledger surface over the port's LedgerManager: the
    header and sequence numbers that transactions are built against."""

    network_id = NET

    def __init__(self, lm):
        self.lm = lm

    def header(self):
        return self.lm.root.get_header()

    def seq_num(self, account_id):
        e = self.lm.root.get_entry(PX.LedgerKey.account(account_id))
        return e.data.value.seqNum if e is not None else 0

    def balance(self, account_id):
        return self.lm.root.get_entry(
            PX.LedgerKey.account(account_id)).data.value.balance


def close_one(lm, pkg, blobs: list, upgrades=()):
    """trim_invalid, then value_externalized, on one side whose modules
    `pkg` names (X, TransactionFrame, TxSetFrame, LedgerCloseData);
    returns the removed contents hashes and the applied frames in apply
    order."""
    X = pkg.X
    frames = [pkg.TransactionFrame.make_from_wire(
        NET, X.TransactionEnvelope.from_xdr(b)) for b in blobs]
    ts = pkg.TxSetFrame(NET, lm.lcl_hash, frames)
    removed = ts.trim_invalid(lm.ltx_root(), lm.app.sig_verifier)
    header = lm.root.get_header()
    value = X.StellarValue(txSetHash=ts.get_contents_hash(),
                           closeTime=header.scpValue.closeTime + 5,
                           upgrades=list(upgrades),
                           ext=X.StellarValueExt(0, None))
    lm.value_externalized(pkg.LedgerCloseData(header.ledgerSeq + 1, ts,
                                              value))
    assert lm.last_closed_ledger_num() == header.ledgerSeq + 1
    return (sorted(f.contents_hash() for f in removed),
            ts.sort_for_apply())


def observe(lm, frames) -> dict:
    """Everything a close must agree on, as bytes."""
    return {
        "lcl_hash": lm.lcl_hash,
        "entries": sorted(e.to_xdr() for e in lm.root.all_entries()),
        "results": [f.result_pair_xdr() for f in frames],
        "fee_meta": [f.fee_meta_xdr() for f in frames],
        "tx_meta": [f.tx_meta_xdr() for f in frames],
        "bucket_list": lm.app.bucket_manager.get_hash(),
        "commitment": lm.app.state_commitment.root,
    }


class Workload:
    """The closes' transactions, built and signed with the port's
    TestAccount against the port side's state."""

    def __init__(self, lm):
        self.shim = Shim(lm)
        self.root = T.TestAccount(self.shim, T.root_secret_key())

        def acct(tag, i):
            return T.TestAccount(self.shim, SecretKey.from_seed(
                hashlib.sha256(b"%s-%d" % (tag, i)).digest()))

        self.multisig = [acct(b"multisig", i) for i in range(MULTISIG)]
        self.two_sig = [acct(b"two-sig", i) for i in range(TWO_SIG)]
        self.roles = [acct(b"role", i) for i in range(ROLES)]
        self.extra = {}
        self.corrupted = set()
        self.merge_n = 0
        self.n = 0

    def fund(self):
        accs = self.multisig + self.two_sig + self.roles
        return [self.root.tx([self.root.op_create_account(a.account_id,
                                                          10 ** 10)
                              for a in accs])]

    def arm(self):
        out = []
        for i, s in enumerate(self.multisig + self.two_sig):
            n = 19 if i < MULTISIG else 1
            ks = [SecretKey.from_seed(hashlib.sha256(
                b"signer-%d-%d" % (i, j)).digest()) for j in range(n)]
            self.extra[s.account_id.key_bytes] = ks
            out.append(s.tx([s.op_add_signer(k.public_key.key_bytes)
                             for k in ks] + [s.op_set_options(med=n + 1)]))
        issuer = self.roles[0]
        out.append(issuer.tx([issuer.op_set_options(
            set_flags=PX.AccountFlags.AUTH_REQUIRED_FLAG |
            PX.AccountFlags.AUTH_REVOCABLE_FLAG)]))
        return out

    @property
    def usd(self):
        return PX.Asset.credit("USD", self.roles[0].account_id)

    def trust(self):
        return [r.tx([r.op_change_trust(self.usd, 10 ** 12)])
                for r in self.roles[1:9]]

    def authorize(self):
        issuer = self.roles[0]
        return [issuer.tx([issuer.op_allow_trust(r.account_id, b"USD\x00")
                           for r in self.roles[1:9]])]

    def issue(self):
        issuer = self.roles[0]
        return [issuer.tx([issuer.op_payment(r.account_id, 10 ** 9,
                                             self.usd)
                           for r in self.roles[1:5]])]

    def payments(self):
        """The multisig mix (20 signatures each, every CORRUPT_EVERY-th
        with one corrupted) and the standard mix's 2-signature payments
        between partners."""
        out = []
        for s in self.multisig:
            self.n += 1
            # the amount varies: a trimmed tx's successor reuses its
            # sequence number and must not reuse its contents hash
            f = s.tx([s.op_payment(self.root.account_id, 1000 + self.n)],
                     extra_signers=self.extra[s.account_id.key_bytes])
            if self.n % CORRUPT_EVERY == 0:
                ds = f.signatures[7]
                ds.signature = ds.signature[:5] + bytes(
                    [ds.signature[5] ^ 1]) + ds.signature[6:]
                self.corrupted.add(f.contents_hash())
            out.append(f)
        for i, s in enumerate(self.two_sig):
            partner = self.two_sig[i ^ 1]
            out.append(s.tx([s.op_payment(partner.account_id, 1000)],
                            extra_signers=self.extra[
                                s.account_id.key_bytes]))
        return out

    def mixed(self, rnd: int):
        """`_StandardMix.submit_mixed_ops` (bench.py) as transactions."""
        from stellar_core_tpu_torch.xdr.basic import MuxedAccountMed25519
        from stellar_core_tpu_torch.xdr.transaction import (
            BumpSequenceOp, PathPaymentStrictReceiveOp,
            PathPaymentStrictSendOp, _InnerTxEnvelope,
        )
        X, usd, r = PX, self.usd, self.roles
        native = X.Asset.native()
        out = [
            r[9].tx([r[9].op_change_trust(usd, 10 ** 10 + rnd),
                     r[9].op_manage_data("bench-k", b"v%d" % rnd)]),
            r[10].tx([r[10].op_manage_data("tmp%d" % (rnd % 3),
                                           b"x" if rnd % 2 else None)]),
            r[11].tx([r[11].op(X.OperationBody(
                X.OperationType.BUMP_SEQUENCE,
                BumpSequenceOp(bumpTo=r[11].next_seq() + 3)))]),
            r[1].tx([r[1].op_manage_sell_offer(usd, native, 500 + rnd,
                                               2, 1)]),
            r[2].tx([r[2].op_manage_buy_offer(native, usd, 60 + rnd, 1, 2)]),
            r[3].tx([r[3].op(X.OperationBody(
                X.OperationType.PATH_PAYMENT_STRICT_RECEIVE,
                PathPaymentStrictReceiveOp(
                    sendAsset=usd, sendMax=10 ** 8, destination=r[4].muxed,
                    destAsset=native, destAmount=40 + rnd, path=[])))]),
            r[4].tx([r[4].op(X.OperationBody(
                X.OperationType.PATH_PAYMENT_STRICT_SEND,
                PathPaymentStrictSendOp(
                    sendAsset=usd, sendAmount=25 + rnd,
                    destination=r[5].muxed, destAsset=native, destMin=1,
                    path=[])))]),
            r[0].tx([r[0].op_allow_trust(r[6].account_id, b"USD\x00",
                                         authorize=2 if rnd % 2 else 1)]),
        ]
        if self.merge_n:
            prev = T.TestAccount(self.shim, SecretKey.from_seed(
                bytes([93, self.merge_n & 0xFF] + [5] * 30)))
            out.append(prev.tx([prev.op(X.OperationBody(
                X.OperationType.ACCOUNT_MERGE,
                X.MuxedAccount.from_account_id(self.root.account_id)))]))
        self.merge_n += 1
        fodder = SecretKey.from_seed(bytes([93, self.merge_n & 0xFF]
                                           + [5] * 30))
        out.append(r[12].tx([r[12].op_create_account(fodder.public_key,
                                                     3 * 10 ** 7)]))
        inner = r[15].tx([r[15].op_payment(self.root.account_id, 5)])
        fb = X.FeeBumpTransaction(
            feeSource=r[14].muxed, fee=2000,
            innerTx=_InnerTxEnvelope(X.EnvelopeType.ENVELOPE_TYPE_TX,
                                     inner.envelope.value),
            ext=X._Ext.v0())
        frame = FeeBumpTransactionFrame(NET, X.TransactionEnvelope(
            X.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP,
            X.FeeBumpTransactionEnvelope(tx=fb, signatures=[])))
        frame.add_signature(r[14].sk)
        out.append(frame)
        out.append(r[16].tx([r[16].op(X.OperationBody(
            X.OperationType.PAYMENT, X.PaymentOp(
                destination=X.MuxedAccount(0x100, MuxedAccountMed25519(
                    id=7, ed25519=r[17].account_id.key_bytes)),
                asset=native, amount=9 + rnd)))]))
        # a one-signature payment whose only signature is corrupted
        bad = r[18].tx([r[18].op_payment(r[19].account_id, 1 + rnd)])
        ds = bad.signatures[0]
        ds.signature = bytes([ds.signature[0] ^ 0x80]) + ds.signature[1:]
        self.corrupted.add(bad.contents_hash())
        out.append(bad)
        return out

    def schedule(self):
        """(transactions, upgrades) per close; a callable is built just
        before its close, against the state the earlier closes left."""
        yield self.fund, ()
        yield self.arm, ()
        yield self.trust, ()
        yield self.authorize, ()
        yield self.issue, ()
        for k in range(13):
            ups = ()
            if k == 6:
                p = UpgradeParameters()
                p.upgrade_time = 0
                p.base_fee = 150
                p.base_reserve = 4_000_000
                ups = Upgrades(p).create_upgrades_for(
                    self.shim.header(), close_time=0)
                assert len(ups) == 2
            yield (lambda k=k: self.payments() + self.mixed(k)), ups


def engine_candidates(root, frames) -> list:
    """The (key, signature, contents hash) triples the apply engine hands
    its verify callback in one close of `frames` (apply order), derived
    from `root`'s state at the close's start by the engine's rule
    (`collect_tx_candidates`, `vset_collect` and `preverify_all` in
    `native/applyc.c`): per signature, in each of a transaction's accounts
    (its source, then each operation's source), the account's master key
    (also when the account does not exist), its signers, and every signer
    that a SET_OPTIONS of the set adds to it, where the key's last four
    bytes are the signature's hint; pairs of one transaction counted
    once. A fee bump gives its outer pairs (fee source, outer signatures,
    outer hash) and then its inner transaction's."""
    X = PX
    adds = []                      # (account key, signer key)
    for f in frames:
        t = getattr(f, "inner", f)
        for opf in t.op_frames:
            body = opf.op.body
            if body.disc == X.OperationType.SET_OPTIONS and \
                    body.value.signer is not None:
                adds.append((opf.source_account_id().key_bytes,
                             body.value.signer.key.value))

    def signers_of(acc: bytes) -> list:
        e = root.get_entry(X.LedgerKey.account(X.PublicKey.ed25519(acc)))
        keys = [acc]
        if e is not None:
            keys += [s.key.value for s in e.data.value.signers]
        return keys + [k for a, k in adds if a == acc]

    def pairs(accounts, signatures, msg) -> list:
        seen, out = set(), []
        for acc in accounts:
            keys = signers_of(acc)
            for i, ds in enumerate(signatures):
                for k in keys:
                    if k[28:] == ds.hint and (k, i) not in seen:
                        seen.add((k, i))
                        out.append((k, ds.signature, msg))
        return out

    out = []
    for f in frames:
        t = getattr(f, "inner", f)
        if t is not f:
            out += pairs([f.source_account_id().key_bytes], f.signatures,
                         f.contents_hash())
        accounts = [t.source_account_id().key_bytes] + [
            opf.source_account_id().key_bytes for opf in t.op_frames]
        out += pairs(accounts, t.signatures, t.contents_hash())
    return out


def engine_launches(candidates, bucket: int = 8192) -> int:
    """Verify kernel launches of the engine's one `prewarm_many` over
    `candidates`: one per `bucket` triples the verify cache does not hold
    (the card's verifier's largest bucket; `prewarm_many` sends every
    miss, a repeated one too)."""
    from stellar_core_tpu_torch.crypto import keys as K
    with K._cache_lock:
        misses = sum(1 for t in candidates
                     if K._cache_key(*t) not in K._verify_cache)
    return -(-misses // bucket)


