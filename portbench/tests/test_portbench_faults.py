"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the port on its C-verifier stack
behind the same resilient layer as the card's, one fault at a time. The
faults a cell can have: an answer altered where it is produced, half of a
batch left out, and a step that returns its state unchanged (a drain
skipped; an envelope's state never moved). There is no exchange between
chips: every cell takes one."""

import pytest

from portbench.run import run_cell

CELLS = ["catchup-verify.pubnet", "scp-bursts.tier1"]


def _altered(orig):
    def verify_many(self, triples):
        out = list(orig(self, triples))
        out[0] = not out[0]
        return out
    return verify_many


def _half(orig):
    def verify_many(self, triples):
        return list(orig(self, triples))[:len(triples) // 2]
    return verify_many


def _run(root, workload):
    return run_cell(root, workload, 2 ** 31 + 17, 2.0, False,
                    backend="cpu-resilient")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(small_root, workload):
    r = _run(small_root, workload)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["altered", "half"])
def test_broken_verify_is_not_correct(small_root, monkeypatch, workload,
                                      fault):
    from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
    wrap = {"altered": _altered, "half": _half}[fault]
    monkeypatch.setattr(CpuSigVerifier, "verify_many",
                        wrap(CpuSigVerifier.verify_many))
    r = _run(small_root, workload)
    assert not r["correct"]
    assert r["checks"]["decisions_wrong"]["value"] > 0


def test_skipped_drain_is_not_correct(small_root, monkeypatch):
    from stellar_core_tpu_torch.historywork.apply_works import \
        ApplyCheckpointWork
    monkeypatch.setattr(ApplyCheckpointWork, "_prewarm_frames",
                        lambda self, frames: None)
    r = _run(small_root, "catchup-verify.pubnet")
    assert not r["correct"]
    assert r["checks"]["triples_wrong"]["value"] > 0


def test_unmoved_envelope_state_is_not_correct(small_root, monkeypatch):
    from stellar_core_tpu_torch.herder.pending_envelopes import \
        PendingEnvelopes
    monkeypatch.setattr(PendingEnvelopes, "finish_verify",
                        lambda self, env, ok, eh=None: False)
    r = _run(small_root, "scp-bursts.tier1")
    assert not r["correct"]
    assert r["checks"]["states_wrong"]["value"] > 0
