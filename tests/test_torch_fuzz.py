"""The port's fuzz harness (`stellar_core_tpu_torch/main/fuzz.py`) and its
fuzzing hook (`transactions/signature_checker.set_fuzzing_mode`) held
against the JAX package's.

Every case of `tests/test_fuzz.py` (3) runs on both packages from the
reference's own source (`torch_mirror_harness.Mirror`), the port's
fuzzers on the CPU (`torch_sim_harness.SIM_SUBS`); each run's stats (the
mutated inputs that failed to decode, were refused as frames, applied, or
raised in a handler; the overlay's dropped peers and rebuilt nets) are
recorded on both sides and equal: the mutations come from one seeded
stream over the same corpus bytes on both packages. The command-line
cases (`test_cli_extra.py::test_gen_fuzz_then_single_input` and
`::test_simulate`) run with the rest of that file in
`tests/test_torch_admin.py`.

Port-only: the fuzzers with no backend named build the card's stacks
and raise where there is no card; the fuzzing flag is off after a
`fuzz_tx` or a `run_one` that raises. Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mirror_harness import Mirror  # noqa: E402
from torch_sim_harness import SIM_SUBS  # noqa: E402


def record_stats(side, pkg, mods, log) -> None:
    """Each fuzz run's stats, in order."""
    mod = mods["test_fuzz.py"]
    for name in ("fuzz_tx", "fuzz_overlay"):
        fn = getattr(mod, name)

        def recorded(*a, _fn=fn, _name=name, **kw):
            stats = _fn(*a, **kw)
            log.append((_name, dict(stats)))
            return stats

        setattr(mod, name, recorded)


MIRROR = Mirror(("test_fuzz.py",), hook=record_stats, port_subs=SIM_SUBS)
CASES = MIRROR.cases()


def test_mirrors_every_case():
    assert sorted(n for _f, n, _i in CASES) == [
        "test_fuzz_overlay_smoke", "test_fuzz_tx_smoke",
        "test_fuzzing_mode_restored"]


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case):
    ref = MIRROR.run("ref", case)
    port = MIRROR.run("port", case)
    assert port == ref and port


def test_fuzzers_raise_without_a_card():
    import torch

    from stellar_core_tpu_torch.main import fuzz
    from stellar_core_tpu_torch.transactions import signature_checker as sc
    assert not torch.cuda.is_available()
    for run in (lambda: fuzz.fuzz_overlay(iterations=1),
                lambda: fuzz.fuzz_tx(iterations=1),
                lambda: fuzz.gen_input("tx"),
                lambda: fuzz.run_one("tx", b"\x00" * 8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
        assert sc._FUZZING_MODE is False


def test_fuzzing_mode_off_after_a_raising_run(monkeypatch):
    """A fuzz run whose apply raises mid-loop still clears the flag in
    its `finally`. The corpus is built through the real apply with the
    flag off; the apply raises only once the flag is on, i.e. inside the
    fuzzing loop, where every signature check passes with no verify."""
    from stellar_core_tpu_torch import testing
    from stellar_core_tpu_torch.main import fuzz
    from stellar_core_tpu_torch.transactions import signature_checker as sc
    seen = []
    orig = testing.TestLedger.apply_frame

    def apply_frame(self, frame):
        seen.append(sc._FUZZING_MODE)
        if sc._FUZZING_MODE:
            raise RuntimeError("apply blew up")
        return orig(self, frame)

    monkeypatch.setattr(testing.TestLedger, "apply_frame", apply_frame)
    with pytest.raises(RuntimeError, match="apply blew up"):
        fuzz.fuzz_tx(iterations=400, seed=3, backend="cpu")
    assert seen[-1] is True and not any(seen[:-1])
    assert sc._FUZZING_MODE is False
    # `run_one` on an unmutated envelope reaches the same raising apply
    led = fuzz._test_ledger("cpu", None)
    root = testing.TestAccount(led, testing.root_secret_key())
    blob = root.tx([root.op_payment(root.account_id, 1)]).envelope.to_xdr()
    del seen[:]
    with pytest.raises(RuntimeError, match="apply blew up"):
        fuzz.run_one("tx", blob, backend="cpu")
    assert seen == [True]
    assert sc._FUZZING_MODE is False


def test_fuzz_command_restores_logging_reference_fault(tmp_path, capsys):
    """The reference's `fuzz` command leaves `logging.disable(ERROR)` in
    force after it returns (ROADMAP Queue 3 item 13), so a caller in the
    same process loses every later warning; the port's silences logging
    only while it runs. Both run the same input to the same stats."""
    import json
    import logging

    from stellar_core_tpu.main.commandline import main as ref_main
    from stellar_core_tpu_torch.crypto import strkey
    from stellar_core_tpu_torch.main.commandline import main as port_main
    conf = tmp_path / "cpu.toml"
    conf.write_text('SIG_VERIFY_BACKEND = "cpu"\nHASH_BACKEND = "cpu"\n'
                    'NODE_SEED = "%s"\n' % strkey.encode_seed(b"\x07" * 32))
    blob = tmp_path / "input.bin"
    assert ref_main(["gen-fuzz", str(blob), "--mode", "tx",
                     "--seed", "7"]) == 0
    left, stats = {}, {}
    try:
        for side, main, extra in (("port", port_main, ["--conf", str(conf)]),
                                  ("ref", ref_main, [])):
            logging.disable(logging.NOTSET)
            capsys.readouterr()
            assert main(["fuzz", "--mode", "tx", "--input", str(blob)]
                        + extra) == 0
            stats[side] = json.loads(capsys.readouterr().out.splitlines()[0])
            left[side] = logging.root.manager.disable
    finally:
        logging.disable(logging.NOTSET)
    assert stats["port"] == stats["ref"] and stats["ref"]["iterations"] == 1
    assert left == {"port": logging.NOTSET, "ref": logging.ERROR}
