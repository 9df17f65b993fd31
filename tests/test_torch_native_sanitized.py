"""The port's sanitized native builds: the five cases of
`tests/test_native_sanitized.py`, on the port.

`SCT_SANITIZE` (`stellar_core_tpu_torch/_build.py`) builds every `cc`
library and extension of the port's `native/` (the ed25519 library, the
verify prep, the chunk padder, the apply engine `applyc.c` and the codec's
C route `xdrc.c`) with -fsanitize=address,undefined into `build/sanitized/`
or with -fsanitize=thread into `build/tsan/`, and `_build.sanitizer_env`
gives the environment that runs Python against them (the runtime and
libstdc++ preloaded, the runtime's options). Each case runs in a
subprocess:

- the ASan/UBSan build compiles and loads all five;
- the port's native differentials (prep, padder, apply engine, codec: each
  held against the port's Python and numpy paths and the reference's
  engine) pass with the sanitized libraries loaded;
- the apply engine's forced-parallel cases (parallel equality, the
  randomized full matrix, every op type) pass under ASan/UBSan;
- the TSan build is made without the preload (a TSan-preloaded Python
  forking gcc can deadlock in the runtime's fork interceptor) and loads
  under it;
- the forced-parallel cases (parallel equality and the two seeded
  conflict mixes) run with the engine's pthread pool TSan-instrumented,
  with no ThreadSanitizer report.

The port's differentials close every set on the reference's engine too,
which reads the same `SCT_SANITIZE`: its libraries are sanitized alike,
and its TSan build is made without the preload as well.

Marked `slow` and `sanitize` as the reference's file is: tier-1 skips it.
Run it with

    python -m pytest tests/test_torch_native_sanitized.py -m sanitize
"""

import os
import shutil
import subprocess
import sys

import pytest

from stellar_core_tpu_torch import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = [pytest.mark.slow, pytest.mark.sanitize]

APPLY = "tests/test_torch_native_apply.py::test_port_engine_matches"
ASAN_PARALLEL = ["%s[native_apply::%s]" % (APPLY, name) for name in (
    "test_native_apply_parallel_equality",
    "test_native_apply_randomized_full_matrix",
    "test_native_apply_all_op_types")]
TSAN_PARALLEL = ["%s[native_apply::%s]" % (APPLY, name) for name in (
    "test_native_apply_parallel_equality",
    "test_native_apply_parallel_seeded-0",
    "test_native_apply_parallel_seeded-1")]


def _env(mode: str) -> dict:
    if shutil.which("cc") is None:
        pytest.skip("no C compiler")
    try:
        env = _build.sanitizer_env(mode)
    except RuntimeError as e:
        pytest.skip(str(e))
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _python(code: str, env: dict, timeout: int = 600):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=timeout)


def _pytest(args, env: dict, timeout: int = 1800):
    r = subprocess.run([sys.executable, "-m", "pytest"] + list(args) +
                       ["-q", "-p", "no:cacheprovider"],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=timeout)
    return r, (r.stdout or "")[-4000:] + (r.stderr or "")[-4000:]


def _asan_clean(r) -> None:
    assert "ERROR: AddressSanitizer" not in r.stderr, r.stderr[-4000:]
    assert "runtime error:" not in r.stderr, r.stderr[-4000:]


def test_sanitized_build_compiles_all_three_extensions():
    r = _python(
        "from stellar_core_tpu_torch import _build, native\n"
        "assert _build.SANITIZE_MODE == 'address', _build.SANITIZE_MODE\n"
        "assert _build.native_build_dir().endswith('sanitized')\n"
        "assert native.ed25519_native() is not None, 'ed25519c failed'\n"
        "assert native.prep_lib() is not None, 'prep failed'\n"
        "assert native.sha256_pad_lib() is not None, 'sha256_pad failed'\n"
        "for mod in (native.apply_engine(), native.xdr_engine()):\n"
        "    assert mod.__file__.startswith(_build.native_build_dir())\n"
        "print('SANITIZED-BUILD-OK')", _env("address"))
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "SANITIZED-BUILD-OK" in r.stdout
    _asan_clean(r)


def test_native_differential_oracles_pass_under_asan_ubsan():
    r, tail = _pytest(["tests/test_torch_native_prep.py",
                       "tests/test_torch_sha256_pad.py",
                       "tests/test_torch_native_apply.py",
                       "tests/test_torch_native_xdr.py"], _env("address"))
    assert r.returncode == 0, tail
    _asan_clean(r)


def test_threaded_parallel_close_under_asan_ubsan():
    r, tail = _pytest(ASAN_PARALLEL, _env("address"), timeout=1200)
    assert r.returncode == 0, tail
    assert "%d passed" % len(ASAN_PARALLEL) in r.stdout, tail
    _asan_clean(r)


def _tsan_prebuild(env: dict) -> None:
    """Build every TSan artifact of both packages without the preload;
    loading them here would fail, so nothing is loaded."""
    build_env = {k: v for k, v in env.items() if k != "LD_PRELOAD"}
    r = subprocess.run([sys.executable, "-m", "stellar_core_tpu_torch._build"],
                       capture_output=True, text=True, cwd=REPO,
                       env=build_env, timeout=600)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert r.stdout.count(os.path.join("build", "tsan")) == 5, r.stdout
    # the reference's engine, which the port's differentials also close on
    r = _python(
        "from stellar_core_tpu import native\n"
        "assert native.SANITIZE_MODE == 'thread', native.SANITIZE_MODE\n"
        "native.available()\n"
        "native.ed25519_native()\n"
        "native.apply_engine()\n"
        "native._compile_xdr_ext()\n"
        "import glob, os\n"
        "for pat in ('libsctprep-*.so', 'libscted25519-*.so',\n"
        "            '_sctapply-*.so', '_sctxdr-*.so'):\n"
        "    assert glob.glob(os.path.join(native._BUILD, pat)), pat\n"
        "print('TSAN-BUILD-OK')", build_env)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "TSAN-BUILD-OK" in r.stdout


def test_tsan_build_compiles_and_loads_under_preload():
    env = _env("thread")
    _tsan_prebuild(env)
    r = _python(
        "from stellar_core_tpu_torch import _build, native\n"
        "assert _build.native_build_dir().endswith('tsan')\n"
        "assert native.apply_engine() is not None, 'applyc failed'\n"
        "assert native.xdr_engine() is not None, 'xdrc failed'\n"
        "assert native.prep_lib() is not None, 'prep failed'\n"
        "assert native.ed25519_native() is not None, 'ed25519c failed'\n"
        "assert native.sha256_pad_lib() is not None, 'sha256_pad failed'\n"
        "print('TSAN-LOAD-OK')", env)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "TSAN-LOAD-OK" in r.stdout
    assert "WARNING: ThreadSanitizer" not in r.stderr, r.stderr[-4000:]


def test_threaded_parallel_close_under_tsan():
    """The race gate: forced-parallel against forced-serial against the
    Python phases, and the seeded conflict mixes, with the GIL-released
    cluster pool TSan-instrumented and no ThreadSanitizer report. TSan's
    own nonzero exit (66) on any report fails the run even if pytest
    passed."""
    env = _env("thread")
    _tsan_prebuild(env)
    r, tail = _pytest(TSAN_PARALLEL, env)
    assert r.returncode == 0, tail
    assert "WARNING: ThreadSanitizer" not in r.stderr, r.stderr[-6000:]
    assert "%d passed" % len(TSAN_PARALLEL) in r.stdout, tail
