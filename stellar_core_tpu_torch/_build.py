"""Builds the port's native code at first use, into `build/` beside this file.

- `csrc/*.cu`: one `nvcc` run per source, all started together, each
  into its own shared library with a plain C interface (loaded with
  ctypes).
  Target `sm_90a` (Hopper). `-Xptxas -v` output (registers, spills) is
  kept beside each library as `<name>.log`.
- `native/ed25519c.c` (the CPU ed25519 library), `native/prep.c` (the
  verify boundary's batched host prep) and `native/sha256_pad.c` (the
  hasher's chunk padder), each built with `cc` into its own library.
- `native/applyc.c` (the apply engine) and `native/xdrc.c` (the XDR
  codec's C route), each built with `cc`, `-pthread` and the interpreter's
  headers into a CPython extension (`build_extension`), whose file name
  also carries the interpreter's `cache_tag`: an extension is not ABI-stable
  across CPython versions.

Every artifact name carries a content hash of its sources and flags, so an
edit never reuses a stale library, and a finished build is reused by every
later process. A failed build raises with the compiler's output.

`SCT_SANITIZE` (read at import, so one process is wholly sanitized or
wholly not) reroutes every `cc` build of `native/` into a sanitizer's own
directory with its flags: "1" or "address" into `build/sanitized/` with
`-fsanitize=address,undefined`, "thread" into `build/tsan/` with
`-fsanitize=thread`; unset, "" or "0" is the normal build. Any other value
raises. The mode, the flags and the two directories are the reference's
(`stellar_core_tpu/native/__init__.py` at commit c67d465). Unlike the
reference's build, a sanitized build never falls back: a host without a C
compiler raises, as a failed build does, and nothing loads the plain
library in its place. The sanitizer's runtime must be preloaded into the
process that loads the libraries (`sanitizer_env`); the compiler never
inherits that preload (a TSan-preloaded Python forking gcc can deadlock in
the runtime's fork interceptor). The `nvcc` builds of `csrc/` are never
sanitized.

    SCT_SANITIZE=thread python -m stellar_core_tpu_torch._build

builds every library and extension of `native/` in the current mode and
prints the environment that runs Python against them.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from typing import Dict, List, Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NATIVE_DIR = os.path.join(PKG_DIR, "native")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CC_FLAGS = ["-O2", "-shared", "-fPIC"]
NVCC_TIMEOUT_S = 900

_SAN_RAW = os.environ.get("SCT_SANITIZE", "")
_SAN_MODES = {"": "", "0": "", "1": "address", "address": "address",
              "thread": "thread"}
if _SAN_RAW not in _SAN_MODES:
    # a typo ('tsan', 'asan') silently producing a plain build would make
    # the sanitizer run vacuously clean
    raise RuntimeError(
        "SCT_SANITIZE=%r is not a sanitize mode (use 1/address for "
        "ASan+UBSan, thread for TSan, 0/unset for none)" % _SAN_RAW)
SANITIZE_MODE = _SAN_MODES[_SAN_RAW]
if SANITIZE_MODE == "thread":
    _SAN_SUBDIR = "tsan"
    SANITIZE_FLAGS = ["-fsanitize=thread", "-fno-omit-frame-pointer", "-g"]
elif SANITIZE_MODE == "address":
    _SAN_SUBDIR = "sanitized"
    SANITIZE_FLAGS = ["-fsanitize=address,undefined",
                      "-fno-omit-frame-pointer", "-g"]
else:
    _SAN_SUBDIR = ""
    SANITIZE_FLAGS = []
# the runtime each mode preloads, and its options: CPython leaks at exit
# by design (leak reports would bury the memory errors), and TSan reports
# every race instead of stopping at the first (its exit code still fails)
_SAN_RUNTIME = {"address": ("libasan.so", "ASAN_OPTIONS", "detect_leaks=0"),
                "thread": ("libtsan.so", "TSAN_OPTIONS", "halt_on_error=0")}

_LOCK = threading.Lock()
_CUDA_LIBS: Dict[str, str] = {}


def _digest(paths: List[str], extra: str) -> str:
    h = hashlib.sha256(extra.encode())
    for p in paths:
        with open(p, "rb") as fh:
            h.update(os.path.basename(p).encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH)")


def _cuda_targets() -> List[tuple]:
    """(stem, source, shared-library path) of every `csrc/*.cu`; each
    library's name hashes its source, all `csrc/*.cuh` and the flags."""
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not sources:
        raise RuntimeError("no CUDA sources under %s" % CSRC_DIR)
    out = []
    for src in sources:
        stem = os.path.splitext(os.path.basename(src))[0]
        out.append((stem, src, os.path.join(BUILD_DIR, "lib%s-%s.so" % (
            stem, _digest([src] + headers, " ".join(NVCC_FLAGS))))))
    return out


def cuda_built(stem: str) -> bool:
    """Whether the library of `csrc/<stem>.cu` for the current sources is
    already built (a later `build_cuda` reuses it without `nvcc`)."""
    return any(s == stem and os.path.exists(so)
               for s, _src, so in _cuda_targets())


def build_cuda() -> Dict[str, str]:
    """Build every `csrc/*.cu` (each with all `csrc/*.cuh` in its hash),
    one `nvcc` process per source, all started together; return {source
    stem: shared-library path}. Any failed build raises."""
    with _LOCK:
        if _CUDA_LIBS:
            return dict(_CUDA_LIBS)
        os.makedirs(BUILD_DIR, exist_ok=True)
        libs: Dict[str, str] = {}
        jobs = []      # (stem, library, temporary output, process)
        try:
            for stem, src, so in _cuda_targets():
                libs[stem] = so
                if os.path.exists(so):
                    continue
                tmp = "%s.tmp%d" % (so, os.getpid())
                with open(so[:-3] + ".log", "w") as log:
                    proc = subprocess.Popen(
                        [find_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                        stdout=log, stderr=subprocess.STDOUT, cwd=CSRC_DIR)
                jobs.append((stem, so, tmp, proc))
            for stem, so, tmp, proc in jobs:
                proc.wait(timeout=NVCC_TIMEOUT_S)
                with open(so[:-3] + ".log") as fh:
                    out = fh.read()
                if proc.returncode != 0:
                    raise RuntimeError("nvcc failed for %s (rc %d):\n%s"
                                       % (stem, proc.returncode,
                                          out[-8000:]))
                os.replace(tmp, so)   # atomic: concurrent builds agree
        finally:
            for _stem, _so, tmp, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
        _CUDA_LIBS.update(libs)
        return dict(libs)


def find_cc() -> Optional[str]:
    for cc in ("cc", "gcc"):
        path = shutil.which(cc)
        if path:
            return path
    return None


def native_build_dir() -> str:
    """Where this process's `cc` builds go: BUILD_DIR, or its sanitizer's
    subdirectory."""
    return os.path.join(BUILD_DIR, _SAN_SUBDIR) if _SAN_SUBDIR else BUILD_DIR


def _cc_or_none() -> Optional[str]:
    """The C compiler; None when the host has none, except in a sanitized
    process, which raises rather than run the plain Python paths."""
    cc = find_cc()
    if cc is None and SANITIZE_MODE:
        raise RuntimeError("SCT_SANITIZE=%r needs a C compiler (cc or gcc)"
                           % _SAN_RAW)
    return cc


def _cc_env() -> Dict[str, str]:
    """The compiler's environment: this one without LD_PRELOAD, which is
    for loading the built libraries into this process."""
    return {k: v for k, v in os.environ.items() if k != "LD_PRELOAD"}


def sanitizer_env(mode: str) -> Dict[str, str]:
    """The environment that runs Python against the `mode` ("address" or
    "thread") builds: SCT_SANITIZE, the runtime and libstdc++ preloaded
    (libstdc++ must resolve when ASan's interceptors start, or the first
    C++ throw aborts), and the runtime's options. Raises when the compiler
    has no such runtime."""
    if mode not in _SAN_RUNTIME:
        raise ValueError("sanitize mode %r is not one of %s"
                         % (mode, sorted(_SAN_RUNTIME)))
    lib, opt_name, opts = _SAN_RUNTIME[mode]
    cc = find_cc()
    if cc is None:
        raise RuntimeError("no C compiler, so no %s" % lib)
    preload = []
    for name in (lib, "libstdc++.so"):
        path = subprocess.run([cc, "-print-file-name=%s" % name],
                              capture_output=True, text=True,
                              env=_cc_env()).stdout.strip()
        if not path or not os.path.exists(path):
            raise RuntimeError("%s has no %s runtime" % (cc, name))
        preload.append(path)
    return dict(os.environ, SCT_SANITIZE="1" if mode == "address" else mode,
                LD_PRELOAD=" ".join(preload), **{opt_name: opts})


# the C libraries of `native/`: source stem -> library name prefix. Each
# build can include the generated `prep_constants.h`
# (native/gen_constants.py); ed25519c.c and prep.c do
NATIVE_LIBS = {"ed25519c": "libscted25519", "prep": "libsctprep",
               "sha256_pad": "libsctsha256pad"}


def build_native(stem: str) -> Optional[str]:
    """Build `native/<stem>.c` (a key of NATIVE_LIBS) into its own library
    and return its path; None when the host has no C compiler (callers
    then use the pure-Python and numpy paths) and the process is not
    sanitized. A failed build raises with the compiler's output; it
    touches no other library."""
    cc = _cc_or_none()
    if cc is None:
        return None
    from .native.gen_constants import header_text
    header = header_text()
    src = os.path.join(NATIVE_DIR, stem + ".c")
    flags = CC_FLAGS + SANITIZE_FLAGS
    digest = _digest([src], header + " ".join(flags))
    out_dir = native_build_dir()
    so = os.path.join(out_dir, "%s-%s.so" % (NATIVE_LIBS[stem], digest))
    if os.path.exists(so):
        return so
    # a private include dir per build: a concurrent build never sees a
    # half-written header
    inc = os.path.join(out_dir, "inc-%s-%d" % (digest, os.getpid()))
    os.makedirs(inc, exist_ok=True)
    try:
        with open(os.path.join(inc, "prep_constants.h"), "w") as fh:
            fh.write(header)
        tmp = "%s.tmp%d" % (so, os.getpid())
        r = subprocess.run([cc] + flags + ["-I", inc, "-o", tmp, src],
                           capture_output=True, text=True, timeout=300,
                           env=_cc_env())
        if r.returncode != 0:
            raise RuntimeError("cc failed for %s.c (rc %d):\n%s"
                               % (stem, r.returncode, r.stderr[-8000:]))
        os.replace(tmp, so)   # atomic: concurrent builds agree
    finally:
        shutil.rmtree(inc, ignore_errors=True)
    return so


# the CPython extensions of `native/`: source stem -> module name (the
# reference package's copies are `_sctapply` and `_sctxdr`; distinct names
# let both load in one process)
NATIVE_EXTS = {"applyc": "_sctapply_torch", "xdrc": "_sctxdr_torch"}
# -pthread: the apply engine's parallel close starts worker threads
EXT_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread"]


def build_extension(stem: str) -> Optional[str]:
    """Build `native/<stem>.c` (a key of NATIVE_EXTS) into a CPython
    extension and return its path; None only when the host has no C
    compiler and the process is not sanitized. The name carries the module
    name, the interpreter's `cache_tag` and a hash of the source, the flags
    and the include dir. A failed build raises with the compiler's
    output."""
    cc = _cc_or_none()
    if cc is None:
        return None
    inc = sysconfig.get_paths()["include"]
    tag = sys.implementation.cache_tag
    src = os.path.join(NATIVE_DIR, stem + ".c")
    flags = EXT_FLAGS + SANITIZE_FLAGS
    digest = _digest([src], " ".join(flags) + " " + inc + " " + tag)
    out_dir = native_build_dir()
    so = os.path.join(out_dir, "%s-%s-%s.so" % (NATIVE_EXTS[stem], tag,
                                                 digest))
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = "%s.tmp%d" % (so, os.getpid())
    try:
        r = subprocess.run([cc] + flags + ["-I", inc, "-o", tmp, src],
                           capture_output=True, text=True, timeout=300,
                           env=_cc_env())
        if r.returncode != 0:
            raise RuntimeError("cc failed for %s.c (rc %d):\n%s"
                               % (stem, r.returncode, r.stderr[-8000:]))
        os.replace(tmp, so)   # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def main() -> int:
    """Build every library and extension of `native/` in this process's
    SCT_SANITIZE mode, print each path, and for a sanitized mode the
    environment that runs Python against them."""
    for stem in NATIVE_LIBS:
        print("%-12s %s" % (stem, build_native(stem)))
    for stem in NATIVE_EXTS:
        print("%-12s %s" % (stem, build_extension(stem)))
    if SANITIZE_MODE:
        env = sanitizer_env(SANITIZE_MODE)
        print("run Python against them with:")
        print("  " + " ".join("%s=%r" % (k, env[k]) for k in (
            "SCT_SANITIZE", "LD_PRELOAD", _SAN_RUNTIME[SANITIZE_MODE][1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
