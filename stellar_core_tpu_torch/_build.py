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


# the C libraries of `native/`: source stem -> library name prefix. Each
# build can include the generated `prep_constants.h`
# (native/gen_constants.py); ed25519c.c and prep.c do
NATIVE_LIBS = {"ed25519c": "libscted25519", "prep": "libsctprep",
               "sha256_pad": "libsctsha256pad"}


def build_native(stem: str) -> Optional[str]:
    """Build `native/<stem>.c` (a key of NATIVE_LIBS) into its own library
    and return its path; None when the host has no C compiler (callers
    then use the pure-Python and numpy paths). A failed build raises with
    the compiler's output; it touches no other library."""
    cc = find_cc()
    if cc is None:
        return None
    from .native.gen_constants import header_text
    header = header_text()
    src = os.path.join(NATIVE_DIR, stem + ".c")
    digest = _digest([src], header + " ".join(CC_FLAGS))
    so = os.path.join(BUILD_DIR, "%s-%s.so" % (NATIVE_LIBS[stem], digest))
    if os.path.exists(so):
        return so
    # a private include dir per build: a concurrent build never sees a
    # half-written header
    inc = os.path.join(BUILD_DIR, "inc-%s-%d" % (digest, os.getpid()))
    os.makedirs(inc, exist_ok=True)
    try:
        with open(os.path.join(inc, "prep_constants.h"), "w") as fh:
            fh.write(header)
        tmp = "%s.tmp%d" % (so, os.getpid())
        r = subprocess.run([cc] + CC_FLAGS + ["-I", inc, "-o", tmp, src],
                           capture_output=True, text=True, timeout=300)
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
    compiler. The name carries the module name, the interpreter's
    `cache_tag` and a hash of the source, the flags and the include dir. A
    failed build raises with the compiler's output."""
    cc = find_cc()
    if cc is None:
        return None
    inc = sysconfig.get_paths()["include"]
    tag = sys.implementation.cache_tag
    src = os.path.join(NATIVE_DIR, stem + ".c")
    digest = _digest([src], " ".join(EXT_FLAGS) + " " + inc + " " + tag)
    so = os.path.join(BUILD_DIR, "%s-%s-%s.so" % (NATIVE_EXTS[stem], tag,
                                                   digest))
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp%d" % (so, os.getpid())
    # the compiler must not inherit a preloaded runtime meant for this
    # process (a sanitizer's, say)
    env = {k: v for k, v in os.environ.items() if k != "LD_PRELOAD"}
    try:
        r = subprocess.run([cc] + EXT_FLAGS + ["-I", inc, "-o", tmp, src],
                           capture_output=True, text=True, timeout=300,
                           env=env)
        if r.returncode != 0:
            raise RuntimeError("cc failed for %s.c (rc %d):\n%s"
                               % (stem, r.returncode, r.stderr[-8000:]))
        os.replace(tmp, so)   # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so
