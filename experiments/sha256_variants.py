#!/usr/bin/env python3
"""Compare variants of the port's SHA-256 kernel on one CUDA card.

    python3 experiments/sha256_variants.py [--edit NAME ...] [VARIANT.cu ...]

Run from the root of a checkout on a machine with an sm_90a card. Builds
`stellar_core_tpu_torch/csrc/sha256.cu` ("kernel"), every VARIANT.cu given
(another source with the same C entry point `sct_sha256_blocks`, e.g. an
earlier commit's `csrc/sha256.cu` from `git show`), and each named edit of
the kernel's round (EDITS below), one `nvcc` per source, all started
together, into the gitignored `stellar_core_tpu_torch/build/
sha256_variants/`. Then for each:

- the ptxas report and, from the SASS (`cuobjdump`), each loop's
  instruction count and ptxas's stall clocks (chip_smoke.sass_loops);
- its digest words against `hash_blocks_plain` on the card at edge shapes
  (one lane, ragged counts, counts past max_blocks, no positive count,
  lane counts that end inside a warp, 20 and 40 blocks); tolerance none;
- its time (CUDA events behind a sleep kernel, chip_smoke.time_cuda) in
  turns a, b, ..., ..., b, a at one lane of 1 and 16 blocks (their slope
  is the per-block latency of a chain), the launch shapes of the hasher's
  main paths and an idle 4096x2 launch (every count 0).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "stellar_core_tpu_torch", "build", "sha256_variants")
KERNEL = os.path.join(ROOT, "stellar_core_tpu_torch", "csrc", "sha256.cu")

_ROUND = """    e = dhwk + S1 + ch;
    d = c;
    c = b;
    b = a;
    a = (hwk + S1 + ch) + (S0 + maj);"""
_ADDS = """    const uint32_t hwk = h + wk;
    const uint32_t dhwk = d + hwk;"""
_IMAD = """#ifdef __CUDACC__
__constant__ uint32_t SHA_ONE_DEV = 1;
#endif
SHA_FN uint32_t sha_add(uint32_t x, uint32_t y)
{
#ifdef __CUDA_ARCH__
    uint32_t r;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r)
        : "r"(x), "r"(SHA_ONE_DEV), "r"(y));
    return r;
#else
    return x + y;
#endif
}

"""
# name: [(old, new), ...] applied to the kernel's source
EDITS = {
    # every add of the round as an IMAD by a 1 that ptxas cannot fold,
    # which keeps it on the FMA pipe
    "imad-adds": [
        ("// One round with wk", _IMAD + "// One round with wk"),
        (_ADDS, "    const uint32_t hwk = sha_add(h, wk);\n"
                "    const uint32_t dhwk = sha_add(d, hwk);"),
        (_ROUND, """    e = sha_add(sha_add(dhwk, ch), S1);
    d = c;
    c = b;
    b = a;
    a = sha_add(sha_add(sha_add(hwk, ch), S1), sha_add(S0, maj));""")],
    # one add fewer, e one level deeper: T1 = h + WK + S1 + Ch, e' = d + T1
    "d-plus-t1": [
        (_ADDS, "    const uint32_t hwk = h + wk;"),
        (_ROUND, """    const uint32_t t1 = hwk + S1 + ch;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;""")],
}

CHECKS = ((1, 1, "full"), (1, 16, "full"), (32, 16, "full"),
          (33, 2, "ragged"), (256, 16, "ragged"), (4096, 2, "ragged"),
          (4096, 16, "ragged"), (1024, 16, "sorted"), (100, 20, "ragged"),
          (64, 4, "idle"), (1000, 40, "ragged"))
TIMED = ((1, 1, "full"), (1, 16, "full"), (4096, 1, "ragged"),
         (4096, 2, "full"), (4096, 4, "full"), (4096, 16, "ragged"),
         (1024, 16, "sorted"), (4096, 2, "idle"))


def batch(rng, lanes: int, blocks: int, kind: str):
    """Random words and (lanes,) counts: all `blocks` ("full"), in
    [-1, blocks + 3] ("ragged"), sorted in [1, blocks] ("sorted"), or in
    [-3, 0] ("idle")."""
    words = rng.integers(0, 1 << 32, (lanes, blocks, 16),
                         dtype=np.uint64).astype(np.uint32)
    if kind == "full":
        counts = np.full(lanes, blocks)
    elif kind == "ragged":
        counts = rng.integers(-1, blocks + 4, lanes)
    elif kind == "sorted":
        counts = np.sort(rng.integers(1, blocks + 1, lanes))
    else:
        counts = rng.integers(-3, 1, lanes)
    return words.view(np.int32), counts.astype(np.int32)


def sources(args) -> dict:
    """{name: source path}: the kernel, the variant files, the edits."""
    srcs = {"kernel": KERNEL}
    for path in args.variants:
        srcs[os.path.splitext(os.path.basename(path))[0]] = path
    with open(KERNEL) as fh:
        text = fh.read()
    for name in args.edit:
        out = text
        for old, new in EDITS[name]:
            if old not in out:
                raise SystemExit("edit %s does not apply to %s"
                                 % (name, KERNEL))
            out = out.replace(old, new)
        path = os.path.join(OUT, "sha256_%s.cu" % name)
        with open(path, "w") as fh:
            fh.write(out)
        srcs[name] = path
    return srcs


def build(srcs: dict) -> dict:
    """{name: loaded library}; prints each build's ptxas figures and SASS
    loops."""
    import chip_smoke as CS
    from stellar_core_tpu_torch import _build
    procs = {}
    for name, src in srcs.items():
        so = os.path.join(OUT, "lib%s.so" % name)
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc()] + _build.NVCC_FLAGS
            + ["-I", _build.CSRC_DIR, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise SystemExit("nvcc failed for %s:\n%s" % (name, log))
        regs = re.search(r"Used (\d+) registers", log)
        smem = re.search(r"(\d+) bytes smem", log)
        print("%s: %s registers, %s bytes smem, %s" % (
            name, regs.group(1) if regs else "?",
            smem.group(1) if smem else "0",
            re.search(r"\d+ bytes stack frame.*", log).group(0)))
        for loop in CS.sass_loops(so, "sha256_blocks_kernel") or []:
            print("  loop: %d instructions, %d stall clocks; %s"
                  % (loop["instructions"], loop["stall_clocks"],
                     ", ".join("%s %d" % kv
                               for kv in loop["ops"].most_common(6))))
        lib = ctypes.CDLL(so)
        lib.sct_sha256_blocks.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.sct_sha256_blocks.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help="other sha256 sources")
    ap.add_argument("--edit", action="append", default=[],
                    choices=sorted(EDITS), help="an edit of the round")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sha256_variants: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from stellar_core_tpu_torch.ops import sha256 as S
    os.makedirs(OUT, exist_ok=True)
    print(CS.nvidia_smi("name,power.limit"))
    t0 = time.perf_counter()
    libs = build(sources(args))
    print("build: %.1f s" % (time.perf_counter() - t0))

    def launch(lib, w, c):
        out = torch.empty((w.shape[0], 8), dtype=torch.int32, device="cuda")
        rc = lib.sct_sha256_blocks(w.data_ptr(), c.data_ptr(),
                                   out.data_ptr(), w.shape[0], w.shape[1],
                                   torch.cuda.current_stream().cuda_stream)
        CS.check(rc == 0, "launch (error %d)" % rc)
        return out

    rng = np.random.default_rng(5)
    for lanes, blocks, kind in CHECKS:
        words, counts = batch(rng, lanes, blocks, kind)
        w = torch.from_numpy(words).cuda()
        c = torch.from_numpy(counts).cuda()
        want = S.hash_blocks_plain(w, c)
        for name, lib in libs.items():
            got = launch(lib, w, c)
            torch.cuda.synchronize()
            CS.check(torch.equal(got, want), "%s == plain at %dx%d %s"
                     % (name, lanes, blocks, kind))
    print("every variant == hash_blocks_plain at %d shapes" % len(CHECKS))

    order = list(libs) + list(libs)[::-1]
    times = {}
    for lanes, blocks, kind in TIMED:
        words, counts = batch(rng, lanes, blocks, kind)
        w = torch.from_numpy(words).cuda()
        c = torch.from_numpy(counts).cuda()
        row = []
        for name in order:
            ms = CS.time_cuda(lambda: launch(libs[name], w, c), reps=200)
            times.setdefault(name, {}).setdefault(
                (lanes, blocks, kind), []).append(ms)
            row.append("%s %.5f" % (name, ms))
        print("%dx%d %s: %s ms" % (lanes, blocks, kind, ", ".join(row)))
    for name, t in times.items():
        one, sixteen = t[(1, 1, "full")], t[(1, 16, "full")]
        print("%s: %s ms per block in a chain" % (name, " / ".join(
            "%.5f" % ((b - a) / 15) for a, b in zip(one, sixteen))))
    print(CS.nvidia_smi("name,power.limit,clocks.max.sm,clocks.sm"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
