"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name: the cell in `BENCHMARK.json`, the
configuration in the file it names, the traffic in
`portbench/traffic/<traffic>.json` (whose `kind` names the module of
`portbench/kinds/` that generates and drives it), and each per-layer
metric's reader in `portbench/metrics/<metric>.py`. With `--trace 0` the
line carries the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from the harness's spans, the port's spans and counters and
a `torch.profiler` trace of the window.

The last lines on standard error, and the `checks` key that ends the
result line, give each number compared beside its limit; `correct` is
true when every one is within it. The process exits non-zero, printing no
result, without a CUDA card (or with fewer than the cell asks for), and
when the window has loaded the JAX package or JAX itself.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import List, Optional  # noqa: E402

# whole top-level module names that no run may load: the JAX package is
# `stellar_core_tpu`, a prefix of the port's own name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "stellar_core_tpu")


def forbidden_loaded() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def find_cell(root: str, bench: dict, workload: str):
    """(cell, config, traffic) of `workload`, each read from its file."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit("no workload %r in BENCHMARK.json (%s)"
                         % (workload, ", ".join(sorted(cells))))
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return cell, config, traffic


def metric_reader(root: str, name: str):
    """The `read(ctx)` of `portbench/metrics/<name>.py` under `root`."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, kind: str, workload: str) -> List[dict]:
    """The `end_to_end` or `per_layer` entries that `workload` reports."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


@dataclass
class Context:
    """What a per-layer metric's reader reads."""
    workload: str
    spans: list = field(default_factory=list)          # (name, t0, t1)
    program_spans: list = field(default_factory=list)  # (name, t0, t1, tid)
    staging_before: Optional[dict] = None
    staging_after: Optional[dict] = None
    counts: dict = field(default_factory=dict)
    trace: object = None          # yardstick.devtrace.DeviceTrace
    card: Optional[dict] = None   # yardstick.roofline.card()


def _staging(app) -> Optional[dict]:
    stats = getattr(app.sig_verifier, "stats", None)
    return dict(stats.staging) if stats is not None else None


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, backend: Optional[str] = None) -> dict:
    """Set up, measure and check one run of `workload`; the result line
    without its `device` block. `backend` replaces the configuration's
    verify stack (the CPU tests name "cpu"); runs on the card keep it."""
    from . import core
    bench = load_benchmark(root)
    cell, config, traffic = find_cell(root, bench, workload)
    kind = importlib.import_module("portbench.kinds." + traffic["kind"])
    backend = backend or config["verify_backend"]
    workdir = tempfile.mkdtemp(prefix="portbench-")
    spans = core.Spans()
    try:
        run = kind.Cell(config, traffic, seed, workdir, backend, seconds)
        try:
            ctx = Context(workload)
            ctx.staging_before = _staging(run.app)
            setup_s = time.perf_counter() - _T_START
            on_card = backend.startswith("cuda")
            if trace:
                run.app.tracer.enable()
            if trace and on_card:
                from .yardstick import devtrace, roofline
                ctx.card = roofline.card()
                profiled = devtrace.Profiled()
                with profiled:
                    out = run.window(seconds, spans)
                ctx.trace = profiled.trace
            else:
                out = run.window(seconds, spans)
            if trace:
                run.app.tracer.disable()
                ctx.program_spans = [
                    (s.name, s.t0, s.t0 + (s.dur or 0.0), s.tid)
                    for s in run.app.tracer.spans()]
            ctx.staging_after = _staging(run.app)
            ctx.spans = list(spans.items)
            ctx.counts = out.counts
            memory_peak = None
            if on_card:
                import torch
                memory_peak = int(torch.cuda.max_memory_allocated())
            checks = run.checks()
        finally:
            run.close()
    finally:
        if backend.startswith("cuda"):
            core.set_warmup_plan(None)
        shutil.rmtree(workdir, ignore_errors=True)

    metrics = {}
    if trace:
        for m in cell_metrics(bench, "per_layer", workload):
            v = metric_reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, "end_to_end", workload):
            v = setup_s if m["name"] == "setup_s" \
                else out.end_to_end.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": all(c.ok for c in checks),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics}
    if trace and ctx.trace is not None:
        from .yardstick import devtrace
        named = [(n, a, b) for (n, a, b) in ctx.spans] + \
            [(n, a, b) for (n, a, b, _t) in ctx.program_spans]
        result["breakdown"] = {
            "device_ops": [[k[:80], v] for k, v in sorted(
                ctx.trace.seconds_by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, s] for n, s in devtrace.idle_gaps(
                ctx.trace, named)]}
        result["_busy"] = (ctx.trace.busy_s, ctx.trace.window_s)
    result["_memory_peak"] = memory_peak
    result["_log"] = out.log_lines
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def result_line(result: dict, device: dict):
    """(lines for standard error, the result line) of a `run_cell` result:
    the run's log, then each number compared beside its limit; the line's
    keys in order, `device` with the memory peak (and the traced window's
    busy and total seconds), `checks` last."""
    device = dict(device, memory_peak_bytes=result["_memory_peak"])
    if "_busy" in result:
        device["busy_s"], device["window_s"] = result["_busy"]
    checks = result["checks"]
    err = list(result["_log"]) + [
        "check %s = %s (limit %s)" % (name, c["value"], c["limit"])
        for name, c in checks.items()]
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics")}
    line["device"] = device
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    return err, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    bench = load_benchmark(root)
    cell, _config, _traffic = find_cell(root, bench, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print("portbench: the cell needs %d CUDA card(s); this host has %s"
              % (cell["chips"], torch.cuda.device_count()
                 if torch.cuda.is_available() else "none"), file=sys.stderr)
        return 2

    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print("portbench: the run loaded %s" % ", ".join(bad),
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"]}
    err, line = result_line(result, device)
    for text in err:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
