"""sctlint: the project's determinism & thread-discipline analyzer.

Copied from `stellar_core_tpu/analysis/` at the commits that each
module's header names (this file at c67d465); carry a fix in either copy
to the other. It lints the port, `stellar_core_tpu_torch/`, with the
port's own allowlist (`analysis/allowlist.txt`, the reference's entries
with their paths pointed at the port's copies), and imports nothing of
the JAX package. Every rule, finding id and message is the reference's,
so the two engines' reports compare finding for finding
(`tests/test_torch_static_analysis.py`); what differs is in
`engine.py`'s header.

The framework's correctness story — per-height header-hash equality
across nodes, seeded chaos soaks, virtual-clock replay — rests on
invariants that generic linters cannot see. This package enforces them
mechanically, as an AST pass with project-specific rules:

- **D1** no wall-clock reads (`time.time` / `time.monotonic` /
  `time.perf_counter` / `datetime.now` / …) outside the clock
  abstraction and the measurement layer: consensus code gets time from
  the injected VirtualClock, so a virtual-clock replay is bit-exact.
- **D2** no unseeded randomness (`random.*` module-level functions,
  argless `random.Random()`, `os.urandom`) outside `util/rnd.py` and
  key generation: chaos runs replay from their seed.
- **T1** thread discipline: call-graph walk from every
  `threading.Thread(target=...)` / `executor.submit(...)` entry point;
  reaching a `@main_thread_only`-marked function (util/threads.py
  registry) is a violation — worker threads hand results to consensus
  via `clock.post_to_main`, never by calling in.
- **E1** no `except Exception: pass` in `scp/`, `herder/`, `ledger/`,
  `bucket/`: consensus code never swallows silently.
- **F1** every fault-site literal (`should_fire("...")`,
  `fire_point("...")`, `check_faults(x, "...")`) must be registered in
  `util.faults.KNOWN_SITES` and cataloged in docs/robustness.md — both
  directions — so the admin endpoint can reject typo'd sites and the
  chaos docs can never rot.
- **M1** every literal metric name registered via `new_counter` /
  `new_meter` / `new_timer` / `new_histogram` must appear in
  docs/metrics.md (dynamic `%s` names by their literal prefix).
- **A1** every `cmd_*` handler in main/command_handler.py has a row in
  the docs/admin.md endpoint table and vice versa.

Plus the native C rules (crules.py — a purpose-built C tokenizer +
call-graph pass over `native/*.c` and `csrc/*.cu`/`*.cuh`, since the
GIL-released pthread engine is invisible to `ast`):

- **N1** no CPython API (`Py*`/`_Py*`) calls reachable with the GIL
  released (pthread worker entries + ALLOW_THREADS brackets; the
  returning `if (...->nopy)` guard idiom honored and required).
- **N2** no `malloc`/`free` family on the cluster-apply hot path —
  per-op buffers go through the per-context bump arenas.
- **N3** every `pthread_mutex_lock` balanced by an unlock on every
  return path (branch-aware structured path analysis).
- **N4** cross-boundary registries: C/Python bail-reason literals ⇄
  the docs/observability.md taxonomy table ⇄ test_apply_cockpit.py,
  and the C `OP_*` table ⇄ the Python `ledger.apply.op.<type>` names.

Intentional exceptions live in `analysis/allowlist.txt`, one line per
(rule, file) with a mandatory justification; stale entries fail the
build. The whole pass runs as tier-1 test
`tests/test_torch_static_analysis.py` and standalone as
`python -m stellar_core_tpu_torch.analysis` (`--native` for the
N-rules-only fast gate). The runtime twin of the N rules is the
ThreadSanitizer leg (tests/test_torch_native_sanitized.py).
See docs/static-analysis.md.
"""

from .engine import (  # noqa: F401
    AllowEntry, AnalysisResult, Finding, LintConfig, default_config,
    load_allowlist, run_analysis,
)
