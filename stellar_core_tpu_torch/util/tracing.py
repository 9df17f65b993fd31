"""Tracer guards: spans and instants against a possibly-absent tracer.

Copied (`_NoopSpan`, `tracer_span`, `tracer_instant`) from
`stellar_core_tpu/util/tracing.py` at commit 02ed56d; carry a fix in
either copy to the other. The `Tracer` itself (its ring buffer, Chrome
export and flight recorder) arrives with the node-stack slice; until then
any object with `enabled`, `span(name, cat, **tags)` and
`instant(name, cat, **tags)` serves (and `_stack()`, the open spans, for
the fault injector). A `None` or disabled tracer is a
no-op.
"""

from __future__ import annotations


class _NoopSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_tag(self, key: str, value) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


def tracer_span(tracer, name: str, cat: str = "core", **tags):
    """A span against a possibly-absent, possibly-disabled tracer."""
    if tracer is None or not tracer.enabled:
        return _NOOP
    return tracer.span(name, cat, **tags)


def tracer_instant(tracer, name: str, cat: str = "core", **tags) -> None:
    if tracer is not None and tracer.enabled:
        tracer.instant(name, cat, **tags)
