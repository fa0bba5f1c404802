"""Device tracing helpers (SURVEY §5 "Tracing / profiling").

Thin, dependency-free wrappers over ``jax.profiler``: a context manager
that captures a Perfetto/TensorBoard trace of everything dispatched
inside it, and annotation helpers that name regions/stacks in the trace.
The quantitative per-stage accounting lives in ``bench/roofline.py``;
this module is for *looking* at a schedule when the numbers surprise you.

Usage::

    from pysfm_tpu.utils import trace

    with trace.capture("/tmp/ba_trace"):
        solve(problem, cfg)         # then open in Perfetto / TensorBoard

    with trace.annotate("build_normal_equations"):
        eqs = build(...)            # named region inside a capture
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import jax


@contextlib.contextmanager
def capture(log_dir: str) -> Iterator[None]:
    """Capture a device trace of the enclosed dispatches into ``log_dir``
    (viewable in TensorBoard's profile plugin or ui.perfetto.dev)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region for the trace timeline (nests)."""
    return jax.profiler.TraceAnnotation(name)


def annotate_fn(fn, name: str | None = None):
    """Wrap ``fn`` so every call shows up as a named trace region."""
    label = name or getattr(fn, "__name__", "fn")

    def wrapped(*a, **kw):
        with jax.profiler.TraceAnnotation(label):
            return fn(*a, **kw)

    return wrapped
