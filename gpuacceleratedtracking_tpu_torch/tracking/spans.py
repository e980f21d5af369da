"""Spans of the port's call path, on the profiler's clock.

A span names a phase of a `track_bank` call: the call itself (its root,
`spanned`), and inside `graphs.scan` the load, the prologue, the replays,
the result copies. A span is on only while a torch profiler session records
(``torch.autograd.profiler._is_profiler_enabled``) or inside `recording()`;
off, a span site reads that flag and returns a shared context that does
nothing (`spanned` calls its function straight), so it enters no record
function and reads no clock. On, a span

- enters the profiler's record function in the user scope, as
  ``torch.profiler.record_function(name)`` does, through the binding the
  profiler itself uses for its annotations
  (``torch.autograd._record_function_with_args_enter``: on the host of an
  NVIDIA H100 machine, under a profiler session, ``record_function`` alone
  took 7.5 us and a whole span through the binding 3.4 us; the spans at a
  call's head fall in the card's idle gap between calls). The span lands
  in the profiler's Chrome trace as a ``user_annotation`` event, on the
  clock of the device's kernels and copies, so an idle gap of the card is
  named by the phase the host was in (the trace is the exporter: nothing
  here keeps a list of spans);
- adds to its name's totals (`totals`): the count, the seconds, and the self
  seconds (its seconds less those of the spans opened inside it).

The open spans are one stack: spans are opened on the thread that calls the
entry points.

This module has no counterpart in the JAX package, as `graphs` has none.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, NamedTuple

import torch
from torch.autograd import profiler as _profiler


class Total(NamedTuple):
    """A span name's totals since the last `reset`."""

    count: int
    seconds: float
    self_seconds: float      # less the seconds of the spans opened inside


_OFF = contextlib.nullcontext()
_totals: dict = {}           # name -> [count, seconds, self seconds]
_stack: list = []            # the open spans, innermost last
_recording = 0


class _Span:
    __slots__ = ("name", "handle", "start", "inner")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(self.name)
        self.inner = 0.0
        _stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.start
        _stack.pop()
        if _stack:
            _stack[-1].inner += seconds
        total = _totals.get(self.name)
        if total is None:
            total = _totals[self.name] = [0, 0.0, 0.0]
        total[0] += 1
        total[1] += seconds
        total[2] += seconds - self.inner
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


def span(name: str):
    """A context for the phase ``name``: a span while a profiler session
    records or inside `recording()`, else a shared context that does
    nothing."""
    if not (_profiler._is_profiler_enabled or _recording):
        return _OFF
    return _Span(name)


def spanned(name: str) -> Callable[[Callable], Callable]:
    """A decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_profiler._is_profiler_enabled or _recording):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Spans on inside, with no profiler session (tests, an operator's
    own reading of `totals`)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def totals() -> dict:
    """Each span name's `Total` since the last `reset`."""
    return {name: Total(*t) for name, t in _totals.items()}


def reset() -> None:
    """Clear the totals."""
    _totals.clear()
