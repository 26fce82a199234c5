"""Spans of the host's work on its perf clock, recorded only when asked.

``span(name)`` marks a stretch of the host's work at a layer boundary:
the served program's calls (``EvalProgram.*``), each layer of the eager
chain (``layer.<Class>``), a coupling's split, conditioner and merge
(``coupling.*``), weight norm (``net.weight``) and each kernel wrapper's
launch (``launch.<LAUNCHES key>[.<kernel path>]``: its checks, allocations
and ctypes call, one span per counted launch).  Names are per class, so the
set stays small.

Outside ``recording()`` a span is one shared object that does nothing: no
allocation and no clock read.  Inside it, each span opened on the thread
that started the recording appends ``(name, start_ns, end_ns, parent,
request)`` to the recording's ``Buffer``: times from
``time.perf_counter_ns()``, ``parent`` the index of the enclosing open
span (-1 at the top), ``request`` the id the enclosing request's root span
opened (-1 outside one).  While a ``torch.profiler`` records as well (read
at each outermost span), each span also opens a ``record_function`` of its
name, so the profiler's Chrome trace (``utils/profiling.trace``) shows the
spans.

    with recording() as buf:
        program.log_prob(x)
    buf.counts()             # {span name: spans}
    self_ns(buf.spans)       # each span's time outside its child spans
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter

import torch

CAPACITY = 1 << 21   # spans a recording keeps; past it each further span is counted dropped


class Buffer:
    """One recording: ``spans`` in the order they opened; ``dropped``
    counts the spans not kept (past ``capacity``, or opened on another
    thread); ``requests`` the request ids given out."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans = []
        self.capacity = capacity
        self.dropped = 0
        self.requests = 0
        self.thread = threading.get_ident()
        self.open = []        # indices of the open spans, innermost last
        self.request = -1     # the open request's id
        self.profiler = False  # a profiler records: read at each outermost span

    def counts(self, prefix: str = "") -> Counter:
        """{span name: spans} of the names that start with ``prefix``."""
        return Counter(s[0] for s in self.spans if s[0].startswith(prefix))


class _Off:
    """The span while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_buffer = None    # the recording's Buffer, None while off


class _Span:
    __slots__ = ("buf", "name", "root", "index", "parent", "request", "range", "start")

    def __init__(self, buf: Buffer, name: str, root: bool):
        self.buf, self.name, self.root = buf, name, root

    def __enter__(self):
        self.start = time.perf_counter_ns()   # first: the span holds its own bookkeeping
        buf = self.buf
        if self.root and buf.request < 0:
            buf.request, buf.requests = buf.requests, buf.requests + 1
        else:
            self.root = False   # a root inside a request joins it
        if buf.open:
            self.parent = buf.open[-1]
        else:
            self.parent, buf.profiler = -1, torch.autograd._profiler_enabled()
        self.index, self.request = len(buf.spans), buf.request
        buf.spans.append(None)
        buf.open.append(self.index)
        self.range = None
        if buf.profiler:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        buf = self.buf
        buf.spans[self.index] = (self.name, self.start, end, self.parent, self.request)
        buf.open.pop()
        if self.root:
            buf.request = -1
        return False


def span(name: str, request: bool = False):
    """A context manager over one stretch of the host's work.  With
    ``request`` it is a request's root: outside a request it opens a new
    request id, which every span inside it shares."""
    buf = _buffer
    if buf is None:
        return _OFF
    if len(buf.spans) >= buf.capacity or threading.get_ident() != buf.thread:
        buf.dropped += 1
        return _OFF
    return _Span(buf, name, request)


@contextlib.contextmanager
def recording(capacity: int = CAPACITY):
    """Record spans inside the block; yields the ``Buffer``.  Inside a
    recording it yields that recording's buffer."""
    global _buffer
    if _buffer is not None:
        yield _buffer
        return
    _buffer = Buffer(capacity)
    try:
        yield _buffer
    finally:
        _buffer = None


def self_ns(spans) -> list:
    """Each span's self time: its duration less what its child spans
    cover (children of one thread nest and do not overlap)."""
    out = [end - start for _, start, end, _, _ in spans]
    for _, start, end, parent, _ in spans:
        if parent >= 0:
            out[parent] -= end - start
    return out
