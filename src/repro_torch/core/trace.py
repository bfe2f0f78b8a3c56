"""Spans of the port's layers, on the profiler's clock.

A span is a named stretch of host time with the span that encloses it
(``parent``) and, where it belongs to one request, the request's id
(``req``).  Its ends are read with ``time.time_ns()``, the clock of the
profiler's host events, so spans and a profiler's trace of the same work
line up.  With ``device=True`` on the card a span also records two timing
``torch.cuda.Event``s on the current stream, read as ``device_ms`` by
:func:`spans`.

Tracing is on inside :func:`recording` and while a torch profiler records
in this thread (a ``torch.profiler.profile`` block, or the calls it makes).
While it is off, :func:`span` costs one check and returns a shared no-op
context: it enters no ``record_function``, records no CUDA event and
allocates nothing.  While it is on, each span also enters
``torch.profiler.record_function(name)``, so that it is a host event in
the profiler's trace beside the kernels it launched.

Spans stay in memory, at most ``MAX_SPANS`` of them (later ones are
counted by :func:`dropped`); :func:`spans` reads them without clearing, so
several readers can read one store, and :func:`clear` empties it.  A span
inside a body that a CUDA graph captures runs at the capture only: a
replay runs no host code.  Spans are named ``<layer>.<region>``; README.md
lists the port's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional

import torch
from torch._C._autograd import _profiler_enabled

#: spans the store keeps; later ones are dropped and counted
MAX_SPANS = 100_000


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int = 0
    id: int = 0
    parent: Optional[int] = None     # the enclosing span's id
    req: Optional[int] = None        # the request all its spans share
    device_ms: Optional[float] = None
    _events: Optional[tuple] = dataclasses.field(default=None, repr=False)


_store: List[Span] = []
_dropped = 0
_recording = 0
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether spans are recorded now."""
    return _recording > 0 or _profiler_enabled()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside this block, with or without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def _open() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(s: Span) -> None:
    global _dropped
    if len(_store) < MAX_SPANS:
        _store.append(s)
    else:
        _dropped += 1


class _Span:
    """One span while it is open."""

    def __init__(self, name: str, req: Optional[int], device: bool):
        self.name, self.req, self.device = name, req, device

    def __enter__(self) -> Span:
        stack = _open()
        self.span = s = Span(self.name, 0, id=next(_ids), req=self.req,
                             parent=stack[-1].id if stack else None)
        if (self.device and torch.cuda.is_available()
                and not torch.cuda.is_current_stream_capturing()):
            s._events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
        self.rf = torch.profiler.record_function(self.name)
        s.start_ns = time.time_ns()
        self.rf.__enter__()
        if s._events:
            s._events[0].record()
        stack.append(s)
        return s

    def __exit__(self, *exc) -> None:
        s = self.span
        if s._events:
            s._events[1].record()
        self.rf.__exit__(*exc)
        s.end_ns = time.time_ns()
        _open().pop()
        _keep(s)


def span(name: str, *, req: Optional[int] = None, device: bool = False):
    """A context that records ``name`` while tracing is on (module doc);
    ``device`` asks for the device time between its ends, on the card and
    outside a capture."""
    if not enabled():
        return _OFF
    return _Span(name, req, device)


def interval(name: str, start_ns: int, end_ns: int, *,
             req: Optional[int] = None) -> None:
    """Record a span that has ended (a wait no block encloses), under the
    span open now, while tracing is on."""
    if not enabled():
        return
    stack = _open()
    _keep(Span(name, start_ns, end_ns, id=next(_ids), req=req,
               parent=stack[-1].id if stack else None))


def spans() -> List[Span]:
    """The kept spans in the order they ended, each with its ``device_ms``
    (one synchronize where any is still to be read)."""
    pending = [s for s in _store if s._events]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            s._events = None
    return list(_store)


def dropped() -> int:
    """Spans not kept since the last :func:`clear`: the store was full."""
    return _dropped


def clear() -> None:
    global _dropped
    _store.clear()
    _dropped = 0


def self_ns(kept: Iterable[Span]) -> Dict[int, int]:
    """Each span's duration less the part of its interval that its
    children cover (their union, clipped to it), by span id."""
    kept = list(kept)
    children: Dict[int, List[Span]] = {}
    for s in kept:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    out = {}
    for s in kept:
        covered, end = 0, s.start_ns
        for c in sorted(children.get(s.id, ()), key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, end), min(c.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                end = hi
        out[s.id] = s.end_ns - s.start_ns - covered
    return out
