"""Spans and counts of the serving path, on the profiler's clock.

A span is a named interval of one thread's work: its start and end in
``time.time_ns()`` nanoseconds (the clock ``torch.profiler`` stamps its
host and device events with, so spans line up with a device trace
without any probe), its own id and its parent's (the innermost span
open on the same thread when it opened), the front-end batch id ``bid``
(given to a root span, inherited by every span opened under it) and a
small dict of counts.

Spans record only while :func:`enable` is in force or while a
``torch.profiler`` session is collecting. The profiler's own enabled
flag is thread-local and reads False in the serving threads, so the
module-wide flag ``torch.autograd.profiler._is_profiler_enabled`` is
read instead. Whether a span records is decided when it opens. Off,
:func:`span` returns one shared no-op context manager and :func:`count`
returns at once: nothing is allocated.

Recorded spans are kept in memory, the newest :data:`MAX_SPANS`:
:func:`spans` lists them in the order they closed, :func:`drain` also
empties the store.

>>> from repro_torch import tracing
>>> tracing.enable()
>>> with tracing.span("frontend.batch", bid=7) as root:
...     with tracing.span("engine.search_batch"):
...         tracing.count(segments=1)
>>> tracing.disable()
>>> child, parent = tracing.drain()
>>> (child.parent == parent.id, child.bid, child.counts)
(True, 7, {'segments': 1})
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 20

_store: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()
_enabled = False


class Span:
    """One recorded interval; a context manager that records itself on
    exit. ``count`` adds to its counts."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "bid", "counts")
    on = True

    def __init__(self, name: str, parent: Optional["Span"], bid: Optional[int]):
        self.name = name
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.bid = bid if bid is not None or parent is None else parent.bid
        self.counts: Dict[str, object] = {}
        self.start_ns = self.end_ns = 0

    def count(self, **counts) -> None:
        self.counts.update(counts)

    def __enter__(self) -> "Span":
        _stack().append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        _stack().pop()
        _store.append(self)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, bid={self.bid}, "
                f"{(self.end_ns - self.start_ns) / 1e6:.3f} ms, {self.counts})")


class _Off:
    """The span handed out while nothing records."""

    __slots__ = ()
    on = False

    def count(self, **counts) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _recording() -> bool:
    return _enabled or getattr(_profiler, "_is_profiler_enabled", False)


def span(name: str, bid: Optional[int] = None, **counts):
    """A span named ``name`` under this thread's innermost open span
    (``bid``, given to a root span, is inherited by its children), or
    the shared no-op span while nothing records. Use it as a context
    manager; its ``on`` says whether it records."""
    if not _recording():
        return _OFF
    stack = _stack()
    sp = Span(name, stack[-1] if stack else None, bid)
    if counts:
        sp.counts.update(counts)
    return sp


def traced(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(**counts) -> None:
    """Add ``counts`` to this thread's innermost open span, if one
    records."""
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].counts.update(counts)


def enable() -> None:
    """Record spans from now on, profiler or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler session collects."""
    global _enabled
    _enabled = False


def spans() -> List[Span]:
    """The recorded spans, in the order they closed."""
    return list(_store)


def drain() -> List[Span]:
    """The recorded spans, in the order they closed; the store is emptied."""
    out = []
    while _store:
        out.append(_store.popleft())
    return out
