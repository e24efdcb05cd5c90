"""The port's spans: where a prove or a keygen spends its time, on the
host clock.

``with span(name, **counts):`` records one span when the block exits: an
id, the id of its parent (the enclosing span on the same thread, or the
span handed over to a worker thread by ``carry``), a request id (given to
a request's top span, ``span(name, request=...)``, and inherited by every
span under it), the name, the thread's ident and name, start and end on
``time.perf_counter()`` (the clock a profiler trace is mapped onto), and
the counts given (bytes, segments, ...: the dict ``span.counts``, which
the block may add to).

Records go into a bounded ring of RING records, oldest dropped first;
``spans()`` returns a snapshot, in the order the spans ended. A full
snapshot may have lost records older than its first. ``time.perf_counter()``
is the host's CLOCK_MONOTONIC on Linux, one clock for every process of the
host, so the records of a chunk worker's process (runtime/worker.py,
``GET /spans``) line up with the coordinator's.
Recording is always on: a span costs a few microseconds, and a chunk prove
records about 280.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple

RING = 1 << 16

_RING: collections.deque = collections.deque(maxlen=RING)
_IDS = itertools.count(1)  # next() on a count is atomic in CPython
_LOCAL = threading.local()  # .stack: the open spans' (id, request)


class Record(NamedTuple):
    id: int
    parent: int  # 0: none
    request: str  # None: none
    name: str
    thread: int
    thread_name: str
    start: float
    end: float
    counts: dict


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class span:
    """Context manager recording one span; see the module docstring."""

    __slots__ = ("name", "request", "counts", "id", "parent", "start")

    def __init__(self, name: str, request: str = None, **counts):
        self.name, self.request, self.counts = name, request, counts

    def __enter__(self) -> "span":
        stack = _stack()
        self.parent, inherited = stack[-1] if stack else (0, None)
        if self.request is None:
            self.request = inherited
        self.id = next(_IDS)
        stack.append((self.id, self.request))
        self.start = time.perf_counter()
        return self

    def tag(self, request: str) -> None:
        """Give the open span its request id, and the spans opened under it
        from now on: for a request whose id is known only once its body is
        read."""
        self.request = request
        stack = _stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == self.id:
                stack[i] = (self.id, request)
                break

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        _stack().pop()
        t = threading.current_thread()
        _RING.append(Record(self.id, self.parent, self.request, self.name,
                            t.ident, t.name, self.start, end, self.counts))


def carry(fn, parent: span = None, request: str = None):
    """`fn` wrapped to run, on whatever thread calls it, under `parent` (an
    open span; by default the calling thread's innermost) and its request,
    or under `request` where given: for work handed to a worker thread."""
    if parent is not None:
        handed = (parent.id, parent.request)
    else:
        stack = _stack()
        handed = stack[-1] if stack else (0, None)
    if request is not None:
        handed = (handed[0], request)

    def run(*args, **kwargs):
        stack = _stack()
        stack.append(handed)
        try:
            return fn(*args, **kwargs)
        finally:
            stack.pop()
    return run


def spans() -> list:
    """A snapshot of the ring, oldest record first."""
    while True:
        try:
            return list(_RING)
        except RuntimeError:  # another thread appended while it was copied
            continue
