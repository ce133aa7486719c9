"""Spans and counters of the program's stages.

``span(name)`` times a block of host work; ``count(name, n)`` adds to a
counter. Spans are off by default: ``span`` then returns one shared no-op
context, after one check of a module global (no clock reading, no
allocation, no lock). ``enable(True)`` turns them on: each span then keeps
a :class:`Row` (its name, its start and end on the host clock
``time.perf_counter``, its thread's name, and its parent, the innermost span
open on the same thread), and opens
``torch.profiler.record_function("phy:" + name)`` as well, so that a
profiler running at the time holds the span on its own clock beside the
device's kernels and copies. Counters are always on.
``snapshot()`` returns the rows and counters, ``reset()`` clears them.

Spans and counters sit at per-stage, per-batch, per-group, per-segment and
per-flush points, never per query, pair or launch inside a loop. The kernel
modules' launch counters (``ops/_kernels.LaunchCounts``) are
:class:`Counters`, one instance a module.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch

#: the prefix of a span's name in a profiler trace
PREFIX = "phy:"


class Counters:
    """Counts by name, safe across threads. The names given here are listed
    from the start, another name from its first ``add``."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(names, 0)

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            for name in self._counts:
                self._counts[name] = 0


class Row(NamedTuple):
    """A closed span. ``parent`` and ``parent_id`` name the innermost span
    that was open on the same thread when it opened (None at the top)."""

    name: str
    parent: str | None
    thread: str
    t0: float
    t1: float
    id: int
    parent_id: int | None


class _Off:
    """The context ``span`` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_rows: list[Row] = []  # appended whole: list.append holds the GIL
_ids = itertools.count(1)
_local = threading.local()
_counts = Counters()


class _Span:
    __slots__ = ("name", "id", "parent", "t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self)
        self._rf = torch.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._rf.__exit__(*exc)
        _local.stack.pop()
        p = self.parent
        _rows.append(Row(self.name, p and p.name, threading.current_thread().name,
                         self.t0, t1, self.id, p and p.id))
        return False


def span(name: str):
    """A context that times its block as the span ``name`` while spans are
    on, and does nothing while they are off."""
    if not _on:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts.add(name, n)


def enable(on: bool = True) -> None:
    """Turn spans on or off (counters are always on)."""
    global _on
    _on = bool(on)


def snapshot() -> dict:
    """{"spans": the closed spans' rows, "counts": the counters}."""
    return {"spans": list(_rows), "counts": _counts.snapshot()}


def reset() -> None:
    """Forget every row and set every counter to 0."""
    _rows.clear()
    _counts.reset()
