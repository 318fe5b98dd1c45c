"""Named host spans of a sweep: seconds into the sweep's ``stats``, and
a host-op range in a profiler's trace.

``with span(name, key):`` adds the body's seconds to ``stats[key]`` of
the sweep this thread runs (:class:`sweep`; ``key=None``: a range only)
and opens a host-op range ``name``.  The range is a function-scope
record (``torch._C._profiler._RecordFunctionFast``), a ``cpu_op`` in the
trace on the same clock as its device records, and never a user
annotation, which the profiler mirrors with device-side records of the
same name.  It shows only while a profiler records; otherwise it costs
the record's own check.  A span's parent in the trace is the range that
encloses it.
"""

from __future__ import annotations

import contextvars
import time

import torch

_Range = torch._C._profiler._RecordFunctionFast

#: The ``stats`` of the sweep running in this thread (or task), where its
#: spans and counters add; ``None`` outside a sweep.
_STATS: contextvars.ContextVar = contextvars.ContextVar("sweep_stats",
                                                        default=None)


class span:
    """``with span(name, key, into):`` times the body into
    ``into[key]`` (default: the current sweep's ``stats``; nothing where
    ``key`` is ``None`` or no sweep runs) under the host range ``name``.
    :attr:`start` is the body's start on ``time.perf_counter``."""

    __slots__ = ("_range", "_into", "_key", "start")

    def __init__(self, name: str, key: str | None = None,
                 into: dict | None = None):
        self._range = _Range(name)
        if into is None and key is not None:
            into = _STATS.get()
        self._key, self._into = key, into

    def __enter__(self) -> "span":
        self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.start
        self._range.__exit__(*exc)
        if self._into is not None:
            self._into[self._key] += dt


class sweep(span):
    """The span of a whole sweep: ``stats`` becomes, for the body, the
    dict that the spans and counters opened inside it add to."""

    __slots__ = ("_token",)

    def __init__(self, name: str, key: str, stats: dict):
        super().__init__(name, key, stats)

    def __enter__(self) -> "sweep":
        self._token = _STATS.set(self._into)
        return super().__enter__()

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        _STATS.reset(self._token)


def count(key: str, n: float = 1.0) -> None:
    """Add ``n`` to ``stats[key]`` of the current sweep, if one runs."""
    stats = _STATS.get()
    if stats is not None:
        stats[key] += n
