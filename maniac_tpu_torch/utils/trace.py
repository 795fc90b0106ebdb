"""The program's spans and counters: one registry for the process.

Counters are always kept: ``count(name, n)`` adds to a dict entry, and
kernels/build.launch counts every launcher call as ``launch.<launcher>``.
Spans and the timed counters are off by default. ``span(name)`` then
returns one shared no-op context, which records nothing and enters no
``torch.profiler.record_function``.

With ``enable(True)`` each span records a ``Span(name, parent, start,
end)`` in memory (``parent`` the index of the enclosing span in
``spans()``, or None; ``start`` and ``end`` in ``time.perf_counter_ns``
ns) in the order the spans were entered, and kernels/build.launch adds
the host ns it spends in each call to ``launch_ns.<launcher>``. While a
``torch.profiler`` profile is recording, the span also opens a
``record_function`` of its name (``Span.profiled``), so that the spans of
a profiled window are ranges of the profile, on the clock of its device
activities, and each device activity's CUDA correlation id places it in
the span that queued it. Nothing is written out: a reader takes
``spans()`` and ``counters()``.

Span names are dotted by layer (``mc.block``, ``kernels.blockg``,
``energy.pair``). A span covers a call made once a block or once a load,
never a step or a launch: a span costs some 0.5 us off, and with a
profile recording some 15 us, which per step would slow the single chain
(401 launches a block) by several percent; per step and per launch there
are counters.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler


class Span(NamedTuple):
    name: str
    parent: int | None     # index in spans() of the enclosing span
    start: int             # time.perf_counter_ns()
    end: int
    profiled: bool         # a record_function range of a recording profile


_on = False
_counters: dict = {}
_spans: list = []          # Span, or None while the span is open
_open: list = []           # indices into _spans of the open spans
_NOOP = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Turn the spans and the timed counters on or off."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def count(name: str, n: int = 1) -> None:
    """Add n to counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter."""
    return dict(_counters)


def since(before: dict) -> dict:
    """What each counter added after the snapshot ``before`` (an earlier
    counters()), for the counters that moved."""
    return {k: v - before.get(k, 0) for k, v in _counters.items()
            if v != before.get(k, 0)}


def spans() -> list:
    """The finished spans in the order they were entered (an open one is
    left out)."""
    return [s for s in _spans if s is not None]


def reset() -> None:
    """Forget every span and counter."""
    _counters.clear()
    _spans.clear()
    _open.clear()


def span(name: str):
    """A context that records span ``name`` when tracing is on."""
    return _Span(name) if _on else _NOOP


class _Span:
    __slots__ = ("name", "index", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.index = len(_spans)
        _spans.append(None)
        _open.append(self.index)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.pop()
        _spans[self.index] = Span(self.name, _open[-1] if _open else None,
                                  self.start, end, self.rf is not None)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False
