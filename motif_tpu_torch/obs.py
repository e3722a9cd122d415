"""Spans and counters: what an operator reads of the running program.

A span, `span(name, **attrs)`, names a block of host code. It is off
unless a torch profiler is recording, and then costs one flag read: every
caller gets the same no-op, with no clock read and no profiler range.
Under a profiler it opens `torch.profiler.record_function(name)`, a user
annotation on the profiler's timeline beside the device's work, and when
it closes it appends a record to a bounded buffer (`spans()`, `clear()`):
its name, `start` and `end` by `time.perf_counter_ns`, its `id`, its
`parent`'s id, the id of the `request` it serves (the outermost span open
around it, or itself) and its `attrs` (`set` adds to them while it is
open). A full buffer drops its oldest record and counts the drop
(`obs.spans_dropped`).

Counters, `count(name, n)` and `counters()`, are plain integer adds and
always on. The kernels' launches are counters too: `launch` counts
`kernels.launches.<kernel>` and `kernels.launches.<kernel>/<entry>`. A
CUDA-graph capture records launches without making them: inside
`recording()` each `launch` goes to a tape instead, and
`count_replay(tape)` counts the tape once per replay of the graph.

Inside a CUDA-graph replay no host code runs, so no span can time a part
of it. Marks do: `part(name)` is the span `motif.<name>`, and inside
`marking(names)` it also records the part's start and end timing events on
the current stream, which a capture makes nodes of its graph; after a
replay `Marks.elapsed` reads the milliseconds of each part the graph
recorded, by name.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

CAPACITY = 16384                 # records the span buffer holds
LAUNCHES = "kernels.launches."   # the prefix of the launch counters

_profiler = torch.autograd.profiler
_range = torch.profiler.record_function
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_counters: dict[str, int] = {}
_ids = itertools.count(1)
_open = threading.local()        # each thread's stack of open span records
_tape: dict | None = None
_marks = None                    # the active Marks


class _Off:
    """The span of every caller while no profiler records."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class _Span:
    __slots__ = ("rec", "_range")

    def __init__(self, name: str, attrs: dict):
        self.rec = {"name": name, "attrs": attrs}

    def __enter__(self):
        stack = _stack()
        rec, parent = self.rec, (stack[-1] if stack else None)
        rec["id"] = next(_ids)
        rec["parent"] = parent["id"] if parent else None
        rec["request"] = parent["request"] if parent else rec["id"]
        self._range = _range(rec["name"])
        self._range.__enter__()
        rec["start"] = time.perf_counter_ns()
        stack.append(rec)
        return self

    def __exit__(self, *exc):
        self.rec["end"] = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _stack().pop()
        if len(_records) == CAPACITY:
            count("obs.spans_dropped")
        _records.append(self.rec)
        return False

    def set(self, **attrs) -> None:
        self.rec["attrs"].update(attrs)


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def enabled() -> bool:
    """Whether spans record: a torch profiler is recording."""
    return _profiler._is_profiler_enabled


def span(name: str, **attrs):
    """A context manager: the span `name` when a profiler records, else the
    shared no-op."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name, attrs)


def spans() -> list:
    """The buffer's records, oldest first."""
    return list(_records)


def clear() -> None:
    _records.clear()


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    return dict(_counters)


def reset(prefix: str) -> None:
    """Drop every counter whose name starts with `prefix`."""
    for name in [k for k in _counters if k.startswith(prefix)]:
        del _counters[name]


def launch(kernel: str, entry: str) -> None:
    """One launch of `kernel` through its entry `entry` (on the tape of
    `recording`, inside one)."""
    key = f"{kernel}/{entry}"
    if _tape is not None:
        _tape[key] = _tape.get(key, 0) + 1
        return
    count(LAUNCHES + kernel)
    count(LAUNCHES + key)


@contextlib.contextmanager
def recording():
    """Around a CUDA-graph capture: yields a tape ({kernel/entry:
    launches}) that every `launch` inside adds to, instead of the
    counters."""
    global _tape
    outer, _tape = _tape, {}
    try:
        yield _tape
    finally:
        _tape = outer


def count_replay(tape: dict) -> None:
    """One replay of a graph whose capture recorded `tape`."""
    for key, n in tape.items():
        count(LAUNCHES + key.split("/", 1)[0], n)
        count(LAUNCHES + key, n)


class Marks:
    """The start and end timing events of each named part, and the parts
    whose end `part` recorded (after their start)."""

    def __init__(self, names):
        self.events = {n: (torch.cuda.Event(enable_timing=True, external=True),
                           torch.cuda.Event(enable_timing=True, external=True))
                       for n in names}
        self.ended: set = set()

    def elapsed(self) -> dict:
        """{part: milliseconds from its start to its end} for each part
        whose two events were recorded."""
        return {n: a.elapsed_time(b) for n, (a, b) in self.events.items()
                if n in self.ended}


@contextlib.contextmanager
def marking(names):
    """Make `part(name)` record the start and end of each of `names` on
    new timing events; yields their `Marks`. Each event is recorded once
    here, so that it exists before a capture, which then makes every later
    record of it a node of its graph (`external`)."""
    global _marks
    marks = Marks(names)
    for pair in marks.events.values():
        for e in pair:
            e.record()
    outer, _marks = _marks, marks
    try:
        yield marks
    finally:
        _marks = outer


def part(name: str):
    """A context manager: the part `name` of MoTIF's forward, the span
    `motif.<name>`, which inside `marking` of that name also records the
    part's start and end events."""
    if _marks is None or name not in _marks.events:
        return span("motif." + name)
    return _marked(_marks, name)


@contextlib.contextmanager
def _marked(marks: Marks, name: str):
    """A part inside `marking`: its start event, its span, its end event
    (none where the part raised)."""
    start, end = marks.events[name]
    start.record()
    with span("motif." + name) as sp:
        yield sp
    end.record()
    marks.ended.add(name)
