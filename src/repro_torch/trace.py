"""The port's tracer: named spans at the layer boundaries of the engine
(``core/engine.py``), the model's decode (``models/model.py``) and the
serving front end (``serving/frontend.py``), one process-wide buffer of
their records, and one exporter.

Off by default. Off, :func:`span` returns one shared no-op object: no
clock read, no record, no profiler call, nothing on the device. On
(:func:`enable`), a span records its name, start and end
(``time.perf_counter_ns``), the span open around it on the same thread
(its parent), that thread and its attributes, into a bounded buffer (the
oldest records go first). A span that opens while ``torch.profiler`` runs
also opens a ``record_function`` range ``cortex.<name>``, so it lies on
the device trace's timeline beside the kernels it launched and device
idle time can be put down to the innermost span open on the host. With
no profiler running the range is not opened: nothing would record it,
and on the card's host it costs more than the rest of the span.

Spans of one request carry its id: the front end's as ``request=<rid>``,
the engine's as the river's ``agent`` id (``fe<rid>`` under the front
end), a side agent's spawn and merge as its ``parent`` river's id.

The tracer never reads a device value and never synchronises.

    from repro_torch import trace
    trace.enable()
    ...                                   # serve
    trace.export_chrome("trace.json")     # Chrome trace JSON; Perfetto opens it
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import NamedTuple

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

PREFIX = "cortex."              # the profiler range of span ``x`` is ``cortex.x``
MAX_RECORDS = 1 << 18           # the buffer's bound (~50 MB of records at most)


class Record(NamedTuple):
    id: int
    parent: int                 # the id of the span open around it on its thread; 0: none
    name: str
    start_ns: int               # time.perf_counter_ns
    end_ns: int
    thread: int                 # threading.get_native_id()
    attrs: dict


_on = False
_records: deque = deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span handed out while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "t0", "range", "thread")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs):
        """Attributes known only once the span's work is done."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            # the thread's id once: it is a system call, slow on some hosts
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        self.thread = _local.thread
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.range = record_function(PREFIX + self.name) if _profiler._is_profiler_enabled else None
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        _records.append(Record(self.id, self.parent, self.name, self.t0, t1, self.thread, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager timing the block it opens; ``.set(**attrs)`` adds
    attributes before it closes."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def enable() -> None:
    """Turn tracing on."""
    global _on
    _on = True


def disable() -> None:
    """Turn tracing off; the records stay until :func:`clear`."""
    global _on
    _on = False


def records() -> list[Record]:
    """The buffer's records, in the order their spans closed."""
    return list(_records)


def clear() -> None:
    _records.clear()


def export_chrome(path) -> int:
    """Write the records as Chrome trace JSON (complete events, µs; each
    event's ``args`` carry its attributes, ``id`` and ``parent``). Returns
    the number of events written."""
    pid = os.getpid()
    events = [{"name": r.name, "ph": "X", "ts": r.start_ns / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
               "pid": pid, "tid": r.thread, "args": {**r.attrs, "id": r.id, "parent": r.parent}}
              for r in sorted(_records, key=lambda r: r.start_ns)]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f, default=str)
    return len(events)
