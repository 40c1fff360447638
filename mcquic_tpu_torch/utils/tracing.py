"""Spans of the port's own work, recorded while `torch.profiler` records.

    with tracing.span("engine.encodeDispatch", images=10) as record:
        ...                   # record is None unless a profiler records
    tracing.spans()           # the finished spans, oldest first
    tracing.clear()

There is no switch of its own: a span records only while a `torch.profiler`
(or `torch.autograd.profiler`) session is recording somewhere in the
process, on any thread. Otherwise `span` reads one flag and returns a shared
`nullcontext`, allocating nothing. A span is not a profiler annotation
(`record_function`, NVTX): kineto repeats those on the device's timeline,
where they would read as device work.

A span holds its name, its start and end in integer ns of `time.time_ns()`,
which is the clock the profiler stamps its events with, CUPTI's device
activities included (Unix-epoch ns on Linux), so a span compares directly
with the trace's intervals; its own id; the id of the span that caused it
(the `parent` handed in, on this thread or another); the id of the batch or
call it belongs to, shared by every span of that batch across threads (a
span with no parent starts one); the OS id of its thread; and the counts
handed in (`images`, `bytes`, `tokens`). Finished spans go into a buffer of
the last `CAPACITY`.

The spans, each read by a benchmark metric (`perfbench/layers/`) and by
`utils/profiling.py::report` (per name: time, counts and their rates, the
threads; per batch: its first start to its last end):
  * `engine.encodeDispatch`, `engine.decodeDispatch`: pad, upload, enqueue
    the model and start the download of one batch (`models/engine.py`);
  * `engine.ransEncode` (on `compressMany`'s worker thread, its parent the
    batch's `encodeDispatch`), `engine.ransDecode`: the host rANS of a batch;
  * `generator.sampleCodes`: the host's enqueue of the whole level loop,
    with no synchronize (`models/generator.py`).
"""
import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch.autograd.profiler as _profiler

CAPACITY = 1 << 16

__all__ = ["Span", "span", "spans", "clear", "CAPACITY"]


class Span:
    """One span; `end` is None while it is open."""
    __slots__ = ("name", "start", "end", "id", "parent", "batch", "thread", "counts")

    def __init__(self, name: str, start: int, end: Optional[int], ident: int,
                 parent: Optional[int], batch: int, thread: int, counts: Dict[str, int]):
        self.name, self.start, self.end = name, start, end
        self.id, self.parent, self.batch, self.thread = ident, parent, batch, thread
        self.counts = counts


_OFF = contextlib.nullcontext()
_finished: deque = deque(maxlen=CAPACITY)
_ids = itertools.count(1)


def span(name: str, parent: Optional[Span] = None, **counts: int):
    """A context manager that records a span while a profiler records and
    yields it (None otherwise). `parent`: the span whose work caused this
    one, such as a batch's dispatch for its rANS on a worker thread."""
    # the module's flag: `torch.autograd._profiler_enabled()` reads False on
    # a thread other than the one that started the profiler
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name, parent, counts)


@contextlib.contextmanager
def _recorded(name: str, parent: Optional[Span], counts: Dict[str, int]):
    ident = next(_ids)
    record = Span(name, 0, None, ident, None if parent is None else parent.id,
                  ident if parent is None else parent.batch, threading.get_native_id(), counts)
    record.start = time.time_ns()
    try:
        yield record
    finally:
        record.end = time.time_ns()
        _finished.append(record)


def spans() -> List[Span]:
    """The finished spans, oldest first."""
    return list(_finished)


def clear():
    _finished.clear()
