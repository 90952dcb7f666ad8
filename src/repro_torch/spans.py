"""Spans and counters of the serving path, on the profiler's clock.

  span(name, **attrs)   a context manager: one record from its start to
                        its end, whose parent is the innermost span open
                        around it
  on                    whether a site reached now records: true inside
                        `recording()` and inside a recorded span
  count(name, **values) one point record (start == end); a value may be
                        a tensor on the device, read by `records()`
  call(name, **attrs)   the span of one `ServeEngine.generate` call, which
                        numbers the call: every record made inside it
                        carries that number
  recording()           records everything inside it, with no profiler
  records(), clear(), dropped()   read, empty and account the buffer
  table(recs)           count, host total and self time by name

Records are made only inside `recording()` or while a `torch.profiler` is
recording (`profile.start()` to `stop()`); nothing else switches them
on.  `span()` checks both, and a span that records sets `on` for its
extent.  The sites a decode step runs once a layer or more (`lm.block`
in `lm_decode_step`, `lm.attend`, `lm.dense`) test `on` alone before they
build their attrs or open a span, so off they cost one attribute read
and build nothing; they record only inside a recorded span (the model's
`lm.prefill` or `lm.decode_step`).  Off, `span()` costs one check, the
keyword dict of its attrs and the `with` of one shared no-op object.  A
span never reads a tensor's value and never makes a tensor: its attrs
are Python ints, strings and shapes, so a CUDA-graph capture of a step
is not broken by its spans.  A counter of device values (`moe.route`,
off any graphed path) keeps a tensor the step already made, with no
launch and no wait; `records()` reads it, after the traced slice, as a
reader of a profiled slice does.

Timestamps are `time.time_ns()`: the Unix epoch in ns, the clock of the
profiler's events (`_KinetoEvent.start_ns()`), so the program's records
and the profiler's device records can be joined.  The buffer keeps the
last `LIMIT` records and counts the ones it drops.  Every name starts
with `repro_torch.`.  One thread serves: the stack of open spans is the
process's.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from typing import Deque, Iterator, List, NamedTuple, Optional

import torch

LIMIT = 2 ** 20
_profiling = torch._C._autograd._profiler_enabled


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]     # the id of the innermost span open around it
    call: Optional[int]       # the number of the generate call it is in
    attrs: dict


_buf: Deque[tuple] = collections.deque(maxlen=LIMIT)   # Record's fields
_dropped = 0
_made = 0                     # records made since the process started
on = False                    # inside `recording()` or a recorded span
_stack: List[int] = []        # ids of the open spans, innermost last
_ids = itertools.count(1)
_calls = itertools.count(1)
_call: Optional[int] = None


def active() -> bool:
    """Whether a span opened now is recorded."""
    return on or _profiling()


def _append(rec: tuple) -> None:
    global _dropped, _made
    if len(_buf) == _buf.maxlen:
        _dropped += 1
    _buf.append(rec)
    _made += 1


class _Off:
    """The span of a site while nothing records."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "call", "start", "was_on")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        global on
        self.was_on, on = on, True
        self.id = next(_ids)
        self.parent = _stack[-1] if _stack else None
        self.call = _call
        _stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global on
        end = time.time_ns()
        _stack.pop()
        on = self.was_on
        _append((self.name, self.start, end, self.id, self.parent,
                 self.call, self.attrs))
        return False


def span(name: str, **attrs):
    """A span of the `with` block it opens (OFF when nothing records)."""
    if not (on or _profiling()):
        return OFF
    return _Span(name, attrs)


def count(name: str, **values) -> None:
    """A point record of `values`: Python ints, or tensors left as they
    are until `records()` reads them."""
    if not (on or _profiling()):
        return
    t = time.time_ns()
    _append((name, t, t, next(_ids), _stack[-1] if _stack else None, _call,
             values))


@contextlib.contextmanager
def call(name: str, **attrs) -> Iterator[int]:
    """The span of one generate call, numbered from 1 in the process.  It
    is open whether or not anything records (a profiler may start inside
    it), and is recorded if it made records or ends while recording: the
    cost of a call, not of a site."""
    global _call
    n, prev = next(_calls), _call
    sid, parent = next(_ids), (_stack[-1] if _stack else None)
    made = _made
    _call = n
    _stack.append(sid)
    start = time.time_ns()
    try:
        yield n
    finally:
        end = time.time_ns()
        _stack.pop()
        _call = prev
        if _made > made or active():
            _append((name, start, end, sid, parent, n, attrs))


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record every span and counter inside the block, with no profiler."""
    global on
    was, on = on, True
    try:
        yield
    finally:
        on = was


def records() -> List[Record]:
    """The buffer's records, in the order they ended; a counter's tensors
    read as Python ints or lists of them (a device tensor waits for the
    device)."""
    return [Record(*r[:6], {k: v.tolist() if isinstance(v, torch.Tensor)
                            else v for k, v in r[6].items()}) for r in _buf]


def dropped() -> int:
    """Records the buffer dropped, oldest first, since the last clear."""
    return _dropped


def clear() -> None:
    """Empty the buffer."""
    global _dropped
    _buf.clear()
    _dropped = 0


def table(recs: List[Record]) -> List[tuple]:
    """(name, count, total ms, self ms) of each name among `recs`, by total
    time: self time is a span's less the time its children took (a
    parent's children run one after another).  A counter counts, with no
    time."""
    child = collections.Counter()
    for r in recs:
        if r.parent is not None:
            child[r.parent] += r.end_ns - r.start_ns
    rows = {}
    for r in recs:
        n, total, own = rows.get(r.name, (0, 0, 0))
        d = r.end_ns - r.start_ns
        rows[r.name] = (n + 1, total + d, own + d - child[r.id])
    return sorted(((name, n, total / 1e6, own / 1e6)
                   for name, (n, total, own) in rows.items()),
                  key=lambda row: -row[2])
