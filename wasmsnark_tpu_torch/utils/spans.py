"""Spans: the port's one tracing mechanism.

    with span("msm.sort"):
        ...

A span records its name, a numeric id and its parent's id (the span open
around it when it started, so that the spans of one proof or one batch
form a tree under its top span), its start and end on
time.perf_counter_ns() (the clock of time.perf_counter()), and the port's
kernel launches between the two (the change in ops/cuda_lib's counters).

Recording is on exactly while a torch profiler session is active
(torch.autograd._profiler_enabled()).  At every other time span() returns
one shared context that does nothing, so a span off costs one check.
Recorded spans stay in memory, in a buffer of bounded size that counts
the spans it drops (the oldest first); recorded() reads it without
emptying it.  The open spans are one stack: spans nest within one thread,
as the prover and the verifier run.

A caller that needs a duration whether or not recording is on (the
prover's phase `timings`) passes `into=(dict, key)`: the span is then
timed always, and on leaving it without an exception synchronizes the
`sync` device (a CUDA one; torch.cuda.synchronize, looked up at the call)
before its end is stamped, and writes its seconds to dict[key].  It is
recorded only while recording is on, like any other.
"""

from __future__ import annotations

import collections
import itertools
import time

import torch

from ..ops import cuda_lib

CAPACITY = 1 << 16

_enabled = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns


# what recorded() gives of a span; the buffer keeps the same values in a
# plain tuple, which the garbage collector stops tracking (it does not stop
# tracking a tuple subclass), so that a full buffer adds nothing to its
# passes over a large heap
Record = collections.namedtuple(
    "Record", ("name", "id", "parent", "t0", "t1", "launches"))


class Buffer:
    """The recorded spans, at most `capacity` of them: past it, each new
    span pushes out the oldest and adds one to `dropped`."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans = collections.deque(maxlen=capacity)
        self.dropped = 0

    def add(self, sp) -> None:
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(sp)


BUFFER = Buffer()
_ids = itertools.count(1)
_open: list = []          # ids of the recording spans open, innermost last


def _launches() -> int:
    return sum(cuda_lib.launches.values())


class Span:
    """One span: name, id, parent (None at the top), t0 and t1 in
    nanoseconds, launches.  id is None where it is not recorded."""

    __slots__ = ("name", "id", "parent", "t0", "t1", "launches", "_rec",
                 "_sync", "_into", "_l0")

    def __init__(self, name: str, rec: bool, sync=None, into=None):
        self.name, self._rec, self._sync, self._into = name, rec, sync, into
        self.id = self.parent = None
        self.launches = 0

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def __enter__(self):
        if self._rec:
            self.id = next(_ids)
            self.parent = _open[-1] if _open else None
            _open.append(self.id)
            self._l0 = _launches()
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, *exc):
        ok = exc_type is None
        if ok and self._sync is not None and self._sync.type == "cuda":
            torch.cuda.synchronize(self._sync)
        self.t1 = _clock()
        if ok and self._into is not None:
            d, key = self._into
            d[key] = self.seconds
        if self._rec:
            self.launches = _launches() - self._l0
            _open.pop()
            BUFFER.add((self.name, self.id, self.parent, self.t0, self.t1,
                        self.launches))
        return False


class _Off:
    """The shared context of a span that is neither recorded nor timed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, sync=None, into=None):
    """The context of one span (see the module's docstring)."""
    rec = _enabled()
    if not rec and into is None:
        return _OFF
    return Span(name, rec, sync, into)


def recorded() -> list:
    """The Records the buffer holds, oldest first (it stays as it is)."""
    return [Record._make(r) for r in BUFFER.spans]
