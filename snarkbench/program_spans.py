"""The port's own spans (wasmsnark_tpu_torch/utils/spans.py), read after a
traced window: grouped by the window's operations, placed on the device
trace's clock, and reduced to the readings of the metrics that read them.

The port records spans only while a profiler session is active, so only
a traced window has them.  A span's start and end are on the host's
perf_counter, the clock of Op.t0 and Op.t1; an operation's offset onto
the trace's clock is its own (the trace's snarkbench.op start minus
Op.t0), so that the drift between the two clocks over a window does not
add up.  Where the port has no spans (a commit before them, an untraced
run, a stand-in program) every reading is None."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
import sys

SPANS_MODULE = "wasmsnark_tpu_torch.utils.spans"


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: int | None
    t0: float         # seconds, host clock (or the trace's, once placed)
    t1: float
    launches: int

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class OpSpans:
    """One operation of the window and the span trees that ran inside it;
    offset: the operation's host-to-trace offset, None without a trace."""
    op: object
    spans: list
    offset: float | None = None

    def named(self, *names, under: str | None = None) -> list:
        """The spans with one of these names, where `under` is given only
        those with an ancestor of that name."""
        by = {s.id: s for s in self.spans}

        def below(s):
            p = by.get(s.parent)
            while p is not None:
                if p.name == under:
                    return True
                p = by.get(p.parent)
            return False

        return [s for s in self.spans if s.name in names
                and (under is None or below(s))]

    def seconds(self, *names, under: str | None = None):
        """The summed seconds of those spans, None where there are none."""
        found = self.named(*names, under=under)
        return sum(s.seconds for s in found) if found else None

    def placed(self) -> list:
        """The spans on the trace's clock."""
        return [dataclasses.replace(s, t0=s.t0 + self.offset,
                                    t1=s.t1 + self.offset)
                for s in self.spans]


def recorded() -> list:
    """The port's recorded spans, in seconds; none where the port has not
    loaded its spans module (nothing imports it for this)."""
    mod = sys.modules.get(SPANS_MODULE)
    if mod is None:
        return []
    return [Span(s.name, s.id, s.parent, s.t0 * 1e-9, s.t1 * 1e-9,
                 s.launches) for s in mod.recorded()]


def op_offsets(rec) -> list:
    """(offset at the start, offset at the end) of each of the window's
    operations onto the trace's clock, None each without a trace."""
    op_spans = rec.trace.spans.get("snarkbench.op", []) \
        if rec.trace is not None else []
    out = [(a - op.t0, b - op.t1) for op, (a, b) in zip(rec.ops, op_spans)]
    return out + [None] * (len(rec.ops) - len(out))


def by_op(rec, spans=None) -> list:
    """An OpSpans for each operation that returned and holds a top span
    (one whose parent is not recorded); a span tree belongs to the
    operation whose host interval holds its top span."""
    spans = recorded() if spans is None else spans
    ids = {s.id for s in spans}
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    tops = sorted((s for s in spans if s.parent not in ids),
                  key=lambda s: s.t0)
    starts = [s.t0 for s in tops]
    out = []
    for op, off in zip(rec.ops, op_offsets(rec)):
        if op.error is not None:
            continue
        k = bisect.bisect_left(starts, op.t0)
        mine = []
        while k < len(tops) and tops[k].t1 <= op.t1:
            todo = [tops[k]]
            while todo:
                s = todo.pop()
                mine.append(s)
                todo.extend(kids[s.id])
            k += 1
        if mine:
            out.append(OpSpans(op, sorted(mine, key=lambda s: s.id),
                               off[0] if off else None))
    return out


def median_over_ops(rec, fn):
    """The median over the window's operations of fn(OpSpans), where it
    is not None; None where it never is."""
    vals = [v for v in (fn(o) for o in by_op(rec)) if v is not None]
    return statistics.median(vals) if vals else None


def segments(spans) -> list:
    """(start, end, span) of each stretch in which `span` is the innermost
    one open, in order (spans properly nested, siblings disjoint)."""
    ids = {s.id for s in spans}
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    out = []

    def walk(s):
        t = s.t0
        for c in sorted(kids[s.id], key=lambda c: c.t0):
            if c.t0 > t:
                out.append((t, c.t0, s))
            walk(c)
            t = max(t, c.t1)
        if s.t1 > t:
            out.append((t, s.t1, s))

    for top in sorted((s for s in spans if s.parent not in ids),
                      key=lambda s: s.t0):
        walk(top)
    return out


def self_seconds(spans) -> dict:
    """Each span's self time by id: its duration less what its children
    cover."""
    out = dict.fromkeys((s.id for s in spans), 0.0)
    for a, b, s in segments(spans):
        out[s.id] += b - a
    return out


def idle_by_span(trace, o: OpSpans) -> dict:
    """The device's idle seconds inside an operation's top spans, by the
    name of the innermost program span open at each gap's midpoint
    (None without an offset)."""
    if o.offset is None:
        return None
    placed = o.placed()
    segs = segments(placed)
    starts = [a for a, _, _ in segs]
    ids = {s.id for s in placed}
    out: dict = {}
    for top in (s for s in placed if s.parent not in ids):
        for a, b in trace.gaps(top.t0, top.t1):
            k = bisect.bisect_right(starts, (a + b) / 2) - 1
            name = segs[k][2].name if k >= 0 else top.name
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def busy_in(trace, o: OpSpans, name: str):
    """The device's busy seconds inside the operation's spans of this name
    on the trace's clock (None without an offset or such spans)."""
    found = o.named(name)
    if o.offset is None or not found:
        return None
    return sum(trace.busy(s.t0 + o.offset, s.t1 + o.offset) for s in found)
