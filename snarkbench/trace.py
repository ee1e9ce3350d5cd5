"""The traced window: torch.profiler over the window's operations, with
the card's activity alone (kernels, copies and the CUDA runtime's calls,
no CPU operators: recording each of torch's operators on the host slowed
a proof by half), its Chrome trace reduced to device intervals, the
benchmark's own spans and the host's runtime calls, and the readings
every per-layer metric starts from.

Spans are placed by synchronizations: every torch.cuda.synchronize in
the window is one cudaDeviceSynchronize in the trace, the benchmark's
own (one at each end of the window and of each operation) and the
program's (wrapped while the window runs), in the order the host made
them.  The k-th in the trace is matched to the k-th the host stamped,
which gives snarkbench.window, snarkbench.op around each operation, and
snarkbench.sync at each of the program's, which is how a prove's timed
phases are placed: the k-th sync of an operation ends its k-th phase of
`timings`."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
SYNC_NAMES = ("cudaDeviceSynchronize", "cuCtxSynchronize")
# the most by which the host's stamp of a synchronization may lie off
# the trace's, once the two clocks' offset is taken out
SYNC_SLACK_S = 0.01


def merge(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """Events of one traced window, in seconds on the trace's clock; its
    spans are set by `align`."""

    def __init__(self, events):
        self.device, self.host, self.spans = [], [], {}
        self.syncs = {name: [] for name in SYNC_NAMES}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e["dur"]) * 1e-6
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in DEVICE_CATS:
                self.device.append((t0, t1, name))
            elif cat in HOST_CATS:
                self.host.append((t0, t1, name))
                if name in self.syncs:
                    self.syncs[name].append(t1)
        self.device.sort()
        self.host.sort()
        for v in self.syncs.values():
            v.sort()
        self.busy_intervals = merge((a, b) for a, b, _ in self.device)
        self._busy_starts = [a for a, _ in self.busy_intervals]
        self._host_starts = [a for a, _, _ in self.host]

    @property
    def window(self):
        """(start, end) of the snarkbench.window span, or None."""
        w = self.spans.get("snarkbench.window")
        return w[0] if w else None

    def busy(self, lo: float, hi: float) -> float:
        """Seconds in [lo, hi] in which some operation ran on the device."""
        k = max(0, bisect.bisect_right(self._busy_starts, lo) - 1)
        total = 0.0
        for a, b in self.busy_intervals[k:]:
            if a >= hi:
                break
            total += max(0.0, min(b, hi) - max(a, lo))
        return total

    def gaps(self, lo: float, hi: float) -> list:
        """The idle (start, end) stretches of the device in [lo, hi]."""
        out, t = [], lo
        k = max(0, bisect.bisect_right(self._busy_starts, lo) - 1)
        for a, b in self.busy_intervals[k:]:
            if a >= hi:
                break
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < hi:
            out.append((t, hi))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host call running at t, or "python" where none
        is (the interpreter between calls)."""
        k = bisect.bisect_right(self._host_starts, t)
        best = None
        for a, b, name in reversed(self.host[max(0, k - 64):k]):
            if b >= t and (best is None or a > best[0]):
                best = (a, name)
        return best[1] if best else "python"

    def kernel_seconds(self, lo: float, hi: float) -> dict:
        """Device seconds by operation name in [lo, hi]."""
        out: dict = {}
        for a, b, name in self.device:
            if b > lo and a < hi:
                out[name] = out.get(name, 0.0) + min(b, hi) - max(a, lo)
        return out


def phases(trace: Trace, ops) -> list:
    """(label, start, end) of every timed phase: an operation with
    `timings` gets one phase a key, ended by its syncs in order; any
    other operation is one phase labelled by its loop.  An operation
    whose syncs do not match its keys gets none."""
    out = []
    op_spans = trace.spans.get("snarkbench.op", [])
    syncs = [b for _, b in trace.spans.get("snarkbench.sync", [])]
    for op, (a, b) in zip(ops, op_spans):
        if not op.timings:
            out.append((op.label, a, b))
            continue
        ends = [t for t in syncs if a <= t <= b]
        if len(ends) != len(op.timings):
            continue
        t = a
        for key, end in zip(op.timings, ends):
            out.append((key, t, end))
            t = end
    return out


def phase_at(spans, t: float) -> str:
    for label, a, b in spans:
        if a <= t <= b:
            return label
    return "between_ops"


def breakdown(trace: Trace, spans, top: int = 10) -> dict:
    """The device operations that took most time in the window, and the
    idle gaps summed by the phase and the host call they fell in."""
    lo, hi = trace.window
    ops = sorted(trace.kernel_seconds(lo, hi).items(), key=lambda kv: -kv[1])
    idle: dict = {}
    for a, b in trace.gaps(lo, hi):
        mid = (a + b) / 2
        key = f"{phase_at(spans, mid)}:{trace.host_at(mid)}"
        idle[key] = idle.get(key, 0.0) + (b - a)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:top]],
            "idle_gaps": [[n[:160], s] for n, s in gaps[:top]]}


def align(trace: Trace, marks) -> bool:
    """Place the host's synchronizations on the trace's clock and set the
    spans from them.  marks: (label, host seconds after it returned) in
    order, label "window" at each end of the window, "op" at each end of
    an operation, "sync" the program's.  The trace may hold more
    synchronizations than the host made (the profiler's own, before the
    first and after the last): the run of them that keeps the two clocks'
    offset steadiest is taken, and none where it strays by more than
    SYNC_SLACK_S.  Returns whether the spans were set."""
    host = [t for _, t in marks]
    for ends in trace.syncs.values():
        best = None
        for d in range(min(len(ends) - len(host), 16) + 1):
            off = [e - h for e, h in zip(ends[d:], host)]
            stray = max(off) - min(off)
            if best is None or stray < best[0]:
                best = (stray, d)
        if best is None or best[0] > SYNC_SLACK_S:
            continue
        at = ends[best[1]:best[1] + len(host)]
        by = {}
        for (label, _), t in zip(marks, at):
            by.setdefault(label, []).append(t)
        w, o = by.get("window", []), by.get("op", [])
        if len(w) != 2 or len(o) % 2:
            return False
        trace.spans = {"snarkbench.window": [tuple(w)],
                       "snarkbench.op": list(zip(o[::2], o[1::2])),
                       "snarkbench.sync": [(t, t) for t in by.get("sync",
                                                                  [])]}
        return True
    return False


@contextlib.contextmanager
def capture(cuda: bool):
    """Profile the card's activity over the body; yields a dict whose
    "mark" the window calls at each end of itself ("window") and of each
    operation ("op"), and whose "trace" is the Trace once the body has
    ended.  torch.cuda.synchronize is wrapped meanwhile, so that the
    program's synchronizations are stamped too.  Without a card nothing
    is profiled and the trace is empty."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    real_sync = torch.cuda.synchronize
    marks: list = []

    def mark(label, *args, **kwargs):
        if cuda:
            real_sync(*args, **kwargs)
        marks.append((label, time.perf_counter()))

    def program_sync(*args, **kwargs):
        mark("sync", *args, **kwargs)

    box: dict = {"mark": mark}
    prof = profile(activities=[ProfilerActivity.CUDA]) if cuda else \
        contextlib.nullcontext()
    with prof:
        torch.cuda.synchronize = program_sync
        try:
            mark("window")
            yield box
            mark("window")
        finally:
            torch.cuda.synchronize = real_sync
    trace = Trace([])
    if cuda:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                trace = Trace(json.load(fh)["traceEvents"])
        finally:
            os.remove(path)
    align(trace, marks)
    box["trace"] = trace
