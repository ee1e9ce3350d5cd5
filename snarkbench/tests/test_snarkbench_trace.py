"""The trace's reduction: device busy time and idle gaps, the spans
placed by the synchronizations, the prover's phases placed by its syncs,
the breakdown; and the capture's marks."""

import pytest
import torch

from snarkbench import trace as tr
from snarkbench.cell import Op


def _ev(cat, name, t0, t1):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0 * 1e6,
            "dur": (t1 - t0) * 1e6}


def _sync(t):
    return _ev("cuda_runtime", "cudaDeviceSynchronize", t - 0.05, t)


def _r(spans):
    return [tuple(round(x, 6) for x in s) for s in spans]


# the host's stamps: the window, one operation with two program syncs
MARKS = [("window", 100.0), ("op", 101.0), ("sync", 103.0), ("sync", 107.0),
         ("op", 109.0), ("window", 110.0)]


def _trace(extra=()):
    """The trace's clock runs 100 s behind the host's."""
    ev = [_sync(t - 100) for _, t in MARKS] + list(extra)
    ev += [_ev("kernel", "k1", 1.5, 2.5), _ev("kernel", "k2", 2.0, 3.0),
           _ev("kernel", "k1", 4.0, 5.0), _ev("gpu_memcpy", "copy", 6.0, 6.5),
           _ev("cuda_runtime", "cudaLaunchKernel", 3.9, 4.0),
           _ev("cuda_runtime", "cudaMemcpyAsync", 7.5, 8.5)]
    t = tr.Trace(ev)
    assert tr.align(t, MARKS)
    return t


def test_spans_from_syncs():
    t = _trace()
    assert _r([t.window]) == [(0.0, 10.0)]
    assert _r(t.spans["snarkbench.op"]) == [(1.0, 9.0)]
    assert _r(t.spans["snarkbench.sync"]) == [(3.0, 3.0), (7.0, 7.0)]
    # the profiler's own syncs before and after are passed over
    t = _trace([_sync(-5.0), _sync(12.0)])
    assert _r([t.window]) == [(0.0, 10.0)]


@pytest.mark.parametrize("marks", [
    MARKS[:-1] + [("window", 113.0)],            # a stamp off the trace
    MARKS + [("sync", 111.0), ("sync", 112.0)],  # more than the trace holds
], ids=["stray", "missing"])
def test_no_spans_where_syncs_disagree(marks):
    t = tr.Trace([_sync(t - 100) for _, t in MARKS])
    assert not tr.align(t, marks) and t.window is None


def test_busy_and_gaps():
    t = _trace()
    assert _r([t.window]) == [(0.0, 10.0)]
    assert abs(t.busy(0, 10) - 3.0) < 1e-9          # [1.5, 3] [4, 5] [6, 6.5]
    assert abs(t.busy(2, 4.5) - 1.5) < 1e-9
    gaps = t.gaps(0, 10)
    assert [(round(a, 6), round(b, 6)) for a, b in gaps] == \
        [(0, 1.5), (3, 4), (5, 6), (6.5, 10)]
    assert t.host_at(3.95) == "cudaLaunchKernel"
    assert t.host_at(8.0) == "cudaMemcpyAsync" and t.host_at(5.5) == "python"
    assert t.host_at(6.97) == "cudaDeviceSynchronize"


def test_phases_from_syncs():
    t = _trace()
    op = Op(0, 1.0, 9.0, None, 1, "prove",
            timings={"calc_h": 1.0, "msm_g1": 2.0})
    ph = tr.phases(t, [op])
    assert [(k, round(a, 6), round(b, 6)) for k, a, b in ph] == \
        [("calc_h", 1.0, 3.0), ("msm_g1", 3.0, 7.0)]
    assert tr.phases(t, [Op(0, 1, 9, None, 1, "prove",
                            timings={"a": 1, "b": 1, "c": 1})]) == []
    assert [(k, round(a, 6), round(b, 6)) for k, a, b in
            tr.phases(t, [Op(0, 1, 9, None, 1, "verify")])] == \
        [("verify", 1.0, 9.0)]
    b = tr.breakdown(t, ph)
    name, seconds = b["device_ops"][0]
    assert name == "k1" and abs(seconds - 2) < 1e-9
    assert dict((k, round(v, 6)) for k, v in b["idle_gaps"]) == {
        "between_ops:python": 1.5, "between_ops:cudaMemcpyAsync": 3.5,
        "msm_g1:python": 2.0}


def test_capture_marks():
    real = torch.cuda.synchronize
    with tr.capture(cuda=False) as box:
        assert torch.cuda.synchronize is not real
        box["mark"]("op")
        torch.cuda.synchronize()
        box["mark"]("op")
    assert torch.cuda.synchronize is real
    assert box["trace"].window is None and box["trace"].device == []
