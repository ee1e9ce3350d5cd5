"""One run of one cell: set-up, the measured (or traced) window, the
reference's comparison and the metrics, as the result line's object."""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import os
import sys
import time
import traceback

from . import loops, programs, trace as tr

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Op:
    i: int
    t0: float
    t1: float
    out: object
    lanes: int
    label: str
    error: str | None = None
    timings: dict | None = None


@dataclasses.dataclass
class Record:
    """What a metric's reader reads: the cell's sizes (the loop's
    `sizes()`), the set-up time, the window's operations and length, the
    device's peak memory over the window, the port's kernel launches in
    it, and with --trace 1 the Trace and its timed phases."""
    sizes: dict
    setup_s: float
    window_s: float
    ops: list
    peak_bytes: int | None = None
    launches: int | None = None
    trace: tr.Trace | None = None
    phases: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> list:
        """The operations that returned."""
        return [op for op in self.ops if op.error is None]


def reader(name: str):
    """The `read(record)` of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "snarkbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window(loop, seconds: float, cap: int = 0, mark=None):
    """Operations back to back until `seconds` have passed (or `cap`
    operations); returns (ops, the window's seconds).  mark: the traced
    window's, called at each end of each operation (which then records
    the prover's phase `timings`)."""
    ops, start, i = [], time.perf_counter(), 0
    errors: set = set()
    while True:
        timings = {} if mark else None
        if mark:
            mark("op")
        t0 = time.perf_counter()
        try:
            out, lanes = loop.op(i, timings)
            err = None
        except Exception as e:  # the window goes on; the op counts failed
            out, lanes, err = None, 0, repr(e)
            if err not in errors:
                errors.add(err)
                traceback.print_exc(file=sys.stderr)
        t1 = time.perf_counter()
        if mark:
            mark("op")
        ops.append(Op(i, t0, t1, out, lanes, loop.kind, err, timings))
        i += 1
        if t1 - start >= seconds or (cap and i >= cap):
            return ops, t1 - start


def run_cell(cfg, traffic, metric_names, seed, seconds, trace, device,
             t_start, program=None, cap: int = 0) -> dict:
    """Everything of a run after the card check.  metric_names: the
    metrics this cell reports in this mode.  program: a factory of a
    stand-in for the port (the control, the fault tests); None runs the
    port.  Returns the result object with "checks" last."""
    loop = loops.module(traffic["loop"]).Loop(cfg, traffic, seed, device,
                                              program)
    loop.prepare()
    return measure(loop, metric_names, seconds, trace, t_start,
                   launches=program is None, cap=cap)


def measure(loop, metric_names, seconds, trace, t_start, launches=True,
            cap: int = 0) -> dict:
    """The window of a prepared loop, its check and its metrics.
    launches: read the port's launch counters; cap: at most this many
    operations (0: no cap; a traced window takes the traffic's
    trace_ops)."""
    import torch
    cuda = torch.device(loop.device).type == "cuda"
    setup_peak = None
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    if launches:
        programs.reset_launches()
    # the set-up's objects (circuit, pools, key) stay alive through the
    # window: out of the collector's reach, they add nothing to its passes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    tdata = None
    if trace:
        with tr.capture(cuda) as box:
            ops, window_s = window(loop, seconds,
                                   loop.traffic.get("trace_ops", 0),
                                   box["mark"])
        tdata = box["trace"]
    else:
        ops, window_s = window(loop, seconds, cap)
    gc.unfreeze()
    rec = Record(loop.sizes(), setup_s, window_s, ops)
    if cuda:
        torch.cuda.synchronize()
        rec.peak_bytes = torch.cuda.max_memory_allocated()
    if launches:
        rec.launches = programs.launches()
    if tdata is not None:
        rec.trace = tdata
        rec.phases = tr.phases(tdata, ops)
    loop.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = loop.check(rec.done)
    failed = sum(1 for op in ops if op.error is not None) * loop.lanes
    attempted = len(ops) * loop.lanes
    metrics = {}
    for name, unit in metric_names:
        value = reader(name)(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": max(setup_peak or 0, rec.peak_bytes or 0)}
    out = {"correct": not failed and bool(rec.done)
           and all(v <= lim for v, lim in checks.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if tdata is not None and tdata.window is not None:
        lo, hi = tdata.window
        dev["busy_s"] = tdata.busy(lo, hi)
        dev["window_s"] = hi - lo
        out["breakdown"] = tr.breakdown(tdata, rec.phases)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
