"""A traced run of one cell, as `run.py --trace 1` makes it, reported by
the port's spans in detail: one JSON line with the cell's per-layer
metrics, and for each operation its wall, its offsets onto the trace's
clock at each end, its program spans' seconds, the device's idle seconds
by innermost span, and what the spans cover of their parents; then what a
span costs on and off, and the card.  From the root of a checkout:

    python3 snarkbench/span_report.py --workload <cell> --seed <n> \\
        --seconds <s>

On a commit whose port records no spans, the operations' walls and the
trace's readings are reported and the span readings are empty."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LEAVES = {"prove": ("prove.key_and_witness", "prove.calc_h",
                    "prove.host_assembly"),
          "verify.batch": ("verify.vk_x", "verify.marshal",
                           "verify.pairing")}


def op_report(rec, o, off) -> dict:
    """What the spans of one operation say (o: an OpSpans)."""
    from snarkbench import program_spans as ps

    op = o.op
    out = {"wall_s": op.t1 - op.t0, "spans": len(o.spans),
           "timings": op.timings or None}
    if off is not None:
        out["offset_start_s"], out["offset_end_s"] = off
        out["offset_diff_ms"] = (off[1] - off[0]) * 1e3
    top = next(s for s in o.spans if s.parent not in
               {p.id for p in o.spans})
    secs: dict = {}
    for s in o.spans:
        secs[s.name] = secs.get(s.name, 0.0) + s.seconds
    out["seconds"] = secs
    selfs = ps.self_seconds(o.spans)
    by_name: dict = {}
    for s in o.spans:
        by_name[s.name] = by_name.get(s.name, 0.0) + selfs[s.id]
    out["self_seconds"] = by_name
    out["launches"] = {s.name: s.launches for s in o.spans
                       if s.name.startswith("prove.")
                       or s.name in ("verify.marshal", "verify.pairing")}
    if top.name == "prove":
        g2 = o.seconds("prove.msm_g2")
        msm = o.seconds("msm", under="prove.msm_g2")
        stages = o.seconds("msm.digits", "msm.sort", "msm.bucket_scan",
                           "msm.triangle", "msm.reduce", "msm.fold",
                           under="prove.msm_g2")
        if g2 and msm and stages:
            out["g2_stages_over_msm"] = stages / msm
            out["g2_msm_over_phase"] = msm / g2
        out["g2_stage_launches"] = {
            s.name: s.launches for s in o.named(
                "msm.digits", "msm.sort", "msm.bucket_scan", "msm.triangle",
                "msm.reduce", "msm.fold", under="prove.msm_g2")}
        if op.timings and "calc_h" in op.timings:
            out["calc_h_span_over_timings"] = \
                o.seconds("prove.calc_h") / op.timings["calc_h"]
    elif o.seconds("verify.marshal") and o.seconds("verify.pairing"):
        marshal = o.seconds("verify.marshal")
        out["marshal_pairing_over_wall"] = (
            marshal + o.seconds("verify.pairing")) / out["wall_s"]
        out["vk_x_over_marshal"] = (o.seconds("verify.vk_x") or 0.0) / \
            marshal
    if rec.trace is not None and o.offset is not None:
        idle = ps.idle_by_span(rec.trace, o)
        total = sum(idle.values())
        named = sum(v for k, v in idle.items()
                    if k.startswith("msm.") or k in LEAVES[top.name])
        out["idle_s"] = total
        out["idle_by_span"] = dict(sorted(idle.items(),
                                          key=lambda kv: -kv[1]))
        out["idle_in_named_leaves"] = named / total if total else None
        out["busy_s"] = rec.trace.busy(top.t0 + o.offset, top.t1 + o.offset)
    return out


def span_cost(n: int = 20000) -> dict:
    """Seconds a span costs, off and on (under the benchmark's profiler
    of the card's activity alone), from a loop of n empty spans; on again
    with the collector paused."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        from wasmsnark_tpu_torch.utils import spans
    except ImportError:
        return {}

    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with spans.span("cost"):
                pass
        return (time.perf_counter() - t) / n

    out = {"off_s": loop()}
    with profile(activities=[ProfilerActivity.CUDA]):
        out["profiler_enabled"] = torch.autograd._profiler_enabled()
        out["on_s"] = loop()
        gc.disable()
        try:
            out["on_gc_off_s"] = loop()
        finally:
            gc.enable()
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def report(cfg, traffic, metrics, seed, seconds, device) -> dict:
    """The traced run of a cell and its report (device: "cuda"; "cpu"
    rehearses it, where nothing is profiled unless the caller is)."""
    from snarkbench import cell, program_spans as ps

    box: dict = {}
    real = cell.reader

    def keeping(name):
        read = real(name)

        def read_keep(rec):
            box["rec"] = rec
            return read(rec)
        return read_keep

    cell.reader = keeping
    try:
        res = cell.run_cell(cfg, traffic, metrics, seed, seconds, True,
                            device, T_START)
    finally:
        cell.reader = real
    rec = box["rec"]
    offs = dict(zip((op.i for op in rec.ops), ps.op_offsets(rec)))
    mod = sys.modules.get(ps.SPANS_MODULE)
    return {"correct": res["correct"], "metrics": res["metrics"],
            "device": res["device"],
            "op_walls_s": [op.t1 - op.t0 for op in rec.done],
            "offset_diffs_ms": [(b - a) * 1e3 for a, b in
                                (offs[op.i] for op in rec.ops
                                 if offs[op.i] is not None)],
            "ops": [op_report(rec, o, offs[o.op.i]) for o in ps.by_op(rec)],
            "dropped": mod.BUFFER.dropped if mod else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from snarkbench.run import load_cell
    _, cfg, traffic, metrics = load_cell(ROOT, args.workload, True)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 2
    out = {"workload": args.workload, "seed": args.seed, "card": card(),
           **report(cfg, traffic, metrics, args.seed, args.seconds, "cuda"),
           "span_cost": span_cost()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
