"""snarkbench: the benchmark of wasmsnark_tpu_torch, the PyTorch/CUDA
port, on an NVIDIA card.  From the root of a checkout:

    python3 snarkbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

runs the cell of BENCHMARK.json named <cell>: set-up from the seed, then
operations back to back for <s> seconds, then the reference's comparison,
and prints the result as one JSON line last on standard output (each
compared number beside its limit also last on standard error).  --trace 1
profiles the window and reports the cell's per-layer metrics instead of
its end-to-end ones.  Everything a cell needs is found by name: the
configuration's file from BENCHMARK.json, traffic/<traffic>.json, the
loop it names in loops/<loop>.py, the reference of the configuration's
curve (reference/pairing.py, or reference/<curve>.py), and
metrics/<metric>.py for every metric.  A run that finds no card, or that
finds jax, jaxlib, flax or wasmsnark_tpu loaded once the window has
closed, exits non-zero without a result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the program builds its kernels into wasmsnark_tpu_torch/_build/<hash>/;
# any Triton cache goes to a fixed directory of the checkout too
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".snarkbench_cache",
                                              "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "wasmsnark_tpu")


def forbidden_modules(names) -> list:
    """The forbidden top-level names among module names, compared whole
    (wasmsnark_tpu_torch is not wasmsnark_tpu)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_cell(root: str, name: str, trace: bool):
    """(cell, configuration, traffic, [(metric, unit)]) of a workload."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, "snarkbench", "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    metrics = [(m["name"], m["unit"])
               for m in bench["per_layer" if trace else "end_to_end"]
               if name in m.get("workloads", [name])]
    return cell, cfg, traffic, metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, cfg, traffic, metrics = load_cell(ROOT, args.workload, args.trace)

    import torch
    # one process, one thread of torch's own: no pool of CPU threads
    # contends with the loop's host work for the machine's cores
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"snarkbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    from snarkbench.cell import run_cell
    out = run_cell(cfg, traffic, metrics, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"snarkbench: the run loaded {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, v in out["checks"].items():
        print(f"{name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
