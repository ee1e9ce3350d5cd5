"""The controls: the reference put in the program's place with one
guarantee the configuration states broken (each loop's `Control`, in
loops/<loop>.py), which the comparison that decides `correct` has to
fail.

    prove   proofs worked out from the witness without the blinding (r =
            s = 0): zero knowledge broken, every proof still verifies
    verify  verdicts in the exponent without the check that each input is
            below r: a lane whose input was raised by r is accepted

    python3 snarkbench/control.py --workload <cell> --seeds 1 2 3 --ops N

runs each seed at the cell's own size and prints its checks and
`correct` (which must be false).  It needs no card: nothing of the
program runs.  The benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from snarkbench import loops  # noqa: E402


def main(argv=None) -> int:
    from snarkbench.cell import run_cell
    from snarkbench.run import load_cell
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--ops", type=int, required=True,
                    help="operations a window (as many as a run makes)")
    args = ap.parse_args(argv)
    _, cfg, traffic, _ = load_cell(ROOT, args.workload, False)
    for seed in args.seeds:
        out = run_cell(cfg, traffic, [], seed, float("inf"), False, "cpu",
                       time.perf_counter(),
                       loops.module(traffic["loop"]).Control,
                       cap=args.ops)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
