#!/usr/bin/env python3
"""Build-time experiment on one NVIDIA card: the 24-word CUDA libraries
with fp.cuh's CIOS outer loop unrolled against rolled (FP_CIOS_ROLLED).

    python3 chip_cios_unroll.py

Run from the root of a checkout on a machine with the CUDA toolkit and a
card.  It compiles `fp_kernels.cu` and `mnt_kernels.cu` at 24 words in both
variants (four nvcc processes, started together) into the ignored
wasmsnark_tpu_torch/_build/cios_unroll/, prints each build's seconds and
each kernel's registers / stack / spill stores, then binds each variant in
turn and prints the median time of K1 and K12-K14 at 2^16 lanes (CUDA
events, each launch behind a ~1 ms device sleep), after checking that both
variants give the same bits.  The committed sources roll the loop in
mnt_kernels.cu only; PERF.md §6 says why.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROLLED = "#define FP_CIOS_ROLLED\n"


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_cios_unroll: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import kernel_name
    from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
    from wasmsnark_tpu_torch.ops import cuda_lib, fp, tower_kernels as tk

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    out = os.path.join(cuda_lib.BUILD_ROOT, "cios_unroll")
    dirs = {}
    for variant in ("unrolled", "rolled"):
        d = dirs[variant] = os.path.join(out, variant)
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(cuda_lib.CSRC, "fp.cuh"), d)
        for src in ("fp_kernels.cu", "mnt_kernels.cu"):
            with open(os.path.join(cuda_lib.CSRC, src)) as fh:
                text = fh.read().replace(ROLLED, "")
            with open(os.path.join(d, src), "w") as fh:
                fh.write((ROLLED if variant == "rolled" else "") + text)
    procs = {}
    t0 = time.perf_counter()
    for variant, d in dirs.items():
        for lib in ("fp_kernels", "mnt_kernels"):
            cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-DWORDS=24",
                   "-o", os.path.join(d, f"lib{lib}.so"),
                   os.path.join(d, f"{lib}.cu")]
            log = open(os.path.join(d, f"{lib}.log"), "w")
            procs[(variant, lib)] = subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)
    seconds = {}
    while len(seconds) < len(procs):
        for key, proc in procs.items():
            if key not in seconds and proc.poll() is not None:
                if proc.returncode:
                    raise RuntimeError(f"nvcc failed for {key}")
                seconds[key] = time.perf_counter() - t0
        time.sleep(0.05)
    for (variant, lib), s in sorted(seconds.items()):
        print(f"build {variant} {lib}_w24: {s:.1f} s")
        with open(os.path.join(dirs[variant], f"{lib}.log")) as fh:
            text = fh.read()
        for block in text.split("Compiling entry function")[1:]:
            name = kernel_name(block.split("'")[1])
            regs = re.search(r"Used (\d+) registers", block)
            props = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores", block)
            if name and regs and props:
                print(f"  {name}: {regs.group(1)} registers, "
                      f"{props.group(1)} B stack, {props.group(2)} B spill")

    spec = mnt6753().fp_spec
    rng = np.random.default_rng(5)
    n = 1 << 16

    def rand():
        a = rng.integers(0, 1 << 16, size=(spec.n_limbs, n), dtype=np.uint32)
        a[-1] = rng.integers(0, spec.q_limbs[-1], size=n, dtype=np.uint32)
        return fp.planes(a, "cuda")

    def median_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[reps // 2]

    x, y = rand(), rand()
    A = tk.unflatten6([rand() for _ in range(6)])
    B = tk.unflatten6([rand() for _ in range(6)])
    X, Y, Z = [tuple(rand() for _ in range(3)) for _ in range(3)]
    xP, yP = rand(), rand()
    runs = {
        "K1": (lambda: fp.mont_mul(spec, x, y), 30),
        "K12 mul": (lambda: tk.mnt_f6_mul(spec, A, B), 30),
        "K12 sqr": (lambda: tk.mnt_f6_sqr(spec, A), 30),
        "K13": (lambda: tk.mnt_f6_cyc_sqr(spec, A), 30),
        "K14 dbl": (lambda: tk.mnt_miller_dbl(spec, X, Y, Z, xP, yP), 10),
        "K14 add": (lambda: tk.mnt_miller_add(spec, X, Y, Z, Y, X, xP, yP),
                    10),
    }
    first = None
    for variant, d in dirs.items():
        for lib in ("fp_kernels", "mnt_kernels"):
            cuda_lib._libs[f"{lib}_w24"] = cuda_lib._bind(
                ctypes.CDLL(os.path.join(d, f"lib{lib}.so")))
        outs = [fn() for fn, _ in runs.values()]
        torch.cuda.synchronize()
        flat = [t.cpu() for t in _leaves(outs)]
        first = first or flat
        same = all(torch.equal(a, b) for a, b in zip(first, flat))
        print(f"{variant}: same bits as unrolled {same}; " + ", ".join(
            f"{k} {median_ms(fn, reps):.4f} ms"
            for k, (fn, reps) in runs.items()), flush=True)
        if not same:
            return 1
    return 0


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [x for c in t for x in _leaves(c)]
    return [t]


if __name__ == "__main__":
    sys.exit(main())
