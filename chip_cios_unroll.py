#!/usr/bin/env python3
"""Experiment on one NVIDIA card: variants of the MNT6753 tower library
`mnt_kernels.cu` (24 words), built side by side and timed in turns.

    python3 chip_cios_unroll.py [--baseline DIR] [--unrolled] [--batches R]

Run from the root of a checkout on a machine with the CUDA toolkit and a
card.  The variants:

  rolled    the committed source (fp.cuh's CIOS outer loop rolled, as
            mnt_kernels.cu defines FP_CIOS_ROLLED);
  unrolled  with --unrolled, the same with the define removed;
  baseline  with --baseline DIR, the `mnt_kernels.cu` and headers of
            another checkout DIR (an older commit, unpacked with
            `git archive`), as committed there.

It compiles every variant at once (one nvcc each) into the ignored
wasmsnark_tpu_torch/_build/cios_unroll/, prints each build's seconds and
each kernel's registers, stack, spill stores, static shared memory and,
where the library reports its blocks' threads (`mnt_block_threads`), the
blocks an SM can hold by those (H100 limits: 64 K registers, 228 KB of
shared memory with 1 KB reserved per block, 2,048 threads and 32 blocks),
then binds each variant in turn and times K12 (product and square), K13
and K14 (doubling and add) at 256, 512 and 2^16 lanes: the median of CUDA
events around each wrapper call, each behind a ~1 ms device sleep; and
the team kernels' C entry points alone (and K1's, one product a thread),
as the mean of 20 launches in a row between two events.  The variants
run in one order and then in the reverse one, and every variant's results
must equal the plain versions' at 256 lanes and the first variant's at
2^16 lanes, bit for bit.

With --batches R it then times chip_smoke.py's steady MNT6753 verify
batch (256 lanes, the wall time of bowe_gabizon_verify_batch, and its
group-map-and-pairing stage alone) under each variant's library in R
rounds, the variants in one order and then in the reverse one, after one
warm-up batch; every batch must return its expected list.  Only the
library of K12-K14 differs between the turns.

The last line is one JSON object of all of it.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROLLED = "#define FP_CIOS_ROLLED\n"
LANES = (256, 512, 1 << 16)
# H100 SM limits for the occupancy estimate
SM_REGS, SM_SMEM, SM_THREADS, SM_BLOCKS = 65536, 228 * 1024, 2048, 32
# the kernels behind mnt_block_threads' entries, in its order
BLOCK_KERNELS = ("f6_mul_kernel", "f6_sqr_kernel", "f6_cyc_sqr_kernel",
                 "mnt_miller_dbl_kernel", "mnt_miller_add_kernel")


def blocks_per_sm(regs, smem, threads):
    """Blocks an SM can hold: registers go to warps in units of 256."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    return min(SM_BLOCKS, SM_THREADS // (32 * warps),
               SM_REGS // (warps * per_warp), SM_SMEM // (smem + 1024))


def block_threads(lib):
    """Kernel name -> threads a block, as the library launches them; {} for
    a library without `mnt_block_threads` (an older source)."""
    if not hasattr(lib, "mnt_block_threads"):
        return {}
    threads = (ctypes.c_int * len(BLOCK_KERNELS))()
    lib.mnt_block_threads(threads)
    return dict(zip(BLOCK_KERNELS, threads))


def ptxas(log_path, threads):
    """Per kernel of a build log: registers, stack, spill stores, static
    shared memory, and with `threads` (kernel name -> threads a block) the
    threads a block and the blocks per SM."""
    from chip_smoke import kernel_name
    with open(log_path) as fh:
        text = fh.read()
    out = {}
    for block in text.split("Compiling entry function")[1:]:
        name = kernel_name(block.split("'")[1])
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        props = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", block)
        if not (name and regs and props):
            continue
        r, s = int(regs.group(1)), int(smem.group(1)) if smem else 0
        out[name] = {"registers": r, "stack": int(props.group(1)),
                     "spill_stores": int(props.group(2)), "smem": s}
        if name in threads:
            out[name]["threads"] = threads[name]
            out[name]["blocks_per_sm"] = blocks_per_sm(r, s, threads[name])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--unrolled", action="store_true",
                    help="also the committed source with the loop unrolled")
    ap.add_argument("--batches", type=int, default=0,
                    help="rounds of the MNT6753 verify batch per variant")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_cios_unroll: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
    from wasmsnark_tpu_torch.ops import cuda_lib, fp, tower_kernels as tk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    out = os.path.join(cuda_lib.BUILD_ROOT, "cios_unroll")
    shutil.rmtree(out, ignore_errors=True)
    csrc = cuda_lib.CSRC
    variants = {"rolled": (csrc, True)}
    if args.unrolled:
        variants["unrolled"] = (csrc, False)
    if args.baseline:
        variants["baseline"] = (os.path.join(
            args.baseline, "wasmsnark_tpu_torch", "csrc"), None)
    dirs, procs = {}, {}
    t0 = time.perf_counter()
    for k, (name, (src, rolled)) in enumerate(variants.items()):
        d = dirs[name] = os.path.join(out, f"v{k}")
        os.makedirs(d)
        for f in os.listdir(src):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(src, f), d)
        with open(os.path.join(src, "mnt_kernels.cu")) as fh:
            text = fh.read()
        if rolled is not None:
            text = (ROLLED if rolled else "") + text.replace(ROLLED, "")
        with open(os.path.join(d, "mnt_kernels.cu"), "w") as fh:
            fh.write(text)
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-DWORDS=24", "-o", os.path.join(d, "libmnt_kernels.so"),
               os.path.join(d, "mnt_kernels.cu")]
        log = open(os.path.join(d, "build.log"), "w")
        procs[name] = subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)
    result = {"device": smi, "build_s": {}, "ptxas": {}, "ms": {}}
    while len(result["build_s"]) < len(procs):
        for name, proc in procs.items():
            if name not in result["build_s"] and proc.poll() is not None:
                if proc.returncode:
                    with open(os.path.join(dirs[name], "build.log")) as fh:
                        print(fh.read()[-4000:])
                    raise RuntimeError(f"nvcc failed for {name}")
                result["build_s"][name] = time.perf_counter() - t0
        time.sleep(0.05)
    libs = {name: cuda_lib._bind(ctypes.CDLL(
        os.path.join(dirs[name], "libmnt_kernels.so"))) for name in variants}
    for name in variants:
        result["ptxas"][name] = ptxas(os.path.join(dirs[name], "build.log"),
                                      block_threads(libs[name]))
        print(f"build {name}: {result['build_s'][name]:.1f} s; "
              + json.dumps(result["ptxas"][name]), flush=True)

    import chip_smoke as smoke
    spec = mnt6753().fp_spec
    rng = np.random.default_rng(5)
    n = LANES[-1]

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

    A = tk.unflatten6([rand() for _ in range(6)])
    B = tk.unflatten6([rand() for _ in range(6)])
    X, Y, Z = [tuple(rand() for _ in range(3)) for _ in range(3)]
    for c in Z:
        c[:, 64:96] = 0
    xP, yP = rand(), rand()
    ins = (A, B, X, Y, Z, xP, yP)

    def cut(t, k):
        return smoke.cut(t, k, n)

    def runs(k):
        A, B, X, Y, Z, xP, yP = cut(ins, k)
        return {
            "K12 mul": lambda: tk.mnt_f6_mul(spec, A, B),
            "K12 sqr": lambda: tk.mnt_f6_sqr(spec, A),
            "K13": lambda: tk.mnt_f6_cyc_sqr(spec, A),
            "K14 dbl": lambda: tk.mnt_miller_dbl(spec, X, Y, Z, xP, yP),
            "K14 add": lambda: tk.mnt_miller_add(spec, X, Y, Z, Y, X, xP,
                                                 yP)}

    def raw(k):
        """The team kernels' C entry points alone on stacked operands, and
        K1's: one base product a thread, for scale."""
        A, B, X, Y, Z, xP, yP = cut(ins, k)
        f6 = [torch.stack(tk.flatten6(A)), torch.stack(tk.flatten6(B)),
              torch.empty((6, spec.n_limbs, k), dtype=torch.int32,
                          device="cuda")]
        dbl = [torch.stack([*X, *Y, *Z]), torch.stack([xP, yP]),
               torch.empty((15, spec.n_limbs, k), dtype=torch.int32,
                           device="cuda")]
        k1 = [A[0][0], B[0][0], torch.empty_like(A[0][0])]
        return {"K12 mul": ("k12_f6_mul", f6), "K14 dbl":
                ("k14_mnt_miller_dbl", dbl), "K1": ("k1_mont_mul", k1)}

    def stream_ms(fn, tensors, k, reps=20):
        """Milliseconds a launch in a stream of reps launches, behind a
        device sleep: the kernel without its wrapper's stacking."""
        cuda_lib.launch(fn, spec, tensors, (k,))
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        for _ in range(reps):
            cuda_lib.launch(fn, spec, tensors, (k,))
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    small = runs(LANES[0])
    plain = _leaves([
        tk.mnt_f6_mul_plain(spec, *cut((A, B), LANES[0])),
        tk.mnt_f6_sqr_plain(spec, cut(A, LANES[0])),
        tk.mnt_f6_cyc_sqr_plain(spec, cut(A, LANES[0])),
        tk.mnt_miller_dbl_plain(spec, *cut((X, Y, Z, xP, yP), LANES[0])),
        tk.mnt_miller_add_plain(spec, *cut((X, Y, Z, Y, X, xP, yP),
                                           LANES[0]))])
    first = None
    order = list(variants) + list(variants)[::-1]
    for turn, name in enumerate(order):
        cuda_lib._libs["mnt_kernels_w24"] = libs[name]
        got = _leaves([fn() for fn in small.values()])
        big = _leaves([fn() for fn in runs(n).values()])
        torch.cuda.synchronize()
        first = first or [t.cpu() for t in big]
        same = (all(torch.equal(a, b) for a, b in zip(got, plain))
                and all(torch.equal(a.cpu(), b) for a, b in zip(big, first)))
        if not same:
            print(f"{name}: results differ from the plain versions or from "
                  "the first variant")
            return 1
        ms = {}
        for k in LANES:
            for kern, fn in runs(k).items():
                reps = 10 if k == n and kern.startswith("K14") else 30
                ms[f"{kern} @{k}"] = median_ms(fn, reps)
            for kern, (fn, tensors) in raw(k).items():
                ms[f"{kern} kernel @{k}"] = stream_ms(fn, tensors, k)
        result["ms"].setdefault(name, []).append(ms)
        print(f"turn {turn} {name}: " + ", ".join(
            f"{key} {v:.4f}" for key, v in ms.items()), flush=True)
    if args.batches:
        result["verify_batch_s"] = verify_batches(
            smoke, libs, cuda_lib, args.batches)
    print(json.dumps(result))
    return 0


def verify_batches(smoke, libs, cuda_lib, rounds):
    """Seconds of the steady MNT6753 verify batch and of its group map and
    pairing stage (rt._check) under each library, in alternating turns."""
    import random
    import torch
    import wasmsnark_tpu_torch

    rt = wasmsnark_tpu_torch.build_mnt6753()
    vk, ins, prs, want = smoke.mnt_lanes(rt, smoke.N_MNT)
    rng = random.Random(smoke.SEED)
    ms = [rt._marshal(vk, i, p, rng) for i, p in zip(ins, prs)]
    batch = [mm for mm in ms if mm is not None]
    g1_4, g2_var, expected = rt._pairing_inputs(batch)
    tt = rt._hash_to_t(batch)
    coeffs = rt._fixed_coeffs(batch[0]["delta"])
    want_ok = [w for w, mm in zip(want, ms) if mm is not None]
    names = list(libs)
    out = {name: {"batch": [], "pairing": []} for name in names}
    turns = ["warm-up"] + [name for r in range(rounds)
                           for name in (names if r % 2 == 0
                                        else names[::-1])]
    for turn, name in enumerate(turns):
        cuda_lib._libs["mnt_kernels_w24"] = libs[names[0] if turn == 0
                                                 else name]
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = rt.bowe_gabizon_verify_batch(vk, ins, prs, fused=True,
                                           rng=random.Random(smoke.SEED))
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t
        t = time.perf_counter()
        ok = rt._check(tt, g1_4, g2_var, coeffs, expected, True).tolist()
        torch.cuda.synchronize()
        pairing_s = time.perf_counter() - t
        if got != want or ok != want_ok:
            raise AssertionError(f"verify batch wrong under {name}")
        print(f"verify batch turn {turn} {name}: batch {batch_s:.3f} s, "
              f"group map and pairing {pairing_s:.3f} s", flush=True)
        if turn:
            out[name]["batch"].append(batch_s)
            out[name]["pairing"].append(pairing_s)
    return out


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [x for c in t for x in _leaves(c)]
    return [t]


if __name__ == "__main__":
    sys.exit(main())
