#!/usr/bin/env python3
"""Experiment on one NVIDIA card: variants of the field and tower
libraries, built side by side and timed in turns.

    python3 chip_cios_unroll.py [--baseline DIR] [--unrolled]
                                [--variant NAME:DEFINE[,DEFINE...]]
                                [--field-only | --tower-only] [--sass]
                                [--pairings R] [--batches R]

Run from the root of a checkout on a machine with the CUDA toolkit and a
card.  Each variant is the field library `fp_kernels.cu` (8, 12 and 24
words), the MNT6753 library `mnt_kernels.cu` (24 words) and the BN128 /
BLS12-381 library `tower_kernels.cu` (8 and 12 words):

  rolled    the committed sources (mnt_kernels.cu defines FP_CIOS_ROLLED,
            fp.cuh's CIOS outer loop rolled);
  unrolled  with --unrolled, the same with that define removed;
  NAME      with --variant NAME:K1_TEAM_MAX_LANES=0 (say), the committed
            sources built with those -D macros (repeatable; the name
            UNROLLED among them stands for --unrolled's edit);
  baseline  with --baseline DIR, the sources and headers of another
            checkout DIR (an older commit, unpacked with `git archive`),
            as committed there.

It compiles every library of every variant at once (one nvcc each) into
the ignored wasmsnark_tpu_torch/_build/cios_unroll/, prints each build's
seconds and each kernel's registers, stack, spill stores, static shared
memory and, where the library reports its blocks' threads
(`mnt_block_threads`, `tower_block_threads`), the blocks an SM can hold
by those (H100 limits: 64 K registers, 228 KB of shared memory with 1 KB
reserved per block, 2,048 threads and 32 blocks).  Then it binds each
variant in turn and times K12 (product and square), K13 and K14
(doubling and add) at 255, 256, 512 and 2^16 lanes and K8's product and
K9 at 8 and 12 words at TOWER_LANES (1,024 to 2^16): the median
of CUDA events around each wrapper call, each behind a ~1 ms device
sleep; and the team kernels' C entry points alone (and K1's, one product
a thread), as the mean of 20 launches in a row between two events.  The
variants run in one order and then in the reverse one, and every
variant's results must equal the plain versions' at the smallest lane
count and the first variant's at 2^16 lanes, bit for bit.  K1 and K2
(the add-and-sub pair, as chip_smoke.py's row) are timed the same way at
24 words at FIELD_LANES[24] lanes (the MNT6753 paths' and 2^16) and at 8
and 12 words at their paths' lane counts and 2^16, each checked against
its plain version at every lane count.  With --field-only only the field
library is built and only K1 and K2 timed, with --tower-only only
tower_kernels.cu and only K8's product and K9.  With --sass it prints,
per variant and kernel, the instructions of its SASS (cuobjdump) and the
most frequent opcodes.

With --pairings R it then times chip_smoke.py's unprepared pairing
batches (BN128 and BLS12-381 on 1,024 lanes, MNT6753 on 256 lanes and
fused on two pairs a lane: the wall time of the call, synchronized) under
each variant's libraries in R rounds, the variants in one order and then
in the reverse one, after one warm-up round, and then the card's kernel
time of one call of each under torch.profiler; every batch must equal the
host oracle's value.  With --batches R it times chip_smoke.py's steady
MNT6753 verify batch (256 lanes, the wall time of
bowe_gabizon_verify_batch, and its group-map-and-pairing stage alone) and
its steady BLS12-381 verify batch (N_VERIFY = 1,024 lanes of one key, the
wall time of groth16_verify_batch; the proof is of a 62-constraint
square chain, since a batch's work depends on the public inputs and not
on the circuit) the same way, then the card's kernel time of one call of
the MNT6753 stage and of the BLS12-381 batch under torch.profiler; every
batch must return its expected list.  Only the field and tower libraries
differ between the turns.

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
# library -> (source, words)
LIBS = {"fp_kernels_w8": ("fp_kernels.cu", 8),
        "fp_kernels_w12": ("fp_kernels.cu", 12),
        "fp_kernels_w24": ("fp_kernels.cu", 24),
        "mnt_kernels_w24": ("mnt_kernels.cu", 24),
        "tower_kernels_w8": ("tower_kernels.cu", 8),
        "tower_kernels_w12": ("tower_kernels.cu", 12)}
BIG = 1 << 16                    # the lane count of the cross-variant check
MNT_LANES = (255, 256, 512, BIG)
# K8's product and K9: the pairing and verify batches' lane counts, and
# more up to 2^16 for where a team kernel stops paying
TOWER_LANES = (1024, 2048, 4096, 8192, 16384, 32768, BIG)
# K1 and K2 per word count: the lane counts their paths launch them with
# most (PERF.md §6: the MNT6753 verify batch's at 24 words, the prove's at
# 8 and 12) and 2^16; at 24 words also those around K1's switch between
# its team product and one thread a lane
FIELD_LANES = {24: (255, 256, 510, 1024, 1530, 2048, 3072, 4096, 6120, BIG),
               8: (2, 3, 6, 1024, 2048, BIG),
               12: (2, 3, 6, 1024, 2048, BIG)}
DEVICE = "cuda"                  # the card (a host rehearsal sets "cpu")
# H100 SM limits for the occupancy estimate
SM_REGS, SM_SMEM, SM_THREADS, SM_BLOCKS = 65536, 228 * 1024, 2048, 32
# the kernels behind each library's block-threads export, in its order
BLOCK_KERNELS = {
    "mnt_block_threads": ("f6_mul_kernel", "f6_sqr_kernel",
                          "f6_cyc_sqr_kernel", "mnt_miller_dbl_kernel",
                          "mnt_miller_add_kernel"),
    "tower_block_threads": ("f12_mul_kernel", "f12_sqr_kernel",
                            "f12_cyc_sqr_kernel", "miller_dbl_kernel",
                            "miller_add_kernel")}


def blocks_per_sm(regs, smem, threads):
    """Blocks an SM can hold: registers go to warps in units of 256."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    return min(SM_BLOCKS, SM_THREADS // (32 * warps),
               SM_REGS // (warps * per_warp), SM_SMEM // (smem + 1024))


def block_threads(lib):
    """Kernel name -> threads a block, as the library launches them; {} for
    a library without a block-threads export (an older source)."""
    for fn, kernels in BLOCK_KERNELS.items():
        if hasattr(lib, fn):
            threads = (ctypes.c_int * len(kernels))()
            getattr(lib, fn)(threads)
            return dict(zip(kernels, threads))
    return {}


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


def sass_counts(so_path, cuda_lib, top=8):
    """Per kernel of a library: its SASS instructions (cuobjdump -sass) and
    the `top` most frequent opcodes, with their modifiers."""
    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    from chip_smoke import kernel_name
    text = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, timeout=300).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = kernel_name(block.split()[0])
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", block)
        if name:
            counts = {}
            for op in ops:
                counts[op] = counts.get(op, 0) + 1
            out[name] = {"instructions": len(ops), "top": dict(sorted(
                counts.items(), key=lambda kv: -kv[1])[:top])}
    return out


def build_variants(variants, cuda_lib, built=LIBS, sass=False):
    """Every library of `built` (library -> (source, words)) of every
    variant, compiled at once; returns (variant -> library -> bound CDLL,
    result dict with build seconds, ptxas and with `sass` the SASS
    counts)."""
    out = os.path.join(cuda_lib.BUILD_ROOT, "cios_unroll")
    shutil.rmtree(out, ignore_errors=True)
    dirs, procs = {}, {}
    t0 = time.perf_counter()
    for k, (name, (src, rolled, defines)) in enumerate(variants.items()):
        d = dirs[name] = os.path.join(out, f"v{k}")
        os.makedirs(d)
        for f in os.listdir(src):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(src, f), d)
        for f in sorted({s for s, _ in built.values()}):
            with open(os.path.join(src, f)) as fh:
                text = fh.read()
            if rolled is not None and f == "mnt_kernels.cu":
                text = (ROLLED if rolled else "") + text.replace(ROLLED, "")
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        for lib, (f, w) in built.items():
            cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, f"-DWORDS={w}",
                   *[f"-D{x}" for x in defines],
                   "-o", os.path.join(d, f"lib{lib}.so"), os.path.join(d, f)]
            log = open(os.path.join(d, f"{lib}.log"), "w")
            procs[name, lib] = subprocess.Popen(cmd, stdout=log,
                                                stderr=subprocess.STDOUT)
    result = {"build_s": {}, "ptxas": {}}
    done = {}
    while len(done) < len(procs):
        for (name, lib), proc in procs.items():
            if (name, lib) not in done and proc.poll() is not None:
                if proc.returncode:
                    with open(os.path.join(dirs[name], f"{lib}.log")) as fh:
                        print(fh.read()[-4000:])
                    raise RuntimeError(f"nvcc failed for {name} {lib}")
                done[name, lib] = time.perf_counter() - t0
        time.sleep(0.05)
    libs = {}
    for name in variants:
        libs[name] = {lib: cuda_lib._bind(ctypes.CDLL(
            os.path.join(dirs[name], f"lib{lib}.so"))) for lib in built}
        result["build_s"][name] = {lib: done[name, lib] for lib in built}
        result["ptxas"][name] = {
            lib: ptxas(os.path.join(dirs[name], f"{lib}.log"),
                       block_threads(libs[name][lib])) for lib in built}
        print(f"build {name}: " + json.dumps(result["build_s"][name]) + "; "
              + json.dumps(result["ptxas"][name]), flush=True)
        if sass:
            result.setdefault("sass", {})[name] = {
                lib: sass_counts(os.path.join(dirs[name], f"lib{lib}.so"),
                                 cuda_lib) for lib in built}
            print(f"sass {name}: " + json.dumps(result["sass"][name]),
                  flush=True)
    return libs, result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--unrolled", action="store_true",
                    help="also the committed source with the loop unrolled")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:MACRO=VALUE[,...]: the committed sources "
                         "built with those macros")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--field-only", action="store_true",
                      help="build and time the field library (K1, K2) only")
    only.add_argument("--tower-only", action="store_true",
                      help="build tower_kernels.cu only, time K8 and K9")
    ap.add_argument("--sass", action="store_true",
                    help="print each kernel's SASS instruction counts")
    ap.add_argument("--pairings", type=int, default=0,
                    help="rounds of the pairing batches per variant")
    ap.add_argument("--batches", type=int, default=0,
                    help="rounds of the MNT6753 verify batch per variant")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_cios_unroll: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from wasmsnark_tpu_torch.models.bls12381 import bls12381
    from wasmsnark_tpu_torch.models.bn128 import bn128
    from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
    from wasmsnark_tpu_torch.ops import cuda_lib, fp, tower_kernels as tk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    csrc = cuda_lib.CSRC
    variants = {"rolled": (csrc, True, ())}
    if args.unrolled:
        variants["unrolled"] = (csrc, False, ())
    for v in args.variant:
        name, defines = v.split(":", 1)
        defines = defines.split(",")
        variants[name] = (csrc, "UNROLLED" not in defines,
                          tuple(d for d in defines if d != "UNROLLED"))
    if args.baseline:
        variants["baseline"] = (os.path.join(
            args.baseline, "wasmsnark_tpu_torch", "csrc"), None, ())
    towers = not args.field_only            # tower_kernels.cu, K8 and K9
    mnt = towers and not args.tower_only    # mnt_kernels.cu, K12-K14
    field = not args.tower_only             # fp_kernels.cu, K1 and K2
    libs, result = build_variants(variants, cuda_lib, {
        lib: sw for lib, sw in LIBS.items()
        if (field and lib.startswith("fp_")) or (mnt and lib.startswith(
            "mnt_")) or (towers and lib.startswith("tower_"))}, args.sass)
    result = {"device": smi, **result, "ms": {}}

    import chip_smoke as smoke
    rng = np.random.default_rng(5)
    n = BIG
    specs = {24: mnt6753().fp_spec, 8: bn128().fp_spec,
             12: bls12381().fp_spec}
    spec = specs[24]

    def rand(s):
        a = rng.integers(0, 1 << 16, size=(s.n_limbs, n), dtype=np.uint32)
        a[-1] = rng.integers(0, s.q_limbs[-1], size=n, dtype=np.uint32)
        return fp.planes(a, DEVICE)

    A = tk.unflatten6([rand(spec) for _ in range(6)])
    B = tk.unflatten6([rand(spec) for _ in range(6)])
    X, Y, Z = [tuple(rand(spec) for _ in range(3)) for _ in range(3)]
    for c in Z:
        c[:, 64:96] = 0
    xP, yP = rand(spec), rand(spec)
    F12 = {w: tk.unflatten12([rand(specs[w]) for _ in range(12)])
           for w in (8, 12)}
    G12 = {w: tk.unflatten12([rand(specs[w]) for _ in range(12)])
           for w in (8, 12)}
    XI = {8: tk.XI, 12: tk.XI_BLS}
    ins = (A, B, X, Y, Z, xP, yP)
    FX = {w: (rand(specs[w]), rand(specs[w])) for w in FIELD_LANES}

    def cut(t, k):
        return smoke.cut(t, k, n)

    def runs(k):
        """The wrappers timed at k lanes: K12-K14 at the MNT6753 lane
        counts, K8's product and K9 at TOWER_LANES, K1 and K2 at
        FIELD_LANES."""
        out = {}
        if mnt and k in MNT_LANES:
            A, B, X, Y, Z, xP, yP = cut(ins, k)
            out.update({
                "K12 mul": lambda: tk.mnt_f6_mul(spec, A, B),
                "K12 sqr": lambda: tk.mnt_f6_sqr(spec, A),
                "K13": lambda: tk.mnt_f6_cyc_sqr(spec, A),
                "K14 dbl": lambda: tk.mnt_miller_dbl(spec, X, Y, Z, xP, yP),
                "K14 add": lambda: tk.mnt_miller_add(spec, X, Y, Z, Y, X,
                                                     xP, yP)})
        if towers and k in TOWER_LANES:
            for w in (8, 12):
                a, b = cut(F12[w], k), cut(G12[w], k)
                out[f"K8 mul @N{w}"] = (lambda a=a, b=b, w=w: tk.f12_mul(
                    specs[w], a, b, XI[w]))
                out[f"K9 @N{w}"] = (lambda a=a, w=w: tk.f12_cyc_sqr(
                    specs[w], a, XI[w]))
        for w, ks in FIELD_LANES.items():
            if field and k in ks:
                x, y = cut(FX[w], k)
                s = specs[w]
                out[f"K1 @N{w}"] = lambda s=s, x=x, y=y: fp.mont_mul(s, x, y)
                out[f"K2 @N{w}"] = lambda s=s, x=x, y=y: (
                    fp.mod_add(s, x, y), fp.mod_sub(s, x, y))
        return out

    def field_plain(k):
        """The plain versions of runs(k)'s K1 and K2 entries, in order."""
        out = []
        for w, ks in FIELD_LANES.items():
            if field and k in ks:
                x, y = cut(FX[w], k)
                s = specs[w]
                out += [fp.mont_mul_plain(s, x, y), fp.mod_add_plain(s, x, y),
                        fp.mod_sub_plain(s, x, y)]
        return out

    def plain(k):
        """The plain versions of runs(k)'s wrappers, in its order."""
        out = []
        if mnt and k in MNT_LANES:
            A, B, X, Y, Z, xP, yP = cut(ins, k)
            out += [tk.mnt_f6_mul_plain(spec, A, B),
                    tk.mnt_f6_sqr_plain(spec, A),
                    tk.mnt_f6_cyc_sqr_plain(spec, A),
                    tk.mnt_miller_dbl_plain(spec, X, Y, Z, xP, yP),
                    tk.mnt_miller_add_plain(spec, X, Y, Z, Y, X, xP, yP)]
        if towers and k in TOWER_LANES:
            for w in (8, 12):
                a, b = cut(F12[w], k), cut(G12[w], k)
                out += [tk.f12_mul_plain(specs[w], a, b, XI[w]),
                        tk.f12_cyc_sqr_plain(specs[w], a, XI[w])]
        return _leaves(out + field_plain(k))

    def raw(k):
        """The team kernels' C entry points alone on stacked operands, and
        K1's: one base product a thread, for scale."""
        def empty(planes, s):
            return torch.empty((planes, s.n_limbs, k), dtype=torch.int32,
                               device=DEVICE)

        out = {}
        if field and k in MNT_LANES:
            A, B, X, Y, Z, xP, yP = cut(ins, k)
            out["K1"] = ("k1_mont_mul", spec,
                         [A[0][0], B[0][0], torch.empty_like(A[0][0])], ())
        if mnt and k in MNT_LANES:
            pts = [torch.stack([*X, *Y, *Z]), torch.stack([xP, yP])]
            out.update({
                "K12 mul": ("k12_f6_mul", spec, [
                    torch.stack(tk.flatten6(A)), torch.stack(tk.flatten6(B)),
                    empty(6, spec)], ()),
                "K12 sqr": ("k12_f6_sqr", spec, [
                    torch.stack(tk.flatten6(A)), empty(6, spec)], ()),
                "K14 dbl": ("k14_mnt_miller_dbl", spec,
                            [*pts, empty(15, spec)], ()),
                "K14 add": ("k14_mnt_miller_add", spec,
                            [pts[0], torch.stack([*Y, *X]), pts[1],
                             empty(15, spec)], ())})
        if towers and k in TOWER_LANES:
            for w in (8, 12):
                a = torch.stack(tk.flatten12(cut(F12[w], k)))
                out[f"K8 mul @N{w}"] = ("k8_f12_mul", specs[w], [
                    a, torch.stack(tk.flatten12(cut(G12[w], k))),
                    empty(12, specs[w])], XI[w])
                out[f"K9 @N{w}"] = ("k9_f12_cyc_sqr", specs[w], [
                    a, empty(12, specs[w])], XI[w])
        return out

    def stream_ms(fn, s, tensors, k, ints, reps=20):
        """Milliseconds a launch in a stream of reps launches, behind a
        device sleep: the kernel without its wrapper's stacking."""
        cuda_lib.launch(fn, s, tensors, (k, *ints))
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        for _ in range(reps):
            cuda_lib.launch(fn, s, tensors, (k, *ints))
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    cuda_lib._libs.update(libs[next(iter(variants))])
    if args.pairings or args.batches:
        cuda_lib.build()              # the field and curve libraries
    lanes = sorted(set(MNT_LANES + TOWER_LANES).union(
        *FIELD_LANES.values()))
    small = {k: plain(k) for k in lanes if k != n}
    first = None
    order = list(variants) + list(variants)[::-1]
    for turn, name in enumerate(order):
        cuda_lib._libs.update(libs[name])
        same = True
        for k, want in small.items():
            got = _leaves([fn() for fn in runs(k).values()])
            same &= all(torch.equal(a, b) for a, b in zip(got, want,
                                                          strict=True))
        big = _leaves([fn() for fn in runs(n).values()])
        torch.cuda.synchronize()
        first = first or [t.cpu() for t in big]
        same &= all(torch.equal(a.cpu(), b) for a, b in zip(big, first))
        if not same:
            print(f"{name}: results differ from the plain versions or from "
                  "the first variant")
            return 1
        ms = {}
        for k in lanes:
            for kern, fn in runs(k).items():
                reps = 10 if k == n and kern.startswith("K14") else 30
                ms[f"{kern} @{k}"] = smoke.time_cuda(fn, reps)
            for kern, (fn, s, tensors, ints) in raw(k).items():
                ms[f"{kern} kernel @{k}"] = stream_ms(fn, s, tensors, k, ints)
        result["ms"].setdefault(name, []).append(ms)
        print(f"turn {turn} {name}: " + ", ".join(
            f"{key} {v:.4f}" for key, v in ms.items()), flush=True)
    if args.pairings:
        result["pairing_s"] = pairing_batches(smoke, libs, cuda_lib,
                                              args.pairings)
    if args.batches:
        result["verify_batch_s"] = verify_batches(
            smoke, libs, cuda_lib, args.batches)
    print(json.dumps(result))
    return 0


def turns(names, rounds):
    """A warm-up turn of the first variant, then rounds of every variant,
    in one order and then in the reverse one."""
    return [(True, names[0])] + [(False, name) for r in range(rounds)
                                 for name in (names if r % 2 == 0
                                              else names[::-1])]


def pairing_batches(smoke, libs, cuda_lib, rounds):
    """Seconds of chip_smoke.py's unprepared pairing batches under each
    variant's libraries, in alternating turns: BN128 and BLS12-381 on
    N_VERIFY lanes of e(7 G1, 9 G2), MNT6753 on N_MNT lanes of the same
    and fused on two pairs a lane, e(7 G1, 9 G2) e(-63 G1, G2); each
    result held against the host oracle's e(G1, G2)^63 (or 1)."""
    import torch
    from wasmsnark_tpu_torch.ops.curve import map_leaf
    from wasmsnark_tpu_torch.ops.pairing import (mnt6753_pairing_device,
                                                 pairing_device)

    def on_lanes(points, pack, n):    # pair j = points[j] on every lane
        return map_leaf(pack([p for p in points for _ in range(n)]),
                        lambda a: a.reshape(a.shape[0], len(points), n))

    batches = {}
    for curve in smoke.CURVES:
        pd = pairing_device(curve)
        m = pd.m
        p7 = m.G1.affine(m.G1.times_scalar(m.g1_gen, 7))[:2]
        q9 = m.G2.affine(m.G2.times_scalar(m.g2_gen, 9))[:2]
        g1 = on_lanes([p7], pd.pack_g1, smoke.N_VERIFY)
        g2 = on_lanes([q9], pd.pack_g2, smoke.N_VERIFY)
        want = m.F12.exp(m.final_exponentiation(m.miller_loop(
            m.G1.affine(m.g1_gen)[:2], m.G2.affine(m.g2_gen)[:2])), 63)
        batches[curve] = (lambda pd=pd, g1=g1, g2=g2: pd.pairing_product(
            g1, g2, 1), lambda e, pd=pd, want=want: all(
                v == want for v in pd.unpack_f12(e)))
    pd = mnt6753_pairing_device()
    m = pd.m
    G1, G2 = m.G1, m.G2
    p7 = G1.affine(G1.times_scalar(m.g1_gen, 7))[:2]
    pm63 = G1.affine(G1.neg(G1.times_scalar(m.g1_gen, 63)))[:2]
    q9 = G2.affine(G2.times_scalar(m.g2_gen, 9))[:2]
    q1 = G2.affine(m.g2_gen)[:2]
    nm = smoke.N_MNT
    g1, g2 = on_lanes([p7], pd.pack_g1, nm), on_lanes([q9], pd.pack_g2, nm)
    g1f = on_lanes([p7, pm63], pd.pack_g1, nm)
    g2f = on_lanes([q9, q1], pd.pack_g2, nm)
    want = m.F6.exp(m.pairing(m.g1_gen, m.g2_gen), 63)
    batches["mnt6753"] = (lambda: pd.pairing_products(g1, g2), lambda e: all(
        v == want for v in pd.unpack_f6(e)))
    batches["mnt6753 fused"] = (
        lambda: pd.pairing_products_fused(g1f, g2f),
        lambda e: all(v == m.F6.one() for v in pd.unpack_f6(e)))

    names = list(libs)
    out = {name: {b: [] for b in batches} for name in names}
    for turn, (warm, name) in enumerate(turns(names, rounds)):
        cuda_lib._libs.update(libs[name])
        secs = {}
        for b, (run, ok) in batches.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            e = run()
            torch.cuda.synchronize()
            secs[b] = time.perf_counter() - t
            if not ok(e):
                raise AssertionError(f"{b} pairing batch wrong under {name}")
            if not warm:
                out[name][b].append(secs[b])
        print(f"pairing turn {turn} {name}: " + ", ".join(
            f"{b} {s:.4f} s" for b, s in secs.items()), flush=True)
    for name in names:                # then one profiled call of each
        cuda_lib._libs.update(libs[name])
        out[name]["device"] = {b: device_ms(run)
                               for b, (run, _) in batches.items()}
        print(f"pairing {name} on the card: " + json.dumps(
            out[name]["device"]), flush=True)
    return out


def device_ms(run):
    """The card's kernel time in one call of run(), from torch.profiler:
    the sum over its kernels, and the five that take most of it (ms); a
    total of None where the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA]
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:5]
    return {"total_ms": sum(e.self_device_time_total for e in ev) / 1e3
            or None,
            "top_ms": {e.key[:80]: e.self_device_time_total / 1e3
                       for e in top}}


def bls_verify_lanes(smoke):
    """A BLS12-381 runtime, key and chip_smoke.py's N_VERIFY verify lanes
    (re-randomised copies of one proof, bad lanes at fixed places) for a
    62-constraint square chain set up and proved on the card."""
    import wasmsnark_tpu_torch
    from wasmsnark_tpu_torch.groth16.pkey import write_witness
    from wasmsnark_tpu_torch.groth16.setup import (
        setup, square_chain_circuit, square_chain_witness)
    from wasmsnark_tpu_torch.models import curve_module

    m = curve_module("bls12381")
    pkey, vk, _ = setup(square_chain_circuit(62), seed=smoke.SEED % 1000,
                        module=m)
    wit = square_chain_witness(62, 3, r=m.Fr.q)
    rt = wasmsnark_tpu_torch.build_bls12381()
    proof = rt.groth16_gen_proof(write_witness(wit, m.fr_spec), pkey, rng=7)
    return rt, vk, smoke.verify_lanes(m, [str(wit[1])], proof,
                                      smoke.N_VERIFY)


def verify_batches(smoke, libs, cuda_lib, rounds):
    """Seconds of the steady MNT6753 verify batch and of its group map and
    pairing stage (rt._check), and of the steady BLS12-381 verify batch,
    under each variant's libraries, in alternating turns; then the card's
    kernel time in one profiled call of the MNT6753 stage and of the
    BLS12-381 batch under each."""
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
    bls, bvk, (bins, bprs, bwant) = bls_verify_lanes(smoke)
    names = list(libs)
    out = {name: {"batch": [], "pairing": [], "bls_batch": []}
           for name in names}
    for turn, (warm, name) in enumerate(turns(names, rounds)):
        cuda_lib._libs.update(libs[name])
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
        t = time.perf_counter()
        bgot = bls.groth16_verify_batch(bvk, bins, bprs)
        torch.cuda.synchronize()
        bls_s = time.perf_counter() - t
        if got != want or ok != want_ok or bgot != bwant:
            raise AssertionError(f"verify batch wrong under {name}")
        print(f"verify batch turn {turn} {name}: batch {batch_s:.3f} s, "
              f"group map and pairing {pairing_s:.3f} s, BLS12-381 batch "
              f"{bls_s:.3f} s", flush=True)
        if not warm:
            out[name]["batch"].append(batch_s)
            out[name]["pairing"].append(pairing_s)
            out[name]["bls_batch"].append(bls_s)
    for name in names:                # then one profiled call of each
        cuda_lib._libs.update(libs[name])
        out[name]["pairing_device"] = device_ms(lambda: rt._check(
            tt, g1_4, g2_var, coeffs, expected, True))
        out[name]["bls_batch_device"] = device_ms(
            lambda: bls.groth16_verify_batch(bvk, bins, bprs))
        print(f"verify batch {name}: group map and pairing on the card "
              + json.dumps(out[name]["pairing_device"])
              + "; BLS12-381 batch on the card "
              + json.dumps(out[name]["bls_batch_device"]), flush=True)
    return out


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [x for c in t for x in _leaves(c)]
    return [t]


if __name__ == "__main__":
    sys.exit(main())
