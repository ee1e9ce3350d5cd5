#!/usr/bin/env python3
"""Experiment on one NVIDIA card: variants of the field and tower
libraries, built side by side and timed in turns.

    python3 chip_cios_unroll.py [--baseline DIR] [--unrolled]
                                [--variant NAME:DEFINE[,DEFINE...]]
                                [--only PART[,PART...]] [--sass]
                                [--pairings R] [--batches R]

Run from the root of a checkout on a machine with the CUDA toolkit and a
card.  Each variant is the field library `fp_kernels.cu` (8, 12 and 24
words), the MNT6753 library `mnt_kernels.cu` (24 words), the BN128 /
BLS12-381 library `tower_kernels.cu` (8 and 12 words) and the G1 group law
`curve_kernels.cu` (8 and 12 words):

  rolled    the committed sources (mnt_kernels.cu defines FP_CIOS_ROLLED,
            fp.cuh's CIOS outer loop rolled);
  unrolled  with --unrolled, the same with that define removed;
  NAME      with --variant NAME:K1_TEAM_MAX_LANES=0 (say), the committed
            sources built with those -D macros (repeatable; the name
            UNROLLED among them stands for --unrolled's edit);
  baseline  with --baseline DIR, the sources and headers of another
            checkout DIR (an older commit, unpacked with `git archive`),
            as committed there (its entry points must take the same
            arguments as the committed ones).

It compiles every library of every variant at once (one nvcc each) into
the ignored wasmsnark_tpu_torch/_build/cios_unroll/, prints each build's
seconds and each kernel's registers, stack, spill stores, static shared
memory and, where the library reports its blocks' threads
(`mnt_block_threads`, `tower_block_threads`, `curve_block_threads`), the
blocks an SM can hold by those (H100 limits: 64 K registers, 228 KB of
shared memory with 1 KB reserved per block, 2,048 threads and 32
blocks).  Then it binds each variant in turn and times K12 (product and
square), K13 and K14 (doubling and add) at 255, 256, 512 and 2^16 lanes,
K8's product and square, K9 and the Miller doubling and add (K10 at 8
words, K11 at 12) at TOWER_LANES (1,024 to 2^16), and
K5-K7 at 8 and 12 words at the prove's lane counts (CURVE_LANES: K6 at
the MSM's 4, 68, 1,114,112 and 2,228,156, K5 at its one launch's on
inputs shaped as the prove's (chip_smoke.py k5_path_inputs, with the lane
kinds that one prove of each curve gives K5, probed first), K7 at 4 with
the window fold's doublings a launch and with one) and 2^16, on
chip_smoke.py's points (equal, opposite and zero points on a few lanes of
every 2^16; K5's the general case, a random Z1): the median
of CUDA events around each wrapper call, each behind a ~1 ms device
sleep; and the team kernels' C entry points alone (and K1's, one product
a thread), as the mean of 20 launches in a row between two events.  The
variants run in one order and then in the reverse one, and every
variant's results must equal the plain versions' at the smallest lane
count and the first variant's at 2^16 lanes, bit for bit.  K1 and K2
(the add-and-sub pair, as chip_smoke.py's row) are timed the same way at
24 words at FIELD_LANES[24] lanes (the MNT6753 paths' and 2^16) and at 8
and 12 words at their paths' lane counts and 2^16, each checked against
its plain version at every lane count; K3 as the transforms of the prove
(NTT_RUNS: NTTDevice's 2^16-point fft, odd-coset fft and ifft and its
2^17-point ifft over BN128's Fr), each checked against ntt_pass_plain:
the passes of the transform kernel, or under a field library without
k3_ntt_pass (a --baseline from before it) the per-stage loop, which then
runs every NTT, the proves' too (loop_transform: a gather, one
k3_butterfly a stage, a mirror gather and a K1 product by 1/N).  With
--only and a comma-separated
list of fp (K1-K3), tower (K8, K9 and the Miller steps of K10 and K11),
mnt (K12-K14) and curve (K5-K7), only those libraries are built and only
their kernels timed; tower builds tower_kernels.cu.
With --sass it prints,
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
on the circuit) and chip_smoke.py's steady BN128 and BLS12-381 proves
(the 2^16-constraint square chain, set up on the card; the wall time of
groth16_gen_proof) the same way, then the card's kernel time of one call
of the MNT6753 stage, of the BLS12-381 batch and of each prove under
torch.profiler; every batch must return its expected list and every
prove the first turn's proof.  Only the variants' libraries differ
between the turns.

The last line is one JSON object of all of it.
"""

import argparse
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROLLED = "#define FP_CIOS_ROLLED\n"
# the parts --only chooses from: library name prefix -> kernels timed
PARTS = {"fp": "K1-K3", "tower": "K8, K9, the Miller steps",
         "mnt": "K12-K14", "curve": "K5-K7"}
# library -> (source, words)
LIBS = {"fp_kernels_w8": ("fp_kernels.cu", 8),
        "fp_kernels_w12": ("fp_kernels.cu", 12),
        "fp_kernels_w24": ("fp_kernels.cu", 24),
        "mnt_kernels_w24": ("mnt_kernels.cu", 24),
        "tower_kernels_w8": ("tower_kernels.cu", 8),
        "tower_kernels_w12": ("tower_kernels.cu", 12),
        "curve_kernels_w8": ("curve_kernels.cu", 8),
        "curve_kernels_w12": ("curve_kernels.cu", 12)}
BIG = 1 << 16                    # the lane count of the cross-variant check
MNT_LANES = (255, 256, 512, BIG)
# K8, K9 and the Miller steps: the pairing and verify batches' lane
# counts, and more up to 2^16 for where a team kernel stops paying
TOWER_LANES = (1024, 2048, 4096, 8192, 16384, 32768, BIG)
# K1 and K2 per word count: the lane counts their paths launch them with
# most (PERF.md §6: the MNT6753 verify batch's at 24 words, the prove's at
# 8 and 12) and 2^16; at 24 words also those around K1's switch between
# its team product and one thread a lane
FIELD_LANES = {24: (255, 256, 510, 1024, 1530, 2048, 3072, 4096, 6120, BIG),
               8: (2, 3, 6, 1024, 2048, BIG),
               12: (2, 3, 6, 1024, 2048, BIG)}
# K5-K7 per word count: the prove's lane counts (PERF.md §6: K5's one
# launch, on lanes shaped as the prove gives it, "K5 path"; K6's window
# fold 4, its last halving step 68, its triangle's last and first steps
# 1,114,112 and 2,228,156; K7's 4, with the fold's doublings a launch,
# "K7 fold", and with one) and 2^16 (K5 on chip_smoke.py's random-Z
# points, the general case; K7 one doubling a launch)
# K3 (BN128's Fr): the transforms the prove runs, at its two sizes — the
# 2^16-point fft, odd-coset fft and ifft and the 2^17-point ifft — as
# (name, odd coset, inverse)
NTT_RUNS = {BIG: (("fft", False, False), ("odd fft", True, False),
                  ("ifft", False, True)),
            2 * BIG: (("ifft", False, True),)}
CURVE_LANES = {"K5 path": {8: (2_444_827,), 12: (2_388_711,)},
               "K5": {w: (BIG,) for w in (8, 12)},
               "K6": {w: (4, 68, 1_114_112, 2_228_156, BIG) for w in (8, 12)},
               "K7 fold": {w: (4,) for w in (8, 12)},
               "K7": {w: (4, BIG) for w in (8, 12)}}

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
                            "miller_add_kernel"),
    "curve_block_threads": ("jac_madd_kernel", "jac_add_kernel",
                            "jac_dbl_kernel")}


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
    ap.add_argument("--only", default=",".join(PARTS),
                    help="the libraries to build and time, of "
                         + ", ".join(f"{p} ({k})" for p, k in PARTS.items()))
    ap.add_argument("--sass", action="store_true",
                    help="print each kernel's SASS instruction counts")
    ap.add_argument("--pairings", type=int, default=0,
                    help="rounds of the pairing batches per variant")
    ap.add_argument("--batches", type=int, default=0,
                    help="rounds of the verify batches and the proves per "
                         "variant")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(PARTS):
        ap.error(f"--only takes parts of {','.join(PARTS)}")
    parts = {p: p in only for p in PARTS}
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_cios_unroll: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from wasmsnark_tpu_torch.models.bls12381 import bls12381
    from wasmsnark_tpu_torch.models.bn128 import bn128
    from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
    from wasmsnark_tpu_torch.ops import curve as cv
    from wasmsnark_tpu_torch.ops import cuda_lib, fp, ntt, tower_kernels as tk

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
    field, towers, mnt, curves = (parts[k] for k in ("fp", "tower", "mnt",
                                                      "curve"))
    libs, result = build_variants(variants, cuda_lib, {
        lib: sw for lib, sw in LIBS.items()
        if parts[lib.split("_kernels")[0]]}, args.sass)

    transform = ntt.NTTDevice._transform

    def use(name):                    # bind variant name's libraries
        cuda_lib._libs.update(libs[name])
        # a field library from before the transform kernel (a --baseline)
        # runs every NTT, the proves' too, one k3_butterfly a stage
        lib = libs[name].get("fp_kernels_w8")
        ntt.NTTDevice._transform = (
            loop_transform if lib is not None
            and not hasattr(lib, "k3_ntt_pass") else transform)

    result = {"device": smi, **result, "ms": {}}

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
    # Miller doubling points (X, Y, Z, xP, yP) per word count, Z = 0 on
    # lanes 64..95; the add's (X, Y, Z, x2, y2, xP, yP) on the same
    DBL = {w: tuple((rand(specs[w]), rand(specs[w])) for _ in range(3))
           + (rand(specs[w]), rand(specs[w])) for w in (8, 12)}
    for w in DBL:
        for c in DBL[w][2]:
            c[:, 64:96] = 0
    ADD = {w: DBL[w][:3] + tuple((rand(specs[w]), rand(specs[w]))
                                 for _ in range(2)) + DBL[w][3:]
           for w in (8, 12)}
    ins = (A, B, X, Y, Z, xP, yP)
    FX = {w: (rand(specs[w]), rand(specs[w])) for w in FIELD_LANES}
    # K3: 2 * BIG random points of BN128's Fr, their first k at k points
    fr = bn128().fr_spec
    NTT = ntt.NTTDevice(bn128().ntt_spec, fp.FpDevice(fr, DEVICE))
    a = rng.integers(0, 1 << 16, size=(fr.n_limbs, 2 * n), dtype=np.uint32)
    a[-1] = rng.integers(0, fr.q_limbs[-1], size=2 * n, dtype=np.uint32)
    XR = fp.planes(a, DEVICE)

    def k3(x, odd, inverse):
        return (NTT.ifft if inverse else NTT.fft)(x, odd)

    def k3_plain(x, odd, inverse):
        bits = x.shape[1].bit_length() - 1
        p = NTT.plan(bits, odd, inverse)
        return ntt.ntt_pass_plain(fr, x, p["tw"], 0, bits, True,
                                  p.get("invn"))
    # P, Q (Jacobian) and Qa (affine) per word count, as chip_smoke.py's
    PTS = {w: smoke.curve_inputs(m, rng, DEVICE, n)
           for w, m in ((8, bn128()), (12, bls12381()))} if curves else {}
    if curves:
        # K5's lane kinds and K7's doublings a launch on chip_smoke.py's
        # proves, under the first variant's libraries
        use(next(iter(variants)))
        cuda_lib.build()
        probed = probe_proves(smoke, proves(smoke))
        result["prove_probe"] = probed
        print("prove probe: " + json.dumps(probed), flush=True)
        PATH5 = {w: smoke.k5_path_inputs(m, rng, DEVICE, n,
                                         probed[c]["k5_lane_kinds"])
                 for w, m, c in ((8, bn128(), "bn128"),
                                 (12, bls12381(), "bls12381"))}
        FOLD = {8: probed["bn128"]["k7_doublings"],
                12: probed["bls12381"]["k7_doublings"]}

    def cut(t, k):
        return smoke.cut(t, k, n)

    def curve_runs(k):
        """(name, wrapper, plain version) of K5-K7 at k lanes."""
        out = []
        for w, pts in PTS.items():
            if not any(k in c[w] for c in CURVE_LANES.values()):
                continue
            s = specs[w]
            P, Q, Qa = cut(pts, k)
            for row, fn, args, ints in (
                    ("K5 path", "jac_madd", cut(PATH5[w], k), ()),
                    ("K5", "jac_madd", (P, Qa), ()),
                    ("K6", "jac_add", (P, Q), ()),
                    ("K7 fold", "jac_double", (P,), (FOLD[w],)),
                    ("K7", "jac_double", (P,), ())):
                if k in CURVE_LANES[row][w]:
                    out.append((
                        f"{row} @N{w}",
                        lambda s=s, fn=fn, a=args, i=ints: getattr(
                            cv, fn)(s, *a, *i),
                        lambda s=s, fn=fn, a=args, i=ints: getattr(
                            cv, fn + "_plain")(s, *a, *i)))
        return out

    def dbl(w, pts, plain=False):
        """The Miller doubling of the word count's curve on the points
        pts (K10 at 8 words, K11 at 12), or its plain version."""
        if w == 8:
            return (tk.miller_dbl_plain if plain else tk.miller_dbl)(
                specs[w], *pts)
        return (tk.miller_dbl_mtwist_plain if plain
                else tk.miller_dbl_mtwist)(specs[w], *pts, XI[w])

    def add(w, pts, plain=False):
        """The Miller add of the word count's curve, as dbl."""
        if w == 8:
            return (tk.miller_add_plain if plain else tk.miller_add)(
                specs[w], *pts)
        return (tk.miller_add_mtwist_plain if plain
                else tk.miller_add_mtwist)(specs[w], *pts, XI[w])

    def runs(k):
        """The wrappers timed at k lanes: K12-K14 at the MNT6753 lane
        counts, K8, K9 and the Miller steps at TOWER_LANES, K1 and K2
        at FIELD_LANES, K5-K7 at CURVE_LANES."""
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
                out[f"K8 sqr @N{w}"] = (lambda a=a, w=w: tk.f12_sqr(
                    specs[w], a, XI[w]))
                out[f"K9 @N{w}"] = (lambda a=a, w=w: tk.f12_cyc_sqr(
                    specs[w], a, XI[w]))
                out[f"K{10 if w == 8 else 11} dbl"] = (
                    lambda w=w, pts=cut(DBL[w], k): dbl(w, pts))
                out[f"K{10 if w == 8 else 11} add"] = (
                    lambda w=w, pts=cut(ADD[w], k): add(w, pts))
        for w, ks in FIELD_LANES.items():
            if field and k in ks:
                x, y = cut(FX[w], k)
                s = specs[w]
                out[f"K1 @N{w}"] = lambda s=s, x=x, y=y: fp.mont_mul(s, x, y)
                out[f"K2 @N{w}"] = lambda s=s, x=x, y=y: (
                    fp.mod_add(s, x, y), fp.mod_sub(s, x, y))
        for name, odd, inverse in (NTT_RUNS.get(k, ()) if field else ()):
            out[f"K3 {name}"] = (lambda x=XR[:, :k].contiguous(), o=odd,
                                 i=inverse: k3(x, o, i))
        out.update({name: fn for name, fn, _ in curve_runs(k)})
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
                        tk.f12_sqr_plain(specs[w], a, XI[w]),
                        tk.f12_cyc_sqr_plain(specs[w], a, XI[w]),
                        dbl(w, cut(DBL[w], k), plain=True),
                        add(w, cut(ADD[w], k), plain=True)]
        k3s = [k3_plain(XR[:, :k].contiguous(), odd, inverse)
               for _, odd, inverse in (NTT_RUNS.get(k, ()) if field else ())]
        return _leaves(out + field_plain(k) + k3s
                       + [p() for _, _, p in curve_runs(k)])

    def raw(k):
        """The team kernels' C entry points alone on stacked operands, and
        K1's: one base product a thread, for scale."""
        def empty(planes, s):
            return torch.empty((planes, s.n_limbs, k), dtype=torch.int32,
                               device=DEVICE)

        out = {}
        if k in MNT_LANES:
            A, B, X, Y, Z, xP, yP = cut(ins, k)
        if field and k in MNT_LANES:
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
                "K13": ("k13_f6_cyc_sqr", spec, [
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
                out[f"K8 sqr @N{w}"] = ("k8_f12_sqr", specs[w], [
                    a, empty(12, specs[w])], XI[w])
                out[f"K9 @N{w}"] = ("k9_f12_cyc_sqr", specs[w], [
                    a, empty(12, specs[w])], XI[w])
                X, Y, Z, x2, y2, xP, yP = cut(ADD[w], k)
                kid, ints = (10, ()) if w == 8 else (11, XI[w])
                xyz, p = torch.stack([*X, *Y, *Z]), torch.stack([xP, yP])
                out[f"K{kid} dbl"] = (
                    "k10_miller_dbl" if w == 8 else "k11_miller_dbl_mtwist",
                    specs[w], [xyz, p, empty(12, specs[w])], ints)
                out[f"K{kid} add"] = (
                    "k10_miller_add" if w == 8 else "k11_miller_add_mtwist",
                    specs[w], [xyz, torch.stack([*x2, *y2]), p,
                               empty(12, specs[w])], ints)
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

    use(next(iter(variants)))
    if args.pairings or args.batches:
        cuda_lib.build()              # the field and curve libraries
    lanes = sorted(set(MNT_LANES + TOWER_LANES).union(
        NTT_RUNS, *FIELD_LANES.values(), *[ks for c in CURVE_LANES.values()
                                           for ks in c.values()]))
    small = {k: plain(k) for k in lanes if k != n}
    first = None
    order = list(variants) + list(variants)[::-1]
    for turn, name in enumerate(order):
        use(name)
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
                reps = 10 if (k == n and kern.startswith("K14")
                              or k > n) else 30
                ms[f"{kern} @{k}"] = smoke.time_cuda(fn, reps)
            for kern, (fn, s, tensors, ints) in raw(k).items():
                ms[f"{kern} kernel @{k}"] = stream_ms(fn, s, tensors, k, ints)
        result["ms"].setdefault(name, []).append(ms)
        print(f"turn {turn} {name}: " + ", ".join(
            f"{key} {v:.4f}" for key, v in ms.items()), flush=True)
    if args.pairings:
        result["pairing_s"] = pairing_batches(smoke, list(libs), use,
                                              args.pairings)
    if args.batches:
        result["verify_batch_s"] = verify_batches(
            smoke, list(libs), use, args.batches)
    print(json.dumps(result))
    return 0


_STAGE_TABLES: dict = {}


def loop_transform(nd, x, tw, invn):
    """NTTDevice._transform in K3's one-stage design: a bit-reverse gather,
    one k3_butterfly launch a stage, and where invn is given a mirror
    gather and a K1 product by 1/N; the stages' tables cut from the
    transform's table once."""
    import torch
    from wasmsnark_tpu_torch.ops import fp, ntt
    n = x.shape[1]
    bits = n.bit_length() - 1
    key = (tw.data_ptr(), bits)
    if key not in _STAGE_TABLES:
        _STAGE_TABLES[key] = (
            [tw[:, (1 << s) - 1:(2 << s) - 1].contiguous()
             for s in range(bits)],
            torch.from_numpy(ntt._bitrev(bits)).to(x.device),
            (-torch.arange(n, device=x.device)) % n)
    tabs, rev, mirror = _STAGE_TABLES[key]
    y = torch.index_select(x, 1, rev)
    for t in tabs:
        y = ntt.butterfly(nd.field, y, t)
    if invn is not None:
        y = fp.mont_mul(nd.field, torch.index_select(y, 1, mirror), invn)
    return y


def turns(names, rounds):
    """A warm-up turn of the first variant, then rounds of every variant,
    in one order and then in the reverse one."""
    return [(True, names[0])] + [(False, name) for r in range(rounds)
                                 for name in (names if r % 2 == 0
                                              else names[::-1])]


def pairing_batches(smoke, names, use, rounds):
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

    out = {name: {b: [] for b in batches} for name in names}
    for turn, (warm, name) in enumerate(turns(names, rounds)):
        use(name)
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
        use(name)
        out[name]["device"] = {b: device_ms(run)
                               for b, (run, _) in batches.items()}
        print(f"pairing {name} on the card: " + json.dumps(
            out[name]["device"]), flush=True)
    return out


def device_ms(run):
    """The card's kernel time in one call of run(), from torch.profiler:
    the sum over its kernels, and each kernel's, most first (ms); a total
    of None where the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA]
    ev = sorted(ev, key=lambda e: -e.self_device_time_total)
    return {"total_ms": sum(e.self_device_time_total for e in ev) / 1e3
            or None,
            "kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                           for e in ev}}


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


@functools.lru_cache(maxsize=None)
def proves(smoke):
    """Per curve of chip_smoke.py, a function that proves the
    2^16-constraint square chain of chip_smoke.py's setup once, with its
    fixed rng, and returns the proof JSON (set up once a process)."""
    import wasmsnark_tpu_torch
    from wasmsnark_tpu_torch.groth16.pkey import write_witness
    from wasmsnark_tpu_torch.groth16.setup import (
        setup, square_chain_circuit, square_chain_witness)
    from wasmsnark_tpu_torch.models import curve_module

    out = {}
    for curve in smoke.CURVES:
        m = curve_module(curve)
        k = (1 << smoke.LOG_2N) - 2
        pkey, _, _ = setup(square_chain_circuit(k), seed=smoke.SEED % 1000,
                           module=m)
        wbytes = write_witness(square_chain_witness(k, 3, r=m.Fr.q),
                               m.fr_spec)
        rt = {"bn128": wasmsnark_tpu_torch.build_bn128,
              "bls12381": wasmsnark_tpu_torch.build_bls12381}[curve]()
        out[curve] = (lambda rt=rt, w=wbytes, pk=pkey:
                      rt.groth16_gen_proof(w, pk, rng=7))
    return out


def probe_proves(smoke, prove):
    """Per curve, what the prove gives K5 and K7 (chip_smoke.py
    probe_curve_kernels, probed_shapes): K5's lanes by kind, K7's calls
    and their most frequent doublings a launch."""
    from wasmsnark_tpu_torch.models import curve_module
    out = {}
    for curve, run in prove.items():
        _, k5, k7 = smoke.probe_curve_kernels(run)
        out[curve] = smoke.probed_shapes(curve_module(curve).fp_spec, k5, k7)
    return out


def verify_batches(smoke, names, use, rounds):
    """Seconds of the steady MNT6753 verify batch and of its group map and
    pairing stage (rt._ys_g1, then rt._pairing_check), of the steady
    BLS12-381 verify batch and of the steady BN128 and BLS12-381 proves,
    under each variant's libraries, in alternating turns; then the card's
    kernel time in one profiled call of the MNT6753 stage, of the
    BLS12-381 batch and of each prove under each."""
    import random
    import torch
    import wasmsnark_tpu_torch

    rt = wasmsnark_tpu_torch.build_mnt6753()
    vk, ins, prs, want = smoke.mnt_lanes(rt, smoke.N_MNT)
    ok_idx, mb = rt._marshal_batch(vk, ins, prs, random.Random(smoke.SEED))
    g1_4, g2_var, expected = mb.g1_4, mb.g2_var, mb.expected
    tt = rt._hash_to_t(mb.bits)
    coeffs = mb.fixed
    want_ok = [want[i] for i in ok_idx]
    bls, bvk, (bins, bprs, bwant) = bls_verify_lanes(smoke)
    prove = proves(smoke)
    first = {}
    out = {name: {"batch": [], "pairing": [], "bls_batch": [],
                  **{f"prove_{c}": [] for c in prove}} for name in names}
    for turn, (warm, name) in enumerate(turns(names, rounds)):
        use(name)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = rt.bowe_gabizon_verify_batch(vk, ins, prs, fused=True,
                                           rng=random.Random(smoke.SEED))
        torch.cuda.synchronize()
        secs = {"batch": time.perf_counter() - t}
        t = time.perf_counter()
        ok = rt._pairing_check(rt._ys_g1(tt, g1_4), g2_var, coeffs,
                               expected, True).tolist()
        torch.cuda.synchronize()
        secs["pairing"] = time.perf_counter() - t
        t = time.perf_counter()
        bgot = bls.groth16_verify_batch(bvk, bins, bprs)
        torch.cuda.synchronize()
        secs["bls_batch"] = time.perf_counter() - t
        if got != want or ok != want_ok or bgot != bwant:
            raise AssertionError(f"verify batch wrong under {name}")
        for c, run in prove.items():
            t = time.perf_counter()
            proof = run()
            torch.cuda.synchronize()
            secs[f"prove_{c}"] = time.perf_counter() - t
            if first.setdefault(c, proof) != proof:
                raise AssertionError(f"{c} prove differs under {name}")
        print(f"verify batch turn {turn} {name}: " + ", ".join(
            f"{key} {v:.3f} s" for key, v in secs.items()), flush=True)
        if not warm:
            for key, v in secs.items():
                out[name][key].append(v)
    for name in names:                # then one profiled call of each
        use(name)
        out[name]["pairing_device"] = device_ms(lambda: rt._pairing_check(
            rt._ys_g1(tt, g1_4), g2_var, coeffs, expected, True))
        out[name]["bls_batch_device"] = device_ms(
            lambda: bls.groth16_verify_batch(bvk, bins, bprs))
        for c, run in prove.items():
            out[name][f"prove_{c}_device"] = device_ms(run)
        print(f"verify batch {name} on the card: " + json.dumps(
            {k: v for k, v in out[name].items() if k.endswith("_device")}),
            flush=True)
    return out


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [x for c in t for x in _leaves(c)]
    return [t]


if __name__ == "__main__":
    sys.exit(main())
