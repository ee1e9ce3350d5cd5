#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout, with nothing prebuilt:

  1. prints the card (torch and nvidia-smi: name, power limit);
  2. builds the CUDA kernels from wasmsnark_tpu_torch/csrc (nvcc, one call
     per source and word count, in parallel) and prints the seconds;
  3. holds each kernel against its plain PyTorch version on the card —
     K1-K10 at BN128's 8 words, K1, K2, K4-K9 and K11 at BLS12-381's 12,
     and K1, K2 and K12-K14 at MNT6753's 24 — on 2^16 lanes from a seeded
     numpy generator plus edge values (0, 1, q-1, q-2; zero, equal and
     opposite points for the curve kernels; Z = 0 and x2 = X/Z lanes for
     the Miller steps; cyclotomic elements for K13), requiring bit
     equality, and times both with CUDA events;

then, for BN128 and then for BLS12-381, at each curve's full widths:

  4. runs the trusted setup of a 2^16-constraint circuit on the card;
  5. proves twice through build_<curve>().groth16_gen_proof with a fixed
     rng, with every launch counter set to 0 just before the first prove
     and read just after it — each of K1-K7 must have launched; the first
     prove's K5 and K7 calls are probed (their wrappers wrapped, the
     launches unchanged): K5's lanes counted by kind (k5_lane_kinds: P
     zero, Q zero, Z1 = one or not, P = Q, P = -Q, an add) and K7's
     doublings a launch;
  6. verifies the proof on the host (True) and a tampered copy (False), and
     proves a small circuit on the card and with the plain versions on the
     CPU, requiring the same proof JSON;
  7. verifies N = 1024 proofs of the 2^16 circuit in one
     rt.groth16_verify_batch call (re-randomised copies of the proof and
     bad lanes at fixed places), twice, requiring exactly the expected
     list; the counters are set to 0 before the second (steady) call and
     K8 and K9 must have launched as often as the static schedule says;
  8. runs the unprepared device pairing pd.pairing_product on 1024 lanes of
     e(7 G1, 9 G2) against e(G1, G2)^63, with the counters set to 0 before
     it (the curve's Miller-step kernel, K10 or K11, must have launched),
     and holds it against the prepared path on the four pairs of one
     proof, bit for bit;
  9. verifies 4 lanes on the card and with the plain versions on the CPU,
     requiring the same booleans and bit-equal F12 values;

then MNT6753 at its full 753-bit width (48 limbs, 24 words):

 10. verifies N_MNT = 256 lanes through build_mnt6753().
     bowe_gabizon_verify_batch(fused=True) with a seeded rng, twice: 16
     distinct synthetic proofs of one synthetic verification key (a
     trapdoor construction; the Coda test vectors are not in the
     repository) repeated across the lanes, and 4 bad lanes at fixed
     places (tampered c, tampered z, a flipped input, a wrong input
     count), requiring exactly the expected list; the counters are set to
     0 before the second (steady) call and K12 and K13 must have launched
     as often as the static schedule says; the steady call is split into
     host marshalling and device pass; verify and verify_fused on one
     good and one bad proof;
 11. runs the unprepared pd.pairing_products on N_MNT lanes of
     e(7 G1, 9 G2) against the host oracle's e(G1, G2)^63 and
     pd.pairing_products_fused on two pairs per lane,
     e(7 G1, 9 G2) e(-63 G1, G2) = 1, with the counters set to 0 before
     them (K14 must have launched), and holds the unprepared product
     against the prepared path on one proof's five pairs, bit for bit;
 12. holds 4 sampled lanes against the port's host oracle: the card's
     booleans against verify_sync, the card's five-pair F6 values against
     the oracle's pairing product.  The plain versions on the CPU are not
     the reference here: a 753-bit Miller loop has 550 steps, and its CPU
     run would take minutes;

then, for every kernel row:

 13. times it again at the PATH_LANES lane counts its paths launched it
     with most (cuda_lib.lane_launches, read on each path of steps 5-11)
     and at the lane count of its own path, not among those, with the
     most launches x lanes (K6's: the MSM triangle's first step, 2,228,156
     lanes), on the same inputs cut to that many lanes (K5 on inputs
     shaped as its prove launch, k5_path_inputs, with the lane kinds of
     step 5 in their shares; K7 with the prove's doublings a launch),
     after the same bit-equality check, with the bound at that lane
     count (K5's from k5_ops, K7's from k7_ops): the record's
     lanes_at_path, ms_at_path and bound_ms_at_path; the time lost against
     the bound on its own path over the lane counts timed (path_loss_ms,
     path_loss_share of its launches); a model's estimate over all of
     them (path_loss_est_ms, untimed_loss_ms, in the phases' record, not
     the kernels'), checked at one more lane count of the path, estimated
     before it is timed (est_check); and against the
     floor of as many calls as it makes at its word count (K2 on one
     lane, one call or the add-and-sub pair, timed the same way,
     call_floor_ms among the phases): ms_above_floor_at_path.
     K1 at 24 words runs one thread a lane at 2^16 lanes and its team
     product at the MNT6753 paths' lane counts, and K8's product at 8
     words one thread a lane at 2^16 and a team kernel at the BN128
     paths' lane counts, so the two checks hold both of their designs.

Any failure prints its traceback and exits non-zero.  Without a CUDA
device, or outside the repository, it exits non-zero and prints no
result.  A progress line "phases {...}" holds every phase time; the
kernels' JSON record comes two lines before the last, the card's name and
power limit on the line before the last, and the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import faulthandler
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUDGET_S = 840                   # under the 900 s outer timeout: a hang
                                 # prints its stack before it is killed
LOG_2N = 16                      # circuit domain 2^16
N_LANES = 1 << 16                # lanes of each kernel check
SEED = 20261017
DEVICE = "cuda"                  # the card (a host rehearsal sets "cpu")

# H100 SXM peaks at the 700 W limit: HBM bytes/s (NVIDIA data sheet), and
# the 32-bit integer multiply-add rate, a multiply-add counted as 2
# operations as mm_ops counts them.  The CUDA C++ Programming Guide's
# throughput table of arithmetic instructions gives compute capability 9.0
# 64 results a clock an SM for 32-bit integer multiply, multiply-add and
# extended-precision multiply-add, half its 128 for float32 multiply-add:
# so half the data sheet's 67 TFLOP/s of float32 (an FMA as 2 operations).
# Modular adds are counted at the same rate, which leaves the bound a lower
# bound.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12 * 64 / 128
N_VERIFY = 1024                  # proofs per verify batch: the JAX kernels'
                                 # lane tile TOWER_TILE_B (tower_pallas.py)
N_MNT = 256                      # MNT6753 lanes: host marshalling costs
                                 # ~32 ms per lane (3 scalar multiplications
                                 # by rho, the vk_x ladder, alphaBeta^rho)
N_MNT_PROOFS = 16                # distinct synthetic proofs among them
PATH_LANES = 3                   # lane counts each kernel row is also
                                 # timed at: its paths' most frequent
PROVE_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")
CURVES = ("bn128", "bls12381")

# the kernel function behind each C entry point (ptxas reports by kernel);
# K1 at 24 words also launches its team product, mont_mul_team_kernel, and
# K8's product above its switch one thread a lane, f12_mul_thread_kernel
OTHER_DESIGN = {"k1_mont_mul": "mont_mul_team_kernel",
                "k8_f12_mul": "f12_mul_thread_kernel"}
ENTRY_KERNEL = {
    "k1_mont_mul": "mont_mul_kernel", "k2_mod_add": "addsub_kernel",
    "k2_mod_sub": "addsub_kernel", "k3_butterfly": "butterfly_kernel",
    "k4_cneg": "cneg_kernel", "k5_jac_madd": "jac_madd_kernel",
    "k6_jac_add": "jac_add_kernel", "k7_jac_dbl": "jac_dbl_kernel",
    "k8_f12_mul": "f12_mul_kernel", "k8_f12_sqr": "f12_sqr_kernel",
    "k9_f12_cyc_sqr": "f12_cyc_sqr_kernel",
    "k10_miller_dbl": "miller_dbl_kernel",
    "k10_miller_add": "miller_add_kernel",
    "k11_miller_dbl_mtwist": "miller_dbl_kernel",
    "k11_miller_add_mtwist": "miller_add_kernel",
    "k12_f6_mul": "f6_mul_kernel", "k12_f6_sqr": "f6_sqr_kernel",
    "k13_f6_cyc_sqr": "f6_cyc_sqr_kernel",
    "k14_mnt_miller_dbl": "mnt_miller_dbl_kernel",
    "k14_mnt_miller_add": "mnt_miller_add_kernel",
}


def words(spec):
    """32-bit words of one element of the field."""
    return spec.n_limbs // 2


def elem_bytes(spec):
    """Bytes of one element in int32 limb planes (64 B at 8 words, 96 B
    at 12, 192 B at 24)."""
    return spec.n_limbs * 4


def mm_ops(spec):
    """Operations of one CIOS Montgomery product."""
    nw = words(spec)
    return 2 * (2 * nw * nw + nw) + nw


def as_ops(spec):
    """Operations of one modular add or sub."""
    return 3 * words(spec)


def chain(k):
    """Modular adds of fp.cuh mul_small(a, k), a double-and-add from 0."""
    return bin(k).count("1") + k.bit_length() - 1


def xi_ops(xi):
    """Modular adds and subs of one multiplication by xi = c0 + c1 u in
    csrc/tower_kernels.cu (f2_mul_xi: four mul_small double-and-add chains,
    then a sub and an add)."""
    return 2 * (chain(xi[0]) + chain(xi[1])) + 2


def sample_lanes(n):
    """Two good lanes (the proof, a re-randomised copy) and two bad ones
    (pi_a + 1, a wrong input) of verify_lanes(..., n)."""
    return (0, 1, 7, n // 3)

_T0 = time.perf_counter()


def say(msg):
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def time_cuda(fn, reps):
    """Median milliseconds of fn() over reps runs, each between two CUDA
    events, after one warm-up run.  A ~1 ms device sleep is queued ahead of
    each run, so the card is still busy while the host issues the events
    and the launches: the events then bracket device time, not the host's
    launch latency (the plain versions, whose host work outlasts the
    sleep, still include some of theirs)."""
    import torch
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
    return statistics.median(times)


def kernel_name(mangled):
    """The `*_kernel` name inside a mangled symbol: a length-prefixed
    identifier whose length digits may be glued to the hex digits of the
    namespace before it, which can themselves read as a length that ends
    on the same `_kernel`; the innermost (rightmost) candidate wins."""
    found = None
    for i in range(len(mangled)):
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        if j > i and mangled[j - 1].isdigit():
            n = int(mangled[i:j])
            if mangled[j:j + n].endswith("_kernel"):
                found = mangled[j:j + n]
    return found


def ptxas_summary(build_dir):
    """Registers, stack frame, spill bytes and static shared memory of
    every kernel entry function, "<kernel>@N<words>", read from the
    `-Xptxas -v` build logs (<source>_w<words>.log)."""
    import re
    out = {}
    for log in sorted(os.listdir(build_dir)):
        if not log.endswith(".log"):
            continue
        nw = log[:-4].rsplit("_w", 1)[1]
        with open(os.path.join(build_dir, log)) as fh:
            text = fh.read()
        for block in text.split("Compiling entry function")[1:]:
            name = kernel_name(block.split("'")[1])
            name = name and f"{name}@N{nw}"
            props = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", block)
            regs = re.search(r"Used (\d+) registers", block)
            smem = re.search(r"(\d+) bytes smem", block)
            if name and props and regs:
                out[name] = {
                    "registers": int(regs.group(1)),
                    "stack": int(props.group(1)),
                    "spill_stores": int(props.group(2)),
                    "spill_loads": int(props.group(3)),
                    "smem": int(smem.group(1)) if smem else 0}
    return out


def bound(nbytes, ops):
    tb, to = nbytes / PEAK_BYTES, ops / PEAK_OPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def leaves(t):
    """The tensors of a nested tuple, in order."""
    return [x for c in t for x in leaves(c)] if isinstance(t, tuple) else [t]


def mismatch(a, b):
    """(lanes that differ, max |difference| of any limb) of two trees of
    [L, lanes] planes."""
    lanes = None
    err = 0
    for x, y in zip(leaves(a), leaves(b), strict=True):
        d = (x.long() - y.long()).abs()
        bad = d.reshape(d.shape[0], -1).amax(0) != 0
        lanes = bad if lanes is None else lanes | bad
        err = max(err, int(d.max()))
    return int(lanes.sum()), err


def lane_counts(counts, fns, nw):
    """Launches by lane count of the entry points `fns` at word count nw,
    from one path's launches per (entry point, word count, lanes)."""
    out = {}
    for (fn, w, k), v in counts.items():
        if fn in fns and w == nw:
            out[k] = out.get(k, 0) + v
    return out


def cut(t, k, n):
    """The tree of lane-last tensors t of a check made at n lanes, made for
    k: each tensor's last dimension s becomes s k / n, its first lanes
    (repeated where k > n), so the edge lanes stay in front."""
    import torch
    if isinstance(t, (tuple, list)):
        return tuple(cut(c, k, n) for c in t)
    idx = torch.arange(t.shape[-1] * k // n, device=t.device) % t.shape[-1]
    return t[..., idx].contiguous()


def at_path_lanes(kr):
    """Time a kernel row at the PATH_LANES lane counts its paths launch it
    with most often, and at the lane count not among them that carries the
    most of its own path's work (launches x lanes); the bound is that lane
    count's.  Also the time lost against the bound on the row's own path:
    measured over the lane counts timed (path_loss_ms), and estimated over
    all of its launches (path_loss_est_ms, untimed_loss_ms).  The estimate
    is a model, so one more count of the path still untimed is estimated
    first and then timed, the model's error there in est_check: the one
    whose launches x lanes times its distance (log ratio) from the count
    it is scaled from is largest, where an error of the model would count
    most."""
    import math
    total = {}
    for c in kr["lanes_by_path"].values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    lanes = sorted(total, key=lambda k: (-total[k], k))[:PATH_LANES]
    # the row's own path: the one its launches count
    counts = next((c for c in kr["lanes_by_path"].values() if c), {})
    rest = [k for k in counts if k not in lanes]
    if rest:
        lanes.append(max(rest, key=lambda k: (counts[k] * k, k)))
    kr["ms_at_path"], kr["bound_ms_at_path"] = {}, {}
    for k in sorted(lanes):
        time_at_lanes(kr, k)
    kr["est_check"] = None
    rest = [k for k in counts if k not in kr["ms_at_path"]]
    if rest:
        k = max(rest, key=lambda k: (counts[k] * k * abs(
            math.log(k / scaled_from(kr, k))), k))
        est = untimed_loss_ms(kr, k)
        time_at_lanes(kr, k)
        got = kr["ms_at_path"][k] - kr["bound_ms_at_path"][k]
        kr["est_check"] = {"lanes": k, "est_ms": est, "ms": got,
                           "err": est / got - 1 if got > 0 else None}
    kr["lanes_at_path"] = sorted(kr["ms_at_path"])
    # launches x (ms - bound) over the lane counts timed, the share of the
    # path's launches they cover, and the estimate over all of them
    timed = {k: v for k, v in counts.items() if k in kr["ms_at_path"]}
    kr["path_loss_ms"] = sum(v * (kr["ms_at_path"][k]
                                  - kr["bound_ms_at_path"][k])
                             for k, v in timed.items())
    kr["path_loss_share"] = (sum(timed.values()) / sum(counts.values())
                             if counts else 0.0)
    kr["path_loss_est_ms"] = kr["path_loss_ms"] + sum(
        v * untimed_loss_ms(kr, k) for k, v in counts.items()
        if k not in timed)
    c = kr["est_check"]
    say(f"{kr['name']} at path lanes: " + ", ".join(
        f"{k} lanes {kr['ms_at_path'][k]:.4f} ms (bound "
        f"{kr['bound_ms_at_path'][k]:.4f})" for k in kr["lanes_at_path"])
        + f"; lost on its path {kr['path_loss_ms']:.1f} ms "
        f"({kr['path_loss_share']:.0%} of its launches timed), "
        f"{kr['path_loss_est_ms']:.1f} ms estimated over all of them"
        + (f"; the model at {c['lanes']} lanes, before timing: "
           f"{c['est_ms']:.4f} ms lost a launch, timed {c['ms']:.4f}"
           + (f" ({c['err']:+.1%})" if c["err"] is not None else "")
           if c else ""))


def time_at_lanes(kr, k):
    """A kernel row's inputs cut to k lanes: the bit-equality check against
    the plain version, then ms_at_path[k] and bound_ms_at_path[k].  A row
    whose path runs other inputs or arguments than its check (K5's lane
    kinds, K7's doublings a launch) takes them from kr["path_run"] and
    their count of operations from kr["path_ops_of"]."""
    import torch
    fn_k, fn_p, args = kr.get("path_run", kr["run"])
    a = cut(args, k, kr["lanes"])
    got, want = fn_k(*a), fn_p(*a)
    torch.cuda.synchronize()
    if mismatch(got, want)[0]:
        raise AssertionError(f"{kr['name']} disagrees with its plain "
                             f"version at {k} lanes")
    del got, want
    kr["ms_at_path"][k] = time_cuda(lambda: fn_k(*a), 50)
    ops_of = kr.get("path_ops_of", kr.get("ops_of"))
    ops = ops_of(*a) if ops_of else kr["ops"] * k / kr["lanes"]
    kr["bound_ms_at_path"][k] = bound(kr["bytes"] * k / kr["lanes"], ops)[0]


def untimed_loss_ms(kr, k):
    """The ms one launch of the row at k lanes, not timed, is estimated to
    lose against its bound, from the lane count timed nearest to k (by
    ratio) on the same side of the row's check size kr["lanes"] (N_LANES),
    that check included.  Above it the card is full and the loss grows
    with the lanes: (ms - bound) per lane times k.  At or below it the
    launch is counted at that count's ms."""
    big = kr["lanes"]
    ms = {**kr["ms_at_path"], big: kr["ms"]}
    bd = {**kr["bound_ms_at_path"], big: kr["bound_ms"]}
    j = scaled_from(kr, k)
    if k > big:
        return (ms[j] - bd[j]) * k / j
    return ms[j] - bound(kr["bytes"] * k / big, kr["ops"] * k / big)[0]


def scaled_from(kr, k):
    """The lane count timed that untimed_loss_ms scales k from."""
    import math
    big = kr["lanes"]
    return min((j for j in (*kr["ms_at_path"], big)
                if (j >= big if k > big else j <= big)),
               key=lambda j: (abs(math.log(k / j)), j))


def call_floors(dev):
    """The floor of a call at each word count: K2 on one lane, timed as
    every row is (time_cuda), after the same bit-equality check, as one
    call (mod_add) and as two (mod_add and mod_sub, as the K2 rows time
    them).  A row's ms above the floor of as many calls as it makes is
    what a kernel design can still take off; the floor itself only fewer
    launches remove.  Returns {words: {calls: ms}}."""
    import numpy as np
    import torch
    from wasmsnark_tpu_torch.models.bls12381 import bls12381
    from wasmsnark_tpu_torch.models.bn128 import bn128
    from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
    from wasmsnark_tpu_torch.ops import fp

    out = {}
    for m in (bn128(), bls12381(), mnt6753()):
        spec = m.fp_spec
        x, y = (fp.planes(np.array([spec.limbs(v)], dtype=np.uint32).T, dev)
                for v in (spec.q - 1, spec.q // 3))
        runs = {1: (lambda: fp.mod_add(spec, x, y),
                    lambda: fp.mod_add_plain(spec, x, y)),
                2: (lambda: (fp.mod_add(spec, x, y), fp.mod_sub(spec, x, y)),
                    lambda: (fp.mod_add_plain(spec, x, y),
                             fp.mod_sub_plain(spec, x, y)))}
        out[words(spec)] = {}
        for calls, (run, plain) in runs.items():
            got = run()
            torch.cuda.synchronize()
            if mismatch(got, plain())[0]:
                raise AssertionError("K2 disagrees with its plain version "
                                     "on one lane")
            out[words(spec)][calls] = time_cuda(run, 50)
    say("the floor of a call (K2 on one lane, one call / two): " + ", ".join(
        f"{f[1]:.4f} / {f[2]:.4f} ms at {w} words" for w, f in out.items()))
    return out


def check_kernels(dev):
    """Every kernel against its plain version on the card: K1-K10 over
    BN128's fields (8 words), then K1, K2, K4-K9 and K11 over BLS12-381's
    Fq (12 words), with K1-K3 over its Fr (8 words) checked untimed, then
    K1, K2 and K12-K14 over MNT6753's Fq (24 words)."""
    import functools
    import numpy as np
    import torch
    from wasmsnark_tpu_torch.models.bls12381 import bls12381
    from wasmsnark_tpu_torch.models.bn128 import bn128
    from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
    from wasmsnark_tpu_torch.ops import cuda_lib, fp

    rng = np.random.default_rng(SEED)
    n = N_LANES

    def rand(spec, k=n):
        """k canonical values: random limbs under q's top limb, then the
        edge values 0, 1, q-1, q-2 in the first lanes."""
        L = spec.n_limbs
        a = rng.integers(0, 1 << 16, size=(L, k), dtype=np.uint32)
        a[L - 1] = rng.integers(0, spec.q_limbs[-1], size=k, dtype=np.uint32)
        for j, v in enumerate((0, 1, spec.q - 1, spec.q - 2)[:k]):
            a[:, j] = spec.limbs(v)
        return fp.planes(a, dev)

    out = []

    def record(curve, spec, kid, name, source, line, fn_k, fn_p, args,
               nbytes, ops, fns=None):
        a, b = fn_k(*args), fn_p(*args)
        torch.cuda.synchronize()
        bad, err = mismatch(a, b)
        ms = time_cuda(lambda: fn_k(*args), 50)
        plain_ms = time_cuda(lambda: fn_p(*args), 3)
        ops_of = ops if callable(ops) else None
        if ops_of:
            ops = ops_of(*args)
        b_ms, b_by = bound(nbytes, ops)
        nw = words(spec)
        label = f"{kid} {name}" + ("" if nw == 8 else f" @N{nw}")
        out.append({
            "name": label, "route": "cuda",
            "source": f"wasmsnark_tpu_torch/csrc/{source}",
            "replaces": line, "launches": None, "max_abs_err": err,
            "mismatched_lanes": bad, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "bytes": nbytes, "ops": ops, "ops_of": ops_of, "lanes": n,
            "n_words": nw,
            "curve": curve, "fns": fns or cuda_lib.KERNELS[kid][1],
            "run": (fn_k, fn_p, args)})
        say(f"{label}: {bad} mismatched lanes, {ms:.4f} ms "
            f"(plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")

    check_curve_kernels("bn128", bn128(), dev, rng, rand, record, n)
    check_curve_kernels("bls12381", bls12381(), dev, rng, rand, record, n)
    check_mnt_kernels(rand, functools.partial(record, "mnt6753",
                                              mnt6753().fp_spec), n)
    return out


def check_curve_kernels(curve, m, dev, rng, rand, record, n):
    """One curve's field, NTT and G1 kernels, then its tower kernels.  The
    rows are at Fq's word count: K1, K2 and K4-K7 timed over Fq, K3 (over
    Fr) timed only where Fr has Fq's word count (BN128); K1-K3 over Fr are
    checked, untimed, for both curves."""
    import functools
    import torch
    from wasmsnark_tpu_torch.ops import fp, towers, ntt, curve as cv

    Fq, Fr = m.fp_spec, m.fr_spec
    E, MM, AS = elem_bytes(Fq), mm_ops(Fq), as_ops(Fq)
    rec = functools.partial(record, curve, Fq)
    x, y = rand(Fq), rand(Fq).flip(1).contiguous()
    xr, yr = rand(Fr), rand(Fr).flip(1).contiguous()
    # both fields go through K1 and K2 on the prove path; Fr is checked
    # here, Fq below (timed)
    for k, p in ((fp.mont_mul, fp.mont_mul_plain), (fp.mod_add, fp.mod_add_plain),
                 (fp.mod_sub, fp.mod_sub_plain)):
        a, b = k(Fr, xr, yr), p(Fr, xr, yr)
        torch.cuda.synchronize()
        if mismatch(a, b)[0]:
            raise AssertionError(f"{k.__name__} disagrees with its plain "
                                 f"version over {curve} Fr")
    rec("K1", "mont_mul", "fp_kernels.cu",
        "wasmsnark_tpu/ops/fp_pallas.py:214",
        lambda x, y: fp.mont_mul(Fq, x, y),
        lambda x, y: fp.mont_mul_plain(Fq, x, y), (x, y), 3 * E * n, MM * n)
    rec("K2", "mod_add/mod_sub", "fp_kernels.cu",
        "wasmsnark_tpu/ops/fp_pallas.py:299",
        lambda x, y: (fp.mod_add(Fq, x, y), fp.mod_sub(Fq, x, y)),
        lambda x, y: (fp.mod_add_plain(Fq, x, y),
                      fp.mod_sub_plain(Fq, x, y)),
        (x, y), 2 * 3 * E * n, 2 * AS * n)
    # K3 at the first stage (h = 1), a middle one (h = 2^7) and the last
    # (h = n/2, timed): below the last, lanes pair across groups g > 0
    for h in (1, 1 << 7, n // 2):
        tw = rand(Fr, h)
        a, b = ntt.butterfly(Fr, xr, tw), ntt.butterfly_plain(Fr, xr, tw)
        torch.cuda.synchronize()
        if mismatch(a, b)[0]:
            raise AssertionError(f"butterfly disagrees with its plain "
                                 f"version at h = {h} over {curve} Fr")
    if words(Fq) == words(Fr):
        Er = elem_bytes(Fr)
        record(curve, Fr, "K3", "butterfly", "fp_kernels.cu",
               "wasmsnark_tpu/ops/fp_pallas.py:500",
               lambda x, t: ntt.butterfly(Fr, x, t),
               lambda x, t: ntt.butterfly_plain(Fr, x, t), (xr, tw),
               (2 * n + n // 2) * Er,
               (n // 2) * (mm_ops(Fr) + 2 * as_ops(Fr)))
    flag = torch.from_numpy(rng.integers(0, 2, size=n).astype(bool)).to(dev)
    rec("K4", "cneg", "fp_kernels.cu",
        "wasmsnark_tpu/ops/fp_pallas.py:374",
        lambda f, y: towers.mod_cneg(Fq, f, y),
        lambda f, y: towers.mod_cneg_plain(Fq, f, y), (flag, y),
        (2 * E + 1) * n, 2 * words(Fq) * n)

    P, Q, Qa = curve_inputs(m, rng, dev, n)
    rec("K5", "jac_madd", "curve_kernels.cu",
        "wasmsnark_tpu/ops/curve_pallas.py:114",
        lambda P, Qa: cv.jac_madd(Fq, P, Qa),
        lambda P, Qa: cv.jac_madd_plain(Fq, P, Qa), (P, Qa),
        8 * E * n, functools.partial(k5_ops, Fq))
    rec("K6", "jac_add", "curve_kernels.cu",
        "wasmsnark_tpu/ops/curve_pallas.py:53",
        lambda P, Q: cv.jac_add(Fq, P, Q),
        lambda P, Q: cv.jac_add_plain(Fq, P, Q), (P, Q),
        9 * E * n, functools.partial(k6_ops, Fq))
    rec("K7", "jac_dbl", "curve_kernels.cu",
        "wasmsnark_tpu/ops/curve_pallas.py:175",
        lambda P: cv.jac_double(Fq, P),
        lambda P: cv.jac_double_plain(Fq, P), (P,),
        6 * E * n, functools.partial(k7_ops, Fq, 1))
    check_tower_kernels(curve, m, rand, rec, n)


# modular adds and subs of one Karatsuba F2 product (two operand sums,
# three combining subs) and one Karatsuba F6 product (its operand sums of
# three F2 pairs a side, six F2 products, 18 combining adds and subs; two
# multiplications by xi besides)
F2_MUL_ADDS = 2 + 3
F6_MUL_ADDS = 12 + 6 * F2_MUL_ADDS + 18
# K8's square: two F6 products, a0 + a1, a0 + v a1 (one multiplication by
# xi), 2 ab and t - ab - v ab (one)
SQR_ADDS = 2 * F6_MUL_ADDS + 6 + 6 + 6 + 12
# the Miller doubling's team kernel: 8 Karatsuba F2 products, 6 complex
# squares (the sum and the difference of the operand's components, a
# doubling), (Y + Z)^2 and (X + Z)^2 (four operand sums, a doubling and
# the two squares taken off, per component); then per component c_y =
# 2 YZ2, c_x = -3 X2Z, t1 = 9 X4 - 4 V Y2, c_0 = 3 X3 - 2 Y2Z, Z' =
# 4 Y2Z c_y and Y' = 36 X3Y2Z - 27 X6 - 8 Y4Z2
DBL_ADDS = (8 * F2_MUL_ADDS + 6 * 3 + 2 * 9
            + 2 * (1 + 3 + chain(9) + chain(4) + 1 + chain(3) + 2 + 2
                   + chain(36) + chain(27) + chain(8) + 2))
# per C entry point of the tower kernels: (Montgomery products, modular
# adds and subs besides those of xi, multiplications by xi), counted from
# csrc/tower_kernels.cu's formulas (small multiples as double-and-add
# chains); K8's square and the doubling from what their results need, a
# sum of operands counted once where the team's product items share it
TOWER_OPS = {
    "k8_f12_mul": (54, 182, 7), "k8_f12_sqr": (36, SQR_ADDS, 6),
    "k9_f12_cyc_sqr": (18, 83, 4),
    "k10_miller_dbl": (44, DBL_ADDS, 0), "k10_miller_add": (41, 79, 0),
    "k11_miller_dbl_mtwist": (44, DBL_ADDS, 1),
    "k11_miller_add_mtwist": (41, 79, 1),
}


def check_tower_kernels(curve, m, rand, rec, n):
    """K8, K9 and the curve's Miller steps (K10 for BN128, K11 for
    BLS12-381) against their plain versions on the card, at the curve's xi.
    Bytes are the operand and output planes, one element each per lane."""
    from wasmsnark_tpu_torch.ops import cuda_lib, fp, tower_kernels as tk
    from wasmsnark_tpu_torch.ops.pairing import pairing_device
    from wasmsnark_tpu_torch.utils.serialize import (ints_to_limbs_fast,
                                                     limbs_to_ints)
    Fq = m.fp_spec
    E = elem_bytes(Fq)
    xi = pairing_device(curve).XI

    def ops(fn):
        prods, adds, n_xi = TOWER_OPS[fn]
        return (prods * mm_ops(Fq) + (adds + n_xi * xi_ops(xi))
                * as_ops(Fq)) * n

    src, pl = "tower_kernels.cu", "wasmsnark_tpu/ops/tower_pallas.py"
    a = tk.unflatten12([rand(Fq) for _ in range(12)])
    b = tk.unflatten12([rand(Fq) for _ in range(12)])
    rec("K8", "f12_mul", src, f"{pl}:75",
        lambda a, b: tk.f12_mul(Fq, a, b, xi),
        lambda a, b: tk.f12_mul_plain(Fq, a, b, xi), (a, b), 36 * E * n,
        ops("k8_f12_mul"), fns=("k8_f12_mul",))
    rec("K8", "f12_sqr", src, f"{pl}:75", lambda a: tk.f12_sqr(Fq, a, xi),
        lambda a: tk.f12_sqr_plain(Fq, a, xi), (a,), 24 * E * n,
        ops("k8_f12_sqr"), fns=("k8_f12_sqr",))
    rec("K9", "f12_cyc_sqr", src, f"{pl}:90",
        lambda a: tk.f12_cyc_sqr(Fq, a, xi),
        lambda a: tk.f12_cyc_sqr_plain(Fq, a, xi), (a,), 24 * E * n,
        ops("k9_f12_cyc_sqr"))
    X, Y, Z, x2, y2 = [(rand(Fq), rand(Fq)) for _ in range(5)]
    xP, yP = rand(Fq), rand(Fq)
    for c in Z:                               # lanes 64..95: Z = 0
        c[:, 64:96] = 0
    # lanes 96..127: x2 = X/Z, where the add step's lambda = x2 Z - X = 0
    sl = slice(96, 128)

    def vals(p):
        return [Fq.from_mont(v) for v in limbs_to_ints(fp.to_numpy(p[:, sl]))]

    xz = [m.F2.mul((u0, u1), m.F2.inv((z0, z1)))
          for u0, u1, z0, z1 in zip(*(vals(p) for p in (*X, *Z)))]
    for k in range(2):
        x2[k][:, sl] = fp.planes(ints_to_limbs_fast(
            [Fq.to_mont(v[k]) for v in xz], Fq.n_limbs), X[0].device)
    if curve == "bn128":
        kid, dbl, add = "K10", "miller_dbl", "miller_add"
        k_dbl, p_dbl = tk.miller_dbl, tk.miller_dbl_plain
        k_add, p_add = tk.miller_add, tk.miller_add_plain
        lines, extra = (f"{pl}:100", f"{pl}:134"), ()
    else:
        kid, dbl, add = "K11", "miller_dbl_mtwist", "miller_add_mtwist"
        k_dbl, p_dbl = tk.miller_dbl_mtwist, tk.miller_dbl_mtwist_plain
        k_add, p_add = tk.miller_add_mtwist, tk.miller_add_mtwist_plain
        lines, extra = (f"{pl}:164", f"{pl}:205"), (xi,)
    fn_dbl, fn_add = cuda_lib.KERNELS[kid][1]
    rec(kid, dbl, src, lines[0],
        lambda *a: k_dbl(Fq, *a, *extra), lambda *a: p_dbl(Fq, *a, *extra),
        (X, Y, Z, xP, yP), 20 * E * n, ops(fn_dbl), fns=(fn_dbl,))
    rec(kid, add, src, lines[1],
        lambda *a: k_add(Fq, *a, *extra), lambda *a: p_add(Fq, *a, *extra),
        (X, Y, Z, x2, y2, xP, yP), 24 * E * n, ops(fn_add), fns=(fn_add,))
    a0 = k_add(Fq, X, Y, Z, x2, y2, xP, yP, *extra)[0][0]
    if any(int(p[:, sl].abs().sum()) for p in a0):
        raise AssertionError("the x2 = X/Z lanes are not degenerate")


# MNT6753 (csrc/mnt_kernels.cu): modular adds and subs of one F3 product
# (six operand sums, three two-term differences, three final adds and two
# multiplications by 11), and per entry point (Montgomery products, modular
# adds and subs) counted from the kernel's formulas (K14's doubling: 14 F3
# products and 6 base ones, Y3 Z3 and Y4 Z2 from Y2Z)
F3_MUL_ADDS = 6 + 6 + 3 + 2 * chain(11)
MNT_OPS = {
    "k12_f6_mul": (18, 3 * F3_MUL_ADDS + 15 + chain(11)),
    "k12_f6_sqr": (12, 2 * F3_MUL_ADDS + 15 + 2 * chain(11)),
    "k13_f6_cyc_sqr": (9, 36 + 4 * chain(11)),
    "k14_mnt_miller_dbl": (14 * 6 + 6, 14 * F3_MUL_ADDS + 18 + 9 * chain(2)
                           + 9 * chain(8) + 3 * chain(3) + 8 * chain(11)
                           + 3 * chain(12)),
    "k14_mnt_miller_add": (13 * 6 + 6, 13 * F3_MUL_ADDS + 24 + 3 * chain(11)
                           + 3 * chain(2)),
}


def check_mnt_kernels(rand, rec, n):
    """K1 and K2 over MNT6753's Fq (24 words), then K12 (F6 product and
    square), K13 (on cyclotomic elements: the easy part of the final
    exponentiation, computed on the card, of random F6 values) and K14
    (with Z = 0 lanes and x2 = X/Z lanes), against their plain versions."""
    from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
    from wasmsnark_tpu_torch.ops import fp, tower_kernels as tk
    from wasmsnark_tpu_torch.ops.pairing import mnt6753_pairing_device
    from wasmsnark_tpu_torch.utils.serialize import (ints_to_limbs_fast,
                                                     limbs_to_ints)
    m = mnt6753()
    Fq = m.fp_spec
    E, MM, AS = elem_bytes(Fq), mm_ops(Fq), as_ops(Fq)

    def ops(fn):
        prods, adds = MNT_OPS[fn]
        return (prods * MM + adds * AS) * n

    x, y = rand(Fq), rand(Fq).flip(1).contiguous()
    pf = "wasmsnark_tpu/ops/fp_pallas.py"
    rec("K1", "mont_mul", "fp_kernels.cu", f"{pf}:214",
        lambda x, y: fp.mont_mul(Fq, x, y),
        lambda x, y: fp.mont_mul_plain(Fq, x, y), (x, y), 3 * E * n, MM * n)
    rec("K2", "mod_add/mod_sub", "fp_kernels.cu", f"{pf}:299",
        lambda x, y: (fp.mod_add(Fq, x, y), fp.mod_sub(Fq, x, y)),
        lambda x, y: (fp.mod_add_plain(Fq, x, y),
                      fp.mod_sub_plain(Fq, x, y)),
        (x, y), 2 * 3 * E * n, 2 * AS * n)

    src, pl = "mnt_kernels.cu", "wasmsnark_tpu/ops/tower_pallas.py"
    a = tk.unflatten6([rand(Fq) for _ in range(6)])
    b = tk.unflatten6([rand(Fq) for _ in range(6)])
    rec("K12", "f6_mul", src, f"{pl}:419",
        lambda a, b: tk.mnt_f6_mul(Fq, a, b),
        lambda a, b: tk.mnt_f6_mul_plain(Fq, a, b), (a, b), 18 * E * n,
        ops("k12_f6_mul"), fns=("k12_f6_mul",))
    rec("K12", "f6_sqr", src, f"{pl}:419", lambda a: tk.mnt_f6_sqr(Fq, a),
        lambda a: tk.mnt_f6_sqr_plain(Fq, a), (a,), 12 * E * n,
        ops("k12_f6_sqr"), fns=("k12_f6_sqr",))
    pd = mnt6753_pairing_device()
    t = pd._f6_mul(pd._f6_conj(a), pd.F6d.inv(a))
    cyc = pd._f6_mul(pd.frobenius(t), t)         # the easy part
    rec("K13", "f6_cyc_sqr", src, f"{pl}:437",
        lambda c: tk.mnt_f6_cyc_sqr(Fq, c),
        lambda c: tk.mnt_f6_cyc_sqr_plain(Fq, c), (cyc,), 12 * E * n,
        ops("k13_f6_cyc_sqr"))
    # on the cyclotomic subgroup K13 is the square
    if mismatch(tk.mnt_f6_cyc_sqr(Fq, cyc), tk.mnt_f6_sqr(Fq, cyc))[0]:
        raise AssertionError("K13 differs from the square on the easy "
                             "part's outputs")
    X, Y, Z, x2, y2 = [tuple(rand(Fq) for _ in range(3)) for _ in range(5)]
    xP, yP = rand(Fq), rand(Fq)
    for c in Z:                               # lanes 64..95: Z = 0
        c[:, 64:96] = 0
    sl = slice(96, 128)                       # lanes 96..127: x2 = X/Z

    def vals(p):
        return [Fq.from_mont(v) for v in limbs_to_ints(fp.to_numpy(p[:, sl]))]

    xz = [m.F3.mul(u, m.F3.inv(z)) for u, z in zip(
        zip(*(vals(p) for p in X)), zip(*(vals(p) for p in Z)))]
    for k in range(3):
        x2[k][:, sl] = fp.planes(ints_to_limbs_fast(
            [Fq.to_mont(v[k]) for v in xz], Fq.n_limbs), X[0].device)
    rec("K14", "mnt_miller_dbl", src, f"{pl}:447",
        lambda *a: tk.mnt_miller_dbl(Fq, *a),
        lambda *a: tk.mnt_miller_dbl_plain(Fq, *a), (X, Y, Z, xP, yP),
        26 * E * n, ops("k14_mnt_miller_dbl"), fns=("k14_mnt_miller_dbl",))
    rec("K14", "mnt_miller_add", src, f"{pl}:459",
        lambda *a: tk.mnt_miller_add(Fq, *a),
        lambda *a: tk.mnt_miller_add_plain(Fq, *a),
        (X, Y, Z, x2, y2, xP, yP), 32 * E * n, ops("k14_mnt_miller_add"),
        fns=("k14_mnt_miller_add",))
    (a0, _), *_ = tk.mnt_miller_add(Fq, X, Y, Z, x2, y2, xP, yP)
    if any(int(p[:, sl].abs().sum()) for p in a0):
        raise AssertionError("the x2 = X/Z lanes are not degenerate")


def k6_ops(Fq, P, Q):
    """K6's operations on these inputs, counted per lane from what its
    result needs (csrc/curve_kernels.cu jac_add_kernel): none where an
    operand is zero; on the others the 8 products and 3 adds and subs of
    H and r; besides those, where P = Q the doubling's 7 products and 14
    adds and subs, where H != 0 the add's other 8 products and 8 adds and
    subs; and nothing more where P = -Q.  The lanes are told apart with the
    plain field product."""
    import functools
    from wasmsnark_tpu_torch.ops import fp
    mul = functools.partial(fp.mont_mul_plain, Fq)
    (X1, Y1, Z1), (X2, Y2, Z2) = P, Q
    z11, z22 = mul(Z1, Z1), mul(Z2, Z2)
    h0 = (mul(X1, z22) == mul(X2, z11)).all(0)
    r0 = (mul(Y1, mul(Z2, z22)) == mul(Y2, mul(Z1, z11))).all(0)
    live = (Z1 != 0).any(0) & (Z2 != 0).any(0)
    MM, AS = mm_ops(Fq), as_ops(Fq)
    return (int(live.sum()) * (8 * MM + 3 * AS)
            + int((live & h0 & r0).sum()) * (7 * MM + 14 * AS)
            + int((live & ~h0).sum()) * (8 * MM + 8 * AS))


def k5_lane_kinds(Fq, P, Qa):
    """K5's lanes by kind (csrc/curve_kernels.cu jac_madd_kernel), told
    apart with the plain field product: P zero (p_zero), else Q the affine
    zero (q_zero), else by Z1, Montgomery one ("one_") or not ("z_"), and
    by what the add comes to, P = Q ("dbl"), P = -Q ("neg") or an add
    ("add").  Returns {kind: lanes}."""
    import functools
    import torch
    from wasmsnark_tpu_torch.ops import fp
    mul = functools.partial(fp.mont_mul_plain, Fq)
    (X1, Y1, Z1), (X2, Y2) = P, Qa
    p_zero = ~(Z1 != 0).any(0)
    q_zero = ~p_zero & ~(X2 != 0).any(0) & ~(Y2 != 0).any(0)
    live = ~p_zero & ~q_zero
    one = torch.tensor(Fq.limbs(Fq.one_mont), dtype=Z1.dtype,
                       device=Z1.device)[:, None]
    z_one = (Z1 == one).all(0)
    z11 = mul(Z1, Z1)
    h0 = (mul(X2, z11) == X1).all(0)
    r0 = (mul(Y2, mul(Z1, z11)) == Y1).all(0)
    out = {"p_zero": int(p_zero.sum()), "q_zero": int(q_zero.sum())}
    for z, zs in (("one_", z_one), ("z_", ~z_one)):
        for law, mask in (("dbl", h0 & r0), ("neg", h0 & ~r0),
                          ("add", ~h0)):
            out[z + law] = int((live & zs & mask).sum())
    return out


def k5_ops(Fq, P, Qa):
    """K5's operations on these inputs, counted per lane from what its
    result needs (csrc/curve_kernels.cu jac_madd_kernel; lanes by
    k5_lane_kinds): none where an operand is zero; on the others the 3
    adds and subs of H and r, and where Z1 is not Montgomery one the 4
    products before them (Z1^2, U2, Z1^3, S2); besides those, where P = Q
    the doubling's 7 products and 14 adds and subs, where H != 0 the add's
    6 products and 7 adds and subs (I, J, V, r^2, Y1 J, r (V - X3); 2H,
    which is Z3 where Z1 is one), and one product and one add more where
    Z1 is not one (Z3 = 2 Z1 H); nothing more where P = -Q."""
    k = k5_lane_kinds(Fq, P, Qa)
    MM, AS = mm_ops(Fq), as_ops(Fq)
    live = sum(v for key, v in k.items() if key.startswith(("one_", "z_")))
    general = sum(v for key, v in k.items() if key.startswith("z_"))
    dbl = k["one_dbl"] + k["z_dbl"]
    add = k["one_add"] + k["z_add"]
    return (live * 3 * AS + general * 4 * MM + dbl * (7 * MM + 14 * AS)
            + add * (6 * MM + 7 * AS) + k["z_add"] * (MM + AS))


def k7_ops(Fq, times, P):
    """K7's operations on these inputs: `times` doublings of 7 products
    and 11 adds and subs on every lane whose Z is not zero (a zero point is
    left as it is)."""
    live = int((P[2] != 0).any(0).sum())
    return times * live * (7 * mm_ops(Fq) + 11 * as_ops(Fq))


def probe_curve_kernels(run):
    """run() with ops.curve's K5 and K7 wrappers wrapped, their launches
    unchanged: returns run()'s result, the operands of every K5 call and
    the (lanes, doublings) of every K7 call."""
    from wasmsnark_tpu_torch.ops import curve as cv
    madd, dbl = cv.jac_madd, cv.jac_double
    k5, k7 = [], []

    def jac_madd(spec, p, q):
        k5.append((p, q))
        return madd(spec, p, q)

    def jac_double(spec, p, times=1):
        k7.append((p[0][0].numel(), times))
        return dbl(spec, p, times)

    cv.jac_madd, cv.jac_double = jac_madd, jac_double
    try:
        return run(), k5, k7
    finally:
        cv.jac_madd, cv.jac_double = madd, dbl


def probed_shapes(Fq, k5_calls, k7_calls):
    """What probe_curve_kernels saw: K5's lanes by kind over its calls
    (k5_lane_kinds), K7's calls by lanes and doublings, and the doublings
    a launch most of them made."""
    import collections
    kinds = collections.Counter()
    for P, Qa in k5_calls:
        kinds.update(k5_lane_kinds(Fq, P, Qa))
    k7 = collections.Counter(k7_calls)
    return {"k5_lane_kinds": dict(kinds),
            "k7_calls": {f"{k} lanes x {t} doublings": v
                         for (k, t), v in sorted(k7.items())},
            "k7_doublings": collections.Counter(
                t for _, t in k7_calls).most_common(1)[0][0]}


def k5_path_inputs(m, rng, dev, n, kinds):
    """K5's operands on n lanes shaped as the prove's launch: the lane
    kinds of k5_lane_kinds in its counts' shares (each kind it holds on at
    least one lane, adds on the rest), in a random order.  P is promoted
    from affine points, (X, Y, one), and (0, one, 0) where P is zero; on
    lanes of a general Z1 ("z_" kinds) it is scaled by a random Z.  Q is
    affine: the affine zero (0, 0), P's point (P = Q), P's point with Y
    negated as K4 leaves it (P = -Q), or another of 256 distinct G1
    points."""
    import numpy as np
    import torch
    from wasmsnark_tpu_torch.ops import fp
    from wasmsnark_tpu_torch.utils.serialize import ints_to_limbs_fast

    Fq, G = m.fp_spec, m.G1
    total = sum(kinds.values())
    share = {k: max(1, round(v * n / total)) if v else 0
             for k, v in kinds.items() if k != "one_add"}
    share["one_add"] = n - sum(share.values())
    lane_kind = np.concatenate([np.full(v, i) for i, v in enumerate(
        share.values())])
    rng.shuffle(lane_kind)
    names = list(share)
    kind = {k: torch.from_numpy(lane_kind == names.index(k)).to(dev)
            for k in names}
    ks = [int(k) for k in rng.integers(1, 2 ** 62, size=256)]
    aff = [G.affine(G.times_scalar(m.g1_gen, k)) for k in ks]

    def mont(vals):
        return fp.planes(ints_to_limbs_fast(
            [Fq.to_mont(v) for v in vals], Fq.n_limbs), dev)

    X, Y = mont([a[0] for a in aff]), mont([a[1] for a in aff])
    ip = rng.integers(0, 256, size=n)
    iq = (ip + rng.integers(1, 256, size=n)) % 256    # another point
    same = lane_kind == names.index("one_dbl")
    same |= lane_kind == names.index("z_dbl")
    neg = (lane_kind == names.index("one_neg")) | (
        lane_kind == names.index("z_neg"))
    iq = np.where(same | neg, ip, iq)
    ip, iq = (torch.from_numpy(v).to(dev) for v in (ip, iq))
    px, py, qx, qy = X[:, ip], Y[:, ip], X[:, iq], Y[:, iq]
    neg = torch.from_numpy(neg).to(dev)
    qy = torch.where(neg[None], fp.mod_sub_plain(Fq, torch.zeros_like(qy),
                                                 qy), qy)
    one = mont([1])
    pz = one.expand(-1, n).clone()
    general = sum(kind[k] for k in names if k.startswith("z_")).bool()
    zs = mont([int(v) for v in rng.integers(1, 2 ** 62, size=n)])
    zz = fp.mont_mul_plain(Fq, zs, zs)
    px = torch.where(general[None], fp.mont_mul_plain(Fq, px, zz), px)
    py = torch.where(general[None], fp.mont_mul_plain(
        Fq, py, fp.mont_mul_plain(Fq, zz, zs)), py)
    pz = torch.where(general[None], zs, pz)
    pzero, qzero = kind["p_zero"][None], kind["q_zero"][None]
    px = torch.where(pzero, 0, px)
    py = torch.where(pzero, one, py)
    pz = torch.where(pzero, 0, pz)
    qx = torch.where(qzero, 0, qx)
    qy = torch.where(qzero, 0, qy)
    return tuple(t.contiguous() for t in (px, py, pz)), (qx.contiguous(),
                                                          qy.contiguous())


def curve_inputs(m, rng, dev, n):
    """Jacobian P, Jacobian Q and affine Qa over 2^16 lanes: 256 distinct
    G1 points tiled at random, random Z scalings, and special lanes —
    P = Q, P = -Q, P = 0, Q = 0 (affine (0, 0)), both zero."""
    import numpy as np
    import torch
    from wasmsnark_tpu_torch.ops import fp
    from wasmsnark_tpu_torch.utils.serialize import ints_to_limbs_fast

    Fq = m.fp_spec
    G = m.G1
    ks = [int(k) for k in rng.integers(1, 2 ** 62, size=256)]
    aff = [G.affine(G.times_scalar(m.g1_gen, k)) for k in ks]

    def mont(vals):
        return fp.planes(ints_to_limbs_fast(
            [Fq.to_mont(v) for v in vals], Fq.n_limbs), dev)

    X, Y = mont([a[0] for a in aff]), mont([a[1] for a in aff])
    ip = torch.from_numpy(rng.integers(0, 256, size=n)).to(dev)
    iq = torch.from_numpy(rng.integers(0, 256, size=n)).to(dev)
    iq[:64] = ip[:64]                                 # P = +-Q lanes
    px, py = X[:, ip], Y[:, ip]
    qx, qy = X[:, iq], Y[:, iq]
    qy[:, 32:64] = fp.mod_sub_plain(Fq, torch.zeros_like(qy[:, 32:64]),
                                    qy[:, 32:64])      # P = -Q
    zs = [int(v) for v in rng.integers(1, 2 ** 62, size=2 * n)]
    z1, z2 = mont(zs[:n]), mont(zs[n:])

    def jac(x, y, z):
        zz = fp.mont_mul_plain(Fq, z, z)
        return (fp.mont_mul_plain(Fq, x, zz),
                fp.mont_mul_plain(Fq, y, fp.mont_mul_plain(Fq, zz, z)), z)

    P = jac(px, py, z1)
    Q = jac(qx, qy, z2)
    Qa = (qx.clone(), qy.clone())
    zero = slice(64, 96)                              # P = 0
    P[2][:, zero] = 0
    qz = slice(96, 128)                               # Q = 0
    Q[2][:, qz] = 0
    Qa[0][:, qz] = 0
    Qa[1][:, qz] = 0
    both = slice(128, 160)                            # both zero
    P[2][:, both] = 0
    Q[2][:, both] = 0
    Qa[0][:, both] = 0
    Qa[1][:, both] = 0
    return P, Q, Qa


def f12_schedule(pd, n_pairs, prepared):
    """Launches of each tower entry point that one pairing product over
    n_pairs pairs makes, from the static schedules: a line multiply per
    Miller step and a square per dbl step; log2(n_pairs) multiplies for the
    pairs; 2 multiplies in the easy part; then the hard part: for BN128
    three z-powers of (bits(z) - 1) cyclotomic squarings and (popcount(z) -
    1) multiplies each, then the chain's 13 multiplies and 4 cyclotomic
    squarings; for BLS12-381 the 4-bit window ladder's 14 table multiplies,
    4 cyclotomic squarings per window after the first and a multiply per
    nonzero one."""
    from wasmsnark_tpu_torch.ops.pairing import window_digits
    flags = pd._prep_flags
    steps, dbls = len(flags), int((flags == 0).sum())
    if hasattr(pd, "z_bits"):
        zbits, zpop = len(pd.z_bits), int(pd.z_bits.sum())
        hard_mul, hard_sqr = 3 * (zpop - 1) + 13, 3 * (zbits - 1) + 4
        dbl_fn, add_fn = "k10_miller_dbl", "k10_miller_add"
    else:
        digits = window_digits(pd._hard_exp, 4)
        hard_mul = 14 + sum(1 for d in digits[1:] if d)
        hard_sqr = 4 * (len(digits) - 1)
        dbl_fn, add_fn = "k11_miller_dbl_mtwist", "k11_miller_add_mtwist"
    sched = dict.fromkeys(TOWER_FNS, 0)
    sched.update({
        "k8_f12_mul": steps + (n_pairs.bit_length() - 1) + 2 + hard_mul,
        "k8_f12_sqr": dbls,
        "k9_f12_cyc_sqr": hard_sqr,
        dbl_fn: 0 if prepared else dbls,
        add_fn: 0 if prepared else steps - dbls,
    })
    return sched


TOWER_FNS = ("k8_f12_mul", "k8_f12_sqr", "k9_f12_cyc_sqr", "k10_miller_dbl",
             "k10_miller_add", "k11_miller_dbl_mtwist", "k11_miller_add_mtwist")


def tower_counts(counts):
    return {fn: counts[fn] for fn in TOWER_FNS}


def rerandomised(m, proof, r):
    """The proof with A' = r^-1 A and B' = r B: valid for the same input,
    since e(A', B') = e(A, B)."""
    from wasmsnark_tpu_torch.groth16 import verifier
    R = m.Fr.q
    a = m.G1.affine(m.G1.times_scalar(
        verifier._g1_from_json(m, proof["pi_a"]), pow(r, -1, R)))
    b = m.G2.affine(m.G2.times_scalar(
        verifier._g2_from_json(m, proof["pi_b"]), r))
    return dict(proof, pi_a=[str(v) for v in a],
                pi_b=[[str(c) for c in v] for v in b])


def verify_lanes(m, pub, proof, n):
    """n lanes: the proof and 64 re-randomised copies, with bad lanes at
    fixed places.  Returns (inputs, proofs, expected)."""
    import random
    rng = random.Random(SEED)
    good = [proof] + [rerandomised(m, proof, rng.randrange(1, m.Fr.q))
                      for _ in range(64)]
    tampered = json.loads(json.dumps(proof))
    tampered["pi_a"][0] = str(int(tampered["pi_a"][0]) + 1)
    bad = {7: (pub, tampered),                          # pi_a + 1
           n // 3: ([str(int(pub[0]) + 1)], proof),     # wrong input
           n // 2: ([str(int(pub[0]) + m.Fr.q)], proof),  # input >= r
           2 * n // 3: (pub + ["1"], proof),            # wrong count
           n - 1: (pub, dict(proof, pi_a=["0", "1", "0"]))}  # pi_a = 0
    ins, prs, want = [], [], []
    for i in range(n):
        inp, prf = bad.get(i, (pub, good[i % len(good)]))
        ins.append(inp)
        prs.append(prf)
        want.append(i not in bad)
    return ins, prs, want


def verify_batch(rt, vk, lanes, phases):
    """N_VERIFY proofs through rt.groth16_verify_batch, twice; returns the
    launches per (entry point, word count, lanes) of the steady call."""
    import torch
    from wasmsnark_tpu_torch.groth16 import verifier
    from wasmsnark_tpu_torch.ops import cuda_lib
    from wasmsnark_tpu_torch.ops.pairing import pairing_device

    m = rt.module
    pd = pairing_device(rt.CURVE)
    ins, prs, want = lanes
    say(f"{rt.CURVE} verify batch: {N_VERIFY} proofs, {want.count(False)} "
        "bad lanes")
    pd.vk_prep_cache.clear()
    for name in ("first", "steady"):
        if name == "steady":
            cuda_lib.reset_launches()
        t = time.perf_counter()
        got = rt.groth16_verify_batch(vk, ins, prs)
        torch.cuda.synchronize()
        phases[f"verify_{name}_s"] = time.perf_counter() - t
        if got != want:
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"verify batch ({name}) wrong at lanes "
                                 f"{bad[:20]}")
    counts = dict(cuda_lib.fn_launches)
    by_lanes = dict(cuda_lib.lane_launches)
    phases["verify_proofs_per_s"] = N_VERIFY / phases["verify_steady_s"]
    phases["verify_launches"] = {k: v for k, v in counts.items() if v}
    say(f"{rt.CURVE} verify batch: first {phases['verify_first_s']:.2f} s, "
        f"steady {phases['verify_steady_s']:.2f} s "
        f"({phases['verify_proofs_per_s']:.1f} proofs/s); launches "
        f"{phases['verify_launches']}")
    sched = f12_schedule(pd, 4, prepared=True)
    if tower_counts(counts) != sched:
        raise AssertionError(f"verify batch launches {tower_counts(counts)} "
                             f"are not the static schedule's {sched}")

    # where the steady time goes: host marshalling, then the device half
    t = time.perf_counter()
    g1, g2_b, fixed, ok_host = verifier._batch_inputs(pd, m, vk, ins, prs)
    torch.cuda.synchronize()
    phases["verify_host_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ok = pd.is_one(verifier._pairing_batch(pd, g1, g2_b, fixed)).tolist()
    phases["verify_device_s"] = time.perf_counter() - t
    if [bool(a) and b for a, b in zip(ok, ok_host)] != want:
        raise AssertionError("the split verify batch disagrees")
    say(f"{rt.CURVE} verify batch split: host marshalling "
        f"{phases['verify_host_s']:.2f} s, device pass "
        f"{phases['verify_device_s']:.2f} s")

    t = time.perf_counter()
    for i in sample_lanes(N_VERIFY):          # two good, two bad lanes
        if rt.groth16_verify(vk, ins[i], prs[i]) is not want[i]:
            raise AssertionError(f"lane {i} disagrees with host verify")
    phases["verify_host_lanes_s"] = time.perf_counter() - t
    return by_lanes


def pairing_batch(rt, vk, pub, proof, phases):
    """The unprepared pairing on N_VERIFY lanes of e(7 G1, 9 G2) against
    e(G1, G2)^63, and against the prepared path on one proof's four
    pairs.  Returns the launches per (entry point, word count, lanes) of the
    pairing batch."""
    import torch
    from wasmsnark_tpu_torch.groth16 import verifier
    from wasmsnark_tpu_torch.ops import cuda_lib
    from wasmsnark_tpu_torch.ops.curve import map_leaf
    from wasmsnark_tpu_torch.ops.pairing import pairing_device

    pd = pairing_device(rt.CURVE)
    m = pd.m
    p1 = m.G1.affine(m.G1.times_scalar(m.g1_gen, 7))[:2]
    q1 = m.G2.affine(m.G2.times_scalar(m.g2_gen, 9))[:2]
    g1 = map_leaf(pd.pack_g1([p1] * N_VERIFY), lambda a: a[:, None])
    g2 = map_leaf(pd.pack_g2([q1] * N_VERIFY), lambda a: a[:, None])
    for name in ("first", "steady"):
        cuda_lib.reset_launches()
        t = time.perf_counter()
        e = pd.pairing_product(g1, g2, 1)
        torch.cuda.synchronize()
        phases[f"pairing_{name}_s"] = time.perf_counter() - t
    counts = dict(cuda_lib.fn_launches)
    by_lanes = dict(cuda_lib.lane_launches)
    phases["pairing_launches"] = {k: v for k, v in counts.items() if v}
    say(f"{rt.CURVE} pairing batch ({N_VERIFY} lanes): first "
        f"{phases['pairing_first_s']:.2f} s, steady "
        f"{phases['pairing_steady_s']:.2f} s; launches "
        f"{phases['pairing_launches']}")
    sched = f12_schedule(pd, 1, prepared=False)
    if tower_counts(counts) != sched:
        raise AssertionError(f"pairing launches {tower_counts(counts)} are "
                             f"not the static schedule's {sched}")
    want = m.F12.exp(m.final_exponentiation(m.miller_loop(
        m.G1.affine(m.g1_gen)[:2], m.G2.affine(m.g2_gen)[:2])), 63)
    if any(v != want for v in pd.unpack_f12(e)):
        raise AssertionError("e(7 G1, 9 G2) != e(G1, G2)^63 on some lane")

    g1p, g2_b, fixed, ok_host = verifier._batch_inputs(pd, m, vk, [pub],
                                                       [proof])
    e_prep = verifier._pairing_batch(pd, g1p, g2_b, fixed)
    pts = [verifier._g2_from_json(m, proof["pi_b"])] + [
        verifier._g2_from_json(m, vk[k])
        for k in ("vk_gamma_2", "vk_delta_2", "vk_beta_2")]
    g2_4 = map_leaf(pd.pack_g2([m.G2.affine(p)[:2] for p in pts]),
                    lambda a: a.reshape(a.shape[0], 4, 1))
    e_full = pd.pairing_product(g1p, g2_4, 4)
    torch.cuda.synchronize()
    if mismatch(e_prep, e_full)[0] or not bool(pd.is_one(e_full).all()):
        raise AssertionError("pairing_product and pairing_product_prepared "
                             "disagree on a good proof's four pairs")
    say(f"{rt.CURVE} pairing: all lanes equal e(G1, G2)^63; unprepared = "
        "prepared on a proof's four pairs, bit for bit")
    return by_lanes


def card_against_cpu(rt, vk, lanes, phases):
    """4 lanes (2 good, 2 bad) on the card and with the plain versions on
    the CPU: the same booleans and bit-equal F12 values."""
    from wasmsnark_tpu_torch.groth16 import verifier
    from wasmsnark_tpu_torch.ops.pairing import pairing_device

    t = time.perf_counter()
    m = rt.module
    ins, prs, _ = lanes
    pick = sample_lanes(N_VERIFY)
    ins, prs = [ins[i] for i in pick], [prs[i] for i in pick]
    cpu = type(rt)(device="cpu")
    got = {"card": rt.groth16_verify_batch(vk, ins, prs),
           "cpu": cpu.groth16_verify_batch(vk, ins, prs)}
    if not got["card"] == got["cpu"] == [True, True, False, False]:
        raise AssertionError(f"card and CPU verify differ: {got}")
    e = {}
    for where in ("card", "cpu"):
        pd = pairing_device(rt.CURVE, "cpu" if where == "cpu" else None)
        g1, g2_b, fixed, _ = verifier._batch_inputs(pd, m, vk, ins, prs)
        e[where] = tuple(x.cpu() for x in leaves(
            verifier._pairing_batch(pd, g1, g2_b, fixed)))
    if mismatch(e["card"], e["cpu"])[0]:
        raise AssertionError("card and CPU F12 values differ")
    phases["card_vs_cpu_s"] = time.perf_counter() - t
    say(f"{rt.CURVE} card against CPU: same booleans, bit-equal F12 values "
        f"({phases['card_vs_cpu_s']:.1f} s)")


def run_curve(curve, phases):
    """Steps 4-9 for one curve; returns the launches per (entry point,
    word count, lanes) on each of its paths: prove, steady verify batch,
    pairing batch."""
    import torch
    import wasmsnark_tpu_torch
    from wasmsnark_tpu_torch.groth16.setup import (
        setup, square_chain_circuit, square_chain_witness)
    from wasmsnark_tpu_torch.groth16.pkey import write_witness
    from wasmsnark_tpu_torch.models import curve_module
    from wasmsnark_tpu_torch.ops import cuda_lib

    m = curve_module(curve)
    R = m.Fr.q
    build = {"bn128": wasmsnark_tpu_torch.build_bn128,
             "bls12381": wasmsnark_tpu_torch.build_bls12381}[curve]
    k = (1 << LOG_2N) - 2
    say(f"{curve} setup: square_chain_circuit(2^{LOG_2N} - 2) on the card")
    timings = {}
    t = time.perf_counter()
    pkey, vk, _ = setup(square_chain_circuit(k), seed=SEED % 1000, module=m,
                        timings=timings)
    torch.cuda.synchronize()
    phases["setup_s"] = time.perf_counter() - t
    phases["setup_sections_s"] = timings
    phases["pkey_bytes"] = len(pkey)
    say(f"{curve} setup: {phases['setup_s']:.1f} s, sections "
        + ", ".join(f"{n} {v:.1f} s" for n, v in timings.items()))

    wit = square_chain_witness(k, 3, r=R)
    wbytes = write_witness(wit, m.fr_spec)
    pub = [str(wit[1])]
    rt = build()

    say(f"{curve} prove (first call; launch counters from 0)")
    cuda_lib.reset_launches()
    t = time.perf_counter()
    proof, k5_calls, k7_calls = probe_curve_kernels(
        lambda: rt.groth16_gen_proof(wbytes, pkey, rng=7))
    torch.cuda.synchronize()
    phases["prove_first_s"] = time.perf_counter() - t
    launches = dict(cuda_lib.launches)
    by_path = {"prove": dict(cuda_lib.lane_launches)}
    phases["prove_launches"] = {kid: v for kid, v in launches.items() if v}
    say(f"{curve} prove: {phases['prove_first_s']:.2f} s, launches "
        f"{launches}")
    missing = [kid for kid in PROVE_KERNELS if launches[kid] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {curve} "
                             f"prove: {missing}")
    # what K5's and K7's launches on the prove were given: K5's lanes by
    # kind (its path-lane row takes their shares), K7's doublings a launch
    phases.update(probed_shapes(m.fp_spec, k5_calls, k7_calls))
    del k5_calls
    say(f"{curve} prove: K5's lanes by kind "
        f"{json.dumps(phases['k5_lane_kinds'])}; K7's calls "
        f"{json.dumps(phases['k7_calls'])}")

    t = time.perf_counter()
    proof2 = rt.groth16_gen_proof(wbytes, pkey, rng=7)
    torch.cuda.synchronize()
    phases["prove_steady_s"] = time.perf_counter() - t
    say(f"{curve} prove (steady): {phases['prove_steady_s']:.2f} s")
    if proof2 != proof:
        raise AssertionError("two proves with the same rng differ")
    breakdown = {}
    if rt.prover.prove(wbytes, pkey, rng=7, timings=breakdown) != proof:
        raise AssertionError("the timed prove differs")
    phases["prove_breakdown_s"] = breakdown
    say(f"{curve} prove breakdown (steady, synchronized): " + ", ".join(
        f"{n} {v:.3f} s" for n, v in breakdown.items()))

    t = time.perf_counter()
    if rt.groth16_verify(vk, pub, proof) is not True:
        raise AssertionError("the proof does not verify")
    bad_proof = json.loads(json.dumps(proof))
    bad_proof["pi_a"][0] = str(int(bad_proof["pi_a"][0]) + 1)
    if rt.groth16_verify(vk, pub, bad_proof) is not False:
        raise AssertionError("a tampered proof verifies")
    phases["verify_s"] = time.perf_counter() - t
    say(f"{curve} verify: good True, tampered False "
        f"({phases['verify_s']:.1f} s)")

    say(f"{curve} small circuit: card against the plain versions on the CPU")
    t = time.perf_counter()
    small_pk, _, _ = setup(square_chain_circuit(3), seed=1, module=m)
    small_w = write_witness(square_chain_witness(3, 5, r=R), m.fr_spec)
    on_card = rt.groth16_gen_proof(small_w, small_pk, rng=7)
    on_cpu = build(device="cpu").groth16_gen_proof(small_w, small_pk, rng=7)
    if on_card != on_cpu:
        raise AssertionError("the card's proof differs from the plain one")
    phases["small_parity_s"] = time.perf_counter() - t
    say(f"{curve} small circuit: identical proofs "
        f"({phases['small_parity_s']:.1f} s)")

    t = time.perf_counter()
    lanes = verify_lanes(m, pub, proof, N_VERIFY)
    phases["verify_lanes_s"] = time.perf_counter() - t
    by_path["verify_batch"] = verify_batch(rt, vk, lanes, phases)
    by_path["pairing_batch"] = pairing_batch(rt, vk, pub, proof, phases)
    card_against_cpu(rt, vk, lanes, phases)
    return by_path


def with_path_runs(kernels, curve, phases, dev):
    """The K5 and K7 rows of a curve, after its prove: K5's path-lane
    timing on k5_path_inputs with the prove's lane kinds (its check at
    N_LANES stays on the random-Z lanes of curve_inputs, the general
    case), bounded by k5_ops; K7's on the check's points with the
    doublings a launch of the prove's K7 calls, bounded by k7_ops."""
    import functools
    import numpy as np
    from wasmsnark_tpu_torch.models import curve_module
    from wasmsnark_tpu_torch.ops import curve as cv

    m = curve_module(curve)
    Fq = m.fp_spec
    times = phases["k7_doublings"]
    rng = np.random.default_rng(SEED + 5)
    for kr in kernels:
        if kr["curve"] != curve:
            continue
        if kr["name"].startswith("K5 "):
            kr["path_run"] = (kr["run"][0], kr["run"][1], k5_path_inputs(
                m, rng, dev, kr["lanes"], phases["k5_lane_kinds"]))
            kr["path_ops_of"] = functools.partial(k5_ops, Fq)
        elif kr["name"].startswith("K7 "):
            kr["path_run"] = (
                lambda P, t=times: cv.jac_double(Fq, P, t),
                lambda P, t=times: cv.jac_double_plain(Fq, P, t),
                kr["run"][2])
            kr["path_ops_of"] = functools.partial(k7_ops, Fq, times)


# -- MNT6753 ------------------------------------------------------------------


def _mnt_json(m):
    """Encoders of G1 and G2 points in the verifier's JSON (decimal
    strings; an F3 value as {"a", "b", "c"})."""
    def f3(v):
        return {"a": str(v[0]), "b": str(v[1]), "c": str(v[2])}

    def g1(p):
        x, y = m.G1.affine(p)[:2]
        return {"x": str(x), "y": str(y)}

    def g2(p):
        x, y = m.G2.affine(p)[:2]
        return {"x": f3(x), "y": f3(y)}

    return f3, g1, g2


def mnt_synthetic_vk(m, n_inputs, rnd):
    """A Bowe-Gabizon verification key with a known trapdoor: query_i =
    q_i G1, alphaBeta = e(G1, G2)^k, delta = t G2.  Returns (vk,
    trapdoor)."""
    R = m.Fr.q
    f3, g1, g2 = _mnt_json(m)
    qs = [rnd.randrange(1, R) for _ in range(n_inputs + 1)]
    k, t = rnd.randrange(1, R), rnd.randrange(1, R)
    ab = m.F6.exp(m.pairing(m.g1_gen, m.g2_gen), k)
    vk = {"query": [g1(m.G1.times_scalar(m.g1_gen, q)) for q in qs],
          "alphaBeta": {"a": f3(ab[0]), "b": f3(ab[1])},
          "delta": g2(m.G2.times_scalar(m.g2_gen, t))}
    return vk, {"qs": qs, "k": k, "t": t}


def mnt_synthetic_proof(rt, trap, inputs, rnd):
    """A valid proof for `inputs` from the trapdoor: A = a G1, B = b G2,
    deltaPrime = d G2, C = ((a b - x - k)/d) G1 with x = q_0 + sum in_i q_i,
    Z = (d/t) Ys with Ys = calculate_ys(A, B, C, deltaPrime)."""
    m = rt.m
    R = m.Fr.q
    G1, G2 = m.G1, m.G2
    _, g1, g2 = _mnt_json(m)
    a, b, d = (rnd.randrange(1, R) for _ in range(3))
    qs = trap["qs"]
    x = (qs[0] + sum(int(v) * q for v, q in zip(inputs, qs[1:]))) % R
    A, B = G1.times_scalar(m.g1_gen, a), G2.times_scalar(m.g2_gen, b)
    C = G1.times_scalar(m.g1_gen, (a * b - x - trap["k"]) * pow(d, -1, R) % R)
    D = G2.times_scalar(m.g2_gen, d)
    ys = rt.calculate_ys(G1.affine(A), G2.affine(B), G1.affine(C),
                         G2.affine(D))
    Z = G1.times_scalar(ys, d * pow(trap["t"], -1, R) % R)
    return {"a": g1(A), "b": g2(B), "c": g1(C), "deltaPrime": g2(D),
            "z": g1(Z)}


def mnt_lanes(rt, n):
    """A synthetic vk with one public input, N_MNT_PROOFS distinct proofs
    repeated over n lanes, and bad lanes at fixed places.  Returns (vk,
    inputs, proofs, expected)."""
    import random
    m = rt.m
    rnd = random.Random(SEED)
    vk, trap = mnt_synthetic_vk(m, 1, rnd)
    pub = [str(rnd.randrange(1 << 200))]
    good = [mnt_synthetic_proof(rt, trap, pub, rnd)
            for _ in range(N_MNT_PROOFS)]
    _, g1, _ = _mnt_json(m)

    def shifted(proof, key):                  # the point plus G1
        p = dict(proof)
        p[key] = g1(m.G1.add(rt._g1_affine(proof[key]), m.g1_gen))
        return p

    bad = {5: (pub, shifted(good[5], "c")),               # tampered c
           n // 3: (pub, shifted(good[1], "z")),          # tampered z
           n // 2: ([str(int(pub[0]) + 1)], good[2]),     # flipped input
           n - 1: (pub + ["1"], good[3])}                 # wrong count
    ins, prs, want = [], [], []
    for i in range(n):
        inp, prf = bad.get(i, (pub, good[i % len(good)]))
        ins.append(inp)
        prs.append(prf)
        want.append(i not in bad)
    return vk, ins, prs, want


def mnt_schedule(pd, n_pairs, prepared, fused):
    """Launches of each MNT entry point that one pairing product over
    n_pairs pairs makes, from the static schedules: per Miller step a line
    multiply and, with fused lanes, the pairs' tree (one multiply per
    level, ceil(log2(n_pairs)) levels, per step when fused, once after the
    loop otherwise), a square per doubling step; 2 multiplies in the easy part, then the
    window ladder of w0: 14 table multiplies, 4 cyclotomic squarings per
    window after the first and a multiply per nonzero one, and the last
    multiply by frob(t)."""
    from wasmsnark_tpu_torch.ops.pairing import window_digits
    flags = pd._prep_flags
    steps, dbls = len(flags), int((flags == 0).sum())
    digits = window_digits(pd._w0, 4)
    tree = (n_pairs - 1).bit_length()
    return {
        "k12_f6_mul": steps * (1 + (tree if fused else 0))
        + (0 if fused else tree) + 2 + 14
        + sum(1 for d in digits[1:] if d) + 1,
        "k12_f6_sqr": dbls,
        "k13_f6_cyc_sqr": 4 * (len(digits) - 1),
        "k14_mnt_miller_dbl": 0 if prepared else dbls,
        "k14_mnt_miller_add": 0 if prepared else steps - dbls,
    }


MNT_FNS = ("k12_f6_mul", "k12_f6_sqr", "k13_f6_cyc_sqr",
           "k14_mnt_miller_dbl", "k14_mnt_miller_add")


def mnt_verify_batch(rt, lanes, phases):
    """N_MNT lanes through rt.bowe_gabizon_verify_batch(fused=True) with a
    seeded rng, twice; the split of the steady call; verify and
    verify_fused on one good and one bad proof.  Returns the launches per
    (entry point, word count, lanes) of the steady call."""
    import random
    import torch
    from wasmsnark_tpu_torch.ops import cuda_lib

    vk, ins, prs, want = lanes
    pd = rt._pd
    say(f"mnt6753 verify batch: {N_MNT} lanes, {want.count(False)} bad")
    pd.vk_prep_cache.clear()
    for name in ("first", "steady"):
        if name == "steady":
            cuda_lib.reset_launches()
        t = time.perf_counter()
        got = rt.bowe_gabizon_verify_batch(vk, ins, prs, fused=True,
                                           rng=random.Random(SEED))
        torch.cuda.synchronize()
        phases[f"verify_{name}_s"] = time.perf_counter() - t
        if got != want:
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"mnt6753 verify batch ({name}) wrong at "
                                 f"lanes {bad[:20]}")
    counts = dict(cuda_lib.fn_launches)
    by_lanes = dict(cuda_lib.lane_launches)
    phases["verify_proofs_per_s"] = N_MNT / phases["verify_steady_s"]
    phases["verify_launches"] = {k: v for k, v in counts.items() if v}
    say(f"mnt6753 verify batch: first {phases['verify_first_s']:.2f} s, "
        f"steady {phases['verify_steady_s']:.2f} s "
        f"({phases['verify_proofs_per_s']:.1f} proofs/s); launches "
        f"{phases['verify_launches']}")
    sched = mnt_schedule(pd, 5, prepared=True, fused=True)
    if {fn: counts[fn] for fn in MNT_FNS} != sched:
        raise AssertionError(f"mnt6753 verify batch launches "
                             f"{ {fn: counts[fn] for fn in MNT_FNS} } are "
                             f"not the static schedule's {sched}")

    # where the steady time goes: host marshalling, then the device stages
    t = time.perf_counter()
    rng = random.Random(SEED)
    ms = [rt._marshal(vk, i, p, rng) for i, p in zip(ins, prs)]
    batch = [mm for mm in ms if mm is not None]
    g1_4, g2_var, expected = rt._pairing_inputs(batch)
    torch.cuda.synchronize()
    phases["verify_host_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tt = rt._hash_to_t(batch)
    torch.cuda.synchronize()
    phases["verify_hash_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ok = rt._check(tt, g1_4, g2_var, rt._fixed_coeffs(batch[0]["delta"]),
                   expected, True).tolist()
    phases["verify_device_s"] = time.perf_counter() - t
    if ok != [w for w, mm in zip(want, ms) if mm is not None]:
        raise AssertionError("the split mnt6753 verify batch disagrees")
    say(f"mnt6753 verify batch split: host marshalling "
        f"{phases['verify_host_s']:.2f} s, Pedersen hash and blake2s "
        f"{phases['verify_hash_s']:.2f} s, group map and pairing "
        f"{phases['verify_device_s']:.2f} s")

    t = time.perf_counter()
    bad_i = want.index(False)
    for fn in (rt.verify, rt.verify_fused):
        for i in (0, bad_i):
            if fn(vk, ins[i], prs[i], rng=random.Random(i)) is not want[i]:
                raise AssertionError(f"{fn.__name__} wrong on lane {i}")
    phases["verify_single_s"] = time.perf_counter() - t
    say(f"mnt6753 verify and verify_fused: one good and one bad proof each "
        f"({phases['verify_single_s']:.1f} s)")
    return by_lanes


def mnt_pairing_batch(rt, lanes, phases):
    """The unprepared pairing products on N_MNT lanes: pairing_products of
    e(7 G1, 9 G2) against the oracle's e(G1, G2)^63, pairing_products_fused
    of e(7 G1, 9 G2) e(-63 G1, G2) = 1, each against the static schedule;
    then the unprepared against the prepared product on one proof's five
    pairs.  Returns the launches per (entry point, word count, lanes) of
    the unprepared call and of the fused one."""
    import random
    import torch
    from wasmsnark_tpu_torch.ops import cuda_lib
    from wasmsnark_tpu_torch.ops.curve import map_leaf

    pd = rt._pd
    m = pd.m
    G1, G2 = m.G1, m.G2
    p7 = G1.affine(G1.times_scalar(m.g1_gen, 7))[:2]
    pm63 = G1.affine(G1.neg(G1.times_scalar(m.g1_gen, 63)))[:2]
    q9 = G2.affine(G2.times_scalar(m.g2_gen, 9))[:2]
    q1 = G2.affine(m.g2_gen)[:2]

    def on_lanes(points, pack):      # pair j = points[j] on every lane
        return map_leaf(pack([p for p in points for _ in range(N_MNT)]),
                        lambda a: a.reshape(a.shape[0], len(points), N_MNT))

    cuda_lib.reset_launches()
    t = time.perf_counter()
    e = pd.pairing_products(on_lanes([p7], pd.pack_g1),
                            on_lanes([q9], pd.pack_g2))
    torch.cuda.synchronize()
    phases["pairing_s"] = time.perf_counter() - t
    counts = dict(cuda_lib.fn_launches)
    sched = mnt_schedule(pd, 1, prepared=False, fused=False)
    if {fn: counts[fn] for fn in MNT_FNS} != sched:
        raise AssertionError(f"pairing_products launches "
                             f"{ {fn: counts[fn] for fn in MNT_FNS} } are "
                             f"not the static schedule's {sched}")
    want = m.F6.exp(m.pairing(m.g1_gen, m.g2_gen), 63)
    if any(v != want for v in pd.unpack_f6(e)):
        raise AssertionError("e(7 G1, 9 G2) != e(G1, G2)^63 on some lane")
    by_lanes = dict(cuda_lib.lane_launches)
    phases["pairing_launches"] = {k: v for k, v in counts.items() if v}

    cuda_lib.reset_launches()
    t = time.perf_counter()
    e2 = pd.pairing_products_fused(on_lanes([p7, pm63], pd.pack_g1),
                                   on_lanes([q9, q1], pd.pack_g2))
    torch.cuda.synchronize()
    phases["pairing_fused_s"] = time.perf_counter() - t
    counts = dict(cuda_lib.fn_launches)
    sched = mnt_schedule(pd, 2, prepared=False, fused=True)
    if {fn: counts[fn] for fn in MNT_FNS} != sched:
        raise AssertionError(f"pairing_products_fused launches "
                             f"{ {fn: counts[fn] for fn in MNT_FNS} } are "
                             f"not the static schedule's {sched}")
    one = m.F6.one()
    if any(v != one for v in pd.unpack_f6(e2)):
        raise AssertionError("e(7 G1, 9 G2) e(-63 G1, G2) != 1 on some lane")
    phases["pairing_fused_launches"] = {k: v for k, v in counts.items() if v}
    fused_lanes = dict(cuda_lib.lane_launches)
    say(f"mnt6753 pairing ({N_MNT} lanes): unprepared "
        f"{phases['pairing_s']:.2f} s, launches {phases['pairing_launches']};"
        f" fused 2 pairs {phases['pairing_fused_s']:.2f} s, launches "
        f"{phases['pairing_fused_launches']}")

    # one proof's five pairs: unprepared against prepared, bit for bit
    vk, ins, prs, _ = lanes
    mm = rt._marshal(vk, ins[0], prs[0], random.Random(SEED))
    g1, g2, _ = mnt_five_pairs(rt, [mm])
    e_full = pd.pairing_products(g1, g2)
    e_prep = pd.pairing_products_prepared(g1, pd.prepare_g2(g2))
    torch.cuda.synchronize()
    if mismatch(e_full, e_prep)[0] or not bool(pd.is_eq_planes(
            e_full, pd.pack_f6([mm["expected"]])).all()):
        raise AssertionError("pairing_products and pairing_products_prepared "
                             "disagree on a good proof's five pairs")
    say("mnt6753 pairing: all lanes equal e(G1, G2)^63 and 1; unprepared = "
        "prepared on a proof's five pairs, bit for bit")
    return by_lanes, fused_lanes


def mnt_five_pairs(rt, batch):
    """The five pairs of marshalled lanes, (rho A, B), (-rho vk_x, G2gen),
    (-rho C, dp), (-Z, delta), (Ys, dp), with Ys from the card's hash and
    group map: (g1, g2) planes [L, 5, N] and the host points per lane."""
    import torch
    pd, m = rt._pd, rt.m
    g1_4, _, _ = rt._pairing_inputs(batch)
    ys_x, ys_y, _ = rt._dev.group_map(rt._hash_to_t(batch))
    g1 = (torch.cat([g1_4[0], ys_x[:, None]], dim=1),
          torch.cat([g1_4[1], ys_y[:, None]], dim=1))
    ys = list(zip(pd.fp.unpack_mont(ys_x), pd.fp.unpack_mont(ys_y)))
    g2gen = m.G2.affine(m.g2_gen)[:2]
    host = [(mm["g1_4"] + [y], [mm["g2_var"][0], g2gen, mm["g2_var"][1],
                                mm["delta"], mm["g2_var"][1]])
            for mm, y in zip(batch, ys)]
    g2 = pd.pack_g2([h[1][k] for k in range(5) for h in host])
    g2 = tuple(tuple(c.reshape(c.shape[0], 5, len(batch)) for c in xy)
               for xy in g2)
    return g1, g2, host


def mnt_against_oracle(rt, lanes, phases):
    """4 sampled lanes (2 good, 2 bad): the card's booleans against the
    port's host verify_sync, and the card's five-pair F6 values against
    the host oracle's pairing product of the same pairs."""
    import random

    t = time.perf_counter()
    m, pd = rt.m, rt._pd
    vk, ins, prs, want = lanes
    pick = [0, 1] + [i for i, w in enumerate(want) if not w][:2]
    ins, prs = [ins[i] for i in pick], [prs[i] for i in pick]
    want = [want[i] for i in pick]
    card = rt.bowe_gabizon_verify_batch(vk, ins, prs, rng=random.Random(1))
    host = [rt.verify_sync(vk, i, p) for i, p in zip(ins, prs)]
    if not card == host == want:
        raise AssertionError(f"card and host verify differ: {card} {host}")
    ms = [rt._marshal(vk, i, p, random.Random(SEED))
          for i, p in zip(ins, prs)]
    g1, g2, pairs = mnt_five_pairs(rt, [mm for mm in ms if mm is not None])
    got = pd.unpack_f6(pd.pairing_products_prepared(g1, pd.prepare_g2(g2)))
    for lane, (p1s, q2s) in enumerate(pairs):
        f = m.F6.one()
        for p, q in zip(p1s, q2s):
            f = m.F6.mul(f, m.miller_loop(p, q))
        if m.final_exponentiation(f) != got[lane]:
            raise AssertionError(f"sampled lane {lane}: the card's F6 value "
                                 "is not the oracle's")
    phases["card_vs_oracle_s"] = time.perf_counter() - t
    say(f"mnt6753 card against the host oracle: same booleans, bit-equal "
        f"F6 values ({phases['card_vs_oracle_s']:.1f} s)")


def run_mnt(phases):
    """Steps 10-12; returns the launches per (entry point, word count,
    lanes) of the steady verify batch, the unprepared pairing and the
    fused one."""
    import wasmsnark_tpu_torch

    rt = wasmsnark_tpu_torch.build_mnt6753()
    t = time.perf_counter()
    lanes = mnt_lanes(rt, N_MNT)
    phases["lanes_s"] = time.perf_counter() - t
    say(f"mnt6753: {N_MNT_PROOFS} synthetic proofs in "
        f"{phases['lanes_s']:.1f} s")
    by_path = {"verify_batch": mnt_verify_batch(rt, lanes, phases)}
    by_path["pairing_batch"], by_path["pairing_fused"] = mnt_pairing_batch(
        rt, lanes, phases)
    mnt_against_oracle(rt, lanes, phases)
    return by_path


def main() -> int:
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from wasmsnark_tpu_torch.ops import cuda_lib

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    say(f"device {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    phases = {"device": kind, "nvidia_smi": smi}

    say("building the CUDA kernels")
    t = time.perf_counter()
    cuda_lib.build()
    phases["build_s"] = time.perf_counter() - t
    phases["build_library_s"] = dict(cuda_lib.build_seconds)
    say(f"build: {phases['build_s']:.1f} s ({cuda_lib.build_dir()}), per "
        f"library {json.dumps(phases['build_library_s'])}")
    ptxas = phases["ptxas"] = ptxas_summary(cuda_lib.build_dir())
    say(f"ptxas: {json.dumps(ptxas)}")

    say("kernels against their plain versions")
    t = time.perf_counter()
    kernels = check_kernels(dev)
    phases["kernel_check_s"] = time.perf_counter() - t
    bad = [k["name"] for k in kernels if k["mismatched_lanes"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")

    by_path = {}
    for curve in CURVES:
        phases[curve] = {}
        by_path[curve] = run_curve(curve, phases[curve])
        with_path_runs(kernels, curve, phases[curve], dev)
    phases["mnt6753"] = {}
    by_path["mnt6753"] = run_mnt(phases["mnt6753"])

    # each kernel's launches on the path that serves it, at its word count:
    # the prove for K1-K7, the steady verify batch for K8, K9, K12, K13 and
    # the 24-word K1/K2, the pairing batch for K10, K11 and K14; per path
    # also by lane count
    for kr in kernels:
        kr["lanes_by_path"] = {
            path: lane_counts(c, kr["fns"], kr["n_words"])
            for path, c in by_path[kr["curve"]].items()}
        counts = {path: sum(c.values())
                  for path, c in kr["lanes_by_path"].items()}
        kr["launches_by_path"] = counts
        kr["launches"] = next((v for v in counts.values() if v), 0)
        if not kr["launches"]:
            raise AssertionError(f"{kr['name']} never launched")
        kr["ptxas"] = {fn: ptxas.get(f"{ENTRY_KERNEL[fn]}@N{kr['n_words']}")
                       for fn in kr["fns"]}
        for fn, kernel in OTHER_DESIGN.items():
            other = ptxas.get(f"{kernel}@N{kr['n_words']}")
            if fn in kr["fns"] and other:
                kr["ptxas"][f"{fn} {kernel}"] = other

    say("kernels at the lane counts their paths launch them with")
    t = time.perf_counter()
    floor = phases["call_floor_ms"] = call_floors(dev)
    for kr in kernels:
        at_path_lanes(kr)
        f = floor[kr["n_words"]][len(kr["fns"])]
        kr["ms_above_floor_at_path"] = {
            k: ms - f for k, ms in kr["ms_at_path"].items()}
    phases["path_lanes_s"] = time.perf_counter() - t
    # the loss estimated over all launches is a model, not a measurement:
    # it stays out of the kernels' record, with its check beside it
    phases["path_loss_model"] = {
        kr["name"]: {k_: kr[k_] for k_ in ("path_loss_ms", "path_loss_est_ms",
                                           "est_check")} for kr in kernels}

    phases["wall_s"] = time.perf_counter() - _T0
    say("phases " + json.dumps(phases))
    say(f"done in {phases['wall_s']:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "ms_at_path", "lanes_at_path", "bound_ms_at_path",
            "path_loss_ms", "path_loss_share", "ms_above_floor_at_path",
            "n_words",
            "mismatched_lanes", "bytes", "launches_by_path",
            "lanes_by_path", "ptxas")
    print(json.dumps({"kernels": [{k_: kr[k_] for k_ in keys}
                                  for kr in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
