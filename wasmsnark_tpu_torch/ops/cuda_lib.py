"""Build, load and launch the port's hand-written CUDA kernels.

The sources live in `wasmsnark_tpu_torch/csrc/`.  Each `.cu` file is
compiled once per word count N that its kernels serve (`SOURCES`: 8 for
BN128 Fp/Fr and BLS12-381 Fr, 12 for BLS12-381 Fq, 24 for MNT6753 Fq), by
one `nvcc -DWORDS=N` call into a shared library `lib<name>_w<N>.so` with a
plain C interface (no PyTorch headers, no ninja), into
`wasmsnark_tpu_torch/_build/<hash>/`, where <hash> covers every source,
the word counts and the flags.  The libraries are built at first use, all in
parallel, and loaded with ctypes.  Nothing here runs at import time: the
CPU tests import every module on a machine with no `nvcc` and no card.

Every launch goes through `launch()`, which picks the library of the
field's word count, passes the tensors' device pointers and PyTorch's
current stream, raises when the C entry point returns a CUDA error, and
adds one to the kernel's launch counters (per kernel id, entry point,
word count, and lane count).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")

# library name -> (source file, 32-bit words per field element it is built
# for); fp.cuh is shared by all.  Only the field kernels serve MNT6753's
# 24-word Fq besides its own tower and Miller-step kernels, so nothing else
# is compiled at 24 words.
SOURCES = {"fp_kernels": ("fp_kernels.cu", (8, 12, 24)),
           "curve_kernels": ("curve_kernels.cu", (8, 12)),
           "tower_kernels": ("tower_kernels.cu", (8, 12)),
           "mnt_kernels": ("mnt_kernels.cu", (24,))}
HEADERS = ("fp.cuh", "team.cuh")
# every word count some library is built for
WORDS = tuple(sorted({w for _, ws in SOURCES.values() for w in ws}))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel id -> (library, C entry points)
KERNELS = {
    "K1": ("fp_kernels", ("k1_mont_mul",)),
    "K2": ("fp_kernels", ("k2_mod_add", "k2_mod_sub")),
    "K3": ("fp_kernels", ("k3_butterfly",)),
    "K4": ("fp_kernels", ("k4_cneg",)),
    "K5": ("curve_kernels", ("k5_jac_madd",)),
    "K6": ("curve_kernels", ("k6_jac_add",)),
    "K7": ("curve_kernels", ("k7_jac_dbl",)),
    "K8": ("tower_kernels", ("k8_f12_mul", "k8_f12_sqr")),
    "K9": ("tower_kernels", ("k9_f12_cyc_sqr",)),
    "K10": ("tower_kernels", ("k10_miller_dbl", "k10_miller_add")),
    "K11": ("tower_kernels", ("k11_miller_dbl_mtwist",
                              "k11_miller_add_mtwist")),
    "K12": ("mnt_kernels", ("k12_f6_mul", "k12_f6_sqr")),
    "K13": ("mnt_kernels", ("k13_f6_cyc_sqr",)),
    "K14": ("mnt_kernels", ("k14_mnt_miller_dbl", "k14_mnt_miller_add")),
}
_ENTRY = {fn: (lib, kid) for kid, (lib, fns) in KERNELS.items() for fn in fns}

# number of tensor arguments and integer arguments of each C entry point,
# in order (tensors first, then the ints, then the constants and stream);
# the first int is the lanes, k7_jac_dbl's second the doublings a launch
# (the window fold's fori_loop over window_bits, wasmsnark_tpu/ops/msm.py
# fold_windows_device)
_SIGNATURES = {
    "k1_mont_mul": (3, 1), "k2_mod_add": (3, 1), "k2_mod_sub": (3, 1),
    "k3_butterfly": (3, 2), "k4_cneg": (3, 1),
    "k5_jac_madd": (8, 1), "k6_jac_add": (9, 1), "k7_jac_dbl": (6, 2),
    "k8_f12_mul": (3, 3), "k8_f12_sqr": (2, 3), "k9_f12_cyc_sqr": (2, 3),
    "k10_miller_dbl": (3, 1), "k10_miller_add": (4, 1),
    "k11_miller_dbl_mtwist": (3, 3), "k11_miller_add_mtwist": (4, 3),
    "k12_f6_mul": (3, 1), "k12_f6_sqr": (2, 1), "k13_f6_cyc_sqr": (2, 1),
    "k14_mnt_miller_dbl": (3, 1), "k14_mnt_miller_add": (4, 1),
}

# launches per kernel id, per C entry point and per (entry point, word
# count, lanes) since the last reset_launches(); lanes is the launch's n,
# its first integer argument
launches = dict.fromkeys(KERNELS, 0)
fn_launches = dict.fromkeys(_ENTRY, 0)
lane_launches: dict = {}
# seconds each library took to build in this process (library -> s)
build_seconds: dict = {}

_libs: dict = {}
_lock = threading.Lock()


def reset_launches():
    for counts in (launches, fn_launches):
        for k in counts:
            counts[k] = 0
    lane_launches.clear()


def libraries() -> dict:
    """Library name (`<source>_w<N>`) -> (source file, N)."""
    return {f"{name}_w{w}": (src, w) for name, (src, ws) in SOURCES.items()
            for w in ws}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + repr(SOURCES).encode())
    for name in sorted(HEADERS + tuple(src for src, _ in SOURCES.values())):
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    return os.path.join(BUILD_ROOT, source_hash())


def build():
    """Compile every library that is not built yet (one nvcc per source and
    word count, all started together, each logging to <build
    dir>/<library>.log) and load them."""
    with _lock:
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        todo = {lib: sw for lib, sw in libraries().items()
                if lib not in _libs
                and not os.path.exists(os.path.join(out_dir, f"lib{lib}.so"))}
        procs = {}
        t0 = time.perf_counter()
        for lib, (src, w) in todo.items():
            tmp = os.path.join(out_dir, f"lib{lib}.so.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, f"-DWORDS={w}", "-o", tmp,
                   os.path.join(CSRC, src)]
            with open(os.path.join(out_dir, f"{lib}.log"), "wb") as log:
                procs[lib] = (subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT), tmp)
        failed = []
        while procs:                    # in the order the builds finish
            for lib, (proc, tmp) in list(procs.items()):
                if proc.poll() is None:
                    continue
                del procs[lib]
                build_seconds[lib] = time.perf_counter() - t0
                if proc.returncode != 0:
                    with open(os.path.join(out_dir, f"{lib}.log")) as log:
                        failed.append((lib, log.read()))
                    continue
                os.replace(tmp, os.path.join(out_dir, f"lib{lib}.so"))
            time.sleep(0.05)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {lib}\n{log}" for lib, log in failed))
        if todo:
            print(f"wasmsnark_tpu_torch: built {sorted(todo)} in "
                  f"{time.perf_counter() - t0:.1f} s into {out_dir}",
                  file=sys.stderr, flush=True)
        for lib in libraries():
            if lib not in _libs:
                _libs[lib] = _bind(ctypes.CDLL(
                    os.path.join(out_dir, f"lib{lib}.so")))


def _bind(lib):
    for fn, (n_ptr, n_int) in _SIGNATURES.items():
        if not hasattr(lib, fn):
            continue
        f = getattr(lib, fn)
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * n_int
                      + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        f.restype = ctypes.c_int
    return lib


def field_words(spec) -> np.ndarray:
    """A FieldSpec's constants as the kernels take them: q and R mod q as
    32-bit words, then -q^{-1} mod 2^32, then -q^{-1} mod R as 32-bit
    words (R = 2^(32 n), read by K1's team product only; every other entry
    point reads the first 2n + 1 words)."""
    n = spec.n_limbs // 2
    q, one = spec.q, spec.one_mont
    inv = -pow(q, -1, 1 << (32 * n)) % (1 << (32 * n))
    words = [(q >> (32 * k)) & 0xFFFFFFFF for k in range(n)]
    words += [(one >> (32 * k)) & 0xFFFFFFFF for k in range(n)]
    words.append(inv & 0xFFFFFFFF)
    words += [(inv >> (32 * k)) & 0xFFFFFFFF for k in range(n)]
    return np.array(words, dtype=np.uint32)


_words_cache: dict = {}


def launch(fn: str, spec, tensors, ints):
    """Call C entry point `fn` on CUDA tensors (already checked by the
    wrapper) and count the launch."""
    import torch

    source, kid = _ENTRY[fn]
    w = spec.n_limbs // 2
    built = SOURCES[source][1]
    if spec.n_limbs % 2 or w not in built:
        raise RuntimeError(f"{fn}: no kernel build for {spec.n_limbs} limbs "
                           f"({source} is built for {built} 32-bit words)")
    lib = f"{source}_w{w}"
    if lib not in _libs:
        build()
    words = _words_cache.get(spec)
    if words is None:
        words = _words_cache[spec] = field_words(spec)
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = getattr(_libs[lib], fn)(
        *[t.data_ptr() for t in tensors], *ints, spec.n_limbs,
        words.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")
    launches[kid] += 1
    fn_launches[fn] += 1
    key = (fn, w, int(ints[0]))
    lane_launches[key] = lane_launches.get(key, 0) + 1
