"""The port's CUDA sources, compiled for the host, against their plain
versions: every kernel at every word count it is built for, bit for bit.

There is no card and no nvcc here, so g++ compiles wasmsnark_tpu_torch/
csrc/*.cu against tests/cuda_host_shim/cuda_runtime.h, with the launch
configurations removed: each kernel then runs its grid-stride loop on one
host thread.  The kernels use one thread per lane and nothing of the
card's but its arithmetic, so this holds the same C++ that nvcc builds
(the per-word-count `#if` builds included) against the plain PyTorch
versions that chip_smoke.py holds the card's kernels against.  It cannot
show that nvcc accepts the code or how it runs on the card.

Inputs: canonical planes from a seeded numpy generator with the edge
values 0, 1, q-1, q-2; equal, opposite and zero points for K5-K7; Z = 0
and x2 = X/Z lanes for the Miller steps.  Tolerance: bit-identical.
"""

import ctypes
import os
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from wasmsnark_tpu_torch.models.bls12381 import bls12381
from wasmsnark_tpu_torch.models.bn128 import bn128
from wasmsnark_tpu_torch.ops import cuda_lib, curve, fp, ntt, towers
from wasmsnark_tpu_torch.ops import tower_kernels as tk
from wasmsnark_tpu_torch.utils.serialize import (ints_to_limbs_fast,
                                                 limbs_to_ints)

SHIM = pathlib.Path(__file__).resolve().parent / "cuda_host_shim"
N = 96                                    # lanes


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every library of cuda_lib.libraries(), built by g++ for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("csrc_host")
    for name in cuda_lib.HEADERS:
        shutil.copy(os.path.join(cuda_lib.CSRC, name), out / name)
    procs = {}
    for lib, (src, w) in cuda_lib.libraries().items():
        text = (pathlib.Path(cuda_lib.CSRC) / src).read_text()
        cpp = out / f"{lib}.cpp"
        cpp.write_text(re.sub(r"<<<.*?>>>", "", text, flags=re.S))
        procs[lib] = subprocess.Popen(
            [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", f"-DWORDS={w}",
             f"-I{SHIM}", f"-I{out}", "-o", str(out / f"lib{lib}.so"),
             str(cpp)], stderr=subprocess.PIPE)
    for lib, p in procs.items():
        _, err = p.communicate()
        assert p.returncode == 0, (lib, err.decode()[-3000:])
    return {lib: cuda_lib._bind(ctypes.CDLL(str(out / f"lib{lib}.so")))
            for lib in procs}


def call(libs, fn, spec, tensors, ints=()):
    """Run C entry point fn of the field's word-count build; returns its
    CUDA error code."""
    source = cuda_lib._ENTRY[fn][0]
    words = cuda_lib.field_words(spec)
    for t in tensors:
        assert t.is_contiguous()
    return getattr(libs[f"{source}_w{spec.n_limbs // 2}"], fn)(
        *[t.data_ptr() for t in tensors], N, *ints, spec.n_limbs,
        words.ctypes.data, None)


def rand(spec, seed, n=N):
    rng = np.random.default_rng(seed)
    L = spec.n_limbs
    a = rng.integers(0, 1 << 16, size=(L, n), dtype=np.uint32)
    a[L - 1] = rng.integers(0, spec.q_limbs[-1], size=n, dtype=np.uint32)
    for j, v in enumerate((0, 1, spec.q - 1, spec.q - 2)[:n]):
        a[:, j] = spec.limbs(v)
    return fp.planes(a, "cpu")


def leaves(t):
    return [x for c in t for x in leaves(c)] if isinstance(t, tuple) else [t]


def assert_equal(a, b):
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert torch.equal(x, y)


CURVES = {"bn128": bn128, "bls12381": bls12381}


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
@pytest.mark.parametrize("field", ["fq", "fr"])
def test_field_kernels(libs, curve_name, field):
    """K1, K2 and K4 at the field's word count (8 or 12)."""
    m = CURVES[curve_name]()
    spec = m.fp_spec if field == "fq" else m.fr_spec
    x, y = rand(spec, 1), rand(spec, 2).flip(1).contiguous()
    for fn, plain in (("k1_mont_mul", fp.mont_mul_plain),
                      ("k2_mod_add", fp.mod_add_plain),
                      ("k2_mod_sub", fp.mod_sub_plain)):
        out = torch.empty_like(x)
        assert call(libs, fn, spec, (x, y, out)) == 0
        assert torch.equal(out, plain(spec, x, y)), fn
    flag = torch.arange(N) % 3 == 0
    out = torch.empty_like(x)
    assert call(libs, "k4_cneg", spec, (flag, y, out)) == 0
    assert torch.equal(out, towers.mod_cneg_plain(spec, flag, y))


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
def test_butterfly_over_fr_and_no_12_word_build(libs, curve_name):
    m = CURVES[curve_name]()
    fr = m.fr_spec
    x = rand(fr, 3)
    for h in (1, 4, N // 2):
        tw = rand(fr, 4, h)
        out = torch.empty_like(x)
        assert call(libs, "k3_butterfly", fr, (x, tw, out), (h,)) == 0
        assert torch.equal(out, ntt.butterfly_plain(fr, x, tw)), h
    fq = bls12381().fp_spec                   # 12 words: no K3 build
    xq = rand(fq, 5)
    assert call(libs, "k3_butterfly", fq,
                (xq, rand(fq, 6, 4), torch.empty_like(xq)), (4,)) == 1


def _points(m, seed):
    """Jacobian P, Q and affine Qa lanes: random multiples of G1 with
    random Z, lanes 0-7 P = Q, 8-15 P = -Q, 16-23 P = 0, 24-31 Q = 0."""
    rng = np.random.default_rng(seed)
    spec, G = m.fp_spec, m.G1
    aff = [G.affine(G.times_scalar(m.g1_gen, int(k)))
           for k in rng.integers(1, 2 ** 62, size=8)]

    def mont(vals):
        return fp.planes(ints_to_limbs_fast(
            [spec.to_mont(v) for v in vals], spec.n_limbs), "cpu")

    X, Y = mont([a[0] for a in aff]), mont([a[1] for a in aff])
    ip = torch.from_numpy(rng.integers(0, 8, size=N))
    iq = torch.from_numpy(rng.integers(0, 8, size=N))
    iq[:16] = ip[:16]
    px, py = X[:, ip], Y[:, ip]
    qx, qy = X[:, iq], Y[:, iq].clone()
    qy[:, 8:16] = fp.mod_sub_plain(spec, torch.zeros_like(qy[:, 8:16]),
                                   qy[:, 8:16])

    def jac(x, y, z):
        zz = fp.mont_mul_plain(spec, z, z)
        return (fp.mont_mul_plain(spec, x, zz),
                fp.mont_mul_plain(spec, y, fp.mont_mul_plain(spec, zz, z)),
                z)

    zs = [int(v) for v in rng.integers(1, 2 ** 62, size=2 * N)]
    P, Q = jac(px, py, mont(zs[:N])), jac(qx, qy, mont(zs[N:]))
    Qa = (qx.clone(), qy.clone())
    P[2][:, 16:24] = 0
    Q[2][:, 24:32] = 0
    Qa[0][:, 24:32] = 0
    Qa[1][:, 24:32] = 0
    return P, Q, Qa


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
def test_curve_kernels(libs, curve_name):
    """K5-K7 at 8 (BN128) and 12 (BLS12-381) words."""
    m = CURVES[curve_name]()
    spec = m.fp_spec
    P, Q, Qa = _points(m, 7)
    for fn, ins, plain in (
            ("k5_jac_madd", (*P, *Qa), curve.jac_madd_plain(spec, P, Qa)),
            ("k6_jac_add", (*P, *Q), curve.jac_add_plain(spec, P, Q)),
            ("k7_jac_dbl", P, curve.jac_double_plain(spec, P))):
        outs = tuple(torch.empty_like(P[0]) for _ in range(3))
        assert call(libs, fn, spec,
                    (*[t.contiguous() for t in ins], *outs)) == 0
        assert_equal(outs, plain)


def _tower(libs, fn, spec, groups, ints):
    ops = [torch.stack(g).contiguous() for g in groups]
    out = torch.empty((tk.N12, spec.n_limbs, N), dtype=torch.int32)
    rc = call(libs, fn, spec, (*ops, out), ints)
    return rc, list(out.unbind(0))


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
def test_tower_and_miller_kernels(libs, curve_name):
    """K8 and K9 at the curve's xi; the curve's Miller steps (K10 at 8
    words, K11 at 12), and the other twist's entry point refused."""
    m = CURVES[curve_name]()
    spec = m.fp_spec
    xi = tk.XI if curve_name == "bn128" else tk.XI_BLS
    a = tk.unflatten12([rand(spec, 10 + k) for k in range(12)])
    b = tk.unflatten12([rand(spec, 30 + k) for k in range(12)])
    for fn, groups, plain in (
            ("k8_f12_mul", [tk.flatten12(a), tk.flatten12(b)],
             tk.f12_mul_plain(spec, a, b, xi)),
            ("k8_f12_sqr", [tk.flatten12(a)], tk.f12_sqr_plain(spec, a, xi)),
            ("k9_f12_cyc_sqr", [tk.flatten12(a)],
             tk.f12_cyc_sqr_plain(spec, a, xi))):
        rc, out = _tower(libs, fn, spec, groups, xi)
        assert rc == 0
        assert_equal(tk.unflatten12(out), plain)

    X, Y, Z, x2, y2 = [(rand(spec, 50 + 2 * k), rand(spec, 51 + 2 * k))
                       for k in range(5)]
    xP, yP = rand(spec, 60), rand(spec, 61)
    for c in Z:                               # lanes 4..7: Z = 0
        c[:, 4:8] = 0
    sl = slice(8, 12)                         # lanes 8..11: x2 = X/Z

    def vals(p):
        return [spec.from_mont(v) for v in limbs_to_ints(fp.to_numpy(p[:, sl]))]

    xz = [m.F2.mul((u0, u1), m.F2.inv((z0, z1)))
          for u0, u1, z0, z1 in zip(*(vals(p) for p in (*X, *Z)))]
    for k in range(2):
        x2[k][:, sl] = fp.planes(ints_to_limbs_fast(
            [spec.to_mont(v[k]) for v in xz], spec.n_limbs), "cpu")
    if curve_name == "bn128":
        fns, extra, other = cuda_lib.KERNELS["K10"][1], (), "K11"
        plains = (tk.miller_dbl_plain(spec, X, Y, Z, xP, yP),
                  tk.miller_add_plain(spec, X, Y, Z, x2, y2, xP, yP))
    else:
        fns, extra, other = cuda_lib.KERNELS["K11"][1], xi, "K10"
        plains = (tk.miller_dbl_mtwist_plain(spec, X, Y, Z, xP, yP, xi),
                  tk.miller_add_mtwist_plain(spec, X, Y, Z, x2, y2, xP, yP,
                                             xi))
    groups = ([[*X, *Y, *Z], [xP, yP]], [[*X, *Y, *Z], [*x2, *y2], [xP, yP]])
    for fn, g, plain in zip(fns, groups, plains):
        rc, out = _tower(libs, fn, spec, g, extra)
        assert rc == 0
        assert_equal(tk._step_out(out, spec.n_limbs, (N,)), plain)
    assert all(int(p[:, sl].abs().sum()) == 0 for p in plains[1][0][0])
    ofns = cuda_lib.KERNELS[other][1]
    oextra = xi if other == "K11" else ()
    for fn, g in zip(ofns, groups):
        assert _tower(libs, fn, spec, g, oextra)[0] == 1
