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
and x2 = X/Z lanes for the Miller steps; cyclotomic elements for K13.
Tolerance: bit-identical.

The same libraries rehearse chip_smoke.py without a card (`rehearse`):
tensors claim to lie on the card, every launch goes to the host library,
and the default device is the CPU.  The tier-1 test runs its MNT6753
kernel phase on 128 lanes; the whole script runs at small sizes with

    PYTHONPATH=. python tests/test_torch_csrc_host.py

(a few minutes; N_LANES 256, LOG_2N 5, N_VERIFY 16, N_MNT 4).
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
from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
from wasmsnark_tpu_torch.ops import cuda_lib, curve, fp, ntt, towers
from wasmsnark_tpu_torch.ops import tower_kernels as tk
from wasmsnark_tpu_torch.utils.serialize import (ints_to_limbs_fast,
                                                 limbs_to_ints)

SHIM = pathlib.Path(__file__).resolve().parent / "cuda_host_shim"
N = 96                                    # lanes


def build_host_libs(out):
    """Every library of cuda_lib.libraries(), compiled by g++ for the host
    into the directory `out` and bound with the loader's argtypes."""
    out = pathlib.Path(out)
    for name in cuda_lib.HEADERS:
        shutil.copy(os.path.join(cuda_lib.CSRC, name), out / name)
    procs = {}
    for lib, (src, w) in cuda_lib.libraries().items():
        text = (pathlib.Path(cuda_lib.CSRC) / src).read_text()
        cpp = out / f"{lib}.cpp"
        cpp.write_text(re.sub(r"<<<.*?>>>", "", text, flags=re.S))
        procs[lib] = subprocess.Popen(
            ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", f"-DWORDS={w}",
             f"-I{SHIM}", f"-I{out}", "-o", str(out / f"lib{lib}.so"),
             str(cpp)], stderr=subprocess.PIPE)
    for lib, p in procs.items():
        _, err = p.communicate()
        assert p.returncode == 0, (lib, err.decode()[-3000:])
    return {lib: cuda_lib._bind(ctypes.CDLL(str(out / f"lib{lib}.so")))
            for lib in procs}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every library of cuda_lib.libraries(), built by g++ for the host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return build_host_libs(tmp_path_factory.mktemp("csrc_host"))


def call(libs, fn, spec, tensors, ints=(), n=N):
    """Run C entry point fn of the field's word-count build on n lanes;
    returns its CUDA error code."""
    source = cuda_lib._ENTRY[fn][0]
    words = cuda_lib.field_words(spec)
    for t in tensors:
        assert t.is_contiguous()
    return getattr(libs[f"{source}_w{spec.n_limbs // 2}"], fn)(
        *[t.data_ptr() for t in tensors], n, *ints, spec.n_limbs,
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


CURVES = {"bn128": bn128, "bls12381": bls12381, "mnt6753": mnt6753}


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381", "mnt6753"])
@pytest.mark.parametrize("field", ["fq", "fr"])
def test_field_kernels(libs, curve_name, field):
    """K1, K2 and K4 at the field's word count (8, 12 or 24)."""
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


def _mnt(libs, fn, spec, groups, n_out, n=N):
    ops = [torch.stack(g)[..., :n].contiguous() for g in groups]
    out = torch.empty((n_out, spec.n_limbs, n), dtype=torch.int32)
    rc = call(libs, fn, spec, (*ops, out), n=n)
    return rc, list(out.unbind(0))


def _mnt_points(m):
    """Miller-step inputs over N lanes: X, Y, Z, x2, y2 (F3 triples of
    planes) and xP, yP, with Z = 0 on lanes 4..7 and x2 = X/Z on lanes
    8..11."""
    spec = m.fp_spec
    X, Y, Z, x2, y2 = [tuple(rand(spec, 90 + 3 * k + j) for j in range(3))
                       for k in range(5)]
    xP, yP = rand(spec, 120), rand(spec, 121)
    for comp in Z:                            # lanes 4..7: Z = 0
        comp[:, 4:8] = 0
    sl = slice(8, 12)                         # lanes 8..11: x2 = X/Z

    def vals(p):
        return [spec.from_mont(v) for v in limbs_to_ints(fp.to_numpy(p[:, sl]))]

    xz = [m.F3.mul(u, m.F3.inv(z)) for u, z in zip(
        zip(*(vals(p) for p in X)), zip(*(vals(p) for p in Z)))]
    for k in range(3):
        x2[k][:, sl] = fp.planes(ints_to_limbs_fast(
            [spec.to_mont(v[k]) for v in xz], spec.n_limbs), "cpu")
    return X, Y, Z, x2, y2, xP, yP


def _cut(t, n):
    """n lanes of a tree of [L, N] planes: the first n, which hold the edge
    values and the special lanes, once n >= 12, else the last n (random
    values)."""
    if isinstance(t, tuple):
        return tuple(_cut(c, n) for c in t)
    lo = 0 if n >= 12 else N - n
    return t[:, lo:lo + n].contiguous()


@pytest.mark.parametrize("n", [1, 13, 30, 96])
def test_mnt_team_kernels(libs, n):
    """The team kernels, K12's F6 product and K14's doubling (and K14's
    add beside them), on n lanes: one lane, ragged lane groups (13 and 30
    are multiples of neither K12's 8 nor K14's 4 lanes a block) and full
    ones, with the edge values, the Z = 0 lanes 4..7 and the x2 = X/Z
    lanes 8..11 from 13 lanes on."""
    m = mnt6753()
    spec = m.fp_spec
    a = _cut(tk.unflatten6([rand(spec, 70 + k) for k in range(6)]), n)
    b = _cut(tk.unflatten6([rand(spec, 80 + k) for k in range(6)]), n)
    rc, out = _mnt(libs, "k12_f6_mul", spec, [tk.flatten6(a), tk.flatten6(b)],
                   tk.N6, n)
    assert rc == 0
    assert_equal(tk.unflatten6(out), tk.mnt_f6_mul_plain(spec, a, b))
    X, Y, Z, x2, y2, xP, yP = _cut(_mnt_points(m), n)
    plains = (tk.mnt_miller_dbl_plain(spec, X, Y, Z, xP, yP),
              tk.mnt_miller_add_plain(spec, X, Y, Z, x2, y2, xP, yP))
    groups = ([[*X, *Y, *Z], [xP, yP]], [[*X, *Y, *Z], [*x2, *y2], [xP, yP]])
    for fn, g, plain in zip(cuda_lib.KERNELS["K14"][1], groups, plains):
        rc, out = _mnt(libs, fn, spec, g, tk.N15, n)
        assert rc == 0
        (a0, bb), Xn, Yn, Zn = plain
        assert_equal(tuple(out), (*a0, *bb, *Xn, *Yn, *Zn))


def test_mnt_kernels(libs):
    """K12, K13 and K14 at 24 words (MNT6753 Fq): the F6 product and
    square on random elements, the cyclotomic square on the easy part's
    outputs (where it equals the square), the Miller steps with Z = 0
    lanes and x2 = X/Z lanes; K3 and the 8/12-word tower kernels are
    refused at 24 words."""
    m = mnt6753()
    spec = m.fp_spec
    a = tk.unflatten6([rand(spec, 70 + k) for k in range(6)])
    b = tk.unflatten6([rand(spec, 80 + k) for k in range(6)])
    F6 = m.F6
    rng = np.random.default_rng(9)
    cyc = []
    for _ in range(N):
        f = tuple(tuple(int(v) % spec.q for v in rng.integers(
            1, 2 ** 62, size=3)) for _ in range(2))
        t = F6.mul(F6.conjugate(f), F6.inv(f))
        cyc.append(F6.mul(m._frobenius6(t), t))
    c = tk.unflatten6([fp.planes(ints_to_limbs_fast(
        [spec.to_mont(v[i][j]) for v in cyc], spec.n_limbs), "cpu")
        for i in range(2) for j in range(3)])
    for fn, groups, plain in (
            ("k12_f6_mul", [tk.flatten6(a), tk.flatten6(b)],
             tk.mnt_f6_mul_plain(spec, a, b)),
            ("k12_f6_sqr", [tk.flatten6(a)], tk.mnt_f6_sqr_plain(spec, a)),
            ("k13_f6_cyc_sqr", [tk.flatten6(c)],
             tk.mnt_f6_cyc_sqr_plain(spec, c))):
        rc, out = _mnt(libs, fn, spec, groups, tk.N6)
        assert rc == 0
        assert_equal(tk.unflatten6(out), plain)
    assert_equal(tk.mnt_f6_cyc_sqr_plain(spec, c),
                 tk.mnt_f6_sqr_plain(spec, c))

    X, Y, Z, x2, y2, xP, yP = _mnt_points(m)
    sl = slice(8, 12)                         # lanes 8..11: x2 = X/Z
    plains = (tk.mnt_miller_dbl_plain(spec, X, Y, Z, xP, yP),
              tk.mnt_miller_add_plain(spec, X, Y, Z, x2, y2, xP, yP))
    groups = ([[*X, *Y, *Z], [xP, yP]], [[*X, *Y, *Z], [*x2, *y2], [xP, yP]])
    for fn, g, plain in zip(cuda_lib.KERNELS["K14"][1], groups, plains):
        rc, out = _mnt(libs, fn, spec, g, tk.N15)
        assert rc == 0
        (a0, bb), Xn, Yn, Zn = plain
        assert_equal(tuple(out), (*a0, *bb, *Xn, *Yn, *Zn))
    assert all(int(p[:, sl].abs().sum()) == 0 for p in plains[1][0][0])
    x = rand(spec, 130)
    assert call(libs, "k3_butterfly", spec, (x, rand(spec, 131, 4),
                                             torch.empty_like(x)), (4,)) == 1
    with pytest.raises(RuntimeError, match="no kernel build for 48 limbs"):
        cuda_lib.launch("k8_f12_mul", spec, (x, x, x), (N, 9, 1))


# ---------------------------------------------------------------------------
# chip_smoke.py without a card
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent.parent


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        import time
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def rehearse(mp, libs, **sizes):
    """Patch the process so chip_smoke.py runs on the host libraries: every
    tensor claims to lie on the card (so each wrapper launches its kernel),
    every launch goes to the host build of its library, the default device
    is the CPU, and the card's queries answer for a stand-in.  `sizes`
    overrides chip_smoke's module constants.  Returns the module."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from wasmsnark_tpu_torch.groth16 import prover, setup, verifier
    from wasmsnark_tpu_torch.models import mnt6753_device, mnt6753_runtime
    from wasmsnark_tpu_torch.ops import pairing

    def cpu(device=None):
        return torch.device("cpu")

    for mod in (fp, pairing, prover, setup, verifier, mnt6753_device,
                mnt6753_runtime):
        if hasattr(mod, "resolve_device"):
            mp.setattr(mod, "resolve_device", cpu)
    mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    mp.setattr(cuda_lib, "_libs", dict(libs))
    mp.setattr(torch.cuda, "current_stream",
               lambda *a, **k: type("S", (), {"cuda_stream": None})())
    mp.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    mp.setattr(torch.cuda, "_sleep", lambda *a, **k: None)
    mp.setattr(torch.cuda, "Event", _Event)
    mp.setattr(torch.cuda, "is_available", lambda: True)
    mp.setattr(torch.cuda, "get_device_name", lambda *a: "host rehearsal")
    mp.setattr(torch.cuda, "device_count", lambda: 1)
    for name, v in sizes.items():
        mp.setattr(chip_smoke, name, v)
    return chip_smoke


def test_chip_smoke_mnt_kernel_phase_rehearsal(libs, monkeypatch):
    """chip_smoke.py's MNT6753 kernel phase (K1, K2 at 24 words, K12-K14)
    on 128 lanes of the host libraries: every row bit-equal to its plain
    version, with the rows' bounds and launch bookkeeping."""
    smoke = rehearse(monkeypatch, libs, N_LANES=128)
    rng = np.random.default_rng(smoke.SEED)
    rows = []

    def record(kid, name, source, line, fn_k, fn_p, args, nbytes, ops,
               fns=None):
        bad, err = smoke.mismatch(fn_k(*args), fn_p(*args))
        rows.append((kid, name, bad, err, smoke.bound(nbytes, ops)))

    spec = mnt6753().fp_spec

    def rnd(s):
        a = rng.integers(0, 1 << 16, size=(s.n_limbs, 128), dtype=np.uint32)
        a[-1] = rng.integers(0, s.q_limbs[-1], size=128, dtype=np.uint32)
        return fp.planes(a, "cpu")

    cuda_lib.reset_launches()
    smoke.check_mnt_kernels(rnd, record, 128)
    assert [(r[0], r[1]) for r in rows] == [
        ("K1", "mont_mul"), ("K2", "mod_add/mod_sub"), ("K12", "f6_mul"),
        ("K12", "f6_sqr"), ("K13", "f6_cyc_sqr"), ("K14", "mnt_miller_dbl"),
        ("K14", "mnt_miller_add")]
    assert all(r[2] == 0 and r[3] == 0 for r in rows), rows
    assert all(r[4][0] > 0 for r in rows)
    assert rows[5][4][1] == "operations"          # K14 dbl: bound by ops
    for kid in ("K1", "K2", "K12", "K13", "K14"):
        assert cuda_lib.launches[kid] > 0, kid
    assert all(any(key[:2] == (fn, 24) for key in cuda_lib.lane_launches)
               for fn in cuda_lib.KERNELS["K14"][1])
    assert spec.n_limbs == 48


def test_chip_smoke_times_rows_at_path_lanes(libs, monkeypatch):
    """chip_smoke.py's path-lane timing on the host libraries: the launch
    counters by lane count, the three most frequent lane counts of a row,
    its inputs cut (or repeated) to each, the bit-equality check there
    (a disagreeing plain version fails the row) and the bound scaled."""
    smoke = rehearse(monkeypatch, libs)
    spec = mnt6753().fp_spec
    a = tk.unflatten6([rand(spec, 70 + k) for k in range(6)])
    b = tk.unflatten6([rand(spec, 80 + k) for k in range(6)])
    cuda_lib.reset_launches()
    tk.mnt_f6_mul(spec, smoke.cut(a, 13, N), smoke.cut(b, 13, N))
    tk.mnt_f6_mul(spec, smoke.cut(a, 130, N), smoke.cut(b, 130, N))
    assert cuda_lib.lane_launches == {("k12_f6_mul", 24, 13): 1,
                                      ("k12_f6_mul", 24, 130): 1}
    assert smoke.lane_counts({**cuda_lib.lane_launches,
                              ("k12_f6_sqr", 24, 13): 5},
                             ("k12_f6_mul",), 24) == {13: 1, 130: 1}
    grown = smoke.cut(a[0][0], 130, N)
    assert torch.equal(grown[:, N:], a[0][0][:, :130 - N])
    cuda_lib.reset_launches()
    assert cuda_lib.lane_launches == {}

    def row(plain):
        return {"name": "K12 f6_mul @N24", "lanes": N, "bytes": 18 * 192 * N,
                "ops": 10 ** 6 * N,
                "run": (lambda a, b: tk.mnt_f6_mul(spec, a, b), plain,
                        (a, b)),
                "lanes_by_path": {"verify_batch": {13: 5, 30: 1},
                                  "pairing_batch": {13: 2, 1: 4, 7: 1}}}

    r = row(lambda a, b: tk.mnt_f6_mul_plain(spec, a, b))
    smoke.at_path_lanes(r)
    assert r["lanes_at_path"] == [1, 7, 13]
    assert sorted(r["ms_at_path"]) == [1, 7, 13]
    assert r["bound_ms_at_path"][13] == smoke.bound(18 * 192 * 13,
                                                    10 ** 6 * 13)[0]
    # on its own path (verify_batch) 13 lanes is timed, 30 is not
    assert r["path_loss_share"] == 5 / 6
    assert r["path_loss_ms"] == pytest.approx(
        5 * (r["ms_at_path"][13] - r["bound_ms_at_path"][13]))
    bad = row(lambda a, b: tk.mnt_f6_mul_plain(spec, b, b))
    with pytest.raises(AssertionError, match="disagrees with its plain"):
        smoke.at_path_lanes(bad)


if __name__ == "__main__":
    # the whole of chip_smoke.py at small sizes on the host libraries
    import sys
    import tempfile
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        host = build_host_libs(tmp)
        smoke = rehearse(mp, host, N_LANES=256, LOG_2N=5, N_VERIFY=16,
                         N_MNT=4, DEVICE="cpu")
        mp.setattr(smoke.subprocess, "run", lambda *a, **k: type(
            "R", (), {"stdout": "host rehearsal, 0 W"})())
        mp.setattr(smoke, "ptxas_summary", lambda d: {})
        sys.exit(smoke.main())
