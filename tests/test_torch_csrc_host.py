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
values 0, 1, q-1, q-2; equal, opposite and zero points for K5-K7 (K5 also
on promoted affine points, as the prove's bucket scan gives it; K7 with
Y = 0 lanes and 1, 2 and 16 doublings a launch); Z = 0 and x2 = X/Z lanes
for the Miller steps; cyclotomic elements for K13.
Tolerance: bit-identical.

The same libraries rehearse chip_smoke.py without a card (`rehearse`):
tensors claim to lie on the card, every launch goes to the host library,
and the default device is the CPU.  The tier-1 test runs its MNT6753
kernel phase on 128 lanes; the whole script runs at small sizes with

    PYTHONPATH=. python tests/test_torch_csrc_host.py

(a few minutes; N_LANES 256, LOG_2N 5, N_VERIFY 16, N_MNT 4,
ROUND_TRIP_LOG 10, steps 14-17 at the sizes of their tier-1 rehearsal,
step 18's ranks this file run with --mesh-rank).
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


def _gxx(out, lib, src, w, defines=(), extra="", prefix=""):
    """Start g++ on source `src` of csrc (its launch configurations removed,
    `prefix` put before it and `extra` appended) for word count w with -D
    `defines`, into out/lib<lib>.so; the headers must be in out."""
    text = (pathlib.Path(cuda_lib.CSRC) / src).read_text()
    cpp = out / f"{lib}.cpp"
    cpp.write_text(prefix + re.sub(r"<<<.*?>>>", "", text, flags=re.S)
                   + extra)
    return subprocess.Popen(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", f"-DWORDS={w}",
         *[f"-D{d}" for d in defines], f"-I{SHIM}", f"-I{out}", "-o",
         str(out / f"lib{lib}.so"), str(cpp)], stderr=subprocess.PIPE)


def build_host_libs(out, only=None, defines=(), extra="", prefix=""):
    """Every library of cuda_lib.libraries() (or those named in `only`),
    compiled by g++ for the host into the directory `out` and bound with
    the loader's argtypes; `defines`, `extra` and `prefix` as for _gxx."""
    out = pathlib.Path(out)
    for name in cuda_lib.HEADERS:
        shutil.copy(os.path.join(cuda_lib.CSRC, name), out / name)
    procs = {lib: _gxx(out, lib, src, w, defines, extra, prefix)
             for lib, (src, w) in cuda_lib.libraries().items()
             if only is None or lib in only}
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


def _on_demand_lib(out, w):
    """fp_kernels.cu compiled by g++ at w words (a width SOURCES does not
    list, as cuda_lib builds it at first use), bound like the loader's."""
    out = pathlib.Path(out)
    for name in cuda_lib.HEADERS:
        shutil.copy(os.path.join(cuda_lib.CSRC, name), out / name)
    lib = f"fp_kernels_w{w}"
    p = _gxx(out, lib, "fp_kernels.cu", w)
    _, err = p.communicate()
    assert p.returncode == 0, err.decode()[-3000:]
    return {lib: cuda_lib._bind(ctypes.CDLL(str(out / f"lib{lib}.so")))}


@pytest.mark.parametrize("q", [(1 << 127) - 1, (1 << 61) - 1])
def test_field_kernels_at_on_demand_widths(tmp_path, monkeypatch, q):
    """K1, K2 and K4 of fp_kernels.cu at 4 words (2^127 - 1, whose top word
    is 2^31 - 1: one spare bit) and 2 words (2^61 - 1) against their plain
    versions, then F1Runtime's methods through that library, its K1 and K2
    launched, against Python ints."""
    from wasmsnark_tpu_torch.fields.runtime import F1Runtime
    from wasmsnark_tpu_torch.fields.spec import FieldSpec
    spec = FieldSpec(q)
    w = spec.n_limbs // 2
    assert w not in cuda_lib.SOURCES["fp_kernels"][1]
    libs = _on_demand_lib(tmp_path, w)
    x, y = rand(spec, 1), rand(spec, 2).flip(1).contiguous()
    for fn, plain in (("k1_mont_mul", fp.mont_mul_plain),
                      ("k2_mod_add", fp.mod_add_plain),
                      ("k2_mod_sub", fp.mod_sub_plain)):
        out = torch.empty_like(x)
        assert call(libs, fn, spec, (x, y, out)) == 0
        assert torch.equal(out, plain(spec, x, y)), fn
    flag = torch.arange(N) % 3 == 0
    out = torch.empty_like(y)
    assert call(libs, "k4_cneg", spec, (flag, y, out)) == 0
    assert torch.equal(out, towers.mod_cneg_plain(spec, flag, y))
    rehearse(monkeypatch, libs)
    cuda_lib.reset_launches()
    rt = F1Runtime(q, "cpu")
    xs = [0, 1, q - 1, q - 2, 12345, q // 3]
    ys = [q - 1, 7, q - 1, 2, 0, q // 5]
    assert rt.mul(xs, ys) == [a * b % q for a, b in zip(xs, ys)]
    assert rt.square(xs) == [a * a % q for a in xs]
    assert rt.sub(xs, ys) == [(a - b) % q for a, b in zip(xs, ys)]
    assert rt.inverse(xs) == [pow(a, -1, q) if a else 0 for a in xs]
    assert cuda_lib.fn_launches["k1_mont_mul"] > 0
    assert cuda_lib.fn_launches["k2_mod_sub"] > 0
    assert {k[1] for k in cuda_lib.lane_launches} == {w}


def k1_team_max_lanes():
    """kK1TeamMaxLanes of fp_kernels.cu: above it K1 @N24 runs one thread a
    lane, up to it the team product."""
    text = (pathlib.Path(cuda_lib.CSRC) / "fp_kernels.cu").read_text()
    return int(re.search(r"#define K1_TEAM_MAX_LANES (\d+)", text).group(1))


def _mnt_operands(n):
    """x and y on n lanes of MNT6753's Fq (24 words): random canonical
    values from a seed, with the edge values 0, 1, q - 1, R mod q and two
    whose 32-bit words below the top one are all 0xFFFFFFFF (top word 0,
    and q's top word - 1) on lanes 0..5 of x, rotated by two on y's, and
    the same six squared on lanes 6..11."""
    spec = mnt6753().fp_spec
    q, W = spec.q, 32 * 23
    ones = (1 << W) - 1
    edge = [0, 1, q - 1, (1 << (W + 32)) % q, ones,
            ((q >> W) - 1) << W | ones]
    x, y = rand(spec, 150), rand(spec, 151).flip(1).contiguous()
    for j in range(12):
        x[:, j] = fp.planes(np.array(spec.limbs(edge[j % 6]),
                                     dtype=np.uint32)[:, None], "cpu")[:, 0]
        y[:, j] = fp.planes(np.array(spec.limbs(
            edge[(j + 2) % 6 if j < 6 else j - 6]), dtype=np.uint32)[:, None],
            "cpu")[:, 0]
    return spec, x[:, :n].contiguous(), y[:, :n].contiguous()


@pytest.fixture(scope="module")
def k1_one_thread(tmp_path_factory):
    """The 24-word field library built with K1_TEAM_MAX_LANES=0: K1 runs
    one thread a lane at every lane count."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return build_host_libs(tmp_path_factory.mktemp("k1_one_thread"),
                           only=("fp_kernels_w24",),
                           defines=("K1_TEAM_MAX_LANES=0",))


@pytest.mark.parametrize("n", [1, 13, 30, 96])
@pytest.mark.parametrize("design", ["team", "one_thread"])
def test_k1_24_words(libs, k1_one_thread, design, n):
    """K1 at 24 words on n lanes, in both of its designs: the team product
    (the library as built, n below the switch: one lane, ragged lane
    groups of its 4 lanes a block and full ones) and one thread a lane
    (the library built without the team), bit-equal to mont_mul_plain,
    with the edge values on the first lanes."""
    assert n <= k1_team_max_lanes()
    spec, x, y = _mnt_operands(n)
    lib = libs if design == "team" else k1_one_thread
    out = torch.empty_like(x)
    assert call(lib, "k1_mont_mul", spec, (x, y, out), n=n) == 0
    assert torch.equal(out, fp.mont_mul_plain(spec, x, y))


def test_k1_24_words_above_switch(libs):
    """K1 at 24 words on one lane more than the switch, where the library
    as built runs one thread a lane: the 96 lanes of the other cases
    tiled, against their plain products tiled the same way."""
    n = k1_team_max_lanes() + 1
    spec, x, y = _mnt_operands(N)
    idx = torch.arange(n) % N
    out = torch.empty((spec.n_limbs, n), dtype=x.dtype)
    assert call(libs, "k1_mont_mul", spec, (x[:, idx].contiguous(),
                                            y[:, idx].contiguous(), out),
                n=n) == 0
    assert torch.equal(out, fp.mont_mul_plain(spec, x, y)[:, idx])


@pytest.mark.parametrize("n", [1, 13, 30, 96, None])
def test_k2_24_words(libs, n):
    """K2 (add and sub) at 24 words on the lane counts of K1's tests (None:
    one more than K1's switch, the 96 lanes tiled), bit-equal to the plain
    versions, with the edge values on the first lanes."""
    spec, x, y = _mnt_operands(n or N)
    if n is None:
        n = k1_team_max_lanes() + 1
        idx = torch.arange(n) % N
        x, y = x[:, idx].contiguous(), y[:, idx].contiguous()
    for fn, plain in (("k2_mod_add", fp.mod_add_plain),
                      ("k2_mod_sub", fp.mod_sub_plain)):
        out = torch.empty_like(x)
        assert call(libs, fn, spec, (x, y, out), n=n) == 0
        assert torch.equal(out, plain(spec, x, y)), fn


_PROBE = """
extern "C" {
void probe_mul_add(uint32_t lo, uint64_t hi, uint64_t v, uint32_t w,
                   uint32_t* lo_out, uint64_t* hi_out) {
  Col c{lo, hi};
  mul_add(c, v, w);
  *lo_out = c.lo;
  *hi_out = c.hi;
}
uint64_t probe_carries48(const uint32_t* flags) { return carries<48>(flags); }
void probe_reduce_3q(const uint32_t* h, const uint32_t* q,
                     const uint32_t* q2, uint32_t* out) {
  uint32_t f1[6], f2[6];
  for (int k = 0; k < 24; ++k) {
    reinterpret_cast<uint8_t*>(f1)[k] = borrow_flag(h[k], q[k]);
    reinterpret_cast<uint8_t*>(f2)[k] = borrow_flag(h[k], q2[k]);
  }
  const uint64_t b1 = carries<24>(f1), b2 = carries<24>(f2);
  for (int k = 0; k < 24; ++k)
    out[k] = reduce_3q<24>(h[k], q[k], q2[k], b1, b2, k);
}
}
"""


def test_k1_team_building_blocks(tmp_path):
    """The parts of K1's team product that random operands almost never
    reach, on the host build of its device functions: a 33-bit word (2^32
    and 2^32 + 1) times a word into a column, the carry lookahead over
    48 words against a ripple, and the final H - 2q, H - q or H for H
    across [0, 3q), its edges included."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    build_host_libs(tmp_path, only=("fp_kernels_w24",), extra=_PROBE)
    lib = ctypes.CDLL(str(tmp_path / "libfp_kernels_w24.so"))
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.probe_mul_add.argtypes = [u32, u64, u64, u32, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.probe_carries48.restype = u64
    lib.probe_carries48.argtypes = [ctypes.c_void_p]
    lib.probe_reduce_3q.argtypes = [ctypes.c_void_p] * 4
    rng = np.random.default_rng(17)
    lo_out, hi_out = u32(), u64()
    for v in (0, 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1):
        for w in (0, 1, (1 << 32) - 1, int(rng.integers(1 << 32))):
            lo, hi = int(rng.integers(1 << 32)), int(rng.integers(1 << 40))
            lib.probe_mul_add(lo, hi, v, w, ctypes.byref(lo_out),
                              ctypes.byref(hi_out))
            assert lo_out.value + (hi_out.value << 32) == \
                lo + (hi << 32) + v * w, (v, w)
    for trial in range(200):
        kind = rng.integers(0, 3, size=48)    # 0 kill, 1 generate, 2 pass
        if trial % 2:
            kind[rng.integers(0, 48):] = 2    # long propagate runs
        flags = np.where(kind == 1, 1, np.where(kind == 2, 2, 0)).astype(
            np.uint8)
        got = int(lib.probe_carries48(flags.ctypes.data))
        c, want = 0, 0
        for k in range(48):
            want |= c << k
            c = int(kind[k] == 1 or (kind[k] == 2 and c))
        assert got == want | c << 48, trial
    q = mnt6753().fp_spec.q

    def words(v):
        return np.array([(v >> (32 * k)) & 0xFFFFFFFF for k in range(24)],
                        dtype=np.uint32)

    out = np.zeros(24, dtype=np.uint32)
    qw, q2w = words(q), words(2 * q)
    hs = [0, 1, q - 1, q, q + 1, 2 * q - 1, 2 * q, 2 * q + 1, 3 * q - 1]
    hs += [int.from_bytes(rng.bytes(96), "little") % (3 * q)
           for _ in range(30)]
    for h in hs:
        hw = words(h)
        lib.probe_reduce_3q(hw.ctypes.data, qw.ctypes.data, q2w.ctypes.data,
                            out.ctypes.data)
        assert sum(int(v) << (32 * k) for k, v in enumerate(out)) == h % q, h


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


def _ntt_splits(bits):
    """Splits of stages 0..bits-1 into passes (s0, s1, tile_log):
    ntt_passes's (one pass up to 2^10, two above), halves on the largest
    tiles and thirds on the smallest, 2^(s1 - s0) elements (one column a
    tile; some passes of no stages where bits < 3)."""
    a, b = bits // 3, 2 * bits // 3
    t = ntt.TILE_LOG
    splits = [ntt.ntt_passes(bits), [(0, bits // 2, t), (bits // 2, bits, t)],
              [(0, a, a), (a, b, b - a), (b, bits, bits - b)]]
    return [s for k, s in enumerate(splits) if s not in splits[:k]]


def _ntt_chain(libs, spec, x, tw, invn, split, gather, mirror):
    """The K3 passes of `split` over x on the host build: the first gathers
    where `gather`, the last mirrors and scales where `mirror`, a pass that
    does neither runs in place."""
    cur = x.clone()
    for k, (s0, s1, tile_log) in enumerate(split):
        g, m = gather and k == 0, mirror and k == len(split) - 1
        out = torch.empty_like(cur) if g or m else cur
        assert call(libs, "k3_ntt_pass", spec, (cur, tw, invn, out),
                    (s0, s1, int(g) | m << 1, tile_log), n=x.shape[1]) == 0
        cur = out
    return cur


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
@pytest.mark.parametrize("bits", range(1, 13))
def test_ntt_pass_kernel(libs, curve_name, bits):
    """K3's transform kernel over the curve's Fr, a 2^bits domain: every
    split of _ntt_splits, with and without the bit-reverse gather and the
    mirror-and-scale epilogue, with the plain and the odd-coset twiddles of
    NTTDevice.plan, bit-identical to ntt_pass_plain over all the stages in
    one call."""
    m = CURVES[curve_name]()
    fr = m.fr_spec
    nd = ntt.NTTDevice(m.ntt_spec, fp.FpDevice(fr, "cpu"))
    x = rand(fr, 40 + bits, 1 << bits)
    for odd in (False, True):
        plan = nd.plan(bits, odd, inverse=True)
        tw, invn = plan["tw"], plan["invn"]
        for gather in (False, True):
            for mirror in (False, True):
                want = ntt.ntt_pass_plain(fr, x, tw, 0, bits, gather,
                                          invn if mirror else None)
                for split in _ntt_splits(bits):
                    got = _ntt_chain(libs, fr, x, tw, invn, split, gather,
                                     mirror)
                    assert torch.equal(got, want), (odd, gather, mirror,
                                                    split)


def test_ntt_pass_refuses(libs):
    """k3_ntt_pass returns cudaErrorInvalidValue (1) on the 12- and 24-word
    builds, for a domain that is not a power of two, a tile larger than
    the kernel's, a pass of more stages than its tile holds, a stage past
    the domain, stages out of order and unknown flags."""
    fr = bn128().fr_spec
    x = rand(fr, 50, 1 << 12)
    tw, out = rand(fr, 51, (1 << 12) - 1), torch.empty_like(x)
    for spec in (bls12381().fp_spec, mnt6753().fp_spec):
        xs = rand(spec, 52, 64)
        assert call(libs, "k3_ntt_pass", spec, (xs, rand(spec, 53, 63),
                                                xs[:, :1].contiguous(),
                                                torch.empty_like(xs)),
                    (0, 6, 0, 6), n=64) == 1
    t = ntt.TILE_LOG
    for n, s0, s1, flags, tile_log in (
            (96, 0, 5, 0, t), (1 << 12, 0, t + 1, 0, t + 1),
            (1 << 12, 0, 6, 0, 5), (1 << 12, 1, 13, 0, t),
            (1 << 12, 0, 4, 4, t), (1 << 12, 5, 4, 0, t)):
        assert call(libs, "k3_ntt_pass", fr, (x, tw, x, out),
                    (s0, s1, flags, tile_log), n=n) == 1, (n, s0, s1, flags)
    assert call(libs, "k3_ntt_pass", fr, (x, tw, x, out), (0, 10, 3, t),
                n=1 << 12) == 0


def _points(m, seed):
    """Jacobian P, Q and affine Qa lanes: random multiples of G1 with
    random Z, lanes 0-7 P = Q, 8-15 P = -Q, 16-23 P = 0, 24-31 Q = 0; and
    P's affine lanes Pa (the affine zero (0, 0) where P = 0)."""
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
    Pa = (px.clone(), py.clone())
    P[2][:, 16:24] = 0
    Q[2][:, 24:32] = 0
    for c in Qa:
        c[:, 24:32] = 0
    for c in Pa:
        c[:, 16:24] = 0
    return P, Q, Qa, Pa


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
def test_curve_kernels(libs, curve_name):
    """K5-K7 at 8 (BN128) and 12 (BLS12-381) words."""
    m = CURVES[curve_name]()
    spec = m.fp_spec
    P, Q, Qa, _ = _points(m, 7)
    for fn, ins, ints, plain in (
            ("k5_jac_madd", (*P, *Qa), (),
             curve.jac_madd_plain(spec, P, Qa)),
            ("k6_jac_add", (*P, *Q), (), curve.jac_add_plain(spec, P, Q)),
            ("k7_jac_dbl", P, (1,), curve.jac_double_plain(spec, P))):
        outs = tuple(torch.empty_like(P[0]) for _ in range(3))
        assert call(libs, fn, spec,
                    (*[t.contiguous() for t in ins], *outs), ints) == 0
        assert_equal(outs, plain)


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
@pytest.mark.parametrize("n", [1, 13, 30, 96])
def test_k6_jac_add(libs, curve_name, n):
    """K6 at 8 (BN128) and 12 (BLS12-381) words on n lanes, against
    jac_add_plain: _points' P = Q, P = -Q, P = 0 and Q = 0 lanes, lanes
    32..35 where P and Q are both all-zero (an empty bucket on each side:
    H = r = 0 without P = Q), and lane 70 a P = Q pair (lane 0's) among
    lanes that add; one lane takes a random lane."""
    m = CURVES[curve_name]()
    spec = m.fp_spec
    P, Q, *_ = _points(m, 21)
    for c in (*P, *Q):
        c[:, 32:36] = 0
        c[:, 70] = c[:, 0]
    P, Q = _cut(P, n), _cut(Q, n)
    outs = tuple(torch.empty_like(P[0]) for _ in range(3))
    assert call(libs, "k6_jac_add", spec, (*P, *Q, *outs), n=n) == 0
    assert_equal(outs, curve.jac_add_plain(spec, P, Q))


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
def test_chip_smoke_counts_k6_ops_by_lane(curve_name):
    """chip_smoke.py's count of K6's operations (its bound) on test_k6's
    lanes, against the lanes told apart in affine coordinates on the host:
    a zero operand needs none, P = -Q the 8 products and 3 adds and subs
    of H and r, P = Q 15 and 17, an add 16 and 11."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    m = CURVES[curve_name]()
    spec = m.fp_spec
    P, Q, *_ = _points(m, 21)
    for c in (*P, *Q):
        c[:, 32:36] = 0
        c[:, 70] = c[:, 0]
    q = spec.q

    def affine(J):
        x, y, z = ([spec.from_mont(v) for v in limbs_to_ints(c.numpy())]
                   for c in J)
        return [None if zi == 0 else
                (xi * pow(zi, -2, q) % q, yi * pow(zi, -3, q) % q)
                for xi, yi, zi in zip(x, y, z)]

    kinds = {"zero": (0, 0), "neg": (8, 3), "dbl": (15, 17), "add": (16, 11)}
    seen = dict.fromkeys(kinds, 0)
    for p, r in zip(affine(P), affine(Q)):
        kind = ("zero" if p is None or r is None else "dbl" if p == r
                else "neg" if p == (r[0], -r[1] % q) else "add")
        seen[kind] += 1
    assert all(seen.values()), seen
    MM, AS = chip_smoke.mm_ops(spec), chip_smoke.as_ops(spec)
    assert chip_smoke.k6_ops(spec, P, Q) == sum(
        v * (kinds[k][0] * MM + kinds[k][1] * AS) for k, v in seen.items())


def _k5_lanes(m, seed, kind):
    """K5's operands: Jacobian P and affine Qa.  P is "path", promoted
    from _points' affine lanes (Z1 = one, as on the bucket scan's first
    step, where P = 0 is (0, one, 0)), or "general", _points' random-Z
    P.  Both with _points' P = Q, P = -Q, P = 0 and Q = 0 lanes, and
    lanes 32..35 where P is zero and Q the affine zero."""
    spec = m.fp_spec
    P, _, Qa, Pa = _points(m, seed)
    for c in (*Qa, *Pa):
        c[:, 32:36] = 0
    if kind == "path":
        jac = curve.JacobianDevice(towers.FpAdapter(fp.PlainFp(spec, "cpu")))
        P = tuple(c.contiguous() for c in jac.promote(Pa))
    else:
        P[2][:, 32:36] = 0
    return P, Qa


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
@pytest.mark.parametrize("kind", ["path", "general"])
@pytest.mark.parametrize("n", [1, 13, 30, 96])
def test_k5_jac_madd(libs, curve_name, kind, n):
    """K5 at 8 (BN128) and 12 (BLS12-381) words on n lanes of _k5_lanes,
    against jac_madd_plain: the branch of each lane kind, the Z1 = one
    shortcut on the path's lanes and the general products on the
    others."""
    m = CURVES[curve_name]()
    spec = m.fp_spec
    P, Qa = _cut(_k5_lanes(m, 23, kind), n)
    outs = tuple(torch.empty_like(P[0]) for _ in range(3))
    assert call(libs, "k5_jac_madd", spec, (*P, *Qa, *outs), n=n) == 0
    assert_equal(outs, curve.jac_madd_plain(spec, P, Qa))


# A host build of the curve kernels that counts the field operations they
# run: the source's products (mont_mul_nc) and adds and subs go through
# counting wrappers, which curve_op_counts reads and resets.
_COUNT_OPS = r"""
#include "team.cuh"
static long long g_ops[2];
template <int N, class Word>
Fe<N> counted_mont_mul_nc(const Field<N>& f, const Fe<N>& a, Word b) {
  ++g_ops[0];
  return mont_mul_nc<N>(f, a, b);
}
template <int N>
Fe<N> counted_add(const Field<N>& f, const Fe<N>& a, const Fe<N>& b) {
  ++g_ops[1];
  return add(f, a, b);
}
template <int N>
Fe<N> counted_sub(const Field<N>& f, const Fe<N>& a, const Fe<N>& b) {
  ++g_ops[1];
  return sub(f, a, b);
}
extern "C" void curve_op_counts(long long* out) {
  out[0] = g_ops[0];
  out[1] = g_ops[1];
  g_ops[0] = g_ops[1] = 0;
}
#define mont_mul_nc counted_mont_mul_nc
#define add counted_add
#define sub counted_sub
"""


@pytest.fixture(scope="module")
def counting_libs(tmp_path_factory):
    """The curve libraries built with _COUNT_OPS."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    libs = build_host_libs(tmp_path_factory.mktemp("curve_counting"),
                           only=("curve_kernels_w8", "curve_kernels_w12"),
                           prefix=_COUNT_OPS)
    for lib in libs.values():
        lib.curve_op_counts.argtypes = [ctypes.c_void_p]
    return libs


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
def test_chip_smoke_counts_k5_ops_by_lane(counting_libs, curve_name):
    """chip_smoke.py's K5 lane kinds and operation count (K5's bound) on
    _k5_lanes' path and general lanes: the kinds against the lanes told
    apart in affine coordinates on the host, the count against the
    products and adds and subs that K5 itself runs on each lane, one lane
    a launch (counting_libs), all bit-equal to the plain version."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    m = CURVES[curve_name]()
    spec = m.fp_spec
    q = spec.q
    MM, AS = chip_smoke.mm_ops(spec), chip_smoke.as_ops(spec)
    lib = counting_libs[f"curve_kernels_w{spec.n_limbs // 2}"]
    counts = np.zeros(2, np.int64)
    for kind in ("path", "general"):
        P, Qa = _k5_lanes(m, 23, kind)
        x1, y1, z1, x2, y2 = ([spec.from_mont(v) for v in
                               limbs_to_ints(c.numpy())] for c in (*P, *Qa))
        seen, ops = {}, 0
        for i, lane in enumerate(zip(x1, y1, z1, x2, y2)):
            xi, yi, zi, ax, ay = lane
            if zi == 0 or ax == ay == 0:
                key = "p_zero" if zi == 0 else "q_zero"
            else:
                p = (xi * pow(zi, -2, q) % q, yi * pow(zi, -3, q) % q)
                key = ("one_" if zi == 1 else "z_") + (
                    "dbl" if p == (ax, ay) else
                    "neg" if p == (ax, -ay % q) else "add")
            seen[key] = seen.get(key, 0) + 1
            ins = tuple(c[:, i:i + 1].contiguous() for c in (*P, *Qa))
            outs = tuple(torch.empty_like(ins[0]) for _ in range(3))
            lib.curve_op_counts(counts.ctypes.data)
            assert lib.k5_jac_madd(
                *[t.data_ptr() for t in (*ins, *outs)], 1, spec.n_limbs,
                cuda_lib.field_words(spec).ctypes.data, None) == 0
            assert_equal(outs, curve.jac_madd_plain(spec, ins[:3], ins[3:]))
            lib.curve_op_counts(counts.ctypes.data)
            ops += int(counts[0]) * MM + int(counts[1]) * AS
        kinds = chip_smoke.k5_lane_kinds(spec, P, Qa)
        assert {k: v for k, v in kinds.items() if v} == seen
        assert set(seen) == {"p_zero", "q_zero"} | {
            ("one_" if kind == "path" else "z_") + law
            for law in ("dbl", "neg", "add")}
        assert chip_smoke.k5_ops(spec, P, Qa) == ops


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
@pytest.mark.parametrize("times", [1, 2, 16])
def test_k7_jac_dbl_times(libs, curve_name, times):
    """K7 at 8 and 12 words, `times` doublings in one launch, against
    jac_double_plain: _points' random-Z P with Z = 0 on lanes 16-23 (left
    as they are at every step), Y = 0 on lanes 40-43 (Z = 0 after the
    first doubling, then left as they are) and X = 0 on lanes 44-45."""
    m = CURVES[curve_name]()
    spec = m.fp_spec
    P, *_ = _points(m, 29)
    P[1][:, 40:44] = 0
    P[0][:, 44:46] = 0
    outs = tuple(torch.empty_like(P[0]) for _ in range(3))
    assert call(libs, "k7_jac_dbl", spec, (*P, *outs), (times,)) == 0
    want = curve.jac_double_plain(spec, P, times)
    assert_equal(outs, want)
    assert_equal(tuple(c[:, 16:24] for c in outs),
                 tuple(c[:, 16:24] for c in P))
    assert not outs[2][:, 40:44].any()


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
def test_k7_jac_dbl_refuses_no_doublings(libs, curve_name):
    """k7_jac_dbl returns cudaErrorInvalidValue for times < 1, and
    jac_double refuses it before any launch."""
    spec = CURVES[curve_name]().fp_spec
    P, *_ = _points(CURVES[curve_name](), 29)
    outs = tuple(torch.empty_like(P[0]) for _ in range(3))
    for times in (0, -1):
        assert call(libs, "k7_jac_dbl", spec, (*P, *outs), (times,)) == 1
    with pytest.raises(ValueError, match="at least once"):
        curve.jac_double(spec, P, 0)


def _affine_planes(m, U, Z, sl):
    """The two planes of the F2 value U / Z on the lanes sl."""
    spec = m.fp_spec

    def vals(p):
        return [spec.from_mont(v)
                for v in limbs_to_ints(fp.to_numpy(p[:, sl]))]

    uz = [m.F2.mul((u0, u1), m.F2.inv((z0, z1)))
          for u0, u1, z0, z1 in zip(*(vals(p) for p in (*U, *Z)))]
    return [fp.planes(ints_to_limbs_fast([spec.to_mont(v[k]) for v in uz],
                                         spec.n_limbs), "cpu")
            for k in range(2)]


def _tower(libs, fn, spec, groups, ints, n=N):
    ops = [torch.stack(g)[..., :n].contiguous() for g in groups]
    out = torch.empty((tk.N12, spec.n_limbs, n), dtype=torch.int32)
    rc = call(libs, fn, spec, (*ops, out), ints, n)
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
    for c, v in zip(x2, _affine_planes(m, X, Z, sl)):
        c[:, sl] = v
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


def _cyclotomic(m, seed, count):
    """count elements of the cyclotomic subgroup of the curve's F12: the
    easy part of the final exponentiation, f^((q^6 - 1)(q^2 + 1)), of
    random f."""
    rng = np.random.default_rng(seed)
    F, q = m.F12, m.fp_spec.q
    out = []
    for _ in range(count):
        f = tuple(tuple(tuple(int(v) % q for v in rng.integers(
            1, 2 ** 62, size=2)) for _ in range(3)) for _ in range(2))
        t = F.mul(F.conjugate(f), F.inv(f))
        out.append(F.mul(m.frobenius(t, 2), t))
    return out


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
@pytest.mark.parametrize("n", [1, 13, 30, 96])
def test_k9_team_kernel(libs, curve_name, n):
    """K9's team kernel at 8 (BN128) and 12 (BLS12-381) words on n lanes:
    one lane, ragged lane groups (13 and 30 are not multiples of its 8
    lanes a block) and full ones; the edge values on lanes 0..3 and
    cyclotomic elements on lanes 4..11 and the last lane, where the
    cyclotomic square equals the F12 square."""
    m = CURVES[curve_name]()
    spec = m.fp_spec
    xi = tk.XI if curve_name == "bn128" else tk.XI_BLS
    planes = [rand(spec, 140 + k) for k in range(12)]
    cyc = [tk.flatten12(c) for c in _cyclotomic(m, 11, 9)]
    on = [*range(4, 12), N - 1]
    for k, p in enumerate(planes):
        p[:, on] = fp.planes(ints_to_limbs_fast(
            [spec.to_mont(c[k]) for c in cyc], spec.n_limbs), "cpu")
    a = _cut(tk.unflatten12(planes), n)
    rc, out = _tower(libs, "k9_f12_cyc_sqr", spec, [tk.flatten12(a)], xi, n)
    assert rc == 0
    got = tk.unflatten12(out)
    assert_equal(got, tk.f12_cyc_sqr_plain(spec, a, xi))
    on = slice(4, 12) if n >= 12 else slice(n - 1, n)
    for x, y in zip(leaves(got), leaves(tk.f12_sqr_plain(spec, a, xi)),
                    strict=True):
        assert torch.equal(x[:, on], y[:, on])


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
@pytest.mark.parametrize("n", [1, 13, 30, 96])
def test_k8_mul_team_kernel(libs, curve_name, n):
    """K8's product as a team kernel at 8 (BN128, xi = 9 + u) and 12
    (BLS12-381, xi = 1 + u) words on n lanes: one lane, ragged lane groups
    (13 and 30 are not multiples of its 8 lanes a block) and full ones; the
    edge values 0, 1, q - 1, q - 2 on lanes 0..3 of every component of
    both operands from 13 lanes on, and on lanes 4..7 b = a (a square)."""
    m = CURVES[curve_name]()
    spec = m.fp_spec
    xi = tk.XI if curve_name == "bn128" else tk.XI_BLS
    pa = [rand(spec, 160 + k) for k in range(12)]
    pb = [rand(spec, 180 + k) for k in range(12)]
    for x, y in zip(pa, pb):
        y[:, 4:8] = x[:, 4:8]
    a = _cut(tk.unflatten12(pa), n)
    b = _cut(tk.unflatten12(pb), n)
    rc, out = _tower(libs, "k8_f12_mul", spec,
                     [tk.flatten12(a), tk.flatten12(b)], xi, n)
    assert rc == 0
    assert_equal(tk.unflatten12(out), tk.f12_mul_plain(spec, a, b, xi))


def k8_team_max_lanes():
    """K8_TEAM_MAX_LANES of tower_kernels.cu at 8 words: above it K8's
    product runs one thread a lane there, up to it the team kernel."""
    text = (pathlib.Path(cuda_lib.CSRC) / "tower_kernels.cu").read_text()
    return int(re.search(r"#define K8_TEAM_MAX_LANES \(WORDS == 8 \? (\d+)",
                         text).group(1))


def test_k8_mul_above_switch(libs):
    """K8's product at 8 words (BN128) on one lane more than the switch,
    where the library as built runs one thread a lane: 96 lanes with the
    edge values tiled, against their plain products tiled the same way."""
    m = bn128()
    spec = m.fp_spec
    n = k8_team_max_lanes() + 1
    a = tk.unflatten12([rand(spec, 200 + k) for k in range(12)])
    b = tk.unflatten12([rand(spec, 220 + k) for k in range(12)])
    idx = torch.arange(n) % N
    ops = [torch.stack(tk.flatten12(x))[..., idx].contiguous() for x in (a, b)]
    out = torch.empty((tk.N12, spec.n_limbs, n), dtype=torch.int32)
    assert call(libs, "k8_f12_mul", spec, (*ops, out), tk.XI, n) == 0
    want = tk.f12_mul_plain(spec, a, b, tk.XI)
    for x, y in zip(tk.flatten12(tk.unflatten12(list(out.unbind(0)))),
                    tk.flatten12(want), strict=True):
        assert torch.equal(x, y[:, idx])


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
def test_k8_mul_other_xi(libs, curve_name):
    """K8's product with an xi other than its build's curve's (the team
    kernel is compiled for that one): 30 lanes run one thread a lane, and
    still equal the plain product at that xi."""
    spec = CURVES[curve_name]().fp_spec
    a = _cut(tk.unflatten12([rand(spec, 240 + k) for k in range(12)]), 30)
    b = _cut(tk.unflatten12([rand(spec, 260 + k) for k in range(12)]), 30)
    for xi in ((2, 1), (9, 3)):
        rc, out = _tower(libs, "k8_f12_mul", spec,
                         [tk.flatten12(a), tk.flatten12(b)], xi, 30)
        assert rc == 0
        assert_equal(tk.unflatten12(out), tk.f12_mul_plain(spec, a, b, xi))


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
@pytest.mark.parametrize("n", [1, 13, 30, 96])
def test_k8_sqr_team_kernel(libs, curve_name, n):
    """K8's square as a team kernel at 8 (BN128, xi = 9 + u) and 12
    (BLS12-381, xi = 1 + u) words on n lanes: one lane, ragged lane groups
    (13 and 30 are not multiples of its 8 lanes a block) and full ones,
    against f12_sqr_plain; the edge values 0, 1, q - 1, q - 2 on lanes 0..3
    and cyclotomic elements on lanes 4..11 and the last lane, where it
    equals K9's cyclotomic square."""
    m = CURVES[curve_name]()
    spec = m.fp_spec
    xi = tk.XI if curve_name == "bn128" else tk.XI_BLS
    planes = [rand(spec, 280 + k) for k in range(12)]
    cyc = [tk.flatten12(c) for c in _cyclotomic(m, 13, 9)]
    on = [*range(4, 12), N - 1]
    for k, p in enumerate(planes):
        p[:, on] = fp.planes(ints_to_limbs_fast(
            [spec.to_mont(c[k]) for c in cyc], spec.n_limbs), "cpu")
    a = _cut(tk.unflatten12(planes), n)
    rc, out = _tower(libs, "k8_f12_sqr", spec, [tk.flatten12(a)], xi, n)
    assert rc == 0
    assert_equal(tk.unflatten12(out), tk.f12_sqr_plain(spec, a, xi))
    rc, cyc_out = _tower(libs, "k9_f12_cyc_sqr", spec, [tk.flatten12(a)], xi,
                         n)
    assert rc == 0
    on = slice(4, 12) if n >= 12 else slice(n - 1, n)
    for x, y in zip(out, cyc_out, strict=True):
        assert torch.equal(x[:, on], y[:, on])


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
def test_k8_sqr_other_xi(libs, curve_name):
    """K8's square with an xi other than its build's curve's (the team
    kernel is compiled for that one): 30 lanes run K8's one-thread product
    of a with itself, and still equal the plain square at that xi."""
    spec = CURVES[curve_name]().fp_spec
    a = _cut(tk.unflatten12([rand(spec, 300 + k) for k in range(12)]), 30)
    for xi in ((2, 1), (9, 3)):
        rc, out = _tower(libs, "k8_f12_sqr", spec, [tk.flatten12(a)], xi, 30)
        assert rc == 0
        assert_equal(tk.unflatten12(out), tk.f12_sqr_plain(spec, a, xi))


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
@pytest.mark.parametrize("n", [1, 13, 30, 96])
def test_miller_dbl_team_kernel(libs, curve_name, n):
    """The Miller doubling as a team kernel on n lanes: the D twist (K10) at
    BN128's 8 words, the M twist (K11, xi = 1 + u) at BLS12-381's 12, against
    miller_dbl_plain / miller_dbl_mtwist_plain: one lane, ragged lane groups
    (13 and 30 are not multiples of its 8 lanes a block) and full ones, the
    edge values on lanes 0..3 of every plane, Z = 0 on lanes 4..7 and
    Y = 0 on lanes 8..11."""
    spec = CURVES[curve_name]().fp_spec
    X, Y, Z = [(rand(spec, 320 + 2 * k), rand(spec, 321 + 2 * k))
               for k in range(3)]
    xP, yP = rand(spec, 330), rand(spec, 331)
    for c in Z:
        c[:, 4:8] = 0
    for c in Y:
        c[:, 8:12] = 0
    X, Y, Z, xP, yP = _cut((X, Y, Z, xP, yP), n)
    if curve_name == "bn128":
        fn, extra = "k10_miller_dbl", ()
        plain = tk.miller_dbl_plain(spec, X, Y, Z, xP, yP)
    else:
        fn, extra = "k11_miller_dbl_mtwist", tk.XI_BLS
        plain = tk.miller_dbl_mtwist_plain(spec, X, Y, Z, xP, yP, tk.XI_BLS)
    rc, out = _tower(libs, fn, spec, [[*X, *Y, *Z], [xP, yP]], extra, n)
    assert rc == 0
    assert_equal(tk._step_out(out, spec.n_limbs, (n,)), plain)


def _miller_add_lanes(m, seed):
    """The Miller add's operands over N lanes, (X, Y, Z, x2, y2, xP, yP):
    the edge values on lanes 0..3 of every plane, Z = 0 on lanes 4..7,
    x2 = X/Z (lambda = x2 Z - X = 0) on 8..11, y2 = Y/Z (theta = 0) on
    12..15 and both (Q equal to the current point) on 16..19."""
    spec = m.fp_spec
    X, Y, Z, x2, y2 = [(rand(spec, seed + 2 * k), rand(spec, seed + 1 + 2 * k))
                       for k in range(5)]
    xP, yP = rand(spec, seed + 10), rand(spec, seed + 11)
    for c in Z:
        c[:, 4:8] = 0
    for (U, V), lo in (((X, x2), 8), ((Y, y2), 12), ((X, x2), 16),
                       ((Y, y2), 16)):
        sl = slice(lo, lo + 4)
        for c, v in zip(V, _affine_planes(m, U, Z, sl)):
            c[:, sl] = v
    return X, Y, Z, x2, y2, xP, yP


def _miller_add(libs, spec, pts, n):
    """The curve's Miller add (K10 at 8 words, K11 with xi = 1 + u at 12) on
    n lanes of pts through the host library, and its plain version."""
    X, Y, Z, x2, y2, xP, yP = pts
    if spec.n_limbs == 16:
        fn, extra = "k10_miller_add", ()
        plain = tk.miller_add_plain(spec, *pts)
    else:
        fn, extra = "k11_miller_add_mtwist", tk.XI_BLS
        plain = tk.miller_add_mtwist_plain(spec, *pts, tk.XI_BLS)
    rc, out = _tower(libs, fn, spec, [[*X, *Y, *Z], [*x2, *y2], [xP, yP]],
                     extra, n)
    assert rc == 0
    return tk._step_out(out, spec.n_limbs, (n,)), plain


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
@pytest.mark.parametrize("n", [1, 13, 30, 96])
def test_miller_add_team_kernel(libs, curve_name, n):
    """The Miller add as a team kernel on n lanes of _miller_add_lanes: the
    D twist (K10) at BN128's 8 words, the M twist (K11, xi = 1 + u) at
    BLS12-381's 12, against miller_add_plain / miller_add_mtwist_plain: one
    (random) lane, ragged lane groups (13 and 30 are not multiples of its 8
    lanes a block) and full ones, with the edge values, Z = 0, lambda = 0,
    theta = 0 and Q = the current point lanes."""
    m = CURVES[curve_name]()
    pts = _cut(_miller_add_lanes(m, 340), n)
    out, plain = _miller_add(libs, m.fp_spec, pts, n)
    assert_equal(out, plain)
    if n >= 20:                 # Q = the current point: lambda = theta = 0
        line = plain[0]
        assert all(int(c[:, 16:20].abs().sum()) == 0
                   for c in (*line[0], *line[1], *line[2]))


# A host build of the tower kernels that logs the field operations they run:
# every product (mont_mul_nc), add, sub and small multiple (mul_small, whose
# own adds stay unlogged: chip_smoke.py counts them as chains) with its
# operands and result, which tower_op_log copies out and clears.  fp.cuh
# comes first, so that the wrappers call its functions; team.cuh after the
# macros, so that a product stage's operand sums are logged.
_LOG_OPS = r"""
#include "fp.cuh"
#include <vector>
struct OpRec { uint32_t kind, a[24], b[24], r[24]; };
static std::vector<OpRec> g_log;
template <int N>
static void log_op(uint32_t kind, const Fe<N>& a, const Fe<N>& b,
                   const Fe<N>& r) {
  OpRec o{kind, {}, {}, {}};
  for (int k = 0; k < N; ++k) {
    o.a[k] = a.w[k];
    o.b[k] = b.w[k];
    o.r[k] = r.w[k];
  }
  g_log.push_back(o);
}
template <int N, class Word>
Fe<N> logged_mont_mul_nc(const Field<N>& f, const Fe<N>& a, Word b) {
  Fe<N> bb;
  for (int k = 0; k < N; ++k) bb.w[k] = b(k);
  const Fe<N> r = mont_mul_nc<N>(f, a, b);
  log_op<N>(0, a, bb, r);
  return r;
}
template <int N>
Fe<N> logged_add(const Field<N>& f, const Fe<N>& a, const Fe<N>& b) {
  const Fe<N> r = add(f, a, b);
  log_op<N>(1, a, b, r);
  return r;
}
template <int N>
Fe<N> logged_sub(const Field<N>& f, const Fe<N>& a, const Fe<N>& b) {
  const Fe<N> r = sub(f, a, b);
  log_op<N>(2, a, b, r);
  return r;
}
template <int N>
Fe<N> logged_mul_small(const Field<N>& f, const Fe<N>& a, int k) {
  Fe<N> kk = fe_zero<N>();
  kk.w[0] = (uint32_t)k;
  const Fe<N> r = mul_small(f, a, k);
  log_op<N>(3, a, kk, r);
  return r;
}
extern "C" long long tower_op_log(uint32_t* out, long long cap) {
  const long long n = (long long)g_log.size();
  for (long long i = 0; i < n && i < cap; ++i) {
    const OpRec& o = g_log[i];
    uint32_t* p = out + 73 * i;
    p[0] = o.kind;
    for (int k = 0; k < 24; ++k) {
      p[1 + k] = o.a[k];
      p[25 + k] = o.b[k];
      p[49 + k] = o.r[k];
    }
  }
  g_log.clear();
  return n;
}
#define mont_mul_nc logged_mont_mul_nc
#define add logged_add
#define sub logged_sub
#define mul_small logged_mul_small
#include "team.cuh"
"""


@pytest.fixture(scope="module")
def logging_libs(tmp_path_factory):
    """The tower libraries built with _LOG_OPS."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    libs = build_host_libs(tmp_path_factory.mktemp("tower_logging"),
                           only=("tower_kernels_w8", "tower_kernels_w12"),
                           prefix=_LOG_OPS)
    for lib in libs.values():
        lib.tower_op_log.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.tower_op_log.restype = ctypes.c_longlong
    return libs


def _live_ops(lib, outputs):
    """The operations of the log that the outputs need: walked back from
    the outputs' values through the operations that produce each value,
    an operation on the same operands counted once however often it ran.
    Every value on the way must have one producer, a multiple by 1 (the
    value itself) aside, so that the walk is the kernel's own dataflow.
    Returns (products, adds and subs, the multipliers of the live small
    multiples)."""
    buf = np.zeros((4096, 73), np.uint32)
    count = lib.tower_op_log(buf.ctypes.data, len(buf))
    assert 0 < count <= len(buf)
    producers = {}
    for rec in buf[:count]:
        key = (int(rec[0]), rec[1:25].tobytes(), rec[25:49].tobytes())
        producers.setdefault(rec[49:73].tobytes(), set()).add(key)
    todo, seen, live = list(outputs), set(), set()
    while todo:
        v = todo.pop()
        if v in seen:
            continue
        seen.add(v)
        keys = producers.get(v, set())
        assert len({k for k in keys if k[0] != 3 or k[1] != v}) <= 1
        for key in keys - live:
            live.add(key)
            todo += [key[1]] + ([key[2]] if key[0] != 3 else [])
    kinds = [k for k, _, _ in live]
    smalls = [int(np.frombuffer(b, np.uint32)[0]) for k, _, b in live
              if k == 3]
    return kinds.count(0), kinds.count(1) + kinds.count(2), smalls


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381"])
def test_chip_smoke_counts_miller_add_ops(logging_libs, curve_name):
    """chip_smoke.py's TOWER_OPS for the Miller add (the rows' bound)
    against what the team kernel's results need on one random lane: the
    products and adds and subs that its outputs depend on, each counted
    once (logging_libs).  On the M twist the multiplication by xi = 1 + u
    adds its two multiples by 1 and a sub and an add, which chip_smoke.py
    counts apart (xi_ops); the D twist has none."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    m = CURVES[curve_name]()
    spec = m.fp_spec
    lib = logging_libs[f"tower_kernels_w{spec.n_limbs // 2}"]
    lib.tower_op_log(None, 0)
    out, plain = _miller_add(logging_libs, spec,
                             _cut(_miller_add_lanes(m, 360), 1), 1)
    assert_equal(out, plain)
    words = []                  # each output as its record's 24 words
    for c in leaves(out):
        limbs = c[:, 0].numpy().astype(np.uint32)
        w = np.zeros(24, np.uint32)
        w[:len(limbs) // 2] = limbs[0::2] | limbs[1::2] << 16
        words.append(w.tobytes())
    prods, adds, smalls = _live_ops(lib, words)
    mtwist = curve_name == "bls12381"
    fn = cuda_lib.KERNELS["K11" if mtwist else "K10"][1][1]
    want_prods, want_adds, n_xi = chip_smoke.TOWER_OPS[fn]
    assert n_xi == int(mtwist)
    assert (prods, adds, smalls) == (want_prods, want_adds + 2 * n_xi,
                                     [1, 1] * n_xi)


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


def _mnt_cyclotomic(m, seed, count):
    """count elements of MNT6753's cyclotomic subgroup: the easy part of
    the final exponentiation, f^((q^3 - 1)(q + 1)), of random f."""
    rng = np.random.default_rng(seed)
    F6, q = m.F6, m.fp_spec.q
    out = []
    for _ in range(count):
        f = tuple(tuple(int(v) % q for v in rng.integers(
            1, 2 ** 62, size=3)) for _ in range(2))
        t = F6.mul(F6.conjugate(f), F6.inv(f))
        out.append(F6.mul(m._frobenius6(t), t))
    return out


@pytest.mark.parametrize("n", [1, 13, 30, 96])
def test_mnt_team_kernels(libs, n):
    """The MNT6753 team kernels, K12's F6 product and square, K13's
    cyclotomic square and K14's doubling and mixed add, on n lanes: one
    lane, ragged lane groups (13 and 30 are multiples of neither K12's and
    K13's 8 nor K14's 4 lanes a block) and full ones, with the edge values,
    the Z = 0 lanes 4..7 and the x2 = X/Z lanes 8..11 from 13 lanes on; K13
    also on cyclotomic elements at lanes 4..11 and the last lane, where it
    equals the square."""
    m = mnt6753()
    spec = m.fp_spec
    a = _cut(tk.unflatten6([rand(spec, 70 + k) for k in range(6)]), n)
    b = _cut(tk.unflatten6([rand(spec, 80 + k) for k in range(6)]), n)
    rc, out = _mnt(libs, "k12_f6_mul", spec, [tk.flatten6(a), tk.flatten6(b)],
                   tk.N6, n)
    assert rc == 0
    assert_equal(tk.unflatten6(out), tk.mnt_f6_mul_plain(spec, a, b))
    rc, out = _mnt(libs, "k12_f6_sqr", spec, [tk.flatten6(a)], tk.N6, n)
    assert rc == 0
    assert_equal(tk.unflatten6(out), tk.mnt_f6_sqr_plain(spec, a))
    rc, out = _mnt(libs, "k13_f6_cyc_sqr", spec, [tk.flatten6(a)], tk.N6, n)
    assert rc == 0
    assert_equal(tk.unflatten6(out), tk.mnt_f6_cyc_sqr_plain(spec, a))
    planes = [rand(spec, 100 + k) for k in range(6)]
    on = [*range(4, 12), N - 1]
    cyc = _mnt_cyclotomic(m, 12, len(on))
    for k, p in enumerate(planes):
        p[:, on] = fp.planes(ints_to_limbs_fast(
            [spec.to_mont(c[k // 3][k % 3]) for c in cyc], spec.n_limbs),
            "cpu")
    c = _cut(tk.unflatten6(planes), n)
    rc, out = _mnt(libs, "k13_f6_cyc_sqr", spec, [tk.flatten6(c)], tk.N6, n)
    assert rc == 0
    got = tk.unflatten6(out)
    assert_equal(got, tk.mnt_f6_cyc_sqr_plain(spec, c))
    on = slice(4, 12) if n >= 12 else slice(n - 1, n)
    for x, y in zip(leaves(got), leaves(tk.mnt_f6_sqr_plain(spec, c)),
                    strict=True):
        assert torch.equal(x[:, on], y[:, on])
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
    cyc = _mnt_cyclotomic(m, 9, N)
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
    from wasmsnark_tpu_torch.parallel import mesh

    def cpu(device=None):
        return torch.device("cpu")

    for mod in (fp, pairing, prover, setup, verifier, mnt6753_device,
                mnt6753_runtime, mesh):
        if hasattr(mod, "resolve_device"):
            mp.setattr(mod, "resolve_device", cpu)
    mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    mp.setattr(cuda_lib, "_libs", dict(libs))
    mp.setattr(torch.cuda, "current_stream",
               lambda *a, **k: type("S", (), {"cuda_stream": None})())
    mp.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    mp.setattr(torch.cuda, "set_device", lambda *a, **k: None)
    mp.setattr(torch.cuda, "_sleep", lambda *a, **k: None)
    mp.setattr(torch.cuda, "Event", _Event)
    for name in ("memory_allocated", "max_memory_allocated"):
        mp.setattr(torch.cuda, name, lambda *a, **k: 0)
    mp.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    mp.setattr(torch.cuda, "is_available", lambda: True)
    mp.setattr(torch.cuda, "get_device_name", lambda *a: "host rehearsal")
    mp.setattr(torch.cuda, "device_count", lambda: 1)
    for name, v in sizes.items():
        mp.setattr(chip_smoke, name, v)
    return chip_smoke


def test_chip_smoke_mnt_kernel_phase_rehearsal(libs, monkeypatch):
    """chip_smoke.py's MNT6753 kernel phase (K1, K2, K4 at 24 words,
    K12-K14) on 128 lanes of the host libraries: every row bit-equal to its
    plain version, with the rows' bounds and launch bookkeeping."""
    smoke = rehearse(monkeypatch, libs, N_LANES=128)
    rng = np.random.default_rng(smoke.SEED)
    rows = []

    def record(kid, name, source, line, fn_k, fn_p, args, nbytes, ops,
               fns=None, **extra):
        bad, err = smoke.mismatch(fn_k(*args), fn_p(*args))
        rows.append((kid, name, bad, err, smoke.bound(nbytes, ops)))
        per_call = extra.get("launches_per_call", lambda k: 1)
        # the K2 row times the add-and-sub pair: two launches a call
        assert per_call(128) == (2 if kid == "K2" else 1), kid

    spec = mnt6753().fp_spec

    def rnd(s):
        a = rng.integers(0, 1 << 16, size=(s.n_limbs, 128), dtype=np.uint32)
        a[-1] = rng.integers(0, s.q_limbs[-1], size=128, dtype=np.uint32)
        return fp.planes(a, "cpu")

    cuda_lib.reset_launches()
    smoke.check_mnt_kernels(rnd, record, 128)
    assert [(r[0], r[1]) for r in rows] == [
        ("K1", "mont_mul"), ("K2", "mod_add/mod_sub"), ("K4", "cneg"),
        ("K12", "f6_mul"), ("K12", "f6_sqr"), ("K13", "f6_cyc_sqr"),
        ("K14", "mnt_miller_dbl"), ("K14", "mnt_miller_add")]
    assert all(r[2] == 0 and r[3] == 0 for r in rows), rows
    assert all(r[4][0] > 0 for r in rows)
    assert rows[6][4][1] == "operations"          # K14 dbl: bound by ops
    for kid in ("K1", "K2", "K4", "K12", "K13", "K14"):
        assert cuda_lib.launches[kid] > 0, kid
    assert all(any(key[:2] == (fn, 24) for key in cuda_lib.lane_launches)
               for fn in cuda_lib.KERNELS["K14"][1])
    assert spec.n_limbs == 48


@pytest.mark.parametrize("step", ["ladders", "complete", "f1",
                                  "finexp_scan"])
def test_chip_smoke_module_steps_rehearsal(libs, tmp_path, monkeypatch,
                                           step):
    """chip_smoke.py's steps 14-17 on the host libraries at small sizes:
    the ladders (16 G1 lanes, 16 MNT6753 lanes, FpDynamic on 64), the
    complete law (256 lanes), F1Runtime (16 lanes, the 4-word library
    given as built at first use) and, on BN128, the full-exponent scan
    against final_exponentiation on four lanes; every check of the script
    passes and the records carry their times and launches."""
    libs = dict(libs)
    w4 = _on_demand_lib(tmp_path, 4)
    smoke = rehearse(monkeypatch, {**libs, **w4}, N_LADDER=16,
                     N_LADDER_MNT=16, N_EXP=64, N_COMPLETE=256, N_F1=16,
                     F1_BENCH_MULS=1 << 10, REPS=1)
    monkeypatch.setattr(cuda_lib, "build_seconds", {"fp_kernels_w4": 0.0})
    dev = torch.device("cpu")
    if step == "finexp_scan":
        from wasmsnark_tpu_torch.ops.pairing import pairing_device
        pd = pairing_device("bn128")
        m = pd.m
        pts = [m.G1.affine(m.G1.times_scalar(m.g1_gen, k))[:2]
               for k in (2, 3, 5, 7)]
        f = pd.miller_loop(pd.pack_g1(pts), pd.pack_g2(
            [m.G2.affine(m.g2_gen)[:2]] * 4))
        monkeypatch.setattr(smoke, "MILLER", {"bn128": f})
        rec = smoke.run_finexp_scan()["bn128"]
        assert rec["exponent_bits"] == len(pd.finexp_bits)
        assert set(rec["launches"]) == {"k8_f12_mul", "k8_f12_sqr"}
        assert rec["launches"]["k8_f12_sqr"] == len(pd.finexp_bits) - 1
        return
    run = {"ladders": smoke.run_ladders, "complete": smoke.run_complete,
           "f1": smoke.run_f1}[step]
    rec = run(dev)
    if step == "ladders":
        assert set(rec) == {"bn128", "bls12381", "mnt6753",
                            "exp_bn128_fq", "exp_mnt6753_fq"}
        bn = rec["bn128"]
        assert {"k4_cneg", "k6_jac_add", "k7_jac_dbl"} <= set(
            bn["signed_launches"])
        # c = 4 over 256-bit scalars: 64 windows below the carry's
        assert bn["signed_launches"]["k7_jac_dbl"] == 64
        assert bn["plain_launches"]["k7_jac_dbl"] == 256
        assert set(rec["mnt6753"]["signed_launches"]) <= {
            "k1_mont_mul", "k2_mod_add", "k2_mod_sub", "k4_cneg"}
    elif step == "complete":
        assert set(rec["g1"]["add_launches"]) == {"k1_mont_mul",
                                                  "k2_mod_add", "k2_mod_sub"}
        assert rec["g2"]["add_launches"]["k1_mont_mul"] == 3
    else:
        assert rec["p127"]["words"] == 4 and rec["p127"]["build_s"] == 0.0
        assert rec["bn128_r"]["muls_per_s"] > 0


def test_chip_smoke_ntt_phase_rehearsal(libs, monkeypatch):
    """chip_smoke.py's K3 phase on the host libraries at n = 1,024: one
    stage at h = 1, 2^7 and n/2, the 1,024-point fft and odd-coset fft (one
    pass each) and the 2,048-point ifft (two) bit-equal to their plain
    versions, the 2^11 round trip returning its input, and the K3 row:
    timed on the fft, with the transforms' launches and bounds, and its
    path-lane run on the ifft at the prove's two sizes."""
    smoke = rehearse(monkeypatch, libs, ROUND_TRIP_LOG=11)
    rng = np.random.default_rng(smoke.SEED)
    m = bn128()
    fr = m.fr_spec
    rows = []

    def rnd(spec, k=1024):
        a = rng.integers(0, 1 << 16, size=(spec.n_limbs, k), dtype=np.uint32)
        a[-1] = rng.integers(0, spec.q_limbs[-1], size=k, dtype=np.uint32)
        return fp.planes(a, "cpu")

    def record(curve, spec, kid, name, source, line, fn_k, fn_p, args,
               nbytes, ops, **extra):
        bad, err = smoke.mismatch(fn_k(*args), fn_p(*args))
        rows.append({"name": f"{kid} {name}", "mismatched_lanes": bad,
                     "max_abs_err": err, "lanes": 1024, "bytes": nbytes,
                     "ops": ops(*args), "ms": 0.5, "run": (fn_k, fn_p, args),
                     "bound_ms": smoke.bound(nbytes, ops(*args))[0],
                     **extra})

    cuda_lib.reset_launches()
    smoke.check_ntt_kernels("bn128", m, "cpu", rnd, record, 1024,
                            timed=True)
    assert cuda_lib.fn_launches["k3_butterfly"] > 0
    (row,) = rows
    assert row["name"] == "K3 ntt_pass" and row["mismatched_lanes"] == 0
    t = row["transforms"]
    assert list(t) == ["fft 1024", "odd fft 1024", "ifft 2048",
                       "round trip 2048"]
    assert [v["launches"] for v in t.values()] == [1, 1, 2, 4]
    assert t["round trip 2048"]["returns_input"] is True
    assert all(v.get("max_abs_err", 0) == 0 for v in t.values())
    assert t["ifft 2048"]["bound_ms"] == smoke.bound(
        3 * 2048 * 64, 1024 * 11 * 328 + 2048 * 280)[0]
    assert smoke.ntt_ops(fr, 1 << 16, False) == 16 * (1 << 15) * 328
    row["lanes_by_path"] = {"prove": {1024: 4, 2048: 2}}
    cuda_lib.reset_launches()
    smoke.at_path_lanes(row)
    assert row["lanes_at_path"] == [1024, 2048]
    assert row["bound_ms_at_path"][2048] == smoke.bound(
        row["bytes"] * 2, smoke.ntt_ops(fr, 2048, True))[0]
    # four 1,024-point transforms of one launch, one 2,048-point of two
    ms, bd = row["ms_at_path"], row["bound_ms_at_path"]
    assert row["path_loss_ms"] == pytest.approx(
        4 * (ms[1024] - bd[1024]) + (ms[2048] - bd[2048]))
    assert cuda_lib.lane_launches[("k3_ntt_pass", 8, 2048)] > 0


def test_chip_smoke_times_rows_at_path_lanes(libs, monkeypatch):
    """chip_smoke.py's path-lane timing on the host libraries: the launch
    counters by lane count, the three most frequent lane counts of a row
    and the one of its own path with the most launches x lanes besides
    them, its inputs cut (or repeated) to each, the bit-equality check
    there (a disagreeing plain version fails the row), the bound scaled,
    the loss measured over the counts timed and estimated over all, and
    the estimate's check at the untimed count with the most work."""
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

    def row(plain, lanes_by_path):
        return {"name": "K12 f6_mul @N24", "lanes": N, "bytes": 18 * 192 * N,
                "ops": 10 ** 6 * N, "ms": 0.5, "bound_ms": 0.1,
                "run": (lambda a, b: tk.mnt_f6_mul(spec, a, b), plain,
                        (a, b)),
                "lanes_by_path": lanes_by_path}

    def bound_ms(k):
        return smoke.bound(18 * 192 * k, 10 ** 6 * k)[0]

    def good(a, b):
        return tk.mnt_f6_mul_plain(spec, a, b)

    # the three most frequent counts are 1, 7 and 13; the most lane-work
    # of its own path (verify_batch) besides them is 30's
    r = row(good, {"verify_batch": {13: 5, 30: 1},
                   "pairing_batch": {13: 2, 1: 4, 7: 1}})
    smoke.at_path_lanes(r)
    assert r["lanes_at_path"] == [1, 7, 13, 30]
    assert sorted(r["ms_at_path"]) == [1, 7, 13, 30]
    assert r["bound_ms_at_path"][13] == bound_ms(13)
    assert r["path_loss_share"] == 1.0
    loss = sum(v * (r["ms_at_path"][k] - r["bound_ms_at_path"][k])
               for k, v in ((13, 5), (30, 1)))
    assert r["path_loss_ms"] == pytest.approx(loss)
    assert r["path_loss_est_ms"] == pytest.approx(loss)
    assert r["est_check"] is None             # nothing left untimed
    # 4, 13 and 30 most frequent, 200 the most lane-work besides; then 150
    # is estimated from 200's loss per lane (the nearest timed count above
    # the check's N lanes) and timed: of the counts still untimed its
    # lane-work times its distance from 200, 150 log(200 / 150), passes
    # 50's from 30, 50 log(50 / 30); 50 is counted at the ms of 30 (the
    # nearest timed count at or below N)
    assert smoke.scaled_from(row(good, {}) | {
        "ms_at_path": {30: 0, 200: 0}}, 50) == 30
    r = row(good, {"prove": {4: 16, 13: 2, 30: 1, 50: 1, 150: 1, 200: 1}})
    smoke.at_path_lanes(r)
    assert r["lanes_at_path"] == [4, 13, 30, 150, 200]
    ms, bd = r["ms_at_path"], r["bound_ms_at_path"]
    assert r["path_loss_share"] == 21 / 22
    loss = sum(v * (ms[k] - bd[k]) for k, v in ((4, 16), (13, 2), (30, 1),
                                                 (150, 1), (200, 1)))
    assert r["path_loss_ms"] == pytest.approx(loss)
    check = r["est_check"]
    assert check["lanes"] == 150
    assert check["est_ms"] == pytest.approx((ms[200] - bd[200]) * 150 / 200)
    assert check["ms"] == pytest.approx(ms[150] - bd[150])
    assert check["err"] == pytest.approx(check["est_ms"] / check["ms"] - 1)
    assert smoke.untimed_loss_ms(r, 50) == pytest.approx(ms[30]
                                                         - bound_ms(50))
    assert smoke.untimed_loss_ms(r, 170) == pytest.approx(
        (ms[150] - bd[150]) * 170 / 150)
    assert smoke.untimed_loss_ms(r, 90) == pytest.approx(0.5 - bound_ms(90))
    assert r["path_loss_est_ms"] == pytest.approx(
        loss + smoke.untimed_loss_ms(r, 50))
    bad = row(lambda a, b: tk.mnt_f6_mul_plain(spec, b, b),
              {"verify_batch": {13: 5, 30: 1}})
    with pytest.raises(AssertionError, match="disagrees with its plain"):
        smoke.at_path_lanes(bad)


def rehearse_mesh(mp, libs, **sizes):
    """rehearse() for chip_smoke.py's step 18: its world of one on gloo,
    its ranks this file run with --mesh-rank on the same host
    libraries."""
    import sys
    libdir = os.path.dirname(next(iter(libs.values()))._name)
    smoke = rehearse(mp, libs, MESH_BACKEND="gloo", **sizes)
    mp.setattr(smoke, "MESH_RANK_CMD", [sys.executable, __file__,
                                        "--mesh-rank", libdir])
    return smoke


def test_chip_smoke_mesh_step_rehearsal(libs, monkeypatch):
    """chip_smoke.py's step 18 on the host libraries, 2^5 - 2 constraints:
    the world of one (gloo here) and two ranks of this file run as
    subprocesses (--mesh-rank) return the unsharded proof with CALC_H
    split (the world of one with the unsharded CALC_H's launches and no
    exchange, the two ranks with one exchange a transform and the last to
    H's blocks, half the bytes), a tampered copy does not verify, the
    sharded round trip (2^8) returns its input and the sharded fft (2^6)
    equals the unsharded one, and the record carries every prove's wall,
    rank 0's launches on its half of the points and the bytes each rank
    holds: its half of the points and of the QAP entries."""
    import wasmsnark_tpu_torch
    from wasmsnark_tpu_torch.groth16.setup import (
        setup, square_chain_circuit, square_chain_witness)
    from wasmsnark_tpu_torch.groth16.pkey import write_witness
    smoke = rehearse_mesh(monkeypatch, libs, LOG_2N=5, MESH_WORLD=2,
                          MESH_RT_LOG=8, MESH_FFT_LOG=6)
    m = bn128()
    k = (1 << 5) - 2
    pkey, vk, _ = setup(square_chain_circuit(k), seed=3, module=m)
    wit = square_chain_witness(k, 3, r=m.Fr.q)
    wbytes = write_witness(wit, m.fr_spec)
    proof = wasmsnark_tpu_torch.build_bn128().groth16_gen_proof(
        wbytes, pkey, rng=7)
    monkeypatch.setattr(smoke, "PROVE", {"bn128": (
        pkey, wbytes, proof, vk, [str(wit[1])])})
    rec = smoke.run_mesh()
    one, ranks = rec["world_of_one"], rec["ranks"]
    n_pad = one["n_pad"]
    assert one["backend"] == "gloo" and one["points_block"] == n_pad
    assert ranks["world"] == 2 and len(ranks["prove_steady_s"]) == 2
    rank0 = ranks["rank0"]
    assert rank0["points_block"] == -(-n_pad // 2)
    for fn in ("k3_ntt_pass", "k4_cneg", "k5_jac_madd", "k6_jac_add",
               "k7_jac_dbl"):
        assert one["launches"][fn] and rank0["launches"][fn], fn
    assert rank0["max_lanes"]["k5_jac_madd"] < one["max_lanes"][
        "k5_jac_madd"]
    for up in ranks["upload_bytes"]:
        assert up["points"] < one["upload_bytes"]["points"]
        assert up["qap"] < 0.75 * one["upload_bytes"]["qap"]
    c1 = one["calc_h"]
    assert c1["path"] == "sharded" and c1["exchanges"] == {}
    assert c1["launches"] == rec["unsharded_calc_h"]["launches"]
    assert c1["launches"]["k3_ntt_pass"] and c1["launches"]["k1_mont_mul"]
    for c in ranks["calc_h"]:
        assert c["path"] == "sharded" and c["domain_part"] == 16
        assert c["exchanges"] == {"ifft": 1, "fft_odd": 1, "ifft_2n": 1,
                                  "h_blocks": 1}
        b = c["exchange_bytes"]
        assert b["ifft"] == b["fft_odd"] == b["ifft_2n"] == 2 * b[
            "h_blocks"] == 2 * 16 * 4 * 16
        assert c["launches"]["k3_ntt_pass"] > c1["launches"]["k3_ntt_pass"]
    for tr in [one["transforms"]] + ranks["transforms"]:
        assert tr["round_trip"]["returns_input"] and tr["round_trip"][
            "log"] == 8
        assert tr["fft_check"]["equals_unsharded"]
        ex = tr["round_trip"]["exchanges"]
        assert ex == ({} if tr["ranks"] == 1 else {"fft": 3, "ifft": 3})


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["--mesh-rank"]:
        # a rank of chip_smoke.py's step 18 on the host libraries in
        # sys.argv[2]
        with pytest.MonkeyPatch.context() as mp:
            host = {lib: cuda_lib._bind(ctypes.CDLL(os.path.join(
                sys.argv[2], f"lib{lib}.so"))) for lib in cuda_lib.libraries()}
            smoke = rehearse(mp, host, DEVICE="cpu")
            sys.exit(smoke.mesh_rank(int(sys.argv[3]), int(sys.argv[4]),
                                     sys.argv[5]))
    # the whole of chip_smoke.py at small sizes on the host libraries
    import tempfile
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        host = {**build_host_libs(tmp), **_on_demand_lib(tmp, 4)}
        smoke = rehearse_mesh(mp, host, N_LANES=256, LOG_2N=5, N_VERIFY=16,
                              N_MNT=4, ROUND_TRIP_LOG=10, DEVICE="cpu",
                              N_LADDER=16, N_LADDER_MNT=16, N_EXP=64,
                              N_COMPLETE=256, N_F1=16,
                              F1_BENCH_MULS=1 << 10, REPS=1)
        # step 16's 4-word library stands for one built at first use
        mp.setattr(cuda_lib, "build_seconds", {"fp_kernels_w4": 0.0})
        mp.setattr(smoke.subprocess, "run", lambda *a, **k: type(
            "R", (), {"stdout": "host rehearsal, 0 W"})())
        mp.setattr(smoke, "ptxas_summary", lambda d: {})
        sys.exit(smoke.main())
