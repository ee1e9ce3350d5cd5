"""The CUDA kernels K1-K14 against their plain versions on the card: K1-K10
at BN128's 8 words, K1-K3 over BLS12-381's Fr (8 words), K1, K2, K4-K9
and K11 over BLS12-381's Fq (12 words), and K1, K2, K4 and K12-K14 over
MNT6753's Fq (24 words); K3 also as NTTDevice's transforms and their
passes over both curves' Fr, up to 2^17 points, and a 2^21 round trip;
the team kernels of K8's product and square, K9, the Miller doubling and
add of K10 and K11 and K12-K14, K1 and K2 at 24 words and K6 at 8 and
12, also at the lane counts of their paths; K5 on promoted affine
points, as the prove gives it, and K7 with several doublings a launch.

Marked `cuda`: they need an NVIDIA card and nvcc, and skip elsewhere.  On
the card, where jax is not installed and tests/conftest.py would import
it: python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

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

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_lib.build()
    return torch.device("cuda")


def _rand(spec, n, seed, dev):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(spec.n_limbs, n), dtype=np.uint32)
    a[-1] = rng.integers(0, spec.q_limbs[-1], size=n, dtype=np.uint32)
    for j, v in enumerate((0, 1, spec.q - 1, spec.q - 2)[:n]):
        a[:, j] = spec.limbs(v)
    return fp.planes(a, dev)


SPECS = {"fp": lambda: bn128().fp_spec, "fr": lambda: bn128().fr_spec,
         "bls_fq": lambda: bls12381().fp_spec,
         "bls_fr": lambda: bls12381().fr_spec,
         "mnt_fq": lambda: mnt6753().fp_spec}


@pytest.mark.parametrize("which", ["fp", "fr", "bls_fq", "bls_fr", "mnt_fq"])
def test_field_kernels_match_plain(dev, which):
    spec = SPECS[which]()
    x, y = _rand(spec, 4099, 1, dev), _rand(spec, 4099, 2, dev)
    for k, p in ((fp.mont_mul, fp.mont_mul_plain),
                 (fp.mod_add, fp.mod_add_plain),
                 (fp.mod_sub, fp.mod_sub_plain)):
        assert torch.equal(k(spec, x, y), p(spec, x, y)), k.__name__
    tw = _rand(spec, 1024, 3, dev)
    if spec.n_limbs == 16:
        assert torch.equal(ntt.butterfly(spec, x[:, :4096], tw),
                           ntt.butterfly_plain(spec, x[:, :4096], tw))
    else:                       # K3 has no 12- or 24-word build
        with pytest.raises(RuntimeError, match="CUDA error"):
            ntt.butterfly(spec, x[:, :4096], tw)
    f = torch.arange(4099, device=dev) % 3 == 0
    assert torch.equal(towers.mod_cneg(spec, f, x),
                       towers.mod_cneg_plain(spec, f, x))


@pytest.mark.parametrize("which", ["fr", "bls_fr"])
@pytest.mark.parametrize("bits", [1, 5, 10, 11, 16, 17])
def test_ntt_transform_kernel_match_plain(dev, which, bits):
    """K3's transform kernel over the curve's Fr: NTTDevice.fft and ifft
    with the plain and the odd-coset twiddles (ntt_passes: one pass up to
    2^10, two above), and the passes of a split in halves and in thirds
    with and without the gather and the mirror-and-scale epilogue, against
    ntt_pass_plain over all stages, bit for bit."""
    from wasmsnark_tpu_torch.models import curve_module
    m = curve_module("bn128" if which == "fr" else "bls12381")
    spec = SPECS[which]()
    nd = ntt.NTTDevice(m.ntt_spec, fp.FpDevice(spec, dev))
    x = _rand(spec, 1 << bits, 30 + bits, dev)
    a, b = bits // 3, 2 * bits // 3
    for odd in (False, True):
        p = nd.plan(bits, odd, inverse=True)
        tw, invn = p["tw"], p["invn"]
        assert torch.equal(nd.fft(x, odd), ntt.ntt_pass_plain(
            spec, x, tw, 0, bits, True))
        assert torch.equal(nd.ifft(x, odd), ntt.ntt_pass_plain(
            spec, x, tw, 0, bits, True, invn))
        for split in ([(0, bits // 2), (bits // 2, bits)],
                      [(0, a), (a, b), (b, bits)]):
            for gather in (False, True):
                for mirror in (False, True):
                    cur = x
                    for k, (s0, s1) in enumerate(split):
                        cur = ntt.ntt_pass(
                            spec, cur, tw, s0, s1, gather and k == 0,
                            invn if mirror and k == len(split) - 1
                            else None)
                    assert torch.equal(cur, ntt.ntt_pass_plain(
                        spec, x, tw, 0, bits, gather,
                        invn if mirror else None)), (odd, split, gather,
                                                     mirror)


def test_ntt_round_trip_2_21(dev):
    """ifft(fft(x)) == x at 2^21 points over BN128's Fr (the JAX package's
    tests/test_scale.py at the port): three K3 launches each way."""
    m = bn128()
    nd = ntt.NTTDevice(m.ntt_spec, fp.FpDevice(m.fr_spec, dev))
    x = _rand(m.fr_spec, 1 << 21, 40, dev)
    cuda_lib.reset_launches()
    assert torch.equal(nd.ifft(nd.fft(x)), x)
    assert cuda_lib.fn_launches["k3_ntt_pass"] == 6


@pytest.mark.parametrize("n", [255, 256, 510])
def test_k1_k2_24_words_at_path_lanes(dev, n):
    """K1 and K2 over MNT6753's Fq at the lane counts of its verify batch:
    K1's team product (below its switch) and K2's spread blocks, with the
    edge values and squares on the first lanes."""
    spec = SPECS["mnt_fq"]()
    x, y = _rand(spec, n, 20, dev), _rand(spec, n, 21, dev)
    y[:, 4:8] = x[:, 4:8]
    for k, p in ((fp.mont_mul, fp.mont_mul_plain),
                 (fp.mod_add, fp.mod_add_plain),
                 (fp.mod_sub, fp.mod_sub_plain)):
        assert torch.equal(k(spec, x, y), p(spec, x, y)), k.__name__


@pytest.mark.parametrize("which", ["fp", "bls_fq"])
def test_curve_kernels_match_plain(dev, which):
    spec = SPECS[which]()
    P = tuple(_rand(spec, 999, s, dev) for s in (4, 5, 6))
    Q = tuple(_rand(spec, 999, s, dev) for s in (7, 8, 9))
    P[2][:, :10] = 0
    Q[2][:, 10:20] = 0
    for a, b in zip(curve.jac_add(spec, P, Q), curve.jac_add_plain(spec, P, Q)):
        assert torch.equal(a, b)
    for a, b in zip(curve.jac_madd(spec, P, Q[:2]),
                    curve.jac_madd_plain(spec, P, Q[:2])):
        assert torch.equal(a, b)
    for a, b in zip(curve.jac_double(spec, P), curve.jac_double_plain(spec, P)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["fp", "bls_fq"])
@pytest.mark.parametrize("n", [4, 68, 557_056, 1_114_112, 2_228_156])
def test_k6_at_path_lanes(dev, which, n):
    """K6 at 8 and 12 words at the lane counts of the prove's MSM (the
    window fold's 4, the triangle and halving steps' 68 x 2^k and the
    triangle's first step, 2,228,156), against jac_add_plain: random
    operands with the edge values on lanes 0-3 of every plane (lane 0 is
    all-zero on both sides), P = Q on lanes 1 and 40 (Q copied from P),
    P = -Q on lanes 2-3, P = 0 on lane 41, Q = 0 on lane 42 and both
    all-zero on lane 43, where the lanes exist."""
    spec = SPECS[which]()
    P = tuple(_rand(spec, n, s, dev) for s in (4, 5, 6))
    Q = tuple(_rand(spec, n, s, dev) for s in (7, 8, 9))
    for k in [k for k in (0, 1, 40) if k < n]:
        for p, q in zip(P, Q):
            q[:, k] = p[:, k]
    Q[0][:, 2:4], Q[2][:, 2:4] = P[0][:, 2:4], P[2][:, 2:4]
    Q[1][:, 2:4] = fp.mod_sub_plain(spec, torch.zeros_like(P[1][:, 2:4]),
                                    P[1][:, 2:4])
    if n > 43:
        P[2][:, 41] = 0
        Q[2][:, 42] = 0
        for c in (*P, *Q):
            c[:, 43] = 0
    _assert_equal(curve.jac_add(spec, P, Q), curve.jac_add_plain(spec, P, Q))


@pytest.mark.parametrize("which", ["fp", "bls_fq"])
@pytest.mark.parametrize("n", [1, 999, 1 << 16, 2_388_711])
def test_k5_on_promoted_points(dev, which, n):
    """K5 at 8 and 12 words on P promoted from affine values (Z1 =
    Montgomery one, as the prove's bucket scan gives it), against
    jac_madd_plain: random operands with P = Q on lanes 0 and 40, P = -Q
    on lanes 1-2, P zero ((0, one, 0)) on lane 41, Q the affine zero on
    lane 42 and both on lane 43, where the lanes exist."""
    spec = SPECS[which]()
    x1, y1, x2, y2 = (_rand(spec, n, s, dev) for s in (30, 31, 32, 33))
    one = fp.planes(np.array([spec.limbs(spec.one_mont)],
                             dtype=np.uint32).T, dev)
    z1 = one.expand(-1, n).contiguous()
    for k in [k for k in (0, 40) if k < n]:
        x2[:, k], y2[:, k] = x1[:, k], y1[:, k]
    x2[:, 1:3] = x1[:, 1:3]
    y2[:, 1:3] = fp.mod_sub_plain(spec, torch.zeros_like(y1[:, 1:3]),
                                  y1[:, 1:3])
    if n > 43:
        x1[:, 41], y1[:, 41], z1[:, 41] = 0, one[:, 0], 0
        x2[:, 42:44], y2[:, 42:44] = 0, 0
        x1[:, 43], y1[:, 43], z1[:, 43] = 0, one[:, 0], 0
    P, Qa = (x1, y1, z1), (x2, y2)
    _assert_equal(curve.jac_madd(spec, P, Qa),
                  curve.jac_madd_plain(spec, P, Qa))


@pytest.mark.parametrize("which", ["fp", "bls_fq"])
@pytest.mark.parametrize("n,times", [(4, 16), (4, 1), (999, 2),
                                     (1 << 16, 1)])
def test_k7_doubles_times_in_one_launch(dev, which, n, times):
    """K7 at 8 and 12 words, `times` doublings in one launch, against
    jac_double_plain: random operands with Z = 0 on lane 0 (left as it
    is) and Y = 0 on lane 1 (zero after one doubling, then left as it
    is); one launch a call."""
    spec = SPECS[which]()
    P = tuple(_rand(spec, n, s, dev) for s in (34, 35, 36))
    P[2][:, 0] = 0
    if n > 1:
        P[1][:, 1] = 0
    cuda_lib.reset_launches()
    got = curve.jac_double(spec, P, times)
    assert cuda_lib.fn_launches["k7_jac_dbl"] == 1
    _assert_equal(got, curve.jac_double_plain(spec, P, times))


def _flat(t):
    return [t] if isinstance(t, torch.Tensor) else [p for c in t
                                                    for p in _flat(c)]


def _assert_equal(a, b):
    for x, y in zip(_flat(a), _flat(b), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("which", ["fp", "bls_fq"])
@pytest.mark.parametrize("n", [777, 1024, 2048, 4096])
def test_tower_kernels_match_plain(dev, which, n):
    """K8-K11 at 8 and 12 words, at the verify and pairing batches' lane
    counts (1,024 and their prepared ladder's 2,048 and 4,096) and a ragged
    count, with Z = 0 lanes."""
    spec = SPECS[which]()
    xi = tk.XI if which == "fp" else tk.XI_BLS
    a = tk.unflatten12([_rand(spec, n, s, dev) for s in range(10, 22)])
    b = tk.unflatten12([_rand(spec, n, s, dev) for s in range(22, 34)])
    _assert_equal(tk.f12_mul(spec, a, b, xi),
                  tk.f12_mul_plain(spec, a, b, xi))
    _assert_equal(tk.f12_sqr(spec, a, xi), tk.f12_sqr_plain(spec, a, xi))
    _assert_equal(tk.f12_cyc_sqr(spec, a, xi),
                  tk.f12_cyc_sqr_plain(spec, a, xi))
    X, Y, Z, q2 = [(_rand(spec, n, s, dev), _rand(spec, n, s + 1, dev))
                   for s in (40, 42, 44, 46)]
    xP, yP = _rand(spec, n, 48, dev), _rand(spec, n, 49, dev)
    Z[0][:, 5:9] = 0
    Z[1][:, 5:9] = 0
    if which == "fp":
        _assert_equal(tk.miller_dbl(spec, X, Y, Z, xP, yP),
                      tk.miller_dbl_plain(spec, X, Y, Z, xP, yP))
        _assert_equal(tk.miller_add(spec, X, Y, Z, q2, X, xP, yP),
                      tk.miller_add_plain(spec, X, Y, Z, q2, X, xP, yP))
        return
    _assert_equal(tk.miller_dbl_mtwist(spec, X, Y, Z, xP, yP, xi),
                  tk.miller_dbl_mtwist_plain(spec, X, Y, Z, xP, yP, xi))
    _assert_equal(tk.miller_add_mtwist(spec, X, Y, Z, q2, X, xP, yP, xi),
                  tk.miller_add_mtwist_plain(spec, X, Y, Z, q2, X, xP, yP,
                                             xi))
    with pytest.raises(RuntimeError, match="CUDA error"):
        tk.miller_dbl(spec, X, Y, Z, xP, yP)       # K10 has no 12-word build


@pytest.mark.parametrize("n", [1, 255, 256, 512, 1280, 1 << 16])
def test_mnt_team_kernels_match_plain(dev, n):
    """The MNT6753 team kernels, K12's F6 product and square, K13's
    cyclotomic square and K14's doubling and mixed add, at the lane counts
    of the MNT6753 paths (255, 256, 512, 1,280), one lane and 2^16, with
    Z = 0 lanes; one lane takes a random lane, not an edge value."""
    spec = SPECS["mnt_fq"]()
    m = max(n, 64)
    lo = 0 if n >= 12 else m - n

    def rand(seed):
        return _rand(spec, m, seed, dev)[:, lo:lo + n].contiguous()

    a = tk.unflatten6([rand(s) for s in range(50, 56)])
    b = tk.unflatten6([rand(s) for s in range(56, 62)])
    _assert_equal(tk.mnt_f6_mul(spec, a, b), tk.mnt_f6_mul_plain(spec, a, b))
    _assert_equal(tk.mnt_f6_sqr(spec, a), tk.mnt_f6_sqr_plain(spec, a))
    _assert_equal(tk.mnt_f6_cyc_sqr(spec, a),
                  tk.mnt_f6_cyc_sqr_plain(spec, a))
    X, Y, Z, x2, y2 = [tuple(rand(s + j) for j in range(3))
                       for s in (70, 73, 76, 79, 82)]
    xP, yP = rand(85), rand(86)
    for c in Z:
        c[:, 5:9] = 0
    _assert_equal(tk.mnt_miller_dbl(spec, X, Y, Z, xP, yP),
                  tk.mnt_miller_dbl_plain(spec, X, Y, Z, xP, yP))
    _assert_equal(tk.mnt_miller_add(spec, X, Y, Z, x2, y2, xP, yP),
                  tk.mnt_miller_add_plain(spec, X, Y, Z, x2, y2, xP, yP))


@pytest.mark.parametrize("which", ["fp", "bls_fq"])
@pytest.mark.parametrize("n", [1, 1000, 1024, 1 << 16])
def test_k9_team_kernel_match_plain(dev, which, n):
    """K9's team kernel at 8 and 12 words, at the pairing batches' 1,024
    lanes, a ragged count, one lane and 2^16; and K8's product, a team
    kernel too, there."""
    spec = SPECS[which]()
    xi = tk.XI if which == "fp" else tk.XI_BLS
    m = max(n, 64)
    lo = 0 if n >= 12 else m - n
    a, b = [tk.unflatten12([_rand(spec, m, s, dev)[:, lo:lo + n].contiguous()
                            for s in range(s0, s0 + 12)]) for s0 in (20, 32)]
    _assert_equal(tk.f12_cyc_sqr(spec, a, xi),
                  tk.f12_cyc_sqr_plain(spec, a, xi))
    _assert_equal(tk.f12_mul(spec, a, b, xi),
                  tk.f12_mul_plain(spec, a, b, xi))


@pytest.mark.parametrize("which", ["fp", "bls_fq"])
@pytest.mark.parametrize("n", [1, 1024, 4096, 1 << 16])
def test_k8_sqr_and_miller_dbl_team_kernels_match_plain(dev, which, n):
    """K8's square and the Miller doubling (K10's D twist at 8 words, K11's
    M twist at 12) as team kernels at the verify and pairing batches' 1,024
    and 4,096 lanes, at 2^16 and on one lane, with Z = 0 lanes and Y = 0
    lanes; one lane takes a random lane, not an edge value."""
    spec = SPECS[which]()
    xi = tk.XI if which == "fp" else tk.XI_BLS
    m = max(n, 64)
    lo = 0 if n >= 12 else m - n

    def rand(seed):
        return _rand(spec, m, seed, dev)[:, lo:lo + n].contiguous()

    a = tk.unflatten12([rand(s) for s in range(90, 102)])
    _assert_equal(tk.f12_sqr(spec, a, xi), tk.f12_sqr_plain(spec, a, xi))
    X, Y, Z = [(rand(s), rand(s + 1)) for s in (110, 112, 114)]
    xP, yP = rand(116), rand(117)
    for c in Z:
        c[:, 5:9] = 0
    for c in Y:
        c[:, 9:13] = 0
    if which == "fp":
        _assert_equal(tk.miller_dbl(spec, X, Y, Z, xP, yP),
                      tk.miller_dbl_plain(spec, X, Y, Z, xP, yP))
    else:
        _assert_equal(tk.miller_dbl_mtwist(spec, X, Y, Z, xP, yP, xi),
                      tk.miller_dbl_mtwist_plain(spec, X, Y, Z, xP, yP, xi))


@pytest.mark.parametrize("which", ["fp", "bls_fq"])
@pytest.mark.parametrize("n", [1, 1024, 4096, 1 << 16])
def test_miller_add_team_kernel_matches_plain(dev, which, n):
    """The Miller add (K10's D twist at 8 words, K11's M twist at 12) as a
    team kernel at the pairing batch's 1,024 lanes, at 4,096, at 2^16 and
    on one lane (a random one): the edge values on lanes 0..3, Z = 0 on
    4..7, x2 = X/Z (lambda = 0) on 8..11, y2 = Y/Z (theta = 0) on 12..15
    and both (Q equal to the current point) on 16..19."""
    m = bn128() if which == "fp" else bls12381()
    spec = m.fp_spec
    xi = tk.XI if which == "fp" else tk.XI_BLS
    big = max(n, 64)
    X, Y, Z, x2, y2 = [(_rand(spec, big, s, "cpu"), _rand(spec, big, s + 1,
                                                           "cpu"))
                       for s in range(130, 140, 2)]
    xP, yP = _rand(spec, big, 140, "cpu"), _rand(spec, big, 141, "cpu")
    for c in Z:
        c[:, 4:8] = 0

    def vals(p, sl):
        return [spec.from_mont(v)
                for v in limbs_to_ints(fp.to_numpy(p[:, sl]))]

    for (U, V), lo in (((X, x2), 8), ((Y, y2), 12), ((X, x2), 16),
                       ((Y, y2), 16)):
        sl = slice(lo, lo + 4)
        uz = [m.F2.mul((u0, u1), m.F2.inv((z0, z1))) for u0, u1, z0, z1 in
              zip(*(vals(p, sl) for p in (*U, *Z)))]
        for k, c in enumerate(V):
            c[:, sl] = fp.planes(ints_to_limbs_fast(
                [spec.to_mont(v[k]) for v in uz], spec.n_limbs), "cpu")
    lo = 0 if n >= 20 else big - n
    X, Y, Z, x2, y2, xP, yP = tuple(
        tuple(c[:, lo:lo + n].contiguous().to(dev) for c in v)
        if isinstance(v, tuple) else v[:, lo:lo + n].contiguous().to(dev)
        for v in (X, Y, Z, x2, y2, xP, yP))
    if which == "fp":
        _assert_equal(tk.miller_add(spec, X, Y, Z, x2, y2, xP, yP),
                      tk.miller_add_plain(spec, X, Y, Z, x2, y2, xP, yP))
    else:
        _assert_equal(
            tk.miller_add_mtwist(spec, X, Y, Z, x2, y2, xP, yP, xi),
            tk.miller_add_mtwist_plain(spec, X, Y, Z, x2, y2, xP, yP, xi))


def test_mnt_kernels_match_plain(dev):
    """K12-K14 at 24 words, with Z = 0 lanes; the 8/12-word tower kernels
    have no 24-word build and are refused before any launch."""
    spec = SPECS["mnt_fq"]()
    n = 333
    a = tk.unflatten6([_rand(spec, n, s, dev) for s in range(50, 56)])
    b = tk.unflatten6([_rand(spec, n, s, dev) for s in range(56, 62)])
    _assert_equal(tk.mnt_f6_mul(spec, a, b), tk.mnt_f6_mul_plain(spec, a, b))
    _assert_equal(tk.mnt_f6_sqr(spec, a), tk.mnt_f6_sqr_plain(spec, a))
    _assert_equal(tk.mnt_f6_cyc_sqr(spec, a),
                  tk.mnt_f6_cyc_sqr_plain(spec, a))
    X, Y, Z, x2, y2 = [tuple(_rand(spec, n, s + j, dev) for j in range(3))
                       for s in (70, 73, 76, 79, 82)]
    xP, yP = _rand(spec, n, 85, dev), _rand(spec, n, 86, dev)
    for c in Z:
        c[:, 5:9] = 0
    _assert_equal(tk.mnt_miller_dbl(spec, X, Y, Z, xP, yP),
                  tk.mnt_miller_dbl_plain(spec, X, Y, Z, xP, yP))
    _assert_equal(tk.mnt_miller_add(spec, X, Y, Z, x2, y2, xP, yP),
                  tk.mnt_miller_add_plain(spec, X, Y, Z, x2, y2, xP, yP))
    f12 = tk.unflatten12([a[0][0]] * 12)
    with pytest.raises(RuntimeError, match="no kernel build for 48 limbs"):
        tk.f12_mul(spec, f12, f12)


def _points_on(m, n, seed, dev):
    """n Jacobian G1 points k G with Z = 1 (lane 0 zero) and n scalars below
    r (lane 1 zero, lane 2 r - 1), on `dev` and on the CPU."""
    rng = np.random.default_rng(seed)
    r = m.fr_spec.q
    G = m.G1
    pts = [None] + [G.affine(G.times_scalar(m.g1_gen, int(k)))[:2]
                    for k in rng.integers(1, 1 << 62, size=n - 1)]
    ks = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)]
    ks[1], ks[2] = 0, r - 1
    spec = m.fp_spec
    cols = ([0 if p is None else spec.to_mont(p[0]) for p in pts],
            [spec.one_mont if p is None else spec.to_mont(p[1]) for p in pts],
            [0 if p is None else spec.one_mont for p in pts])
    P = tuple(fp.planes(ints_to_limbs_fast(c, spec.n_limbs), dev)
              for c in cols)
    return P, ints_to_limbs_fast(ks, m.fr_spec.n_limbs)


@pytest.mark.parametrize("which", ["fp", "bls_fq"])
def test_scalar_ladders_match_cpu(dev, which):
    """times_scalar_signed_device (K4, K6, K7 on the card) and
    times_scalar_device on 64 lanes of G1, and tree_reduce of them, bit for
    bit against the same ladders' plain versions on the CPU."""
    from wasmsnark_tpu_torch.ops import msm
    m = bn128() if which == "fp" else bls12381()
    P, S = _points_on(m, 64, 90, dev)
    out = {}
    for where in (dev, torch.device("cpu")):
        G = curve.JacobianDevice(towers.FpAdapter(fp.FpDevice(m.fp_spec,
                                                              where)))
        Pw = tuple(c.to(where) for c in P)
        s = msm.times_scalar_signed_device(G, Pw, S, 4)
        out[where.type] = (s, fp.times_scalar_device(G, Pw, S),
                           G.tree_reduce(s, 64))
    for a, b in zip(out["cuda"], out["cpu"]):
        _assert_equal(tuple(c.cpu() for c in a), b)


def test_fp_dynamic_and_complete_law_match_cpu(dev):
    """FpDynamic.exp on 4,099 lanes of BN128 Fq with 254-bit exponents, and
    CompleteCurveDevice's add over BN128 G1 on the same lanes' points,
    bit for bit against the CPU."""
    from wasmsnark_tpu_torch.ops.curve_complete import CompleteCurveDevice
    spec = SPECS["fp"]()
    n = 4099
    x, e = _rand(spec, n, 91, dev), _rand(spec, n, 92, dev)
    P = tuple(_rand(spec, n, 93 + j, dev) for j in range(3))
    Q = tuple(_rand(spec, n, 96 + j, dev) for j in range(3))
    out = {}
    for where in (dev, torch.device("cpu")):
        F = fp.FpDevice(spec, where)
        base = towers.FpAdapter(F)
        C = CompleteCurveDevice(base, lambda a: base.mul_small(a, 9))
        mv = [t.to(where) for t in (x, e)]
        out[where.type] = (fp.FpDynamic(F).exp(mv[0], mv[1], 254),
                           C.add(tuple(c.to(where) for c in P),
                                 tuple(c.to(where) for c in Q)))
    _assert_equal(tuple(c.cpu() for c in (out["cuda"][0], *out["cuda"][1])),
                  (out["cpu"][0], *out["cpu"][1]))


def test_f1_runtime_builds_4_words_at_first_use(dev):
    """build_f1(2^127 - 1) on the card: fp_kernels at 4 words is built at
    its first launch, and every method matches Python ints."""
    import wasmsnark_tpu_torch
    q = (1 << 127) - 1
    rt = wasmsnark_tpu_torch.build_f1(q)
    xs = [0, 1, q - 1, q - 2] + [(k * 0x9E3779B97F4A7C15) % q
                                 for k in range(1, 60)]
    ys = list(reversed(xs))
    assert rt.mul(xs, ys) == [a * b % q for a, b in zip(xs, ys)]
    assert "fp_kernels_w4" in cuda_lib._libs
    assert rt.square(xs) == [a * a % q for a in xs]
    assert rt.add(xs, ys) == [(a + b) % q for a, b in zip(xs, ys)]
    assert rt.sub(xs, ys) == [(a - b) % q for a, b in zip(xs, ys)]
    assert rt.inverse(xs) == [pow(a, -1, q) if a else 0 for a in xs]
    assert rt.inverse_gcd(xs) == [pow(a, -1, q) if a else 0 for a in xs]


@pytest.mark.parametrize("curve_name", ["bn128", "bls12381", "mnt6753"])
def test_final_exponentiation_scan_on_card(dev, curve_name):
    """final_exponentiation_scan over the full exponent (K8 or K12) equals
    final_exponentiation on 4 lanes of Miller-loop values."""
    from wasmsnark_tpu_torch.ops.pairing import pairing_device
    pd = pairing_device(curve_name)
    m = pd.m
    g1 = pd.pack_g1([m.G1.affine(m.G1.times_scalar(m.g1_gen, k))[:2]
                     for k in (2, 3, 5, 7)])
    g2 = pd.pack_g2([m.G2.affine(m.g2_gen)[:2]] * 4)
    f = pd.miller_loop(g1, g2)
    _assert_equal(pd.final_exponentiation_scan(f),
                  pd.final_exponentiation(f))
