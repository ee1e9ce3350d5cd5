"""The CUDA kernels K1-K14 against their plain versions on the card: K1-K10
at BN128's 8 words, K1-K3 over BLS12-381's Fr (8 words), K1, K2, K4-K9
and K11 over BLS12-381's Fq (12 words), and K1, K2, K4 and K12-K14 over
MNT6753's Fq (24 words); the team kernels of K8's product and square, K9,
the Miller doubling of K10 and K11 and K12-K14, K1 and K2 at 24 words and
K6 at 8 and 12, also at the lane counts of their paths; K5 on promoted
affine points, as the prove gives it, and K7 with several doublings a
launch.

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
