"""Port parity: the Jacobian group law (K5-K7 plain versions, G2 composed
over F2Device) and the MSM of wasmsnark_tpu_torch, against the bigint
oracle and the JAX package's MSMDevice on the CPU.

Jacobian outputs are not unique (they depend on the summation order), so
points are compared after affine normalization.
"""

import random

import jax
import numpy as np
import pytest
import torch

from wasmsnark_tpu.models.bn128 import bn128, R
from wasmsnark_tpu.ops.curve import JacobianDevice as JJac
from wasmsnark_tpu.ops.fp import FpDevice as JFp
from wasmsnark_tpu.ops.msm import MSMDevice as JMSM
from wasmsnark_tpu.ops.towers import FpAdapter as JAd
from wasmsnark_tpu.utils.serialize import ints_to_limbs

from wasmsnark_tpu_torch.ops import fp as tfp
from wasmsnark_tpu_torch.ops.curve import JacobianDevice, host_points, map_leaf
from wasmsnark_tpu_torch.ops.msm import (MSMDevice, fold_windows,
                                         fold_windows_device)
from wasmsnark_tpu_torch.ops.towers import FpAdapter, F2Device

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
m = bn128()
Fp = tfp.FpDevice(m.fp_spec, CPU)
A1 = FpAdapter(Fp)
G1d = JacobianDevice(A1)
G2d = JacobianDevice(F2Device(A1, A1.neg))
JA1 = JAd(JFp(m.fp_spec))
JG1 = JJac(JA1)


def pack(vals):
    return Fp.pack_mont(vals)


def pack_g1(points):
    return tuple(pack([p[i] for p in points]) for i in range(3))


def pack_g1_affine(points):
    aff = [(0, 0) if m.G1.is_zero(p) else m.G1.affine(p)[:2] for p in points]
    return pack([a[0] for a in aff]), pack([a[1] for a in aff])


def pack_g2(points):
    return tuple((pack([p[i][0] for p in points]),
                  pack([p[i][1] for p in points])) for i in range(3))


def pack_g2_affine(points):
    aff = [((0, 0), (0, 0)) if m.G2.is_zero(p) else m.G2.affine(p)[:2]
           for p in points]
    return tuple((pack([a[i][0] for a in aff]), pack([a[i][1] for a in aff]))
                 for i in range(2))


def unpack_g1(p):
    return list(zip(*(Fp.unpack_mont(c.reshape(c.shape[0], -1)) for c in p)))


def unpack_g2(p):
    comps = [(Fp.unpack_mont(c[0].reshape(c[0].shape[0], -1)),
              Fp.unpack_mont(c[1].reshape(c[1].shape[0], -1))) for c in p]
    return [tuple((comps[i][0][j], comps[i][1][j]) for i in range(3))
            for j in range(len(comps[0][0]))]


def same(curve, a, b):
    if curve.is_zero(a):
        return curve.is_zero(b)
    return not curve.is_zero(b) and curve.eq(a, b)


def rand_g1(rnd, k):
    return [m.G1.times_scalar(m.g1_gen, rnd.randrange(1, R)) for _ in range(k)]


def test_g1_complete_add_and_double_degeneracies():
    rnd = random.Random(3)
    pts = rand_g1(rnd, 4)
    z = m.G1.zero()
    P = [pts[0], pts[1], pts[2], pts[2], z, pts[3], z]
    Q = [pts[1], pts[0], pts[2], m.G1.neg(pts[2]), pts[3], z, z]
    got = unpack_g1(G1d.add(pack_g1(P), pack_g1(Q)))
    for i, (p, q) in enumerate(zip(P, Q)):
        assert same(m.G1, m.G1.add(p, q), got[i]), i
    gotd = unpack_g1(G1d.double(pack_g1(P)))
    for i, p in enumerate(P):
        assert same(m.G1, m.G1.double(p), gotd[i]), i
    # the JAX package's jnp add on the same planes, bit for bit where
    # the complete law's zero is canonical
    jp = tuple(np.asarray(tfp.to_numpy(c)) for c in pack_g1(P))
    jq = tuple(np.asarray(tfp.to_numpy(c)) for c in pack_g1(Q))
    want = jax.jit(JG1.add)(jp, jq)
    for g, w in zip(G1d.add(pack_g1(P), pack_g1(Q)), want):
        np.testing.assert_array_equal(tfp.to_numpy(g), np.asarray(w))


def test_g1_madd_degeneracies():
    rnd = random.Random(17)
    pts = rand_g1(rnd, 3)
    z = m.G1.zero()
    P = [pts[0], pts[1], pts[1], pts[2], z, z]
    Qo = [pts[1], pts[1], m.G1.neg(pts[1]), z, pts[0], z]
    got = unpack_g1(G1d.madd(pack_g1(P), pack_g1_affine(Qo)))
    for i, (p, q) in enumerate(zip(P, Qo)):
        assert same(m.G1, m.G1.add(p, q), got[i]), i


def test_g2_complete_add():
    rnd = random.Random(4)
    pts = [m.G2.times_scalar(m.g2_gen, rnd.randrange(1, R)) for _ in range(3)]
    z = m.G2.zero()
    P = [pts[0], pts[1], pts[1], z]
    Q = [pts[1], pts[1], m.G2.neg(pts[1]), pts[2]]
    got = unpack_g2(G2d.add(pack_g2(P), pack_g2(Q)))
    for i, (p, q) in enumerate(zip(P, Q)):
        assert same(m.G2, m.G2.add(p, q), got[i]), i


def _jax_windows(msm, S, P):
    win = jax.jit(msm.msm)(S, P)
    return map_leaf(win, lambda a: np.asarray(a))


def _adversarial_g1(seed, n):
    rnd = random.Random(seed)
    pts = [m.G1.affine(p) for p in rand_g1(rnd, n - 4)]
    pts += [pts[0], pts[0], m.G1.zero(), m.G1.neg(pts[1])]
    scalars = [rnd.randrange(R) for _ in range(n - 3)] + [0, 2 ** 256 - 1, 7]
    return pts, scalars


@pytest.mark.parametrize("window_bits", [4, 8])
def test_g1_msm_vs_oracle_and_jax(window_bits):
    """Repeats, a zero point, an inverse pair, a zero scalar and an
    unreduced 256-bit scalar (the pattern of tests/test_curve_msm.py);
    every window sum equals the JAX package's, and the fold the oracle's."""
    pts, scalars = _adversarial_g1(9, 32)
    S = ints_to_limbs(scalars, 16)
    P = pack_g1_affine(pts)
    msm = MSMDevice(G1d, window_bits=window_bits)
    win = unpack_g1(msm.msm(tfp.planes(S, CPU), P))
    jwin = _jax_windows(JMSM(JG1, window_bits=window_bits), S,
                        tuple(tfp.to_numpy(c) for c in P))
    jw = unpack_g1(tuple(tfp.planes(c, CPU) for c in jwin))
    assert len(win) == len(jw)
    for a, b in zip(win, jw):
        assert same(m.G1, a, b)
    assert same(m.G1, m.G1.msm(pts, scalars),
                fold_windows(m.G1, win, window_bits))


def test_g2_msm_vs_oracle():
    rnd = random.Random(13)
    n = 16
    pts = [m.G2.times_scalar(m.g2_gen, rnd.randrange(1, R))
           for _ in range(n - 1)] + [m.G2.zero()]
    scalars = [rnd.randrange(R) for _ in range(n - 1)] + [0]
    S = tfp.planes(ints_to_limbs(scalars, 16), CPU)
    msm = MSMDevice(G2d, window_bits=8)
    got = unpack_g2(tuple(map_leaf(c, lambda a: a[..., None])
                          for c in msm.msm_point(S, pack_g2_affine(pts))))[0]
    assert same(m.G2, m.G2.msm(pts, scalars), got)


def test_batched_msm_point_and_256_points():
    """Two MSMs in one batch (the prover's stacked G1 sections), one of
    them zero-padded, over 2^8 tiled points, folded on the device."""
    rnd = random.Random(31)
    n = 256
    ks = [rnd.randrange(1, R) for _ in range(16)]
    base = [m.G1.affine(m.G1.times_scalar(m.g1_gen, k)) for k in ks]
    pts = [base[i % 16] for i in range(n)]
    sc0 = [rnd.randrange(R) for _ in range(n)]
    sc1 = [rnd.randrange(R) for _ in range(n // 2)] + [0] * (n // 2)
    S = torch.stack([tfp.planes(ints_to_limbs(s, 16), CPU)
                     for s in (sc0, sc1)], dim=1)
    P0 = pack_g1_affine(pts)
    P = tuple(torch.stack([c, c], dim=1) for c in P0)
    out = MSMDevice(G1d, window_bits=8).msm_point(S, P)
    got = unpack_g1(out)
    for k, sc in enumerate((sc0, sc1)):
        e = sum(s * ks[i % 16] for i, s in enumerate(sc)) % R
        assert same(m.G1, m.G1.times_scalar(m.g1_gen, e), got[k]), k


def test_fold_windows_device_matches_host():
    rnd = random.Random(12)
    wins = rand_g1(rnd, 5) + [m.G1.zero()]
    got = unpack_g1(tuple(c[:, None] for c in fold_windows_device(
        G1d, pack_g1(wins), 4)))[0]
    assert same(m.G1, fold_windows(m.G1, wins, 4), got)


@pytest.mark.parametrize("window_bits", [3, 16])
def test_fold_windows_device_double_times_vs_jax(window_bits, monkeypatch):
    """The port's window fold, whose `window_bits` doublings a window are
    one double_times call (K7's plain version on the CPU), against the JAX
    package's fold_windows_device (a fori_loop of doublings) after affine
    normalisation, and against the host fold; windows include the zero
    point."""
    from wasmsnark_tpu.ops.msm import fold_windows_device as jfold
    from wasmsnark_tpu_torch.ops import curve as curve_mod
    rnd = random.Random(41)
    wins = rand_g1(rnd, 3) + [m.G1.zero()] + rand_g1(rnd, 2)
    calls = []
    dbl = curve_mod.jac_double

    def jac_double(spec, p, times=1):
        calls.append(times)
        return dbl(spec, p, times)

    monkeypatch.setattr(curve_mod, "jac_double", jac_double)
    got = unpack_g1(tuple(c[:, None] for c in fold_windows_device(
        G1d, pack_g1(wins), window_bits)))[0]
    assert calls == [window_bits] * (len(wins) - 1)
    jw = tuple(np.asarray(tfp.to_numpy(c)) for c in pack_g1(wins))
    want = jax.jit(lambda w: jfold(JG1, w, window_bits))(jw)
    jgot = unpack_g1(tuple(tfp.planes(np.asarray(c)[:, None], CPU)
                           for c in want))[0]
    assert same(m.G1, got, jgot)
    assert same(m.G1, fold_windows(m.G1, wins, window_bits), got)


@pytest.mark.parametrize("n", [1, 3, 5, 6, 8])
def test_reduce_last_any_length_vs_jax(n):
    """reduce_last sums an axis of any length (one not a power of two is
    padded with zero points), as the JAX package's reduce_last does, over
    BN128 G1 with a zero point among the inputs, compared affine; at 8
    points the halving is unchanged: three launches of the add."""
    from wasmsnark_tpu.ops.scan import reduce_last as jreduce
    from wasmsnark_tpu_torch.ops import curve as curve_mod
    from wasmsnark_tpu_torch.ops.scan import reduce_last
    rnd = random.Random(50 + n)
    pts = rand_g1(rnd, n)
    if n > 2:
        pts[1] = m.G1.zero()
    calls = []
    add = curve_mod.jac_add

    def jac_add(spec, p, q):
        calls.append(p[0].shape[-1])
        return add(spec, p, q)

    P = pack_g1(pts)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(curve_mod, "jac_add", jac_add)
        got = unpack_g1(reduce_last(G1d, P))
    assert len(got) == 1
    assert calls == [2 ** k for k in range((n - 1).bit_length() - 1, -1, -1)]
    jp = tuple(np.asarray(tfp.to_numpy(c)) for c in P)
    want = jax.jit(lambda v: jreduce(JG1, v))(jp)
    jgot = unpack_g1(tuple(tfp.planes(np.asarray(c), CPU) for c in want))
    acc = m.G1.zero()
    for p in pts:
        acc = m.G1.add(acc, p)
    assert same(m.G1, got[0], jgot[0])
    assert same(m.G1, acc, got[0])


def _jax_oracle(curve):
    """The JAX package's host module of a curve."""
    if curve == "bn128":
        return m
    from wasmsnark_tpu.models.bls12381 import bls12381
    return bls12381()


def _g2_scalars(case, c, r, rnd, n):
    if case == "small":
        return [rnd.randrange(1 << (2 * c)) for _ in range(n)]
    if case == "zero":
        return [0] * n
    # the largest reduced scalar, 2^255 - 1 (every digit carries, up to
    # the top window), and 2^256 - 1 (the carry window filled)
    return [rnd.randrange(r) for _ in range(n - 3)] + [
        r - 1, 2 ** 255 - 1, 2 ** 256 - 1]


@pytest.mark.parametrize("case", ["small", "zero", "carry"])
@pytest.mark.parametrize("window_bits", [4, 8])
@pytest.mark.parametrize("curve", ["bn128", "bls12381"])
def test_g2_msm_host_fold(curve, window_bits, case, monkeypatch):
    """The prover's G2 MSM (Groth16Prover._msm_g2: the window sums folded
    on the host) equals the JAX package's oracle MSM, and so do the same
    window sums folded by fold_windows over the JAX oracle's G2 and by
    fold_windows_device, compared affine: scalars under 2^(2c), whose top
    windows are zero sums; all-zero scalars, whose MSM is the zero point;
    and scalars that carry into the top window and the carry window.  The
    points hold a repeat and the zero point."""
    from wasmsnark_tpu_torch.groth16.prover import Groth16Prover
    jm = _jax_oracle(curve)
    prover = Groth16Prover(device="cpu", curve=curve,
                           msm_window_bits=window_bits)
    F, G2 = prover.Fp, prover.G2d
    rnd = random.Random(f"{curve}-{window_bits}-{case}")
    r = jm.Fr.q
    base = [jm.G2.affine(jm.G2.times_scalar(jm.g2_gen, rnd.randrange(1, r)))
            for _ in range(4)]
    pts = base + [jm.G2.zero(), base[0]]
    scalars = _g2_scalars(case, window_bits, r, rnd, len(pts))
    S = tfp.planes(ints_to_limbs(scalars, 16), CPU)
    P = tuple((F.pack_mont([p[i][0] for p in pts]),
               F.pack_mont([p[i][1] for p in pts])) for i in range(2))
    P = map_leaf(P, lambda a: a * torch.tensor(
        [not jm.G2.is_zero(p) for p in pts], dtype=a.dtype))
    sums = []
    msm = MSMDevice.msm

    def keep(self, *args):
        sums.append(msm(self, *args))
        return sums[-1]

    monkeypatch.setattr(MSMDevice, "msm", keep)
    got = prover._msm_g2(S, P)
    assert len(sums) == 1
    win = host_points(F, sums[0])
    if case == "small":
        assert all(jm.G2.is_zero(w) for w in win[3:])
    if case == "carry":
        assert not jm.G2.is_zero(win[-1])
    host = fold_windows(jm.G2, win, window_bits)
    dev = host_points(F, fold_windows_device(G2, sums[0], window_bits))
    assert len(dev) == 1
    want = jm.G2.msm(pts, scalars)
    assert jm.G2.is_zero(want) == (case == "zero")
    for p in (got, host, dev[0]):
        assert same(jm.G2, want, p)
