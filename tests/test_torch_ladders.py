"""The port's per-lane ladders (ops/fp.py FpDynamic.exp and
times_scalar_device, ops/msm.py times_scalar_signed_device) and the
Jacobian helpers neg, sub, eq and tree_reduce (ops/curve.py) on the CPU
path, against the JAX package on the same numpy-seeded inputs.

The first three cases are tests/test_fp_dynamic.py's (P61 = 2^61 - 1 and
the toy curve y^2 = x^3 + 7 over it; a zero point, a zero scalar and the
max-window digits of 0xFFFF8001).  Tolerance: field values bit-identical;
points equal after affine normalisation (a Jacobian representation is not
unique), with Z = 0 wherever the result is zero.  The signed ladder then
runs on 4 BN128 G1 lanes with full-width scalars against the port's host
oracle.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wasmsnark_tpu.fields.spec import FieldSpec as JSpec
from wasmsnark_tpu.ops import curve as jcurve, fp as jfp, msm as jmsm
from wasmsnark_tpu.ops.towers import FpAdapter as JAdapter

from wasmsnark_tpu_torch.curves.oracle import JacobianCurve
from wasmsnark_tpu_torch.fields.oracle import Fp as OracleFp
from wasmsnark_tpu_torch.fields.spec import FieldSpec
from wasmsnark_tpu_torch.models.bn128 import bn128
from wasmsnark_tpu_torch.ops import curve, fp, msm
from wasmsnark_tpu_torch.ops.towers import FpAdapter
from wasmsnark_tpu_torch.utils.serialize import ints_to_limbs

P61 = (1 << 61) - 1


def _toy():
    """(port spec, port field, port curve, JAX field, JAX curve, oracle
    curve, generator) of y^2 = x^3 + 7 over P61."""
    spec = FieldSpec(P61)
    x0 = next(c for c in range(2, 100)
              if spec.is_square((c ** 3 + 7) % spec.q))
    oc = JacobianCurve(OracleFp(spec))
    gen = oc.from_affine(x0, spec.sqrt((x0 ** 3 + 7) % spec.q))
    F = fp.FpDevice(spec, "cpu")
    JF = jfp.FpDevice(JSpec(P61))
    return (spec, F, curve.JacobianDevice(FpAdapter(F)), JF,
            jcurve.JacobianDevice(JAdapter(JF)), oc, gen)


def _pack_points(F, pts):
    return tuple(F.pack_mont([p[i] for p in pts]) for i in range(3))


def _affine(unpack_mont, oc, P):
    """Points of Jacobian planes -> oracle affine (None for zero),
    requiring Z = 0 exactly where the point is zero."""
    xs, ys, zs = (unpack_mont(np.asarray(c)) for c in P)
    out = []
    for x, y, z in zip(xs, ys, zs):
        out.append(None if z == 0 else oc.affine((x, y, z))[:2])
    return out


def _want(oc, pts, scl):
    return [None if oc.is_zero(w) else oc.affine(w)[:2]
            for w in (oc.times_scalar(p, s) for p, s in zip(pts, scl))]


def test_dynamic_exp_per_lane_against_jax():
    """test_fp_dynamic.py:44: six lanes of P61, 40-bit exponents, 0 and 1,
    48 ladder bits: bit-identical planes."""
    spec, F, _, JF, _, _, _ = _toy()
    rng = np.random.default_rng(2)
    xs = [int(v) for v in rng.integers(0, spec.q, size=6)]
    es = [int(v) for v in rng.integers(0, 1 << 40, size=4)] + [0, 1]
    e = ints_to_limbs(es, 3)
    want = np.asarray(jax.jit(lambda a, b: jfp.FpDynamic(JF).exp(a, b, 48))(
        jnp.asarray(JF.pack_mont(xs)), jnp.asarray(e)))
    got = fp.FpDynamic(F).exp(F.pack_mont(xs), e, 48)
    assert np.array_equal(fp.to_numpy(got), want)
    assert F.unpack_mont(got) == [pow(x, k, spec.q) for x, k in zip(xs, es)]


def test_times_scalar_device_against_jax():
    """test_fp_dynamic.py:58: the generator, 5 G and the zero point times
    12345, 999 and 777 over 32 ladder bits."""
    _, F, G, JF, JG, oc, gen = _toy()
    pts = [gen, oc.times_scalar(gen, 5), oc.zero()]
    scl = [12345, 999, 777]
    sc = ints_to_limbs(scl, 2)
    P = _pack_points(F, pts)
    want = jax.jit(lambda p, s: jfp.times_scalar_device(JG, p, s, 32))(
        tuple(jnp.asarray(fp.to_numpy(c)) for c in P), jnp.asarray(sc))
    got = fp.times_scalar_device(G, P, sc, 32)
    expect = _want(oc, pts, scl)
    assert _affine(JF.unpack_mont, oc, want) == expect
    assert _affine(F.unpack_mont, oc, got) == expect


def test_times_scalar_signed_device_against_jax():
    """test_fp_dynamic.py:82: the signed 4-bit window ladder with a zero
    point, a zero scalar and 0xFFFF8001 (every window's digit carries)."""
    _, F, G, JF, JG, oc, gen = _toy()
    pts = [gen, oc.times_scalar(gen, 3), oc.zero(), gen]
    scl = [0xFFFF8001, 999, 777, 0]
    sc = ints_to_limbs(scl, 2)
    P = _pack_points(F, pts)
    want = jax.jit(lambda p, s: jmsm.times_scalar_signed_device(JG, p, s, 4))(
        tuple(jnp.asarray(fp.to_numpy(c)) for c in P), jnp.asarray(sc))
    got = msm.times_scalar_signed_device(G, P, sc, 4)
    expect = _want(oc, pts, scl)
    assert _affine(JF.unpack_mont, oc, want) == expect
    assert _affine(F.unpack_mont, oc, got) == expect
    assert expect[2] is None and expect[3] is None


def test_jacobian_neg_sub_eq_tree_reduce_against_jax():
    """neg (bit-identical), sub, eq and tree_reduce over 8 lanes of the toy
    curve (two zero points, a repeated point and its negative), against
    the JAX package's methods in one jitted call (tree_reduce over rows of
    two) and the oracle (tree_reduce of all 8); eq also on another
    representation of each point (X l^2, Y l^3, Z l)."""
    spec, F, G, JF, JG, oc, gen = _toy()
    rng = np.random.default_rng(5)
    ks = [int(v) for v in rng.integers(1, 1 << 40, size=8)]
    pts = [oc.times_scalar(gen, k) for k in ks]
    pts[2] = oc.zero()
    pts[5] = oc.zero()
    pts[6] = pts[1]
    pts[7] = oc.neg(pts[3])
    qts = pts[-1:] + pts[:-1]
    P = _pack_points(F, pts)
    Q = tuple(c.roll(1, dims=1) for c in P)

    def jax_side(JP, JQ):
        pairs = tuple(c.reshape(c.shape[0], 4, 2) for c in JP)
        return (JG.neg(JP)[1], JG.sub(JP, JQ), JG.eq(JP, JQ),
                JG.tree_reduce(pairs, 2))

    jneg, jsub, jeq, jred = jax.jit(jax_side)(
        *(tuple(jnp.asarray(fp.to_numpy(c)) for c in X) for X in (P, Q)))
    assert np.array_equal(fp.to_numpy(G.neg(P)[1]), np.asarray(jneg))
    want = [None if oc.is_zero(w) else oc.affine(w)[:2]
            for w in (oc.sub(p, q) for p, q in zip(pts, qts))]
    assert _affine(F.unpack_mont, oc, G.sub(P, Q)) == want
    assert _affine(JF.unpack_mont, oc, jsub) == want
    assert _affine(F.unpack_mont, oc, G.sub(P, P)) == [None] * 8
    eq_q = G.eq(P, Q).tolist()
    assert eq_q == np.asarray(jeq).tolist()
    assert eq_q == [oc.eq(p, q) for p, q in zip(pts, qts)]
    lam = [int(v) for v in rng.integers(2, spec.q, size=8)]
    R = [(oc.F.mul(p[0], oc.F.mul(l, l)), oc.F.mul(p[1], oc.F.mul(
        l, oc.F.mul(l, l))), oc.F.mul(p[2], l)) for p, l in zip(pts, lam)]
    assert G.eq(P, _pack_points(F, R)).tolist() == [True] * 8
    pairs = G.tree_reduce(tuple(c.reshape(F.L, 4, 2) for c in P), 2)
    assert pairs[0].shape == (F.L, 4, 1)
    want = [oc.add(pts[2 * i], pts[2 * i + 1]) for i in range(4)]
    want = [None if oc.is_zero(w) else oc.affine(w)[:2] for w in want]
    flat = tuple(c.reshape(F.L, 4) for c in pairs)
    assert _affine(F.unpack_mont, oc, flat) == want
    assert _affine(JF.unpack_mont, oc,
                   tuple(np.asarray(c).reshape(F.L, 4) for c in jred)) == want
    total = oc.zero()
    for p in pts:
        total = oc.add(total, p)
    red = G.tree_reduce(P, 8)
    assert red[0].shape == (F.L, 1)
    assert _affine(F.unpack_mont, oc, red) == [oc.affine(total)[:2]]
    with pytest.raises(ValueError, match="power-of-two"):
        G.tree_reduce(tuple(c[:, :6] for c in P), 6)


def test_signed_ladder_bn128_full_width_against_oracle():
    """The signed ladder on 4 BN128 G1 lanes (the kernel-backed curve's CPU
    path: K4, K6 and K7's plain versions) with full-width scalars: r - 1,
    a random one below r, the 0xFFFF8001 pattern over 224 bits, and zero;
    the third lane's point is zero."""
    m = bn128()
    r = m.fr_spec.q
    F = fp.FpDevice(m.fp_spec, "cpu")
    G = curve.JacobianDevice(FpAdapter(F))
    oc = m.G1
    rng = np.random.default_rng(11)
    ks = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(4)]
    pts = [oc.times_scalar(m.g1_gen, k) for k in ks]
    pts[2] = oc.zero()
    carry = sum(0xFFFF8001 << (32 * i) for i in range(7))
    scl = [r - 1, ks[0], carry, 0]
    got = msm.times_scalar_signed_device(
        G, _pack_points(F, pts), ints_to_limbs(scl, 16), 4)
    xs, ys, zs = (F.unpack_mont(c) for c in got)
    want = _want(oc, pts, scl)
    assert [None if z == 0 else oc.affine((x, y, z))[:2]
            for x, y, z in zip(xs, ys, zs)] == want
    assert want[0] == oc.affine(oc.neg(pts[0]))[:2]
    assert want[2] is None and want[3] is None


def test_ladders_over_projective_device_against_oracle():
    """Both scalar ladders and tree_reduce over ProjectiveDevice (a != 0,
    the MNT6753 G1 device's class) on the toy curve y^2 = x^3 + 2x + 3
    over P61, 8 lanes (a zero point, a zero scalar, the 0xFFFF8001 pattern,
    40-bit scalars), against the port's projective host oracle; the JAX
    package's ladders run the same code over either device."""
    from wasmsnark_tpu_torch.curves.oracle import ProjectiveCurve
    spec = FieldSpec(P61)
    OF = OracleFp(spec)
    oc = ProjectiveCurve(OF, lambda z: OF.mul(2, z))
    x0 = next(c for c in range(2, 100)
              if spec.is_square((c ** 3 + 2 * c + 3) % spec.q))
    gen = oc.from_affine(x0, spec.sqrt((x0 ** 3 + 2 * x0 + 3) % spec.q))
    F = fp.FpDevice(spec, "cpu")
    a = F.pack_mont([2])
    G = curve.ProjectiveDevice(FpAdapter(F), lambda z: F.mont_mul(z, a))
    rng = np.random.default_rng(8)
    ks = [int(v) for v in rng.integers(1, 1 << 40, size=8)]
    pts = [oc.times_scalar(gen, k) for k in ks]
    pts[0] = oc.zero()
    scl = [int(v) for v in rng.integers(0, 1 << 32, size=8)]
    scl[1], scl[2] = 0, 0xFFFF8001
    P, sc = _pack_points(F, pts), ints_to_limbs(scl, 2)
    expect = _want(oc, pts, scl)
    signed = msm.times_scalar_signed_device(G, P, sc, 4)
    assert _affine(F.unpack_mont, oc, signed) == expect
    assert _affine(F.unpack_mont, oc,
                   fp.times_scalar_device(G, P, sc, 32)) == expect
    total = oc.zero()
    for p, k in zip(pts, scl):
        total = oc.add(total, oc.times_scalar(p, k))
    assert _affine(F.unpack_mont, oc, curve.tree_reduce(G, signed, 8)) == [
        oc.affine(total)[:2]]
