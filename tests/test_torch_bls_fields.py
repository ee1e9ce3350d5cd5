"""Port parity at BLS12-381's widths: field constants, FpDevice ops and the
K4 negation over the 24-limb Fq (and the NTT field Fr), the G1 group law
and the G1 and G2 MSMs of wasmsnark_tpu_torch against wasmsnark_tpu on the
CPU.

Tolerance: field ops are bit-identical to the JAX package's jnp path (the
adversarial gen_values grid, as the same uint32 planes); the group law
and MSMs, whose Jacobian outputs depend on the summation order, equal the
JAX host oracle after affine normalisation.
"""

import random

import jax
import numpy as np
import pytest
import torch

from wasmsnark_tpu.fields import spec as jspec
from wasmsnark_tpu.models.bls12381 import bls12381 as jbls
from wasmsnark_tpu.ops.fp import FpDevice as JFp
from wasmsnark_tpu.ops.towers import FpAdapter as JAd

from wasmsnark_tpu_torch.fields import spec as tspec
from wasmsnark_tpu_torch.models.bls12381 import R, bls12381 as tbls
from wasmsnark_tpu_torch.ops import fp as tfp
from wasmsnark_tpu_torch.ops.curve import JacobianDevice, map_leaf
from wasmsnark_tpu_torch.ops.msm import MSMDevice
from wasmsnark_tpu_torch.ops.towers import FpAdapter, F2Device
from wasmsnark_tpu_torch.utils.serialize import ints_to_limbs

from conftest import gen_values

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
jm, m = jbls(), tbls()
Fp = tfp.FpDevice(m.fp_spec, CPU)
A1 = FpAdapter(Fp)
G1d = JacobianDevice(A1)
G2d = JacobianDevice(F2Device(A1, A1.neg))


def _specs(which):
    return ((jm.fp_spec, m.fp_spec) if which == "fq"
            else (jm.fr_spec, m.fr_spec))


def _vectors(q):
    vals = gen_values(q)
    n = len(vals)
    return ([vals[i % n] for i in range(2 * n)],
            [vals[(i * 7 + 3) % n] for i in range(2 * n)])


@pytest.mark.parametrize("which", ["fq", "fr"])
def test_bls_spec_constants(which):
    js, ts = _specs(which)
    assert ts.n_limbs == (24 if which == "fq" else 16)
    assert ts.n8 == (48 if which == "fq" else 32)
    for attr in ("q", "n_limbs", "bits", "R", "R2", "R3", "np16", "half",
                 "one_mont", "q_limbs", "n8"):
        assert getattr(js, attr) == getattr(ts, attr), attr
    jn, tn = jspec.NTTSpec(js), tspec.NTTSpec(ts)
    assert jn.max_bits == tn.max_bits
    assert jn.roots == tn.roots and jn.inv2 == tn.inv2


OPS = ["add", "sub", "neg", "mont_mul", "mont_sqr", "to_mont", "from_mont"]


@pytest.mark.parametrize("op", OPS)
def test_fq_ops_bit_identical(op):
    """K1 and K2 (plain versions) at L = 24 against the jnp path."""
    js, ts = _specs("fq")
    J, T = JFp(js), tfp.FpDevice(ts, CPU)
    xs, ys = _vectors(js.q)
    X, Y = J.pack(xs), J.pack(ys)
    binary = op in ("add", "sub", "mont_mul")
    fn = getattr(J, op)
    want = np.asarray(jax.jit(fn)(X, Y) if binary else jax.jit(fn)(X))
    tx, ty = tfp.planes(X, CPU), tfp.planes(Y, CPU)
    got = getattr(T, op)(tx, ty) if binary else getattr(T, op)(tx)
    np.testing.assert_array_equal(tfp.to_numpy(got), want)


def test_fr_mont_mul_and_fq_cneg_bit_identical():
    """BLS12-381's Fr through K1, and K4's negation at L = 24."""
    js, ts = _specs("fr")
    J, T = JFp(js), tfp.FpDevice(ts, CPU)
    xs, ys = _vectors(js.q)
    X, Y = J.pack(xs), J.pack(ys)
    np.testing.assert_array_equal(
        tfp.to_numpy(T.mont_mul(tfp.planes(X, CPU), tfp.planes(Y, CPU))),
        np.asarray(jax.jit(J.mont_mul)(X, Y)))
    js, ts = _specs("fq")
    J = JFp(js)
    xs, _ = _vectors(js.q)
    X = J.pack(xs)
    mask = np.arange(X.shape[1]) % 3 != 1
    want = np.asarray(jax.jit(JAd(J).cneg)(mask, X))
    got = A1.cneg(torch.from_numpy(mask), tfp.planes(X, CPU))
    np.testing.assert_array_equal(tfp.to_numpy(got), want)


def pack_g1(points):
    return tuple(Fp.pack_mont([p[i] for p in points]) for i in range(3))


def pack_g1_affine(points):
    aff = [(0, 0) if m.G1.is_zero(p) else m.G1.affine(p)[:2] for p in points]
    return (Fp.pack_mont([a[0] for a in aff]),
            Fp.pack_mont([a[1] for a in aff]))


def pack_g2_affine(points):
    aff = [((0, 0), (0, 0)) if m.G2.is_zero(p) else m.G2.affine(p)[:2]
           for p in points]
    return tuple((Fp.pack_mont([a[i][0] for a in aff]),
                  Fp.pack_mont([a[i][1] for a in aff])) for i in range(2))


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


def test_g1_group_law_degeneracies_at_l24():
    """K5-K7 (plain versions) at L = 24: equal, opposite and zero points,
    against the JAX host oracle."""
    rnd = random.Random(3)
    pts = [jm.G1.times_scalar(jm.g1_gen, rnd.randrange(1, R))
           for _ in range(4)]
    z = jm.G1.zero()
    P = [pts[0], pts[1], pts[2], pts[2], z, pts[3], z]
    Q = [pts[1], pts[0], pts[2], jm.G1.neg(pts[2]), pts[3], z, z]
    got = unpack_g1(G1d.add(pack_g1(P), pack_g1(Q)))
    for i, (p, q) in enumerate(zip(P, Q)):
        assert same(jm.G1, jm.G1.add(p, q), got[i]), i
    gotd = unpack_g1(G1d.double(pack_g1(P)))
    for i, p in enumerate(P):
        assert same(jm.G1, jm.G1.double(p), gotd[i]), i
    gotm = unpack_g1(G1d.madd(pack_g1(P), pack_g1_affine(Q)))
    for i, (p, q) in enumerate(zip(P, Q)):
        assert same(jm.G1, jm.G1.add(p, q), gotm[i]), i


def test_g1_msm_vs_jax_oracle():
    """Repeats, a zero point, an inverse pair, a zero scalar and an
    unreduced 256-bit scalar over 381-bit G1."""
    rnd = random.Random(9)
    n = 24
    pts = [jm.G1.affine(jm.G1.times_scalar(jm.g1_gen, rnd.randrange(1, R)))
           for _ in range(n - 4)]
    pts += [pts[0], pts[0], jm.G1.zero(), jm.G1.neg(pts[1])]
    scalars = [rnd.randrange(R) for _ in range(n - 3)] + [0, 2 ** 256 - 1, 7]
    S = tfp.planes(ints_to_limbs(scalars, 16), CPU)
    # the window the prover takes below 2^7 points
    msm = MSMDevice(G1d, window_bits=4)
    got = unpack_g1(tuple(map_leaf(c, lambda a: a[..., None])
                          for c in msm.msm_point(S, pack_g1_affine(pts))))[0]
    assert same(jm.G1, jm.G1.msm(pts, scalars), got)


def test_g2_msm_vs_jax_oracle():
    rnd = random.Random(13)
    n = 12
    pts = [jm.G2.times_scalar(jm.g2_gen, rnd.randrange(1, R))
           for _ in range(n - 1)] + [jm.G2.zero()]
    scalars = [rnd.randrange(R) for _ in range(n - 1)] + [0]
    S = tfp.planes(ints_to_limbs(scalars, 16), CPU)
    msm = MSMDevice(G2d, window_bits=4)
    got = unpack_g2(tuple(map_leaf(c, lambda a: a[..., None])
                          for c in msm.msm_point(S, pack_g2_affine(pts))))[0]
    assert same(jm.G2, jm.G2.msm(pts, scalars), got)
