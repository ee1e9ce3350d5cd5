"""The port's complete projective group law (ops/curve_complete.py
CompleteCurveDevice, Renes-Costello-Batina for a = 0) on the CPU path
against the JAX package's class on the same numpy-seeded inputs: add,
double and eq over the toy curve y^2 = x^3 + 7 over P61 (b3 = 21) and over
BN128 G1 (b3 = 9), on lanes of random projective points (random Z), equal
operands, opposite operands, a zero operand and two zeros.  Tolerance: the
projective coordinates are bit-identical (the formula sequence is fixed
and canonical values are unique); the sums also equal the host oracle's
after affine normalisation.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wasmsnark_tpu.fields.spec import FieldSpec as JSpec
from wasmsnark_tpu.ops import fp as jfp
from wasmsnark_tpu.ops.curve_complete import CompleteCurveDevice as JComplete
from wasmsnark_tpu.ops.towers import FpAdapter as JAdapter

from wasmsnark_tpu_torch.curves.oracle import JacobianCurve
from wasmsnark_tpu_torch.fields.oracle import Fp as OracleFp
from wasmsnark_tpu_torch.fields.spec import FieldSpec
from wasmsnark_tpu_torch.models.bn128 import bn128
from wasmsnark_tpu_torch.ops import fp
from wasmsnark_tpu_torch.ops.curve_complete import CompleteCurveDevice
from wasmsnark_tpu_torch.ops.towers import FpAdapter

N = 12


def _jax_mul_small(F, k):
    """k a for the JAX adapter, which has no mul_small: double-and-add
    over its add (the canonical value k a mod q)."""
    def mul(a):
        r, kk = None, k
        while kk:
            if kk & 1:
                r = a if r is None else F.add(r, a)
            kk >>= 1
            if kk:
                a = F.add(a, a)
        return r
    return mul


def _curve(name):
    """(spec, b, generator as oracle Jacobian, oracle curve)."""
    if name == "bn128":
        m = bn128()
        return m.fp_spec, 3, m.g1_gen, m.G1
    spec = FieldSpec((1 << 61) - 1)
    oc = JacobianCurve(OracleFp(spec))
    x0 = next(c for c in range(2, 100)
              if spec.is_square((c ** 3 + 7) % spec.q))
    return spec, 7, oc.from_affine(x0, spec.sqrt((x0 ** 3 + 7) % spec.q)), oc


def _lanes(spec, gen, oc, rng):
    """Projective (X, Y, Z) canonical triples of N lanes for p and q:
    random points at random Z, then p = q, q = -p, q zero, p zero, both
    zero; and the affine oracle sums (None for zero)."""
    q = spec.q

    def proj(pt, z):
        if pt is None:
            return (0, 1, 0)
        x, y = pt
        return (x * z % q, y * z % q, z)

    ks = [int(v) for v in rng.integers(1, 1 << 62, size=2 * N)]
    aff = [oc.affine(oc.times_scalar(gen, k))[:2] for k in ks]
    P, Qp = aff[:N], aff[N:]
    Qp[0] = P[0]
    Qp[1] = P[1]
    Qp[2] = (P[2][0], (-P[2][1]) % q)
    Qp[3] = None
    P[4] = None
    P[5], Qp[5] = None, None
    zs = [int(v) % (q - 1) + 1 for v in rng.integers(1, 1 << 62, size=2 * N)]
    p = [proj(a, z) for a, z in zip(P, zs[:N])]
    qq = [proj(a, z) for a, z in zip(Qp, zs[N:])]

    def jac(a):
        return oc.zero() if a is None else oc.from_affine(*a)
    want = []
    for a, b in zip(P, Qp):
        s = oc.add(jac(a), jac(b))
        want.append(None if oc.is_zero(s) else oc.affine(s)[:2])
    return p, qq, want


@pytest.mark.parametrize("name", ["p61", "bn128"])
def test_complete_add_double_eq_against_jax(name):
    spec, b, gen, oc = _curve(name)
    rng = np.random.default_rng(3)
    p, q, want = _lanes(spec, gen, oc, rng)
    F = fp.FpDevice(spec, "cpu")
    C = CompleteCurveDevice(FpAdapter(F), lambda a: FpAdapter(F).mul_small(
        a, 3 * b))
    JF = jfp.FpDevice(JSpec(spec.q))
    JA = JAdapter(JF)
    JC = JComplete(JA, _jax_mul_small(JA, 3 * b))

    def pack(pts):
        return tuple(F.pack_mont([t[i] for t in pts]) for i in range(3))

    P, Q = pack(p), pack(q)
    jadd, jdbl, jeq, jeq_self = jax.jit(lambda a, c: (
        JC.add(a, c), JC.double(a), JC.eq(a, c), JC.eq(a, a)))(
        *(tuple(jnp.asarray(fp.to_numpy(c)) for c in X) for X in (P, Q)))
    add, dbl = C.add(P, Q), C.double(P)
    for got, ref in ((add, jadd), (dbl, jdbl)):
        for g, r in zip(got, ref):
            assert np.array_equal(fp.to_numpy(g), np.asarray(r))
    eq = C.eq(P, Q).tolist()
    assert eq == np.asarray(jeq).tolist()
    assert eq == [True, True] + [False] * 3 + [True] + [False] * (N - 6)
    assert C.eq(P, P).tolist() == np.asarray(jeq_self).tolist() == [True] * N
    xs, ys, zs = (F.unpack_mont(c) for c in add)
    got = [None if z == 0 else (x * pow(z, -1, spec.q) % spec.q,
                                y * pow(z, -1, spec.q) % spec.q)
           for x, y, z in zip(xs, ys, zs)]
    assert got == want
    assert want[2] is None and want[5] is None
    assert C.is_zero(add).tolist() == [w is None for w in want]
