"""Port parity for the a != 0 projective group law (MNT6753's G1):
wasmsnark_tpu_torch's ProjectiveDevice against the JAX package's.

On the toy curve of tests/test_projective_device.py (y^2 = x^3 + 3x + 11
over 2^61 - 1, where the JAX device class compiles in seconds) the port's
add, double and a double-and-add ladder are held against the JAX
ProjectiveDevice (jnp path) on the same lanes; at MNT6753's 753-bit G1
(L = 48) against the JAX host oracle's ProjectiveCurve.  Projective
representatives depend on the formulas, so outputs are compared after
affine normalisation, and zero as Z = 0 (tolerance 0 on the canonical
affine values).  Lanes: random multiples of the generator, P = Q,
P = -Q, zero operands.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wasmsnark_tpu.curves.oracle import ProjectiveCurve
from wasmsnark_tpu.fields import oracle as jfo
from wasmsnark_tpu.fields.spec import FieldSpec as JSpec
from wasmsnark_tpu.models.mnt6753 import mnt6753 as jmnt
from wasmsnark_tpu.ops.curve import ProjectiveDevice as JProj
from wasmsnark_tpu.ops.fp import FpDevice as JFp
from wasmsnark_tpu.ops.towers import FpAdapter as JAd

from wasmsnark_tpu_torch.fields.spec import FieldSpec
from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
from wasmsnark_tpu_torch.ops import fp as tfp
from wasmsnark_tpu_torch.ops.curve import ProjectiveDevice
from wasmsnark_tpu_torch.ops.towers import FpAdapter

torch.set_num_threads(1)

CPU = torch.device("cpu")
P61 = (1 << 61) - 1
A_TOY = 3


def _port_curve(spec, a):
    F = tfp.FpDevice(spec, CPU)
    a_m = F.pack_mont([a])
    return F, ProjectiveDevice(FpAdapter(F), lambda z: F.mont_mul(z, a_m))


def _affine(curve, xs, ys, zs):
    """Per lane: None for zero, else the oracle-affine (x, y)."""
    out = []
    for x, y, z in zip(xs, ys, zs):
        out.append(None if z == 0 else curve.affine((x, y, z))[:2])
    return out


def _want(curve, pts):
    return [None if curve.is_zero(p) else curve.affine(p)[:2] for p in pts]


@pytest.fixture(scope="module")
def toy():
    ospec = JSpec(P61, "toy61")
    F = jfo.Fp(ospec)
    curve = ProjectiveCurve(F, lambda z: F.mul(A_TOY, z), "toy")
    gen = curve.from_affine(2, 5)
    jF = JFp(ospec)
    a_m = jnp.asarray(jF.pack_mont([A_TOY]))
    jdev = JProj(JAd(jF), lambda z: jF.mont_mul(z, a_m))
    tF, tdev = _port_curve(FieldSpec(P61, "toy61"), A_TOY)
    return curve, gen, jF, jdev, tF, tdev


def _lanes(curve, gen, seed):
    rng = random.Random(seed)
    pts = [curve.times_scalar(gen, rng.randrange(1, 1 << 40))
           for _ in range(4)]
    # scale the projective representatives by random z
    pts = [(x * z % P61, y * z % P61, p[2] * z % P61) for p, (x, y, z) in
           zip(pts, [(p[0], p[1], rng.randrange(1, P61)) for p in pts])]
    zero = curve.zero()
    Pl = [pts[0], pts[1], zero, pts[2], pts[3], zero, curve.double(pts[1])]
    Ql = [pts[0], curve.neg(pts[1]), pts[2], zero, pts[0], zero, pts[3]]
    return Pl, Ql


@pytest.mark.parametrize("op", ["add", "double"])
def test_toy_curve_against_the_jax_device_class(toy, op):
    curve, gen, jF, jdev, tF, tdev = toy
    Pl, Ql = _lanes(curve, gen, 3)

    def jpack(pl):
        return tuple(jnp.asarray(jF.pack_mont([p[i] for p in pl]))
                     for i in range(3))

    def tpack(pl):
        return tuple(tF.pack_mont([p[i] for p in pl]) for i in range(3))

    if op == "add":
        j = jax.jit(jdev.add)(jpack(Pl), jpack(Ql))
        t = tdev.add(tpack(Pl), tpack(Ql))
        want = _want(curve, [curve.add(p, q) for p, q in zip(Pl, Ql)])
    else:
        j = jax.jit(jdev.double)(jpack(Pl))
        t = tdev.double(tpack(Pl))
        want = _want(curve, [curve.double(p) for p in Pl])
    jv = _affine(curve, *(jF.unpack_mont(np.asarray(c)) for c in j))
    tv = _affine(curve, *(tF.unpack_mont(c) for c in t))
    assert tv == jv == want


def test_toy_ladder_and_eq(toy):
    """13 P by double-and-add through both packages' device ops, and the
    port's projective eq against the oracle's."""
    curve, gen, jF, jdev, tF, tdev = toy
    Pl, Ql = _lanes(curve, gen, 4)
    jp = tuple(jnp.asarray(jF.pack_mont([p[i] for p in Pl]))
               for i in range(3))
    tp = tuple(tF.pack_mont([p[i] for p in Pl]) for i in range(3))

    def ladder(dev, p):
        acc = p
        for bit in bin(13)[3:]:
            acc = dev.double(acc)
            if bit == "1":
                acc = dev.add(acc, p)
        return acc

    jacc = jax.jit(lambda p: ladder(jdev, p))(jp)
    tacc = ladder(tdev, tp)
    want = _want(curve, [curve.times_scalar(p, 13) for p in Pl])
    assert _affine(curve, *(tF.unpack_mont(c) for c in tacc)) == want
    assert _affine(curve, *(jF.unpack_mont(np.asarray(c))
                            for c in jacc)) == want
    tq = tuple(tF.pack_mont([q[i] for q in Ql]) for i in range(3))
    assert tdev.eq(tp, tq).tolist() == [curve.eq(p, q)
                                        for p, q in zip(Pl, Ql)]


def test_mnt6753_g1_against_the_oracle():
    """MNT6753 G1 (L = 48, a = 11): add (generic, P = Q, P = -Q, zero
    operands) and double against the JAX host oracle."""
    jm, m = jmnt(), mnt6753()
    G = jm.G1
    rng = random.Random(5)
    pts = [G.times_scalar(jm.g1_gen, rng.randrange(1, 1 << 64))
           for _ in range(3)]
    Pl = [pts[0], pts[1], G.zero(), pts[2]]
    Ql = [pts[0], G.neg(pts[1]), pts[2], pts[1]]
    F, dev = _port_curve(m.fp_spec, 11)

    def pack(pl):
        return tuple(F.pack_mont([p[i] for p in pl]) for i in range(3))

    got = dev.add(pack(Pl), pack(Ql))
    assert _affine(G, *(F.unpack_mont(c) for c in got)) == _want(
        G, [G.add(p, q) for p, q in zip(Pl, Ql)])
    got = dev.double(pack(Pl))
    assert _affine(G, *(F.unpack_mont(c) for c in got)) == _want(
        G, [G.double(p) for p in Pl])


def _mnt_lanes():
    """MNT6753 G1 lanes for the mixed add: P (projective, random Z) and Q
    (affine, zero written (0, 0)): generic, P = Q, P = -Q, P zero, Q zero,
    both zero."""
    jm = jmnt()
    G = jm.G1
    q = jm.fp_spec.q
    rng = random.Random(6)
    pts = [G.affine(G.times_scalar(jm.g1_gen, rng.randrange(1, 1 << 64)))
           for _ in range(3)]

    def scaled(p):
        z = rng.randrange(1, q)
        return (p[0] * z % q, p[1] * z % q, z)

    Pl = [scaled(pts[0]), scaled(pts[1]), scaled(pts[1]), G.zero(),
          scaled(pts[2]), G.zero()]
    Ql = [pts[1], pts[1], G.neg(pts[1]), pts[2], None, None]
    return G, Pl, Ql


@pytest.mark.parametrize("op", ["promote", "madd", "tree_reduce"])
def test_mnt6753_g1_mixed_add_and_tree(op):
    """ProjectiveDevice.promote, madd and tree_reduce (what ops/
    fixed_base.py sums with) at MNT6753's G1 against the JAX host
    oracle's add; zero operands and P = Q included."""
    G, Pl, Ql = _mnt_lanes()
    F, dev = _port_curve(mnt6753().fp_spec, 11)

    def pack(pl, n=3):
        return tuple(F.pack_mont([p[i] for p in pl]) for i in range(n))

    def unpack(p):
        return _affine(G, *(F.unpack_mont(c.reshape(c.shape[0], -1))
                            for c in p))

    qa = [(0, 0) if q is None else q[:2] for q in Ql]
    qp = [G.zero() if q is None else G.from_affine(*q[:2]) for q in Ql]
    if op == "promote":
        assert unpack(dev.promote(pack(qa, 2))) == _want(G, qp)
    elif op == "madd":
        got = dev.madd(pack(Pl), pack(qa, 2))
        assert unpack(got) == _want(G, [G.add(p, q) for p, q in zip(Pl, qp)])
    else:
        # lanes [2, 4]: the four summands of a lane along the last axis;
        # the first level adds P = Q in one lane, P = -Q in the other
        rows = [[Pl[1], Pl[0], Pl[2], Pl[3]], [qp[1], Pl[0], qp[2], Pl[5]]]
        got = dev.tree_reduce(tuple(c.reshape(c.shape[0], 2, 4) for c in
                                    pack(sum(rows, []))), 4)
        want = []
        for row in rows:
            acc = G.zero()
            for p in row:
                acc = G.add(acc, p)
            want.append(acc)
        assert unpack(got) == _want(G, want)
