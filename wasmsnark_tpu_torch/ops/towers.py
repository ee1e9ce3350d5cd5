"""Extension-field adapters, PyTorch port of wasmsnark_tpu/ops/towers.py
(FpAdapter, F2Device, F3Device, gs_cyclotomic_square).

A tower element is a tuple of base-field planes, so the curve, MSM and
pairing code is generic over Fp (G1), Fp2 (G2) and the F6/F12 towers, as
in the JAX package (MNT6753's F3/F6 over Fp too, `mnt_towers`).  The one
kernel here is K4 (`mod_cneg`), the MSM's signed-digit negation; the fused
F12, F6 and Miller-step kernels K8-K14 sit in ops/tower_kernels.py.

Every formula stacks its independent base-field calls on a new batch axis
(`stack`), so one tower operation is a few base calls (one launch each on
the card) instead of one per product.  Canonical Montgomery outputs are
unique, so the values are bit-identical to the JAX package's formulas.
"""

from __future__ import annotations

import torch

from ..fields.spec import FieldSpec
from . import cuda_lib
from .fp import (DTYPE, PlainFp, broadcast_shapes, check_cuda, lanes,
                 mod_sub_plain, mul_small_plain)


def mod_cneg_plain(spec: FieldSpec, flag, y):
    """flag ? (q - y, with -0 = 0) : y on [L, n] planes, flag [n] bool."""
    return torch.where(flag[None], mod_sub_plain(spec, torch.zeros_like(y), y),
                       y.to(DTYPE))


def mod_cneg(spec: FieldSpec, flag, y):
    """K4: flag ? -y : y (replaces fp_pallas.py mod_cneg_pallas)."""
    L = spec.n_limbs
    (yf,), bshape = lanes(L, y)
    ff = torch.broadcast_to(flag.to(torch.bool), bshape).reshape(-1)
    if not yf.is_cuda:
        out = mod_cneg_plain(spec, ff, yf)
    else:
        ff = ff.contiguous()
        check_cuda(ff, yf)
        out = torch.empty_like(yf)
        cuda_lib.launch("k4_cneg", spec, (ff, yf, out), (yf.shape[1],))
    return out.reshape((L,) + bshape)


class FpAdapter:
    """FpDevice in the generic tower element protocol (bare [L, *B]
    planes)."""

    def __init__(self, fp):
        self.fp = fp

    def mul(self, a, b):
        return self.fp.mont_mul(a, b)

    def square(self, a):
        return self.fp.mont_sqr(a)

    def add(self, a, b):
        return self.fp.add(a, b)

    def sub(self, a, b):
        return self.fp.sub(a, b)

    def neg(self, a):
        return self.fp.neg(a)

    def cneg(self, mask, a):
        """mask ? -a : a in one pass (K4)."""
        return mod_cneg(self.fp.spec, mask, a)

    def is_zero(self, a):
        return self.fp.is_zero(a)

    def eq(self, a, b):
        return self.fp.eq(a, b)

    def select(self, mask, a, b):
        return self.fp.select(mask, a, b)

    def zero_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return self.fp.one_mont(*a.shape[1:])

    def mul_small(self, a, k: int):
        """a * k for a small static k >= 0: on the card a double-and-add
        chain of K2 adds (one launch each); the plain field and CPU tensors
        take mul_small_plain, one pass with the same canonical value."""
        if a.is_cuda and not isinstance(self.fp, PlainFp):
            return mul_small(self, a, k)
        (af,), bshape = lanes(self.fp.L, a)
        return mul_small_plain(self.fp.spec, af, k).reshape(
            (self.fp.L,) + bshape)

    def inv(self, a):
        return self.fp.mont_inv(a)


def mul_small(F, a, k: int):
    """a * k for a small static k >= 0 by double-and-add over F.add (the
    JAX package adds k - 1 times; the canonical value is the same)."""
    if k == 0:
        return F.zero_like(a)
    r = None
    while k:
        if k & 1:
            r = a if r is None else F.add(r, a)
        k >>= 1
        if k:
            a = F.add(a, a)
    return r


def stack(*els):
    """Tower elements of one structure -> one element with a new batch
    axis 1 (so one field call computes them all)."""
    if isinstance(els[0], tuple):
        return tuple(stack(*[e[i] for e in els]) for i in range(len(els[0])))
    shape = broadcast_shapes(*[e.shape for e in els])
    return torch.stack([e.expand(shape) for e in els], dim=1)


def unstack(e, k: int) -> list:
    """Inverse of stack: k elements."""
    if isinstance(e, tuple):
        parts = [unstack(c, k) for c in e]
        return [tuple(p[i] for p in parts) for i in range(k)]
    return list(e.unbind(1))


class F2Device:
    """Quadratic extension over a base adapter; elements are (c0, c1)
    tuples.  Karatsuba mul, complex-style square, norm-based inverse —
    the formulas of the JAX package's F2Device."""

    def __init__(self, base, mul_nr):
        self.base = base
        self.mul_nr = mul_nr

    # Independent base-field calls are stacked on a new batch axis 1, so a
    # product costs one base multiply call (one launch on the card).

    def mul(self, a, b):
        F = self.base
        sa, sb = unstack(F.add(stack(a[0], b[0]), stack(a[1], b[1])), 2)
        m0, m1, t = unstack(F.mul(stack(a[0], a[1], sa),
                                  stack(b[0], b[1], sb)), 3)
        c0, m01 = unstack(F.add(stack(m0, m0),
                                stack(self.mul_nr(m1), m1)), 2)
        return (c0, F.sub(t, m01))

    def square(self, a):
        F = self.base
        s0, s1 = unstack(F.add(stack(a[0], a[0]),
                               stack(a[1], self.mul_nr(a[1]))), 2)
        ab, t = unstack(F.mul(stack(a[0], s0), stack(a[1], s1)), 2)
        u, c1 = unstack(F.add(stack(ab, ab), stack(self.mul_nr(ab), ab)), 2)
        return (F.sub(t, u), c1)

    def add(self, a, b):
        return tuple(unstack(self.base.add(stack(*a), stack(*b)), 2))

    def sub(self, a, b):
        return tuple(unstack(self.base.sub(stack(*a), stack(*b)), 2))

    def neg(self, a):
        return tuple(unstack(self.base.neg(stack(*a)), 2))

    def cneg(self, mask, a):
        return tuple(unstack(self.base.cneg(mask, stack(*a)), 2))

    def conjugate(self, a):
        return (a[0], self.base.neg(a[1]))

    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1])

    def eq(self, a, b):
        return self.base.eq(a[0], b[0]) & self.base.eq(a[1], b[1])

    def select(self, mask, a, b):
        F = self.base
        return (F.select(mask, a[0], b[0]), F.select(mask, a[1], b[1]))

    def zero_like(self, a):
        F = self.base
        return (F.zero_like(a[0]), F.zero_like(a[1]))

    def one_like(self, a):
        F = self.base
        return (F.one_like(a[0]), F.zero_like(a[1]))

    def mul_small(self, a, k: int):
        """Per component over the stacked base: the same chain of base adds
        (one call each) as a chain of F2 adds."""
        return tuple(unstack(self.base.mul_small(stack(*a), k), 2))

    def mul_base(self, a, b_base):
        """a * b for b in the base field."""
        return tuple(unstack(self.base.mul(stack(*a), stack(b_base, b_base)),
                             2))

    def inv(self, a):
        F = self.base
        t = F.sub(F.square(a[0]), self.mul_nr(F.square(a[1])))
        ti = F.inv(t)
        return (F.mul(a[0], ti), F.neg(F.mul(a[1], ti)))


class F3Device:
    """Cubic extension over a base adapter; elements (c0, c1, c2) with
    v^3 = nr.  Karatsuba-style 6M mul, CH-SQR2 square, adjugate inverse —
    the formulas of the JAX package's F3Device (build_f3m.js)."""

    def __init__(self, base, mul_nr):
        self.base = base
        self.mul_nr = mul_nr

    def mul(self, a, b):
        F, nr = self.base, self.mul_nr
        s01, s12, s02, u01, u12, u02 = unstack(F.add(
            stack(a[0], a[1], a[0], b[0], b[1], b[0]),
            stack(a[1], a[2], a[2], b[1], b[2], b[2])), 6)
        v0, v1, v2, t01, t12, t02 = unstack(F.mul(
            stack(a[0], a[1], a[2], s01, s12, s02),
            stack(b[0], b[1], b[2], u01, u12, u02)), 6)
        w = F.sub(F.sub(stack(t12, t01, t02), stack(v1, v0, v0)),
                  stack(v2, v1, v2))
        w12, w01, w02 = unstack(w, 3)
        n12, n2 = unstack(nr(stack(w12, v2)), 2)
        return tuple(unstack(F.add(stack(v0, w01, w02),
                                   stack(n12, n2, v1)), 3))

    def square(self, a):
        F, nr = self.base, self.mul_nr
        e = F.add(F.sub(a[0], a[1]), a[2])
        s0, s2, s4, ab, bc = unstack(F.mul(stack(a[0], e, a[2], a[0], a[1]),
                                           stack(a[0], e, a[2], a[1], a[2])), 5)
        s1, s3 = unstack(F.add(stack(ab, bc), stack(ab, bc)), 2)
        n3, n4 = unstack(nr(stack(s3, s4)), 2)
        c0, c1, c2 = unstack(F.add(stack(s0, s1, s1), stack(n3, n4, s2)), 3)
        return (c0, c1, F.sub(F.add(c2, s3), F.add(s0, s4)))

    def add(self, a, b):
        return tuple(unstack(self.base.add(stack(*a), stack(*b)), 3))

    def sub(self, a, b):
        return tuple(unstack(self.base.sub(stack(*a), stack(*b)), 3))

    def neg(self, a):
        return tuple(unstack(self.base.neg(stack(*a)), 3))

    def eq(self, a, b):
        F = self.base
        return F.eq(a[0], b[0]) & F.eq(a[1], b[1]) & F.eq(a[2], b[2])

    def zero_like(self, a):
        F = self.base
        return tuple(F.zero_like(x) for x in a)

    def one_like(self, a):
        F = self.base
        return (F.one_like(a[0]), F.zero_like(a[1]), F.zero_like(a[2]))

    def mul_small(self, a, k: int):
        return tuple(unstack(self.base.mul_small(stack(*a), k), 3))

    def mul_base(self, a, b_base):
        return tuple(unstack(self.base.mul(
            stack(*a), stack(b_base, b_base, b_base)), 3))

    def inv(self, a):
        """Adjugate inverse (build_f3m.js:389-444): x^-1 = (A + B v +
        C v^2) / N with A = a0^2 - nr a1 a2, B = nr a2^2 - a0 a1,
        C = a1^2 - a0 a2, N = a0 A + nr (a2 B + a1 C)."""
        F, nr = self.base, self.mul_nr
        s0, s1, s2, p12, p01, p02 = unstack(F.mul(
            stack(a[0], a[1], a[2], a[1], a[0], a[0]),
            stack(a[0], a[1], a[2], a[2], a[1], a[2])), 6)
        n12, n22 = unstack(nr(stack(p12, s2)), 2)
        A, B, C = unstack(F.sub(stack(s0, n22, s1), stack(n12, p01, p02)), 3)
        a0A, a2B, a1C = unstack(F.mul(stack(a[0], a[2], a[1]),
                                      stack(A, B, C)), 3)
        N = F.add(a0A, nr(F.add(a2B, a1C)))
        Ni = F.inv(N)
        return tuple(unstack(F.mul(stack(A, B, C), stack(Ni, Ni, Ni)), 3))


def xi_mul(F, xi):
    """Multiplication by the small sextic non-residue xi = c0 + c1 u of
    F2 = F[u]/(u^2 + 1) (BN128: 9 + u): (c0 a0 - c1 a1, c1 a0 + c0 a1)."""
    c0, c1 = xi

    def mul_xi(a):
        s0, s1 = unstack(F.mul_small(stack(a[0], a[1]), c0), 2)
        t0, t1 = unstack(F.mul_small(stack(a[0], a[1]), c1), 2)
        return (F.sub(s0, t1), F.add(t0, s1))

    return mul_xi


def f12_towers(base, xi):
    """F2 = base[u]/(u^2 + 1), F6 = F2[v]/(v^3 - xi), F12 = F6[w]/(w^2 - v)
    over a base adapter; returns (F2, F6, F12, mul_xi)."""
    F2 = F2Device(base, base.neg)
    mul_xi = xi_mul(base, xi)
    F6 = F3Device(F2, mul_xi)

    def mul_nr12(a):  # (a0, a1, a2) in F6 -> (xi a2, a0, a1)
        return (mul_xi(a[2]), a[0], a[1])

    return F2, F6, F2Device(F6, mul_nr12), mul_xi


def mnt_towers(base, nr: int = 11):
    """MNT6753's F3 = base[v]/(v^3 - nr) and F6 = F3[w]/(w^2 - v) over a
    base adapter (tower_pallas.py _mnt_towers); returns (F3, F6, mulv),
    mulv(a) = v a = (nr a2, a0, a1)."""
    def mul_nr(a):
        return base.mul_small(a, nr)

    def mulv(a):
        return (mul_nr(a[2]), a[0], a[1])

    F3 = F3Device(base, mul_nr)
    return F3, F2Device(F3, mulv), mulv


def _part(e, sl):
    """Entries `sl` of the stacked axis of a tower element."""
    if isinstance(e, tuple):
        return tuple(_part(c, sl) for c in e)
    return e[:, sl]


def gs_cyclotomic_square(B, mul_nr, f):
    """Granger-Scott cyclotomic squaring over the quadratic-over-cubic
    tower ((a0, a1, a2), (b0, b1, b2)) with w^2 = v, v^3 = nr: 9 squarings
    in B instead of a full square (build_bn128.js:980-1089).  It equals
    the square only on the cyclotomic subgroup; elsewhere it is the same
    polynomial map as the JAX package's."""
    (a0, a1, a2), (b0, b1, b2) = f
    xs, ys = stack(b1, a2, b2), stack(a0, b0, a1)
    sx, sy, sxy = unstack(B.square(stack(xs, ys, B.add(xs, ys))), 3)
    c_a0b1, c_a2b0, c_a1b2 = unstack(B.sub(B.sub(sxy, sx), sy), 3)  # 2xy
    s_b1, s_a2, s_b2 = unstack(sx, 3)
    n_b1, n_a2, n_b2, t8 = unstack(mul_nr(stack(s_b1, s_a2, s_b2, c_a1b2)), 4)
    t0, t2, t4 = unstack(B.add(stack(n_b1, n_a2, n_b2), sy), 3)
    t = stack(t0, t2, t4, t8, c_a0b1, c_a2b0)
    t3 = B.add(B.add(t, t), t)
    c = stack(a0, a1, a2, b0, b1, b2)
    c2 = B.add(c, c)
    a = B.sub(_part(t3, slice(0, 3)), _part(c2, slice(0, 3)))
    b = B.add(_part(t3, slice(3, 6)), _part(c2, slice(3, 6)))
    return tuple(unstack(a, 3)), tuple(unstack(b, 3))
