"""Complete projective group law for a = 0, PyTorch port of
wasmsnark_tpu/ops/curve_complete.py (CompleteCurveDevice): the
Renes-Costello-Batina formulas ("Complete addition formulas for prime
order elliptic curves", EUROCRYPT 2016, Algorithm 7) for y^2 = x^3 + b in
homogeneous projective coordinates, with b3 = 3 b:

  X3 = (X1Y2+X2Y1)(Y1Y2-b3 Z1Z2) - b3(Y1Z2+Y2Z1)(X1Z2+X2Z1)
  Y3 = (Y1Y2+b3 Z1Z2)(Y1Y2-b3 Z1Z2) + 3X1X2 * b3(X1Z2+X2Z1)
  Z3 = (Y1Z2+Y2Z1)(Y1Y2+b3 Z1Z2) + (X1Y2+X2Y1) * 3X1X2

Equal points, inverses and zeros need no masks: completeness is algebraic.
Zero is (0, 1, 0) (any Z = 0).  The class works over any field adapter
(FpAdapter, F2Device); `mul_b3` multiplies by b3 (G1 of BN128: b3 = 9, a
chain of K2 adds; its twist: a full F2 product by 3 b').  The JAX class's
formula sequence is kept, its independent products and sums stacked into
one field call each, so a complete add is two stacked field products
(one K1 launch each over Fp, besides mul_b3's) and a few stacked adds, and
every coordinate equals the JAX class's, bit for bit (canonical values are
unique).
"""

from __future__ import annotations

from .towers import stack, unstack


class CompleteCurveDevice:
    """y^2 = x^3 + b over `field`, homogeneous projective, complete add."""

    def __init__(self, field, mul_b3):
        self.F = field
        self.mul_b3 = mul_b3

    def is_zero(self, p):
        return self.F.is_zero(p[2])

    def zero_like(self, p):
        F = self.F
        return (F.zero_like(p[0]), F.one_like(p[1]), F.zero_like(p[2]))

    def select(self, mask, p, q):
        F = self.F
        return tuple(F.select(mask, a, b) for a, b in zip(p, q))

    def neg(self, p):
        return (p[0], self.F.neg(p[1]), p[2])

    def add(self, p, q):
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        t0, t1, t2, t3, t4, t5 = unstack(F.mul(
            stack(X1, Y1, Z1, *unstack(F.add(stack(X1, Y1, X1),
                                             stack(Y1, Z1, Z1)), 3)),
            stack(X2, Y2, Z2, *unstack(F.add(stack(X2, Y2, X2),
                                             stack(Y2, Z2, Z2)), 3))), 6)
        # X1Y2 + X2Y1, Y1Z2 + Y2Z1, X1Z2 + X2Z1
        t3, t4, t5 = unstack(F.sub(
            stack(t3, t4, t5),
            F.add(stack(t0, t1, t0), stack(t1, t2, t2))), 3)
        three_t0 = F.add(F.add(t0, t0), t0)                 # 3 X1X2
        b3z, b3x = unstack(self.mul_b3(stack(t2, t5)), 2)
        s = F.add(t1, b3z)                                  # Y1Y2 + b3 Z1Z2
        d = F.sub(t1, b3z)                                  # Y1Y2 - b3 Z1Z2
        m = unstack(F.mul(stack(t3, t4, s, three_t0, t4, t3),
                          stack(d, b3x, d, b3x, s, three_t0)), 6)
        X3 = F.sub(m[0], m[1])
        Y3, Z3 = unstack(F.add(stack(m[2], m[4]), stack(m[3], m[5])), 2)
        return (X3, Y3, Z3)

    def double(self, p):
        return self.add(p, p)

    def eq(self, p, q):
        """Projective cross-compare: X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1, or
        both zero."""
        F = self.F
        a, b, c, d = unstack(F.mul(stack(p[0], q[0], p[1], q[1]),
                                   stack(q[2], p[2], q[2], p[2])), 4)
        pz, qz = self.is_zero(p), self.is_zero(q)
        return (F.eq(a, b) & F.eq(c, d) & ~(pz ^ qz)) | (pz & qz)
