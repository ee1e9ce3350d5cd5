"""Short Weierstrass curves y^2 = x^3 + b in Jacobian coordinates
(x = X/Z^2, y = Y/Z^3) over any field of reference/fields.py.  Zero is
(0, 1, 0).  `FixedBase` multiplies one point by many scalars through a
table of its windowed multiples."""

from __future__ import annotations


class Jacobian:
    def __init__(self, F):
        self.F = F

    def zero(self):
        return (self.F.zero(), self.F.one(), self.F.zero())

    def is_zero(self, p):
        return self.F.is_zero(p[2])

    def from_affine(self, x, y):
        return (x, y, self.F.one())

    def neg(self, p):
        return (p[0], self.F.neg(p[1]), p[2])

    def double(self, p):
        F = self.F
        if self.is_zero(p):
            return p
        X, Y, Z = p
        A, B = F.square(X), F.square(Y)
        C = F.square(B)
        D = F.sub(F.sub(F.square(F.add(X, B)), A), C)
        D = F.add(D, D)
        E = F.add(F.add(A, A), A)
        X3 = F.sub(F.square(E), F.add(D, D))
        C8 = F.mul_scalar(C, 8)
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
        YZ = F.mul(Y, Z)
        return (X3, Y3, F.add(YZ, YZ))

    def add(self, p, q):
        F = self.F
        if self.is_zero(p):
            return q
        if self.is_zero(q):
            return p
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1, Z2Z2 = F.square(Z1), F.square(Z2)
        U1, U2 = F.mul(X1, Z2Z2), F.mul(X2, Z1Z1)
        S1 = F.mul(Y1, F.mul(Z2, Z2Z2))
        S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
        if F.eq(U1, U2):
            return self.double(p) if F.eq(S1, S2) else self.zero()
        H = F.sub(U2, U1)
        I = F.square(F.add(H, H))
        J = F.mul(H, I)
        r = F.sub(S2, S1)
        r = F.add(r, r)
        V = F.mul(U1, I)
        X3 = F.sub(F.sub(F.square(r), J), F.add(V, V))
        S1J = F.mul(S1, J)
        Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.add(S1J, S1J))
        Z3 = F.mul(F.sub(F.sub(F.square(F.add(Z1, Z2)), Z1Z1), Z2Z2), H)
        return (X3, Y3, Z3)

    def eq(self, p, q):
        return self.is_zero(self.add(p, self.neg(q)))

    def affine(self, p):
        """(x, y) of a point, or None for zero."""
        F = self.F
        if self.is_zero(p):
            return None
        zi = F.inv(p[2])
        zi2 = F.square(zi)
        return (F.mul(p[0], zi2), F.mul(p[1], F.mul(zi, zi2)))

    def on_curve(self, xy, b) -> bool:
        F = self.F
        x, y = xy
        return F.eq(F.square(y), F.add(F.mul(F.square(x), x), b))

    def times_scalar(self, p, s: int):
        if s < 0:
            p, s = self.neg(p), -s
        r = self.zero()
        for bit in bin(s)[2:]:
            r = self.double(r)
            if bit == "1":
                r = self.add(r, p)
        return r


class FixedBase:
    """k * P for one P and many k < 2^bits: a table of d * 2^(c w) * P for
    every c-bit window w and digit d, so a product costs one add a
    window."""

    def __init__(self, curve, p, bits: int, c: int = 8):
        self.curve, self.c = curve, c
        self.windows = -(-bits // c)
        self.table = []
        base = p
        for _ in range(self.windows):
            row = [curve.zero(), base]
            for _ in range((1 << c) - 2):
                row.append(curve.add(row[-1], base))
            self.table.append(row)
            base = curve.add(row[-1], base)

    def mul(self, k: int):
        C, c, mask = self.curve, self.c, (1 << self.c) - 1
        if k >> (c * self.windows):
            raise ValueError("scalar wider than the table")
        acc = C.zero()
        for w in range(self.windows):
            d = (k >> (c * w)) & mask
            if d:
                acc = C.add(acc, self.table[w][d])
        return acc
