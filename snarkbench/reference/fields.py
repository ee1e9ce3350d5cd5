"""Prime fields and their extension towers on plain Python integers.

Elements are canonical: an int in [0, q) for the prime field, tuples of
base elements for an extension.  A tower is built by a "multiply by the
non-residue" callback, so F12 = F2 over F6 = F3 over F2 = F2 over Fp."""

from __future__ import annotations


def exp(F, a, e: int):
    """Square-and-multiply, most significant bit first."""
    if e < 0:
        a, e = F.inv(a), -e
    r = F.one()
    for bit in bin(e)[2:]:
        r = F.square(r)
        if bit == "1":
            r = F.mul(r, a)
    return r


class Fp:
    def __init__(self, q: int):
        self.q = q

    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        return (a + b) % self.q

    def sub(self, a, b):
        return (a - b) % self.q

    def neg(self, a):
        return -a % self.q

    def mul(self, a, b):
        return a * b % self.q

    def square(self, a):
        return a * a % self.q

    def inv(self, a):
        return pow(a, -1, self.q)

    def mul_scalar(self, a, s: int):
        return a * s % self.q

    def conjugate(self, a):
        return a

    def eq(self, a, b):
        return a == b

    def is_zero(self, a):
        return a == 0

    def exp(self, a, e: int):
        return pow(a, e, self.q)


class F2:
    """x0 + x1 u with u^2 = nr."""

    def __init__(self, base, mul_nr):
        self.base = base
        self.mul_nr = mul_nr

    def zero(self):
        return (self.base.zero(), self.base.zero())

    def one(self):
        return (self.base.one(), self.base.zero())

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def conjugate(self, a):
        return (a[0], self.base.neg(a[1]))

    def mul(self, a, b):
        F = self.base
        m0, m1 = F.mul(a[0], b[0]), F.mul(a[1], b[1])
        t = F.mul(F.add(a[0], a[1]), F.add(b[0], b[1]))
        return (F.add(m0, self.mul_nr(m1)), F.sub(F.sub(t, m0), m1))

    def square(self, a):
        return self.mul(a, a)

    def inv(self, a):
        F = self.base
        t = F.inv(F.sub(F.square(a[0]), self.mul_nr(F.square(a[1]))))
        return (F.mul(a[0], t), F.neg(F.mul(a[1], t)))

    def mul_scalar(self, a, s: int):
        return (self.base.mul_scalar(a[0], s), self.base.mul_scalar(a[1], s))

    def eq(self, a, b):
        return self.base.eq(a[0], b[0]) and self.base.eq(a[1], b[1])

    def is_zero(self, a):
        return self.base.is_zero(a[0]) and self.base.is_zero(a[1])

    def exp(self, a, e: int):
        return exp(self, a, e)


class F3:
    """x0 + x1 v + x2 v^2 with v^3 = nr."""

    def __init__(self, base, mul_nr):
        self.base = base
        self.mul_nr = mul_nr

    def zero(self):
        z = self.base.zero()
        return (z, z, z)

    def one(self):
        return (self.base.one(), self.base.zero(), self.base.zero())

    def add(self, a, b):
        return tuple(self.base.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.base.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        return tuple(self.base.neg(x) for x in a)

    def mul(self, a, b):
        F, nr = self.base, self.mul_nr
        v0, v1, v2 = F.mul(a[0], b[0]), F.mul(a[1], b[1]), F.mul(a[2], b[2])
        t01 = F.mul(F.add(a[0], a[1]), F.add(b[0], b[1]))
        t12 = F.mul(F.add(a[1], a[2]), F.add(b[1], b[2]))
        t02 = F.mul(F.add(a[0], a[2]), F.add(b[0], b[2]))
        return (F.add(v0, nr(F.sub(F.sub(t12, v1), v2))),
                F.add(F.sub(F.sub(t01, v0), v1), nr(v2)),
                F.add(F.sub(F.sub(t02, v0), v2), v1))

    def square(self, a):
        return self.mul(a, a)

    def inv(self, a):
        F, nr = self.base, self.mul_nr
        c0 = F.sub(F.square(a[0]), nr(F.mul(a[1], a[2])))
        c1 = F.sub(nr(F.square(a[2])), F.mul(a[0], a[1]))
        c2 = F.sub(F.square(a[1]), F.mul(a[0], a[2]))
        t = F.inv(F.add(F.mul(a[0], c0),
                        nr(F.add(F.mul(a[2], c1), F.mul(a[1], c2)))))
        return (F.mul(c0, t), F.mul(c1, t), F.mul(c2, t))

    def mul_scalar(self, a, s: int):
        return tuple(self.base.mul_scalar(x, s) for x in a)

    def eq(self, a, b):
        return all(self.base.eq(x, y) for x, y in zip(a, b))

    def is_zero(self, a):
        return all(self.base.is_zero(x) for x in a)

    def exp(self, a, e: int):
        return exp(self, a, e)
