"""Host "protoboard" oracle: pure-Python bigint arithmetic for every field.

This is the moral equivalent of the reference's src/protoboard.js test
harness + the semantics of build_f1m/f2m/f3m: a slow-but-obviously-correct
mirror of every device kernel, used (a) as the property-test oracle for the
Pallas/JAX kernels and (b) for latency-insignificant scalar work (proof
assembly, verification pairings in round 1).

All values are canonical (not Montgomery); Montgomery form only exists at
serialization boundaries and inside device kernels.  The math is identical:
wasmsnark's Montgomery ops compute the same field elements.

Extension towers mirror the reference's composition pattern, where a tower is
parameterized by a "multiply by non-residue" callback (build_f2m.js /
build_f3m.js take `mulNonResidueFn`):

    F2(base, mul_nr)  ~ build_f2m.js  (x = x0 + x1*u,  u^2 = nr)
    F3(base, mul_nr)  ~ build_f3m.js  (x = x0 + x1*v + x2*v^2,  v^3 = nr)

Elements of extensions are tuples of base elements, so F12 elements for BN128
are nested tuples ((a,b,c),(d,e,f)) of F2 pairs, same shape as the reference's
flat 12-coordinate memory layout.
"""

from __future__ import annotations

from .spec import FieldSpec


class Fp:
    """Prime field, canonical representation. Mirrors build_f1m semantics."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.q = spec.q

    # element type: int in [0, q)
    def zero(self):
        return 0

    def one(self):
        return 1

    def elem(self, a: int):
        return a % self.q

    def add(self, a, b):
        r = a + b
        return r - self.q if r >= self.q else r

    def sub(self, a, b):
        r = a - b
        return r + self.q if r < 0 else r

    def neg(self, a):
        return (self.q - a) % self.q

    def mul(self, a, b):
        return a * b % self.q

    def square(self, a):
        return a * a % self.q

    def inv(self, a):
        return pow(a, -1, self.q)

    def exp(self, a, e: int):
        return pow(a, e, self.q)

    def eq(self, a, b):
        return a == b

    def is_zero(self, a):
        return a == 0

    def conjugate(self, a):
        return a

    def mul_scalar(self, a, s: int):
        return a * (s % self.q) % self.q

    def is_negative(self, a):
        """Reference f1m_isNegative: canonical value > (q-1)/2
        (build_f1.js:78-88 semantics used by sqrt sign-normalization)."""
        return a > self.spec.half

    def sqrt(self, a):
        return self.spec.sqrt(a)

    def is_square(self, a):
        return self.spec.is_square(a)

    def rand_like(self):  # pragma: no cover - convenience
        import random
        return random.randrange(self.q)


class F2:
    """Quadratic extension x0 + x1*u with u^2 = nr (build_f2m.js).

    `mul_nr` is a callback on base elements, exactly like the reference's
    `mulNonResidueFn` prefix-callback, so towers compose (F12 = F2 over F6).
    """

    def __init__(self, base, mul_nr):
        self.base = base
        self.mul_nr = mul_nr

    def zero(self):
        return (self.base.zero(), self.base.zero())

    def one(self):
        return (self.base.one(), self.base.zero())

    def elem(self, pair):
        return tuple(pair)

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def conjugate(self, a):
        return (a[0], self.base.neg(a[1]))

    def mul(self, a, b):
        # Karatsuba 3M (build_f2m.js:127-163)
        F = self.base
        m0 = F.mul(a[0], b[0])
        m1 = F.mul(a[1], b[1])
        t = F.mul(F.add(a[0], a[1]), F.add(b[0], b[1]))
        return (F.add(m0, self.mul_nr(m1)), F.sub(F.sub(t, m0), m1))

    def square(self, a):
        # complex-style 2M (build_f2m.js:186-227)
        F = self.base
        ab = F.mul(a[0], a[1])
        t = F.mul(F.add(a[0], a[1]), F.add(a[0], self.mul_nr(a[1])))
        return (F.sub(F.sub(t, ab), self.mul_nr(ab)), F.add(ab, ab))

    def mul_base(self, a, b_base):
        """mul1: multiply by a base-field element (build_f2m.js:165-184)."""
        F = self.base
        return (F.mul(a[0], b_base), F.mul(a[1], b_base))

    def inv(self, a):
        # via norm (build_f2m.js:353-383)
        F = self.base
        t = F.sub(F.square(a[0]), self.mul_nr(F.square(a[1])))
        ti = F.inv(t)
        return (F.mul(a[0], ti), F.neg(F.mul(a[1], ti)))

    def eq(self, a, b):
        return self.base.eq(a[0], b[0]) and self.base.eq(a[1], b[1])

    def is_zero(self, a):
        return self.base.is_zero(a[0]) and self.base.is_zero(a[1])

    def exp(self, a, e: int):
        return _generic_exp(self, a, e)

    def mul_scalar(self, a, s: int):
        return (self.base.mul_scalar(a[0], s), self.base.mul_scalar(a[1], s))


class F3:
    """Cubic extension x0 + x1*v + x2*v^2 with v^3 = nr (build_f3m.js)."""

    def __init__(self, base, mul_nr):
        self.base = base
        self.mul_nr = mul_nr

    def zero(self):
        z = self.base.zero()
        return (z, z, z)

    def one(self):
        return (self.base.one(), self.base.zero(), self.base.zero())

    def elem(self, t):
        return tuple(t)

    def add(self, a, b):
        F = self.base
        return (F.add(a[0], b[0]), F.add(a[1], b[1]), F.add(a[2], b[2]))

    def sub(self, a, b):
        F = self.base
        return (F.sub(a[0], b[0]), F.sub(a[1], b[1]), F.sub(a[2], b[2]))

    def neg(self, a):
        F = self.base
        return (F.neg(a[0]), F.neg(a[1]), F.neg(a[2]))

    def mul(self, a, b):
        # Karatsuba-style 6M (build_f3m.js:125-189)
        F = self.base
        nr = self.mul_nr
        v0 = F.mul(a[0], b[0])
        v1 = F.mul(a[1], b[1])
        v2 = F.mul(a[2], b[2])
        t01 = F.mul(F.add(a[0], a[1]), F.add(b[0], b[1]))
        t12 = F.mul(F.add(a[1], a[2]), F.add(b[1], b[2]))
        t02 = F.mul(F.add(a[0], a[2]), F.add(b[0], b[2]))
        c0 = F.add(v0, nr(F.sub(F.sub(t12, v1), v2)))
        c1 = F.add(F.sub(F.sub(t01, v0), v1), nr(v2))
        c2 = F.add(F.sub(F.sub(t02, v0), v2), v1)
        return (c0, c1, c2)

    def square(self, a):
        # CH-SQR3 (build_f3m.js:191-241)
        F = self.base
        nr = self.mul_nr
        s0 = F.square(a[0])
        ab = F.mul(a[0], a[1])
        s1 = F.add(ab, ab)
        s2 = F.square(F.add(F.sub(a[0], a[1]), a[2]))
        bc = F.mul(a[1], a[2])
        s3 = F.add(bc, bc)
        s4 = F.square(a[2])
        c0 = F.add(s0, nr(s3))
        c1 = F.add(s1, nr(s4))
        c2 = F.sub(F.add(F.add(s1, s2), s3), F.add(s0, s4))
        return (c0, c1, c2)

    def mul_base(self, a, b_base):
        F = self.base
        return (F.mul(a[0], b_base), F.mul(a[1], b_base), F.mul(a[2], b_base))

    def mul_by_1(self, a, c1):
        """Sparse multiply a * (c1 v): 3 base muls instead of the dense 6
        (the reference's f6m_mul1, build_bls12381.js:577-741)."""
        F = self.base
        return (self.mul_nr(F.mul(a[2], c1)), F.mul(a[0], c1),
                F.mul(a[1], c1))

    def mul_by_01(self, a, c0, c1):
        """Sparse multiply a * (c0 + c1 v): 6 base muls
        (the reference's f6m_mul01, build_bls12381.js:577-741)."""
        F = self.base
        r0 = F.add(F.mul(a[0], c0), self.mul_nr(F.mul(a[2], c1)))
        r1 = F.add(F.mul(a[0], c1), F.mul(a[1], c0))
        r2 = F.add(F.mul(a[1], c1), F.mul(a[2], c0))
        return (r0, r1, r2)

    def inv(self, a):
        # adjugate method (build_f3m.js:389-444)
        F = self.base
        nr = self.mul_nr
        t0 = F.square(a[0])
        t1 = F.square(a[1])
        t2 = F.square(a[2])
        t3 = F.mul(a[0], a[1])
        t4 = F.mul(a[0], a[2])
        t5 = F.mul(a[1], a[2])
        c0 = F.sub(t0, nr(t5))
        c1 = F.sub(nr(t2), t3)
        c2 = F.sub(t1, t4)
        t6 = F.add(F.mul(a[0], c0), nr(F.add(F.mul(a[2], c1), F.mul(a[1], c2))))
        t6i = F.inv(t6)
        return (F.mul(c0, t6i), F.mul(c1, t6i), F.mul(c2, t6i))

    def eq(self, a, b):
        return all(self.base.eq(x, y) for x, y in zip(a, b))

    def is_zero(self, a):
        return all(self.base.is_zero(x) for x in a)

    def exp(self, a, e: int):
        return _generic_exp(self, a, e)

    def mul_scalar(self, a, s: int):
        return tuple(self.base.mul_scalar(x, s) for x in a)


def frobenius12(F2, xi, q, f, power=1):
    """f^(q^power) for f in the quadratic-over-cubic tower
    F12 = F6[w]/(w^2 - v), F6 = F2[v]/(v^3 - xi): per-component F2
    conjugation (odd powers; q = 3 mod 4 so u^q = -u) plus multiplication
    by the gamma coefficients xi^(k (q^power - 1)/6) for the component at
    power k of xi^(1/6) — the reference's precomputed gamma tables,
    validated against exp-by-q^i exactly as its tests do
    (build_bn128.js:838-939, build_bls12381.js:857-961,
    test/bn128.js Frobenius-vs-exp pattern)."""
    (a0, a1, a2), (b0, b1, b2) = f
    e = (q ** power - 1) // 6
    g = [F2.exp(xi, k * e) for k in range(1, 6)]
    if power % 2 == 1:
        conj = F2.conjugate
        a0, a1, a2 = conj(a0), conj(a1), conj(a2)
        b0, b1, b2 = conj(b0), conj(b1), conj(b2)
    return ((a0, F2.mul(a1, g[1]), F2.mul(a2, g[3])),
            (F2.mul(b0, g[0]), F2.mul(b1, g[2]), F2.mul(b2, g[4])))


def gs_cyclotomic_square(B, mul_nr, f):
    """Granger-Scott cyclotomic squaring of f in the quadratic-over-cubic
    tower ((a0, a1, a2), (b0, b1, b2)), w^2 = v, v^3 = nr, over the oracle
    field B: 9 squarings in B instead of a full square
    (__cyclotomicSquare, build_bn128.js:980-1089).  It equals the square
    only on the cyclotomic subgroup; elsewhere it is the same polynomial
    map as the device version's (ops/towers.py)."""
    (a0, a1, a2), (b0, b1, b2) = f

    def two(x):
        return B.add(x, x)

    def three(x):
        return B.add(two(x), x)

    def sq2(x, y):
        """(x^2, y^2, 2xy), the cross term from one more squaring."""
        sx, sy = B.square(x), B.square(y)
        return sx, sy, B.sub(B.sub(B.square(B.add(x, y)), sx), sy)

    s_b1, s_a0, c_a0b1 = sq2(b1, a0)
    s_a2, s_b0, c_a2b0 = sq2(a2, b0)
    s_b2, s_a1, c_a1b2 = sq2(b2, a1)
    t0 = B.add(mul_nr(s_b1), s_a0)
    t2 = B.add(mul_nr(s_a2), s_b0)
    t4 = B.add(mul_nr(s_b2), s_a1)
    t8 = mul_nr(c_a1b2)
    return ((B.sub(three(t0), two(a0)), B.sub(three(t2), two(a1)),
             B.sub(three(t4), two(a2))),
            (B.add(three(t8), two(b0)), B.add(three(c_a0b1), two(b1)),
             B.add(three(c_a2b0), two(b2))))


def _generic_exp(F, a, e: int):
    """Square-and-multiply ladder, MSB first (build_timesscalar.js)."""
    if e < 0:
        a = F.inv(a)
        e = -e
    r = F.one()
    for bit in bin(e)[2:]:
        r = F.square(r)
        if bit == "1":
            r = F.mul(r, a)
    return r


def flatten(x):
    """Flatten a nested tower element into a flat list of base-field ints,
    in the reference's memory order (component-major, low first)."""
    if isinstance(x, tuple):
        out = []
        for c in x:
            out.extend(flatten(c))
        return out
    return [x]


def unflatten(shape, flat):
    """Inverse of flatten given a template `shape` (nested tuple of 0s)."""
    it = iter(flat)

    def rec(s):
        if isinstance(s, tuple):
            return tuple(rec(c) for c in s)
        return next(it)

    return rec(shape)
