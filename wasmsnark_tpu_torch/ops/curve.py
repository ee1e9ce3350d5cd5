"""Branch-free batched group laws, PyTorch port of wasmsnark_tpu/ops/curve.py
(JacobianDevice for a = 0, ProjectiveDevice for a != 0, map_leaf).

Points are (X, Y, Z) tuples of field elements (tower tuples compose); zero
is any Z = 0, canonical (0, one, 0).  Every degenerate case (zero
operands, P == Q, P == -Q) is resolved per lane with masked selects.  Both
devices also give neg, sub, eq, cneg (the sign of a signed-digit pick),
double_times, promote and madd (an affine point, zero written (0, 0):
what ops/fixed_base.py sums), and `tree_reduce` sums a power-of-two lane
axis.

For the Jacobian G1 (base field Fp) the three operations are fused kernels:
K5 `jac_madd`, K6 `jac_add`, K7 `jac_double` (csrc/curve_kernels.cu; K7
doubles a given number of times in one launch, `double_times`).
Their plain versions are the composed formulas below evaluated over
`PlainFp`, pure PyTorch on any device.  G2 composes per-op over F2Device,
and ProjectiveDevice (MNT6753 G1) over any field adapter, as in the JAX
package, where neither has a kernel of its own.
"""

from __future__ import annotations

import torch

from ..fields.spec import FieldSpec
from . import cuda_lib
from .fp import PlainFp, check_cuda, lanes
from .towers import FpAdapter, stack, unstack


def map_leaf(x, fn):
    """Apply fn to each tensor leaf of a tower element (nested tuples)."""
    if isinstance(x, tuple):
        return tuple(map_leaf(c, fn) for c in x)
    return fn(x)


def map_leaf2(x, y, fn):
    """Apply fn to matching tensor leaves of two tower elements."""
    if isinstance(x, tuple):
        return tuple(map_leaf2(a, b, fn) for a, b in zip(x, y))
    return fn(x, y)


def host_points(F, p) -> list:
    """Device points (leaves [L, *B], Montgomery over the base field's
    FpDevice F) -> their host oracle points, B flattened: each coordinate
    an int, or over a tower a tuple of them.  One copy a leaf."""
    def coord(c):
        if isinstance(c, tuple):
            return list(zip(*(coord(cc) for cc in c)))
        return F.unpack_mont(c.reshape(c.shape[0], -1))
    return list(zip(*(coord(c) for c in p)))


class JacobianDevice:
    """y^2 = x^3 + b, a = 0 (BN128 G1 and G2)."""

    def __init__(self, field):
        self.F = field

    def is_zero(self, p):
        return self.F.is_zero(p[2])

    def zero_like(self, p):
        F = self.F
        return (F.zero_like(p[0]), F.one_like(p[1]), F.zero_like(p[2]))

    def select(self, mask, p, q):
        F = self.F
        return tuple(F.select(mask, a, b) for a, b in zip(p, q))

    def neg(self, p):
        """-p = (X, -Y, Z): one field negation of Y (on a kernel-backed G1
        a K2 sub from zero)."""
        return (p[0], self.F.neg(p[1]), p[2])

    def cneg(self, mask, p):
        """mask ? -p : p per lane, Y through the field's cneg (K4 on a
        kernel-backed field)."""
        return (p[0], self.F.cneg(mask, p[1]), p[2])

    def _fused_spec(self):
        """FieldSpec when the fused curve kernels apply (G1 over a kernel-
        backed Fp); tower curves and the plain field compose per op."""
        F = self.F
        if isinstance(F, FpAdapter) and not isinstance(F.fp, PlainFp):
            return F.fp.spec
        return None

    # -- composed formulas (the plain versions of K5-K7 over PlainFp) ---------
    #
    # Independent field products and sums are stacked into one call (a new
    # batch axis), which cuts the calls, and on the card the launches, of a
    # point operation about in half; the values are those of the JAX
    # package's formulas.

    def _raw_double(self, p):
        # dbl-2009-l; yields Z3 = 0 for Z = 0
        F = self.F
        X, Y, Z = p
        A, B, YZ = unstack(F.mul(stack(X, Y, Y), stack(X, Y, Z)), 3)
        XB = F.add(X, B)
        E = F.add(F.add(A, A), A)
        C, T, G = unstack(F.square(stack(B, XB, E)), 3)
        D = F.sub(F.sub(T, A), C)
        D2, C2, Z3 = unstack(F.add(stack(D, C, YZ), stack(D, C, YZ)), 3)
        X3 = F.sub(G, F.add(D2, D2))
        C4 = F.add(C2, C2)
        Y3 = F.sub(F.mul(E, F.sub(D2, X3)), F.add(C4, C4))
        return (X3, Y3, Z3)

    def _finish(self, p, q_is_zero, q_jac, gen, H, r):
        """The masks of the complete law, in the Pallas kernels' order."""
        F = self.F
        h_zero = F.is_zero(H)
        r_zero = F.is_zero(r)
        out = self.select(h_zero & r_zero, self._raw_double(p), gen)
        out = self.select(h_zero & ~r_zero, self.zero_like(p), out)
        out = self.select(q_is_zero, p, out)
        return self.select(self.is_zero(p), q_jac, out)

    def double_composed(self, p):
        return self.select(self.is_zero(p), p, self._raw_double(p))

    def add_composed(self, p, q):
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1, Z2Z2 = unstack(F.square(stack(Z1, Z2)), 2)
        U1, U2, Z2c, Z1c = unstack(F.mul(stack(X1, X2, Z2, Z1),
                                         stack(Z2Z2, Z1Z1, Z2Z2, Z1Z1)), 4)
        S1, S2 = unstack(F.mul(stack(Y1, Y2), stack(Z2c, Z1c)), 2)
        H, r = unstack(F.sub(stack(U2, S2), stack(U1, S1)), 2)
        r, HH, z12 = unstack(F.add(stack(r, H, Z1), stack(r, H, Z2)), 3)
        I, rr, z12s = unstack(F.square(stack(HH, r, z12)), 3)
        J, V = unstack(F.mul(stack(H, U1), stack(I, I)), 2)
        X3 = F.sub(F.sub(rr, J), F.add(V, V))
        S1J, rv = unstack(F.mul(stack(S1, r), stack(J, F.sub(V, X3))), 2)
        Y3 = F.sub(rv, F.add(S1J, S1J))
        Z3 = F.mul(F.sub(F.sub(z12s, Z1Z1), Z2Z2), H)
        return self._finish(p, self.is_zero(q), q, (X3, Y3, Z3), H, r)

    def madd_composed(self, p, q):
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2 = q
        Z1Z1 = F.square(Z1)
        U2, Z1c = unstack(F.mul(stack(X2, Z1), stack(Z1Z1, Z1Z1)), 2)
        S2 = F.mul(Y2, Z1c)
        H, r = unstack(F.sub(stack(U2, S2), stack(X1, Y1)), 2)
        r, HH, Z1d = unstack(F.add(stack(r, H, Z1), stack(r, H, Z1)), 3)
        I, rr = unstack(F.square(stack(HH, r)), 2)
        J, V = unstack(F.mul(stack(H, X1), stack(I, I)), 2)
        X3 = F.sub(F.sub(rr, J), F.add(V, V))
        S1J, rv, Z3 = unstack(F.mul(stack(Y1, r, Z1d),
                                    stack(J, F.sub(V, X3), H)), 3)
        Y3 = F.sub(rv, F.add(S1J, S1J))
        return self._finish(p, self.is_zero_affine(q), self.promote(q),
                            (X3, Y3, Z3), H, r)

    # -- the group law --------------------------------------------------------

    def double(self, p):
        return self.double_times(p, 1)

    def double_times(self, p, times: int):
        """p doubled `times` times: one K7 launch on a kernel-backed G1,
        else `times` composed doublings."""
        spec = self._fused_spec()
        if spec is not None:
            return jac_double(spec, p, times)
        for _ in range(times):
            p = self.double_composed(p)
        return p

    def add(self, p, q):
        spec = self._fused_spec()
        if spec is not None:
            return jac_add(spec, p, q)
        return self.add_composed(p, q)

    def sub(self, p, q):
        return self.add(p, self.neg(q))

    def eq(self, p, q):
        """Cross-normalised equality (build_curve_jacobian_a0.js:115-172):
        X1 Z2^2 = X2 Z1^2 and Y1 Z2^3 = Y2 Z1^3, or both zero."""
        F = self.F
        Z1Z1, Z2Z2 = unstack(F.square(stack(p[2], q[2])), 2)
        U1, U2, Z2c, Z1c = unstack(F.mul(stack(p[0], q[0], q[2], p[2]),
                                         stack(Z2Z2, Z1Z1, Z2Z2, Z1Z1)), 4)
        S1, S2 = unstack(F.mul(stack(p[1], q[1]), stack(Z2c, Z1c)), 2)
        pz, qz = self.is_zero(p), self.is_zero(q)
        return (F.eq(U1, U2) & F.eq(S1, S2) & ~(pz ^ qz)) | (pz & qz)

    def tree_reduce(self, p, axis_size: int):
        """Sum 2^k points along the last batch axis by halving (log depth,
        one add a level: K6 on a kernel-backed G1).  Leaves [..., axis_size]
        -> [..., 1]."""
        return tree_reduce(self, p, axis_size)

    def madd(self, p, q):
        """Complete mixed addition: p Jacobian + q affine (X, Y), with the
        affine zero written (0, 0)."""
        spec = self._fused_spec()
        if spec is not None:
            return jac_madd(spec, p, q)
        return self.madd_composed(p, q)

    def is_zero_affine(self, q):
        return self.F.is_zero(q[0]) & self.F.is_zero(q[1])

    def promote(self, q):
        """Affine (X, Y) -> (X, Y, 1), Jacobian or projective; (0, 0) ->
        (0, one, 0)."""
        F = self.F
        zero = self.is_zero_affine(q)
        return (q[0],
                F.select(zero, F.one_like(q[1]), q[1]),
                F.select(zero, F.zero_like(q[0]), F.one_like(q[0])))


class ProjectiveDevice:
    """y^2 = x^3 + a x + b over any field adapter in projective coordinates
    (the JAX package's ProjectiveDevice, build_curve_projective.js): `mul_a`
    multiplies by a.  Zero is any Z = 0 (canonical (0, one, 0)); zero
    operands, P == Q and P == -Q are resolved per lane with masked selects.
    The formulas are the JAX package's, their independent products stacked
    into one field call each; canonical outputs are unique, so the values
    are its values."""

    def __init__(self, field, mul_a):
        self.F = field
        self.mul_a = mul_a

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

    def _raw_double(self, p):
        # build_curve_projective.js:202-288
        F = self.F
        X, Y, Z = p
        XX, ZZ, YZ = unstack(F.mul(stack(X, Z, Y), stack(X, Z, Z)), 3)
        w = F.add(self.mul_a(ZZ), F.add(F.add(XX, XX), XX))
        s = F.add(YZ, YZ)
        ss, R = unstack(F.mul(stack(s, Y), stack(s, s)), 2)
        XR_ = F.add(X, R)
        sss, RR, XR, ww = unstack(F.mul(stack(s, R, XR_, w),
                                        stack(ss, R, XR_, w)), 4)
        B = F.sub(F.sub(XR, XX), RR)
        h = F.sub(ww, F.add(B, B))
        X3, wBh = unstack(F.mul(stack(h, w), stack(s, F.sub(B, h))), 2)
        return (X3, F.sub(wBh, F.add(RR, RR)), sss)

    def double(self, p):
        return self.select(self.is_zero(p), p, self._raw_double(p))

    def double_times(self, p, times: int):
        for _ in range(times):
            p = self.double(p)
        return p

    def add(self, p, q):
        # add-1998-cmo-2 (build_curve_projective.js:291-408), complete
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Y1Z2, Y2Z1, X1Z2, X2Z1, ZZ = unstack(F.mul(
            stack(Y1, Y2, X1, X2, Z1), stack(Z2, Z1, Z2, Z1, Z2)), 5)
        u, v = unstack(F.sub(stack(Y2Z1, X2Z1), stack(Y1Z2, X1Z2)), 2)
        uu, vv = unstack(F.mul(stack(u, v), stack(u, v)), 2)
        vvv, R, uuZZ = unstack(F.mul(stack(v, vv, uu),
                                     stack(vv, X1Z2, ZZ)), 3)
        A = F.sub(uuZZ, F.add(vvv, F.add(R, R)))
        X3, uRA, vvvY, Z3 = unstack(F.mul(
            stack(v, u, vvv, vvv), stack(A, F.sub(R, A), Y1Z2, ZZ)), 4)
        gen = (X3, F.sub(uRA, vvvY), Z3)
        v_zero, u_zero = F.is_zero(v), F.is_zero(u)
        out = self.select(v_zero & u_zero, self._raw_double(p), gen)
        out = self.select(v_zero & ~u_zero, self.zero_like(p), out)
        out = self.select(self.is_zero(q), p, out)
        return self.select(self.is_zero(p), q, out)

    def madd(self, p, q):
        """p projective + q affine (X, Y), the affine zero written (0,
        0): the complete add of q promoted."""
        return self.add(p, self.promote(q))

    # the same in both coordinate systems: an affine point is (X, Y, 1)
    is_zero_affine = JacobianDevice.is_zero_affine
    promote = JacobianDevice.promote
    tree_reduce = JacobianDevice.tree_reduce

    def sub(self, p, q):
        return self.add(p, self.neg(q))

    def cneg(self, mask, p):
        return (p[0], self.F.cneg(mask, p[1]), p[2])

    def eq(self, p, q):
        F = self.F
        ex = F.eq(F.mul(p[0], q[2]), F.mul(q[0], p[2]))
        ey = F.eq(F.mul(p[1], q[2]), F.mul(q[1], p[2]))
        pz, qz = self.is_zero(p), self.is_zero(q)
        return (ex & ey & ~(pz ^ qz)) | (pz & qz)


def tree_reduce(curve, p, axis_size: int):
    """Sum 2^k points of any curve device along the last batch axis by
    halving: leaves [..., axis_size] -> [..., 1]."""
    n = axis_size
    if n & (n - 1):
        raise ValueError("tree_reduce needs a power-of-two axis")
    while n > 1:
        half = n // 2
        p = curve.add(map_leaf(p, lambda a: a[..., :half]),
                      map_leaf(p, lambda a: a[..., half:n]))
        n = half
    return p


# ---------------------------------------------------------------------------
# kernel wrappers K5-K7 and their plain versions
# ---------------------------------------------------------------------------

def _plain_curve(spec: FieldSpec, device) -> JacobianDevice:
    return JacobianDevice(FpAdapter(PlainFp(spec, device)))


def jac_madd_plain(spec: FieldSpec, p, q):
    return _plain_curve(spec, p[0].device).madd_composed(p, q)


def jac_add_plain(spec: FieldSpec, p, q):
    return _plain_curve(spec, p[0].device).add_composed(p, q)


def jac_double_plain(spec: FieldSpec, p, times: int = 1):
    return _plain_curve(spec, p[0].device).double_times(p, times)


def _curve_call(fn: str, plain, spec: FieldSpec, coords, split, ints=()):
    L = spec.n_limbs
    flat, bshape = lanes(L, *coords)
    if not flat[0].is_cuda:
        ins = (tuple(flat[:split]), tuple(flat[split:])) if split else \
            (tuple(flat),)
        out = plain(spec, *ins, *ints)
    else:
        check_cuda(*flat)
        out = tuple(torch.empty_like(flat[0]) for _ in range(3))
        cuda_lib.launch(fn, spec, (*flat, *out), (flat[0].shape[1], *ints))
    return tuple(o.reshape((L,) + bshape) for o in out)


def jac_madd(spec: FieldSpec, p, q):
    """K5: Jacobian + affine (replaces curve_pallas.py jac_madd_pallas)."""
    return _curve_call("k5_jac_madd", jac_madd_plain, spec, (*p, *q), 3)


def jac_add(spec: FieldSpec, p, q):
    """K6: Jacobian + Jacobian (replaces curve_pallas.py jac_add_pallas)."""
    return _curve_call("k6_jac_add", jac_add_plain, spec, (*p, *q), 3)


def jac_double(spec: FieldSpec, p, times: int = 1):
    """K7: p doubled `times` >= 1 times in one launch (replaces
    curve_pallas.py jac_double_pallas, run `times` times)."""
    if times < 1:
        raise ValueError("jac_double doubles at least once")
    return _curve_call("k7_jac_dbl", jac_double_plain, spec, tuple(p), 0,
                       (times,))

