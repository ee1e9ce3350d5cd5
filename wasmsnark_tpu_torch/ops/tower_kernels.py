"""Fused extension-tower and Miller-step kernels, PyTorch port of
wasmsnark_tpu/ops/tower_pallas.py (BN128, BLS12-381 and MNT6753).

    K8  f12_mul / f12_sqr   F12 = F6[w] Karatsuba product / square, xi an
                            argument (BN128 9 + u, BLS12-381 1 + u)
    K9  f12_cyc_sqr         Granger-Scott cyclotomic square
    K10 miller_dbl / miller_add
                            BN128's D-twist Miller doubling / mixed-add
                            step: the new homogeneous F2 point and the
                            sparse line (a0, b0, b1) evaluated at P
    K11 miller_dbl_mtwist / miller_add_mtwist
                            BLS12-381's M-twist steps: the same point, the
                            line (a0, b1, b2) = (xi c_y yP, c_0, c_x xP)
    K12 mnt_f6_mul / mnt_f6_sqr
                            MNT6753's F6 = F3[w] product / square
    K13 mnt_f6_cyc_sqr      MNT6753's Granger-Scott cyclotomic square
    K14 mnt_miller_dbl / mnt_miller_add
                            MNT6753's Miller steps on the a != 0 twist over
                            F3: the new projective point and the line
                            (a0, b) at P

Each wrapper launches its CUDA kernel (csrc/tower_kernels.cu for K8-K11,
csrc/mnt_kernels.cu for K12-K14) on CUDA tensors and runs its plain version
on CPU tensors.  The plain versions are the composed towers of
ops/towers.py over `PlainFp`, so chip_smoke.py can hold the kernels against
pure PyTorch on the card.

Operands go to a kernel stacked as one contiguous [k, L, n] tensor each:
an F12 element as its 12 component planes in `flatten12` order (the JAX
package's `_flatten12`), a Miller point as [6, L, n] (X, Y, Z), an affine
G2 point as [4, L, n], the G1 point as [2, L, n]; K8-K11 write
[12, L, n].  MNT6753's F6 element is its 6 planes in `flatten6` order, a
Miller point [9, L, n], an affine F3 point [6, L, n]; K12 and K13 write
[6, L, n], K14 [15, L, n].  Inputs with a batch shape ([L, 4, N] pairing lanes, [L, 1]
constants) are broadcast and flattened to lanes first.
"""

from __future__ import annotations

import functools

import torch

from ..fields.spec import FieldSpec
from . import cuda_lib
from .fp import DTYPE, PlainFp, check_cuda, lanes
from .towers import (FpAdapter, f12_towers, gs_cyclotomic_square,
                     mnt_towers, stack, unstack)

XI = (9, 1)          # BN128's sextic non-residue 9 + u
XI_BLS = (1, 1)      # BLS12-381's, 1 + u
N12 = 12


def flatten12(el) -> list:
    """F12 element -> its 12 planes, ((c00, c01), (c10, c11), (c20, c21))
    of each F6 half in turn."""
    return [p for half in el for c in half for p in c]


def unflatten12(flat):
    i = iter(flat)
    return tuple(tuple((next(i), next(i)) for _ in range(3)) for _ in range(2))


# ---------------------------------------------------------------------------
# Miller-step formulas (shared by the plain versions of K10 and by the
# prepared-coefficient ladder of ops/pairing.py)
# ---------------------------------------------------------------------------

def g2_dbl_coefs(F2, X, Y, Z):
    """Doubling step on homogeneous twist coordinates: the line
    coefficients (c_y, c_x, c_0) before P is applied, and the doubled
    point.  The line is scaled by 2YZ^2 (killed by the final
    exponentiation); the formulas of tower_pallas.py _miller_dbl_kernel,
    with the independent products stacked."""
    X2, Y2, Z2 = unstack(F2.square(stack(X, Y, Z)), 3)
    Y2Z, YZ2, X2Z, X3c, YZ, X4, Y3, Z3 = unstack(F2.mul(
        stack(Y2, Y, X2, X2, Y, X2, Y2, Z2),
        stack(Z, Z2, Z, X, Z, X2, Y, Z)), 8)
    XY2Z, X3cY2Z, X4X2, Y2Zsq, Y3Z3 = unstack(F2.mul(
        stack(X, X3c, X4, Y2Z, Y3), stack(Y2Z, Y2Z, X2, Y2Z, Z3)), 5)
    c_y, Y2Z_2, YZ_2 = unstack(F2.mul_small(stack(YZ2, Y2Z, YZ), 2), 3)
    X2Z_3, X3c_3 = unstack(F2.mul_small(stack(X2Z, X3c), 3), 2)
    XY2Z_8, Y2Zsq_8, Zn = unstack(F2.mul_small(stack(XY2Z, Y2Zsq, Y3Z3), 8), 3)
    c_0, t1, Yd = unstack(F2.sub(
        stack(X3c_3, F2.mul_small(X4, 9), F2.mul_small(X3cY2Z, 36)),
        stack(Y2Z_2, XY2Z_8, F2.mul_small(X4X2, 27))), 3)
    c_x = F2.neg(X2Z_3)
    Xn = F2.mul(YZ_2, t1)
    Yn = F2.sub(Yd, Y2Zsq_8)
    return (c_y, c_x, c_0), Xn, Yn, Zn


def g2_add_coefs(F2, X, Y, Z, x2, y2):
    """Mixed-add step (homogeneous + affine (x2, y2)): line coefficients
    and the sum, the formulas of tower_pallas.py _miller_add_kernel."""
    y2Z, x2Z = unstack(F2.mul(stack(y2, x2), stack(Z, Z)), 2)
    th, lm = unstack(F2.sub(stack(y2Z, x2Z), stack(Y, X)), 2)
    thx2, lmy2, C, D = unstack(F2.mul(stack(th, lm, th, lm),
                                      stack(x2, y2, th, lm)), 4)
    E, Fv, G = unstack(F2.mul(stack(lm, Z, X), stack(D, C, D)), 3)
    c_0 = F2.sub(thx2, lmy2)
    H = F2.sub(F2.sub(Fv, F2.add(G, G)), E)
    Xn, thGH, EY, Zn = unstack(F2.mul(stack(lm, th, E, Z),
                                      stack(H, F2.sub(G, H), Y, E)), 4)
    return (lm, F2.neg(th), c_0), Xn, F2.sub(thGH, EY), Zn


def line_at(F2, c_y, c_x, xP, yP):
    """(c_y, c_x) -> line slots a0 = c_y * yP, b0 = c_x * xP."""
    F = F2.base
    p = F.mul(stack(c_y[0], c_y[1], c_x[0], c_x[1]), stack(yP, yP, xP, xP))
    a00, a01, b00, b01 = unstack(p, 4)
    return (a00, a01), (b00, b01)


# ---------------------------------------------------------------------------
# plain versions: composed towers over PlainFp (any device)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def plain_towers(spec: FieldSpec, device: str, xi=XI):
    """(F2, F6, F12, mul_xi) over PlainFp on `device`."""
    return f12_towers(FpAdapter(PlainFp(spec, device)), xi)


def _towers_for(spec, plane, xi):
    return plain_towers(spec, str(plane.device), tuple(xi))


def f12_mul_plain(spec: FieldSpec, a, b, xi=XI):
    return _towers_for(spec, a[0][0][0], xi)[2].mul(a, b)


def f12_sqr_plain(spec: FieldSpec, a, xi=XI):
    return _towers_for(spec, a[0][0][0], xi)[2].square(a)


def f12_cyc_sqr_plain(spec: FieldSpec, a, xi=XI):
    F2, _, _, mul_xi = _towers_for(spec, a[0][0][0], xi)
    return gs_cyclotomic_square(F2, mul_xi, a)


def miller_dbl_plain(spec: FieldSpec, X, Y, Z, xP, yP):
    F2 = _towers_for(spec, xP, XI)[0]
    (c_y, c_x, c_0), Xn, Yn, Zn = g2_dbl_coefs(F2, X, Y, Z)
    a0, b0 = line_at(F2, c_y, c_x, xP, yP)
    return (a0, b0, c_0), Xn, Yn, Zn


def miller_add_plain(spec: FieldSpec, X, Y, Z, x2, y2, xP, yP):
    F2 = _towers_for(spec, xP, XI)[0]
    (c_y, c_x, c_0), Xn, Yn, Zn = g2_add_coefs(F2, X, Y, Z, x2, y2)
    a0, b0 = line_at(F2, c_y, c_x, xP, yP)
    return (a0, b0, c_0), Xn, Yn, Zn


def _mtwist_line(spec, step, xP, yP, xi):
    """M-twist slots of a step's (c_y, c_x, c_0): (a0, b1, b2) =
    (xi c_y yP, c_0, c_x xP), the line of tower_pallas.py
    _miller_*_mtwist_kernel."""
    F2, _, _, mul_xi = _towers_for(spec, xP, xi)
    (c_y, c_x, c_0), Xn, Yn, Zn = step
    a0, b2 = line_at(F2, mul_xi(c_y), c_x, xP, yP)
    return (a0, c_0, b2), Xn, Yn, Zn


def miller_dbl_mtwist_plain(spec: FieldSpec, X, Y, Z, xP, yP, xi=XI_BLS):
    F2 = _towers_for(spec, xP, xi)[0]
    return _mtwist_line(spec, g2_dbl_coefs(F2, X, Y, Z), xP, yP, xi)


def miller_add_mtwist_plain(spec: FieldSpec, X, Y, Z, x2, y2, xP, yP,
                            xi=XI_BLS):
    F2 = _towers_for(spec, xP, xi)[0]
    return _mtwist_line(spec, g2_add_coefs(F2, X, Y, Z, x2, y2), xP, yP, xi)


# ---------------------------------------------------------------------------
# kernel wrappers K8-K11
# ---------------------------------------------------------------------------

def _launch(fn: str, spec: FieldSpec, groups, ints=(), n_out=N12):
    """Stack each group of [L, n] planes into one [k, L, n] operand, launch
    `fn` and return the n_out output planes [L, n]."""
    ops = [torch.stack(g) for g in groups]
    check_cuda(*ops)
    n = ops[0].shape[2]
    out = torch.empty((n_out, spec.n_limbs, n), dtype=DTYPE,
                      device=ops[0].device)
    cuda_lib.launch(fn, spec, (*ops, out), (n, *ints))
    return list(out.unbind(0))


def _reshape(planes, L, bshape):
    return [p.reshape((L,) + bshape) for p in planes]


def f12_mul(spec: FieldSpec, a, b, xi=XI):
    """K8: F12 product (replaces tower_pallas.py f12_mul_pallas)."""
    L = spec.n_limbs
    flat, bshape = lanes(L, *flatten12(a), *flatten12(b))
    if not flat[0].is_cuda:
        out = flatten12(f12_mul_plain(spec, unflatten12(flat[:N12]),
                                      unflatten12(flat[N12:]), xi))
    else:
        out = _launch("k8_f12_mul", spec, [flat[:N12], flat[N12:]], xi)
    return unflatten12(_reshape(out, L, bshape))


def f12_sqr(spec: FieldSpec, a, xi=XI):
    """K8: F12 square (replaces tower_pallas.py f12_sqr_pallas)."""
    L = spec.n_limbs
    flat, bshape = lanes(L, *flatten12(a))
    if not flat[0].is_cuda:
        out = flatten12(f12_sqr_plain(spec, unflatten12(flat), xi))
    else:
        out = _launch("k8_f12_sqr", spec, [flat], xi)
    return unflatten12(_reshape(out, L, bshape))


def f12_cyc_sqr(spec: FieldSpec, a, xi=XI):
    """K9: Granger-Scott cyclotomic square (replaces tower_pallas.py
    f12_cyc_sqr_pallas)."""
    L = spec.n_limbs
    flat, bshape = lanes(L, *flatten12(a))
    if not flat[0].is_cuda:
        out = flatten12(f12_cyc_sqr_plain(spec, unflatten12(flat), xi))
    else:
        out = _launch("k9_f12_cyc_sqr", spec, [flat], xi)
    return unflatten12(_reshape(out, L, bshape))


def _step_out(out, L, bshape):
    o = _reshape(out, L, bshape)
    pairs = [(o[k], o[k + 1]) for k in range(0, N12, 2)]
    return tuple(pairs[:3]), pairs[3], pairs[4], pairs[5]


def _step_flat(step):
    (a0, b0, b1), Xn, Yn, Zn = step
    return [*a0, *b0, *b1, *Xn, *Yn, *Zn]


def miller_dbl(spec: FieldSpec, X, Y, Z, xP, yP):
    """K10: Miller doubling step (replaces tower_pallas.py
    miller_dbl_pallas, D-twist).  Returns ((a0, b0, b1), Xn, Yn, Zn)."""
    L = spec.n_limbs
    flat, bshape = lanes(L, *X, *Y, *Z, xP, yP)
    if not flat[0].is_cuda:
        f = flat
        out = _step_flat(miller_dbl_plain(
            spec, (f[0], f[1]), (f[2], f[3]), (f[4], f[5]), f[6], f[7]))
    else:
        out = _launch("k10_miller_dbl", spec, [flat[:6], flat[6:]])
    return _step_out(out, L, bshape)


def miller_add(spec: FieldSpec, X, Y, Z, x2, y2, xP, yP):
    """K10: Miller mixed-add step (replaces tower_pallas.py
    miller_add_pallas, D-twist).  Returns ((a0, b0, b1), Xn, Yn, Zn)."""
    L = spec.n_limbs
    flat, bshape = lanes(L, *X, *Y, *Z, *x2, *y2, xP, yP)
    if not flat[0].is_cuda:
        f = flat
        out = _step_flat(miller_add_plain(
            spec, (f[0], f[1]), (f[2], f[3]), (f[4], f[5]), (f[6], f[7]),
            (f[8], f[9]), f[10], f[11]))
    else:
        out = _launch("k10_miller_add", spec,
                      [flat[:6], flat[6:10], flat[10:]])
    return _step_out(out, L, bshape)


def miller_dbl_mtwist(spec: FieldSpec, X, Y, Z, xP, yP, xi=XI_BLS):
    """K11: M-twist Miller doubling step (replaces tower_pallas.py
    miller_dbl_pallas with mtwist=True).  Returns ((a0, b1, b2), Xn, Yn,
    Zn)."""
    L = spec.n_limbs
    flat, bshape = lanes(L, *X, *Y, *Z, xP, yP)
    if not flat[0].is_cuda:
        f = flat
        out = _step_flat(miller_dbl_mtwist_plain(
            spec, (f[0], f[1]), (f[2], f[3]), (f[4], f[5]), f[6], f[7], xi))
    else:
        out = _launch("k11_miller_dbl_mtwist", spec, [flat[:6], flat[6:]], xi)
    return _step_out(out, L, bshape)


def miller_add_mtwist(spec: FieldSpec, X, Y, Z, x2, y2, xP, yP, xi=XI_BLS):
    """K11: M-twist Miller mixed-add step (replaces tower_pallas.py
    miller_add_pallas with mtwist=True).  Returns ((a0, b1, b2), Xn, Yn,
    Zn)."""
    L = spec.n_limbs
    flat, bshape = lanes(L, *X, *Y, *Z, *x2, *y2, xP, yP)
    if not flat[0].is_cuda:
        f = flat
        out = _step_flat(miller_add_mtwist_plain(
            spec, (f[0], f[1]), (f[2], f[3]), (f[4], f[5]), (f[6], f[7]),
            (f[8], f[9]), f[10], f[11], xi))
    else:
        out = _launch("k11_miller_add_mtwist", spec,
                      [flat[:6], flat[6:10], flat[10:]], xi)
    return _step_out(out, L, bshape)


# ---------------------------------------------------------------------------
# MNT6753 (L = 48): F6 = F3[w]/(w^2 - v), F3 = Fp[v]/(v^3 - 11), and the
# Miller steps on the a != 0 twist (K12-K14)
# ---------------------------------------------------------------------------

MNT_NR = 11          # F3 non-residue; also G1's a and G2's a2 / v^2
N6, N15 = 6, 15


def flatten6(el) -> list:
    """F6 element ((a0, a1, a2), (b0, b1, b2)) -> its 6 planes."""
    return [*el[0], *el[1]]


def unflatten6(flat):
    return (tuple(flat[0:3]), tuple(flat[3:6]))


def mnt_dbl_coefs(F3, mulv, X, Y, Z, a_small=MNT_NR):
    """Doubling step on homogeneous F3 twist coordinates with a2 =
    a_small v^2: the line coefficients (c_y, c_x, c_0) = (2YZ^2, WZ,
    WX - 2Y^2Z), W = 3X^2 + a2 Z^2, and the doubled point.  The products of
    tower_pallas.py mnt_dbl_formula (the G2 half of the JAX package's
    Mnt6753PairingDevice._dbl_coefs), the independent ones stacked."""
    X2, Z2, Y2, YZ = unstack(F3.mul(stack(X, Z, Y, Y), stack(X, Z, Y, Z)), 4)
    Y2Z, YZ2, Y3, Z3, Y4 = unstack(F3.mul(stack(Y2, Y, Y2, Z2, Y2),
                                          stack(Z, Z2, Y, Z, Y2)), 5)
    W = F3.add(F3.mul_small(X2, 3), F3.mul_small(mulv(mulv(Z2)), a_small))
    WZ, WX, W2, XY2Z, Y3Z3, Y4Z2 = unstack(F3.mul(
        stack(W, W, W, X, Y3, Y4), stack(Z, X, W, Y2Z, Z3, Z2)), 6)
    c_y, Y2Z_2, YZ_2 = unstack(F3.mul_small(stack(YZ2, Y2Z, YZ), 2), 3)
    XY2Z_8, Zn, Y4Z2_8 = unstack(F3.mul_small(stack(XY2Z, Y3Z3, Y4Z2), 8), 3)
    Xn, WYn = unstack(F3.mul(
        stack(YZ_2, W),
        stack(F3.sub(W2, XY2Z_8), F3.sub(F3.mul_small(XY2Z, 12), W2))), 2)
    return (c_y, WZ, F3.sub(WX, Y2Z_2)), Xn, F3.sub(WYn, Y4Z2_8), Zn


def mnt_add_coefs(F3, X, Y, Z, x2, y2):
    """Mixed-add step (homogeneous + affine (x2, y2)): the line
    coefficients (c_y, c_x, c_0) = (lm, th, th x2 - y2 lm) and the sum, the
    products of tower_pallas.py mnt_add_formula."""
    y2Z, x2Z = unstack(F3.mul(stack(y2, x2), stack(Z, Z)), 2)
    th, lm = unstack(F3.sub(stack(y2Z, x2Z), stack(Y, X)), 2)
    thx2, y2lm, C, D = unstack(F3.mul(stack(th, y2, th, lm),
                                      stack(x2, lm, th, lm)), 4)
    E, Fv, G = unstack(F3.mul(stack(lm, Z, X), stack(D, C, D)), 3)
    H = F3.sub(F3.sub(Fv, F3.mul_small(G, 2)), E)
    Xn, thGH, EY, Zn = unstack(F3.mul(stack(lm, th, E, Z),
                                      stack(H, F3.sub(G, H), Y, E)), 4)
    return (lm, th, F3.sub(thx2, y2lm)), Xn, F3.sub(thGH, EY), Zn


def mnt_line(base, F3, c, xP, yP):
    """The sparse F6 line a0 + b w at P from (c_y, c_x, c_0):
    a0 = v^2 (c_y yP), b = c_0 - v (c_x xP) (the JAX package's
    _line_from_coefs; the same values as the line of mnt_dbl_formula and
    mnt_add_formula)."""
    c_y, c_x, c_0 = c
    y0, y1, y2, x0, x1, x2 = unstack(base.mul(
        stack(*c_y, *c_x), stack(yP, yP, yP, xP, xP, xP)), 6)
    n1, n2, nx = unstack(base.mul_small(stack(y1, y2, x2), MNT_NR), 3)
    return (n1, n2, y0), F3.sub(c_0, (nx, x0, x1))


def mnt_dbl_formula(base, F3, mulv, X, Y, Z, xP, yP):
    """tower_pallas.py mnt_dbl_formula: ((a0, b), X', Y', Z')."""
    c, Xn, Yn, Zn = mnt_dbl_coefs(F3, mulv, X, Y, Z)
    return mnt_line(base, F3, c, xP, yP), Xn, Yn, Zn


def mnt_add_formula(base, F3, mulv, X, Y, Z, x2, y2, xP, yP):
    """tower_pallas.py mnt_add_formula: ((a0, b), X', Y', Z')."""
    c, Xn, Yn, Zn = mnt_add_coefs(F3, X, Y, Z, x2, y2)
    return mnt_line(base, F3, c, xP, yP), Xn, Yn, Zn


@functools.lru_cache(maxsize=None)
def plain_mnt_towers(spec: FieldSpec, device: str):
    """(base, F3, F6, mulv) over PlainFp on `device`."""
    base = FpAdapter(PlainFp(spec, device))
    return (base, *mnt_towers(base, MNT_NR))


def _mnt_for(spec, plane):
    return plain_mnt_towers(spec, str(plane.device))


def mnt_f6_mul_plain(spec: FieldSpec, a, b):
    return _mnt_for(spec, a[0][0])[2].mul(a, b)


def mnt_f6_sqr_plain(spec: FieldSpec, a):
    return _mnt_for(spec, a[0][0])[2].square(a)


def mnt_f6_cyc_sqr_plain(spec: FieldSpec, a):
    base = _mnt_for(spec, a[0][0])[0]
    return gs_cyclotomic_square(base, lambda x: base.mul_small(x, MNT_NR), a)


def mnt_miller_dbl_plain(spec: FieldSpec, X, Y, Z, xP, yP):
    base, F3, _, mulv = _mnt_for(spec, xP)
    return mnt_dbl_formula(base, F3, mulv, X, Y, Z, xP, yP)


def mnt_miller_add_plain(spec: FieldSpec, X, Y, Z, x2, y2, xP, yP):
    base, F3, _, mulv = _mnt_for(spec, xP)
    return mnt_add_formula(base, F3, mulv, X, Y, Z, x2, y2, xP, yP)


def _f6_call(fn, plain, spec, els):
    """Flatten F6 operands to lanes, run K12/K13 or its plain version, and
    return the F6 result in the operands' batch shape."""
    L = spec.n_limbs
    flat, bshape = lanes(L, *[p for el in els for p in flatten6(el)])
    groups = [flat[k:k + N6] for k in range(0, len(flat), N6)]
    if not flat[0].is_cuda:
        out = flatten6(plain(spec, *[unflatten6(g) for g in groups]))
    else:
        out = _launch(fn, spec, groups, n_out=N6)
    return unflatten6(_reshape(out, L, bshape))


def mnt_f6_mul(spec: FieldSpec, a, b):
    """K12: F6 product (replaces tower_pallas.py mnt_f6_mul_pallas)."""
    return _f6_call("k12_f6_mul", mnt_f6_mul_plain, spec, (a, b))


def mnt_f6_sqr(spec: FieldSpec, a):
    """K12: F6 square (replaces tower_pallas.py mnt_f6_sqr_pallas)."""
    return _f6_call("k12_f6_sqr", mnt_f6_sqr_plain, spec, (a,))


def mnt_f6_cyc_sqr(spec: FieldSpec, a):
    """K13: Granger-Scott cyclotomic square (replaces tower_pallas.py
    mnt_f6_cyc_sqr_pallas)."""
    return _f6_call("k13_f6_cyc_sqr", mnt_f6_cyc_sqr_plain, spec, (a,))


def _mnt_step(fn, plain, spec, pts, xP, yP):
    """Run K14 or its plain version on F3 points `pts` ((X, Y, Z) or
    (X, Y, Z, x2, y2)) and P; returns ((a0, b), X', Y', Z')."""
    L = spec.n_limbs
    flat, bshape = lanes(L, *[c for pt in pts for c in pt], xP, yP)
    k = 3 * len(pts)
    if not flat[0].is_cuda:
        f3s = [tuple(flat[j:j + 3]) for j in range(0, k, 3)]
        (a0, b), Xn, Yn, Zn = plain(spec, *f3s, flat[k], flat[k + 1])
        out = [*a0, *b, *Xn, *Yn, *Zn]
    else:
        groups = [flat[:9], flat[9:k], flat[k:]] if k > 9 else \
            [flat[:9], flat[9:]]
        out = _launch(fn, spec, groups, n_out=N15)
    o = _reshape(out, L, bshape)
    f3 = [tuple(o[j:j + 3]) for j in range(0, N15, 3)]
    return (f3[0], f3[1]), f3[2], f3[3], f3[4]


def mnt_miller_dbl(spec: FieldSpec, X, Y, Z, xP, yP):
    """K14: MNT6753 Miller doubling step (replaces tower_pallas.py
    mnt_miller_dbl_pallas).  Returns ((a0, b), X', Y', Z')."""
    return _mnt_step("k14_mnt_miller_dbl", mnt_miller_dbl_plain, spec,
                     (X, Y, Z), xP, yP)


def mnt_miller_add(spec: FieldSpec, X, Y, Z, x2, y2, xP, yP):
    """K14: MNT6753 Miller mixed-add step (replaces tower_pallas.py
    mnt_miller_add_pallas).  Returns ((a0, b), X', Y', Z')."""
    return _mnt_step("k14_mnt_miller_add", mnt_miller_add_plain, spec,
                     (X, Y, Z, x2, y2), xP, yP)
