"""BN128 and BLS12-381 optimal-ate pairings and the MNT6753 ate pairing on
the device, batched over pairing pairs — PyTorch port of
wasmsnark_tpu/ops/pairing.py.

The pairs axis is a batch axis: all Miller loops of a pairing-product
equation, and of as many independent equations as fit, run in the same
lanes, so verification throughput grows with the batch (a verification
server).  The algorithm is the JAX package's, value for value:

* an inversion-free Miller loop over homogeneous twist coordinates, whose
  line values are scaled by subfield factors (2YZ^2, lambda_d) that the
  final exponentiation kills;
* sparse lines of F12 = F2[v, w]: BN128's D twist puts them at w^0 (a0),
  w (b0) and v w (b1); BLS12-381's M twist at w^0 (a0, times xi), v w (b1)
  and v^2 w (b2);
* BN128: two Frobenius add steps with host-computed twist constants, and
  the final exponentiation's hard part as the BN z-chain under cyclotomic
  squaring;
* BLS12-381: a negative loop (the Miller value is conjugated after it), no
  correction steps, and the exact hard part (q^4 - q^2 + 1)/r by a 4-bit
  window ladder under cyclotomic squaring;
* MNT6753: F6 = F3[w] over the 753-bit field, homogeneous F3 twist
  coordinates on the a != 0 twist, a sparse line a0 + b w, a positive loop
  without correction steps, and the final exponentiation
  (q^3 - 1)(q + 1)(q + w0) with w0 by the same window ladder.

The ladders are static, so where the JAX package scans, this module runs
Python loops over the same schedules.  The heavy steps are the fused
kernels of ops/tower_kernels.py — K8 (`_f12_mul`, `_f12_sqr`), K9
(`cyclotomic_square`), K10 / K11 (`_dbl_step`, `_add_step` of BN128 /
BLS12-381), and for MNT6753 K12 (`_f6_mul`, `_f6_sqr`), K13
(`cyclotomic_square`) and K14 (`_dbl_step`, `_add_step`) — which run their
CUDA kernels on the card and their plain versions on the CPU: the tensor's
device decides.  Everything else
composes the towers of ops/towers.py over the K1/K2 field kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import tower_kernels as tk
from .curve import map_leaf, map_leaf2
from .fp import FpDevice, resolve_device
from .towers import FpAdapter, f12_towers, mnt_towers, stack, unstack

# the Miller-step formulas live with their kernel's plain versions
_g2_dbl_coefs = tk.g2_dbl_coefs
_g2_add_coefs = tk.g2_add_coefs


def _leaf0(tree):
    """First leaf of a tower element (shape and device donor)."""
    x = tree
    while isinstance(x, tuple):
        x = x[0]
    return x


def _bit_segments(bits):
    """Static MSB-first bit array (MSB already skipped) -> (segments,
    tail): segments[i] = squarings before the i-th multiply (inclusive of
    the 1-bit's own squaring); tail = squarings after the last 1-bit."""
    segs, run = [], 0
    for b in np.asarray(bits).tolist():
        run += 1
        if b:
            segs.append(run)
            run = 0
    return segs, run


def _seg_square_multiply(sqr_once, mul_f, st, bits):
    """Square-and-multiply over a static bit string, segment by segment."""
    segs, tail = _bit_segments(bits)
    for k in segs:
        for _ in range(k):
            st = sqr_once(st)
        st = mul_f(st)
    for _ in range(tail):
        st = sqr_once(st)
    return st


def _step_flags(loop_bits, n_corr: int = 0):
    """Static dbl/add schedule of the ate ladder: a dbl step per bit, an
    add step after each 1-bit, then n_corr correction adds (0 = dbl,
    1 = add)."""
    flags = []
    for b in np.asarray(loop_bits).tolist():
        flags.append(0)
        if b:
            flags.append(1)
    flags.extend([1] * n_corr)
    return np.asarray(flags, dtype=np.uint32)


def _stack_steps(steps):
    """Per-step coefficient trees -> one tree with a leading step axis."""
    if isinstance(steps[0], tuple):
        return tuple(_stack_steps([s[i] for s in steps])
                     for i in range(len(steps[0])))
    return torch.stack(steps)


def _coef_ladder(F2, xQ, yQ, loop_flags, dbl_coefs, add_coefs):
    """Run the G2 ladder over the static schedule, emitting per-step line
    coefficients.  Returns (coefficients with a leading step axis [S, ...],
    final (X, Y, Z))."""
    X, Y, Z = xQ, yQ, F2.one_like(xQ)
    coeffs = []
    for flag in np.asarray(loop_flags).tolist():
        if flag:
            c, X, Y, Z = add_coefs(X, Y, Z, xQ, yQ)
        else:
            c, X, Y, Z = dbl_coefs(X, Y, Z)
        coeffs.append(c)
    return _stack_steps(coeffs), (X, Y, Z)


def _windowed_cyc_exp(mul, sqr, f, e: int, w: int = 4):
    """f^e for cyclotomic f by a w-bit window ladder: w cyclotomic squarings
    between windows, one multiply per window against the table f^1 ..
    f^(2^w - 1).  The JAX package scans every window and selects; here the
    digits are static, so the ladder starts at the top window's power and
    skips the multiply of a zero window.  Every value is canonical, so the
    result is the JAX ladder's, bit for bit."""
    pows = [None, f]
    for _ in range(2, 1 << w):
        pows.append(mul(pows[-1], f))
    digits = window_digits(e, w)
    r = pows[digits[0]]
    for d in digits[1:]:
        for _ in range(w):
            r = sqr(r)
        if d:
            r = mul(r, pows[d])
    return r


def window_digits(e: int, w: int) -> list:
    """The w-bit digits of e > 0, most significant first."""
    nd = (e.bit_length() + w - 1) // w
    return [(e >> (w * (nd - 1 - i))) & ((1 << w) - 1) for i in range(nd)]


def _append_steps(coeffs, extra):
    """Append per-step coefficient trees (no step axis) to a stacked one."""
    if isinstance(coeffs, tuple):
        return tuple(_append_steps(c, [e[i] for e in extra])
                     for i, c in enumerate(coeffs))
    return torch.cat([coeffs] + [e[None] for e in extra], dim=0)


class _PairingEngine:
    """What both engines share: marshalling, the fused kernels K8/K9, the
    Miller loop over the static ate bits, prepared coefficients, Frobenius,
    the pairs reduction and the pairing products.  A subclass gives the
    curve module, xi, the twist's line slots and Miller steps, its
    correction steps, the loop's sign and the final exponentiation."""

    XI: tuple = ()
    N_CORR = 0                  # correction add steps after the loop
    NEGATIVE_LOOP = False

    def __init__(self, m, device=None):
        self.m = m
        self.fp = FpDevice(m.fp_spec, device)
        self.device = self.fp.device
        self.base = FpAdapter(self.fp)
        self.F2d, self.F6d, self.F12d, self.mul_xi = f12_towers(
            self.base, self.XI)
        Q = m.F1.q

        # Frobenius coefficient tables for x -> x^(q^j), j = 1, 2, 3
        # (build_bn128.js:838-939): component k (power of xi^(1/6)) picks
        # up xi^(k (q^j - 1)/6)
        F2o, xi = m.F2, m.xi
        self._frob_coefs = []
        for j in (1, 2, 3):
            e = (Q ** j - 1) // 6
            self._frob_coefs.append(tuple(
                self._const_f2(F2o.exp(xi, k * e)) for k in range(1, 6)))
        # the full exponent (q^12 - 1)/r, MSB first, for the self-check
        # ladder final_exponentiation_scan
        self.finexp_bits = np.array(
            [int(b) for b in bin((Q ** 12 - 1) // m.fr_spec.q)[2:]],
            dtype=np.uint32)

    @staticmethod
    def _bits(loop_count):
        """Static Miller-loop bit string (MSB skipped), MSB-first."""
        return np.array([int(b) for b in bin(loop_count)[3:]],
                        dtype=np.uint32)

    # -- constants / marshalling ----------------------------------------------

    def _const_f2(self, v):
        return (self.fp.pack_mont([v[0]]), self.fp.pack_mont([v[1]]))

    def pack_g1(self, points):
        """list of oracle-affine (x, y) -> (xP, yP) planes [L, B]."""
        return (self.fp.pack_mont([p[0] for p in points]),
                self.fp.pack_mont([p[1] for p in points]))

    def pack_g2(self, points):
        """list of oracle-affine Fp2 points -> ((x0, x1), (y0, y1))."""
        def comp(i, j):
            return self.fp.pack_mont([p[i][j] for p in points])
        return ((comp(0, 0), comp(0, 1)), (comp(1, 0), comp(1, 1)))

    def unpack_f12(self, el):
        """F12 element -> list over lanes of oracle nested tuples."""
        L = self.fp.L
        flat = [self.fp.unpack_mont(p.reshape(L, -1))
                for p in tk.flatten12(el)]
        return [tk.unflatten12([f[b] for f in flat])
                for b in range(len(flat[0]))]

    # -- the fused kernels (ops/tower_kernels.py) -------------------------------

    def _f12_mul(self, a, b):
        return tk.f12_mul(self.fp.spec, a, b, self.XI)

    def _f12_sqr(self, a):
        return tk.f12_sqr(self.fp.spec, a, self.XI)

    def cyclotomic_square(self, f):
        """Granger-Scott squaring for elements of the cyclotomic subgroup
        (build_bn128.js:980-1089): 9 F2 squarings instead of a full F12
        square."""
        return tk.f12_cyc_sqr(self.fp.spec, f, self.XI)

    # -- Miller loop --------------------------------------------------------------

    def _bc(self, c, like):
        """Broadcast a packed [L, 1] constant F2 element to like's shape."""
        return map_leaf(c, lambda a: a.reshape(
            (a.shape[0],) + (1,) * (like.dim() - 1)).expand(like.shape))

    def _corrections(self, xQ, yQ):
        """Affine twist points of the add steps after the loop (none by
        default)."""
        return []

    def _miller_core(self, f, X, Y, Z, xQ, yQ, xP, yP):
        """Square-and-multiply over the static ate-loop bits, segment by
        segment: k doubling steps, then one add step."""
        segs, tail = _bit_segments(self.loop_bits)

        def dbl_once(f, X, Y, Z):
            l, X, Y, Z = self._dbl_step(X, Y, Z, xP, yP)
            return self._f12_mul(self._f12_sqr(f), l), X, Y, Z

        for k in segs:
            for _ in range(k):
                f, X, Y, Z = dbl_once(f, X, Y, Z)
            l, X, Y, Z = self._add_step(X, Y, Z, xQ, yQ, xP, yP)
            f = self._f12_mul(f, l)
        for _ in range(tail):
            f, X, Y, Z = dbl_once(f, X, Y, Z)
        return f, X, Y, Z

    def _loop_sign(self, f):
        """A negative loop conjugates the Miller value (the inverse under
        the final exponentiation)."""
        return self._f12_conj(f) if self.NEGATIVE_LOOP else f

    def miller_loop(self, g1, g2):
        """g1 = (xP, yP) planes [L, *B]; g2 = ((x0, x1), (y0, y1)) F2
        planes.  Returns the (scaled) Miller value, an F12 element.  Zero
        points are not representable in affine marshalling: callers handle
        e(0, .) = 1 on the host."""
        xP, yP = g1
        xQ, yQ = g2
        f = self._f12_one(xP)
        X, Y, Z = xQ, yQ, self.F2d.one_like(xQ)
        f, X, Y, Z = self._miller_core(f, X, Y, Z, xQ, yQ, xP, yP)
        for x2, y2 in self._corrections(xQ, yQ):
            l, X, Y, Z = self._add_step(X, Y, Z, x2, y2, xP, yP)
            f = self._f12_mul(f, l)
        return self._loop_sign(f)

    # -- prepared pairing inputs (prepareG2, build_bn128.js:459-575) -----------
    #
    # For a fixed G2 point the line coefficients of every step depend only
    # on the G2 ladder, so they are computed once and reused: each step's
    # line is (c_y, c_x, c_0), placed in the twist's slots at P by
    # _line_from_coefs.

    @functools.cached_property
    def _prep_flags(self):
        return _step_flags(self.loop_bits, n_corr=self.N_CORR)

    def _prep_coefs(self, c):
        """A step's coefficients as prepare_g2 stores them."""
        return c

    def prepare_g2(self, g2):
        """Line coefficients of the ate ladder for g2 (leaves [L, *B]):
        a tree with a leading step axis (leaves [S, L, *B]), reusable by
        any number of miller_loop_prepared calls."""
        F2d = self.F2d
        xQ, yQ = g2

        def dbl(X, Y, Z):
            c, *pt = _g2_dbl_coefs(F2d, X, Y, Z)
            return (self._prep_coefs(c), *pt)

        def add(X, Y, Z, x2, y2):
            c, *pt = _g2_add_coefs(F2d, X, Y, Z, x2, y2)
            return (self._prep_coefs(c), *pt)

        coeffs, (X, Y, Z) = _coef_ladder(
            F2d, xQ, yQ, _step_flags(self.loop_bits), dbl, add)
        extra = []
        for x2, y2 in self._corrections(xQ, yQ):
            c, X, Y, Z = add(X, Y, Z, x2, y2)
            extra.append(c)
        return _append_steps(coeffs, extra)

    def _line_at(self, c, xP, yP):
        """(c_y, c_x, c_0) at P: (c_y yP, c_x xP, c_0 broadcast)."""
        c_y, c_x, c_0 = c
        a0, bx = tk.line_at(self.F2d, c_y, c_x, xP, yP)
        like = _leaf0(a0)
        return a0, bx, map_leaf(c_0, lambda a: a.expand(like.shape))

    def miller_loop_prepared(self, g1, coeffs):
        """miller_loop(g1, g2) for coeffs = prepare_g2(g2): each step is a
        (dbl-step) squaring of f and one line multiply."""
        xP, yP = g1
        f = self._f12_one(xP)
        for s, flag in enumerate(self._prep_flags.tolist()):
            c = map_leaf(coeffs, lambda a: a[s])
            line = self._line_from_coefs(c, xP, yP)
            if not flag:
                f = self._f12_sqr(f)
            f = self._f12_mul(f, line)
        return self._loop_sign(f)

    def _reduce_pairs(self, f, n_pairs: int):
        """Product over the pairs axis (position 1 of the leaves), as a
        log tree of F12 multiplies."""
        k = n_pairs
        while k > 1:
            if k % 2:
                raise ValueError("pad the pairs to a power of two")
            half = k // 2
            f = self._f12_mul(map_leaf(f, lambda a: a[:, :half]),
                              map_leaf(f, lambda a: a[:, half:k]))
            k = half
        return map_leaf(f, lambda a: a[:, 0])

    def pairing_product_prepared(self, g1, coeffs, n_pairs: int):
        """pairing_product through prepared coefficients (pairs axis at
        position 1 of the g1 leaves, 2 of the coefficient leaves)."""
        f = self.miller_loop_prepared(g1, coeffs)
        return self.final_exponentiation(self._reduce_pairs(f, n_pairs))

    def pairing_product(self, g1, g2, n_pairs: int):
        """Batched pairing product: leaves [L, n_pairs, B]; the Miller
        loops run in lanes, the pairs axis reduces in a log tree, then one
        final exponentiation on [L, B] (the device analogue of
        bn128_pairingEqN, build_bn128.js:1287-1317)."""
        f = self.miller_loop(g1, g2)
        return self.final_exponentiation(self._reduce_pairs(f, n_pairs))

    def _f12_one(self, like):
        F = self.base
        one, z = F.one_like(like), F.zero_like(like)
        return (((one, z), (z, z), (z, z)), ((z, z), (z, z), (z, z)))

    # -- Frobenius / final exponentiation ---------------------------------------

    def frobenius(self, f, power: int = 1):
        """f^(q^power) for power in {1, 2, 3}: per-component conjugation
        and the gamma coefficients (build_bn128.js:838-939).  The six
        components sit at powers (0, 2, 4, 1, 3, 5) of xi^(1/6)."""
        F2 = self.F2d
        (a0, a1, a2), (b0, b1, b2) = f
        like = a0[0]
        g = [self._bc(c, like) for c in self._frob_coefs[power - 1]]
        if power in (1, 3):
            a0, a1, a2 = F2.conjugate(a0), F2.conjugate(a1), F2.conjugate(a2)
            b0, b1, b2 = F2.conjugate(b0), F2.conjugate(b1), F2.conjugate(b2)
        return ((a0, F2.mul(a1, g[1]), F2.mul(a2, g[3])),
                (F2.mul(b0, g[0]), F2.mul(b1, g[2]), F2.mul(b2, g[4])))

    def _f12_conj(self, f):
        return (f[0], self.F6d.neg(f[1]))

    def _easy_part(self, f):
        """f^((q^6 - 1)(q^2 + 1)): conj(f) f^-1, then times its q^2
        Frobenius."""
        t = self._f12_mul(self._f12_conj(f), self.F12d.inv(f))
        return self._f12_mul(self.frobenius(t, 2), t)

    def final_exponentiation_scan(self, f):
        """f^((q^12 - 1)/r) by square-and-multiply over the bits of
        finexp_bits, the MSB implicit (f itself): the self-check reference
        for final_exponentiation.  The JAX package scans every bit and
        selects the product; the bits are static, so the product (K8) runs
        only after a 1-bit, every square (K8) after each bit: the same
        values."""
        return _seg_square_multiply(self._f12_sqr,
                                    lambda r: self._f12_mul(r, f), f,
                                    self.finexp_bits[1:])

    def is_one(self, el):
        """Batched F12 == 1 (Montgomery form) -> bool [*B]."""
        return self.F12d.eq(el, self._f12_one(_leaf0(el)))


class Bn128PairingDevice(_PairingEngine):
    """Device pairing engine for BN128 on one torch device: D twist,
    positive loop, two Frobenius correction steps, BN z-chain hard part."""

    XI = (9, 1)
    N_CORR = 2

    def __init__(self, device=None):
        from ..models.bn128 import bn128, Q, ATE_LOOP_COUNT, FINAL_EXP_Z

        super().__init__(bn128(), device)
        self.loop_bits = self._bits(ATE_LOOP_COUNT)

        # host-computed twist-Frobenius constants (Montgomery [L, 1] planes)
        F2o = self.m.F2
        xi = self.m.xi
        self._g12 = self._const_f2(F2o.exp(xi, (Q - 1) // 3))
        self._g13 = self._const_f2(F2o.exp(xi, (Q - 1) // 2))
        self._g22 = self._const_f2(F2o.exp(xi, (Q * Q - 1) // 3))
        self._g23 = self._const_f2(F2o.exp(xi, (Q * Q - 1) // 2))

        # BN parameter z for the hard-part chain (build_bn128.js:1092)
        self.z_bits = np.array([int(b) for b in bin(FINAL_EXP_Z)[2:]],
                               dtype=np.uint32)

    # -- the D twist's sparse line and Miller steps (K10) ------------------------

    def _sparse(self, a0, b0, b1):
        z = self.base.zero_like(a0[0])
        z2 = (z, z)
        return ((a0, z2, z2), (b0, b1, z2))

    def _dbl_step(self, X, Y, Z, xP, yP):
        (a0, b0, b1), Xn, Yn, Zn = tk.miller_dbl(self.fp.spec, X, Y, Z, xP, yP)
        return self._sparse(a0, b0, b1), Xn, Yn, Zn

    def _add_step(self, X, Y, Z, x2, y2, xP, yP):
        (a0, b0, b1), Xn, Yn, Zn = tk.miller_add(
            self.fp.spec, X, Y, Z, x2, y2, xP, yP)
        return self._sparse(a0, b0, b1), Xn, Yn, Zn

    def _line_from_coefs(self, c, xP, yP):
        """(c_y, c_x, c_0) -> the sparse line at P: a0 = c_y yP,
        b0 = c_x xP, b1 = c_0."""
        return self._sparse(*self._line_at(c, xP, yP))

    def _corrections(self, xQ, yQ):
        """The two Frobenius-twisted points of the correction add steps
        (build_bn128.js:530-575): (pi(Q), -pi^2(Q)) in affine twist
        coordinates."""
        F2d = self.F2d
        like = _leaf0(xQ)
        x1 = F2d.mul(F2d.conjugate(xQ), self._bc(self._g12, like))
        y1 = F2d.mul(F2d.conjugate(yQ), self._bc(self._g13, like))
        x2 = F2d.mul(xQ, self._bc(self._g22, like))
        y2 = F2d.neg(F2d.mul(yQ, self._bc(self._g23, like)))
        return [(x1, y1), (x2, y2)]

    # -- final exponentiation ---------------------------------------------------

    def _exp_cyc(self, f, bits):
        """f^e for cyclotomic f, static MSB-first bits of e."""
        return _seg_square_multiply(
            self.cyclotomic_square, lambda r: self._f12_mul(r, f),
            f, bits[1:])

    def final_exponentiation(self, f):
        """f^((q^12 - 1)/r) (build_bn128.js:943-1262).  Easy part:
        conj(f) f^-1, then times its q^2 Frobenius.  Hard part: the BN
        addition chain in z, (q^4 - q^2 + 1)/r as an integer identity,
        with three z-powers under cyclotomic squaring."""
        t = self._easy_part(f)
        mul, sq = self._f12_mul, self.cyclotomic_square
        conj = self._f12_conj
        fp1 = self.frobenius(t, 1)
        fp2 = self.frobenius(t, 2)
        fp3 = self.frobenius(t, 3)
        fu = self._exp_cyc(t, self.z_bits)
        fu2 = self._exp_cyc(fu, self.z_bits)
        fu3 = self._exp_cyc(fu2, self.z_bits)
        y0 = mul(mul(fp1, fp2), fp3)
        y1 = conj(t)
        y2 = self.frobenius(fu2, 2)
        y3 = conj(self.frobenius(fu, 1))
        y4 = conj(mul(fu, self.frobenius(fu2, 1)))
        y5 = conj(fu2)
        y6 = conj(mul(fu3, self.frobenius(fu3, 1)))
        t0 = mul(mul(sq(y6), y4), y5)
        t1 = mul(mul(y3, y5), t0)
        t0 = mul(t0, y2)
        t1 = mul(sq(t1), t0)
        t1 = sq(t1)
        t0 = mul(t1, y1)
        t1 = mul(t1, y0)
        t0 = sq(t0)
        return mul(t0, t1)


class Bls12381PairingDevice(_PairingEngine):
    """Device pairing engine for BLS12-381 on one torch device (JAX
    pairing.py Bls12381PairingDevice): xi = 1 + u, M twist (line at w^0
    times xi, v w and v^2 w), the negative loop x = -0xd201000000010000
    conjugated after the loop, no correction steps
    (build_bls12381.js:228-231, :849), and the exact hard part."""

    XI = (1, 1)
    NEGATIVE_LOOP = True

    def __init__(self, device=None):
        from ..models.bls12381 import bls12381, Q, R, ATE_LOOP_COUNT

        super().__init__(bls12381(), device)
        self.loop_bits = self._bits(ATE_LOOP_COUNT)
        # the exact hard-part exponent: the z-based BLS chains compute a
        # fixed power of it (f^(3d)), which would break bit parity with the
        # oracle's exponent
        self._hard_exp = (Q ** 4 - Q ** 2 + 1) // R

    # -- the M twist's sparse line and Miller steps (K11) ------------------------

    def _sparse(self, a0, b1, b2):
        z = self.base.zero_like(a0[0])
        z2 = (z, z)
        return ((a0, z2, z2), (z2, b1, b2))

    def _dbl_step(self, X, Y, Z, xP, yP):
        (a0, b1, b2), Xn, Yn, Zn = tk.miller_dbl_mtwist(
            self.fp.spec, X, Y, Z, xP, yP, self.XI)
        return self._sparse(a0, b1, b2), Xn, Yn, Zn

    def _add_step(self, X, Y, Z, x2, y2, xP, yP):
        (a0, b1, b2), Xn, Yn, Zn = tk.miller_add_mtwist(
            self.fp.spec, X, Y, Z, x2, y2, xP, yP, self.XI)
        return self._sparse(a0, b1, b2), Xn, Yn, Zn

    def _prep_coefs(self, c):
        """xi folds into c_y at prepare time (the M twist's a0 slot)."""
        c_y, c_x, c_0 = c
        return (self.mul_xi(c_y), c_x, c_0)

    def _line_from_coefs(self, c, xP, yP):
        """M-twist slots: a0 = c_y yP, b1 = c_0, b2 = c_x xP."""
        a0, bx, c0 = self._line_at(c, xP, yP)
        return self._sparse(a0, c0, bx)

    # -- final exponentiation ---------------------------------------------------

    def _exp_cyc_window(self, f, e: int, w: int = 4):
        return _windowed_cyc_exp(self._f12_mul, self.cyclotomic_square,
                                 f, e, w)

    def final_exponentiation(self, f):
        """f^((q^12 - 1)/r): the easy part as BN128's, the hard part the
        exact (q^4 - q^2 + 1)/r through a 4-bit window cyclotomic ladder."""
        return self._exp_cyc_window(self._easy_part(f), self._hard_exp, w=4)


class Mnt6753PairingDevice:
    """Device pairing engine for MNT6753 on one torch device (JAX
    pairing.py Mnt6753PairingDevice), over the 753-bit field (48 limbs).

    An inversion-free Miller loop on homogeneous F3 twist coordinates whose
    line values are scaled by F3 factors (killed by the q^3 - 1 factor of
    the final exponentiation); the line is sparse in F6 = F3[w], a0 + b w,
    the shape of the reference's EV_at_P pair (build_mnt6753.js:694-802).
    Positive ate loop, no correction steps; the final exponentiation is
    (q^3 - 1)(q + 1)(q + w0), easy part conj(f) f^-1 times its Frobenius,
    hard part frob(t) t^w0 with w0 under a 4-bit window ladder of
    cyclotomic squarings (static digits, as the BLS12-381 engine's)."""

    def __init__(self, device=None):
        from ..models.mnt6753 import (
            mnt6753, Q, ATE_LOOP_COUNT, FINAL_EXP_W0, NR)

        self.m = mnt6753()
        self.fp = FpDevice(self.m.fp_spec, device)
        self.device = self.fp.device
        self.base = FpAdapter(self.fp)
        self.F3d, self.F6d, self.mulv = mnt_towers(self.base, NR)
        self.loop_bits = _PairingEngine._bits(ATE_LOOP_COUNT)
        self._w0 = FINAL_EXP_W0
        # the full exponent (q^3 - 1)(q + 1)(q + w0), MSB first, for
        # final_exponentiation_scan
        self.finexp_bits = np.array(
            [int(b) for b in bin((Q ** 3 - 1) * (Q + 1)
                                 * (Q + FINAL_EXP_W0))[2:]], dtype=np.uint32)
        # F6-over-Fp Frobenius: component k (power of nr^(1/6), k = (0, 2,
        # 4, 1, 3, 5) across (a0, a1, a2, b0, b1, b2)) picks up the Fp
        # scalar nr^(k (q - 1)/6) (build_mnt6753.js:1008-1070); entry k-1
        # of the tuple is nr^(k (q - 1)/6)
        e1 = (Q - 1) // 6
        self._frob_fp = tuple(self.fp.pack_mont([pow(NR, k * e1, Q)])
                              for k in range(1, 6))

    # -- marshalling ----------------------------------------------------------

    def pack_g1(self, points):
        """list of oracle-affine (x, y) -> (xP, yP) planes [L, B]."""
        return (self.fp.pack_mont([p[0] for p in points]),
                self.fp.pack_mont([p[1] for p in points]))

    def pack_g2(self, points):
        """list of affine F3 points ((x0, x1, x2), (y0, y1, y2)), or of
        canonical F6 values ((a0, a1, a2), (b0, b1, b2)) -> Montgomery plane
        tuples, leaves [L, N]."""
        def comp(i, j):
            return self.fp.pack_mont([p[i][j] for p in points])
        return (tuple(comp(0, j) for j in range(3)),
                tuple(comp(1, j) for j in range(3)))

    pack_f6 = pack_g2              # an F6 value has an F3 point's layout

    def unpack_f6(self, el):
        """F6 element -> list over lanes of oracle nested tuples."""
        L = self.fp.L
        flat = [self.fp.unpack_mont(c.reshape(L, -1))
                for c in (*el[0], *el[1])]
        return [((flat[0][b], flat[1][b], flat[2][b]),
                 (flat[3][b], flat[4][b], flat[5][b]))
                for b in range(len(flat[0]))]

    def _f6_one(self, like):
        F = self.base
        one, z = F.one_like(like), F.zero_like(like)
        return ((one, z, z), (z, z, z))

    def is_eq_planes(self, el, expected):
        """Batched F6 equality against per-lane expected Montgomery planes
        of the same shapes -> bool [*B]."""
        m = None
        for got, exp in zip((*el[0], *el[1]), (*expected[0], *expected[1])):
            e = self.base.eq(got, exp)
            m = e if m is None else (m & e)
        return m

    def _bc(self, c, el):
        """A packed [L, 1] constant broadcast to the shape of el's leaves."""
        like = _leaf0(el)
        return c.reshape((c.shape[0],) + (1,) * (like.dim() - 1)).expand(
            like.shape)

    # -- the fused kernels (ops/tower_kernels.py) --------------------------------

    def _f6_mul(self, a, b):
        return tk.mnt_f6_mul(self.fp.spec, a, b)

    def _f6_sqr(self, a):
        return tk.mnt_f6_sqr(self.fp.spec, a)

    def cyclotomic_square(self, f):
        """Granger-Scott squaring on the F6 cyclotomic subgroup
        (build_mnt6753.js:1071-1243), K13."""
        return tk.mnt_f6_cyc_sqr(self.fp.spec, f)

    def _dbl_step(self, X, Y, Z, xP, yP):
        """K14: the line (a0, b) as an F6 element and the doubled point."""
        return tk.mnt_miller_dbl(self.fp.spec, X, Y, Z, xP, yP)

    def _add_step(self, X, Y, Z, x2, y2, xP, yP):
        """K14: the line (a0, b) and the sum."""
        return tk.mnt_miller_add(self.fp.spec, X, Y, Z, x2, y2, xP, yP)

    # -- Miller loops -------------------------------------------------------------

    def _ladder(self, f, g1, g2, fold):
        """The unprepared ate ladder segment by segment: k doubling steps,
        then one add step; fold(l) turns a step's line into the factor of
        f (the line itself, or its product over the pairs axis)."""
        xP, yP = g1
        xQ, yQ = g2
        X, Y, Z = xQ, yQ, self.F3d.one_like(xQ)
        segs, tail = _bit_segments(self.loop_bits)

        def dbl_once(f, X, Y, Z):
            l, X, Y, Z = self._dbl_step(X, Y, Z, xP, yP)
            return self._f6_mul(self._f6_sqr(f), fold(l)), X, Y, Z

        for k in segs:
            for _ in range(k):
                f, X, Y, Z = dbl_once(f, X, Y, Z)
            l, X, Y, Z = self._add_step(X, Y, Z, xQ, yQ, xP, yP)
            f = self._f6_mul(f, fold(l))
        for _ in range(tail):
            f, X, Y, Z = dbl_once(f, X, Y, Z)
        return f

    def miller_loop(self, g1, g2):
        """g1 = (xP, yP) planes [L, *B], g2 = ((x0, x1, x2), (y0, y1, y2))
        affine F3 planes: the (scaled) Miller value per lane."""
        return self._ladder(self._f6_one(g1[0]), g1, g2, lambda l: l)

    def miller_loop_fused(self, g1, g2):
        """Fused multi-pair Miller loop (the reference's fusedMillerLoop,
        src/mnt6753.js:803-1006): pairs ride axis 1 (leaves [L, k, *B]),
        one running f per batch lane is squared once per doubling step and
        multiplied by the product of the k lines."""
        f = self._f6_one(g1[0][:, 0])
        return self._ladder(f, g1, g2, self._f6_prod_pairs)

    # -- prepared pairing inputs (PRECOMPUTE_G1/G2, src/mnt6753.js:151-176) ----

    @functools.cached_property
    def _prep_flags(self):
        return _step_flags(self.loop_bits)

    def prepare_g2(self, g2):
        """Per-step line coefficients (c_y, c_x, c_0) of the ate ladder for
        g2 (leaves [L, *B] -> [S, L, *B])."""
        F3d, mulv = self.F3d, self.mulv
        xQ, yQ = g2
        coeffs, _ = _coef_ladder(
            F3d, xQ, yQ, self._prep_flags,
            lambda X, Y, Z: tk.mnt_dbl_coefs(F3d, mulv, X, Y, Z),
            lambda X, Y, Z, x2, y2: tk.mnt_add_coefs(F3d, X, Y, Z, x2, y2))
        return coeffs

    def _line_from_coefs(self, c, xP, yP):
        return tk.mnt_line(self.base, self.F3d, c, xP, yP)

    def _prepared(self, g1, coeffs, f, fold):
        xP, yP = g1
        for s, flag in enumerate(self._prep_flags.tolist()):
            c = map_leaf(coeffs, lambda a: a[s])
            line = fold(self._line_from_coefs(c, xP, yP))
            if not flag:
                f = self._f6_sqr(f)
            f = self._f6_mul(f, line)
        return f

    def miller_loop_prepared(self, g1, coeffs):
        """miller_loop(g1, g2) for coeffs = prepare_g2(g2)."""
        return self._prepared(g1, coeffs, self._f6_one(g1[0]), lambda l: l)

    def miller_loop_fused_prepared(self, g1, coeffs):
        """miller_loop_fused through prepared coefficients: g1 leaves
        [L, k, *B], coefficient leaves [S, L, k, *B]."""
        return self._prepared(g1, coeffs, self._f6_one(g1[0][:, 0]),
                              self._f6_prod_pairs)

    # -- pairs, Frobenius, final exponentiation ---------------------------------

    def _f6_prod_pairs(self, f):
        """Product over the pairs axis (position 1 of the leaves) as a tree
        of F6 multiplies; an odd count carries its last lane forward."""
        k = _leaf0(f).shape[1]
        while k > 1:
            half = k // 2
            prod = self._f6_mul(map_leaf(f, lambda a: a[:, :half]),
                                map_leaf(f, lambda a: a[:, half:2 * half]))
            if k % 2:
                prod = map_leaf2(prod, f, lambda p, r: torch.cat(
                    [p, r[:, 2 * half:]], dim=1))
            f = prod
            k = half + k % 2
        return map_leaf(f, lambda a: a[:, 0])

    def frobenius(self, f):
        """f^q on F6 over Fp: an Fp-scalar product per component, no
        conjugation (the components are Fp elements)."""
        F = self.base
        (a0, a1, a2), (b0, b1, b2) = f
        g = [self._bc(c, a0) for c in self._frob_fp]
        n1, n2, m0, m1, m2 = unstack(F.mul(stack(a1, a2, b0, b1, b2),
                                           stack(g[1], g[3], g[0], g[2],
                                                 g[4])), 5)
        return ((a0, n1, n2), (m0, m1, m2))

    def _f6_conj(self, f):
        """f^(q^3): conjugation over F3 (w -> -w)."""
        return (f[0], self.F3d.neg(f[1]))

    def final_exponentiation(self, f):
        """f^((q^3 - 1)(q + 1)(q + w0)) (build_mnt6753.js:1244-1314)."""
        t = self._f6_mul(self._f6_conj(f), self.F6d.inv(f))
        t = self._f6_mul(self.frobenius(t), t)
        tw = _windowed_cyc_exp(self._f6_mul, self.cyclotomic_square, t,
                               self._w0, 4)
        return self._f6_mul(self.frobenius(t), tw)

    def final_exponentiation_scan(self, f):
        """The full exponent by square-and-multiply over finexp_bits (MSB
        implicit), K12's square after each bit and its product after each
        1-bit: the self-check reference for final_exponentiation."""
        return _seg_square_multiply(self._f6_sqr,
                                    lambda r: self._f6_mul(r, f), f,
                                    self.finexp_bits[1:])

    def pairing_products(self, g1, g2):
        """prod_j e(P_j, Q_j) per batch lane: pairs on axis 1 (point leaves
        [L, k, *B]), independent Miller loops in lanes, the tree product,
        one final exponentiation (the reference's verify worker DAG,
        src/mnt6753.js:944-1087)."""
        f = self.miller_loop(g1, g2)
        return self.final_exponentiation(self._f6_prod_pairs(f))

    def pairing_products_fused(self, g1, g2):
        """pairing_products through the fused Miller loop (verifyFused,
        src/mnt6753.js:779-941)."""
        return self.final_exponentiation(self.miller_loop_fused(g1, g2))

    def pairing_products_prepared(self, g1, coeffs, fused: bool = True):
        """prod_j e(P_j, Q_j) per batch lane from prepared coefficients."""
        if fused:
            f = self.miller_loop_fused_prepared(g1, coeffs)
        else:
            f = self._f6_prod_pairs(self.miller_loop_prepared(g1, coeffs))
        return self.final_exponentiation(f)


@functools.lru_cache(maxsize=None)
def _engine(cls, device: str):
    return cls(device)


def bn128_pairing_device(device=None) -> Bn128PairingDevice:
    """The BN128 pairing engine of `device` (default: the CUDA card), one
    per device."""
    return _engine(Bn128PairingDevice, str(resolve_device(device)))


def bls12381_pairing_device(device=None) -> Bls12381PairingDevice:
    """The BLS12-381 pairing engine of `device` (default: the CUDA card),
    one per device."""
    return _engine(Bls12381PairingDevice, str(resolve_device(device)))


def mnt6753_pairing_device(device=None) -> Mnt6753PairingDevice:
    """The MNT6753 pairing engine of `device` (default: the CUDA card), one
    per device."""
    return _engine(Mnt6753PairingDevice, str(resolve_device(device)))


def pairing_device(curve: str, device=None):
    """The pairing engine of a curve ("bn128", "bls12381" or "mnt6753") on
    `device`."""
    engines = {"bn128": bn128_pairing_device,
               "bls12381": bls12381_pairing_device,
               "mnt6753": mnt6753_pairing_device}
    if curve not in engines:
        raise ValueError(f"unknown curve {curve!r}")
    return engines[curve](device)
