"""BN128 optimal-ate pairing on the device, batched over pairing pairs —
PyTorch port of the BN128 part of wasmsnark_tpu/ops/pairing.py.

The pairs axis is a batch axis: all Miller loops of a pairing-product
equation, and of as many independent equations as fit, run in the same
lanes, so verification throughput grows with the batch (a verification
server).  The algorithm is the JAX package's, value for value:

* an inversion-free Miller loop over homogeneous twist coordinates, whose
  line values are scaled by subfield factors (2YZ^2, lambda_d) that the
  final exponentiation kills;
* sparse lines with components at w^0 (a0), w (b0) and v w (b1) of
  F12 = F2[v, w];
* two Frobenius add steps with host-computed twist constants;
* the final exponentiation as the easy part (conjugate, inverse, q^2
  Frobenius) and the BN z-chain hard part under cyclotomic squaring.

The ladders are static, so where the JAX package scans, this module runs
Python loops over the same schedules.  The heavy steps are the fused
kernels of ops/tower_kernels.py — K8 (`_f12_mul`, `_f12_sqr`), K9
(`cyclotomic_square`), K10 (`_dbl_step`, `_add_step`) — which run their
CUDA kernels on the card and their plain versions on the CPU: the tensor's
device decides.  Everything else composes the towers of ops/towers.py over
the K1/K2 field kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import tower_kernels as tk
from .curve import map_leaf
from .fp import FpDevice, resolve_device
from .towers import FpAdapter, f12_towers

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


def _append_steps(coeffs, extra):
    """Append per-step coefficient trees (no step axis) to a stacked one."""
    if isinstance(coeffs, tuple):
        return tuple(_append_steps(c, [e[i] for e in extra])
                     for i, c in enumerate(coeffs))
    return torch.cat([coeffs] + [e[None] for e in extra], dim=0)


class Bn128PairingDevice:
    """Device pairing engine for BN128 on one torch device."""

    XI = (9, 1)

    def __init__(self, device=None):
        from ..models.bn128 import bn128, Q, ATE_LOOP_COUNT, FINAL_EXP_Z

        self.m = bn128()
        self.fp = FpDevice(self.m.fp_spec, device)
        self.device = self.fp.device
        self.base = FpAdapter(self.fp)
        self.F2d, self.F6d, self.F12d, self.mul_xi = f12_towers(
            self.base, self.XI)

        # static Miller-loop bit string (MSB skipped), MSB-first
        self.loop_bits = np.array(
            [int(b) for b in bin(ATE_LOOP_COUNT)[3:]], dtype=np.uint32)

        # host-computed twist-Frobenius constants (Montgomery [L, 1] planes)
        F2o = self.m.F2
        xi = self.m.xi
        self._g12 = self._const_f2(F2o.exp(xi, (Q - 1) // 3))
        self._g13 = self._const_f2(F2o.exp(xi, (Q - 1) // 2))
        self._g22 = self._const_f2(F2o.exp(xi, (Q * Q - 1) // 3))
        self._g23 = self._const_f2(F2o.exp(xi, (Q * Q - 1) // 2))

        # Frobenius coefficient tables for x -> x^(q^j), j = 1, 2, 3
        # (build_bn128.js:838-939): component k (power of xi^(1/6)) picks
        # up xi^(k (q^j - 1)/6)
        self._frob_coefs = []
        for j in (1, 2, 3):
            e = (Q ** j - 1) // 6
            self._frob_coefs.append(tuple(
                self._const_f2(F2o.exp(xi, k * e)) for k in range(1, 6)))

        # BN parameter z for the hard-part chain (build_bn128.js:1092)
        self.z_bits = np.array([int(b) for b in bin(FINAL_EXP_Z)[2:]],
                               dtype=np.uint32)
        # prepared line coefficients of fixed G2 points (a verification
        # key's gamma2, delta2, beta2), filled by groth16.verifier
        self.vk_prep_cache: dict = {}

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

    # -- sparse line element ----------------------------------------------------

    def _sparse(self, a0, b0, b1):
        z = self.base.zero_like(a0[0])
        z2 = (z, z)
        return ((a0, z2, z2), (b0, b1, z2))

    # -- the fused kernels (ops/tower_kernels.py) -------------------------------

    def _f12_mul(self, a, b):
        return tk.f12_mul(self.fp.spec, a, b, self.XI)

    def _f12_sqr(self, a):
        return tk.f12_sqr(self.fp.spec, a, self.XI)

    def _dbl_step(self, X, Y, Z, xP, yP):
        (a0, b0, b1), Xn, Yn, Zn = tk.miller_dbl(self.fp.spec, X, Y, Z, xP, yP)
        return self._sparse(a0, b0, b1), Xn, Yn, Zn

    def _add_step(self, X, Y, Z, x2, y2, xP, yP):
        (a0, b0, b1), Xn, Yn, Zn = tk.miller_add(
            self.fp.spec, X, Y, Z, x2, y2, xP, yP)
        return self._sparse(a0, b0, b1), Xn, Yn, Zn

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
        """The two Frobenius-twisted points of the correction add steps
        (build_bn128.js:530-575): (pi(Q), -pi^2(Q)) in affine twist
        coordinates."""
        F2d = self.F2d
        like = _leaf0(xQ)
        x1 = F2d.mul(F2d.conjugate(xQ), self._bc(self._g12, like))
        y1 = F2d.mul(F2d.conjugate(yQ), self._bc(self._g13, like))
        x2 = F2d.mul(xQ, self._bc(self._g22, like))
        y2 = F2d.neg(F2d.mul(yQ, self._bc(self._g23, like)))
        return (x1, y1), (x2, y2)

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
        return f

    # -- prepared pairing inputs (prepareG2, build_bn128.js:459-575) -----------
    #
    # For a fixed G2 point the line coefficients of every step depend only
    # on the G2 ladder, so they are computed once and reused: each step's
    # line is (c_y, c_x, c_0) with line(P) = slots (c_y yP, c_x xP, c_0).

    @functools.cached_property
    def _prep_flags(self):
        return _step_flags(self.loop_bits, n_corr=2)

    def prepare_g2(self, g2):
        """Line coefficients of the ate ladder for g2 (leaves [L, *B]):
        a tree with a leading step axis (leaves [S, L, *B]), reusable by
        any number of miller_loop_prepared calls."""
        F2d = self.F2d
        xQ, yQ = g2
        coeffs, (X, Y, Z) = _coef_ladder(
            F2d, xQ, yQ, _step_flags(self.loop_bits),
            lambda X, Y, Z: _g2_dbl_coefs(F2d, X, Y, Z),
            lambda X, Y, Z, x2, y2: _g2_add_coefs(F2d, X, Y, Z, x2, y2))
        extra = []
        for x2, y2 in self._corrections(xQ, yQ):
            c, X, Y, Z = _g2_add_coefs(F2d, X, Y, Z, x2, y2)
            extra.append(c)
        return _append_steps(coeffs, extra)

    def _line_from_coefs(self, c, xP, yP):
        """(c_y, c_x, c_0) -> the sparse line at P: a0 = c_y yP,
        b0 = c_x xP, b1 = c_0."""
        c_y, c_x, c_0 = c
        a0, b0 = tk.line_at(self.F2d, c_y, c_x, xP, yP)
        like = _leaf0(a0)
        b1 = map_leaf(c_0, lambda a: a.expand(like.shape))
        return self._sparse(a0, b0, b1)

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
        return f

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
        F12 = self.F12d
        t = self._f12_mul(self._f12_conj(f), F12.inv(f))
        t = self._f12_mul(self.frobenius(t, 2), t)
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

    def is_one(self, el):
        """Batched F12 == 1 (Montgomery form) -> bool [*B]."""
        return self.F12d.eq(el, self._f12_one(_leaf0(el)))


@functools.lru_cache(maxsize=None)
def _pairing_device(device: str) -> Bn128PairingDevice:
    return Bn128PairingDevice(device)


def bn128_pairing_device(device=None) -> Bn128PairingDevice:
    """The pairing engine of `device` (default: the CUDA card), one per
    device."""
    return _pairing_device(str(resolve_device(device)))
