"""BLS12-381 curve family: fields, towers, curves, pairing oracle — the
port's copy of wasmsnark_tpu/models/bls12381.py (`cyclotomic_square` on
the oracle's F2; the device's is K9, ops/tower_kernels.py).

Capability mirror of src/bls12381/build_bls12381.js: Fp (381-bit), Fr
(255-bit, 2-adicity 32) with NTT support, Fp2 = Fp[u]/(u^2+1), Fp6 over Fp2
with non-residue xi = 1+u (the dedicated f2m_mulNR, build_bls12381.js:156-175),
Fp12 = Fp2 over Fp6; G1/G2 Jacobian a=0 groups; optimal ate pairing with the
**negative** loop x = -0xd201000000010000 (build_bls12381.js:228-231): the
Miller value is inverted after the loop (the reference conjugates, which is
equivalent under the final exponentiation).

The reference builds the full module (field/curve/FFT/multiexp/pairing) but
wires **no prover orchestrator** for BLS (SURVEY.md §2.2); we expose the same
building blocks — the device kernels (ops/) are curve-generic and accept
these FieldSpecs directly, and groth16-style proving over BLS12-381 works
through the same Groth16Prover machinery instantiated with this module.
"""

from __future__ import annotations

import functools

from ..fields.spec import FieldSpec, NTTSpec
from ..fields import oracle as fo
from ..curves.oracle import JacobianCurve
from .bls12381_constants import (
    Q, R, ATE_LOOP_COUNT, ATE_LOOP_IS_NEGATIVE, FINAL_EXP_Z,
    G1_GEN, G2_GEN, TWIST_COEF_B,
)

__all__ = ["Q", "R", "ATE_LOOP_COUNT", "FINAL_EXP_Z", "G1_GEN", "G2_GEN",
           "TWIST_COEF_B", "FP_SPEC", "FR_SPEC", "Bls12381", "bls12381"]

FP_SPEC = FieldSpec(Q, "bls12381_fp")
FR_SPEC = FieldSpec(R, "bls12381_fr")


class Bls12381:
    """Assembled BLS12-381 module — oracle analogue of the bls12381 WASM
    module."""

    def __init__(self):
        self.fp_spec = FP_SPEC
        self.fr_spec = FR_SPEC
        self.ntt_spec = NTTSpec(FR_SPEC)

        self.F1 = fo.Fp(FP_SPEC)
        self.Fr = fo.Fp(FR_SPEC)
        # Fp2 = Fp[u]/(u^2+1) (nr = -1, build_bls12381.js:41)
        self.F2 = fo.F2(self.F1, self.F1.neg)
        # xi = 1 + u; f2m_mulNR(x) = (x0 - x1) + (x0 + x1) u
        # (build_bls12381.js:156-175)
        self.xi = (1, 1)
        self.F6 = fo.F3(self.F2, lambda a: self.F2.mul(self.xi, a))
        # Fp12 = Fp6[w]/(w^2 - v): mulNR12 shifts + xi on top
        # (build_bls12381.js:179-211)
        def mul_nr12(a):
            return (self.F2.mul(self.xi, a[2]), a[0], a[1])
        self.mul_nr12 = mul_nr12
        self.F12 = fo.F2(self.F6, mul_nr12)

        self.G1 = JacobianCurve(self.F1, "g1")
        self.G2 = JacobianCurve(self.F2, "g2")

        self.g1_gen = self.G1.from_affine(*G1_GEN)
        self.g2_gen = self.G2.from_affine(G2_GEN[0], G2_GEN[1])

    # -- Fp2 -> Fp12 embeddings; untwist for the M-type twist ------------------

    def _embed_fp2(self, a):
        z2 = (0, 0)
        return ((a, z2, z2), (z2, z2, z2))

    def _embed_fp(self, a):
        return self._embed_fp2((a, 0))

    @functools.cached_property
    def _w_m2(self):
        """w^-2 = v^-1 in Fp12."""
        F12 = self.F12
        z2 = (0, 0)
        w = ((z2, z2, z2), ((1, 0), z2, z2))
        return F12.inv(F12.square(w))

    @functools.cached_property
    def _w_m3(self):
        F12 = self.F12
        z2 = (0, 0)
        w = ((z2, z2, z2), ((1, 0), z2, z2))
        return F12.inv(F12.mul(F12.square(w), w))

    def untwist_g2(self, p):
        """psi: E'(Fp2) -> E(Fp12); (x, y) -> (x*w^-2, y*w^-3).

        BLS12-381 is an M-type twist (b' = 4*xi, verified from G2_GEN), so
        the untwist divides by powers of w — the opposite direction from
        BN128's D-twist embedding."""
        F12 = self.F12
        x = F12.mul(self._embed_fp2(p[0]), self._w_m2)
        y = F12.mul(self._embed_fp2(p[1]), self._w_m3)
        return (x, y)

    # -- Miller loop (affine, a = 0) -------------------------------------------

    def _line(self, T, Q2, P):
        F = self.F12
        xT, yT = T
        xQ, yQ = Q2
        xP, yP = P
        if F.eq(xT, xQ):
            if F.eq(yT, F.neg(yQ)):
                return F.sub(xP, xT), None
            num = F.mul_scalar(F.square(xT), 3)
            den = F.add(yT, yT)
        else:
            num = F.sub(yQ, yT)
            den = F.sub(xQ, xT)
        lam = F.mul(num, F.inv(den))
        l = F.sub(F.sub(yP, yT), F.mul(lam, F.sub(xP, xT)))
        x3 = F.sub(F.sub(F.square(lam), xT), xQ)
        y3 = F.sub(F.mul(lam, F.sub(xT, x3)), yT)
        return l, (x3, y3)

    def miller_loop(self, g1_affine, g2_affine):
        """f_{|x|,Q}(P) then inverted (negative loop, build_bls12381.js:849:
        the reference conjugates, identical after final exponentiation).
        No Frobenius correction steps (BLS family, unlike BN)."""
        F = self.F12
        if g1_affine is None or g2_affine is None:
            return F.one()
        P = (self._embed_fp(g1_affine[0]), self._embed_fp(g1_affine[1]))
        Qp = self.untwist_g2(g2_affine)
        T = Qp
        f = F.one()
        for b in bin(ATE_LOOP_COUNT)[3:]:
            l, T = self._line(T, T, P)
            f = F.mul(F.square(f), l)
            if b == "1":
                l, T = self._line(T, Qp, P)
                f = F.mul(f, l)
        if ATE_LOOP_IS_NEGATIVE:
            f = F.inv(f)
        return f

    def final_exponentiation(self, f):
        """f^((q^12-1)/r) via the easy/hard split (q^12-1)/r =
        (q^6-1)(q^2+1) * (q^4-q^2+1)/r (same value as the full exponent;
        the reference's optimized cyclotomic hard chunk,
        build_bls12381.js:961-1250, computes a fixed power of this reduced
        pairing — both are valid reduced ate pairings)."""
        F = self.F12
        t = F.mul(F.conjugate(f), F.inv(f))
        t = F.mul(F.exp(t, Q * Q), t)
        return F.exp(t, (Q ** 4 - Q ** 2 + 1) // R)

    def pairing(self, g1_point, g2_point):
        a1 = self._affine2(self.G1, g1_point)
        a2 = self._affine2(self.G2, g2_point)
        return self.final_exponentiation(self.miller_loop(a1, a2))

    def frobenius(self, f, power=1):
        """F12 Frobenius via gamma tables (build_bls12381.js:857-961);
        equals F12.exp(f, Q**power)."""
        return fo.frobenius12(self.F2, self.xi, Q, f, power)

    def cyclotomic_square(self, f):
        """Granger-Scott squaring on the cyclotomic subgroup
        (build_bls12381.js:961-1250)."""
        return fo.gs_cyclotomic_square(
            self.F2, lambda a: self.F2.mul(self.xi, a), f)

    def mul_by_014(self, f, c0, c1, c4):
        """Sparse F12 multiply by ((c0, c1, 0), (0, c4, 0)) — the M-twist
        line shape (ftm_mul014, build_bls12381.js:577-741): 8+3+2 F2 muls
        vs the dense 18, via the f6m_mul01/f6m_mul1 sparse products."""
        F6, F2 = self.F6, self.F2
        d0, d1 = f
        A = F6.mul_by_01(d0, c0, c1)
        B = F6.mul_by_1(d1, c4)
        t = F6.mul_by_01(F6.add(d0, d1), c0, F2.add(c1, c4))
        return (F6.add(A, self.mul_nr12(B)),
                F6.sub(F6.sub(t, A), B))

    @staticmethod
    def _affine2(curve, p):
        if curve.is_zero(p):
            return None
        a = curve.affine(p)
        return (a[0], a[1])

    def pairing_eq(self, pairs, expected=None):
        """prod e(P_i, Q_i) == expected (bls12381_pairingEq1..5,
        build_bls12381.js:1270-1337)."""
        F = self.F12
        acc = F.one()
        for g1p, g2p in pairs:
            a1 = self._affine2(self.G1, g1p)
            a2 = self._affine2(self.G2, g2p)
            acc = F.mul(acc, self.miller_loop(a1, a2))
        acc = self.final_exponentiation(acc)
        if expected is None:
            expected = F.one()
        return F.eq(acc, expected)


@functools.lru_cache(maxsize=1)
def bls12381() -> Bls12381:
    return Bls12381()
