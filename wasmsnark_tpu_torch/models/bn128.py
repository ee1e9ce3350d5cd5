"""BN128 (alt_bn128) curve family: constants, towers, curves, pairing oracle.

Mirrors the capability set of src/bn128/build_bn128.js: Fp, Fr, Fp2, Fp6,
Fp12 towers; G1/G2 Jacobian groups; optimal ate pairing; pairing product
equations.  Constants are the standard public alt_bn128 parameters (same
values as build_bn128.js:19-20, 80-90, 160-165).

The pairing oracle works over E(Fp12) via the sextic-twist embedding
Psi(x, y) = (x*w^2, y*w^3) — mathematically the same pairing the reference's
Miller loop computes (build_bn128.js:613-835), chosen in this naive form so it
serves as an independent cross-check for device kernels.  Verification only
consumes boolean pairing-product equations, so internal F12 conventions are
free (reference likewise only exposes pairingEqN + pOneT).
"""

from __future__ import annotations

import functools

from ..fields.spec import FieldSpec, NTTSpec
from ..fields import oracle as fo
from ..curves.oracle import JacobianCurve

# ---------------------------------------------------------------------------
# Public curve constants (build_bn128.js:19-20)
# ---------------------------------------------------------------------------

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# ate loop count 6x+2 (build_bn128.js:220), x = 4965661367192848881
ATE_LOOP_COUNT = 29793968203157093288
FINAL_EXP_Z = 4965661367192848881

# G1 generator (1, 2); G2 generator (build_bn128.js:80-90)
G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

# twist curve coefficient b' = 3/(9+u) (build_bn128.js:160-165)
TWIST_COEF_B = (
    19485874751759354771024239261021720505790618469301721065564631296452457478373,
    266929791119991161246907387137283842545076965332900288569378510910307636690,
)

FP_SPEC = FieldSpec(Q, "bn128_fp")
FR_SPEC = FieldSpec(R, "bn128_fr")


class Bn128:
    """Assembled BN128 module — the oracle analogue of the bn128 WASM module."""

    def __init__(self):
        self.fp_spec = FP_SPEC
        self.fr_spec = FR_SPEC
        self.ntt_spec = NTTSpec(FR_SPEC)

        self.F1 = fo.Fp(FP_SPEC)
        self.Fr = fo.Fp(FR_SPEC)
        # Fp2 = Fp[u]/(u^2+1): non-residue -1 => mulNR = neg (build_bn128.js:41)
        self.F2 = fo.F2(self.F1, self.F1.neg)
        # Fp6 = Fp2[v]/(v^3 - (9+u)) (build_bn128.js mulNR6)
        self.xi = (9, 1)
        self.F6 = fo.F3(self.F2, lambda a: self.F2.mul(self.xi, a))
        # Fp12 = Fp6[w]/(w^2 - v) (build_bn128.js mulNR12: shift + xi on top)
        def mul_nr12(a):  # a in F6: (a0,a1,a2) -> (xi*a2, a0, a1)
            return (self.F2.mul(self.xi, a[2]), a[0], a[1])
        self.mul_nr12 = mul_nr12
        self.F12 = fo.F2(self.F6, mul_nr12)

        self.G1 = JacobianCurve(self.F1, "g1")
        self.G2 = JacobianCurve(self.F2, "g2")

        self.g1_gen = self.G1.from_affine(*G1_GEN)
        self.g2_gen = self.G2.from_affine(G2_GEN[0], G2_GEN[1])

    # -- Fp2 -> Fp12 twist embedding ----------------------------------------

    def _embed_fp2(self, a):
        """Fp2 element (a0, a1) as an Fp12 element."""
        z2 = (0, 0)
        return ((a, z2, z2), (z2, z2, z2))

    def _embed_fp(self, a):
        return self._embed_fp2((a, 0))

    @functools.cached_property
    def _w2(self):
        """w^2 = v in Fp12."""
        z2 = (0, 0)
        return (((0, 0), (1, 0), z2), (z2, z2, z2))

    @functools.cached_property
    def _w3(self):
        """w^3 = v*w in Fp12."""
        z2 = (0, 0)
        return ((z2, z2, z2), ((0, 0), (1, 0), z2))

    def embed_g2(self, p):
        """Psi: E'(Fp2) -> E(Fp12); (x, y) affine -> (x*w^2, y*w^3)."""
        F12 = self.F12
        x = F12.mul(self._embed_fp2(p[0]), self._w2)
        y = F12.mul(self._embed_fp2(p[1]), self._w3)
        return (x, y)

    # -- Miller loop over E(Fp12), affine coordinates ------------------------

    def _line(self, T, Q2, P):
        """Evaluate the line through T and Q2 (or tangent if T==Q2) at P, and
        return (line_value, T+Q2). All points affine over Fp12."""
        F = self.F12
        xT, yT = T
        xQ, yQ = Q2
        xP, yP = P
        if F.eq(xT, xQ):
            if F.eq(yT, F.neg(yQ)):
                # vertical line x - xT
                return F.sub(xP, xT), None
            # tangent: lambda = 3 xT^2 / 2 yT
            num = F.mul_scalar(F.square(xT), 3)
            den = F.add(yT, yT)
        else:
            num = F.sub(yQ, yT)
            den = F.sub(xQ, xT)
        lam = F.mul(num, F.inv(den))
        # l(P) = yP - yT - lambda (xP - xT)
        l = F.sub(F.sub(yP, yT), F.mul(lam, F.sub(xP, xT)))
        # T + Q
        x3 = F.sub(F.sub(F.square(lam), xT), xQ)
        y3 = F.sub(F.mul(lam, F.sub(xT, x3)), yT)
        return l, (x3, y3)

    def _frob_point(self, P, k=1):
        """Frobenius pi^k on an affine E(Fp12) point via exponentiation."""
        F = self.F12
        e = Q ** k
        return (F.exp(P[0], e), F.exp(P[1], e))

    def miller_loop(self, g1_affine, g2_affine):
        """f_{6x+2, Q}(P) * line corrections — optimal ate Miller loop.

        g1_affine: (x, y) ints; g2_affine: ((x0,x1),(y0,y1)) Fp2 pairs.
        Either may be the zero point, in which case the result is 1
        (pairing with zero), matching e(0, Q) = e(P, 0) = 1.
        """
        F = self.F12
        if g1_affine is None or g2_affine is None:
            return F.one()
        P = (self._embed_fp(g1_affine[0]), self._embed_fp(g1_affine[1]))
        Qp = self.embed_g2(g2_affine)
        T = Qp
        f = F.one()
        bits = bin(ATE_LOOP_COUNT)[3:]  # skip MSB
        for b in bits:
            l, T = self._line(T, T, P)
            f = F.mul(F.square(f), l)
            if b == "1":
                l, T = self._line(T, Qp, P)
                f = F.mul(f, l)
        # frobenius correction steps (BN optimal ate)
        Q1 = self._frob_point(Qp, 1)
        Q2n = self._frob_point(Qp, 2)
        Q2n = (Q2n[0], F.neg(Q2n[1]))
        l, T = self._line(T, Q1, P)
        f = F.mul(f, l)
        l, T = self._line(T, Q2n, P)
        f = F.mul(f, l)
        return f

    def final_exponentiation(self, f):
        """f^((q^12-1)/r) via the easy/hard split (q^12-1)/r =
        (q^6-1)(q^2+1) * (q^4-q^2+1)/r: conjugate*inverse for the q^6-1
        chunk (f^(q^6) = conjugate over F6), then two ladders totalling
        ~1270 bits instead of the 3046-bit full exponent (the reference's
        easy chunk, build_bn128.js:943-978; its cyclotomic hard part lives
        in the device engine, ops/pairing.py)."""
        F = self.F12
        t = F.mul(F.conjugate(f), F.inv(f))
        t = F.mul(F.exp(t, Q * Q), t)
        return F.exp(t, (Q ** 4 - Q ** 2 + 1) // R)

    def pairing(self, g1_point, g2_point):
        """Full pairing on oracle curve points (Jacobian tuples)."""
        a1 = self._affine2(self.G1, g1_point)
        a2 = self._affine2(self.G2, g2_point)
        return self.final_exponentiation(self.miller_loop(a1, a2))

    def frobenius(self, f, power=1):
        """F12 Frobenius via gamma tables (__mulBy024-era gamma maps,
        build_bn128.js:838-939); equals F12.exp(f, Q**power)."""
        return fo.frobenius12(self.F2, self.xi, Q, f, power)

    def cyclotomic_square(self, f):
        """Granger-Scott squaring, valid on the cyclotomic subgroup
        (__cyclotomicSquare, build_bn128.js:980-1089)."""
        return fo.gs_cyclotomic_square(
            self.F2, lambda a: self.F2.mul(self.xi, a), f)

    def mul_line(self, f, a0, b0, b1):
        """Sparse F12 multiply by a Miller line ((a0,0,0),(b0,b1,0)) —
        the __mulBy024 analogue in this tower basis (build_bn128.js:613-753):
        13 F2 muls vs the dense 18."""
        F6, F2 = self.F6, self.F2
        d0, d1 = f
        A = F6.mul_base(d0, a0)
        B = F6.mul_by_01(d1, b0, b1)
        t = F6.mul_by_01(F6.add(d0, d1), F2.add(a0, b0), b1)
        return (F6.add(A, self.mul_nr12(B)),
                F6.sub(F6.sub(t, A), B))

    @staticmethod
    def _affine2(curve, p):
        if curve.is_zero(p):
            return None
        a = curve.affine(p)
        return (a[0], a[1])

    def pairing_eq(self, pairs, expected=None):
        """prod_i e(P_i, Q_i) == expected (default 1).

        The reference exposes pairingEq1..5(..., pRes) comparing against a
        caller-supplied F12 value (build_bn128.js:1287-1317); groth16Verify
        passes pOneT (src/bn128.js:786).
        """
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
def bn128() -> Bn128:
    return Bn128()
