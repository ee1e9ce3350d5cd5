"""MNT6753 curve family: 753-bit field, F3/F6 towers, projective curves,
ate pairing, Pedersen hash, group map — the port's copy of
wasmsnark_tpu/models/mnt6753.py, line for line (the host oracle of the
MNT6753 verifier and of the port's tests and chip_smoke.py).

Capability mirror of src/mnt6753/build_mnt6753.js: Fp (753-bit), Fp3
(v^3 = 11), Fp6 = Fp3[w]/(w^2 - v); G1 projective y^2 = x^3 + 11x + b,
G2 projective over Fp3 with a2 = 11*v^2, b2 = 11*b; ate pairing with the
753-bit loop count (build_mnt6753.js:262) and the Coda final exponentiation
(x^{(q^3-1)(q+1)(q+w0)}, build_mnt6753.js:1244-1314 — verified equal to the
reference's committed full exponent); windowed signed Pedersen hash over the
12 precomputed bases (chunkSize 188, build_pedersenhash.js,
tools/buildpedersentablebases_mnt6753.js); deterministic group map
(build_mnt6753.js:1385-1511).

The pairing oracle untwists G2'(Fp3) points onto E(Fp6) via
psi(x, y) = (x * w^-2, y * w^-3) and runs a textbook affine Miller loop —
the reduced ate pairing value is independent of the Miller-function
normalization, so this matches the reference's line-coefficient pipeline
bit-exactly after final exponentiation (validated against the Coda-produced
test vectors in test/data/mnt6753verifier_testvector*.json).
"""

from __future__ import annotations

import functools

from ..fields.spec import FieldSpec
from ..fields import oracle as fo
from ..curves.oracle import ProjectiveCurve
from .mnt6753_constants import (
    Q, R, A, B, NR, ATE_LOOP_COUNT, FINAL_EXP_W0, G1_GEN, G2_GEN,
    GROUP_MAP_CONIC_C, GROUP_MAP_PROJ_Z, PEDERSEN_CHUNK_SIZE, PEDERSEN_BASES,
)

__all__ = [
    "Q", "R", "A", "B", "NR", "ATE_LOOP_COUNT", "FINAL_EXP_W0",
    "G1_GEN", "G2_GEN", "FP_SPEC", "FR_SPEC", "Mnt6753", "mnt6753",
]

FP_SPEC = FieldSpec(Q, "mnt6753_fp")
FR_SPEC = FieldSpec(R, "mnt6753_fr")


class Mnt6753:
    """Assembled MNT6753 module — the oracle analogue of the mnt6753 WASM
    module (src/mnt6753/build_mnt6753.js)."""

    def __init__(self):
        self.fp_spec = FP_SPEC
        self.fr_spec = FR_SPEC

        self.F1 = fo.Fp(FP_SPEC)
        self.Fr = fo.Fp(FR_SPEC)
        # Fp3 = Fp[v]/(v^3 - 11) (mulNR3, build_mnt6753.js:35-54)
        self.F3 = fo.F3(self.F1, lambda a: self.F1.mul(NR, a))
        # Fp6 = Fp3[w]/(w^2 - v) (mulNR6 shifts components, :58-88)
        def mul_nr6(a):  # a in F3: (a0,a1,a2) -> v*a = (11*a2, a0, a1)
            return (self.F1.mul(NR, a[2]), a[0], a[1])
        self.F6 = fo.F2(self.F3, mul_nr6)

        # G1: y^2 = x^3 + 11x + b over Fp (mulByA1, :90-109)
        self.G1 = ProjectiveCurve(self.F1, lambda z: self.F1.mul(A, z), "g1")
        # G2: y^2 = x^3 + (11 v^2) x + 11b over Fp3 (mulByA2, :111-144)
        self.a2 = (0, 0, A)
        self.G2 = ProjectiveCurve(self.F3, lambda z: self.F3.mul(self.a2, z), "g2")

        self.g1_gen = self.G1.from_affine(*G1_GEN)
        self.g2_gen = self.G2.from_affine(G2_GEN[0], G2_GEN[1])

        # untwist multipliers in F6: w^-2 and w^-3
        F6 = self.F6
        w = (self.F3.zero(), self.F3.one())               # the element w
        self._w_m2 = F6.inv(F6.square(w))
        self._w_m3 = F6.inv(F6.mul(F6.square(w), w))
        # a coefficient embedded in F6 for tangent lines
        self._a6 = self._embed_fp(A)

    # -- embeddings -----------------------------------------------------------

    def _embed_f3(self, a):
        return (a, self.F3.zero())

    def _embed_fp(self, a):
        return ((a, 0, 0), self.F3.zero())

    def untwist_g2(self, p_affine):
        """psi: E'(Fp3) -> E(Fp6); (x, y) -> (x*w^-2, y*w^-3).

        Lands on y^2 = x^3 + 11x + b since a2 = 11 v^2 and b2 = 11 b (both
        verified against the reference G2 generator at constants-gen time)."""
        F6 = self.F6
        x = F6.mul(self._embed_f3(p_affine[0]), self._w_m2)
        y = F6.mul(self._embed_f3(p_affine[1]), self._w_m3)
        return (x, y)

    # -- Miller loop over E(Fp6), affine, general a != 0 ----------------------

    def _line(self, T, Q2, P):
        """Line through T, Q2 (tangent if equal) evaluated at P; returns
        (value, T+Q2).  Tangent slope includes the a = 11 term."""
        F = self.F6
        xT, yT = T
        xQ, yQ = Q2
        xP, yP = P
        if F.eq(xT, xQ):
            if F.eq(yT, F.neg(yQ)):
                return F.sub(xP, xT), None
            num = F.add(F.mul_scalar(F.square(xT), 3), self._a6)
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
        """f_{T,Q}(P), T = ATE_LOOP_COUNT (positive loop, no extra add/frob
        steps — build_mnt6753.js:694-802)."""
        F = self.F6
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
        return f

    @functools.cached_property
    def _frob6_coeffs(self):
        """Fp scalars nr^(k(q-1)/6): component k' of (a0,a1,a2,b0,b1,b2)
        sits on power (0,2,4,1,3,5) of nr^(1/6) and picks up g[k'] under
        x -> x^q (build_mnt6753.js:1008-1070)."""
        return [pow(NR, k * (Q - 1) // 6, Q) for k in range(6)]

    def _frobenius6(self, f):
        (a0, a1, a2), (b0, b1, b2) = f
        g = self._frob6_coeffs
        F1 = self.F1
        return ((a0, F1.mul(a1, g[2]), F1.mul(a2, g[4])),
                (F1.mul(b0, g[1]), F1.mul(b1, g[3]), F1.mul(b2, g[5])))

    def final_exponentiation(self, f):
        """f^((q^3-1)(q+1)(q+w0)) — the product of the reference's first
        chunk (q^3-1)(q+1) and last chunk (q + w0)
        (build_mnt6753.js:1244-1314; equals its committed full exponent),
        via the easy/hard split: conjugate*inverse (the q^3-1 chunk, f^q^3
        = conjugate over F3), one Frobenius (the q+1 chunk), then
        frob(t) * t^w0 — a 753-bit ladder instead of the 3765-bit full
        exponent."""
        F = self.F6
        t = F.mul(F.conjugate(f), F.inv(f))
        t = F.mul(self._frobenius6(t), t)
        return F.mul(self._frobenius6(t), F.exp(t, FINAL_EXP_W0))

    def pairing(self, g1_point, g2_point):
        a1 = self._affine2(self.G1, g1_point)
        a2 = self._affine2(self.G2, g2_point)
        return self.final_exponentiation(self.miller_loop(a1, a2))

    @staticmethod
    def _affine2(curve, p):
        if curve.is_zero(p):
            return None
        a = curve.affine(p)
        return (a[0], a[1])

    def pairing_eq(self, pairs, expected=None):
        """prod e(P_i, Q_i) == expected (mnt6753_pairingEq1..3; verifySync
        passes alphaBeta or pOneT, src/mnt6753.js:686,724)."""
        F = self.F6
        acc = F.one()
        for g1p, g2p in pairs:
            a1 = self._affine2(self.G1, g1p)
            a2 = self._affine2(self.G2, g2p)
            acc = F.mul(acc, self.miller_loop(a1, a2))
        acc = self.final_exponentiation(acc)
        if expected is None:
            expected = F.one()
        return F.eq(acc, expected)

    # -- Pedersen hash (build_pedersenhash.js) --------------------------------

    @functools.cached_property
    def _pedersen_table(self):
        """[base][sel] -> projective (sel+1)*B for sel 0..3 — the {B, 2B,
        3B, 4B} table of tools/buildpedersentablebases_mnt6753.js."""
        table = []
        for bx, by in PEDERSEN_BASES:
            p1 = self.G1.from_affine(bx, by)
            p2 = self.G1.affine(self.G1.double(p1))
            p3 = self.G1.affine(self.G1.add(p1, p2))
            p4 = self.G1.affine(self.G1.double(p2))
            table.append((p1, p2, p3, p4))
        return table

    def pedersen_hash(self, bits) -> int:
        """3-bit windowed signed Pedersen hash; returns the canonical affine
        x-coordinate (g1m_pedersenHash copies only the x coordinate to the
        result, build_pedersenhash.js:156-162).

        Per 3-bit window at i: sel = b[i] + 2*b[i+1] selects (sel+1)*Base,
        b[i+2] is the sign; base index advances every chunkSize windows;
        accumulator index = (i/3) mod chunkSize; reduction folds accumulators
        MSB-first with x16 doublings (build_pedersenhash.js:48-266)."""
        G = self.G1
        n = PEDERSEN_CHUNK_SIZE
        accs = [G.zero()] * n

        def bit(i):
            return 1 if (i < len(bits) and bits[i]) else 0

        table = self._pedersen_table
        for i in range(0, len(bits), 3):
            sel = bit(i) | (bit(i + 1) << 1)
            sign = bit(i + 2)
            base = table[i // (n * 3)][sel]
            k = (i // 3) % n
            accs[k] = G.sub(accs[k], base) if sign else G.add(accs[k], base)

        res = accs[n - 1]
        for p in range(n - 2, -1, -1):
            for _ in range(4):
                res = G.double(res)
            res = G.add(res, accs[p])
        aff = G.affine(res)
        return aff[0]

    # -- deterministic group map (build_mnt6753.js:1385-1511) -----------------

    def group_map(self, t: int):
        """Map a field element to a G1 point: try x = v, -(1+v), 1+y^2 and
        take the first with square RHS; y = Tonelli sqrt (sign-normalized,
        matching f1m_sqrt)."""
        F = self.F1
        ct = F.mul(GROUP_MAP_CONIC_C, t % Q)
        s = F.mul(F.add(ct, GROUP_MAP_PROJ_Z), F.inv(F.add(F.mul(ct, t % Q), 1)))
        s = F.add(s, s)
        z = F.sub(GROUP_MAP_PROJ_Z, s)
        y = F.sub(1, F.mul(s, t % Q))
        half = pow(2, -1, Q)
        v = F.sub(F.mul(z, F.inv(y)), half)

        for x in (v, F.neg(F.add(1, v)), F.add(1, F.square(y))):
            y2 = F.add(F.add(F.mul(F.square(x), x), F.mul(A, x)), B)
            if self.fp_spec.is_square(y2):
                return self.G1.from_affine(x, self.fp_spec.sqrt(y2))
        raise AssertionError("group_map: no candidate x found")  # unreachable


@functools.lru_cache(maxsize=1)
def mnt6753() -> Mnt6753:
    return Mnt6753()
