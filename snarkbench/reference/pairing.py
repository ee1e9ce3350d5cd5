"""BN128 (alt_bn128) and BLS12-381: constants, towers, groups and the
optimal ate pairing, in the plain affine form over E(Fp12) (a frozen copy
of the oracles the port's bring-up was checked against).

    curve("bn128") / curve("bls12381") -> Curve
    Curve.pairing_eq([(P1, Q1), ...]) -> prod e(P_i, Q_i) == 1
"""

from __future__ import annotations

import functools

from .curves import FixedBase, Jacobian
from .fields import F2, F3, Fp

_BN_Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
_BN_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
_BLS_Q = 4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787
_BLS_R = 52435875175126190479447740508185965837690552500527637822603658699938581184513

PARAMS = {
    "bn128": dict(
        q=_BN_Q, r=_BN_R, xi=(9, 1), b1=3,
        b2=(19485874751759354771024239261021720505790618469301721065564631296452457478373,
            266929791119991161246907387137283842545076965332900288569378510910307636690),
        loop=29793968203157093288, loop_negative=False,   # 6x + 2
        g1=(1, 2),
        g2=((10857046999023057135944570762232829481370756359578518086990519993285655852781,
             11559732032986387107991004021392285783925812861821192530917403151452391805634),
            (8495653923123431417604973247489272438418190587263600148770280649306958101930,
             4082367875863433681332203403145435568316851327593401208105741076214120093531))),
    "bls12381": dict(
        q=_BLS_Q, r=_BLS_R, xi=(1, 1), b1=4, b2=(4, 4),
        loop=15132376222941642752, loop_negative=True,    # |x|, x < 0
        g1=(3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
            1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569),
        g2=((352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
             3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758),
            (1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
             927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582))),
}


def domain_root(r: int, bits: int) -> int:
    """The primitive 2^bits-th root of unity of the proving key's domain:
    the smallest quadratic non-residue from 2 raised to the odd part of
    r - 1, squared down to order 2^bits (wasmsnark's build_fft.js)."""
    odd, s = r - 1, 0
    while odd % 2 == 0:
        odd, s = odd // 2, s + 1
    nr = 2
    while pow(nr, (r - 1) // 2, r) == 1:
        nr += 1
    if bits > s:
        raise ValueError(f"no 2^{bits}-point domain in this field")
    return pow(pow(nr, odd, r), 1 << (s - bits), r)


class Curve:
    def __init__(self, name: str):
        p = PARAMS[name]
        self.name = name
        self.q, self.r = p["q"], p["r"]
        self.b1, self.b2 = p["b1"], p["b2"]
        self.loop, self.loop_negative = p["loop"], p["loop_negative"]
        self.xi = p["xi"]
        self.F1 = Fp(self.q)
        self.F2 = F2(self.F1, self.F1.neg)
        self.F6 = F3(self.F2, lambda a: self.F2.mul(self.xi, a))
        self.F12 = F2(self.F6, lambda a: (self.F2.mul(self.xi, a[2]),
                                          a[0], a[1]))
        self.G1 = Jacobian(self.F1)
        self.G2 = Jacobian(self.F2)
        self.g1 = self.G1.from_affine(*p["g1"])
        self.g2 = self.G2.from_affine(*p["g2"])

    @functools.cached_property
    def g1_table(self):
        return FixedBase(self.G1, self.g1, self.r.bit_length())

    @functools.cached_property
    def g2_table(self):
        return FixedBase(self.G2, self.g2, self.r.bit_length())

    def g1_mul(self, k: int):
        return self.g1_table.mul(k % self.r)

    def g2_mul(self, k: int):
        return self.g2_table.mul(k % self.r)

    # -- G2 into E(Fp12) -----------------------------------------------------

    def _fp12(self, a):
        z = (0, 0)
        return ((a, z, z), (z, z, z))

    @functools.cached_property
    def _w(self):
        z = (0, 0)
        return ((z, z, z), ((1, 0), z, z))

    def lift_g2(self, xy):
        """A twisted point as a point of E(Fp12): (x w^2, y w^3) for the
        D-type twist (BN128), (x w^-2, y w^-3) for the M-type (BLS12-381)."""
        F = self.F12
        w2 = F.square(self._w)
        w3 = F.mul(w2, self._w)
        if self.name == "bls12381":
            w2, w3 = F.inv(w2), F.inv(w3)
        return (F.mul(self._fp12(xy[0]), w2), F.mul(self._fp12(xy[1]), w3))

    # -- Miller loop ---------------------------------------------------------

    def _line(self, T, Q, P):
        """The line through T and Q (the tangent where T = Q) at P, and T + Q
        (None where it is zero), all affine over Fp12."""
        F = self.F12
        (xT, yT), (xQ, yQ), (xP, yP) = T, Q, P
        if F.eq(xT, xQ):
            if F.eq(yT, F.neg(yQ)):
                return F.sub(xP, xT), None
            num, den = F.mul_scalar(F.square(xT), 3), F.add(yT, yT)
        else:
            num, den = F.sub(yQ, yT), F.sub(xQ, xT)
        lam = F.mul(num, F.inv(den))
        line = F.sub(F.sub(yP, yT), F.mul(lam, F.sub(xP, xT)))
        x3 = F.sub(F.sub(F.square(lam), xT), xQ)
        return line, (x3, F.sub(F.mul(lam, F.sub(xT, x3)), yT))

    def miller_loop(self, p_xy, q_xy):
        F = self.F12
        P = (self._fp12((p_xy[0], 0)), self._fp12((p_xy[1], 0)))
        Q = self.lift_g2(q_xy)
        T, f = Q, F.one()
        for bit in bin(self.loop)[3:]:
            line, T = self._line(T, T, P)
            f = F.mul(F.square(f), line)
            if bit == "1":
                line, T = self._line(T, Q, P)
                f = F.mul(f, line)
        if self.name == "bn128":
            # the two Frobenius steps of the BN optimal ate loop
            q1 = tuple(F.exp(c, self.q) for c in Q)
            q2 = tuple(F.exp(c, self.q ** 2) for c in Q)
            line, T = self._line(T, q1, P)
            f = F.mul(f, line)
            line, T = self._line(T, (q2[0], F.neg(q2[1])), P)
            f = F.mul(f, line)
        if self.loop_negative:
            f = F.inv(f)
        return f

    def final_exponentiation(self, f):
        F, q = self.F12, self.q
        t = F.mul(F.conjugate(f), F.inv(f))
        t = F.mul(F.exp(t, q * q), t)
        return F.exp(t, (q ** 4 - q ** 2 + 1) // self.r)

    def pairing_eq(self, pairs) -> bool:
        """prod e(P_i, Q_i) == 1 over Jacobian points (a pair with a zero
        point contributes 1)."""
        F = self.F12
        acc = F.one()
        for p, q in pairs:
            a, b = self.G1.affine(p), self.G2.affine(q)
            if a is not None and b is not None:
                acc = F.mul(acc, self.miller_loop(a, b))
        return F.eq(self.final_exponentiation(acc), F.one())


@functools.lru_cache(maxsize=2)
def curve(name: str) -> Curve:
    return Curve(name)
