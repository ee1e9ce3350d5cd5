"""Groth16 worked out from the circuit and the setup's trapdoor, in
plain integers: the QAP of every signal at tau, the verifying key, the
exact proof a prover must return for a witness and its blinding, and the
verification equation, by the pairing and in the exponent.

The proving-key conventions are those of the key format the program
reads (old snarkjs "groth", wasmsnark's tools/buildpkey.js): one binding
row (s_i) * (0) = 0 appended for ONE and each public signal; the domain
is the 2^k-th roots of unity of `pairing.domain_root`; pi_c carries the
private signals' C points and the H term sum_j h_j tau^j Z(tau) / delta;
the trapdoor is random.Random(seed)'s first five randrange(1, r): tau,
alpha, beta, gamma, delta."""

from __future__ import annotations

import dataclasses
import random

from .pairing import Curve, domain_root


@dataclasses.dataclass(frozen=True)
class Trapdoor:
    tau: int
    alpha: int
    beta: int
    gamma: int
    delta: int

    @classmethod
    def draw(cls, seed: int, r: int) -> "Trapdoor":
        rng = random.Random(seed)
        return cls(*(rng.randrange(1, r) for _ in range(5)))


@dataclasses.dataclass
class QAP:
    """u_i(tau), v_i(tau), w_i(tau) of every signal, and Z(tau)."""
    a: list
    b: list
    c: list
    z: int
    domain: int


def qap_at(constraints, n_signals: int, n_public: int, tau: int,
           r: int) -> QAP:
    rows = list(constraints) + [({i: 1}, {}, {})
                                for i in range(n_public + 1)]
    bits = max(1, (len(rows) - 1).bit_length())
    n = 1 << bits
    w = domain_root(r, bits)
    z = (pow(tau, n, r) - 1) % r
    # L_k(tau) = w^k Z(tau) / (n (tau - w^k)), one inversion for all rows
    wk, pts = 1, []
    for _ in rows:
        pts.append(wk)
        wk = wk * w % r
    prefix = [1]
    for p in pts:
        prefix.append(prefix[-1] * (tau - p) % r)
    inv = pow(prefix[-1], -1, r)
    scale = z * pow(n, -1, r) % r
    lag = [0] * len(rows)
    for k in range(len(rows) - 1, -1, -1):
        lag[k] = pts[k] * scale % r * (prefix[k] * inv % r) % r
        inv = inv * (tau - pts[k]) % r
    a, b, c = [0] * n_signals, [0] * n_signals, [0] * n_signals
    for k, (A, B, C) in enumerate(rows):
        lk = lag[k]
        for out, lc in ((a, A), (b, B), (c, C)):
            for s, v in lc.items():
                out[s] = (out[s] + v * lk) % r
    return QAP(a, b, c, z, n)


@dataclasses.dataclass
class VerifyingKey:
    """The key's points (Jacobian) and its IC scalars."""
    alpha1: tuple
    beta2: tuple
    gamma2: tuple
    delta2: tuple
    ic: list            # points
    ic_scalars: list


def verifying_key(curve: Curve, qap: QAP, td: Trapdoor,
                  n_public: int) -> VerifyingKey:
    r = curve.r
    gi = pow(td.gamma, -1, r)
    ics = [k * gi % r for k in private_coeffs(qap, td, r)[:n_public + 1]]
    return VerifyingKey(curve.g1_mul(td.alpha), curve.g2_mul(td.beta),
                        curve.g2_mul(td.gamma), curve.g2_mul(td.delta),
                        [curve.g1_mul(k) for k in ics], ics)


def vk_json(curve: Curve, vk: VerifyingKey, n_public: int) -> dict:
    """The key in the snarkjs JSON layout the verifier reads."""
    return {"protocol": "groth", "nPublic": n_public,
            "vk_alfa_1": g1_json(curve, vk.alpha1),
            "vk_beta_2": g2_json(curve, vk.beta2),
            "vk_gamma_2": g2_json(curve, vk.gamma2),
            "vk_delta_2": g2_json(curve, vk.delta2),
            "IC": [g1_json(curve, p) for p in vk.ic]}


def g1_json(curve: Curve, p) -> list:
    xy = curve.G1.affine(p)
    return ["0", "1", "0"] if xy is None else [str(xy[0]), str(xy[1]), "1"]


def g2_json(curve: Curve, p) -> list:
    xy = curve.G2.affine(p)
    if xy is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    return [[str(xy[0][0]), str(xy[0][1])], [str(xy[1][0]), str(xy[1][1])],
            ["1", "0"]]


def private_coeffs(qap: QAP, td: Trapdoor, r: int) -> list:
    """(beta u_i + alpha v_i + w_i)(tau) of every signal: the C point of
    a private signal is this over delta, an IC point this over gamma."""
    return [(td.beta * a + td.alpha * b + c) % r
            for a, b, c in zip(qap.a, qap.b, qap.c)]


def proof_scalars(qap: QAP, td: Trapdoor, kc, witness, n_public: int,
                  r: int, blind_r: int, blind_s: int) -> tuple:
    """The discrete logs (a, b, c) of the proof (A, B, C) a Groth16 prover
    returns for this witness and blinding (r, s), with kc the
    private_coeffs: A = alpha + A_w(tau) + r delta, B = beta + B_w(tau)
    + s delta, C = (sum over private signals of w_i kc_i + H(tau) Z(tau))
    / delta + s A + r B - r s delta, where H Z = A_w B_w - C_w."""
    aw = sum(x * u for x, u in zip(witness, qap.a) if x) % r
    bw = sum(x * v for x, v in zip(witness, qap.b) if x) % r
    cw = sum(x * w for x, w in zip(witness, qap.c) if x) % r
    priv = sum(x * k for x, k in zip(witness[n_public + 1:],
                                     kc[n_public + 1:]) if x) % r
    di = pow(td.delta, -1, r)
    a = (td.alpha + aw + blind_r * td.delta) % r
    b = (td.beta + bw + blind_s * td.delta) % r
    c = ((priv + aw * bw - cw) * di + blind_s * a + blind_r * b
         - blind_r * blind_s * td.delta) % r
    return a, b, c


def proof_json(curve: Curve, a: int, b: int, c: int) -> dict:
    """The proof with these discrete logs, in the prover's JSON layout."""
    return {"pi_a": g1_json(curve, curve.g1_mul(a)),
            "pi_b": g2_json(curve, curve.g2_mul(b)),
            "pi_c": g1_json(curve, curve.g1_mul(c)), "protocol": "groth"}


def inputs_ok(inputs, n_public: int, r: int) -> bool:
    """The verifier's checks on the public inputs: as many as the key
    has, each an integer below r."""
    return len(inputs) == n_public and all(0 <= int(v) < r for v in inputs)


def verify_exponent(td: Trapdoor, ic_scalars, inputs, a: int, b: int,
                    c: int, r: int, check_range: bool = True) -> bool:
    """The verification equation e(A, B) = e(alpha, beta) e(vk_x, gamma)
    e(C, delta) in the exponent, for a proof whose discrete logs are
    known: a b = alpha beta + x gamma + c delta (mod r)."""
    if check_range and not inputs_ok(inputs, len(ic_scalars) - 1, r):
        return False
    if len(inputs) != len(ic_scalars) - 1:
        return False
    x = (ic_scalars[0] + sum(int(v) * k for v, k in
                             zip(inputs, ic_scalars[1:]))) % r
    return (a * b - td.alpha * td.beta - x * td.gamma - c * td.delta) % r == 0


def parse_proof(curve: Curve, proof: dict):
    """(A, B, C) Jacobian points of a proof in the JSON layout."""
    def g1(v):
        x, y, z = (int(s) for s in v[:3])
        return curve.G1.zero() if z == 0 else (x, y, z)

    def g2(v):
        x, y, z = (tuple(int(s) for s in c) for c in v[:3])
        return curve.G2.zero() if z == (0, 0) else (x, y, z)

    return g1(proof["pi_a"]), g2(proof["pi_b"]), g1(proof["pi_c"])


def verify_pairing(curve: Curve, vk: VerifyingKey, inputs, proof: dict,
                   check_range: bool = True) -> bool:
    """The Groth16 verifier: inputs checked, vk_x = IC_0 + sum v_i IC_i,
    then e(A, B) e(-vk_x, gamma) e(-C, delta) e(-alpha, beta) == 1."""
    r = curve.r
    if len(inputs) != len(vk.ic) - 1:
        return False
    if check_range and not inputs_ok(inputs, len(vk.ic) - 1, r):
        return False
    A, B, C = parse_proof(curve, proof)
    G1 = curve.G1
    for p in (A, C):
        if not G1.is_zero(p) and not G1.on_curve(G1.affine(p), curve.b1):
            return False
    if not curve.G2.is_zero(B) and not curve.G2.on_curve(
            curve.G2.affine(B), curve.b2):
        return False
    vk_x = vk.ic[0]
    for v, p in zip(inputs, vk.ic[1:]):
        vk_x = G1.add(vk_x, G1.times_scalar(p, int(v) % r))
    return curve.pairing_eq([(A, B), (G1.neg(vk_x), vk.gamma2),
                             (G1.neg(C), vk.delta2),
                             (G1.neg(vk.alpha1), vk.beta2)])
