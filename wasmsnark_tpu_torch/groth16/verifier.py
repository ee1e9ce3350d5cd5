"""Groth16 verifier for BN128 and BLS12-381, port of wasmsnark_tpu/groth16/
verifier.py — semantics of src/bn128.js:722-791.

The verification equation, exactly as the reference evaluates it:

    e(A, B) * e(-vk_x, gamma_2) * e(-C, delta_2) * e(-alfa_1, beta_2) == 1

with vk_x = IC[0] + sum_i input[i] * IC[i+1], and every public input checked
to be < r (bn128.js:776: `if int_gte(input, r) return false`).

`groth16_verify` runs the pairing on the host oracle (models/);
`groth16_verify_batch` runs N proofs at once through the curve's device
pairing engine (ops/pairing.py), port of the JAX package's
`groth16_verify_batch`.  Its spans (utils/spans.py): "verify.batch" around
it, "verify.marshal" around the host marshalling with one "verify.vk_x" a
lane that reaches its vk_x ladder, and "verify.pairing" around the device
pairing and the verdicts' copy to the host.
"""

from __future__ import annotations

import torch

from ..models import curve_module
from ..ops.curve import map_leaf, map_leaf2
from ..utils.serialize import parse_bigint
from ..utils.spans import span


def _g1_from_json(m, pt):
    x, y, z = (parse_bigint(c) for c in pt[:3])
    if z == 0:
        return m.G1.zero()
    # normalize: reference JSON always has z==1 for affine points
    p = (m.F1.elem(x), m.F1.elem(y), m.F1.elem(z))
    return m.G1.affine(p) if z != 1 else p


def _g2_from_json(m, pt):
    q = m.F1.q
    xs, ys, zs = pt[:3]
    x = (parse_bigint(xs[0]) % q, parse_bigint(xs[1]) % q)
    y = (parse_bigint(ys[0]) % q, parse_bigint(ys[1]) % q)
    z = (parse_bigint(zs[0]) % q, parse_bigint(zs[1]) % q)
    if z == (0, 0):
        return m.G2.zero()
    p = (x, y, z)
    return m.G2.affine(p) if z != (1, 0) else p


def groth16_verify(vk: dict, inputs, proof: dict,
                   curve: str = "bn128") -> bool:
    """Verify a proof against a snarkjs-style verification key JSON.

    `vk`: dict with vk_alfa_1, vk_beta_2, vk_gamma_2, vk_delta_2, IC.
    `inputs`: list of public inputs (ints / decimal strings); a scalar or
    OCaml-num value is wrapped, mirroring bn128.js:724-728.
    `proof`: dict with pi_a (G1), pi_b (G2), pi_c (G1).
    """
    m = curve_module(curve)
    R = m.Fr.q

    if inputs is None:
        inputs = []
    elif not isinstance(inputs, list):
        inputs = [inputs]

    A = _g1_from_json(m, proof["pi_a"])
    B = _g2_from_json(m, proof["pi_b"])
    C = _g1_from_json(m, proof["pi_c"])

    alfa1 = _g1_from_json(m, vk["vk_alfa_1"])
    beta2 = _g2_from_json(m, vk["vk_beta_2"])
    gamma2 = _g2_from_json(m, vk["vk_gamma_2"])
    delta2 = _g2_from_json(m, vk["vk_delta_2"])
    ic = [_g1_from_json(m, p) for p in vk["IC"]]

    if len(inputs) + 1 != len(ic):
        return False

    vk_x = ic[0]
    for i, raw in enumerate(inputs):
        v = parse_bigint(raw)
        if v >= R:  # input < r check (bn128.js:776)
            return False
        vk_x = m.G1.add(vk_x, m.G1.times_scalar(ic[i + 1], v))

    return m.pairing_eq([
        (A, B),
        (m.G1.neg(vk_x), gamma2),
        (m.G1.neg(C), delta2),
        (m.G1.neg(alfa1), beta2),
    ])


# ---------------------------------------------------------------------------
# Batched device verification
# ---------------------------------------------------------------------------

def groth16_verify_batch(vk: dict, inputs_list, proofs, curve: str = "bn128",
                         device=None) -> list:
    """Verify N proofs against one verification key in one device pass.

    The four Miller loops of the verification equation and all N proofs
    share the lanes: leaves are [L, 4, N] limb planes, the pairs axis
    reduces with two F12 multiplies, and one final exponentiation closes
    every equation.  `device` is the torch device (default: the CUDA
    card); `curve` picks the pairing engine of that device, whose
    vk_prep_cache keeps the vk's prepared ladders.  A lane with a zero
    point, a wrong input count, an input >= r or an unparsable proof is
    filled with generators and answers False.
    """
    from ..ops.pairing import pairing_device

    m = curve_module(curve)
    n = len(proofs)
    if len(inputs_list) != n:
        raise ValueError(f"{len(inputs_list)} input lists for {n} proofs")
    if n == 0:
        return []
    with span("verify.batch"):
        pd = pairing_device(curve, device)
        with span("verify.marshal"):
            g1, g2_b, fixed, ok_host = _batch_inputs(pd, m, vk, inputs_list,
                                                     proofs)
        with span("verify.pairing"):
            ok = pd.is_one(_pairing_batch(pd, g1, g2_b, fixed)).cpu().tolist()
        return [bool(ok[i]) and ok_host[i] for i in range(n)]


def _batch_inputs(pd, m, vk, inputs_list, proofs):
    """Host marshalling of a batch: the G1 planes of the four pairs
    (A, -vk_x, -C, -alfa1) as leaves [L, 4, N], pi_b as F2 leaves
    [L, 1, N], the vk's prepared (gamma2, delta2, beta2) coefficients, and
    per lane whether the host let it through."""
    R = m.Fr.q
    n = len(proofs)
    g1_rows = [[], [], [], []]   # A, -vk_x, -C, -alfa1
    g2_b = []                    # B
    ok_host = [True] * n

    alfa1 = _g1_from_json(m, vk["vk_alfa_1"])
    beta2 = _g2_from_json(m, vk["vk_beta_2"])
    gamma2 = _g2_from_json(m, vk["vk_gamma_2"])
    delta2 = _g2_from_json(m, vk["vk_delta_2"])
    ic = [_g1_from_json(m, p) for p in vk["IC"]]
    g1_gen = m.G1.affine(m.g1_gen)
    g2_gen = m.G2.affine(m.g2_gen)

    for i, (inputs, proof) in enumerate(zip(inputs_list, proofs)):
        if inputs is None:
            inputs = []
        elif not isinstance(inputs, list):
            inputs = [inputs]
        try:
            A = _g1_from_json(m, proof["pi_a"])
            B = _g2_from_json(m, proof["pi_b"])
            C = _g1_from_json(m, proof["pi_c"])
            if len(inputs) + 1 != len(ic):
                raise ValueError("bad input count")
            with span("verify.vk_x"):
                vk_x = ic[0]
                for j, raw in enumerate(inputs):
                    v = parse_bigint(raw)
                    if v >= R:
                        raise ValueError("input >= r")
                    vk_x = m.G1.add(vk_x, m.G1.times_scalar(ic[j + 1], v))
            pts1 = [A, m.G1.neg(vk_x), m.G1.neg(C), m.G1.neg(alfa1)]
            if any(m.G1.is_zero(p) for p in pts1) or any(
                    m.G2.is_zero(p) for p in (B, gamma2, delta2, beta2)):
                raise ValueError("zero point")
            for k in range(4):
                a1 = m.G1.affine(pts1[k])
                g1_rows[k].append((a1[0], a1[1]))
            a2 = m.G2.affine(B)
            g2_b.append((a2[0], a2[1]))
        except (ValueError, KeyError, TypeError):
            # keep the lanes rectangular with generator pairs, which cannot
            # satisfy the equation; the host has decided this lane
            ok_host[i] = False
            for k in range(4):
                g1_rows[k].append((g1_gen[0], g1_gen[1]))
            g2_b.append((g2_gen[0], g2_gen[1]))

    g1 = pd.pack_g1([p for row in g1_rows for p in row])      # [L, 4N]
    g1 = map_leaf(g1, lambda a: a.reshape(a.shape[0], 4, n))
    # only pair 0's G2 point (pi_b) varies per proof; gamma2, delta2 and
    # beta2 ride the prepared-coefficient cache
    g2 = map_leaf(pd.pack_g2(g2_b), lambda a: a.reshape(a.shape[0], 1, n))
    fixed = _prepared_vk_coeffs(pd, m, (gamma2, delta2, beta2))
    return g1, g2, fixed, ok_host


def _prepared_vk_coeffs(pd, m, g2_fixed):
    """Prepared line coefficients of the vk's fixed G2 points (gamma2,
    delta2, beta2): leaves [S, L, 3], cached on the device's pairing
    engine, keyed by the points, at most 4 keys."""
    key = tuple((p[0], p[1]) for p in (m.G2.affine(q) for q in g2_fixed))
    cache = pd.vk_prep_cache
    if key not in cache:
        if len(cache) >= 4:
            cache.clear()
        cache[key] = pd.prepare_g2(pd.pack_g2(list(key)))
    return cache[key]


def _pairing_batch(pd, g1, g2_b, fixed):
    """The device half of a batch: pi_b's ladder, the prepared Miller
    loops of the four pairs, their product and the final exponentiation.
    g1 leaves [L, 4, N]; g2_b F2 leaves [L, 1, N]; fixed coefficient
    leaves [S, L, 3].  Returns the F12 value of each lane."""
    prep_b = pd.prepare_g2(g2_b)                   # leaves [S, L, 1, N]
    N = g1[0].shape[-1]
    coeffs = map_leaf2(prep_b, fixed, lambda b, f: torch.cat(
        [b, f[..., None].expand(f.shape[:2] + (3, N))], dim=2))
    return pd.pairing_product_prepared(g1, coeffs, 4)
