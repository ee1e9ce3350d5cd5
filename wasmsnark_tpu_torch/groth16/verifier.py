"""Groth16 verifier for BN128 and BLS12-381, port of wasmsnark_tpu/groth16/
verifier.py — semantics of src/bn128.js:722-791.

The verification equation, exactly as the reference evaluates it:

    e(A, B) * e(-vk_x, gamma_2) * e(-C, delta_2) * e(-alfa_1, beta_2) == 1

with vk_x = IC[0] + sum_i input[i] * IC[i+1], and every public input checked
to be < r (bn128.js:776: `if int_gte(input, r) return false`).

`groth16_verify` runs the pairing on the host oracle (models/);
`Groth16BatchVerifier.verify` runs N proofs at once through the curve's
device pairing engine (ops/pairing.py), port of the JAX package's
`groth16_verify_batch`; every lane's vk_x is summed on the device from
fixed-base tables of the key's IC points (ops/fixed_base.py
`FixedBaseSum`), which the verifier builds once per key and keeps with the
key's prepared G2 coefficients (`KeyState`, utils/keys.py's rule).  Its
spans (utils/spans.py):
"verify.batch" around it, "verify.marshal" around the marshalling, and
under it "verify.vk_x_table" around a table's build and "verify.vk_x"
around the batch's vk_x stage, and "verify.pairing" around the device
pairing and the verdicts' copy to the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..fields.spec import LIMB_BITS
from ..models import curve_module
from ..ops.curve import JacobianDevice, map_leaf, map_leaf2
from ..ops.fixed_base import FixedBaseSum, batch_to_affine
from ..ops.fp import planes, resolve_device
from ..utils.keys import KeyCache
from ..utils.serialize import ints_to_limbs_fast, parse_bigint
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

class KeyState(NamedTuple):
    """A verification key's device state, built once: coeffs, the prepared
    line coefficients of its fixed G2 points (gamma2, delta2, beta2),
    leaves [S, L, 3]; vk_x, the FixedBaseSum over its IC points (IC[0] the
    start point)."""
    coeffs: tuple
    vk_x: FixedBaseSum


class Groth16BatchVerifier:
    """The batch verifier of one curve ("bn128" or "bls12381") on one torch
    device (default: the CUDA card).  It keeps each key's KeyState, keyed
    by the key's affine points (IC, gamma2, delta2, beta2)."""

    def __init__(self, curve: str = "bn128", device=None):
        self.curve = curve
        self.m = curve_module(curve)
        self.device = resolve_device(device)
        self._keys = KeyCache()

    @functools.cached_property
    def pd(self):
        """The curve's pairing engine on the verifier's device."""
        from ..ops.pairing import pairing_device
        return pairing_device(self.curve, self.device)

    def verify(self, vk: dict, inputs_list, proofs) -> list:
        """Verify N proofs against one verification key in one device pass.

        The four Miller loops of the verification equation and all N
        proofs share the lanes: leaves are [L, 4, N] limb planes, the pairs
        axis reduces with two F12 multiplies, and one final exponentiation
        closes every equation.  A lane with a zero point (vk_x included), a
        wrong input count, an input >= r or an unparsable proof is filled
        with generators and answers False.
        """
        n = len(proofs)
        if len(inputs_list) != n:
            raise ValueError(f"{len(inputs_list)} input lists for {n} proofs")
        if n == 0:
            return []
        with span("verify.batch"):
            pd = self.pd
            with span("verify.marshal"):
                g1, g2_b, fixed, ok_host, vk_x_ok = self._batch_inputs(
                    vk, inputs_list, proofs)
            with span("verify.pairing"):
                ok = (pd.is_one(_pairing_batch(pd, g1, g2_b, fixed))
                      & vk_x_ok).cpu().tolist()
            return [bool(ok[i]) and ok_host[i] for i in range(n)]

    def _batch_inputs(self, vk, inputs_list, proofs):
        """Marshalling of a batch: the G1 planes of the four pairs
        (A, -vk_x, -C, -alfa1) as leaves [L, 4, N], pi_b as F2 leaves
        [L, 1, N], the vk's prepared (gamma2, delta2, beta2) coefficients,
        per lane whether the host let it through, and per lane (a device
        mask) whether vk_x is not the zero point.  The host parses the
        points and checks the inputs; vk_x is the device stage
        `_vk_x_device`."""
        pd, m = self.pd, self.m
        R = m.Fr.q
        n = len(proofs)
        g1_rows = [[], [], []]       # A, -C, -alfa1
        g2_b = []                    # B
        ok_host = [True] * n

        alfa1 = _g1_from_json(m, vk["vk_alfa_1"])
        beta2 = _g2_from_json(m, vk["vk_beta_2"])
        gamma2 = _g2_from_json(m, vk["vk_gamma_2"])
        delta2 = _g2_from_json(m, vk["vk_delta_2"])
        ic = [_g1_from_json(m, p) for p in vk["IC"]]
        g1_gen = m.G1.affine(m.g1_gen)
        g2_gen = m.G2.affine(m.g2_gen)
        scalars = [[0] * n for _ in range(len(ic) - 1)]   # [input, lane]

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
                values = [parse_bigint(raw) for raw in inputs]
                if any(v >= R for v in values):
                    raise ValueError("input >= r")
                pts1 = [A, m.G1.neg(C), m.G1.neg(alfa1)]
                if any(m.G1.is_zero(p) for p in pts1) or any(
                        m.G2.is_zero(p) for p in (B, gamma2, delta2, beta2)):
                    raise ValueError("zero point")
                for k in range(3):
                    a1 = m.G1.affine(pts1[k])
                    g1_rows[k].append((a1[0], a1[1]))
                a2 = m.G2.affine(B)
                g2_b.append((a2[0], a2[1]))
                # a negative input as its residue: the same multiple of the
                # r-order IC points as the host ladder's -v P
                for j, v in enumerate(values):
                    scalars[j][i] = v % R
            except (ValueError, KeyError, TypeError):
                # keep the lanes rectangular with generator pairs, which
                # cannot satisfy the equation, and zero scalars; the host
                # has decided this lane
                ok_host[i] = False
                for k in range(3):
                    g1_rows[k].append((g1_gen[0], g1_gen[1]))
                g2_b.append((g2_gen[0], g2_gen[1]))

        # every upload before the vk_x stage's launches
        rows = map_leaf(pd.pack_g1([p for row in g1_rows for p in row]),
                        lambda a: a.reshape(a.shape[0], 3, n))  # [L, 3, N]
        # only pair 0's G2 point (pi_b) varies per proof; gamma2, delta2
        # and beta2 ride the key's prepared coefficients
        g2 = map_leaf(pd.pack_g2(g2_b),
                      lambda a: a.reshape(a.shape[0], 1, n))
        state = self._key_state(ic, (gamma2, delta2, beta2))
        with span("verify.vk_x"):
            neg_vk_x, vk_x_ok = _vk_x_device(pd, m, state.vk_x, scalars, n)
        g1 = map_leaf2(rows, neg_vk_x, lambda r, v: torch.stack(
            (r[:, 0], v, r[:, 1], r[:, 2]), dim=1))            # [L, 4, N]
        return g1, g2, state.coeffs, ok_host, vk_x_ok

    def _key_state(self, ic, g2_fixed):
        """The key's KeyState, built on its first batch: the prepared
        coefficients of g2_fixed, then the IC points' tables."""
        pd, m = self.pd, self.m
        g2 = tuple((p[0], p[1]) for p in (m.G2.affine(q) for q in g2_fixed))
        return self._keys.get(
            (tuple(tuple(p) for p in ic), g2),
            lambda: KeyState(pd.prepare_g2(pd.pack_g2(list(g2))),
                             _vk_x_table(pd, m, ic)))


@functools.lru_cache(maxsize=8)
def _verifier(curve: str, device) -> Groth16BatchVerifier:
    return Groth16BatchVerifier(curve, device)


def groth16_verify_batch(vk: dict, inputs_list, proofs, curve: str = "bn128",
                         device=None) -> list:
    """Module-level batch verify (the JAX package's entry point): the
    Groth16BatchVerifier of `curve` on `device` (default: the CUDA card),
    one per curve and device, verifies the batch."""
    return _verifier(curve, resolve_device(device)).verify(
        vk, inputs_list, proofs)


def _vk_x_table(pd, m, ic):
    """The fixed-base tables of the vk's IC points (IC[0] the start
    point), under the span verify.vk_x_table."""
    with span("verify.vk_x_table"):
        return FixedBaseSum(
            JacobianDevice(pd.base), m.G1, ic[0], ic[1:], pd.fp.pack_mont,
            m.fr_spec.n_limbs * LIMB_BITS)


def _vk_x_device(pd, m, table, scalars, n):
    """-vk_x of every lane, vk_x = IC[0] + sum_j scalars[j][lane] IC[j+1]:
    the scalars' upload, the table's sum and one batched inversion, with
    no sync.  Returns the affine Montgomery planes (x, y) [L, N] of -vk_x,
    the generator's negation where vk_x is the zero point, and the mask of
    the lanes where it is not."""
    F = table.curve.F
    gen = m.G1.affine(m.g1_gen)
    gx, gy = pd.pack_g1([(gen[0], gen[1])])                    # [L, 1]
    s = planes(ints_to_limbs_fast([v for row in scalars for v in row],
                                  m.fr_spec.n_limbs), pd.device)
    p = table.points_jac(s.reshape(s.shape[0], len(scalars), n))
    zero = table.curve.is_zero(p)
    x, y = batch_to_affine(table.curve, p)
    return (F.select(zero, gx, x), F.neg(F.select(zero, gy, y))), ~zero


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
