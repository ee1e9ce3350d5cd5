"""MNT6753 runtime: the Bowe-Gabizon verifier, PyTorch port of
wasmsnark_tpu/models/mnt6753_runtime.py (src/mnt6753.js parity).

    reference (src/mnt6753.js)        here
    --------------------------        ----
    verifySync(vk, input, proof)      verify_sync(vk, input, proof)
    verify(vk, input, proof)          verify(vk, input, proof)
    verifyFused(vk, input, proof)     verify_fused(vk, input, proof)
    (no batch API)                    bowe_gabizon_verify_batch(vk, ...)

verify_sync is the host-bigint oracle path (mnt6753.js:614-726).  verify,
verify_fused and bowe_gabizon_verify_batch run on the runtime's device (the
CUDA card unless the caller asks for the CPU): N proofs ride the lanes of

  1. marshalling: the host parses each lane, checks its input count and
     draws rho, then one upload of the lanes' canonical coordinates and
     scalars feeds a device stage built on per-key tables: vk_x as a
     fixed-base sum (ops/fixed_base.py), one 128-bit ladder for rho A,
     rho vk_x and rho C over all lanes, one batched inversion to affine,
     alphaBeta^rho as a product of 32 entries of a fixed-base F6 table,
     and the hash's bit planes cut from the same limbs;
  2. the batched Pedersen hash of the proofs' bit strings
     (models/mnt6753_device.py);
  3. blake2s per proof on the host (the reference keeps it in JS);
  4. the group map of the digests on the device;
  5. the 5-pair prepared pairing product against alphaBeta^rho, through
     independent Miller lanes and a tree product (verify) or the fused
     Miller loop (verify_fused, the batch's default).

The rho randomisation (16 random bytes) merges check1^rho * check2 into one
product e(rho A, B) e(-rho vk_x, G2) e(-rho C, dp) e(-Z, delta) e(Ys, dp)
== alphaBeta^rho, as the reference's async verify does (mnt6753.js:
1070-1083): one final exponentiation for both checks.  rho comes from
`rng` (a random.Random or anything with randbytes(n)); without one it is
os.urandom(16), as in the JAX package.

Every input scalar is reduced mod r before the upload: the curve's group
has prime order r (r G1 = 0 and |q + 1 - r| lies inside Hasse's bound), so
x P = (x mod r) P for every point of the curve, and the raw-scalar ladder
of the reference (mnt6753.js:673-676) gives the same vk_x for any input.
A key's state (the prepared (G2gen, delta) coefficients, vk_x's
fixed-base tables over its query points, the alphaBeta powers) is built
once and kept on the runtime (utils/keys.py's rule); nothing is kept per
proof or input.

Verification protocol (mnt6753.js:614-726):
  1. bits := [A.y&1, bits753(A.x), B.y.a&1, bits753(B.x.{a,b,c}),
              C.y&1, bits753(C.x), dp.y.a&1, bits753(dp.x.{a,b,c})]
  2. vk_x := query[0] + sum_i input[i] * query[i+1]
  3. check1: e(A,B) * e(-vk_x, G2gen) * e(-C, deltaPrime) == alphaBeta
  4. ys := groupMap(blake2s(pedersenHash(bits)[x, 95 bytes LE]))
  5. check2: e(ys, deltaPrime) * e(-Z, delta) == 1
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import NamedTuple

import torch

from .mnt6753 import mnt6753, Q
from .mnt6753_constants import R
from ..fields.spec import LIMB_BITS
from ..ops.curve import map_leaf, map_leaf2
from ..ops.fixed_base import FixedBaseSum
from ..ops.fp import planes, resolve_device
from ..ops.msm import times_scalar_signed_device, window_digits
from ..ops.towers import stack, unstack
from ..utils.keys import KeyCache
from ..utils.serialize import (int_to_bytes_le, ints_to_limbs,
                               ints_to_limbs_fast, is_ocam_num, parse_bigint)
from ..utils.spans import span

RHO_BITS = 128              # rho: 16 random bytes (mnt6753.js:789-800)
AB_WINDOW = 4               # alphaBeta^rho's table: 4-bit windows of rho

# a lane's canonical coordinates, in upload order: A, B, C, dp, then -Z
# (x before y, F3 components in order)
A_X, A_Y, B_X, B_Y, C_X, C_Y, DP_X, DP_Y, NZ_X, NZ_Y = (
    0, 1, 2, 5, 8, 9, 10, 13, 16, 17)
N_COORDS = 18


def _bits753(v: int):
    """LSB-first 753 bits of a canonical field value (unpackBits over the
    96-byte LE memory image, mnt6753.js:373-379)."""
    return [(v >> i) & 1 for i in range(753)]


def _digest(x: int) -> int:
    """blake2s of the 95-byte LE image of the hash's x (mnt6753.js:766)."""
    return int.from_bytes(
        hashlib.blake2s(int_to_bytes_le(x, 96)[:95]).digest(), "little")


class Lane(NamedTuple):
    """The host's part of a lane: its canonical coordinates (N_COORDS, the
    upload order), its inputs mod r and rho."""
    coords: list
    scalars: list
    rho: int


class KeyState(NamedTuple):
    """A verification key's device state, built once (span bg.vk_tables):
    coeffs, the prepared line coefficients of its fixed G2 points (G2gen,
    delta), leaves [S, L, 2]; vk_x, the FixedBaseSum over its query points
    (query[0] the start point); ab, the F6 table T[w D + d] =
    alphaBeta^(d 2^(c w)) of rho's c-bit windows, planes [L, W D]."""
    coeffs: tuple
    vk_x: FixedBaseSum
    ab: tuple


class Marshalled(NamedTuple):
    """The device inputs of a batch's lanes: g1_4, the affine Montgomery
    planes (x, y) [L, 4, N] of (rho A, -rho vk_x, -rho C, -Z); g2_var, the
    F3 planes of (B, dp), leaves [L, 2, N]; delta, the key's affine delta
    on the host; fixed, the key's prepared (G2gen, delta) coefficients;
    expected, alphaBeta^rho as F6 planes [L, N]; bits, the hash's bit
    planes [6028, N]."""
    g1_4: tuple
    g2_var: tuple
    delta: tuple
    fixed: tuple
    expected: tuple
    bits: torch.Tensor


class Mnt6753Runtime:
    """The Bowe-Gabizon verifier of MNT6753 on one torch device."""

    def __init__(self, device=None):
        self.m = mnt6753()
        self.device = resolve_device(device)
        self._keys = KeyCache()

    # -- JSON marshalling (setF1/setF3/setF6/setG1Affine/setG2Affine,
    #    mnt6753.js:492-537; values decimal strings or OCaml num triples) ----

    def _f1(self, e):
        return parse_bigint(e) % Q

    def _f3(self, e):
        return (self._f1(e["a"]), self._f1(e["b"]), self._f1(e["c"]))

    def _f6(self, e):
        return (self._f3(e["a"]), self._f3(e["b"]))

    def _g1_xy(self, e):
        return self._f1(e["x"]), self._f1(e["y"])

    def _g2_xy(self, e):
        return self._f3(e["x"]), self._f3(e["y"])

    def _g1_affine(self, e):
        return self.m.G1.from_affine(*self._g1_xy(e))

    def _g2_affine(self, e):
        return self.m.G2.from_affine(*self._g2_xy(e))

    # -- hash input bit string (mnt6753.js:645-658) ---------------------------

    @staticmethod
    def _g1_bits(p_affine):
        return [p_affine[1] & 1] + _bits753(p_affine[0])

    @staticmethod
    def _g2_bits(p_affine):
        x, y = p_affine[0], p_affine[1]
        return [y[0] & 1] + _bits753(x[0]) + _bits753(x[1]) + _bits753(x[2])

    def calculate_ys(self, a_aff, b_aff, c_aff, dp_aff):
        """Pedersen-hash the proof points, blake2s, group-map to G1
        (calculateYS, mnt6753.js:730-777), on the host."""
        bits = (self._g1_bits(a_aff) + self._g2_bits(b_aff)
                + self._g1_bits(c_aff) + self._g2_bits(dp_aff))
        return self.m.group_map(_digest(self.m.pedersen_hash(bits)))

    @staticmethod
    def _inputs(inputs):
        if inputs is None:
            return []
        if not isinstance(inputs, list) or is_ocam_num(inputs):
            return [inputs]
        return inputs

    def _vk_x(self, verification_key, inputs):
        """query[0] + sum_i input[i] query[i+1]; each scalar is the raw
        753-bit value, not reduced mod r (g1m_timesScalar over SIZEF1
        bytes, mnt6753.js:673-676)."""
        G1, query = self.m.G1, verification_key["query"]
        vk_x = self._g1_affine(query[0])
        for i, raw in enumerate(inputs):
            vk_x = G1.add(vk_x, G1.times_scalar(
                self._g1_affine(query[i + 1]), parse_bigint(raw)))
        return vk_x

    # -- the host verifier -------------------------------------------------------

    def verify_sync(self, verification_key: dict, inputs, proof: dict) -> bool:
        m = self.m
        inputs = self._inputs(inputs)
        A = m.G1.affine(self._g1_affine(proof["a"]))
        Bp = m.G2.affine(self._g2_affine(proof["b"]))
        C = m.G1.affine(self._g1_affine(proof["c"]))
        dp = m.G2.affine(self._g2_affine(proof["deltaPrime"]))
        if len(inputs) + 1 != len(verification_key["query"]):
            return False
        vk_x = self._vk_x(verification_key, inputs)
        alpha_beta = self._f6(verification_key["alphaBeta"])
        valid1 = m.pairing_eq(
            [(A, Bp), (m.G1.neg(vk_x), m.g2_gen), (m.G1.neg(C), dp)],
            expected=alpha_beta)
        if not valid1:
            return False
        ys = self.calculate_ys(A, Bp, C, dp)
        Z = self._g1_affine(proof["z"])
        delta = self._g2_affine(verification_key["delta"])
        return m.pairing_eq([(ys, dp), (m.G1.neg(Z), delta)])

    # reference API alias (main_mnt6753.js:26-44): the host-oracle path
    bowe_gabizon_verifier = verify_sync

    # -- device-batched verification ------------------------------------------

    def _marshal(self, verification_key: dict, inputs, proof: dict,
                 rng=None):
        """The host's part of a lane's marshalling: the input-count check,
        the proof's canonical coordinates (-Z negated here), the inputs mod
        r and rho.  None when the input count does not match the query
        (the lane answers False without reaching the card)."""
        inputs = self._inputs(inputs)
        if len(inputs) + 1 != len(verification_key["query"]):
            return None
        ax, ay = self._g1_xy(proof["a"])
        bx, by = self._g2_xy(proof["b"])
        cx, cy = self._g1_xy(proof["c"])
        dx, dy = self._g2_xy(proof["deltaPrime"])
        zx, zy = self._g1_xy(proof["z"])
        coords = [ax, ay, *bx, *by, cx, cy, *dx, *dy, zx, (Q - zy) % Q]
        scalars = [parse_bigint(raw) % R for raw in inputs]
        # rho: 16 random bytes (mnt6753.js:789-800), scaling A, vk_x, C and
        # the alphaBeta target, which merges both pairing checks
        raw = os.urandom(16) if rng is None else rng.randbytes(16)
        return Lane(coords, scalars, int.from_bytes(raw, "little"))

    def _key_state(self, verification_key):
        """The key's KeyState, built on its first batch (span
        bg.vk_tables) and kept on the runtime, keyed by the query points,
        alphaBeta and delta."""
        query = tuple(self._g1_xy(p) for p in verification_key["query"])
        alpha_beta = self._f6(verification_key["alphaBeta"])
        delta = self._g2_xy(verification_key["delta"])

        def build():
            with span("bg.vk_tables"):
                m, dev, pd = self.m, self._dev, self._pd
                g2gen = m.G2.affine(m.g2_gen)
                coeffs = pd.prepare_g2(pd.pack_g2([g2gen[:2], delta]))
                pts = [m.G1.from_affine(*p) for p in query]
                vk_x = FixedBaseSum(dev.G1d, m.G1, pts[0], pts[1:],
                                    dev.fp.pack_mont, R.bit_length())
                return KeyState(coeffs, vk_x, self._ab_table(alpha_beta))

        return self._keys.get((query, alpha_beta, delta), build)

    def _ab_table(self, alpha_beta):
        """T[w D + d] = alphaBeta^(d 2^(c w)) for rho's c-bit windows w
        (c = AB_WINDOW, D = 2^c), built on the host -> F6 planes
        [L, W D]."""
        F6, D = self.m.F6, 1 << AB_WINDOW
        rows, base = [], alpha_beta
        for _ in range(RHO_BITS // AB_WINDOW):
            acc = F6.one()
            rows.append(acc)
            for _ in range(D - 1):
                acc = F6.mul(acc, base)
                rows.append(acc)
            base = F6.mul(acc, base)
        return self._pd.pack_f6(rows)

    def _ab_rho(self, ab_table, rho):
        """alphaBeta^rho of every lane (rho: canonical planes [8, N]): one
        gather of its W table entries, then a product tree over them (K12).
        Powers of one element commute, so this is F6.exp(alphaBeta, rho)
        for any F6 value."""
        d = window_digits(rho, AB_WINDOW)                   # [W, N]
        W, N = d.shape
        idx = d + (torch.arange(W, device=d.device) << AB_WINDOW)[:, None]
        entries = map_leaf(ab_table, lambda a: torch.index_select(
            a, 1, idx.reshape(-1)).reshape(a.shape[0], W, N))
        return self._pd._f6_prod_pairs(entries)

    def _scalars(self, state, coords, up_scalars, rho):
        """The scalar stage, on the device with no sync: vk_x from the
        key's fixed-base tables, one signed-window ladder of rho over the
        3N lanes (A, vk_x, C), their batched inversion to affine with vk_x
        and C negated, and alphaBeta^rho as one gather from the F6 table
        and a product tree.  coords: Montgomery planes [L, N_COORDS, N];
        up_scalars: the inputs' canonical planes [L, k, N]; rho: [8, N].
        Returns (the affine planes (x, y) [L, 3, N] of rho A, -rho vk_x,
        -rho C; alphaBeta^rho as F6 planes [L, N]).  A zero point is (0,
        1), as the host oracle's affine zero."""
        G = self._dev.G1d
        F = G.F
        N = coords.shape[-1]
        one = F.one_like(coords[:, 0])
        vk_x = state.vk_x.points_jac(up_scalars)
        pts = tuple(torch.cat(c, dim=-1) for c in zip(
            (coords[:, A_X], coords[:, A_Y], one), vk_x,
            (coords[:, C_X], coords[:, C_Y], one)))
        p = times_scalar_signed_device(G, pts, torch.cat([rho] * 3, dim=1))
        zero = G.is_zero(p)
        zi = F.inv(F.select(zero, F.one_like(p[2]), p[2]))
        x, y = unstack(F.mul(stack(p[0], p[1]), zi), 2)
        y = F.cneg(torch.arange(3 * N, device=y.device) >= N, y)
        x = F.select(zero, F.zero_like(x), x)
        y = F.select(zero, F.one_like(y), y)
        g1_3 = tuple(a.reshape(a.shape[0], 3, N) for a in (x, y))
        return g1_3, self._ab_rho(state.ab, rho)

    @staticmethod
    def _bit_planes(c):
        """The hash's bit string of every lane from the canonical limb
        planes [L, N_COORDS, N] (int64 [6028, N]): per point the y parity,
        then 753 bits LSB first per x coordinate (_g1_bits and _g2_bits
        order: A, B, C, dp)."""
        c = c.long()
        sh = torch.arange(LIMB_BITS, device=c.device)
        bits = ((c[:, None] >> sh[None, :, None, None]) & 1).reshape(
            -1, *c.shape[1:])[:753]                         # [753, K, N]
        rows = []
        for x, y, n in ((A_X, A_Y, 1), (B_X, B_Y, 3), (C_X, C_Y, 1),
                        (DP_X, DP_Y, 3)):
            rows += [c[0, y][None] & 1] + [bits[:, x + j] for j in range(n)]
        return torch.cat(rows)

    def _marshal_batch(self, verification_key, inputs_list, proofs, rng):
        """bg.marshal: every lane's host marshalling, then one upload and
        the device stage (span bg.scalars).  Returns (the indices of the
        lanes the key takes, their Marshalled inputs; None where there are
        none)."""
        lanes = [self._marshal(verification_key, inp, prf, rng)
                 for inp, prf in zip(inputs_list, proofs)]
        ok_idx = [i for i, ln in enumerate(lanes) if ln is not None]
        if not ok_idx:
            return ok_idx, None
        lanes = [lanes[i] for i in ok_idx]
        state = self._key_state(verification_key)
        fp = self._dev.fp
        N, k = len(lanes), len(lanes[0].scalars)
        K = N_COORDS + k + 1
        with span("bg.scalars"):
            vals = [ln.coords[j] for j in range(N_COORDS) for ln in lanes]
            vals += [ln.scalars[j] for j in range(k) for ln in lanes]
            vals += [ln.rho for ln in lanes]
            up = planes(ints_to_limbs_fast(vals, fp.L), self.device).reshape(
                fp.L, K, N)
            canon = up[:, :N_COORDS]
            coords = fp.to_mont(canon)
            g1_3, expected = self._scalars(
                state, coords, up[:, N_COORDS:N_COORDS + k],
                up[:RHO_BITS // LIMB_BITS, K - 1])
        g1_4 = tuple(torch.cat([g, coords[:, z:z + 1]], dim=1)
                     for g, z in zip(g1_3, (NZ_X, NZ_Y)))
        g2_var = tuple(tuple(coords[:, [b + j, d + j]] for j in range(3))
                       for b, d in ((B_X, DP_X), (B_Y, DP_Y)))
        return ok_idx, Marshalled(g1_4, g2_var,
                                  self._g2_xy(verification_key["delta"]),
                                  state.coeffs, expected,
                                  self._bit_planes(canon))

    @functools.cached_property
    def _dev(self):
        from .mnt6753_device import mnt6753_device
        return mnt6753_device(self.device)

    @functools.cached_property
    def _pd(self):
        from ..ops.pairing import mnt6753_pairing_device
        return mnt6753_pairing_device(self.device)

    def _hash_to_t(self, bits):
        """Stages 2-3: the device Pedersen hash of every lane's bit planes
        [6028, N], then blake2s on the host -> the group map's inputs,
        limb planes [L, N]."""
        fp = self._dev.fp
        ped_x = fp.unpack(self._dev.pedersen_hash(bits))
        return planes(ints_to_limbs([_digest(x) for x in ped_x], fp.L),
                      self.device)

    def _ys_g1(self, t, g1_4):
        """Stage 4: group-map Ys and append it to the pairs axis of the
        four G1 points -> G1 planes [L, 5, N]."""
        ys_x, ys_y, _ = self._dev.group_map(t)
        return (torch.cat([g1_4[0], ys_x[:, None]], dim=1),
                torch.cat([g1_4[1], ys_y[:, None]], dim=1))

    def _pairing_check(self, g1, g2_var, fixed, expected, fused: bool):
        """Stage 5: assemble the 5-pair prepared coefficient stack [B,
        G2gen, dp, delta, dp] from the per-call (B, dp) ladder and the
        per-vk (G2gen, delta) one (dp's ladder runs once for both of its
        slots), then the pairing product against alphaBeta^rho -> bool
        [N]."""
        pd = self._pd
        prep = pd.prepare_g2(g2_var)                # leaves [S, L, 2, N]
        N = g1[0].shape[-1]

        def five(v, f):
            fb = f[:, :, :, None].expand(f.shape + (N,))
            return torch.cat([v[:, :, 0:1], fb[:, :, 0:1], v[:, :, 1:2],
                              fb[:, :, 1:2], v[:, :, 1:2]], dim=2)

        coeffs = map_leaf2(prep, fixed, five)
        e = pd.pairing_products_prepared(g1, coeffs, fused=fused)
        return pd.is_eq_planes(e, expected)

    def _verify_device(self, verification_key, inputs_list, proofs,
                       fused: bool, rng=None) -> list:
        """N proofs in batch lanes through the device stages, under the
        span bg.batch: bg.marshal (the lanes' host marshalling, the key's
        state, bg.vk_tables, where it is built, and the device stage
        bg.scalars), bg.hash, bg.group_map, then bg.pairing (the product
        and the verdicts' copy to the host)."""
        results = [False] * len(proofs)
        with span("bg.batch"):
            with span("bg.marshal"):
                ok_idx, mb = self._marshal_batch(verification_key,
                                                 inputs_list, proofs, rng)
                if mb is None:
                    return results
            with span("bg.hash"):
                t = self._hash_to_t(mb.bits)
            with span("bg.group_map"):
                g1 = self._ys_g1(t, mb.g1_4)
            with span("bg.pairing"):
                ok = self._pairing_check(g1, mb.g2_var, mb.fixed,
                                         mb.expected, fused).tolist()
            for pos, i in enumerate(ok_idx):
                results[i] = bool(ok[pos])
            return results

    def bowe_gabizon_verify_batch(self, verification_key, inputs_list,
                                  proofs, fused: bool = True,
                                  rng=None) -> list:
        """Batched device verification: N proofs ride the lanes of the
        Pedersen hash, the group map and one prepared 5-pair pairing
        product each (the batched answer to the reference's worker
        pool)."""
        return self._verify_device(verification_key, inputs_list, proofs,
                                   fused=fused, rng=rng)

    def verify(self, verification_key, inputs, proof, rng=None) -> bool:
        """Device verification of one proof: independent Miller lanes and a
        tree product (the reference verify's 5-worker DAG, in lanes)."""
        return self._verify_device(verification_key, [inputs], [proof],
                                   fused=False, rng=rng)[0]

    def verify_fused(self, verification_key, inputs, proof,
                     rng=None) -> bool:
        """Device verification of one proof through the fused Miller loop
        (the verifyFused analogue)."""
        return self._verify_device(verification_key, [inputs], [proof],
                                   fused=True, rng=rng)[0]
