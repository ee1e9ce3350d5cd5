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

  1. host marshalling: affine proof points, the vk_x ladder, the rho
     randomisation and alphaBeta^rho;
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

import numpy as np
import torch

from .mnt6753 import mnt6753, Q
from ..ops.curve import map_leaf2
from ..ops.fp import planes, resolve_device
from ..utils.serialize import (int_to_bytes_le, ints_to_limbs, is_ocam_num,
                               parse_bigint)
from ..utils.spans import span


def _bits753(v: int):
    """LSB-first 753 bits of a canonical field value (unpackBits over the
    96-byte LE memory image, mnt6753.js:373-379)."""
    return [(v >> i) & 1 for i in range(753)]


def _digest(x: int) -> int:
    """blake2s of the 95-byte LE image of the hash's x (mnt6753.js:766)."""
    return int.from_bytes(
        hashlib.blake2s(int_to_bytes_le(x, 96)[:95]).digest(), "little")


class Mnt6753Runtime:
    """The Bowe-Gabizon verifier of MNT6753 on one torch device."""

    def __init__(self, device=None):
        self.m = mnt6753()
        self.device = resolve_device(device)

    # -- JSON marshalling (setF1/setF3/setF6/setG1Affine/setG2Affine,
    #    mnt6753.js:492-537; values decimal strings or OCaml num triples) ----

    def _f1(self, e):
        return parse_bigint(e) % Q

    def _f3(self, e):
        return (self._f1(e["a"]), self._f1(e["b"]), self._f1(e["c"]))

    def _f6(self, e):
        return (self._f3(e["a"]), self._f3(e["b"]))

    def _g1_affine(self, e):
        return self.m.G1.from_affine(self._f1(e["x"]), self._f1(e["y"]))

    def _g2_affine(self, e):
        return self.m.G2.from_affine(self._f3(e["x"]), self._f3(e["y"]))

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
        """Host marshalling of the device paths: affine proof points, the
        vk_x ladder, rho, alphaBeta^rho and the hash's bit string.  None
        when the input count does not match the query (the lane answers
        False)."""
        m = self.m
        inputs = self._inputs(inputs)
        if len(inputs) + 1 != len(verification_key["query"]):
            return None
        A = m.G1.affine(self._g1_affine(proof["a"]))
        Bp = m.G2.affine(self._g2_affine(proof["b"]))
        C = m.G1.affine(self._g1_affine(proof["c"]))
        dp = m.G2.affine(self._g2_affine(proof["deltaPrime"]))
        Z = m.G1.affine(self._g1_affine(proof["z"]))
        delta = m.G2.affine(self._g2_affine(verification_key["delta"]))
        vk_x = self._vk_x(verification_key, inputs)

        # rho: 16 random bytes (mnt6753.js:789-800), scaling A, vk_x, C and
        # the alphaBeta target, which merges both pairing checks
        raw = os.urandom(16) if rng is None else rng.randbytes(16)
        rho = int.from_bytes(raw, "little")
        G1 = m.G1

        def aff(p):
            return G1.affine(p)[:2]

        rA = aff(G1.times_scalar(G1.from_affine(*A[:2]), rho))
        n_vkx = aff(G1.neg(G1.times_scalar(vk_x, rho)))
        nC = aff(G1.neg(G1.times_scalar(G1.from_affine(*C[:2]), rho)))
        nZ = aff(G1.neg(G1.from_affine(*Z[:2])))
        ab_rho = m.F6.exp(self._f6(verification_key["alphaBeta"]), rho)
        bits = (self._g1_bits(A) + self._g2_bits(Bp)
                + self._g1_bits(C) + self._g2_bits(dp))
        return {
            # pair order: (rho A, B), (-rho vk_x, G2gen), (-rho C, dp),
            # (-Z, delta), (Ys, dp); Ys is appended on the device, G2gen
            # and delta ride the per-vk prepared coefficients
            "g1_4": [rA, n_vkx, nC, nZ],
            "g2_var": [(Bp[0], Bp[1]), (dp[0], dp[1])],
            "delta": (delta[0], delta[1]),
            "expected": ab_rho,
            "bits": bits,
        }

    @functools.cached_property
    def _dev(self):
        from .mnt6753_device import mnt6753_device
        return mnt6753_device(self.device)

    @functools.cached_property
    def _pd(self):
        from ..ops.pairing import mnt6753_pairing_device
        return mnt6753_pairing_device(self.device)

    def _fixed_coeffs(self, delta_aff):
        """Prepared line coefficients of the verification equation's two
        fixed G2 points, G2gen and vk.delta (leaves [S, L, 2]), computed
        once per vk and device and kept in the engine's vk_prep_cache (at
        most 4 keys, as the JAX package's cache)."""
        cache = self._pd.vk_prep_cache
        if delta_aff not in cache:
            g2gen = self.m.G2.affine(self.m.g2_gen)
            packed = self._pd.pack_g2([(g2gen[0], g2gen[1]), delta_aff])
            if len(cache) >= 4:
                cache.clear()
            cache[delta_aff] = self._pd.prepare_g2(packed)
        return cache[delta_aff]

    def _pairing_inputs(self, batch):
        """The device inputs of marshalled lanes: (g1_4 planes, the varying
        G2 points (B, dp), expected F6 planes)."""
        fp, pd = self._pd.fp, self._pd

        def g1comp(i):
            return torch.stack([fp.pack_mont([mm["g1_4"][k][i]
                                              for mm in batch])
                                for k in range(4)], dim=1)

        def g2comp(i, j):
            return torch.stack([fp.pack_mont([mm["g2_var"][k][i][j]
                                              for mm in batch])
                                for k in range(2)], dim=1)

        g2_var = (tuple(g2comp(0, j) for j in range(3)),
                  tuple(g2comp(1, j) for j in range(3)))
        return ((g1comp(0), g1comp(1)), g2_var,
                pd.pack_f6([mm["expected"] for mm in batch]))

    def _hash_to_t(self, batch):
        """Stages 2-3: the device Pedersen hash of every lane's bit string,
        then blake2s on the host -> the group map's inputs, limb planes
        [L, N]."""
        fp = self._dev.fp
        bits = torch.from_numpy(np.asarray(
            [mm["bits"] for mm in batch], dtype=np.int64).T.copy())
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

    def _check(self, t, g1_4, g2_var, fixed, expected, fused: bool):
        """Stages 4-5 -> bool [N]."""
        return self._pairing_check(self._ys_g1(t, g1_4), g2_var, fixed,
                                   expected, fused)

    def _verify_device(self, verification_key, inputs_list, proofs,
                       fused: bool, rng=None) -> list:
        """N proofs in batch lanes through the device stages, under the
        span bg.batch: bg.marshal (the lanes' host marshalling and their
        packing), bg.hash, bg.group_map, then bg.pairing (the key's
        prepared coefficients, the product and the verdicts' copy to the
        host)."""
        with span("bg.batch"):
            with span("bg.marshal"):
                ms = [self._marshal(verification_key, inp, prf, rng)
                      for inp, prf in zip(inputs_list, proofs)]
                ok_idx = [i for i, mm in enumerate(ms) if mm is not None]
                results = [False] * len(ms)
                if not ok_idx:
                    return results
                batch = [ms[i] for i in ok_idx]
                g1_4, g2_var, expected = self._pairing_inputs(batch)
            with span("bg.hash"):
                t = self._hash_to_t(batch)
            with span("bg.group_map"):
                g1 = self._ys_g1(t, g1_4)
            with span("bg.pairing"):
                fixed = self._fixed_coeffs(batch[0]["delta"])
                ok = self._pairing_check(g1, g2_var, fixed, expected,
                                         fused).tolist()
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
