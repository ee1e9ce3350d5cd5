"""Port parity for the MNT6753 pairing engine (ops/pairing.py
Mnt6753PairingDevice, L = 48) against the JAX package, on the CPU with the
plain versions of K12-K14.

References: the JAX host oracle (`Mnt6753.pairing`, `miller_loop`,
`final_exponentiation`, `_frobenius6`) for the unprepared and fused
pairing products and the final exponentiation; the JAX engine's own
prepared-coefficient steps (`Mnt6753PairingDevice._dbl_coefs` /
`_add_coefs`) driven over the integer base adapter of
tests/test_torch_mnt_kernels.py for every step of
prepare_g2; its Frobenius constants (`_frob_fp`) and its step schedule.
Every comparison is bit-exact on canonical values.
"""

import random
import types

import numpy as np
import torch

from wasmsnark_tpu.models.mnt6753 import mnt6753 as jmnt
from wasmsnark_tpu.ops.pairing import Mnt6753PairingDevice as JPD
from wasmsnark_tpu.ops.pairing import _step_flags as jstep_flags
from wasmsnark_tpu.ops.towers import F3Device

from wasmsnark_tpu_torch.ops import fp as tfp
from wasmsnark_tpu_torch.ops.curve import map_leaf
from wasmsnark_tpu_torch.ops.pairing import (mnt6753_pairing_device,
                                             pairing_device)

from test_torch_mnt_kernels import IntBase

torch.set_num_threads(1)

jm = jmnt()
Q = jm.fp_spec.q
pd = mnt6753_pairing_device("cpu")


def _points(seed, n):
    """n affine random multiples of the G1 and the G2 generator."""
    rng = random.Random(seed)
    ks = [rng.randrange(1, 1 << 64) for _ in range(2 * n)]
    g1 = [jm.G1.affine(jm.G1.times_scalar(jm.g1_gen, k))[:2] for k in ks[:n]]
    g2 = [jm.G2.affine(jm.G2.times_scalar(jm.g2_gen, k))[:2] for k in ks[n:]]
    return g1, g2


def test_engine_constants_and_schedule():
    """The step schedule, the loop bits and the Frobenius constants equal
    the JAX engine's; pairing_device("mnt6753") is this engine."""
    j = JPD()
    assert np.array_equal(pd._prep_flags, np.asarray(jstep_flags(
        j.loop_bits)))
    assert np.array_equal(pd.loop_bits, j.loop_bits)
    assert len(pd._prep_flags) == 550 and int(pd._prep_flags.sum()) == 174
    for ours, theirs in zip(pd._frob_fp, j._frob_fp, strict=True):
        assert np.array_equal(tfp.to_numpy(ours), np.asarray(theirs))
    assert pairing_device("mnt6753", "cpu") is pd


def test_prepare_g2_every_step_against_the_jax_coefficient_steps():
    """prepare_g2 on one lane: all 550 steps' (c_y, c_x, c_0) equal the JAX
    engine's _dbl_coefs / _add_coefs run over Python ints."""
    _, g2 = _points(1, 1)
    base = IntBase()
    F3 = F3Device(base, lambda a: base.mul_small(a, 11))
    ns = types.SimpleNamespace(
        F3d=F3, mulv=lambda a: (base.mul_small(a[2], 11), a[0], a[1]))
    xQ, yQ = g2[0]
    X, Y, Z = xQ, yQ, (1, 0, 0)
    want = []
    for flag in pd._prep_flags.tolist():
        if flag:
            c, X, Y, Z = JPD._add_coefs(ns, X, Y, Z, xQ, yQ)
        else:
            c, X, Y, Z = JPD._dbl_coefs(ns, X, Y, Z)
        want.append(c)
    coeffs = pd.prepare_g2(pd.pack_g2(g2))
    got = map_leaf(coeffs, lambda a: pd.fp.unpack_mont(
        a.reshape(a.shape[0], a.shape[1]).t().contiguous()))
    # got[slot][component] is the list over steps
    for s, c in enumerate(want):
        assert tuple(tuple(got[i][k][s] for k in range(3))
                     for i in range(3)) == c, s


def test_frobenius_and_final_exponentiation_against_the_oracle():
    rng = random.Random(2)
    f = tuple(tuple(rng.randrange(Q) for _ in range(3)) for _ in range(2))
    planes = pd.pack_f6([f])
    assert pd.unpack_f6(pd.frobenius(planes)) == [jm._frobenius6(f)]
    assert pd.unpack_f6(pd.final_exponentiation(planes)) == [
        jm.final_exponentiation(f)]


def test_unprepared_pairing_products_on_two_lanes():
    """pairing_products (K14 steps, plain) on two lanes of one pair each:
    e(P_i, Q_i) equal the oracle's pairing."""
    g1, g2 = _points(3, 2)
    e = pd.pairing_products(map_leaf(pd.pack_g1(g1), lambda a: a[:, None]),
                            map_leaf(pd.pack_g2(g2), lambda a: a[:, None]))
    assert pd.unpack_f6(e) == [jm.pairing(jm.G1.from_affine(*p),
                                          jm.G2.from_affine(*q))
                               for p, q in zip(g1, g2)]


def test_fused_pairing_products_on_two_pairs():
    """pairing_products_fused on one lane of two pairs equals the oracle's
    product of the two pairings (the prepared fused path runs in
    tests/test_torch_mnt_verify*.py)."""
    g1, g2 = _points(4, 2)
    P = map_leaf(pd.pack_g1(g1), lambda a: a[:, :, None])
    Qs = map_leaf(pd.pack_g2(g2), lambda a: a[:, :, None])
    f = jm.F6.one()
    for p, q in zip(g1, g2):
        f = jm.F6.mul(f, jm.miller_loop(p, q))
    want = [jm.final_exponentiation(f)]
    assert pd.unpack_f6(pd.pairing_products_fused(P, Qs)) == want
