"""Port parity: the BN128 device pairing of wasmsnark_tpu_torch/ops/pairing.py
on the CPU (kernel wrappers run their plain versions there).

* `frobenius` against the JAX package's jitted one;
* the first dbl and add steps of `prepare_g2` against the JAX package's
  jitted `_g2_dbl_coefs` / `_g2_add_coefs`;
* `pairing_product`, `pairing_product_prepared` and
  `final_exponentiation` against final_exponentiation(miller_loop(.)) of
  the JAX package's host oracle, which is what the JAX package validates
  its own device pairing against; bilinearity e(7P, 9Q) = e(P, Q)^63.

The Miller values themselves carry line scalings that differ from the
oracle's, so only final-exponentiated values are compared with it.
"""

import random

import jax
import numpy as np
import pytest
import torch

from wasmsnark_tpu.models.bn128 import bn128 as jbn128
from wasmsnark_tpu.ops.pairing import (_g2_add_coefs, _g2_dbl_coefs,
                                       bn128_pairing_device)

from wasmsnark_tpu_torch.convert import tower_from_numpy, tower_to_numpy
from wasmsnark_tpu_torch.ops import tower_kernels as tk
from wasmsnark_tpu_torch.ops.curve import map_leaf
from wasmsnark_tpu_torch.ops.pairing import bn128_pairing_device as tpd_

from test_torch_f12_kernels import assert_same, rand_planes

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
jm = jbn128()


@pytest.fixture(scope="module")
def tpd():
    return tpd_(CPU)


def _g1(k):
    return jm.G1.affine(jm.G1.times_scalar(jm.g1_gen, k))[:2]


def _g2(k):
    return jm.G2.affine(jm.G2.times_scalar(jm.g2_gen, k))[:2]


def _e(pairs):
    """The oracle's value of prod e(P_i, Q_i)."""
    F = jm.F12
    acc = F.one()
    for p, q in pairs:
        acc = F.mul(acc, jm.miller_loop(p, q))
    return jm.final_exponentiation(acc)


def _pairs(tpd, lanes):
    """lanes[b] = [(P, Q) per pair] -> g1, g2 leaves [L, n_pairs, B]."""
    n_pairs, B = len(lanes[0]), len(lanes)
    flat = [pq for i in range(n_pairs) for pq in (ln[i] for ln in lanes)]
    g1 = tpd.pack_g1([p for p, _ in flat])
    g2 = tpd.pack_g2([q for _, q in flat])

    def shape(a):
        return a.reshape(a.shape[0], n_pairs, B)

    return map_leaf(g1, shape), map_leaf(g2, shape)


def test_frobenius_matches_jax(tpd):
    f = tk.unflatten12(rand_planes(np.random.default_rng(30), 12))
    jpd = bn128_pairing_device()
    tf = tower_from_numpy(f, CPU)
    for j in (1, 2, 3):
        want = jax.jit(lambda x, j=j: jpd.frobenius(x, j))(f)
        assert_same(tpd.frobenius(tf, j), want)


def test_prepare_g2_first_steps_match_jax(tpd):
    """The ladder's first two steps are a dbl and an add (the ate loop's
    first bit after the MSB is 1)."""
    assert tpd._prep_flags[:2].tolist() == [0, 1]
    pts = [_g2(5), _g2(11)]
    g2 = tpd.pack_g2(pts)
    coeffs = tpd.prepare_g2(g2)
    jpd = bn128_pairing_device()
    F2 = jpd.F2d

    @jax.jit
    def first_steps(xQ, yQ):
        c0, X, Y, Z = _g2_dbl_coefs(F2, xQ, yQ, F2.one_like(xQ))
        c1, *_ = _g2_add_coefs(F2, X, Y, Z, xQ, yQ)
        return c0, c1

    want = first_steps(*tower_to_numpy(g2))
    for s in (0, 1):
        got = tower_to_numpy(map_leaf(coeffs, lambda a: a[s]))
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want[s])):
            np.testing.assert_array_equal(g, np.asarray(w))
    assert coeffs[0][0].shape[0] == len(tpd._prep_flags) == 102


def test_pairing_product_and_bilinearity(tpd):
    P, Q = _g1(1), _g2(1)
    g1, g2 = _pairs(tpd, [[(_g1(7), _g2(9))], [(P, Q)]])
    e = tpd.unpack_f12(tpd.pairing_product(g1, g2, 1))
    want = _e([(P, Q)])
    assert e[1] == want
    assert e[0] == jm.F12.exp(want, 63)


def test_pairing_product_prepared(tpd):
    """Two pairs per lane through prepared coefficients: a product the
    oracle computes, and e(7P, 9Q) e(-63P, Q) = 1."""
    P, Q = _g1(1), _g2(1)
    neg63 = jm.G1.affine(jm.G1.neg(jm.G1.times_scalar(jm.g1_gen, 63)))[:2]
    lanes = [[(P, Q), (_g1(2), _g2(3))], [(_g1(7), _g2(9)), (neg63, Q)]]
    g1, g2 = _pairs(tpd, lanes)
    coeffs = tpd.prepare_g2(g2)
    e = tpd.pairing_product_prepared(g1, coeffs, 2)
    assert tpd.unpack_f12(e)[0] == _e(lanes[0])
    assert tpd.is_one(e).tolist() == [False, True]


def test_final_exponentiation_matches_oracle(tpd):
    rng = random.Random(31)
    q = jm.F1.q
    f = tuple(tuple((rng.randrange(q), rng.randrange(q)) for _ in range(3))
              for _ in range(2))
    tf = tuple(tuple((tpd.fp.pack_mont([c2[0]]), tpd.fp.pack_mont([c2[1]]))
                     for c2 in c6) for c6 in f)
    assert tpd.unpack_f12(tpd.final_exponentiation(tf))[0] == \
        jm.final_exponentiation(f)
