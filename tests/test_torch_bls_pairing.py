"""Port parity: the BLS12-381 device pairing of wasmsnark_tpu_torch/ops/
pairing.py on the CPU (kernel wrappers run their plain versions there).

* `pairing_product` (the unprepared Miller loop through K11's plain
  version, the negative loop's conjugation, the exact windowed hard part)
  against final_exponentiation(miller_loop(.)) of the JAX package's host
  oracle, `bls12381().pairing`; bilinearity e(7P, 9Q) = e(P, Q)^63;
* `pairing_product_prepared` on two pairs per lane, a product the oracle
  computes and a product equal to one;
* `final_exponentiation` of a random F12 element against the oracle's.

Tolerance: the final-exponentiated values are unique, so they are equal
to the oracle's (integers); the Miller values carry line scalings that
differ from the oracle's and are not compared.
"""

import random

import pytest
import torch

from wasmsnark_tpu.models.bls12381 import bls12381 as jbls

from wasmsnark_tpu_torch.ops.curve import map_leaf
from wasmsnark_tpu_torch.ops.pairing import (bls12381_pairing_device,
                                             window_digits)

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
jm = jbls()


@pytest.fixture(scope="module")
def tpd():
    return bls12381_pairing_device(CPU)


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


def test_pairing_product_matches_oracle_and_bilinearity(tpd):
    P, Q = _g1(1), _g2(1)
    g1, g2 = _pairs(tpd, [[(_g1(7), _g2(9))], [(P, Q)]])
    e = tpd.unpack_f12(tpd.pairing_product(g1, g2, 1))
    want = jm.pairing(jm.g1_gen, jm.g2_gen)
    assert e[1] == want == _e([(P, Q)])
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
    """The exact hard part: (q^4 - q^2 + 1)/r through the 4-bit window
    ladder, with its static schedule."""
    digits = window_digits(tpd._hard_exp, 4)
    assert sum(d << (4 * k) for k, d in enumerate(reversed(digits))) == \
        tpd._hard_exp and digits[0] != 0
    rng = random.Random(31)
    q = jm.F1.q
    f = tuple(tuple((rng.randrange(q), rng.randrange(q)) for _ in range(3))
              for _ in range(2))
    tf = tuple(tuple((tpd.fp.pack_mont([c2[0]]), tpd.fp.pack_mont([c2[1]]))
                     for c2 in c6) for c6 in f)
    assert tpd.unpack_f12(tpd.final_exponentiation(tf))[0] == \
        jm.final_exponentiation(f)
