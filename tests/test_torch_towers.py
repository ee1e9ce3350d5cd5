"""Port parity: the extension towers of wasmsnark_tpu_torch/ops/towers.py on
the CPU.  The F2 operations this slice adds (conjugate, mul_base,
mul_small, inv) against the JAX package's jitted F2Device; F6 and F12
multiply, square and inverse against the JAX package's host oracle
(wasmsnark_tpu.models.bn128), bit for bit after conversion out of
Montgomery form.
"""

import random

import jax
import numpy as np
import pytest
import torch

from wasmsnark_tpu.models.bn128 import bn128 as jbn128
from wasmsnark_tpu.ops.pairing import bn128_pairing_device

from wasmsnark_tpu_torch.convert import tower_from_numpy, tower_to_numpy
from wasmsnark_tpu_torch.ops.pairing import bn128_pairing_device as tpd_

from test_torch_f12_kernels import rand_planes

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
LANES = 3


@pytest.fixture(scope="module")
def tpd():
    return tpd_(CPU)


def test_f2_ops_match_jax(tpd):
    rng = np.random.default_rng(20)
    a = tuple(rand_planes(rng, 2))
    b = rand_planes(rng, 1)[0]
    jF2 = bn128_pairing_device().F2d
    want = jax.jit(lambda a, b: (jF2.conjugate(a), jF2.mul_base(a, b),
                                 jF2.mul_small(a, 9), jF2.mul_small(a, 36),
                                 jF2.inv(a)))(a, b)
    F2 = tpd.F2d
    ta, tb = tower_from_numpy(a, CPU), tower_from_numpy(b, CPU)
    got = (F2.conjugate(ta), F2.mul_base(ta, tb), F2.mul_small(ta, 9),
           F2.mul_small(ta, 36), F2.inv(ta))
    for g, w in zip(tower_to_numpy(got), want):
        for gp, wp in zip(g, w):
            np.testing.assert_array_equal(gp, np.asarray(wp))


def _pack(tpd, els):
    """Oracle tower elements (one per lane) -> port planes."""
    if isinstance(els[0], tuple):
        return tuple(_pack(tpd, [e[i] for e in els])
                     for i in range(len(els[0])))
    return tpd.fp.pack_mont(els)


def _unpack(tpd, t, lanes):
    if isinstance(t, tuple):
        parts = [_unpack(tpd, c, lanes) for c in t]
        return [tuple(p[j] for p in parts) for j in range(lanes)]
    return tpd.fp.unpack_mont(t)


@pytest.mark.parametrize("tower", ["F6", "F12"])
def test_tower_mul_square_inv_match_oracle(tpd, tower):
    jm = jbn128()
    q = jm.F1.q
    rng = random.Random(21)

    def rand6():
        return tuple((rng.randrange(q), rng.randrange(q)) for _ in range(3))

    def rand(k):
        return [rand6() if tower == "F6" else (rand6(), rand6())
                for _ in range(k)]

    a, b = rand(LANES), rand(LANES)
    a[0] = jm.F6.one() if tower == "F6" else jm.F12.one()
    O = jm.F6 if tower == "F6" else jm.F12
    D = tpd.F6d if tower == "F6" else tpd.F12d
    ta, tb = _pack(tpd, a), _pack(tpd, b)
    assert _unpack(tpd, D.mul(ta, tb), LANES) == [O.mul(x, y)
                                                  for x, y in zip(a, b)]
    assert _unpack(tpd, D.square(ta), LANES) == [O.square(x) for x in a]
    assert _unpack(tpd, D.inv(ta), LANES) == [O.inv(x) for x in a]
    assert bool(D.eq(D.mul(ta, D.inv(ta)), D.one_like(ta)).all())


@pytest.mark.parametrize("curve", ["bn128", "bls12381"])
def test_oracle_cyclotomic_square_matches_jax(curve):
    """The host oracles' Granger-Scott square, on f^((q^6 - 1)(q^2 + 1))
    of a seeded F12 element (a cyclotomic element): the JAX models' value
    and F12.mul(f, f)."""
    from wasmsnark_tpu.models import bls12381 as jbls, bn128 as jbn
    from wasmsnark_tpu_torch.models import curve_module
    m = curve_module(curve)
    jm = {"bn128": jbn.bn128, "bls12381": jbls.bls12381}[curve]()
    rnd = random.Random(60)
    q = m.F1.q
    f = tuple(tuple((rnd.randrange(q), rnd.randrange(q)) for _ in range(3))
              for _ in range(2))
    F12 = m.F12
    g = F12.mul(F12.conjugate(f), F12.inv(f))          # f^(q^6 - 1)
    c = F12.mul(m.frobenius(g, 2), g)                  # ^(q^2 + 1)
    got = m.cyclotomic_square(c)
    assert got == jm.cyclotomic_square(c)
    assert got == F12.mul(c, c)
    assert m.cyclotomic_square(f) == jm.cyclotomic_square(f)
