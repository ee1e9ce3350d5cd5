"""The port's batched big-integer division and modular inversion
(ops/bigint.py int_div, inverse_mod) and F1Runtime (fields/runtime.py,
api.build_f1) on the CPU path, against the JAX package on the same inputs.

The four grids are tests/test_bigint.py's (the adversarial values of
conftest.gen_values, division by zero, mixed widths, prime, 32-bit and odd
composite moduli, unreduced x): the port's limb planes must equal the JAX
package's bit for bit, and both the integers' quotients, remainders and
inverses.  F1Runtime(device="cpu") for BN128's r and for 2^127 - 1 (8
limbs, 4 words) against the JAX F1Runtime and Python ints, method by
method; square against the JAX runtime's mul(x, x), see
test_f1_runtime_against_jax.
"""

import math
import random

import numpy as np
import pytest
import torch

from conftest import gen_values

import jax

from wasmsnark_tpu.fields.runtime import F1Runtime as JF1Runtime
from wasmsnark_tpu.ops.bigint import (int_div as j_int_div,
                                      inverse_mod as j_inverse_mod)

import wasmsnark_tpu_torch
from wasmsnark_tpu_torch.fields.runtime import F1Runtime
from wasmsnark_tpu_torch.ops import fp
from wasmsnark_tpu_torch.ops.bigint import int_div, inverse_mod
from wasmsnark_tpu_torch.utils.serialize import ints_to_limbs_fast

Q_BN = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R_BN = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def _pack(vals, n_limbs):
    return np.asarray(ints_to_limbs_fast(list(vals), n_limbs))


def _unpack(arr):
    arr = np.asarray(arr)
    return [sum(int(arr[i, j]) << (16 * i) for i in range(arr.shape[0]))
            for j in range(arr.shape[1])]


def _both(port_fn, jax_fn, *planes):
    """The port's function on tensors and the JAX package's (jitted) on
    the same uint32 planes; asserts bit-equal outputs, returns the
    port's as numpy."""
    got = port_fn(*[fp.planes(p, "cpu") for p in planes])
    want = jax.jit(jax_fn)(*planes)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    out = []
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        g = fp.to_numpy(g)
        assert np.array_equal(g, np.asarray(w))
        out.append(g)
    return out


def test_int_div_grid():
    random.seed(7)
    xs, ys = [], []
    for x in gen_values(1 << 256, n_random=12)[:24]:
        y = random.choice([1, 2, 3, 0xFFFF, Q_BN,
                           random.randrange(1, 1 << 128),
                           random.randrange(1, 1 << 250)])
        xs.append(x % (1 << 256))
        ys.append(y)
    xs.append(12345)                  # divide by zero: q = 0, r = x
    ys.append(0)
    q, r = _both(int_div, j_int_div, _pack(xs, 16), _pack(ys, 16))
    for x, y, qq, rr in zip(xs, ys, _unpack(q), _unpack(r)):
        if y == 0:
            assert qq == 0 and rr == x % (1 << 256)
        else:
            assert (qq, rr) == (x // y, x % y), (x, y)


def test_int_div_mixed_widths():
    random.seed(8)
    xs = [random.randrange(1 << 500) for _ in range(6)] + [0, 1]
    ys = [random.randrange(1, 1 << 200) for _ in range(6)] + [3, 1]
    q, r = _both(int_div, j_int_div, _pack(xs, 32), _pack(ys, 16))
    assert q.shape == (32, 8) and r.shape == (16, 8)
    for x, y, qq, rr in zip(xs, ys, _unpack(q), _unpack(r)):
        assert (qq, rr) == (x // y, x % y)


@pytest.mark.parametrize("m", [
    Q_BN, R_BN,
    0xFFFF_FFFB,                      # a 32-bit prime
    3 * 5 * 7 * 11 * 13 * 17 * 19 * 23,  # an odd composite
])
def test_inverse_mod_grid(m):
    random.seed(9)
    xs = [v % m for v in gen_values(m, n_random=8)]
    xs += [m - 1, 1, 0, m + 7 if m.bit_length() < 250 else 0]
    (inv,) = _both(inverse_mod, j_inverse_mod, _pack(xs, 16),
                   _pack([m] * len(xs), 16))
    for x, iv in zip(xs, _unpack(inv)):
        if math.gcd(x, m) == 1:
            assert (iv * x) % m == 1 and 0 <= iv < m, (x, m)
        else:
            assert iv == 0, (x, m)


def test_inverse_mod_x_above_m():
    m = 0xFFFF_FFFB
    xs = [m + 2, 5 * m + 3, (1 << 200) + 11]
    (inv,) = _both(inverse_mod, j_inverse_mod, _pack(xs, 16),
                   _pack([m] * len(xs), 16))
    for x, iv in zip(xs, _unpack(inv)):
        assert (iv * x) % m == 1


@pytest.mark.parametrize("q", [R_BN, (1 << 127) - 1])
def test_f1_runtime_against_jax(q):
    """Every method of F1Runtime(q, device="cpu") (build_f1) against the
    JAX F1Runtime and Python ints.  The JAX runtime's square returns
    x^2 R mod q (to_mont then a Montgomery square: a Montgomery-form
    value), against its own canonical contract; the port's square is
    canonical, f1_square = f1_mul(x, x), held against the JAX runtime's
    mul(x, x)."""
    random.seed(10)
    xs = gen_values(q, n_random=6)
    ys = list(reversed(gen_values(q, n_random=6)))
    rt = wasmsnark_tpu_torch.build_f1(q, device="cpu")
    assert isinstance(rt, F1Runtime) and rt.device.type == "cpu"
    assert rt.spec.n_limbs == (16 if q == R_BN else 8)
    jrt = JF1Runtime(q)
    assert rt.mul(xs, ys) == jrt.mul(xs, ys) == [
        x * y % q for x, y in zip(xs, ys)]
    assert rt.square(xs) == jrt.mul(xs, xs) == [x * x % q for x in xs]
    R = 1 << (16 * rt.spec.n_limbs)
    assert jrt.square(xs) == [x * x * R % q for x in xs]
    for name, want in (("add", [(x + y) % q for x, y in zip(xs, ys)]),
                       ("sub", [(x - y) % q for x, y in zip(xs, ys)])):
        assert getattr(rt, name)(xs, ys) == getattr(jrt, name)(xs, ys) == want
    assert rt.neg(xs) == jrt.neg(xs) == [(-x) % q for x in xs]
    inv = [pow(x, -1, q) if x else 0 for x in xs]
    assert rt.inverse(xs) == jrt.inverse(xs) == inv
    assert rt.inverse_gcd(xs) == jrt.inverse_gcd(xs) == inv
    ds = [y or 1 for y in ys]
    assert rt.divmod(xs, ds) == jrt.divmod(xs, ds) == (
        [x // d for x, d in zip(xs, ds)], [x % d for x, d in zip(xs, ds)])
    b = rt.bench_mul(1 << 10, batch=1 << 8)
    assert b["muls"] == 1 << 10 and b["seconds"] > 0


def test_f1_runtime_needs_a_spare_bit():
    """q must leave its limbs a spare top bit: a + b < 2q must fit, as the
    field kernels' adds need."""
    with pytest.raises(ValueError, match="spare top bit"):
        F1Runtime((1 << 64) - 59, device="cpu")
