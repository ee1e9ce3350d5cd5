"""Port parity for MNT6753's 753-bit field (L = 48 16-bit limbs): the
plain Montgomery product, add, sub and inverse, `batch_inv` and `FpSqrt`
of wasmsnark_tpu_torch against the JAX package.

The JAX package's 48-limb device path compiles for minutes on the CPU, so
at 48 limbs the reference is its host oracle (`fields/oracle.Fp`,
`FieldSpec.sqrt` / `is_square`); `batch_inv` and `FpSqrt` are also held
against its device classes (`FpDevice.batch_inv`, `FpSqrt`) run through
their jnp path on the small high-2-adicity fields of
tests/test_fp_dynamic.py, where they compile in seconds.  Inputs are
seeded; every comparison is bit-exact on canonical values (tolerance 0).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wasmsnark_tpu.fields.oracle import Fp as JOracleFp
from wasmsnark_tpu.fields.spec import FieldSpec as JSpec
from wasmsnark_tpu.models.mnt6753 import mnt6753 as jmnt
from wasmsnark_tpu.ops.fp import FpDevice as JFp, FpSqrt as JSqrt

from wasmsnark_tpu_torch.fields.spec import FieldSpec
from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
from wasmsnark_tpu_torch.ops import fp as tfp

torch.set_num_threads(1)

CPU = torch.device("cpu")
jm, m = jmnt(), mnt6753()
spec = m.fp_spec
F = tfp.FpDevice(spec, CPU)
ORACLE = JOracleFp(jm.fp_spec)
Q = spec.q


def _values(seed, n):
    rng = random.Random(seed)
    return [0, 1, Q - 1, Q - 2, Q >> 1] + [rng.randrange(Q)
                                           for _ in range(n)]


def test_spec_matches_the_jax_package():
    assert spec.n_limbs == jm.fp_spec.n_limbs == 48
    assert spec.q_limbs == jm.fp_spec.q_limbs
    assert spec.one_mont == jm.fp_spec.one_mont
    assert spec._tonelli == jm.fp_spec._tonelli
    assert spec._tonelli[0] == 30              # s: 29 Tonelli rounds


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_field_ops_48_limbs_against_the_oracle(op):
    xs, ys = _values(1, 27), list(reversed(_values(2, 27)))
    x, y = F.pack_mont(xs), F.pack_mont(ys)
    got = F.unpack_mont(getattr(F, op)(x, y))
    want = {"mont_mul": ORACLE.mul, "add": ORACLE.add,
            "sub": ORACLE.sub}[op]
    assert got == [want(a, b) for a, b in zip(xs, ys)]


def test_mont_inv_and_batch_inv_with_zero_lanes():
    xs, ys = _values(3, 4), _values(4, 4)
    ys[2] = 0
    x, y = F.pack_mont(xs), F.pack_mont(ys)
    assert F.unpack_mont(F.mont_inv(x)) == [
        ORACLE.inv(v) if v else 0 for v in xs]
    ix, iy = F.batch_inv([x, y])
    assert F.unpack_mont(ix) == [ORACLE.inv(v) if v else 0 for v in xs]
    assert F.unpack_mont(iy) == [ORACLE.inv(v) if v else 0 for v in ys]


def test_sqrt_and_is_square_against_the_oracle():
    """Squares, non-squares, 0 and 1: Euler's criterion, and the root the
    JAX package's FieldSpec.sqrt returns (the even canonical one)."""
    rng = random.Random(5)
    vals = [0, 1, 4, Q - 1] + [rng.randrange(Q) for _ in range(4)] + [
        rng.randrange(Q) ** 2 % Q for _ in range(4)]
    S = tfp.FpSqrt(F)
    x = F.pack_mont(vals)
    assert S.is_square(x).tolist() == [jm.fp_spec.is_square(v)
                                       for v in vals]
    roots = F.unpack_mont(S.sqrt(x))
    for v, r in zip(vals, roots):
        if jm.fp_spec.is_square(v):
            assert r == jm.fp_spec.sqrt(v)
            assert r % 2 == 0                   # the even root
            assert r * r % Q == v


@pytest.mark.parametrize("q", [97, (1 << 61) - 1])
def test_small_field_against_the_jax_device_classes(q):
    """batch_inv, is_square and sqrt against the JAX package's FpDevice and
    FpSqrt (jnp path) on the fields of tests/test_fp_dynamic.py."""
    rng = random.Random(q)
    vals = [0, 1, 4, q - 1] + [rng.randrange(q) for _ in range(12)]
    other = [rng.randrange(q) for _ in range(15)] + [0]
    jF, tF = JFp(JSpec(q)), tfp.FpDevice(FieldSpec(q), CPU)
    jx, jy = jnp.asarray(jF.pack_mont(vals)), jnp.asarray(jF.pack_mont(other))
    tx, ty = tF.pack_mont(vals), tF.pack_mont(other)
    jinv = jax.jit(lambda a, b: jF.batch_inv([a, b]))(jx, jy)
    tinv = tF.batch_inv([tx, ty])
    for j, t in zip(jinv, tinv):
        assert np.array_equal(np.asarray(j), tfp.to_numpy(t))
    jS, tS = JSqrt(jF), tfp.FpSqrt(tF)
    assert np.asarray(jax.jit(jS.is_square)(jx)).tolist() == \
        tS.is_square(tx).tolist()
    jr = np.asarray(jax.jit(jS.sqrt)(jx))
    tr = tfp.to_numpy(tS.sqrt(tx))
    sq = np.asarray([JSpec(q).is_square(v) for v in vals])
    assert np.array_equal(jr[:, sq], tr[:, sq])
