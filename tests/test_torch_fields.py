"""Port parity: field constants and FpDevice ops of wasmsnark_tpu_torch
against wasmsnark_tpu on the CPU, bit for bit.

Inputs are the adversarial gen_values grid (conftest.py) for BN128 Fp and
Fr, fed to both packages as the same uint32 limb planes.  The JAX side runs
its jnp path (bit-equal to Pallas); the port runs its kernels' plain
versions, which are what the CUDA kernels are held against on the card.
"""

import jax
import numpy as np
import pytest
import torch

from wasmsnark_tpu.fields import spec as jspec
from wasmsnark_tpu.models.bn128 import bn128 as jbn128
from wasmsnark_tpu.ops.fp import FpDevice as JFp
from wasmsnark_tpu.utils import serialize as jser

from wasmsnark_tpu_torch.fields import spec as tspec
from wasmsnark_tpu_torch.models.bn128 import bn128 as tbn128
from wasmsnark_tpu_torch.ops import fp as tfp
from wasmsnark_tpu_torch.ops.pol import SparseLC, construct_lc
from wasmsnark_tpu_torch.utils import native as tnative
from wasmsnark_tpu_torch.utils import serialize as tser

from conftest import gen_values

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

FIELDS = ["fp", "fr"]
CPU = torch.device("cpu")


def _specs(which):
    jm, tm = jbn128(), tbn128()
    return ((jm.fp_spec, tm.fp_spec) if which == "fp"
            else (jm.fr_spec, tm.fr_spec))


def _vectors(q):
    # the grid of tests/test_fp_device.py, so the JAX programs are cached
    vals = gen_values(q)
    n = len(vals)
    return ([vals[i % n] for i in range(2 * n)],
            [vals[(i * 7 + 3) % n] for i in range(2 * n)])


@pytest.mark.parametrize("which", FIELDS)
def test_spec_constants(which):
    js, ts = _specs(which)
    for attr in ("q", "n_limbs", "bits", "R", "R2", "R3", "np16", "half",
                 "one_mont", "q_limbs", "n8"):
        assert getattr(js, attr) == getattr(ts, attr), attr
    jn, tn = jspec.NTTSpec(js), tspec.NTTSpec(ts)
    assert jn.max_bits == tn.max_bits
    assert jn.roots == tn.roots and jn.inv2 == tn.inv2


OPS = ["add", "sub", "neg", "mont_mul", "mont_sqr", "to_mont", "from_mont"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("which", FIELDS)
def test_fp_ops_bit_identical(which, op):
    js, ts = _specs(which)
    J, T = JFp(js), tfp.FpDevice(ts, CPU)
    xs, ys = _vectors(js.q)
    X, Y = J.pack(xs), J.pack(ys)
    binary = op in ("add", "sub", "mont_mul")
    fn = getattr(J, op)
    want = np.asarray(jax.jit(fn)(X, Y) if binary else jax.jit(fn)(X))
    tx, ty = tfp.planes(X, CPU), tfp.planes(Y, CPU)
    got = getattr(T, op)(tx, ty) if binary else getattr(T, op)(tx)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(tfp.to_numpy(got), want)


@pytest.mark.parametrize("which", FIELDS)
def test_predicates_select_and_broadcast(which):
    js, ts = _specs(which)
    J, T = JFp(js), tfp.FpDevice(ts, CPU)
    xs, ys = _vectors(js.q)
    X, Y = J.pack(xs), J.pack(ys)
    tx, ty = tfp.planes(X, CPU), tfp.planes(Y, CPU)
    np.testing.assert_array_equal(T.is_zero(tx).numpy(),
                                  np.asarray(J.is_zero(X)))
    np.testing.assert_array_equal(T.eq(tx, ty).numpy(),
                                  np.asarray(J.eq(X, Y)))
    mask = T.is_zero(ty)
    np.testing.assert_array_equal(
        tfp.to_numpy(T.select(mask, tx, ty)),
        np.asarray(J.select(J.is_zero(Y), X, Y)))
    # a constant [L, 1] plane broadcasts against a [L, 2, B] batch
    x3 = tx.reshape(ts.n_limbs, 2, -1)
    got = T.mont_mul(x3, T.r2_t)
    np.testing.assert_array_equal(
        tfp.to_numpy(got).reshape(ts.n_limbs, -1),
        np.asarray(jax.jit(J.to_mont)(X)))


@pytest.mark.parametrize("which", FIELDS)
def test_inverse_and_pow_vs_oracle(which):
    _, ts = _specs(which)
    T = tfp.FpDevice(ts, CPU)
    q = ts.q
    vals = [0, 1, 2, q - 1, q - 2, 12345678901234567890]
    inv = T.unpack_mont(T.mont_inv(T.pack_mont(vals)))
    assert inv == [pow(v, q - 2, q) for v in vals]
    cube = T.unpack_mont(T.mont_pow_const(T.pack_mont(vals), 3))
    assert cube == [pow(v, 3, q) for v in vals]


@pytest.mark.parametrize("field", ["bn128_fp", "bn128_fr", "bls_fq",
                                   "bls_fr", "mnt_fq"])
def test_mont_mul_plain_carry_chains(field):
    """mont_mul_plain where U = x y + m q ends in a carry that runs through
    every limb of its low half (1 times R mod q over BLS12-381's Fr: U = R,
    so 16 limbs of 2^16 - 1 pass on the carry of a limb that also carries),
    against the integers: x y R^-1 mod q.  One lane a call: the carry
    rounds run until the batch's largest column is small enough, so other
    lanes in the batch could hide a chain."""
    from wasmsnark_tpu_torch.models.bls12381 import bls12381
    from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
    curve, kind = field.split("_")
    m = {"bn128": tbn128, "bls": bls12381, "mnt": mnt6753}[curve]()
    s = m.fp_spec if kind == "fq" or kind == "fp" else m.fr_spec
    q, R = s.q, 1 << (16 * s.n_limbs)
    xs = [1, 2, 3, q - 1, q - 2, q // 2, 65535, 65536]
    ys = [R % q, R * R % q, (q - 1) * R % q, 1]
    for x in xs:
        for y in ys:
            tx, ty = (tfp.planes(np.array([s.limbs(v)], dtype=np.uint32).T,
                                 CPU) for v in (x, y))
            got = tser.limbs_to_ints(tfp.to_numpy(
                tfp.mont_mul_plain(s, tx, ty)))
            assert got == [x * y * pow(R, -1, q) % q], (x, y)


def test_reduce_wide_sum_and_construct_lc_vs_jax():
    """construct_lc with duplicate destinations and empty buckets (the case
    of tests/test_groth16_e2e.py) equals the JAX package's planes."""
    import random
    import jax.numpy as jnp
    from wasmsnark_tpu.ops.pol import (SparseLC as JLC,
                                       construct_lc as jconstruct)
    js, ts = _specs("fr")
    J, T = JFp(js), tfp.FpDevice(ts, CPU)
    q = js.q
    rnd = random.Random(5)
    domain, nsig, nnz = 16, 6, 40
    sig_idx = [rnd.randrange(nsig) for _ in range(nnz)]
    coef_idx = [rnd.choice([0, 3, 3, 3, 7, 7, 15]) for _ in range(nnz)]
    coefs = J.pack_mont([rnd.randrange(q) for _ in range(nnz)])
    signals = [rnd.randrange(q) for _ in range(nsig)]
    sig_m = J.to_mont(jnp.asarray(jser.ints_to_limbs(signals, J.L)))
    jlc = JLC(sig_idx=np.array(sig_idx, np.int32),
              coef_idx=np.array(coef_idx, np.int32), coefs=coefs,
              domain_size=domain)
    want = np.asarray(jconstruct(J, jlc, sig_m))
    tlc = SparseLC(sig_idx=np.array(sig_idx, np.int32),
                   coef_idx=np.array(coef_idx, np.int32), coefs=coefs,
                   domain_size=domain)
    got = construct_lc(T, tlc, tfp.planes(np.asarray(sig_m), CPU))
    np.testing.assert_array_equal(tfp.to_numpy(got), want)
    # a wide column sum with a carry beyond 2^(16L)
    acc = torch.full((T.L, 3), 0xFFFF * 5000, dtype=torch.int64)
    v = sum((0xFFFF * 5000) << (16 * i) for i in range(T.L)) % q
    assert T.unpack(T.reduce_wide_sum(acc)) == [v] * 3


def test_serialize_and_sparse_parse_match():
    m = jbn128()
    vals = [0, 1, m.Fr.q - 1, 2 ** 200 + 12345]
    data = b"".join(v.to_bytes(32, "little") for v in vals)
    np.testing.assert_array_equal(
        tser.bytes_to_limbs(data, 32, 16), jser.bytes_to_limbs(data, 32, 16))
    planes = tser.bytes_to_limbs(data, 32, 16)
    assert tser.limbs_to_bytes(planes, 32) == data
    assert tser.ints_to_limbs_fast(vals, 16).tolist() == \
        jser.ints_to_limbs(vals, 16).tolist()
    # sparse section: per signal u32 count, then (u32 idx, 32B coef)*
    recs = [[(3, 7), (0, 9)], [], [(5, 1)]]
    sec = b""
    for r in recs:
        sec += len(r).to_bytes(4, "little")
        for idx, c in r:
            sec += idx.to_bytes(4, "little") + c.to_bytes(32, "little")
    sig, cidx, cb = tnative.parse_sparse(sec, len(recs), 32)
    assert sig.tolist() == [0, 0, 2] and cidx.tolist() == [3, 0, 5]
    assert cb.tobytes() == b"".join(c.to_bytes(32, "little")
                                    for r in recs for _, c in r)
    with pytest.raises(ValueError):
        tnative.parse_sparse(sec[:-1], len(recs), 32)
    with pytest.raises(ValueError):
        SparseLC(sig_idx=np.zeros(1 << 16, np.int32),
                 coef_idx=np.zeros(1 << 16, np.int32),
                 coefs=np.zeros((16, 1 << 16), np.uint32), domain_size=4)
