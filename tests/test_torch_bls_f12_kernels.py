"""Port parity at BLS12-381's widths: the plain versions of K8 (F12 multiply
and square) and K9 (Granger-Scott cyclotomic square) at N = 12 words and
xi = 1 + u, and the Frobenius maps of the BLS12-381 pairing engine, against
the JAX package's Bls12381PairingDevice on the CPU.

Tolerance: bit-identical.  The JAX side runs its composed formulas
(`F12d.mul`, `F12d.square`, `gs_cyclotomic_square(F2d, mul_xi, .)`,
`frobenius`), which off the TPU are what the Pallas kernel bodies compute.
Inputs are canonical Montgomery planes from a seeded numpy generator with
a lane of edge values (0, 1, q-1); K9 gets non-unitary inputs, which pins
the polynomial map and not only its values on the cyclotomic subgroup.
"""

import jax
import numpy as np
import pytest
import torch

from wasmsnark_tpu.ops.pairing import bls12381_pairing_device
from wasmsnark_tpu.ops.towers import gs_cyclotomic_square

from wasmsnark_tpu_torch.convert import tower_from_numpy, tower_to_numpy
from wasmsnark_tpu_torch.models.bls12381 import bls12381
from wasmsnark_tpu_torch.ops import tower_kernels as tk
from wasmsnark_tpu_torch.ops.pairing import (
    bls12381_pairing_device as tpd_)

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SPEC = bls12381().fp_spec
XI = tk.XI_BLS
LANES = 3


def rand_planes(rng, n_planes, lanes=LANES):
    """n_planes canonical [24, lanes] uint32 planes of BLS12-381's Fq;
    lane 0 holds the edge values 0, 1, q-1 in turn."""
    out = []
    for k in range(n_planes):
        a = rng.integers(0, 1 << 16, size=(SPEC.n_limbs, lanes),
                         dtype=np.uint32)
        a[-1] = rng.integers(0, SPEC.q_limbs[-1], size=lanes, dtype=np.uint32)
        a[:, 0] = SPEC.limbs((0, 1, SPEC.q - 1)[k % 3])
        out.append(a)
    return out


def assert_same(port_tree, jax_tree):
    got = tk.flatten12(tower_to_numpy(port_tree))
    want = tk.flatten12(jax_tree)
    assert len(got) == len(want) == 12
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"plane {k}")


def test_engine_xi_is_one_plus_u():
    assert tpd_(CPU).XI == bls12381_pairing_device().XI == XI == (1, 1)
    assert tpd_(CPU).fp.L == 24


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_k8_plain_matches_jax_f12_at_n12(op):
    rng = np.random.default_rng(81 if op == "mul" else 82)
    a = tk.unflatten12(rand_planes(rng, 12))
    b = tk.unflatten12(rand_planes(rng, 12))
    jpd = bls12381_pairing_device()
    ta, tb = tower_from_numpy(a, CPU), tower_from_numpy(b, CPU)
    if op == "mul":
        want = jax.jit(jpd.F12d.mul)(a, b)
        assert_same(tk.f12_mul_plain(SPEC, ta, tb, XI), want)
        assert_same(tk.f12_mul(SPEC, ta, tb, XI), want)
    else:
        want = jax.jit(jpd.F12d.square)(a)
        assert_same(tk.f12_sqr_plain(SPEC, ta, XI), want)
        assert_same(tk.f12_sqr(SPEC, ta, XI), want)


def test_k9_plain_matches_jax_cyclotomic_square_at_n12():
    rng = np.random.default_rng(90)
    a = tk.unflatten12(rand_planes(rng, 12))
    jpd = bls12381_pairing_device()
    want = jax.jit(lambda f: gs_cyclotomic_square(jpd.F2d, jpd.mul_xi, f))(a)
    ta = tower_from_numpy(a, CPU)
    assert_same(tk.f12_cyc_sqr_plain(SPEC, ta, XI), want)
    assert_same(tk.f12_cyc_sqr(SPEC, ta, XI), want)
    assert_same(tpd_(CPU).cyclotomic_square(ta), want)


def test_frobenius_matches_jax_engine():
    f = tk.unflatten12(rand_planes(np.random.default_rng(30), 12))
    jpd = bls12381_pairing_device()
    tf = tower_from_numpy(f, CPU)
    tpd = tpd_(CPU)
    for j in (1, 2, 3):
        with jax.disable_jit():
            want = jpd.frobenius(f, j)
        assert_same(tpd.frobenius(tf, j), want)
