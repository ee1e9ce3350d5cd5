"""Port parity: the plain versions of K9 (Granger-Scott cyclotomic square)
and K10 (Miller doubling and mixed-add steps) of ops/tower_kernels.py
against the JAX package on the CPU, bit for bit.

The JAX side runs, jitted, `gs_cyclotomic_square(pd.F2d, pd.mul_xi, .)`
(wasmsnark_tpu/ops/towers.py) and `pd._dbl_step` / `pd._add_step`
(wasmsnark_tpu/ops/pairing.py): off the TPU these are the composed
formulas that the Pallas kernel bodies compute.  K9 gets random,
non-unitary inputs, which pins the polynomial map and not only its values
on the cyclotomic subgroup.  K10 gets a lane of edge values (0, 1, q-1), a
lane with Z = 0, and for the add step a lane with x2 = X/Z (the line's
degenerate case lambda = 0).
"""

import jax
import numpy as np
import torch

from wasmsnark_tpu.ops.pairing import bn128_pairing_device
from wasmsnark_tpu.ops.towers import gs_cyclotomic_square

from wasmsnark_tpu_torch.convert import tower_from_numpy, tower_to_numpy
from wasmsnark_tpu_torch.models.bn128 import bn128
from wasmsnark_tpu_torch.ops import tower_kernels as tk

from test_torch_f12_kernels import assert_same, rand_planes

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
m = bn128()
SPEC = m.fp_spec
LANES = 4


def f2(rng):
    return tuple(rand_planes(rng, 2, LANES))


def assert_tree(port_tree, jax_tree):
    got, want = [], []

    def leaves(t, out):
        if isinstance(t, tuple):
            for c in t:
                leaves(c, out)
        else:
            out.append(np.asarray(t))

    leaves(tower_to_numpy(port_tree), got)
    leaves(jax_tree, want)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"plane {k}")


def test_k9_plain_matches_jax_cyclotomic_square():
    rng = np.random.default_rng(10)
    a = tk.unflatten12(rand_planes(rng, 12))
    jpd = bn128_pairing_device()
    want = jax.jit(lambda f: gs_cyclotomic_square(jpd.F2d, jpd.mul_xi, f))(a)
    ta = tower_from_numpy(a, CPU)
    assert_same(tk.f12_cyc_sqr(SPEC, ta), want)
    assert_same(tk.f12_cyc_sqr_plain(SPEC, ta), want)


def _miller_inputs(seed):
    rng = np.random.default_rng(seed)
    X, Y, Z, x2, y2 = f2(rng), f2(rng), f2(rng), f2(rng), f2(rng)
    xP, yP = rand_planes(rng, 2, LANES)
    for c in Z:                                  # lane 1: Z = 0
        c[:, 1] = 0
    # lane 3: x2 = X/Z in F2, so x2 Z - X = 0
    def val(pair, j):
        return tuple(SPEC.from_mont(SPEC.from_limbs(p[:, j])) for p in pair)
    x = m.F2.mul(val(X, 3), m.F2.inv(val(Z, 3)))
    for c, v in zip(x2, x):
        c[:, 3] = SPEC.limbs(SPEC.to_mont(v))
    return X, Y, Z, x2, y2, xP, yP


def test_k10_dbl_plain_matches_jax_dbl_step():
    X, Y, Z, _, _, xP, yP = _miller_inputs(11)
    jpd = bn128_pairing_device()
    line, *pt = jax.jit(jpd._dbl_step)(X, Y, Z, xP, yP)
    want = ((line[0][0], line[1][0], line[1][1]), *pt)
    t = tower_from_numpy((X, Y, Z, xP, yP), CPU)
    assert_tree(tk.miller_dbl(SPEC, *t), want)
    assert_tree(tk.miller_dbl_plain(SPEC, *t), want)


def test_k10_add_plain_matches_jax_add_step():
    X, Y, Z, x2, y2, xP, yP = _miller_inputs(12)
    jpd = bn128_pairing_device()
    line, *pt = jax.jit(jpd._add_step)(X, Y, Z, x2, y2, xP, yP)
    want = ((line[0][0], line[1][0], line[1][1]), *pt)
    t = tower_from_numpy((X, Y, Z, x2, y2, xP, yP), CPU)
    got = tk.miller_add(SPEC, *t)
    assert_tree(got, want)
    assert_tree(tk.miller_add_plain(SPEC, *t), want)
    # the degenerate lane really is one: lambda = x2 Z - X = 0 there
    assert all(int(p[:, 3].abs().sum()) == 0 for p in got[0][0])
