"""Port parity: the plain versions of K11 (BLS12-381's M-twist Miller
doubling and mixed-add steps, ops/tower_kernels.py) and the first steps of
the BLS12-381 engine's prepare_g2, against the JAX package on the CPU.

Tolerance: bit-identical.  The JAX side runs `Bls12381PairingDevice()
._dbl_step` / `._add_step` (wasmsnark_tpu/ops/pairing.py), which off the
TPU are the composed formulas that the Pallas kernels
`_miller_dbl_mtwist_kernel` / `_miller_add_mtwist_kernel` compute, under
`jax.disable_jit()` (their jit at L = 24 costs more than the run).  The
inputs hold a lane of edge values (0, 1, q-1), a lane with Z = 0 and, for
the add step, a lane with x2 = X/Z (the line's degenerate case
lambda = 0).
"""

import jax
import numpy as np
import torch

from wasmsnark_tpu.ops.pairing import (_g2_add_coefs, _g2_dbl_coefs,
                                       bls12381_pairing_device)

from wasmsnark_tpu_torch.convert import tower_from_numpy, tower_to_numpy
from wasmsnark_tpu_torch.models.bls12381 import bls12381
from wasmsnark_tpu_torch.ops import tower_kernels as tk
from wasmsnark_tpu_torch.ops.curve import map_leaf
from wasmsnark_tpu_torch.ops.pairing import (
    bls12381_pairing_device as tpd_)

from test_torch_bls_f12_kernels import SPEC, XI, rand_planes

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
m = bls12381()
LANES = 4


def f2(rng):
    return tuple(rand_planes(rng, 2, LANES))


def assert_tree(port_tree, jax_tree):
    got = jax.tree.leaves(tower_to_numpy(port_tree))
    want = jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"plane {k}")


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


def _mtwist_slots(step):
    """The JAX step's sparse line ((a0, 0, 0), (0, b1, b2)) -> (a0, b1,
    b2), with the point."""
    line, *pt = step
    assert not np.asarray(line[1][0][0]).any()
    return ((line[0][0], line[1][1], line[1][2]), *pt)


def test_k11_dbl_plain_matches_jax_dbl_step():
    X, Y, Z, _, _, xP, yP = _miller_inputs(111)
    with jax.disable_jit():
        want = _mtwist_slots(bls12381_pairing_device()._dbl_step(
            X, Y, Z, xP, yP))
    t = tower_from_numpy((X, Y, Z, xP, yP), CPU)
    assert_tree(tk.miller_dbl_mtwist_plain(SPEC, *t, XI), want)
    assert_tree(tk.miller_dbl_mtwist(SPEC, *t, XI), want)


def test_k11_add_plain_matches_jax_add_step():
    X, Y, Z, x2, y2, xP, yP = _miller_inputs(112)
    with jax.disable_jit():
        want = _mtwist_slots(bls12381_pairing_device()._add_step(
            X, Y, Z, x2, y2, xP, yP))
    t = tower_from_numpy((X, Y, Z, x2, y2, xP, yP), CPU)
    got = tk.miller_add_mtwist(SPEC, *t, XI)
    assert_tree(got, want)
    assert_tree(tk.miller_add_mtwist_plain(SPEC, *t, XI), want)
    # the degenerate lane really is one: lambda = x2 Z - X = 0 there
    assert all(int(p[:, 3].abs().sum()) == 0 for p in got[0][0])


def test_prepare_g2_first_steps_fold_xi_like_jax():
    """The ladder's first two steps are a dbl and an add; xi is folded into
    c_y as in the JAX engine's prepare_g2.  The loop has no correction
    steps: one coefficient set per step of the 64-bit |x|."""
    tpd = tpd_(CPU)
    assert tpd._prep_flags[:2].tolist() == [0, 1]
    assert len(tpd._prep_flags) == 63 + 5
    pts = [m.G2.affine(m.G2.times_scalar(m.g2_gen, k))[:2] for k in (5, 11)]
    g2 = tpd.pack_g2(pts)
    coeffs = tpd.prepare_g2(g2)
    assert coeffs[0][0].shape[0] == len(tpd._prep_flags)
    jpd = bls12381_pairing_device()
    F2 = jpd.F2d
    xQ, yQ = tower_to_numpy(g2)
    with jax.disable_jit():
        (cy, cx, c0), X, Y, Z = _g2_dbl_coefs(F2, xQ, yQ, F2.one_like(xQ))
        want0 = (jpd._mul_xi(cy), cx, c0)
        (cy, cx, c0), *_ = _g2_add_coefs(F2, X, Y, Z, xQ, yQ)
        want1 = (jpd._mul_xi(cy), cx, c0)
    for s, want in ((0, want0), (1, want1)):
        assert_tree(map_leaf(coeffs, lambda a: a[s]), want)
