"""Port parity: the plain version of K8 (F12 multiply and square,
ops/tower_kernels.py) against the JAX package's F12 tower on the CPU, bit
for bit.

The JAX side runs `Bn128PairingDevice.F12d.mul` / `.square` jitted: off
the TPU these are the composed formulas that the Pallas kernel body
`_f12_mul_kernel` computes.  Inputs are canonical Montgomery planes from a
seeded numpy generator, with one lane of edge values (0, 1, q-1), crossed
with `convert.tower_from_numpy`.  The CUDA kernel is held against the
same plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

from wasmsnark_tpu.ops.pairing import bn128_pairing_device

from wasmsnark_tpu_torch.convert import tower_from_numpy, tower_to_numpy
from wasmsnark_tpu_torch.models.bn128 import bn128
from wasmsnark_tpu_torch.ops import tower_kernels as tk

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SPEC = bn128().fp_spec
LANES = 3


def rand_planes(rng, n_planes, lanes=LANES):
    """n_planes canonical [L, lanes] uint32 planes; lane 0 holds the edge
    values 0, 1, q-1 in turn."""
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


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_k8_plain_matches_jax_f12(op):
    rng = np.random.default_rng(8 if op == "mul" else 9)
    a = tk.unflatten12(rand_planes(rng, 12))
    b = tk.unflatten12(rand_planes(rng, 12))
    jpd = bn128_pairing_device()
    ta, tb = tower_from_numpy(a, CPU), tower_from_numpy(b, CPU)
    if op == "mul":
        want = jax.jit(jpd.F12d.mul)(a, b)
        got = tk.f12_mul(SPEC, ta, tb)
        assert_same(tk.f12_mul_plain(SPEC, ta, tb), want)
    else:
        want = jax.jit(jpd.F12d.square)(a)
        got = tk.f12_sqr(SPEC, ta)
        assert_same(tk.f12_sqr_plain(SPEC, ta), want)
    # the wrapper on CPU tensors is the plain version
    assert_same(got, want)
