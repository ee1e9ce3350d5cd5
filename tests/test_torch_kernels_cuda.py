"""The CUDA kernels K1-K10 against their plain versions on the card.

Marked `cuda`: they need an NVIDIA card and nvcc, and skip elsewhere.  On
the card, where jax is not installed and tests/conftest.py would import
it: python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from wasmsnark_tpu_torch.models.bn128 import bn128
from wasmsnark_tpu_torch.ops import cuda_lib, curve, fp, ntt, towers
from wasmsnark_tpu_torch.ops import tower_kernels as tk

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_lib.build()
    return torch.device("cuda")


def _rand(spec, n, seed, dev):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(spec.n_limbs, n), dtype=np.uint32)
    a[-1] = rng.integers(0, spec.q_limbs[-1], size=n, dtype=np.uint32)
    for j, v in enumerate((0, 1, spec.q - 1, spec.q - 2)):
        a[:, j] = spec.limbs(v)
    return fp.planes(a, dev)


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_field_kernels_match_plain(dev, which):
    m = bn128()
    spec = m.fp_spec if which == "fp" else m.fr_spec
    x, y = _rand(spec, 4099, 1, dev), _rand(spec, 4099, 2, dev)
    for k, p in ((fp.mont_mul, fp.mont_mul_plain),
                 (fp.mod_add, fp.mod_add_plain),
                 (fp.mod_sub, fp.mod_sub_plain)):
        assert torch.equal(k(spec, x, y), p(spec, x, y)), k.__name__
    tw = _rand(spec, 1024, 3, dev)
    assert torch.equal(ntt.butterfly(spec, x[:, :4096], tw),
                       ntt.butterfly_plain(spec, x[:, :4096], tw))
    f = torch.arange(4099, device=dev) % 3 == 0
    assert torch.equal(towers.mod_cneg(spec, f, x),
                       towers.mod_cneg_plain(spec, f, x))


def test_curve_kernels_match_plain(dev):
    spec = bn128().fp_spec
    P = tuple(_rand(spec, 999, s, dev) for s in (4, 5, 6))
    Q = tuple(_rand(spec, 999, s, dev) for s in (7, 8, 9))
    P[2][:, :10] = 0
    Q[2][:, 10:20] = 0
    for a, b in zip(curve.jac_add(spec, P, Q), curve.jac_add_plain(spec, P, Q)):
        assert torch.equal(a, b)
    for a, b in zip(curve.jac_madd(spec, P, Q[:2]),
                    curve.jac_madd_plain(spec, P, Q[:2])):
        assert torch.equal(a, b)
    for a, b in zip(curve.jac_double(spec, P), curve.jac_double_plain(spec, P)):
        assert torch.equal(a, b)


def _flat(t):
    return [t] if isinstance(t, torch.Tensor) else [p for c in t
                                                    for p in _flat(c)]


def _assert_equal(a, b):
    for x, y in zip(_flat(a), _flat(b), strict=True):
        assert torch.equal(x, y)


def test_tower_kernels_match_plain(dev):
    spec = bn128().fp_spec
    n = 777
    a = tk.unflatten12([_rand(spec, n, s, dev) for s in range(10, 22)])
    b = tk.unflatten12([_rand(spec, n, s, dev) for s in range(22, 34)])
    _assert_equal(tk.f12_mul(spec, a, b), tk.f12_mul_plain(spec, a, b))
    _assert_equal(tk.f12_sqr(spec, a), tk.f12_sqr_plain(spec, a))
    _assert_equal(tk.f12_cyc_sqr(spec, a), tk.f12_cyc_sqr_plain(spec, a))
    X, Y, Z, q2 = [(_rand(spec, n, s, dev), _rand(spec, n, s + 1, dev))
                   for s in (40, 42, 44, 46)]
    xP, yP = _rand(spec, n, 48, dev), _rand(spec, n, 49, dev)
    Z[0][:, 5:9] = 0
    Z[1][:, 5:9] = 0
    _assert_equal(tk.miller_dbl(spec, X, Y, Z, xP, yP),
                  tk.miller_dbl_plain(spec, X, Y, Z, xP, yP))
    _assert_equal(tk.miller_add(spec, X, Y, Z, q2, X, xP, yP),
                  tk.miller_add_plain(spec, X, Y, Z, q2, X, xP, yP))
