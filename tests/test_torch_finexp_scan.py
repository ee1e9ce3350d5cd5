"""The full-exponent self-check ladder final_exponentiation_scan of the
port's three pairing engines (ops/pairing.py: BN128 and BLS12-381 over
K8's square and product, MNT6753 over K12's) on the CPU path, against the
JAX package's method.

The full exponents (finexp_bits: (q^12 - 1)/r, and (q^3 - 1)(q + 1)(q + w0)
for MNT6753) must equal the JAX engines'.  The ladders then run with both
objects given the same shortened finexp_bits, the exponent's top 48 bits
(the full one is ~2,800-4,300 squarings, minutes of plain versions on
the CPU), on two lanes of numpy-seeded F12 / F6 values.  Tolerance: the
planes are bit-identical, and equal the host oracle's power by the
shortened exponent.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wasmsnark_tpu.ops import pairing as jpairing

from wasmsnark_tpu_torch.ops import fp
from wasmsnark_tpu_torch.ops import tower_kernels as tk
from wasmsnark_tpu_torch.ops.pairing import pairing_device

JAX_ENGINES = {"bn128": jpairing.Bn128PairingDevice,
               "bls12381": jpairing.Bls12381PairingDevice,
               "mnt6753": jpairing.Mnt6753PairingDevice}
BITS = 48
LANES = 2


@pytest.mark.parametrize("curve", ["bn128", "bls12381", "mnt6753"])
def test_final_exponentiation_scan_against_jax(curve, monkeypatch):
    pd = pairing_device(curve, "cpu")
    jd = JAX_ENGINES[curve]()
    assert np.array_equal(pd.finexp_bits, jd.finexp_bits)
    bits = pd.finexp_bits[:BITS].copy()
    monkeypatch.setattr(pd, "finexp_bits", bits)
    jd.finexp_bits = bits
    mnt = curve == "mnt6753"
    spec = pd.fp.spec
    rng = np.random.default_rng(4)
    comps = [[int.from_bytes(rng.bytes(spec.n8), "little") % spec.q
              for _ in range(LANES)] for _ in range(6 if mnt else 12)]
    unflatten = tk.unflatten6 if mnt else tk.unflatten12
    f = unflatten([pd.fp.pack_mont(c) for c in comps])
    got = pd.final_exponentiation_scan(f)
    want = jax.jit(jd.final_exponentiation_scan)(jax.tree_util.tree_map(
        lambda a: jnp.asarray(fp.to_numpy(a)), f))
    flat = tk.flatten6 if mnt else tk.flatten12
    for g, w in zip(flat(got), flat(want), strict=True):
        assert np.array_equal(fp.to_numpy(g), np.asarray(w))
    e = int("".join(str(int(b)) for b in bits), 2)
    tower = pd.m.F6 if mnt else pd.m.F12
    unpack = pd.unpack_f6 if mnt else pd.unpack_f12
    assert unpack(got) == [
        tower.exp(unflatten([c[b] for c in comps]), e) for b in range(LANES)]
