"""Port parity for MNT6753's batched Pedersen hash and group map
(models/mnt6753_device.py) against the JAX package.

The window tables are held against the JAX package's own
(`Mnt6753Device._window_tables`, carried across by convert); the hash and
the group map against its host oracle (`Mnt6753.pedersen_hash`,
`Mnt6753.group_map`), since its 48-limb device path compiles for minutes
on the CPU.  Inputs: the verifier's 6,028-bit strings (seeded random bits
and all zeros) and strings that end at the first chunk boundary (188
windows, 564 bits) and one window past it (567 bits); group-map inputs
from seeded blake2s digests, with one whose first two candidates fail.
Tolerance 0 on the canonical affine coordinates.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from wasmsnark_tpu.models.mnt6753 import mnt6753 as jmnt
from wasmsnark_tpu.models.mnt6753_device import Mnt6753Device as JDev

from wasmsnark_tpu_torch import convert
from wasmsnark_tpu_torch.models.mnt6753_device import (VERIFIER_BITS,
                                                       mnt6753_device)
from wasmsnark_tpu_torch.ops import fp as tfp
from wasmsnark_tpu_torch.utils.serialize import ints_to_limbs

torch.set_num_threads(1)

jm = jmnt()
Q = jm.fp_spec.q
dev = mnt6753_device("cpu")


def test_window_tables_equal_the_jax_package_tables():
    tx, ty = JDev()._window_tables
    assert tx.shape == (48, (VERIFIER_BITS + 2) // 3, 4)
    ours = dev._window_tables
    theirs = convert.tower_from_numpy((tx, ty), "cpu")
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    assert np.array_equal(tfp.to_numpy(ours[0]), tx)


@pytest.mark.parametrize("nbits", [VERIFIER_BITS, 188 * 3, 189 * 3])
def test_pedersen_hash_against_the_oracle(nbits):
    rng = random.Random(nbits)
    strings = [[rng.randrange(2) for _ in range(nbits)] for _ in range(2)]
    strings.append([0] * nbits)
    bits = torch.tensor(strings, dtype=torch.int64).t()
    got = dev.fp.unpack(dev.pedersen_hash(bits))
    assert got == [jm.pedersen_hash(s) for s in strings]


def _digest(seed):
    return int.from_bytes(hashlib.blake2s(seed.to_bytes(8, "little"))
                          .digest(), "little")


def test_group_map_against_the_oracle():
    """Seeded digests, one of them taking the third candidate x."""
    ts = [_digest(s) for s in range(3)]
    for s in range(3, 200):              # the third candidate: x1, x2 fail
        t = _digest(s)
        if not any(_candidate_hits(t, k) for k in (0, 1)):
            ts.append(t)
            break
    assert len(ts) == 4
    x, y, z = dev.group_map(tfp.planes(ints_to_limbs(ts, 48), "cpu"))
    xs, ys, zs = (dev.fp.unpack_mont(c) for c in (x, y, z))
    for t, xx, yy, zz in zip(ts, xs, ys, zs):
        want = jm.G1.affine(jm.group_map(t))[:2]
        assert zz == 1 and (xx, yy) == want
        assert yy % 2 == 0                         # the even root


def _candidate_hits(t, k):
    """Whether candidate k (0: v, 1: -(1 + v)) of the reference's group
    map has a square right-hand side (the oracle's own arithmetic)."""
    from wasmsnark_tpu.models.mnt6753_constants import (
        A, B, GROUP_MAP_CONIC_C, GROUP_MAP_PROJ_Z)
    F = jm.F1
    ct = F.mul(GROUP_MAP_CONIC_C, t % Q)
    s = F.mul(F.add(ct, GROUP_MAP_PROJ_Z), F.inv(F.add(F.mul(ct, t % Q), 1)))
    s = F.add(s, s)
    z = F.sub(GROUP_MAP_PROJ_Z, s)
    y = F.sub(1, F.mul(s, t % Q))
    v = F.sub(F.mul(z, F.inv(y)), pow(2, -1, Q))
    x = (v, F.neg(F.add(1, v)))[k]
    rhs = F.add(F.add(F.mul(F.square(x), x), F.mul(A, x)), B)
    return jm.fp_spec.is_square(rhs)
