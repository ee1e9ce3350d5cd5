"""The MNT6753 slice's single-proof entry points on the CPU:
wasmsnark_tpu_torch's verify (independent Miller lanes and a tree
product) and verify_fused (the fused Miller loop) on one synthetic
trapdoor proof, against the JAX package's Mnt6753Runtime.verify_sync on
the same vk and proof.  The helpers are those of
tests/test_torch_mnt_verify.py; each call runs the whole device path
(Pedersen hash, group map, prepared pairing) with the plain versions.
"""

import random

import pytest
import torch

from wasmsnark_tpu.models import mnt6753_runtime as jrt_mod

import wasmsnark_tpu_torch

from test_torch_mnt_verify import synthetic_proof, synthetic_vk

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    jrt = jrt_mod.Mnt6753Runtime()
    rt = wasmsnark_tpu_torch.build_mnt6753(device="cpu")
    rnd = random.Random(17)
    vk, trap = synthetic_vk(jrt.m, 2, rnd)
    pub = [str(rnd.randrange(1 << 100)), str(rnd.randrange(1 << 100))]
    return jrt, rt, vk, pub, synthetic_proof(jrt, trap, pub, rnd)


@pytest.mark.parametrize("entry", ["verify", "verify_fused"])
def test_single_proof_entry_points(case, entry):
    jrt, rt, vk, pub, proof = case
    got = getattr(rt, entry)(vk, pub, proof, rng=random.Random(5))
    assert got is jrt.verify_sync(vk, pub, proof) is True
