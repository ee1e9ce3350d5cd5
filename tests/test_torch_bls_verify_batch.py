"""Port parity: `groth16_verify_batch(curve="bls12381")` of
wasmsnark_tpu_torch on the CPU (the BLS12-381 device pairing with its
kernels' plain versions), lane by lane against the JAX package's host
`groth16_verify(..., curve="bls12381")`, on a proof from the port's own
prover at square_chain_circuit(3).

Lanes: a good proof, a host re-randomised copy (A' = r^-1 A, B' = r B), a
tampered pi_a, a wrong public input, an input >= r, a wrong input count
and a zero pi_a.  The vk's prepared coefficients are kept by the
BLS12-381 verifier that made them (not the BN128 one), and a second batch
takes them from there.  Tolerance: the booleans are equal.
"""

import json

import pytest
import torch

from wasmsnark_tpu.groth16.verifier import groth16_verify as jverify

import wasmsnark_tpu_torch
from wasmsnark_tpu_torch.groth16 import setup as tsetup
from wasmsnark_tpu_torch.groth16 import verifier as tverifier
from wasmsnark_tpu_torch.groth16.pkey import write_witness
from wasmsnark_tpu_torch.models.bls12381 import R, bls12381
from wasmsnark_tpu_torch.ops.pairing import (bls12381_pairing_device,
                                             bn128_pairing_device)

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 3
m = bls12381()


@pytest.fixture(scope="module")
def case():
    pkey, vk, _ = tsetup.setup(tsetup.square_chain_circuit(K), seed=2,
                               module=m, device=CPU)
    rt = wasmsnark_tpu_torch.build_bls12381(device=CPU)
    wit = tsetup.square_chain_witness(K, 5, r=R)
    proof = rt.groth16_gen_proof(write_witness(wit, m.fr_spec), pkey, rng=7)
    pub = [str(wit[1])]
    r = 123456789
    a = m.G1.affine(m.G1.times_scalar(
        tverifier._g1_from_json(m, proof["pi_a"]), pow(r, -1, R)))
    b = m.G2.affine(m.G2.times_scalar(
        tverifier._g2_from_json(m, proof["pi_b"]), r))
    rerand = dict(proof, pi_a=[str(v) for v in a],
                  pi_b=[[str(c) for c in v] for v in b])
    tampered = json.loads(json.dumps(proof))
    tampered["pi_a"][0] = str(int(tampered["pi_a"][0]) + 1)
    zero_a = json.loads(json.dumps(proof))
    zero_a["pi_a"] = ["0", "1", "0"]
    lanes = [
        ("good", pub, proof),
        ("re-randomised", pub, rerand),
        ("tampered pi_a", pub, tampered),
        ("wrong input", [str(wit[1] + 1)], proof),
        ("input >= r", [str(int(pub[0]) + R)], proof),
        ("wrong count", pub + ["1"], proof),
        ("zero pi_a", pub, zero_a),
    ]
    return rt, vk, lanes


@pytest.fixture(scope="module")
def first_batch(case):
    """The whole batch once through the module-level entry point, from an
    empty key cache of its BLS12-381 verifier, counting the BLS engine's
    prepare_g2 calls."""
    rt, vk, lanes = case
    verifier = tverifier._verifier("bls12381", CPU)
    verifier._keys.clear()
    pd = bls12381_pairing_device(CPU)
    bn_keys = list(tverifier._verifier("bn128", CPU)._keys.values())
    calls = []
    prepare = pd.prepare_g2

    def counting(g2):
        calls.append(tuple(g2[0][0].shape))
        return prepare(g2)

    pd.prepare_g2 = counting
    try:
        got = tverifier.groth16_verify_batch(
            vk, [ln[1] for ln in lanes], [ln[2] for ln in lanes],
            curve="bls12381", device=CPU)
    finally:
        del pd.prepare_g2
    return got, calls, bn_keys


def test_bls_verify_batch_matches_jax_host_verify_per_lane(case,
                                                           first_batch):
    _, vk, lanes = case
    got, calls, bn_keys = first_batch
    want = [jverify(vk, ln[1], ln[2], curve="bls12381") for ln in lanes]
    assert want == [True, True] + [False] * 5
    assert dict(zip((ln[0] for ln in lanes), got)) == \
        dict(zip((ln[0] for ln in lanes), want))
    # pi_b's ladder and the vk's, whose state the BLS12-381 verifier of
    # the device keeps; the BN128 one's is as it was
    verifier = tverifier._verifier("bls12381", CPU)
    assert verifier.pd is bls12381_pairing_device(CPU)
    assert len(calls) == 2 and len(verifier._keys) == 1
    bn = tverifier._verifier("bn128", CPU)
    assert bn.pd is bn128_pairing_device(CPU)
    assert len(bn._keys) == len(bn_keys) and all(
        a is b for a, b in zip(bn._keys.values(), bn_keys))


def test_second_bls_batch_hits_the_vk_cache(case, first_batch, monkeypatch):
    _, vk, lanes = case
    verifier = tverifier._verifier("bls12381", CPU)
    cached, = verifier._keys.values()
    pd = bls12381_pairing_device(CPU)
    calls = []
    prepare = pd.prepare_g2

    def counting(g2):
        calls.append(tuple(g2[0][0].shape))
        return prepare(g2)

    monkeypatch.setattr(pd, "prepare_g2", counting)
    assert tverifier.groth16_verify_batch(
        vk, [lanes[1][1]], [lanes[1][2]], curve="bls12381",
        device=CPU) == [True]
    assert len(calls) == 1                      # pi_b only
    again, = verifier._keys.values()
    assert again is cached
