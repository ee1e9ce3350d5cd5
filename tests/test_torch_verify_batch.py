"""Port parity: `groth16_verify_batch` of wasmsnark_tpu_torch on the CPU
(the device pairing with its kernels' plain versions), lane by lane
against the JAX package's host `groth16_verify`, on proofs from the
port's own prover at square_chain_circuit(3).

Lanes: a good proof, a tampered pi_a, a wrong public input, an input
>= r, a wrong input count and a zero pi_a.  A second batch against the
same vk must take the vk's prepared coefficients from the cache.
"""

import json

import pytest
import torch

from wasmsnark_tpu.groth16.verifier import groth16_verify as jverify

import wasmsnark_tpu_torch
from wasmsnark_tpu_torch.groth16 import setup as tsetup
from wasmsnark_tpu_torch.groth16.pkey import write_witness
from wasmsnark_tpu_torch.models.bn128 import bn128
from wasmsnark_tpu_torch.ops.pairing import bn128_pairing_device

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 3
m = bn128()


@pytest.fixture(scope="module")
def case():
    pkey, vk, _ = tsetup.setup(tsetup.square_chain_circuit(K), seed=2,
                               device=CPU)
    rt = wasmsnark_tpu_torch.build_bn128(device=CPU)
    wit = tsetup.square_chain_witness(K, 5)
    proof = rt.groth16_gen_proof(write_witness(wit, m.fr_spec), pkey, rng=7)
    pub = [str(wit[1])]
    tampered = json.loads(json.dumps(proof))
    tampered["pi_a"][0] = str(int(tampered["pi_a"][0]) + 1)
    zero_a = json.loads(json.dumps(proof))
    zero_a["pi_a"] = ["0", "1", "0"]
    lanes = [
        ("good", pub, proof),
        ("tampered pi_a", pub, tampered),
        ("wrong input", [str(wit[1] + 1)], proof),
        ("input >= r", [str(int(pub[0]) + m.Fr.q)], proof),
        ("wrong count", pub + ["1"], proof),
        ("zero pi_a", pub, zero_a),
    ]
    return rt, vk, lanes


def test_verify_batch_matches_host_verify_per_lane(case):
    rt, vk, lanes = case
    got = rt.groth16_verify_batch(vk, [ln[1] for ln in lanes],
                                  [ln[2] for ln in lanes])
    want = [jverify(vk, ln[1], ln[2]) for ln in lanes]
    assert want == [True] + [False] * 5
    assert dict(zip((ln[0] for ln in lanes), got)) == \
        dict(zip((ln[0] for ln in lanes), want))


def test_second_batch_hits_the_vk_cache(case, monkeypatch):
    rt, vk, lanes = case
    pd = bn128_pairing_device(CPU)
    pd.vk_prep_cache.clear()
    calls = []
    prepare = pd.prepare_g2

    def counting(g2):
        calls.append(tuple(g2[0][0].shape))
        return prepare(g2)

    monkeypatch.setattr(pd, "prepare_g2", counting)
    first = rt.groth16_verify_batch(vk, [lanes[1][1], lanes[0][1]],
                                    [lanes[1][2], lanes[0][2]])
    assert first == [False, True]
    assert len(calls) == 2 and len(pd.vk_prep_cache) == 1
    cached = next(iter(pd.vk_prep_cache.values()))
    second = rt.groth16_verify_batch(vk, [lanes[0][1]], [lanes[0][2]])
    assert second == [True]
    assert len(calls) == 3                      # pi_b only
    assert next(iter(pd.vk_prep_cache.values())) is cached
    assert rt.groth16_verify_batch(vk, [], []) == []
    with pytest.raises(ValueError):
        rt.groth16_verify_batch(vk, [lanes[0][1]], [])
