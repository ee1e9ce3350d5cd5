"""Port parity, end to end over BLS12-381: the trusted setup's key bytes
(48-byte Fq elements) and vk equal wasmsnark_tpu's for the same seed, the
CALC_H planes equal the JAX prover's, and the JAX package's host verifier
accepts the port's proof and rejects a tampered one and one from a bad
witness.

Tolerance: bit-identical key bytes, vk and CALC_H planes; the proof is
held by the JAX verifier's boolean.  The JAX BLS prover compiles for
minutes on the CPU, so the byte-for-byte comparison of the proof JSON with
it is in the slow tier (WASMSNARK_TPU_SLOW_TESTS=1), as the JAX package
gates its own BLS prove (tests/test_groth16_bls.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import wasmsnark_tpu
from wasmsnark_tpu.groth16 import setup as jsetup
from wasmsnark_tpu.groth16.pkey import parse_pkey
from wasmsnark_tpu.groth16.prover import Groth16Prover as JProver
from wasmsnark_tpu.groth16.verifier import groth16_verify as jverify
from wasmsnark_tpu.models.bls12381 import R, bls12381 as jbls

import wasmsnark_tpu_torch
from wasmsnark_tpu_torch.convert import proving_key_from_numpy
from wasmsnark_tpu_torch.groth16 import setup as tsetup
from wasmsnark_tpu_torch.groth16.pkey import parse_pkey as tparse
from wasmsnark_tpu_torch.groth16.pkey import write_witness
from wasmsnark_tpu_torch.models.bls12381 import bls12381 as tbls
from wasmsnark_tpu_torch.ops.fp import planes, to_numpy

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 3
jm, m = jbls(), tbls()


@pytest.fixture(scope="module")
def keys():
    pkey, vk, _ = jsetup.setup(jsetup.square_chain_circuit(K), seed=1,
                               module=jm)
    return pkey, vk


@pytest.fixture(scope="module")
def port():
    return wasmsnark_tpu_torch.build_bls12381(device=CPU)


@pytest.fixture(scope="module")
def proof(keys, port):
    pkey, _ = keys
    wit = tsetup.square_chain_witness(K, 5, r=R)
    return wit, port.groth16_gen_proof(write_witness(wit, m.fr_spec), pkey,
                                       rng=7)


def test_setup_bytes_equal_jax(keys):
    pkey, vk = keys
    tk, tvk, _ = tsetup.setup(tsetup.square_chain_circuit(K), seed=1,
                              module=m, device=CPU)
    assert tk == pkey
    assert tvk == vk
    assert tsetup.square_chain_witness(K, 5, r=R) == \
        jsetup.square_chain_witness(K, 5, r=R)


def test_pkey_parse_48_byte_elements_matches_jax(keys):
    pkey, _ = keys
    jpk = parse_pkey(pkey, jm.fp_spec, jm.fr_spec)
    tpk = tparse(pkey, m.fp_spec, m.fr_spec)
    for name in ("n_signals", "n_public", "domain_size", "alfa1", "beta1",
                 "delta1", "beta2", "delta2"):
        assert getattr(tpk, name) == getattr(jpk, name)
    assert tpk.points_a[0].shape == (24, tpk.n_signals)
    assert tpk.points_b2[0][0].shape == (24, tpk.n_signals)
    for name in ("points_a", "points_b1", "points_b2", "points_c", "h_exps"):
        for a, b in zip(np.asarray(getattr(tpk, name), dtype=object).flat,
                        np.asarray(getattr(jpk, name), dtype=object).flat):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x, y = tpk.alfa1                       # on y^2 = x^3 + 4
    assert (y * y - (x ** 3 + 4)) % m.F1.q == 0


def test_calc_h_planes_equal_jax(keys, port):
    pkey, _ = keys
    jpk = parse_pkey(pkey, jm.fp_spec, jm.fr_spec)
    wit = jsetup.square_chain_witness(K, 5, r=R)
    sig = np.stack([np.array(m.fr_spec.limbs(v), np.uint32) for v in wit], 1)
    want = np.asarray(JProver(curve="bls12381").calc_h(jpk, sig))
    got = port.prover.calc_h(proving_key_from_numpy(jpk), planes(sig, CPU))
    np.testing.assert_array_equal(to_numpy(got), want)


def test_jax_host_verifier_accepts_port_proof(keys, port, proof):
    _, vk = keys
    wit, prf = proof
    pub = [str(wit[1])]
    assert jverify(vk, pub, prf, curve="bls12381") is True
    assert port.groth16_verify(vk, pub, prf) is True
    tampered = json.loads(json.dumps(prf))
    tampered["pi_a"][0] = str(int(tampered["pi_a"][0]) + 1)
    assert jverify(vk, pub, tampered, curve="bls12381") is False
    assert port.groth16_verify(vk, pub, tampered) is False


def test_bad_witness_proof_rejected_by_jax(keys, port):
    pkey, vk = keys
    wit = tsetup.square_chain_witness(K, 5, r=R)
    bad = list(wit)
    bad[3] += 1
    pbad = port.groth16_gen_proof(bad, pkey, rng=7)
    assert jverify(vk, [str(wit[1])], pbad, curve="bls12381") is False


def test_runtime_passes_through_to_the_module(port):
    assert port.module.F1.q == port.F1.q == jm.F1.q
    assert port.prover.m is port.module
    g = port.G1.times_scalar(port.g1_gen, 7)
    assert not port.G1.is_zero(g)


@pytest.mark.skipif(os.environ.get("WASMSNARK_TPU_SLOW_TESTS") != "1",
                    reason="the JAX BLS prover compiles for ~8 min on the "
                           "CPU (tests/test_groth16_bls.py gates it alike)")
def test_proof_json_equals_jax_byte_for_byte(keys, proof):
    pkey, _ = keys
    wit, prf = proof
    want = wasmsnark_tpu.build_bls12381().groth16_gen_proof(
        write_witness(wit, m.fr_spec), pkey, rng=7)
    assert json.dumps(prf) == json.dumps(want)
