"""Port parity, end to end: the trusted setup's key bytes and the proof JSON
of wasmsnark_tpu_torch equal wasmsnark_tpu's on the CPU, and the host
verifier accepts the port's proof and rejects a bad witness (the pattern
of tests/test_groth16_e2e.py, at its circuit size so the JAX programs are
cached)."""

import json

import pytest
import torch

import wasmsnark_tpu
from wasmsnark_tpu.groth16 import setup as jsetup
from wasmsnark_tpu.groth16.pkey import parse_pkey, write_witness
from wasmsnark_tpu.models.bn128 import bn128

import wasmsnark_tpu_torch
from wasmsnark_tpu_torch.convert import proving_key_from_numpy
from wasmsnark_tpu_torch.groth16 import setup as tsetup
from wasmsnark_tpu_torch.groth16.pkey import parse_pkey as tparse

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 3
m = bn128()


@pytest.fixture(scope="module")
def keys():
    pkey, vk, _ = jsetup.setup(jsetup.square_chain_circuit(K), seed=1)
    return pkey, vk


@pytest.fixture(scope="module")
def port():
    return wasmsnark_tpu_torch.build_bn128(device=CPU)


def test_setup_bytes_equal_jax(keys):
    """The port's setup, point sections through its fixed-base engine,
    writes the JAX setup's key and vk for the same seed."""
    pkey, vk = keys
    tk, tvk, ttox = tsetup.setup(tsetup.square_chain_circuit(K), seed=1,
                                 device=CPU)
    assert tk == pkey
    assert tvk == vk
    assert tsetup.square_chain_witness(K, 5) == \
        jsetup.square_chain_witness(K, 5)


def test_proof_json_equals_jax_and_verifies(keys, port):
    pkey, vk = keys
    wit = jsetup.square_chain_witness(K, 5)
    wbytes = write_witness(wit, m.fr_spec)
    want = wasmsnark_tpu.build_bn128().groth16_gen_proof(wbytes, pkey, rng=7)
    jpk = parse_pkey(pkey, m.fp_spec, m.fr_spec)
    got = port.groth16_gen_proof(wbytes, proving_key_from_numpy(jpk), rng=7)
    assert json.dumps(got) == json.dumps(want)
    assert port.groth16_verify(vk, [str(wit[1])], got) is True


def test_g2_windows_fold_on_the_host(keys, port, monkeypatch):
    """In one prove the device fold runs once, over the four stacked G1
    MSMs, and never over G2: the G2 MSM's window sums are folded on the
    host, once, over the oracle's G2 (c = 4 at this size: 64 windows and
    the carry window).  The proof JSON stays the JAX package's byte for
    byte."""
    from wasmsnark_tpu_torch.groth16 import prover as prover_mod
    from wasmsnark_tpu_torch.ops import msm as msm_mod
    pkey, _ = keys
    wbytes = write_witness(jsetup.square_chain_witness(K, 5), m.fr_spec)
    want = wasmsnark_tpu.build_bn128().groth16_gen_proof(wbytes, pkey, rng=7)
    folds = []
    device_fold = msm_mod.fold_windows_device
    host_fold = prover_mod.fold_windows

    def fold_windows_device(curve, win, window_bits):
        folds.append(("device", curve, tuple(win[0].shape[1:])))
        return device_fold(curve, win, window_bits)

    def fold_windows(curve, points, window_bits):
        folds.append(("host", curve, len(points)))
        return host_fold(curve, points, window_bits)

    monkeypatch.setattr(msm_mod, "fold_windows_device", fold_windows_device)
    monkeypatch.setattr(prover_mod, "fold_windows", fold_windows)
    got = port.groth16_gen_proof(wbytes, pkey, rng=7)
    prover = port.prover
    assert folds == [("device", prover.G1d, (4, 65)),
                     ("host", prover.m.G2, 65)]
    assert json.dumps(got) == json.dumps(want)


def test_bad_witness_and_tampered_proof_rejected(keys, port):
    pkey, vk = keys
    wit = jsetup.square_chain_witness(K, 5)
    bad = list(wit)
    bad[3] += 1
    pbad = port.groth16_gen_proof(bad, pkey, rng=7)
    assert port.groth16_verify(vk, [str(wit[1])], pbad) is False
    # from the key bytes through the port's own parser, with the prover's
    # phase timings on
    timings = {}
    good = port.prover.prove(wit, pkey, rng=lambda n: b"\0" * n,
                             timings=timings)
    assert port.groth16_verify(vk, [str(wit[1])], good) is True
    assert list(timings) == ["key_and_witness", "calc_h", "msm_g1", "msm_g2",
                             "host_assembly"]
    tampered = json.loads(json.dumps(good))
    tampered["pi_c"][1] = str(int(tampered["pi_c"][1]) + 1)
    assert port.groth16_verify(vk, [str(wit[1])], tampered) is False
    assert port.groth16_verify(vk, [str(m.Fr.q)], good) is False


def test_pkey_parse_matches_jax(keys):
    pkey, _ = keys
    jpk = parse_pkey(pkey, m.fp_spec, m.fr_spec)
    tpk = tparse(pkey, m.fp_spec, m.fr_spec)
    conv = proving_key_from_numpy(jpk)
    for name in ("n_signals", "n_public", "domain_size", "alfa1", "beta1",
                 "delta1", "beta2", "delta2"):
        assert getattr(tpk, name) == getattr(jpk, name) == getattr(conv, name)
    def leaves(t):
        return [x for c in t for x in leaves(c)] if isinstance(t, tuple) \
            else [t]

    for name in ("points_a", "points_b1", "points_b2", "points_c", "h_exps"):
        for a, b in zip(leaves(getattr(tpk, name)), leaves(getattr(jpk, name))):
            assert a.dtype == b.dtype and (a == b).all()
    for name in ("pols_a", "pols_b"):
        a, b = getattr(tpk, name), getattr(jpk, name)
        got = sorted(zip(a.coef_idx.tolist(), a.sig_idx.tolist(),
                         map(tuple, a.coefs.T.tolist())))
        want = sorted(zip(b.coef_idx.tolist(), b.sig_idx.tolist(),
                          map(tuple, b.coefs.T.tolist())))
        assert got == want
