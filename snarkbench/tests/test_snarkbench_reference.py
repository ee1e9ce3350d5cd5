"""The plain reference accepts a valid Groth16 proof and rejects each
kind of tampered lane, by the pairing and in the exponent, on both
curves at a tiny circuit; it imports nothing of the program."""

import ast
import os
import random

import pytest

from snarkbench import circuit
from snarkbench.reference import groth16 as ref
from snarkbench.reference.pairing import curve, domain_root

import small

REF_DIR = os.path.join(small.HERE, "reference")


@pytest.fixture(scope="module", params=["bn128", "bls12381"])
def setup(request):
    cv = curve(request.param)
    cfg = dict(small.prove_cfg(96), curve=request.param)
    circ = circuit.generate(cfg, 7, cv.r)
    td = ref.Trapdoor.draw(2 ** 31 + 5, cv.r)
    qap = ref.qap_at(circ.constraints, circ.n_signals, circ.n_public,
                     td.tau, cv.r)
    vk = ref.verifying_key(cv, qap, td, circ.n_public)
    w = circuit.witness(circ, random.Random(3))
    kc = ref.private_coeffs(qap, td, cv.r)
    logs = ref.proof_scalars(qap, td, kc, w, circ.n_public, cv.r,
                             2 ** 255 + 11, 2 ** 254 + 3)
    return cv, td, vk, w[1:circ.n_public + 1], logs


def test_valid_proof_accepted(setup):
    cv, td, vk, pubs, logs = setup
    assert ref.verify_pairing(cv, vk, pubs, ref.proof_json(cv, *logs))
    assert ref.verify_exponent(td, vk.ic_scalars, pubs, *logs, cv.r)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_moved_point_rejected(setup, which):
    cv, td, vk, pubs, logs = setup
    moved = [v + (k == which) for k, v in enumerate(logs)]
    assert not ref.verify_pairing(cv, vk, pubs, ref.proof_json(cv, *moved))
    assert not ref.verify_exponent(td, vk.ic_scalars, pubs, *moved, cv.r)


def test_changed_input_rejected(setup):
    cv, td, vk, pubs, logs = setup
    bad = [pubs[0] + 1] + pubs[1:]
    assert not ref.verify_pairing(cv, vk, bad, ref.proof_json(cv, *logs))
    assert not ref.verify_exponent(td, vk.ic_scalars, bad, *logs, cv.r)


def test_noncanonical_input_rejected_only_with_range_check(setup):
    cv, td, vk, pubs, logs = setup
    bad = [pubs[0] + cv.r] + pubs[1:]
    proof = ref.proof_json(cv, *logs)
    assert not ref.verify_pairing(cv, vk, bad, proof)
    assert not ref.verify_exponent(td, vk.ic_scalars, bad, *logs, cv.r)
    # the control's verifier: the same equation, no range check
    assert ref.verify_exponent(td, vk.ic_scalars, bad, *logs, cv.r,
                               check_range=False)


def test_wrong_input_count_rejected(setup):
    cv, td, vk, pubs, logs = setup
    assert not ref.verify_pairing(cv, vk, pubs[:-1], ref.proof_json(cv, *logs))
    assert not ref.verify_exponent(td, vk.ic_scalars, pubs + [1], *logs, cv.r)


def test_off_curve_point_rejected(setup):
    cv, td, vk, pubs, logs = setup
    proof = ref.proof_json(cv, *logs)
    proof["pi_a"] = [str(int(proof["pi_a"][0]) + 1)] + proof["pi_a"][1:]
    assert not ref.verify_pairing(cv, vk, pubs, proof)


@pytest.mark.parametrize("name", ["bn128", "bls12381"])
def test_pairing_bilinear(name):
    cv = curve(name)
    a, b = 123456789, 987654321
    assert cv.pairing_eq([(cv.g1_mul(a), cv.g2_mul(b)),
                          (cv.G1.neg(cv.g1_mul(a * b)), cv.g2)])
    assert not cv.pairing_eq([(cv.g1_mul(a), cv.g2_mul(b)),
                              (cv.G1.neg(cv.g1_mul(a * b + 1)), cv.g2)])


@pytest.mark.parametrize("name", ["bn128", "bls12381"])
def test_domain_root_order(name):
    r = curve(name).r
    for bits in (1, 5, 17):
        w = domain_root(r, bits)
        assert pow(w, 1 << bits, r) == 1 and pow(w, 1 << (bits - 1), r) != 1


def test_fixed_base_equals_double_and_add():
    cv = curve("bn128")
    k = random.Random(1).randrange(cv.r)
    assert cv.G1.eq(cv.g1_mul(k), cv.G1.times_scalar(cv.g1, k))
    assert cv.G2.eq(cv.g2_mul(k), cv.G2.times_scalar(cv.g2, k))


def test_reference_imports_only_itself():
    for fn in os.listdir(REF_DIR):
        if not fn.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF_DIR, fn)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("__future__", "dataclasses",
                                           "functools", "importlib",
                                           "random"), (fn, n)
