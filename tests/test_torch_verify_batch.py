"""Port parity: `groth16_verify_batch` of wasmsnark_tpu_torch on the CPU
(the device pairing with its kernels' plain versions), lane by lane
against the JAX package's host `groth16_verify`, on proofs from the
port's own prover at square_chain_circuit(3).

Lanes: a good proof, a tampered pi_a, a wrong public input, an input
>= r, a wrong input count and a zero pi_a.  A second batch against the
same vk must take the vk's prepared coefficients and its fixed-base vk_x
tables from the state the runtime's verifier keeps.

The device vk_x stage against the host ladder (IC[0] + sum v_j IC[j+1] by
double-and-add), bit for bit on BN128 and BLS12-381 with 7 hand-made IC
points (6 inputs), and with zero IC points; a hand-made vk whose vk_x is
the zero point on one lane, with a proof the pairing alone would accept
there; a key's state keyed by its points (IC, gamma2, delta2, beta2), at
most 4 keys.
"""

import json
import random

import pytest
import torch

from wasmsnark_tpu.groth16.verifier import groth16_verify as jverify

import wasmsnark_tpu_torch
from wasmsnark_tpu_torch.groth16 import setup as tsetup
from wasmsnark_tpu_torch.groth16 import verifier as tverifier
from wasmsnark_tpu_torch.groth16.pkey import write_witness
from wasmsnark_tpu_torch.models import curve_module
from wasmsnark_tpu_torch.models.bn128 import bn128
from wasmsnark_tpu_torch.ops.pairing import (bn128_pairing_device,
                                             pairing_device)

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


def _count_table_builds(monkeypatch) -> list:
    """Each build of a key's vk_x tables, as its number of bases."""
    builds = []
    build = tverifier.FixedBaseSum

    def counting(*args, **kwargs):
        builds.append(len(args[3]))            # IC[1..k]
        return build(*args, **kwargs)

    monkeypatch.setattr(tverifier, "FixedBaseSum", counting)
    return builds


def test_second_batch_hits_the_vk_cache(case, monkeypatch):
    rt, vk, lanes = case
    keys = rt.verifier._keys
    keys.clear()
    pd = rt.verifier.pd
    assert pd is bn128_pairing_device(CPU)
    builds = _count_table_builds(monkeypatch)
    calls = []
    prepare = pd.prepare_g2

    def counting(g2):
        calls.append(tuple(g2[0][0].shape))
        return prepare(g2)

    monkeypatch.setattr(pd, "prepare_g2", counting)
    first = rt.groth16_verify_batch(vk, [lanes[1][1], lanes[0][1]],
                                    [lanes[1][2], lanes[0][2]])
    assert first == [False, True]
    assert len(calls) == 2 and len(keys) == 1
    cached, = keys.values()
    second = rt.groth16_verify_batch(vk, [lanes[0][1]], [lanes[0][2]])
    assert second == [True]
    assert len(calls) == 3                      # pi_b only
    again, = keys.values()
    assert again is cached and builds == [1]
    assert rt.groth16_verify_batch(vk, [], []) == []
    with pytest.raises(ValueError):
        rt.groth16_verify_batch(vk, [lanes[0][1]], [])


def _g1_json(m, p):
    a = m.G1.affine(p)
    return [str(a[0]), str(a[1]), "1"]


def _g2_json(m, p):
    a = m.G2.affine(p)
    return [[str(c) for c in a[0]], [str(c) for c in a[1]], ["1", "0"]]


@pytest.mark.parametrize("curve", ["bn128", "bls12381"])
def test_vk_x_stage_matches_the_host_ladder(curve):
    mc = curve_module(curve)
    pd = pairing_device(curve, CPU)
    R = mc.Fr.q
    rng = random.Random(23)
    ic = [mc.G1.affine(mc.G1.times_scalar(mc.g1_gen, rng.randrange(1, R)))
          for _ in range(7)]
    edge = [0, 1, R - 1, 2 ** 160 - 1, 2 ** 57 - 1, rng.randrange(R)]
    lanes = [edge[j:] + edge[:j] for j in range(6)]
    lanes += [[0] * 6, [rng.randrange(R) for _ in range(6)]]
    table = tverifier._vk_x_table(pd, mc, ic)
    (x, y), ok = tverifier._vk_x_device(
        pd, mc, table, [[ln[j] for ln in lanes] for j in range(6)],
        len(lanes))
    got = list(zip(pd.fp.unpack_mont(x), pd.fp.unpack_mont(y)))
    want = []
    for ln in lanes:
        vk_x = ic[0]
        for j, v in enumerate(ln):
            vk_x = mc.G1.add(vk_x, mc.G1.times_scalar(ic[j + 1], v))
        want.append(tuple(mc.G1.affine(mc.G1.neg(vk_x))[:2]))
    assert want[6] == tuple(mc.G1.affine(mc.G1.neg(ic[0]))[:2])
    assert got == want
    assert ok.tolist() == [True] * len(lanes)


def test_vk_x_stage_with_zero_ic_points():
    """IC[0] and IC[2] the zero point: the start column and a base's whole
    table are the affine zero (0, 0); a lane whose vk_x is zero carries the
    generator's negation and a False mask."""
    pd = bn128_pairing_device(CPU)
    P = m.G1.affine(m.G1.times_scalar(m.g1_gen, 12345))
    ic = [m.G1.zero(), P, m.G1.zero()]
    lanes = [[0, 0], [1, 5], [3, 0], [m.Fr.q - 1, 7]]
    table = tverifier._vk_x_table(pd, m, ic)
    (x, y), ok = tverifier._vk_x_device(
        pd, m, table, [[ln[j] for ln in lanes] for j in range(2)],
        len(lanes))
    got = list(zip(pd.fp.unpack_mont(x), pd.fp.unpack_mont(y)))
    gen = m.G1.affine(m.G1.neg(m.g1_gen))[:2]
    want = [tuple(gen)] + [tuple(m.G1.affine(m.G1.neg(
        m.G1.times_scalar(P, ln[0])))[:2]) for ln in lanes[1:]]
    assert got == want
    assert ok.tolist() == [False, True, True, True]


def test_zero_vk_x_lane_answers_false(monkeypatch):
    """IC = (G, -G): the input 0 gives vk_x = G, the input 1 the zero
    point.  The proof satisfies the equation for vk_x = G, the point the
    device puts in a zero lane's place: the pairing alone accepts both
    lanes, the zero mask refuses the second, as the host verifier does."""
    R = m.Fr.q
    rng = random.Random(29)
    al, be, ga, de, a, b = (rng.randrange(1, R) for _ in range(6))
    c = (a * b - al * be - ga) * pow(de, -1, R) % R

    def g1(k):
        return _g1_json(m, m.G1.times_scalar(m.g1_gen, k))

    def g2(k):
        return _g2_json(m, m.G2.times_scalar(m.g2_gen, k))

    vk = {"vk_alfa_1": g1(al), "vk_beta_2": g2(be), "vk_gamma_2": g2(ga),
          "vk_delta_2": g2(de), "IC": [g1(1), g1(R - 1)]}
    proof = {"pi_a": g1(a), "pi_b": g2(b), "pi_c": g1(c)}
    inputs = [["0"], ["1"]]
    seen = []
    pairing = tverifier._pairing_batch

    def keep(*args):
        seen.append(pairing(*args))
        return seen[-1]

    monkeypatch.setattr(tverifier, "_pairing_batch", keep)
    got = tverifier.groth16_verify_batch(vk, inputs, [proof, proof],
                                         device=CPU)
    want = [jverify(vk, ins, proof) for ins in inputs]
    assert want == [True, False]
    assert got == want
    assert bn128_pairing_device(CPU).is_one(seen[0]).tolist() == [True, True]


def test_vk_x_tables_are_keyed_by_the_ic_points_alone(case, monkeypatch):
    """A key's state (its tables and prepared G2 coefficients) is keyed by
    the whole key's points, IC, gamma2, delta2 and beta2: alfa1, the
    proofs and the inputs leave it alone, another delta2 builds anew; at
    most four keys are kept."""
    _, vk, lanes = case
    verifier = tverifier.Groth16BatchVerifier("bn128", CPU)
    builds = _count_table_builds(monkeypatch)

    def marshal(key, ins, proofs):
        return verifier._batch_inputs(key, ins, proofs)

    good, wrong = lanes[0], lanes[2]
    marshal(vk, [good[1]], [good[2]])
    # other proofs and inputs, another alfa1: the same state
    other = dict(vk, vk_alfa_1=_g1_json(m, m.G1.times_scalar(m.g1_gen, 5)))
    *_, ok_host, vk_x_ok = marshal(other, [wrong[1], good[1]],
                                   [good[2], lanes[1][2]])
    assert builds == [1] and ok_host == [True, True]
    assert vk_x_ok.tolist() == [True, True]
    first, = verifier._keys.values()
    ic = [tverifier._g1_from_json(m, p) for p in vk["IC"]]
    g2 = [tverifier._g2_from_json(m, vk[k])
          for k in ("vk_gamma_2", "vk_delta_2", "vk_beta_2")]
    assert verifier._key_state(ic, g2) is first
    # another delta2: a key of its own
    moved = dict(vk, vk_delta_2=_g2_json(m, m.G2.times_scalar(m.g2_gen, 3)))
    marshal(moved, [good[1]], [good[2]])
    assert builds == [1, 1] and len(verifier._keys) == 2
    assert verifier._key_state(ic, g2) is first
    # three more keys of one IC point each (no inputs): the fifth key
    # clears the four kept before it
    for k in range(2, 5):
        one = dict(vk, IC=[_g1_json(m, m.G1.times_scalar(m.g1_gen, k))])
        marshal(one, [[]], [good[2]])
    assert builds == [1, 1, 0, 0, 0]
    last, = verifier._keys.values()
    assert verifier._key_state(
        [tverifier._g1_from_json(m, one["IC"][0])], g2) is last
