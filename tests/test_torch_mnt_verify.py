"""The MNT6753 slice end to end on the CPU: wasmsnark_tpu_torch's
Bowe-Gabizon verifier (build_mnt6753(device="cpu"), every kernel by its
plain version) against the JAX package's Mnt6753Runtime.

The Coda test vectors are not in the repository, so a trapdoor
construction gives valid proofs (`synthetic_vk`, `synthetic_proof`, the
JAX runtime's own calculate_ys for Ys).  Held against the JAX package:
the marshalling (the port's device stage, unpacked, against the JAX
`_marshal` with the same rho: its os.urandom patched here, the port's
rng seeded with the same bytes), `verify_sync`, and the device batch
`bowe_gabizon_verify_batch` on three lanes — a good proof, one with a
tampered C, one with the wrong input count — whose answers must equal
the JAX verify_sync's (True, False, False).  The fixed-base F6 power of
the marshalling is held against the JAX package's F6.exp.  verify and
verify_fused run in tests/test_torch_mnt_verify_single.py.
"""

import json
import random

import pytest
import torch

from wasmsnark_tpu.models import mnt6753_runtime as jrt_mod

import wasmsnark_tpu_torch

torch.set_num_threads(1)


def synthetic_vk(m, n_inputs, rnd):
    """query_i = q_i G1, alphaBeta = e(G1, G2)^k, delta = t G2; returns
    (vk JSON, trapdoor)."""
    R = m.Fr.q
    qs = [rnd.randrange(1, R) for _ in range(n_inputs + 1)]
    k, t = rnd.randrange(1, R), rnd.randrange(1, R)
    ab = m.F6.exp(m.pairing(m.g1_gen, m.g2_gen), k)
    vk = {"query": [g1_json(m, m.G1.times_scalar(m.g1_gen, q)) for q in qs],
          "alphaBeta": {"a": f3_json(ab[0]), "b": f3_json(ab[1])},
          "delta": g2_json(m, m.G2.times_scalar(m.g2_gen, t))}
    return vk, {"qs": qs, "k": k, "t": t}


def synthetic_proof(rt, trap, inputs, rnd):
    """A = a G1, B = b G2, deltaPrime = d G2, C = ((ab - x - k)/d) G1 with
    x = q_0 + sum in_i q_i, Z = (d/t) Ys, Ys = calculate_ys(A, B, C, dp):
    both pairing checks hold."""
    m = rt.m
    R = m.Fr.q
    G1, G2 = m.G1, m.G2
    a, b, d = (rnd.randrange(1, R) for _ in range(3))
    qs = trap["qs"]
    x = (qs[0] + sum(int(v) * q for v, q in zip(inputs, qs[1:]))) % R
    A, B = G1.times_scalar(m.g1_gen, a), G2.times_scalar(m.g2_gen, b)
    C = G1.times_scalar(m.g1_gen, (a * b - x - trap["k"]) * pow(d, -1, R) % R)
    D = G2.times_scalar(m.g2_gen, d)
    ys = rt.calculate_ys(G1.affine(A), G2.affine(B), G1.affine(C),
                         G2.affine(D))
    Z = G1.times_scalar(ys, d * pow(trap["t"], -1, R) % R)
    return {"a": g1_json(m, A), "b": g2_json(m, B), "c": g1_json(m, C),
            "deltaPrime": g2_json(m, D), "z": g1_json(m, Z)}


def f3_json(v):
    return {"a": str(v[0]), "b": str(v[1]), "c": str(v[2])}


def g1_json(m, p):
    x, y = m.G1.affine(p)[:2]
    return {"x": str(x), "y": str(y)}


def g2_json(m, p):
    x, y = m.G2.affine(p)[:2]
    return {"x": f3_json(x), "y": f3_json(y)}


@pytest.fixture(scope="module")
def case():
    """(JAX runtime, port runtime, vk, public input, good proof, proof with
    C + G1)."""
    jrt = jrt_mod.Mnt6753Runtime()
    rt = wasmsnark_tpu_torch.build_mnt6753(device="cpu")
    rnd = random.Random(7)
    vk, trap = synthetic_vk(jrt.m, 1, rnd)
    pub = [str(rnd.randrange(1 << 200))]
    good = synthetic_proof(jrt, trap, pub, rnd)
    bad = json.loads(json.dumps(good))
    m = jrt.m
    bad["c"] = g1_json(m, m.G1.add(jrt._g1_affine(good["c"]), m.g1_gen))
    return jrt, rt, vk, pub, good, bad


def unpacked(rt, mb):
    """rt._marshal_batch's Marshalled planes, per lane as the JAX
    package's _marshal gives them."""
    fp = rt._pd.fp

    def lanes(half):            # coordinate planes -> per lane tuples
        return list(zip(*(fp.unpack_mont(c) for c in half)))

    g1 = [lanes([c[:, k] for c in mb.g1_4]) for k in range(4)]
    g2 = [list(zip(*(lanes([c[:, k] for c in half]) for half in mb.g2_var)))
          for k in range(2)]
    expected = rt._pd.unpack_f6(mb.expected)
    return [{"g1_4": [g1[k][n] for k in range(4)],
             "g2_var": [g2[0][n], g2[1][n]], "delta": mb.delta,
             "expected": expected[n], "bits": bits}
            for n, bits in enumerate(mb.bits.T.tolist())]


def test_marshal_equals_the_jax_package_with_the_same_rho(case,
                                                          monkeypatch):
    """The device marshalling of a good lane, one with C + G1 and one with
    an input >= r: the four affine G1 points, (B, dp), delta,
    alphaBeta^rho and the hash's bits, as the JAX package's host _marshal
    gives them with the same rho lane for lane."""
    jrt, rt, vk, pub, good, bad = case
    big = [str(int(pub[0]) + 3 * jrt.m.Fr.q)]
    ins, prs = [pub, pub, big], [good, bad, good]
    src = random.Random(11)
    monkeypatch.setattr(jrt_mod.os, "urandom", src.randbytes)
    want = [jrt._marshal(vk, i, p) for i, p in zip(ins, prs)]
    ok_idx, mb = rt._marshal_batch(vk, ins, prs, random.Random(11))
    assert ok_idx == [0, 1, 2]
    assert unpacked(rt, mb) == want
    assert rt._marshal(vk, pub + ["1"], good) is None
    assert jrt._marshal(vk, pub + ["1"], good) is None


@pytest.mark.parametrize("rho", [0, 1, 2 ** 128 - 1, 0x9E3779B97F4A7C15])
def test_fixed_base_f6_power(case, rho):
    """alphaBeta^rho from the F6 table (one gather, a K12 product tree)
    against the JAX package's F6.exp, on an F6 value outside the
    cyclotomic subgroup."""
    from wasmsnark_tpu_torch.fields.spec import LIMB_BITS
    from wasmsnark_tpu_torch.ops.fp import planes
    from wasmsnark_tpu_torch.utils.serialize import ints_to_limbs

    jrt, rt = case[:2]
    rnd = random.Random(rho % 1009)
    q = rt.m.fp_spec.q
    ab = tuple(tuple(rnd.randrange(q) for _ in range(3)) for _ in range(2))
    limbs = planes(ints_to_limbs([rho], 128 // LIMB_BITS), "cpu")
    got = rt._pd.unpack_f6(rt._ab_rho(rt._ab_table(ab), limbs))
    assert got == [jrt.m.F6.exp(ab, rho)]


def test_verify_sync_equals_the_jax_package(case):
    jrt, rt, vk, pub, good, bad = case
    for inp, prf, want in ((pub, good, True), (pub, bad, False),
                           (pub + ["1"], good, False)):
        assert jrt.verify_sync(vk, inp, prf) is want
        assert rt.verify_sync(vk, inp, prf) is want
    assert rt.bowe_gabizon_verifier(vk, pub, good) is True


def test_bowe_gabizon_verify_batch_on_three_lanes(case):
    """Good, tampered C, wrong input count: the device batch (plain
    versions) answers as the JAX package's verify_sync does."""
    jrt, rt, vk, pub, good, bad = case
    ins, prs = [pub, pub, pub + ["1"]], [good, bad, good]
    got = rt.bowe_gabizon_verify_batch(vk, ins, prs, rng=random.Random(3))
    assert got == [jrt.verify_sync(vk, i, p) for i, p in zip(ins, prs)] \
        == [True, False, False]
    assert len(rt._keys) == 1                  # the key's state kept
