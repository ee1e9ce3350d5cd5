"""The generators: a satisfiable R1CS of the configuration's stated
shape, the same inputs from the same seed, the verify traffic's lanes."""

import random

from snarkbench import circuit, loops
from snarkbench.reference import groth16 as ref
from snarkbench.reference.pairing import curve

import small

R = curve("bls12381").r


def _bits(circ):
    return sum(1 for kind, *_ in circ.rows if kind in ("bool", "xor", "and"))


def test_stated_shape_scaled_down():
    cfg = dict(small.load("configs", "zcash_sapling_spend"),
               constraints=3000)
    circ = circuit.generate(cfg, 11, R)
    assert len(circ.constraints) == 3000
    assert circ.n_public == 7
    assert circ.n_signals == 3000 + 1
    share = sum(cfg["rows"][k] for k in ("bool", "xor", "and"))
    assert abs(_bits(circ) / (3000 - 7) - share) < 0.002
    w = circuit.witness(circ, random.Random(5))
    assert circuit.satisfied(circ, w)
    assert all(v in (0, 1) for kind, out, *_ in circ.rows
               if kind in ("bool", "xor", "and") for v in [w[out]])
    # the nullifier's packings: 254 and 2 bits
    assert w[6] < 2 ** 254 and w[7] < 4


def test_full_size_shape():
    cfg = small.load("configs", "zcash_sapling_spend")
    circ = circuit.generate(cfg, 2 ** 31 + 1, R)
    rows = len(circ.constraints) + circ.n_public + 1
    assert len(circ.constraints) == 98777 and circ.n_public == 7
    assert 1 << 16 < rows <= 1 << 17 == cfg["domain"]
    assert circuit.satisfied(circ, circuit.witness(circ, random.Random(1)))


def test_same_seed_same_inputs_other_seed_same_sizes():
    cfg = small.prove_cfg(400)
    a, b = circuit.generate(cfg, 3, R), circuit.generate(cfg, 3, R)
    assert a.constraints == b.constraints and a.rows == b.rows
    assert circuit.witness(a, random.Random(9)) == \
        circuit.witness(b, random.Random(9))
    c = circuit.generate(cfg, 4, R)
    assert c.constraints != a.constraints
    assert _bits(c) == _bits(a)
    nnz = [sum(len(x) for row in cc.constraints for x in row) for cc in (a, c)]
    assert abs(nnz[0] - nnz[1]) <= 0.02 * nnz[0]


class _Echo:
    """A verifier that returns the reference's own verdicts."""

    def __init__(self, loop):
        self.loop = loop

    def verify_batch(self, vk, inputs_list, proofs):
        return [True] * len(proofs)


def _verify_loop(seed, cfg=None, traffic=None):
    loop = loops.module("verify").Loop(cfg or small.verify_cfg(),
                                       traffic or small.verify_traffic(),
                                       seed, "cpu", _Echo)
    loop.prepare()
    return loop


def test_verify_lanes_from_seed():
    a, b = _verify_loop(2 ** 31 + 7), _verify_loop(2 ** 31 + 7)
    assert a.vk_json == b.vk_json
    for i in (0, 1, 5):
        la = [a.lane(x) for x in a.batch(i)]
        lb = [b.lane(x) for x in b.batch(i)]
        assert [(x.inputs, x.proof) for x in la] == \
            [(x.inputs, x.proof) for x in lb]
    refs = a.batch(0)
    t = small.verify_traffic()
    assert len(refs) == t["batch"]
    kinds = [k for k, _ in refs if k != "pool"]
    assert sorted(kinds) == sorted(k for k, n in t["tampered"].items()
                                   for _ in range(n))
    assert all(a.expected(x) == (x[0] == "pool") for x in refs)


def test_verify_pool_distinct_batches():
    """The window's batches take distinct valid proofs in turn, each with
    inputs and A, B and C of its own; the warm batch takes its own."""
    loop = _verify_loop(2 ** 35 + 1)
    t = small.verify_traffic()
    assert len(loop.pool) == (t["batches"] + 1) * t["batch"]
    seen = [j for i in range(-1, t["batches"]) for k, j in loop.batch(i)
            if k == "pool"]
    assert len(seen) == len(set(seen))
    # the window's batch after the last takes the first slice again
    assert all(j < t["batch"] for k, j in loop.batch(t["batches"])
               if k == "pool")
    for key in ("pi_a", "pi_b", "pi_c"):
        pts = [str(ln.proof[key]) for ln in loop.pool]
        assert len(set(pts)) == len(pts), key
    assert len({tuple(ln.inputs) for ln in loop.pool}) == len(loop.pool)
    cv = loop.curve
    for ln in loop.pool[::5]:
        a, b, c = ln.logs
        assert ln.proof == ref.proof_json(cv, a, b, c) | {"protocol": "groth"}
        assert loop.expected(("pool", loop.pool.index(ln)))


def test_verify_inputs_have_stated_widths():
    loop = _verify_loop(2 ** 33)
    r = loop.curve.r
    for lane in loop.pool:
        for v, p in zip(lane.values, loop.cfg["public_inputs"]):
            assert 0 <= v < (r if p["bits"] is None else 1 << p["bits"])
    assert all(lane.values[5] == 0 for lane in loop.pool)   # refund


def test_new_cell_is_data_only():
    """sapling_spend.verify, a cell for later, needs no code: the
    Sapling configuration under the verify traffic."""
    loop = _verify_loop(5, small.load("configs", "zcash_sapling_spend"),
                        small.verify_traffic())
    assert loop.n_public == 7 and len(loop.pool[0].inputs) == 7
    assert all(loop.expected(x) == (x[0] == "pool") for x in loop.batch(0))
