"""The comparison that decides `correct`: the port passes it at a small
size on the CPU; each fault a cell can have, planted under the timed
path, fails it; and the control (the reference in the program's place,
one guarantee broken) fails it while the sound reference passes."""

import time

import pytest

from snarkbench import cell, loops
from snarkbench.reference import groth16 as ref

import small

SEED = 2 ** 31 + 101
PROVE, VERIFY = loops.module("prove"), loops.module("verify")


def _run(loop, ops):
    return cell.measure(loop, [], float("inf"), False, time.perf_counter(),
                        launches=False, cap=ops)


@pytest.fixture(scope="module")
def prove_loop():
    loop = PROVE.Loop(small.prove_cfg(), small.prove_traffic(), SEED, "cpu")
    loop.prepare()
    loop.port = loop.prog
    return loop


@pytest.fixture(scope="module")
def verify_loop():
    loop = VERIFY.Loop(small.verify_cfg(), small.verify_traffic(), SEED,
                       "cpu")
    loop.prepare()
    loop.port = loop.prog
    return loop


class _Stale:
    """Returns what the call before returned (the first call is real)."""

    def __init__(self, inner, method):
        self.inner, self.method, self.last = inner, method, None

    def __getattr__(self, name):
        real = getattr(self.inner, name)
        if name != self.method:
            return real

        def call(*a, **k):
            out = real(*a, **k) if self.last is None else self.last
            self.last = out
            return out
        return call


class _AlteredProof:
    def __init__(self, inner):
        self.inner = inner

    def prove(self, *a, **k):
        out = self.inner.prove(*a, **k)
        out["pi_c"][0] = str(int(out["pi_c"][0]) + 1)
        return out


class _HalfWitness:
    """The second half of the witness's signals left out (zero)."""

    def __init__(self, inner):
        self.inner = inner

    def prove(self, witness, *a, **k):
        half = len(witness) // 64 * 32
        return self.inner.prove(witness[:half] + bytes(len(witness) - half),
                                *a, **k)


class _AlteredVerdict:
    def __init__(self, inner):
        self.inner = inner

    def verify_batch(self, *a):
        out = self.inner.verify_batch(*a)
        out[0] = not out[0]
        return out


class _HalfBatch:
    """The first half of the batch verified, the rest given its
    majority's verdict."""

    def __init__(self, inner):
        self.inner = inner

    def verify_batch(self, vk, inputs, proofs):
        h = len(proofs) // 2
        out = self.inner.verify_batch(vk, inputs[:h], proofs[:h])
        return out + [sum(out) * 2 >= len(out)] * (len(proofs) - h)


def test_port_prove_correct(prove_loop):
    prove_loop.prog = prove_loop.port
    out = _run(prove_loop, 1)
    assert out["correct"] and out["checks"]["proofs_wrong"]["value"] == 0


@pytest.mark.parametrize("fault, ops", [
    (lambda p: _Stale(p, "prove"), 2), (_AlteredProof, 1), (_HalfWitness, 1)],
    ids=["state_unchanged", "answer_altered", "half_left_out"])
def test_prove_faults_fail(prove_loop, fault, ops):
    prove_loop.prog = fault(prove_loop.port)
    out = _run(prove_loop, ops)
    assert not out["correct"]
    assert out["checks"]["proofs_wrong"]["value"] >= 1


def test_port_verify_correct(verify_loop):
    verify_loop.prog = verify_loop.port
    out = _run(verify_loop, 1)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault, ops", [
    (lambda p: _Stale(p, "verify_batch"), 2), (_AlteredVerdict, 1),
    (_HalfBatch, 1)], ids=["state_unchanged", "answer_altered",
                           "half_left_out"])
def test_verify_faults_fail(verify_loop, fault, ops):
    verify_loop.prog = fault(verify_loop.port)
    out = _run(verify_loop, ops)
    assert not out["correct"]
    assert out["checks"]["verdicts_wrong"]["value"] >= 1


class _BlindedReference(PROVE.Control):
    """The reference's prover with the proof's own blinding: sound."""

    def prove(self, witness, pkey, rng, timings=None):
        cv = self.loop.curve
        br, bs = (int.from_bytes(rng(32), "little") for _ in range(2))
        return ref.proof_json(cv, *ref.proof_scalars(
            self.qap, self.td, self.kc, self.witness(witness),
            self.loop.circ.n_public, cv.r, br, bs))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9, 2 ** 40 + 3])
def test_prove_control_fails_reference_passes(seed):
    cfg, traffic = small.prove_cfg(400), small.prove_traffic()
    out = cell.run_cell(cfg, traffic, [], seed, float("inf"), False, "cpu",
                        time.perf_counter(), PROVE.Control, cap=3)
    assert not out["correct"]
    assert out["checks"]["proofs_wrong"]["value"] == 3
    # unblinded proofs still verify: only the exact comparison sees them
    assert out["checks"]["proofs_rejected"]["value"] == 0
    out = cell.run_cell(cfg, traffic, [], seed, float("inf"), False, "cpu",
                        time.perf_counter(), _BlindedReference, cap=3)
    assert out["correct"]


class _RangeCheckedReference(VERIFY.Control):
    def verify_batch(self, vk, inputs_list, proofs):
        L = self.loop
        return [ref.verify_exponent(L.td, L.vk.ic_scalars,
                                    L.by_id[(id(i), id(p))].values,
                                    *L.by_id[(id(i), id(p))].logs, L.curve.r)
                for i, p in zip(inputs_list, proofs)]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9, 2 ** 40 + 3])
def test_verify_control_fails_reference_passes(seed):
    cfg, traffic = small.verify_cfg(), small.verify_traffic()
    out = cell.run_cell(cfg, traffic, [], seed, float("inf"), False, "cpu",
                        time.perf_counter(), VERIFY.Control, cap=3)
    assert not out["correct"]
    assert out["checks"]["verdicts_wrong"]["value"] == \
        3 * traffic["tampered"]["noncanonical"]
    out = cell.run_cell(cfg, traffic, [], seed, float("inf"), False, "cpu",
                        time.perf_counter(), _RangeCheckedReference, cap=3)
    assert out["correct"], out["checks"]
