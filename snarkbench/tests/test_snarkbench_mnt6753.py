"""The coda.verify cell on the CPU: the port's Bowe-Gabizon batch verifier
(build_mnt6753(device="cpu"), every kernel by its plain version) against
reference/mnt6753.py lane by lane, a valid lane and one of each tampered
kind; the reference's hash and group map against the port's host oracle;
the control (the hash equation dropped) failing the comparison that
decides `correct` while the sound reference passes; its BLAKE2s against
hashlib's; the counts of
counts/mnt6753.py from the curve's constants; and the bg.* readers.  One
call of the port (~60 s) and the reference's set-up at a small size."""

import ast
import os
import sys
import time
import types

import pytest

from snarkbench import cell, loops
from snarkbench import program_spans as ps
from snarkbench.counts import least_s
from snarkbench.counts import mnt6753 as counts
from snarkbench.reference import mnt6753 as ref

import small

SEED = 2 ** 33 + 24
BG = loops.module("bg_verify")
READERS = ["bg.marshal_s", "bg.hash_s", "bg.group_map_s", "bg.pairing_s",
           "bg_pairing_roofline"]


def _cfg():
    return small.load("configs", "coda_bowe_gabizon")


def _traffic(**kw):
    """Five lanes a batch, four of them tampered, one of each kind."""
    return {**small.load("traffic", "bg_verify_batch"), "batch": 5,
            "batches": 1, "tampered": {"c": 1, "z": 1, "input": 1,
                                       "count": 1}, **kw}


def _run(loop, ops):
    return cell.measure(loop, [], float("inf"), False, time.perf_counter(),
                        launches=False, cap=ops)


@pytest.fixture(scope="module")
def loop():
    """The loop prepared with the control in the program's place (its warm
    operation costs nothing), then the port put there."""
    lp = BG.Loop(_cfg(), _traffic(), SEED, "cpu", BG.Control)
    lp.prepare()
    lp.prog = BG.PortBGVerifier("cpu")
    return lp


@pytest.fixture(scope="module")
def port_run(loop):
    return _run(loop, 1)


def test_port_answers_as_the_reference(loop, port_run):
    assert port_run["correct"], port_run["checks"]
    refs = loop.batch(0)
    assert sorted(k for k, _ in refs) == ["c", "count", "input", "pool", "z"]
    want = [k == "pool" for k, _ in refs]
    assert [loop.expected(x) for x in refs] == want
    # the pairing sample holds the z lane, verified from its JSON
    assert port_run["checks"]["pairing_disagree"]["value"] == 0


def test_reference_ys_is_the_port_oracles(loop):
    from wasmsnark_tpu_torch.models.mnt6753_runtime import Mnt6753Runtime
    rt = Mnt6753Runtime(device="cpu")
    lane = loop.pool[0]
    A, B, C, dp = lane.points[:4]
    want = rt.m.G1.affine(rt.calculate_ys(A, B, C, dp))
    assert loop.ys((A, B, C, dp)) == tuple(want[:2])
    assert loop.curve.G1.on_curve(loop.ys((A, B, C, dp)), loop.curve.b1)


def test_reference_pairing_accepts_a_valid_lane(loop):
    cv, lane = loop.curve, loop.pool[0]
    assert ref.verify_bg(cv, loop.vk_json, lane.inputs, lane.proof)
    z = loop.bank["z"][0]
    assert not ref.verify_bg(cv, loop.vk_json, z.inputs, z.proof)
    assert ref.verify_exponent(cv, loop.td, z.values, z.logs, z.points,
                               hash_check=False)


class _Sound(BG.Control):
    def verify_batch(self, vk, inputs_list, proofs):
        L = self.loop
        return [ref.verify_exponent(L.curve, L.td, ln.values, ln.logs,
                                    ln.points, L.ys)
                for ln in (L.by_id[(id(i), id(p))]
                           for i, p in zip(inputs_list, proofs))]


def test_control_fails_reference_passes():
    traffic = _traffic(batch=8, tampered={"c": 1, "z": 2, "input": 1,
                                          "count": 1})
    out = cell.run_cell(_cfg(), traffic, [], SEED + 1, float("inf"), False,
                        "cpu", time.perf_counter(), BG.Control, cap=2)
    assert not out["correct"]
    # the z lanes of both batches accepted, and the sampled z lane
    assert out["checks"]["verdicts_wrong"]["value"] == 2 * 2
    assert out["checks"]["pairing_disagree"]["value"] == 1
    out = cell.run_cell(_cfg(), traffic, [], SEED + 1, float("inf"), False,
                        "cpu", time.perf_counter(), _Sound, cap=2)
    assert out["correct"], out["checks"]


def test_pool_lanes_distinct(loop):
    for k in range(5):
        pts = [ln.points[k] for ln in loop.pool]
        assert len(set(pts)) == len(pts)
    assert len({tuple(ln.inputs) for ln in loop.pool}) == len(loop.pool)
    r = loop.curve.r
    assert all(0 <= v < r for ln in loop.pool for v in ln.values)


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 95, 128, 129])
def test_reference_blake2s(n):
    import hashlib
    import random
    data = random.Random(n).randbytes(n)
    assert ref.blake2s(data) == hashlib.blake2s(data).digest()


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(small.HERE, "reference", "mnt6753.py")
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("wasmsnark_tpu",
                                           "wasmsnark_tpu_torch", "jax")


# -- counts/mnt6753.py --------------------------------------------------------

def test_counts_follow_the_curve():
    assert counts.LOOP == ref.ATE_LOOP_COUNT
    assert counts.doublings() == ref.ATE_LOOP_COUNT.bit_length() - 1 == 376
    assert counts.additions() == bin(ref.ATE_LOOP_COUNT).count("1") - 1 \
        == 174
    w = -(-ref.Q.bit_length() // 32)
    assert w == 24
    one, two = counts.pairing_lane(w, 1), counts.pairing_lane(w, 2)
    # a pair more: its lines at every step, nothing else
    steps = counts.doublings() + counts.additions()
    per = counts._ops(w, [(steps, counts.LINE_EVAL),
                          (steps, counts.LINE_MUL)])
    assert two - one == per


def test_counts_depend_on_lanes_alone():
    a, b = counts.verify_batch(24, 255), counts.verify_batch(24, 510)
    assert b[0] == 2 * a[0] and a[1] < b[1] < 2 * a[1]
    least = least_s(a[1], a[0])
    assert a[0] / 33.5e12 > a[1] / 3.35e12     # operation-bound
    assert 1e-4 < least < 1e-2


# -- the bg.* readers ---------------------------------------------------------

def _record(trees, kernels=()):
    """A traced record of two operations (host 101-109 and 111-119 s, the
    trace's clock 100 s behind) and the port's spans of the trees."""
    from snarkbench import trace as tr
    from snarkbench.cell import Op, Record
    spans, nxt = [], [1]

    def add(node, parent=None):
        name, t0, t1, kids = node
        sid = nxt[0]
        nxt[0] += 1
        for k in kids:
            add(k, sid)
        spans.append(types.SimpleNamespace(
            name=name, id=sid, parent=parent, t0=round(t0 * 1e9),
            t1=round(t1 * 1e9), launches=10))

    for t in trees:
        add(t)
    ops_at = ((101.0, 109.0), (111.0, 119.0))
    marks = [("window", 100.0)] + [("op", t) for ab in ops_at for t in ab] \
        + [("window", 120.0)]
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
           "ts": (t - 100.01) * 1e6, "dur": 0.01 * 1e6} for _, t in marks]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": a * 1e6,
            "dur": (b - a) * 1e6} for a, b in kernels]
    trace = tr.Trace(ev)
    assert tr.align(trace, marks)
    sizes = {"curve": "mnt6753", "n_public": 1, "fq_words": 24,
             "pairing_lanes": 255}
    ops = [Op(i, a, b, [], 256, "bg_verify")
           for i, (a, b) in enumerate(ops_at)]
    return Record(sizes, 1.0, 20.0, ops, trace=trace), spans


def _batch(t0, scale):
    stages = [("bg.marshal", 3.0), ("bg.hash", 1.0), ("bg.group_map", 0.5),
              ("bg.pairing", 2.0)]
    kids, t = [], t0 + 0.01
    for name, d in stages:
        kids.append((name, t, t + d * scale, []))
        t += d * scale
    return ("bg.batch", t0, t + 0.01, kids)


def test_bg_readers(monkeypatch):
    # the card busy 0.1 s inside each batch's bg.pairing (trace clock)
    rec, spans = _record([_batch(101.0, 1.0), _batch(111.0, 1.2)],
                         kernels=[(6.0, 6.1), (17.0, 17.1)])
    monkeypatch.setitem(sys.modules, ps.SPANS_MODULE,
                        types.SimpleNamespace(recorded=lambda: spans))
    want = {"bg.marshal_s": 3.3, "bg.hash_s": 1.1, "bg.group_map_s": 0.55,
            "bg.pairing_s": 2.2}
    for name, v in want.items():
        assert abs(cell.reader(name)(rec) - v) < 1e-6, name
    ops, nbytes = counts.verify_batch(24, 255)
    roof = 100 * 2 * least_s(nbytes, ops) / 0.2
    got = cell.reader("bg_pairing_roofline")(rec)
    assert abs(got - roof) < 1e-6 * roof and 0 < got < 100


@pytest.mark.parametrize("name", READERS)
def test_bg_reader_none_without_spans(name, monkeypatch):
    rec, _ = _record([_batch(101.0, 1.0)])
    monkeypatch.delitem(sys.modules, ps.SPANS_MODULE, raising=False)
    assert cell.reader(name)(rec) is None
    monkeypatch.setitem(sys.modules, ps.SPANS_MODULE,
                        types.SimpleNamespace(recorded=lambda: []))
    assert cell.reader(name)(rec) is None
