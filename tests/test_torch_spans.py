"""The port's spans (wasmsnark_tpu_torch/utils/spans.py) on the CPU: a
small BN128 prove and a small verify batch under torch.profiler give the
span tree of groth16/prover.py, ops/msm.py and groth16/verifier.py, with
every child inside its parent; with the profiler off nothing is recorded
and the proof and the verdicts are the same; prove(timings=) reads the
phase spans; the buffer's bound counts what it drops.  An MNT6753
Bowe-Gabizon batch (models/mnt6753_runtime.py) gives the bg.* tree, with
recording switched on as the profiler would (the CPU profiler over its
plain field operations would take minutes to stop)."""

import gc
import json
import random

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import wasmsnark_tpu_torch
from wasmsnark_tpu_torch.groth16 import setup as tsetup
from wasmsnark_tpu_torch.groth16.pkey import write_witness
from wasmsnark_tpu_torch.models.bn128 import bn128
from wasmsnark_tpu_torch.ops import cuda_lib
from wasmsnark_tpu_torch.utils import spans

from test_torch_mnt_verify import g1_json, synthetic_proof, synthetic_vk

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 3
m = bn128()
PHASES = ["key_and_witness", "calc_h", "msm_g1", "msm_g2", "host_assembly"]
STAGES = {"msm.digits", "msm.sort", "msm.bucket_scan", "msm.triangle",
          "msm.reduce", "msm.fold"}


def _new_since(last: int) -> list:
    return [s for s in spans.recorded() if s.id > last]


def _last() -> int:
    """The newest id recorded (a parent is added after its children)."""
    return max((s.id for s in spans.recorded()), default=0)


def _run(fn, traced: bool):
    """fn() and the spans it recorded, under the profiler or not."""
    last = _last()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            out = fn()
    else:
        out = fn()
    return out, _new_since(last)


@pytest.fixture(scope="module")
def case():
    pkey, vk, _ = tsetup.setup(tsetup.square_chain_circuit(K), seed=3,
                               device=CPU)
    rt = wasmsnark_tpu_torch.build_bn128(device=CPU)
    wit = tsetup.square_chain_witness(K, 5)
    wbytes = write_witness(wit, m.fr_spec)

    def prove(timings=None):
        return rt.prover.prove(wbytes, pkey, rng=7, timings=timings)

    off = {"prove": _run(prove, False)}
    proof = off["prove"][0]
    pub = [str(wit[1])]
    tampered = json.loads(json.dumps(proof))
    tampered["pi_a"][0] = str(int(tampered["pi_a"][0]) + 1)
    lanes = [(pub, proof), (pub, tampered), ([str(wit[1] + 1)], proof),
             ([str(int(pub[0]) + m.Fr.q)], proof), (pub + ["1"], proof),
             (pub, dict(proof, pi_a=["0", "1", "0"]))]

    def verify():
        return rt.groth16_verify_batch(vk, [ln[0] for ln in lanes],
                                       [ln[1] for ln in lanes])

    timings = {}
    # rt's first batch, traced, builds the vk's fixed-base tables
    on = {"prove": _run(lambda: prove(timings), True),
          "verify": _run(verify, True)}
    off["verify"] = _run(verify, False)
    return {"on": on, "off": off, "timings": timings, "want": [True] +
            [False] * 5}


def _by_id(recs):
    return {s.id: s for s in recs}


def _children(recs, parent):
    return [s for s in recs if s.parent == parent.id]


def test_prove_span_tree(case):
    _, recs = case["on"]["prove"]
    tops = [s for s in recs if s.parent is None]
    assert [s.name for s in tops] == ["prove"]
    phases = _children(recs, tops[0])
    assert [s.name for s in phases] == ["prove." + p for p in PHASES]
    by = {s.name: s for s in phases}
    for name in ("prove.key_and_witness", "prove.calc_h",
                 "prove.host_assembly"):
        assert _children(recs, by[name]) == []
    # one msm under each MSM phase: the four G1 sections as one batch
    for name in ("prove.msm_g1", "prove.msm_g2"):
        assert [s.name for s in _children(recs, by[name])] == ["msm"]


def test_each_msm_has_its_six_stages(case):
    _, recs = case["on"]["prove"]
    msms = [s for s in recs if s.name == "msm"]
    assert len(msms) == 2
    for msm in msms:
        kids = _children(recs, msm)
        assert [s.name for s in kids] == [
            "msm.digits", "msm.sort", "msm.bucket_scan", "msm.triangle",
            "msm.reduce", "msm.fold"]
    assert {s.name for s in recs if s.name.startswith("msm.")} == STAGES


def test_verify_span_tree(case):
    _, recs = case["on"]["verify"]
    tops = [s for s in recs if s.parent is None]
    assert [s.name for s in tops] == ["verify.batch"]
    kids = _children(recs, tops[0])
    assert [s.name for s in kids] == ["verify.marshal", "verify.pairing"]
    vk_x = _children(recs, kids[0])
    # the key's tables, built by this first batch, then one vk_x stage
    # for all six lanes
    assert [s.name for s in vk_x] == ["verify.vk_x_table", "verify.vk_x"]
    assert all(_children(recs, s) == [] for s in vk_x)
    assert _children(recs, kids[1]) == []


@pytest.mark.parametrize("what", ["prove", "verify"])
def test_children_lie_inside_their_parents(case, what):
    _, recs = case["on"][what]
    by = _by_id(recs)
    assert len(recs) == len(by)
    for s in recs:
        assert s.t0 <= s.t1
        if s.parent is not None:
            p = by[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    # siblings one after another
    for s in recs:
        kids = sorted(_children(recs, s), key=lambda k: k.t0)
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
    # on the CPU the plain versions launch nothing
    assert all(s.launches == 0 for s in recs)


@pytest.mark.parametrize("what", ["prove", "verify"])
def test_off_records_nothing_and_gives_the_same_result(case, what):
    out_on, _ = case["on"][what]
    out_off, recs = case["off"][what]
    assert recs == []
    assert json.dumps(out_on) == json.dumps(out_off)
    if what == "verify":
        assert out_on == case["want"]
    else:
        assert out_on["protocol"] == "groth"


def test_timings_are_the_phase_spans(case):
    _, recs = case["on"]["prove"]
    timings = case["timings"]
    assert list(timings) == PHASES
    by = {s.name: s for s in recs}
    for key in PHASES:
        rec = by["prove." + key]
        assert timings[key] == (rec.t1 - rec.t0) * 1e-9
    # timed without the profiler too, and still nothing recorded
    again = {}
    last = _last()
    with spans.span("prove.calc_h", sync=CPU, into=(again, "calc_h")) as sp:
        pass
    assert list(again) == ["calc_h"] and again["calc_h"] == sp.seconds >= 0
    # a phase that raises gives no seconds
    with pytest.raises(ValueError):
        with spans.span("prove.msm_g1", sync=CPU, into=(again, "msm_g1")):
            raise ValueError("stop")
    assert list(again) == ["calc_h"]
    assert _new_since(last) == []


def test_off_is_one_shared_context():
    assert spans.span("a") is spans.span("b")
    with spans.span("a") as sp:
        assert not isinstance(sp, spans.Span)


def test_buffer_bound_counts_drops(monkeypatch):
    buf = spans.Buffer(3)
    monkeypatch.setattr(spans, "BUFFER", buf)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(5):
            with spans.span(f"s{k}"):
                pass
    assert [s.name for s in spans.recorded()] == ["s2", "s3", "s4"]
    assert buf.dropped == 2
    assert len(spans.recorded()) == 3     # reading does not empty it
    # the buffer holds plain values: the collector stops tracking them
    gc.collect()
    assert not any(gc.is_tracked(r) for r in buf.spans)


def test_span_counts_launches_between_its_ends(monkeypatch):
    counts = dict.fromkeys(cuda_lib.launches, 0)
    monkeypatch.setattr(cuda_lib, "launches", counts)
    last = _last()
    key = next(iter(counts))
    with profile(activities=[ProfilerActivity.CPU]):
        counts[key] += 2
        with spans.span("outer"):
            counts[key] += 3
            with spans.span("inner"):
                counts[key] += 4
    got = {s.name: (s.launches, s.parent) for s in _new_since(last)}
    outer = next(s for s in _new_since(last) if s.name == "outer")
    assert got == {"inner": (4, outer.id), "outer": (7, None)}


# -- the MNT6753 Bowe-Gabizon batch -------------------------------------------

BG_STAGES = ["bg.marshal", "bg.hash", "bg.group_map", "bg.pairing"]


def _bg_lanes():
    """A key and three lanes (a valid proof, its Z moved, one input too
    many) made with a trapdoor on the port's host oracle."""
    rt = wasmsnark_tpu_torch.build_mnt6753(device=CPU)
    m, rnd = rt.m, random.Random(24)
    vk, trap = synthetic_vk(m, 1, rnd)
    pub = [str(rnd.randrange(m.Fr.q))]
    good = synthetic_proof(rt, trap, pub, rnd)
    moved = dict(good, z=g1_json(m, m.G1.add(rt._g1_affine(good["z"]),
                                              m.g1_gen)))
    return rt, vk, [pub, pub, pub + ["1"]], [good, moved, good]


@pytest.fixture(scope="module")
def bg_case():
    rt, vk, ins, prfs = _bg_lanes()

    def verify():
        return rt.bowe_gabizon_verify_batch(vk, ins, prfs,
                                            rng=random.Random(5))

    def on(fn):
        mp = pytest.MonkeyPatch()
        mp.setattr(spans, "_enabled", lambda: True)
        try:
            return _run(fn, False)
        finally:
            mp.undo()

    # no lane of this batch takes the key, so the key's first batch that
    # does (traced) builds its state
    none = on(lambda: rt.bowe_gabizon_verify_batch(vk, ins[2:], prfs[2:]))
    return {"on": on(verify), "off": _run(verify, False), "none": none}


def test_bg_span_tree(bg_case):
    """bg.batch's four stages; under bg.marshal the key's state build (its
    first batch) and the device stage bg.scalars; every other span a
    leaf."""
    out, recs = bg_case["on"]
    tops = [s for s in recs if s.parent is None]
    assert [s.name for s in tops] == ["bg.batch"]
    kids = sorted(_children(recs, tops[0]), key=lambda s: s.t0)
    assert [s.name for s in kids] == BG_STAGES
    marshal = sorted(_children(recs, kids[0]), key=lambda s: s.t0)
    assert [s.name for s in marshal] == ["bg.vk_tables", "bg.scalars"]
    assert all(_children(recs, s) == [] for s in kids[1:] + marshal)
    # a batch no lane of which the key takes: marshalling alone
    out_none, recs_none = bg_case["none"]
    assert out_none == [False]
    top, = [s for s in recs_none if s.parent is None]
    assert [s.name for s in _children(recs_none, top)] == ["bg.marshal"]


def test_bg_children_lie_inside_their_parents(bg_case):
    _, recs = bg_case["on"]
    by = _by_id(recs)
    assert len(recs) == len(by) == 7
    for s in recs:
        assert s.t0 <= s.t1
        if s.parent is not None:
            assert by[s.parent].t0 <= s.t0 and s.t1 <= by[s.parent].t1
    for parent in recs:
        kids = sorted(_children(recs, parent), key=lambda k: k.t0)
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
    top = next(s for s in recs if s.parent is None)
    kids = _children(recs, top)
    assert sum(s.t1 - s.t0 for s in kids) >= 0.99 * (top.t1 - top.t0)
    assert all(s.launches == 0 for s in recs)


def test_bg_vk_tables_once_a_key(monkeypatch):
    """bg.vk_tables records once for two batches under one key and once
    more for a second key; bg.scalars once a batch."""
    rt, vk, ins, prfs = _bg_lanes()
    vk2, _ = synthetic_vk(rt.m, 1, random.Random(25))
    monkeypatch.setattr(spans, "_enabled", lambda: True)
    last = _last()
    for key in (vk, vk, vk2):
        rt._marshal_batch(key, ins[:1], prfs[:1], random.Random(5))
    names = [s.name for s in _new_since(last)]
    assert names.count("bg.vk_tables") == 2
    assert names.count("bg.scalars") == 3
    assert len(rt._keys) == 2


def test_bg_off_records_nothing_and_gives_the_same_verdicts(bg_case):
    out_on, _ = bg_case["on"]
    out_off, recs = bg_case["off"]
    assert recs == []
    assert out_on == out_off == [True, False, False]
