"""The port's spans as the benchmark reads them (snarkbench/program_spans.py
and the metrics that read spans), on synthetic records: each operation's
offset onto the trace's clock, self time, idle gaps named by the innermost
span, every reader's value, and None without spans."""

import importlib.util
import os
import sys
import types

import pytest

from snarkbench import program_spans as ps
from snarkbench import trace as tr
from snarkbench.cell import Op, Record, reader
from snarkbench.counts import least_s
from snarkbench.readings import prove_work

import small

SIZES = {"n_signals": 1000, "n_public": 2, "n_bits": 600, "n_wide": 400,
         "domain": 1024, "nnz_a": 2000, "nnz_b": 1500, "fq_words": 12,
         "fr_words": 8, "scalar_bits": 255}
STAGES = [("msm.digits", .1), ("msm.sort", .2), ("msm.bucket_scan", .3),
          ("msm.triangle", .4), ("msm.reduce", .05), ("msm.fold", .15)]
# the trace's clock runs 100 s behind the host's; the second operation's
# marks lie 0.4 ms further off, a drift an offset per operation takes out
BEHIND, DRIFT = 100.0, 0.0004


class Maker:
    """Port-style spans (times in ns, ids in order of entry) of a tree
    written as (name, start s, end s, launches, [children])."""

    def __init__(self):
        self.out, self.next = [], 1

    def add(self, node, parent=None):
        name, t0, t1, launches, kids = node
        sid = self.next
        self.next += 1
        for k in kids:
            self.add(k, sid)
        self.out.append(types.SimpleNamespace(
            name=name, id=sid, parent=parent, t0=round(t0 * 1e9),
            t1=round(t1 * 1e9), launches=launches))


def _msm(t0, scale=1.0):
    kids, t = [], t0
    for name, d in STAGES:
        kids.append((name, t, t + d * scale, 10, []))
        t += d * scale
    return ("msm", t0, t, 60, kids), t


def _proof(t0, scale):
    """A prove tree from t0: the phases, an msm under each MSM phase."""
    g1, g1_end = _msm(t0 + 1.6, 0.1)
    g2, g2_end = _msm(g1_end + 0.05, scale)
    return ("prove", t0, g2_end + 0.5, 0, [
        ("prove.key_and_witness", t0, t0 + 0.5, 0, []),
        ("prove.calc_h", t0 + 0.5, t0 + 1.5, 20, []),
        ("prove.msm_g1", t0 + 1.5, g1_end + 0.05, 70, [g1]),
        ("prove.msm_g2", g1_end + 0.05, g2_end + 0.01, 100 * scale, [g2]),
        ("prove.host_assembly", g2_end + 0.01, g2_end + 0.5, 0, [])])


def _batch(t0, lanes, vk):
    vks = [("verify.vk_x", t0 + 0.2 + k * 0.1, t0 + 0.2 + k * 0.1 + vk,
            0, []) for k in range(lanes)]
    m_end = t0 + 0.3 + lanes * 0.1
    return ("verify.batch", t0, m_end + 1.0, 0, [
        ("verify.marshal", t0 + 0.1, m_end, 0, vks),
        ("verify.pairing", m_end, m_end + 0.9, 50, [])])


def _record(trees, kernels=(), ops_at=((101.0, 109.0), (111.0, 119.0))):
    """A traced record of two operations at ops_at (host clock) holding
    the trees, with the port's spans, a stale tree and device kernels
    (trace clock)."""
    mk = Maker()
    mk.add(("prove", 90.0, 91.0, 0, []))          # before the window
    for t in trees:
        mk.add(t)
    marks = [("window", 100.0)]
    for a, b in ops_at:
        marks += [("op", a), ("op", b)]
    marks.append(("window", 120.0))
    ends = [t - BEHIND - (DRIFT if t > 110 else 0) for _, t in marks]
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
           "ts": (t - 0.01) * 1e6, "dur": 0.01 * 1e6} for t in ends]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": a * 1e6,
            "dur": (b - a) * 1e6} for a, b in kernels]
    trace = tr.Trace(ev)
    assert tr.align(trace, marks)
    ops = [Op(i, a, b, {}, 1, "prove") for i, (a, b) in enumerate(ops_at)]
    return Record(SIZES, 1.0, 20.0, ops, trace=trace), mk.out


@pytest.fixture
def port_spans(monkeypatch):
    """Installs a stand-in for the port's spans module that holds the
    given spans."""
    def install(spans):
        mod = types.SimpleNamespace(recorded=lambda: list(spans))
        monkeypatch.setitem(sys.modules, ps.SPANS_MODULE, mod)
    return install


def _proofs():
    return [_proof(101.01, 1.0), _proof(111.01, 2.0)]


def _secs(spans):
    return [ps.Span(s.name, s.id, s.parent, s.t0 * 1e-9, s.t1 * 1e-9,
                    s.launches) for s in spans]


def test_offset_per_operation():
    rec, spans = _record(_proofs())
    offs = ps.op_offsets(rec)
    assert [(round(a, 6), round(b, 6)) for a, b in offs] == \
        [(-BEHIND, -BEHIND), (-BEHIND - DRIFT, -BEHIND - DRIFT)]
    got = ps.by_op(rec, _secs(spans))
    assert [round(o.offset, 6) for o in got] == [-BEHIND, -BEHIND - DRIFT]
    # the stale tree before the window belongs to no operation
    assert all(min(s.t0 for s in o.spans) > 100 for o in got)
    assert [len(o.spans) for o in got] == [20, 20]
    placed = got[1].placed()
    top = next(s for s in placed if s.name == "prove")
    assert abs(top.t0 - (111.01 - BEHIND - DRIFT)) < 1e-9
    # without a trace the spans are grouped all the same, with no offset
    rec.trace = None
    assert [o.offset for o in ps.by_op(rec, _secs(spans))] == [None, None]


def test_self_time():
    spans = [ps.Span("a", 1, None, 0.0, 10.0, 0),
             ps.Span("b", 2, 1, 1.0, 3.0, 0),
             ps.Span("c", 3, 1, 4.0, 6.0, 0),
             ps.Span("d", 4, 3, 4.5, 5.0, 0)]
    self_s = ps.self_seconds(spans)
    assert {k: round(v, 9) for k, v in self_s.items()} == \
        {1: 6.0, 2: 2.0, 3: 1.5, 4: 0.5}
    assert [(a, b, s.name) for a, b, s in ps.segments(spans)] == [
        (0.0, 1.0, "a"), (1.0, 3.0, "b"), (3.0, 4.0, "a"), (4.0, 4.5, "c"),
        (4.5, 5.0, "d"), (5.0, 6.0, "c"), (6.0, 10.0, "a")]


def test_idle_gaps_named_by_innermost_span(port_spans):
    proof = _proof(101.01, 1.0)
    # on the trace's clock the card is busy through calc_h and most of the
    # G2 MSM's bucket scan, and for a microsecond where each stretch of
    # one innermost span starts, so that each gap lies in one of them
    g2 = proof[4][3][4][0]
    scan = next(k for k in g2[4] if k[0] == "msm.bucket_scan")
    mk = Maker()
    mk.add(proof)
    starts = [a - BEHIND for a, _, _ in ps.segments(_secs(mk.out))]
    kernels = [(1.51, 2.51), (scan[1] - BEHIND, scan[2] - BEHIND - 0.1)] + \
        [(a, a + 1e-6) for a in starts]
    rec, spans = _record([proof], kernels, ops_at=((101.0, 109.0),))
    port_spans(spans)
    o, = ps.by_op(rec)
    idle = ps.idle_by_span(rec.trace, o)
    # the G1 MSM's stages at a tenth of the G2 MSM's
    want = {name: 1.1 * d for name, d in STAGES}
    want.update({"msm.bucket_scan": 0.03 + 0.1,
                 "prove.key_and_witness": 0.5, "prove.msm_g1": 0.15,
                 "prove.msm_g2": 0.01, "prove.host_assembly": 0.49})
    assert {k for k, v in idle.items() if v > 1e-5} == set(want)
    for name, v in want.items():
        assert abs(idle[name] - v) < 1e-4, name
    assert round(ps.busy_in(rec.trace, o, "prove.calc_h"), 6) == 1.0


def _value(name, rec):
    return reader(name)(rec)


def test_prove_readers(port_spans):
    kernels = [(1.51, 2.01), (11.51 - DRIFT, 12.51 - DRIFT)]
    rec, spans = _record(_proofs(), kernels)
    port_spans(spans)
    bucket = sum(d for n, d in STAGES[:3])
    tri = STAGES[3][1] + STAGES[4][1]
    want = {"prove.calc_h_s": 1.0,
            "msm_g2.bucket_s": 1.5 * bucket,       # median of x1 and x2
            "msm_g2.triangle_s": 1.5 * tri,
            "msm_g2.fold_s": 1.5 * STAGES[5][1],
            "launches.msm_g2": 150}
    for name, v in want.items():
        assert abs(_value(name, rec) - v) < 1e-6, name
    ops, nbytes = prove_work(SIZES)["calc_h"]
    roof = 100 * 2 * least_s(nbytes, ops) / 1.5
    assert abs(_value("calc_h_roofline", rec) - roof) < 1e-9 * roof


def test_verify_readers(port_spans):
    rec, spans = _record([_batch(101.01, 5, 0.05), _batch(111.01, 7, 0.08)])
    port_spans(spans)
    want = {"verify.marshal_s": (0.2 + 0.5 + 0.2 + 0.7) / 2,
            "verify.vk_x_s": (5 * 0.05 + 7 * 0.08) / 2,
            "verify.pairing_s": 0.9}
    for name, v in want.items():
        assert abs(_value(name, rec) - v) < 1e-6, name


NEW = ["prove.calc_h_s", "calc_h_roofline", "msm_g2.bucket_s",
       "msm_g2.triangle_s", "msm_g2.fold_s", "launches.msm_g2",
       "verify.marshal_s", "verify.vk_x_s", "verify.pairing_s"]


@pytest.mark.parametrize("name", NEW)
def test_none_without_spans(name, monkeypatch, port_spans):
    rec, spans = _record(_proofs())
    # a port without the spans module (an older commit)
    monkeypatch.delitem(sys.modules, ps.SPANS_MODULE, raising=False)
    assert _value(name, rec) is None
    # one whose buffer is empty (an untraced run), or holds only spans
    # outside the window's operations
    port_spans([])
    assert _value(name, rec) is None
    port_spans([s for s in spans if s.t0 < 100e9])
    assert _value(name, rec) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_in_benchmark(name):
    """Each reader is a metrics/<name>.py the harness finds, listed in
    BENCHMARK.json for the cell whose spans it reads."""
    path = os.path.join(small.HERE, "metrics", name + ".py")
    assert importlib.util.spec_from_file_location("m", path) is not None
    import json
    bench = json.load(open(os.path.join(os.path.dirname(small.HERE),
                                        "BENCHMARK.json")))
    m = next(x for x in bench["per_layer"] if x["name"] == name)
    cell = "tornado_withdraw.verify" if name.startswith("verify.") \
        else "sapling_spend.prove"
    assert m["workloads"] == [cell]
