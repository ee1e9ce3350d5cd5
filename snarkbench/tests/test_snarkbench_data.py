"""BENCHMARK.json keeps to the benchmark's contract as far as a file can
show it, and everything a cell names is found by that name."""

import json
import os
import re

from snarkbench.run import load_cell

import small

ROOT = os.path.dirname(small.HERE)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["snarkbench"]
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("snarkbench/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]


def test_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and _line(w["why"])
        assert os.path.exists(os.path.join(small.HERE, "traffic",
                                           w["traffic"] + ".json"))
        _, _, _, ends = load_cell(ROOT, w["name"], False)
        _, _, _, layers = load_cell(ROOT, w["name"], True)
        ends = [n for n, _ in ends]
        assert "setup_s" in ends and len(ends) >= 2 and layers
        for name, _ in layers:
            m = next(x for x in BENCH["per_layer"] if x["name"] == name)
            assert m["moves"] in ends and m["moves"] in e2e


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(small.HERE, "metrics",
                                           m["name"] + ".py")), m["name"]
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in BENCH["workloads"]}


def test_loops_and_references_found_by_name():
    """A traffic file's loop is loops/<loop>.py with a Loop and a Control;
    a curve outside pairing.py's is reference/<curve>.py: a new kind of
    either is a new file."""
    import pytest

    from snarkbench import loops, reference
    for w in BENCH["workloads"]:
        _, cfg, traffic, _ = load_cell(ROOT, w["name"], False)
        mod = loops.module(traffic["loop"])
        assert mod.Loop and mod.Control
        assert reference.curve(cfg["curve"]).r > 0
    with pytest.raises(ModuleNotFoundError, match="snarkbench.loops.nosuch"):
        loops.module("nosuch")
    with pytest.raises(ModuleNotFoundError,
                       match="snarkbench.reference.nosuch"):
        reference.curve("nosuch")
