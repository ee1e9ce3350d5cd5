"""Each cell of BENCHMARK.json on the card, for one short window:
`python -m pytest snarkbench/tests -q -m cuda` on a machine with one."""

import json
import os
import subprocess
import sys

import pytest

import small

ROOT = os.path.dirname(small.HERE)
CELLS = [w["name"] for w in
         json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(card, name):
    out = subprocess.run([sys.executable, "snarkbench/run.py", "--workload",
                          name, "--seed", str(2 ** 31 + 77), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
