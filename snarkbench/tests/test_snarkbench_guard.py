"""No run imports jax, jaxlib, flax or the JAX package (whole top-level
names), nothing of the benchmark reads the JAX package's bench files, and
a run without a card or without the program exits non-zero with no
result."""

import ast
import os
import shutil
import subprocess
import sys

from snarkbench.run import FORBIDDEN, forbidden_modules

import small

ROOT = os.path.dirname(small.HERE)


def test_whole_names():
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client",
                              "flax.linen", "wasmsnark_tpu.ops.fp",
                              "wasmsnark_tpu_torch", "wasmsnark_tpu_torch.ops",
                              "jaxx", "flaxen", "torch"]) == \
        ["flax", "jax", "jaxlib", "wasmsnark_tpu"]
    assert forbidden_modules(["wasmsnark_tpu_torch.groth16.prover"]) == []


def _sources():
    for d, _, files in os.walk(small.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                and node.body and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            out.add(id(node.body[0].value))
    return out


def test_sources_import_and_read_nothing_forbidden():
    for path in _sources():
        tree = ast.parse(open(path).read())
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN, (path, n)
                assert top not in ("bench", "chip_smoke", "tools"), (path, n)
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                for word in ("BENCH_", "MULTICHIP_", "chip_smoke",
                             "bench.py", "tools/"):
                    assert word not in node.value, (path, word)


def test_port_run_imports_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import snarkbench.cell, snarkbench.programs\n"
            "import wasmsnark_tpu_torch.groth16.prover\n"
            "import wasmsnark_tpu_torch.groth16.verifier\n"
            "from snarkbench.run import forbidden_modules\n"
            "print(forbidden_modules(list(sys.modules)))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "snarkbench/run.py", "--workload",
         "sapling_spend.prove", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(small.HERE, tmp_path / "snarkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from snarkbench import programs\n"
            "programs.PortVerifier('bn128', 'cpu')\n"
            "print('{}')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "wasmsnark_tpu_torch" in out.stderr
